"""Entry `MpmPipeline.step`: the pipeline's frame entry, n substeps of the
scene in one call, in place on data.state (on the kernel path the rows are
packed once and the static colliders' node CDF is built once a call).

  make(data) -> call(n): runs n substeps, returns the call's StepDiag.
"""


def make(data):
    from wgsparkl_tpu_torch.pipeline import MpmPipeline

    pipe = MpmPipeline()
    return lambda n: pipe.step(data, n)
