"""Entry `substep_pallas`: the kernel path's one-substep entry, as a host
that couples its own solver calls it once a substep (the rows packed and
unpacked, every collider's node CDF evaluated, in each call).

  make(data) -> call(n): runs the one substep (n is 1), returns None (the
  entry keeps no StepDiag).
"""


def make(data):
    from wgsparkl_tpu_torch.pipeline import substep_pallas

    def call(n):
        if n != 1:
            raise ValueError("substep_pallas runs one substep a call: substeps_per_call 1")
        data.state = substep_pallas(data.state, data.params, data.config)

    return call
