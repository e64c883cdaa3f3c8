"""pipeline.host_ms_per_substep: the host's time inside the entry
(MpmPipeline.step, from the call to its return, before the synchronise)
over the window's substeps, in ms; host clock, unprofiled frames of the
traced run."""


def read(ctx):
    w = ctx["window"]
    n = w["frames"] * ctx["substeps"]
    return 1e3 * sum(w["host_s"]) / n if n else None
