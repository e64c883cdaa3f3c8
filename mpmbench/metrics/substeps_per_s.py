"""substeps_per_s: every substep completed in the window over the window's
whole wall time (episode restores and synchronises included); host clock."""


def read(ctx):
    w = ctx["window"]
    return w["frames"] * ctx["substeps"] / w["wall_s"] if w["frames"] else None
