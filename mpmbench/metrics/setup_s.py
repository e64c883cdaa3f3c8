"""setup_s: process start (the first statement of mpmbench/run.py) to the
first timed frame: imports, the scene build and its mesh sampling, kernel
build or load, the warm frame and restore; host clock."""


def read(ctx):
    return ctx["setup_s"]
