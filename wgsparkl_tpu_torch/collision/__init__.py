from wgsparkl_tpu_torch.collision.shapes import (
    SHAPE_BALL,
    SHAPE_CAPSULE,
    SHAPE_CUBOID,
    SHAPE_HALFSPACE,
    SHAPE_POLYLINE,
    SHAPE_TRIMESH,
    SHAPE_HEIGHTFIELD,
    Collider,
    project_on_boundary,
)


def __getattr__(name):
    # `cdf` loads on first use: it imports ops/rows, which imports this
    # package's cdf_channel.
    if name == "cdf":
        import importlib

        return importlib.import_module(f"{__name__}.cdf")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "SHAPE_BALL",
    "SHAPE_CAPSULE",
    "SHAPE_CUBOID",
    "SHAPE_HALFSPACE",
    "SHAPE_POLYLINE",
    "SHAPE_TRIMESH",
    "SHAPE_HEIGHTFIELD",
    "Collider",
    "project_on_boundary",
    "cdf",
]
