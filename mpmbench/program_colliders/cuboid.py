"""Collider kind `cuboid`, the program's part: the port's shape of the
inputs that colliders/cuboid.py made."""


def shape(c):
    from wgsparkl_tpu_torch.collision.shapes import Collider

    return Collider.cuboid(*c.data["half_extents"].tolist())
