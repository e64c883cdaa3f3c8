"""Collider kind `polyline`, the program's part: the port's shape of the
inputs that colliders/polyline.py made."""


def shape(c):
    from wgsparkl_tpu_torch.collision.shapes import Collider

    return Collider.polyline(c.data["vertices"])
