"""Collider kind `heightfield`, the program's part: the port's shape of the
inputs that colliders/heightfield.py made."""


def shape(c):
    from wgsparkl_tpu_torch.collision.shapes import Collider

    return Collider.heightfield(c.data["heights"], c.data["scale"])
