"""3D sand in a box with a spinning paddle (examples/sand3.py on the port):
scenes.sand_box_3d at nxz = max(8, 45 SCALE), ny = max(16, 100 SCALE), 20
substeps a frame.

    python -m wgsparkl_tpu_torch.examples.sand3
"""

from wgsparkl_tpu_torch import scenes
from wgsparkl_tpu_torch.examples import common


def build(scale: float = 0.4, device=None, transfer: str = "pallas", group: int = 256,
          **mpm_kw):
    kw = {**common.transfer_kw(transfer, group), **mpm_kw}
    return scenes.sand_box_3d(nxz=max(8, int(45 * scale)), ny=max(16, int(100 * scale)),
                              cell_width=1.0, num_substeps=20, device=device, **kw)


def main():
    data = build(common.scale(0.4), common.device(), **common.env_kw())
    print(f"sand3: {data.num_particles} particles, grid {data.config.grid.shape}")
    common.run_example(data, num_substeps=20, frames=60, name="sand3")


if __name__ == "__main__":
    main()
