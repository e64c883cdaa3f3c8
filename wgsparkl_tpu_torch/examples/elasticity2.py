"""2D elastic columns (examples/elasticity2.py on the port):
scenes.elastic_blocks_2d at n_side = max(32, 700 SCALE), 15 substeps a
frame.

    python -m wgsparkl_tpu_torch.examples.elasticity2
"""

from wgsparkl_tpu_torch import scenes
from wgsparkl_tpu_torch.examples import common


def build(scale: float = 0.2, device=None, transfer: str = "pallas", group: int = 256,
          **mpm_kw):
    kw = {**common.transfer_kw(transfer, group), **mpm_kw}
    return scenes.elastic_blocks_2d(n_side=max(32, int(700 * scale)), num_substeps=15,
                                    device=device, **kw)


def main():
    data = build(common.scale(0.2), common.device(), **common.env_kw())
    print(f"elasticity2: {data.num_particles} particles, grid {data.config.grid.shape}")
    common.run_example(data, num_substeps=15, frames=60, name="elasticity2")


if __name__ == "__main__":
    main()
