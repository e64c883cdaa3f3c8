"""wgsparkl_tpu_torch — the PyTorch/CUDA port of wgsparkl_tpu for NVIDIA Hopper.

The JAX package ``wgsparkl_tpu`` stays the reference; this package runs the
same MLS-MPM paths in PyTorch: the 3D sand box and the 2D scenes with
two-way (or per-body one-way) CPIC rigid coupling to fixed, kinematic and
dynamic bodies with body contacts and joints, mesh colliders (trimesh,
heightfield, polyline), and scenes with no collider,
on the bounded block grid, (3D) the sparse, unbounded domain, or the dense
grid of the dense and blocked transfers, with
corotated or neo-Hookean elasticity,
several materials and fracture.  The Pallas kernels
of those paths are rewritten as hand-written CUDA C++ kernels for sm_90a
(``csrc/``).

Every kernel wrapper dispatches on the device of its tensors: a CPU tensor
takes the module's plain PyTorch version, a CUDA tensor launches the kernel
(built on first use by ``_cuda.load``) or raises.  Each wrapper counts the
kernel launches the host issues in ``wrapper.launches``; those a frame
graph's replay runs are counted apart (``replayed_launch_counts``).
"""

__version__ = "0.1.0"

import torch as _torch

# Counterpart of wgsparkl_tpu/__init__.py's matmul-precision pin: the
# engine's contract is fp32 trajectories, so TF32 stays off everywhere.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

# The JAX package's top-level exports (no kernel is built on import).
from wgsparkl_tpu_torch import models, solver  # noqa: E402,F401
from wgsparkl_tpu_torch.params import SimulationParams  # noqa: E402,F401


def kernel_wrappers():
    """{name: wrapper} of the hand-written kernels: the 3D path's five
    (A-E), the collider-free P2G (F), the 2D path's three (G-I), the dim=2
    entry of kernel C, the rigid solve (body contacts and joints), the
    mesh node-CDF pass (bounded and sparse entries), the dense transfer's
    particle CDF, P2G and G2P (either dimension), the in-kernel math probe,
    the P2G ablation probe and the window scatter's pull."""
    from wgsparkl_tpu_torch.collision.cdf import dense_pcdf
    from wgsparkl_tpu_torch.math.probe import math_probe
    from wgsparkl_tpu_torch.ops import transfer2d
    from wgsparkl_tpu_torch.ops.ablation import p2g_ablation
    from wgsparkl_tpu_torch.ops.blocked import scatter_tiles_pull
    from wgsparkl_tpu_torch.ops.compact import compact_flagged
    from wgsparkl_tpu_torch.ops.g2p import g2p_rows
    from wgsparkl_tpu_torch.ops.p2g import p2g_tiles
    from wgsparkl_tpu_torch.ops.p2g_cdf import p2g_cdf_tiles
    from wgsparkl_tpu_torch.ops.permute import permute_lanes
    from wgsparkl_tpu_torch.ops.rigid_cdf import mesh_node_cdf, mesh_node_cdf_sparse
    from wgsparkl_tpu_torch.ops.transfer import dense_g2p, dense_p2g
    from wgsparkl_tpu_torch.ops.update_rows import update_rows, update_rows2d
    from wgsparkl_tpu_torch.rigid.solve import rigid_solve

    return {
        "p2g_cdf": p2g_cdf_tiles,
        "g2p": g2p_rows,
        "update_rows": update_rows,
        "permute": permute_lanes,
        "compact": compact_flagged,
        "p2g": p2g_tiles,
        "pcdf2d": transfer2d.pcdf_rows,
        "p2g2d": transfer2d.p2g_tiles,
        "g2p2d": transfer2d.g2p_rows,
        "update_rows2d": update_rows2d,
        "rigid_solve": rigid_solve,
        "mesh_cdf": mesh_node_cdf,
        "mesh_cdf_sparse": mesh_node_cdf_sparse,
        "dense_pcdf": dense_pcdf,
        "dense_p2g": dense_p2g,
        "dense_g2p": dense_g2p,
        "math_probe": math_probe,
        "p2g_ablation": p2g_ablation,
        "scatter_pull": scatter_tiles_pull,
    }


def reset_launch_counts():
    """Set every kernel's launch counts to 0: the host's (launch_counts)
    and the frame graphs' (replayed_launch_counts)."""
    from wgsparkl_tpu_torch import pipeline

    for w in kernel_wrappers().values():
        w.launches = 0
    pipeline._replayed_launches.clear()


def launch_counts():
    """{kernel: the launches the host issued}, the wrappers' own counts."""
    return {k: w.launches for k, w in kernel_wrappers().items()}


def replayed_launch_counts():
    """{kernel: its launches inside frame-graph replays}: each replay of a
    frame's substeps (pipeline._frame_graph) adds the launches that its
    capture issued, which launch_counts leaves out."""
    from wgsparkl_tpu_torch import pipeline

    return {k: pipeline._replayed_launches.get(k, 0) for k in kernel_wrappers()}
