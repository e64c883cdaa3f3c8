"""The MPM step on the bounded block grid, the sparse 3D domain and the dense
grid (port of wgsparkl_tpu/pipeline.py: MpmConfig, MpmData, MpmPipeline,
RigidBodyDesc, build_rigid_world, StepDiag, step / step_pallas /
step_with_diag, the one-substep entry points substep / substep_blocked /
substep_pallas, the bounded and sparse branches of `_substep_pallas_rows`,
`_sparse_chan_grid`, the bounded branch of `_substep_pallas_rows_2d`, and
the dense and blocked transfers).

`transfer` picks the path.  "pallas" (the port's default) is the kernel
path below; "dense" (the JAX package's default) and "blocked" run the
dense transfer on the whole row-major node grid, 3D or 2D (`_substep_dense`,
in the JAX package's order): world mass properties; the node CDF of every
collider every substep (no frame hoist; mesh colliders through the mesh
pass); the particle CDF (kernel dense_pcdf); P2G with the CPIC impulses
(kernel dense_p2g); the grid update; G2P with ghost velocities (kernel
dense_g2p); the particle update (kernel C on the row matrix, carried through
the frame as on the kernel path); the rigid update.  "blocked" first sorts
the rows by home block (kernel D) and builds the job table (kernel E):
particles come back block-sorted, and the lanes of jobs past max_jobs take
no part in P2G and get zero velocity and gradient from G2P
(ops/blocked_transfer.py).  Neither keeps a StepDiag counter.

One 3D substep, in order: block sort keys; stable sort and row permute
(kernel D); job table (kernel E inside build_jobs); window gather of the
frame-static node-CDF channels; fused particle CDF + P2G (kernel A);
scatter to the grid; grid velocity; window gather; G2P (kernel B); fused
particle update (kernel C); rigid-body update.  A 2D substep has the same
phases with the particle CDF (kernel G) and P2G (kernel H) apart, G2P
kernel I and the dim=2 branch of kernel C.  A scene with no collider (the
world then holds one inert body slot) skips every CDF phase: P2G is kernel
F in 3D and kernel H at nc = 0 in 2D, and the other kernels run with
nc = 0, a zero gate level and zero particle-CDF rows.

Colliders are analytic (cuboids, balls, capsules and halfspaces, fixed,
kinematic or dynamic) or meshes (trimeshes and heightfields in 3D,
polylines in 2D, fixed or kinematic), mixed freely.  A mesh collider's node
CDF comes from its surface samples through the mesh node-CDF pass
(ops/rigid_cdf.py, the mesh_cdf kernel); a scene with one runs the dense
mode.  A dynamic body is a moving collider with mass: the
CPIC impulses move it (two-way coupling, or one-way per body through
`coupling`), and the rigid update after the kernels resolves its contacts
with the other colliders and the joints (`rigid_bodies_update`; on the card
in one launch of the rigid-solve kernel, rigid/solve.py).  The CDF modes
are the JAX package's:
  * gathered hybrid (the default): the never-moving colliders' node-CDF
    channel grid is built once per frame and gathered per job window; in
    3D the moving colliders are merged in-kernel at the windows of jobs a
    conservative reach test marks (gate level 2);
  * dense: with no never-moving collider in 3D, with any moving collider
    in 2D, and with any mesh collider, every substep evaluates the moving
    analytic colliders' node CDF and the mesh pass on the whole grid
    (merged with the frame's static part) and gathers it;
  * chan-free (`chan_free=True` or the construction-time heuristic): no
    channel grid; the kernels evaluate every collider at the window nodes,
    the levels coming from reach tests: in 3D the static ones at gate level
    1 and all at level 2; in 2D all at the one level a reach test against
    every collider gives.  A mesh scene is never chan-free (the option is
    kept in the configuration and ignored, as the JAX package does).
`fold_vel=True` (off by default, as in the JAX package) skips the grid
velocity pass: G2P (B or I) reads the raw momentum and mass tiles and does
the grid update at its window nodes.

The sparse domain (`MpmData(..., sparse=True)`, 3D, 4^3 blocks) has no grid
box: particles sort by packed block keys (ops/blocked.py), the occupied
blocks (at most kmax get jobs) and their {0,1}^3 neighbours form the
active table (at most amax slots), and the grid is [amax + 1, 64, 4] slots
into it, the ghost slot amax reading zero.  The window moves address slots
(the job's octant neighbours looked up in the table); kernels A-F run
unchanged.  Outside the chan-free mode every substep evaluates every
collider's node CDF, and the mesh pass on slots, at the active slots' nodes
(`_sparse_chan_grid`), and the kernels evaluate no collider; there is no
frame hoist.

Every step takes an optional `comm` (parallel/comm.py), this rank's view of
a multi-device run, in the place of the JAX package's axis_name: with one,
the substeps sum the grid and the rigid impulses over the ranks after P2G
(the particle-sharded mode, every transfer), or, under a configuration with
spatial_devices (parallel/domain.spatial_config, the pallas path), migrate
the particles that left the rank's x slab after the sort and exchange the
slab's boundary plane after P2G (`_migrate_x`, `_halo_exchange_x`,
`_halo_exchange_sparse`); parallel/domain.py builds the sharded step.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from wgsparkl_tpu_torch.collision import cdf_channel as cch
from wgsparkl_tpu_torch.collision import shapes as shp
from wgsparkl_tpu_torch.collision.cdf import dense_pcdf, node_cdf
from wgsparkl_tpu_torch.device import resolve
from wgsparkl_tpu_torch.grid import GridConfig
from wgsparkl_tpu_torch.math import div
from wgsparkl_tpu_torch.ops import blocked as bk
from wgsparkl_tpu_torch.ops import rows as R
from wgsparkl_tpu_torch.ops import rigid_cdf
from wgsparkl_tpu_torch.ops import rows2d as R2
from wgsparkl_tpu_torch.ops.blocked_transfer import live_end
from wgsparkl_tpu_torch.ops.g2p import g2p_rows
from wgsparkl_tpu_torch.ops.p2g import p2g_tiles
from wgsparkl_tpu_torch.ops.p2g_cdf import p2g_cdf_tiles
from wgsparkl_tpu_torch.ops.particle_update import ELASTIC_MODELS
from wgsparkl_tpu_torch.ops.permute import permute_lanes
from wgsparkl_tpu_torch.ops.transfer import dense_g2p, dense_p2g
from wgsparkl_tpu_torch.ops.transfer import grid_update as _grid_velocity
from wgsparkl_tpu_torch.ops.transfer2d import g2p_rows as g2p_rows2d
from wgsparkl_tpu_torch.ops.transfer2d import p2g_tiles as p2g_tiles2d
from wgsparkl_tpu_torch.ops.transfer2d import pcdf_rows as pcdf_rows2d
from wgsparkl_tpu_torch.ops.update_rows import update_rows, update_rows2d
from wgsparkl_tpu_torch.params import SimulationParams, velocity_limit
from wgsparkl_tpu_torch.rigid import body as body_mod
from wgsparkl_tpu_torch.rigid import sampling
from wgsparkl_tpu_torch.rigid import solve as rigid_tables
from wgsparkl_tpu_torch.rigid.body import RigidWorld
from wgsparkl_tpu_torch.rigid.solve import rigid_solve
from wgsparkl_tpu_torch.solver import Models, Particles, attach_material_table
from wgsparkl_tpu_torch.utils import tracing

# Per-body coupling modes (MpmConfig.coupling): a one-way body sees the
# matter (particle CDF, ghost velocities) but takes no impulse from it.
COUPLING_ONE_WAY = 1
COUPLING_TWO_WAY = 2


@dataclasses.dataclass
class SimState:
    particles: Particles
    models: Models
    bodies: RigidWorld
    meshes: Optional[rigid_cdf.MeshColliders] = None


@dataclasses.dataclass(frozen=True)
class MpmConfig:
    """Static configuration of a scene's step.  transfer: "pallas" (the
    kernel path), "dense" or "blocked"; group / max_jobs: the job table of
    the pallas and blocked paths; job_chunk: the JAX package's job chunk,
    to which MpmData rounds max_jobs.  No step reads job_chunk (the port
    runs no chunked job scan), so it takes no part in comparisons: two
    configurations that step alike compare equal."""

    grid: GridConfig
    collider_types: Tuple[int, ...] = ()
    transfer: str = "pallas"
    group: int = 256
    job_chunk: int = dataclasses.field(default=32, compare=False)
    max_jobs: int = 0
    by: int = 4
    n_materials: int = 1
    static_slots: Tuple[int, ...] = ()
    elastic_model: str = "corotated"
    chan_free: bool = False
    fold_vel: bool = False
    # Slots whose contacts the rigid update resolves (the dynamic bodies;
    # empty when MpmData was built with body_contacts=False).
    dynamic_slots: Tuple[int, ...] = ()
    # COUPLING_ONE_WAY / COUPLING_TWO_WAY a slot (empty: all two-way).
    coupling: Tuple[int, ...] = ()
    # Normalised joints (b, c, anchor_b, anchor_c, kind, extra), see
    # _normalize_joints.
    joints: Tuple = ()
    # Mesh collider slots, and the JAX package's sample job geometry
    # (group, scan chunk, table size), carried so that both packages'
    # configurations compare equal; the port's mesh pass runs no job table.
    mesh_cids: Tuple[int, ...] = ()
    sample_group: int = 128
    sample_chunk: int = 32
    sample_max_jobs: int = 0
    # The sparse domain: occupied blocks with jobs (kmax) and active slots
    # (amax) a substep.
    sparse: bool = False
    kmax: int = 0
    amax: int = 0
    # Spatial x-slab decomposition (parallel/domain.spatial_config): the x
    # axis is split into spatial_devices slabs, one a rank; particles that
    # cross a slab boundary migrate through buffers of migration_cap lanes
    # a side; the sparse halo exchange ships at most halo_cap (key, row)
    # pairs a boundary plane.
    spatial_devices: int = 0
    migration_cap: int = 2048
    halo_cap: int = 1024

    @property
    def num_colliders(self) -> int:
        return len(self.collider_types)

    @property
    def cdf_chan_free(self) -> bool:
        """The chan-free CDF mode in force: never with a mesh collider."""
        return self.chan_free and not self.mesh_cids


@dataclasses.dataclass
class StepDiag:
    """On-device counters of one frame, the most over its substeps of: the
    jobs needed beyond max_jobs (their particles are masked out); in the
    sparse domain the distinct occupied blocks beyond kmax (their particles
    freeze) and the active blocks beyond amax (their nodes read the zero
    ghost).  Under the spatial decomposition also: the slab crossers beyond
    migration_cap, summed over substeps (they stay parked outside the
    slab); the live lanes past the shard's capacity at the frame's end
    (lost); and the sparse boundary-plane slots beyond halo_cap, summed
    (their exchange is dropped).  These six (FAULTS) are 0 when healthy;
    the sparse domain also keeps its peak occupied (sparse_n_occ) and
    active (sparse_n_active) blocks, its spatial halo exchange the peak
    active blocks of a boundary plane (halo_n_plane, to size halo_cap), and
    the spatial decomposition the movers a rank shipped (migrated, summed),
    which are no fault.  The sharded step returns each counter
    as a [world] vector of the ranks' values."""

    job_overflow: torch.Tensor
    sparse_occ_overflow: torch.Tensor
    sparse_act_overflow: torch.Tensor
    sparse_n_occ: torch.Tensor
    sparse_n_active: torch.Tensor
    migration_dropped: torch.Tensor
    live_lost: torch.Tensor
    halo_dropped: torch.Tensor
    halo_n_plane: torch.Tensor
    migrated: torch.Tensor

    FAULTS = ("job_overflow", "sparse_occ_overflow", "sparse_act_overflow",
              "migration_dropped", "live_lost", "halo_dropped")

    @classmethod
    def zeros(cls, device="cpu") -> "StepDiag":
        return cls(*(torch.zeros((), dtype=torch.int32, device=device)
                     for _ in dataclasses.fields(cls)))

    def _overflows(self):
        return [(k, int(getattr(self, k).max())) for k in self.FAULTS]

    def any_overflow(self) -> bool:
        return any(v > 0 for _, v in self._overflows())

    def summary(self) -> str:
        flags = [f"{k}={v}" for k, v in self._overflows() if v > 0]
        return "OK" if not flags else "OVERFLOW: " + ", ".join(flags)


@dataclasses.dataclass(frozen=True)
class RigidBodyDesc:
    """Host-side body + collider (rotation: an angle in 2D, a scaled-axis
    vector in 3D)."""

    collider: shp.Collider
    translation: Tuple[float, ...]
    rotation: object = None
    body_type: str = "fixed"
    density: float = 1000.0
    linvel: Optional[Tuple[float, ...]] = None
    angvel: object = None


def build_rigid_world(descs: Sequence[RigidBodyDesc], dim: int = 3,
                      device=None) -> RigidWorld:
    """The bodies of `descs` as a RigidWorld on `device` (None: the card);
    a dynamic body takes its inverse mass (every axis) and inverse inertia
    from its collider's shape and density."""
    device = resolve(device)
    b = max(len(descs), 1)
    na = 3 if dim == 3 else 1
    rots, poss, lin, ang, params, inv_m, inv_i = [], [], [], [], [], [], []
    for d in descs:
        poss.append(np.asarray(d.translation, np.float32))
        if dim == 2:
            a = 0.0 if d.rotation is None else float(d.rotation)
            rots.append(np.array([np.cos(a), np.sin(a)], np.float32))
        else:
            rvec = (np.zeros(3, np.float32) if d.rotation is None
                    else np.asarray(d.rotation, np.float32))
            angle = float(np.linalg.norm(rvec))
            axis = (rvec / angle if angle > 1e-12
                    else np.array([1.0, 0, 0], np.float32))
            rots.append(np.array([np.cos(0.5 * angle),
                                  *(np.sin(0.5 * angle) * axis)], np.float32))
        lin.append(np.zeros(dim, np.float32) if d.linvel is None
                   else np.asarray(d.linvel, np.float32))
        ang.append(np.zeros(na, np.float32) if d.angvel is None
                   else np.atleast_1d(np.asarray(d.angvel, np.float32)))
        params.append(d.collider.padded_params())
        if d.body_type == "dynamic":
            if d.collider.shape_type in shp.MESH:
                # The JAX package has no mass properties for a mesh (its
                # build fails on the missing inertia): refuse it plainly.
                raise ValueError("a mesh collider cannot be dynamic: give it "
                                 "body_type 'fixed' or 'kinematic'")
            mass, _, inertia = body_mod.shape_mass_properties(d.collider, d.density,
                                                              dim)
            inv_m.append(np.full(dim, 1.0 / mass, np.float32))
            inv_i.append(np.linalg.inv(inertia).astype(np.float32))
        else:
            inv_m.append(np.zeros(dim, np.float32))
            inv_i.append(np.zeros((na, na), np.float32))
    t = lambda x: torch.as_tensor(np.stack(x), device=device)  # noqa: E731
    zd = torch.zeros((b, dim), device=device)
    if not descs:
        zi = torch.zeros((b, na, na), device=device)
        rot = torch.zeros((b, 4 if dim == 3 else 2), device=device)
        rot[:, 0] = 1.0
        return RigidWorld(rot, zd, zd.clone(), torch.zeros((b, na), device=device),
                          zd.clone(), zd.clone(), zd.clone(), zi, zi.clone(),
                          torch.zeros((b, 8), device=device))
    return RigidWorld(rot=t(rots), pos=t(poss), linvel=t(lin), angvel=t(ang),
                      local_com=zd.clone(), world_com=zd.clone(),
                      inv_mass=t(inv_m), inv_inertia_local=t(inv_i),
                      inv_inertia_world=t(inv_i), shape_params=t(params))


def _normalize_joints(joints, bodies, dim: int):
    """User joint specs -> the static MpmConfig.joints tuples (b, c,
    anchor_b, anchor_c, kind, extra) (a copy of the JAX package's).

    Accepted: (b, c, ab, ac) or (b, c, ab, ac, "ball"); (b, c, ab, ac,
    "fixed"), the current relative rotation captured as the weld target;
    (b, c, ab, ac, "revolute", axis), a 3D hinge about axis in b's frame
    (in 2D the same as ball); (b, c, ab, ac, "prismatic", axis), a slider
    along axis in b's frame with the relative rotation welded.  The initial
    rotations come from build_rigid_world on the CPU."""
    if not joints:
        return ()
    rot0 = None
    out = []

    def _rel0(b, c):
        """Initial relative rotation rot_b^-1 rot_c as a static tuple."""
        if dim == 2:
            (cb, sb), (cc, sc) = rot0[b], rot0[c]
            return (float(cb * cc + sb * sc), float(cb * sc - sb * cc))
        wb, xb, yb, zb = rot0[b]
        w1, x1, y1, z1 = wb, -xb, -yb, -zb
        w2, x2, y2, z2 = rot0[c]
        return (
            float(w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2),
            float(w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2),
            float(w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2),
            float(w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2),
        )

    for j in joints:
        b, c = int(j[0]), int(j[1])
        ab, ac = tuple(map(float, j[2])), tuple(map(float, j[3]))
        kind = j[4] if len(j) > 4 else "ball"
        extra = None
        if kind in ("fixed", "revolute", "prismatic") and rot0 is None:
            rot0 = build_rigid_world(bodies, dim, "cpu").rot.double().numpy()
        if kind == "fixed":
            extra = _rel0(b, c)
        elif kind == "prismatic":
            ax = np.asarray(j[5], np.float64)
            ax = ax / max(np.linalg.norm(ax), 1e-12)
            extra = (tuple(map(float, ax)), _rel0(b, c))
        elif kind == "revolute":
            if dim == 2:
                kind = "ball"
            else:
                from wgsparkl_tpu_torch.math import pose as _pm

                ax = np.asarray(j[5], np.float64)
                ax = ax / max(np.linalg.norm(ax), 1e-12)
                q_b = torch.as_tensor(rot0[b], dtype=torch.float32)
                q_c = torch.as_tensor(rot0[c], dtype=torch.float32)
                a_world = _pm.quat_rotate(q_b, torch.as_tensor(ax, dtype=torch.float32))
                ax_c = _pm.quat_inv_rotate(q_c, a_world)
                extra = (tuple(map(float, ax)), tuple(map(float, ax_c.tolist())))
        elif kind != "ball":
            raise ValueError(f"unknown joint kind {kind!r}")
        out.append((b, c, ab, ac, kind, extra))
    return tuple(out)


def pallas_npad(n: int, group: int) -> int:
    """Lane padding of the row matrix: a multiple of 2048 with >= group
    lanes of slack past the particles."""
    return -((n + group) // -2048) * 2048


def _body_table(bodies: RigidWorld, params: SimulationParams, grid: GridConfig):
    """[32, 128] body table (ops/rows.body_table's rows 0-23); row 24
    lanes 0-2 gravity * dt, lane 3 the velocity clamp."""
    bt = R.body_table(bodies)
    bt[24, :3] = params.gravity * params.dt
    bt[24, 3].fill_(velocity_limit(grid.cell_width, params.dt))  # no host copy
    return bt


def _body_table_2d(bodies: RigidWorld, params: SimulationParams,
                   grid: GridConfig):
    """[16, 128] 2D body table (ops/rows.body_table's rows 0-11); row 13
    lanes 0-1 gravity * dt, lane 2 the velocity clamp."""
    bt = R.body_table(bodies)
    bt[13, :2] = params.gravity * params.dt
    bt[13, 2].fill_(velocity_limit(grid.cell_width, params.dt))
    return bt


def _node_cdf_static(bodies: RigidWorld, cfg: MpmConfig):
    """Analytic node CDF of the static slots at block-major node positions."""
    pos = bk.block_major_node_positions_ch(cfg.grid, cfg.by, bodies.pos.device)
    return node_cdf(cfg.collider_types, bodies.shape_params, bodies.rot, bodies.pos,
                    pos, cfg.grid.cell_width, only=frozenset(cfg.static_slots))


def _node_cdf_full(bodies: RigidWorld, cfg: MpmConfig, static_part=None,
                   meshes=None):
    """Node CDF at block-major node positions: of every analytic collider,
    or of the moving ones merged with static_part (the static slots' triple
    of this frame), which gives the same triple exactly; then the mesh
    pass of meshes merged in (a mesh key strictly closer wins)."""
    pos = bk.block_major_node_positions_ch(cfg.grid, cfg.by, bodies.pos.device)
    only = None
    if static_part is not None:
        only = frozenset(i for i in range(cfg.num_colliders)
                         if i not in cfg.static_slots)
    tri = node_cdf(cfg.collider_types, bodies.shape_params, bodies.rot, bodies.pos,
                   pos, cfg.grid.cell_width, only=only)
    if static_part is not None:
        tri = cch.merge_node_cdf(static_part, tri)
    if cfg.mesh_cids:
        with tracing.span("mpm.mesh_pass"):
            key, word = rigid_cdf.mesh_pass(meshes, bodies, cfg.grid, cfg.by)
        tri = rigid_cdf.merge_mesh_into_node_cdf(*tri, key, word)
    return tri


def _cdf_chan_grid(node_dist, node_aff, node_closest, nrows: int, bsd: int):
    """Node CDF -> channel grid [nrows + 1, bsd, 4] (aff low, aff high,
    closest, dist); row nrows is the ghost block (closest = -1)."""
    lo, hi = R.aff_halves(node_aff)
    g = torch.stack([lo, hi, node_closest.to(torch.float32), node_dist], -1)
    ghost = torch.zeros((1, bsd, 4), dtype=torch.float32, device=g.device)
    ghost[..., 2] = -1.0
    return torch.cat([g.reshape(nrows, bsd, 4), ghost], 0)


def _jbody_gate(ntiles, wvol: int, static_slots=None):
    """Per-job CPIC gate level: 0 no collider node in the window, 1 only
    static closest bodies, 2 some node's closest body can move.  Without
    static_slots (the 2D path) only 0 and 2."""
    wmask = (torch.arange(ntiles.shape[1], device=ntiles.device) < wvol)[None, :]
    closest = ntiles[..., 2]
    any_c = torch.any(((ntiles[..., 0] + ntiles[..., 1] > 0.0) | (closest >= 0.0))
                      & wmask, dim=1)
    if static_slots is None:
        return any_c.to(torch.int32) * 2
    is_static = torch.zeros_like(closest, dtype=torch.bool)
    for s in static_slots:
        is_static = is_static | (closest == float(s))
    moving = torch.any((closest >= 0.0) & ~is_static & wmask, dim=1)
    return torch.where(moving, 2, torch.where(any_c, 1, 0)).to(torch.int32)


def _moving_reach_gate(bcells, bodies: RigidWorld, desc, wsh, h: float):
    """[J] bool: the job window may lie within node-CDF reach (1.5 cells)
    of a collider of desc ((slot, shape), ...): window-centre surface
    distance against the reach plus the window half-diagonal (false
    positives only promote the gate)."""
    dim = bcells.shape[1]
    ctr = [(bcells[:, a].to(torch.float32) + (wsh[a] - 1) * 0.5) * h
           for a in range(dim)]
    thresh = 1.5 * h + 0.5 * h * float(np.sqrt(sum((s - 1) ** 2 for s in wsh)))
    hit = torch.zeros(bcells.shape[0], dtype=torch.bool, device=bcells.device)
    for slot, st in desc:
        q = cch._to_local([bodies.rot[slot, k] for k in range(bodies.rot.shape[1])],
                          [bodies.pos[slot, k] for k in range(dim)], ctr)
        proj, inside = cch.project(st, bodies.shape_params[slot], q)
        # A rotation keeps lengths: the local gap is the world distance.
        d = [proj[a] - q[a] for a in range(dim)]
        sq = d[0] * d[0]
        for a in range(1, dim):
            sq = sq + d[a] * d[a]
        hit = hit | inside | (torch.sqrt(sq) <= thresh)
    return hit


def _auto_chan_free(grid, by, desc, bodies, pos, gravity) -> bool:
    """The JAX package's construction-time CDF-mode heuristic: True
    (in-kernel "chan-free" CDF) only when few blocks lie within collider
    reach and no collider catches the settling matter."""
    if not desc:
        return False
    dim = grid.dim
    nb = bk.num_blocks(grid, by)
    bsh = bk.block_shape(dim, by)
    wsh = bk.window_shape(dim, by)
    coords = np.stack(np.meshgrid(*(np.arange(n, dtype=np.int32) for n in nb),
                                  indexing="ij"), -1).reshape(-1, dim)
    bcells = torch.as_tensor(coords * np.asarray(bsh, np.int32)
                             + np.asarray(grid.origin_cell, np.int32))
    cpu = dataclasses.replace(bodies, **{f.name: getattr(bodies, f.name).cpu()
                                         for f in dataclasses.fields(bodies)})
    hit = _moving_reach_gate(bcells, cpu, desc, wsh, grid.cell_width).numpy()
    if float(hit.mean()) >= 0.15:
        return False
    g = np.asarray(gravity, np.float64)
    if np.linalg.norm(g) > 1e-12:
        ax = int(np.argmax(np.abs(g)))
        lo, hi = pos.min(0), pos.max(0)
        ctr = (coords + 0.5) * np.asarray(bsh, np.float64)
        ctr = (ctr + np.asarray(grid.origin_cell)) * grid.cell_width
        margin = 0.5 * grid.cell_width * max(bsh) + 2 * grid.cell_width
        lateral = np.ones(len(ctr), bool)
        for a in range(dim):
            if a != ax:
                lateral &= (ctr[:, a] >= lo[a] - margin) & (ctr[:, a] <= hi[a] + margin)
        downstream = (ctr[:, ax] <= hi[ax] + margin if g[ax] < 0
                      else ctr[:, ax] >= lo[ax] - margin)
        if bool((hit & lateral & downstream).any()):
            return False
    return True


def _norm(x):
    return torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))


def rigid_bodies_update(bodies, lin_imp, ang_imp, params, cfg: MpmConfig):
    """Mask the CPIC impulses of one-way bodies, apply them, cap
    velocities, integrate poses, add gravity to bodies with mass, then
    resolve the dynamic bodies' contacts and the joints on the new poses
    (rigid/solve.py: one kernel launch on the card)."""
    dt = params.dt
    tab = rigid_tables.tables(cfg, bodies.pos.device)
    if tab.coupling_mask is not None:
        lin_imp = lin_imp * tab.coupling_mask
        ang_imp = ang_imp * tab.coupling_mask
    new_lin, new_ang = body_mod.apply_impulse(bodies, lin_imp, ang_imp)
    nz = (_norm(lin_imp) != 0.0) | (_norm(ang_imp) != 0.0)
    lin_limit = float(torch.tensor(0.1 * cfg.grid.cell_width, dtype=torch.float32)) / dt
    ln, an = _norm(new_lin), _norm(new_ang)
    new_lin = torch.where(nz & (ln > lin_limit),
                          new_lin * div(lin_limit, torch.clamp(ln, min=1e-30)), new_lin)
    new_ang = torch.where(nz & (an > 1.0),
                          new_ang * (1.0 / torch.clamp(an, min=1e-30)), new_ang)
    new_rot, new_pos = body_mod.integrate_velocity(bodies, new_lin, new_ang, dt)
    mass_mask = (bodies.inv_mass != 0.0).to(new_lin.dtype)
    new_lin = new_lin + params.gravity[None, :] * mass_mask * dt
    if not tab.empty:
        # Contacts (slop 5% of a cell), then joints, on the new poses; the
        # non-dynamic bodies keep their prescribed velocities.
        world = body_mod.update_world_mass_properties(
            dataclasses.replace(bodies, rot=new_rot, pos=new_pos))
        new_lin, new_ang = rigid_solve(world, new_lin, new_ang, dt,
                                       0.05 * cfg.grid.cell_width, tab)
    return dataclasses.replace(bodies, rot=new_rot, pos=new_pos, linvel=new_lin,
                               angvel=new_ang)


def _spatial(cfg: MpmConfig, comm) -> int:
    """The slab count of a spatial substep (0 when not spatial)."""
    return cfg.spatial_devices if comm is not None else 0


def _slab_keys(cfg: MpmConfig, rank: int, world: int, live_key: int):
    """(lo, hi): the sort keys of this rank's x slab, [lo, hi).  The keys sort
    x-slowest; the edge ranks own everything beyond their slab (lo 0 on the
    first; hi live_key on the last, and in the sparse domain, whose slabs
    split the nominal grid's x blocks, lo 0 and hi live_key at the edges)."""
    nb = bk.num_blocks(cfg.grid, cfg.by)
    wx = nb[0] // world
    if cfg.sparse:
        dd2 = bk.SPARSE_DIM * bk.SPARSE_DIM
        lo = (bk.SPARSE_HALF + rank * wx) * dd2 if rank > 0 else 0
        hi = ((bk.SPARSE_HALF + (rank + 1) * wx) * dd2 if rank < world - 1
              else live_key)
        return lo, hi
    xstride = int(np.prod(nb[1:]))
    return rank * wx * xstride, (rank + 1) * wx * xstride


def _migrate_x(rows, sorted_ids, lo_key: int, hi_key: int, live_key: int,
               capx: int, comm, diag: StepDiag, sort_rows, pm: int):
    """Particle migration between x-slab owners through buffers of capx
    lanes a side (the JAX package's _migrate_x).  After the sort the movers
    to the left (keys below lo_key) are a prefix and those to the right
    (keys in [hi_key, live_key)) end at the live boundary; each side's
    first capx movers ship to the neighbour, every row of the lanes past
    the count zeroed; the sent lanes' mass is zeroed here (they sort to the
    tail), the received ones land on the last 2 capx lanes (dead padding)
    and the rows sort again.  Movers beyond capx stay parked outside the
    slab and count in diag.migration_dropped, the shipped ones in
    diag.migrated.  Returns sort_rows' result on the migrated rows."""
    npad = rows.shape[1]
    dev = rows.device
    lane = torch.arange(npad, device=dev)
    bounds = torch.tensor([lo_key, hi_key, live_key], dtype=sorted_ids.dtype,
                          device=dev)
    nl, nr0, nov = torch.searchsorted(sorted_ids, bounds).to(torch.int32).unbind()
    li = torch.arange(capx, device=dev)

    def win(start, count):
        st = torch.clamp(start, 0, npad - capx)
        buf = rows.index_select(1, st + li)
        return torch.where((li < count)[None, :], buf, 0.0)

    cl = torch.clamp(nl, max=capx)
    cr = torch.clamp(nov - nr0, max=capx)
    diag.migration_dropped = (diag.migration_dropped + (nl - cl)
                              + (nov - nr0 - cr)).to(torch.int32)
    diag.migrated = (diag.migrated + cl + cr).to(torch.int32)
    from_right = comm.shift(win(torch.zeros_like(nl), cl), -1)
    from_left = comm.shift(win(nr0, cr), +1)
    out = (lane < cl) | ((lane >= nr0) & (lane < nr0 + cr))
    rows[pm] = torch.where(out, 0.0, rows[pm])
    rows[:, npad - 2 * capx:npad - capx] = from_left
    rows[:, npad - capx:] = from_right
    return sort_rows(rows)


def _halo_exchange_x(grid_mm, p2: int, rank: int, wx: int, comm):
    """The bounded grid's halo exchange in place of the whole-grid sum (the
    JAX package's _halo_exchange_x): a window reaches one block past the
    slab in x, so a rank's P2G lands in its slab and one overhang plane of
    p2 blocks.  The overhang goes right and is added into the owner's first
    plane; the owner's reduced first plane comes back left into the
    overhang for G2P.  The first rank adds the zeros it receives; the last
    keeps its overhang (there is no owner past it)."""
    flat = grid_mm.reshape(grid_mm.shape[0], -1)
    nb_total = flat.shape[0] - 1
    ov = min((rank + 1) * wx * p2, nb_total + 1 - p2)
    recv = comm.shift(flat[ov:ov + p2], +1)
    first = rank * wx * p2
    flat[first:first + p2] = flat[first:first + p2] + recv
    back = comm.shift(flat[first:first + p2], -1)
    if rank < comm.world - 1:
        flat[ov:ov + p2] = back
    return grid_mm


def _halo_exchange_sparse(grid_mm, act, amax: int, lo_key: int, hi_key: int,
                          halo_cap: int, comm, diag: StepDiag):
    """The sparse domain's halo exchange (the JAX package's
    _halo_exchange_sparse): the boundary plane's active slots travel as
    (key, row) pairs, at most H = min(halo_cap, amax) a plane.  The
    overhang (keys from hi_key on) goes right and is added into the owner's
    slots of the same keys; a key the owner lacks routes to the ghost slot
    with a zero payload (only the sender's particles touch that node, and
    its own copy is whole).  Then the owner's reduced first plane (keys in
    [lo_key, lo_key + one x plane)) comes back left and overwrites the
    sender's slots.  The ghost stays zero; the pairs beyond H count in
    diag.halo_dropped, the larger plane's pairs in diag.halo_n_plane (a
    peak)."""
    sent = bk.SPARSE_SENTINEL
    dd2 = bk.SPARSE_DIM * bk.SPARSE_DIM
    H = min(halo_cap, amax)
    dev = act.device
    flat = grid_mm.reshape(amax + 1, -1)
    li = torch.arange(H, device=dev)

    def plane(first, last):
        s = torch.clamp(first, 0, amax - H)
        ok = (li >= first - s) & (li < last - s)
        idx = s + li
        keys = torch.where(ok, act[idx], sent)
        rows = flat.index_select(0, idx) * ok[:, None].to(torch.float32)
        return keys, rows, torch.clamp(last - first - H, min=0)

    def search(key):
        return torch.searchsorted(act, torch.tensor([key], dtype=act.dtype,
                                                    device=dev))[0].to(torch.int32)

    i_over, i_sent = search(hi_key), search(sent)
    i0, i1 = search(lo_key), search(min(lo_key + dd2, sent))
    diag.halo_n_plane = torch.maximum(diag.halo_n_plane,
                                      torch.maximum(i_sent - i_over, i1 - i0))
    hkeys, hrows, drop1 = plane(i_over, i_sent)
    rk, rr = comm.shift(hkeys, +1), comm.shift(hrows, +1)
    slots = bk.sparse_slots(act, rk, amax).long()
    flat.index_add_(0, slots, torch.where((slots < amax)[:, None], rr, 0.0))
    bkeys, brows, drop2 = plane(i0, i1)
    bkr, brr = comm.shift(bkeys, -1), comm.shift(brows, -1)
    slots2 = bk.sparse_slots(act, bkr, amax).long()
    flat[slots2] = torch.where((slots2 < amax)[:, None], brr, 0.0)
    diag.halo_dropped = (diag.halo_dropped + drop1 + drop2).to(torch.int32)
    return grid_mm


def _exchange(grid_mm, lin_imp, ang_imp, ph, cfg: MpmConfig, comm, diag):
    """After P2G on a rank of a multi-device run: the grid summed over the
    ranks, or under the spatial decomposition its halo exchanged; the
    impulses summed (span "mpm.exchange")."""
    with tracing.span("mpm.exchange"):
        if _spatial(cfg, comm) and cfg.sparse:
            grid_mm = _halo_exchange_sparse(grid_mm, ph["act"], cfg.amax, ph["lo_key"],
                                            ph["hi_key"], cfg.halo_cap, comm, diag)
        elif _spatial(cfg, comm):
            nb = bk.num_blocks(cfg.grid, cfg.by)
            grid_mm = _halo_exchange_x(grid_mm, int(np.prod(nb[1:])), comm.rank,
                                       nb[0] // comm.world, comm)
        else:
            grid_mm = comm.psum(grid_mm)
        return grid_mm, comm.psum(lin_imp), comm.psum(ang_imp)


def _job_phase(rows_all, cfg: MpmConfig, n: int, diag: StepDiag, comm=None):
    """Sort and job table of one substep (both dimensions, bounded or
    sparse): the sorted rows and their ids, the permutation, the job table
    (starts masked into the padded lanes), the jobs' block origin cells and
    window sources, the covered rank prefix, the grid's block rows
    (grid_rows, plus the ghost) and kernel C's live_below.  Counts the
    overflows into diag; a sparse substep also returns the active table
    (act) and the jobs' octant slots (tgts).  Under the spatial
    decomposition (cfg.spatial_devices and a comm) the lanes sort by mass
    (a lane of mass 0, padding or migrated out, to the very tail, past the
    overflow bucket), the slab's movers migrate between the sort and the
    job table (`_migrate_x`, a second sort; unsorted and perm are then the
    second sort's), and lo_key / hi_key hold the slab's keys."""
    grid, by, group = cfg.grid, cfg.by, cfg.group
    dim = grid.dim
    npad = rows_all.shape[1]
    dev = rows_all.device
    spatial = _spatial(cfg, comm)
    pm = R.PM if dim == 3 else R2.PM
    # Sort: gravity-fastest block keys, padding lanes to the very tail.
    lane = torch.arange(npad, device=dev)
    if cfg.sparse:
        live_below = bk.SPARSE_SENTINEL
    else:
        nb = bk.num_blocks(grid, by)
        live_below = int(np.prod(nb))

    def sort_rows(rows_in):
        pch = [rows_in[a] for a in range(dim)]
        keys = (bk.particle_sparse_keys_ch(pch, grid) if cfg.sparse
                else bk.particle_sort_keys_ch(pch, grid, by))
        live = rows_in[pm] > 0.0 if spatial else lane < n
        keys = torch.where(live, keys, live_below + 1).to(torch.int32)
        sorted_ids, perm = torch.sort(keys, stable=True)
        perm = perm.to(torch.int32)
        return rows_in, permute_lanes(rows_in, perm), sorted_ids, perm

    rows_all, rows, sorted_ids, perm = sort_rows(rows_all)
    out = {}
    if spatial:
        lo_key, hi_key = _slab_keys(cfg, comm.rank, comm.world, live_below)
        # Span "mpm.migrate_x": the moves and the second sort.
        with tracing.span("mpm.migrate_x"):
            rows_all, rows, sorted_ids, perm = _migrate_x(
                rows, sorted_ids, lo_key, hi_key, live_below, cfg.migration_cap,
                comm, diag, sort_rows, pm)
        out.update(lo_key=lo_key, hi_key=hi_key)
    if cfg.sparse:
        jobs, okeys, n_occ = bk.build_jobs_sparse(sorted_ids, group, cfg.max_jobs,
                                                  cfg.kmax)
        # Blocks past kmax freeze: no job runs over their lanes.
        jobs = bk.freeze_truncated_blocks(jobs, okeys, sorted_ids)
        act, n_active = bk.sparse_active_table(okeys, cfg.amax)
        diag.sparse_n_occ = torch.maximum(diag.sparse_n_occ, n_occ)
        diag.sparse_n_active = torch.maximum(diag.sparse_n_active, n_active)
        diag.sparse_occ_overflow = torch.maximum(diag.sparse_occ_overflow,
                                                 n_occ - cfg.kmax)
        diag.sparse_act_overflow = torch.maximum(diag.sparse_act_overflow,
                                                 n_active - cfg.amax)
        deltas, origin, _ = _sparse_tables(grid.origin_cell, dev)
        tgts = bk.sparse_slots(act, jobs["key"][None, :] + deltas[:, None], cfg.amax)
        bcells = (bk.sparse_key_coords(jobs["key"]) * 4 + origin).to(torch.int32)
        grid_rows, src = cfg.amax, bk.window_sources_slots(tgts)
        out.update(act=act, tgts=tgts)
        where = {"key": jobs["key"]}
    else:
        jobs = bk.build_jobs(sorted_ids, live_below, group, cfg.max_jobs)
        block = bk.key_to_block(jobs["block"], nb, dim)
        bcells = bk.block_origin_cells(block, nb, by, grid.origin_cell)
        grid_rows, src = live_below, bk.window_sources(block, nb, by)
        out.update(nb_total=live_below, cum=jobs["cum"])
        where = {"block": block}
    diag.job_overflow = torch.maximum(diag.job_overflow,
                                      (jobs["needed"] - cfg.max_jobs).to(torch.int32))
    # The live share of the job slots that the window scatter reads.
    tracing.count("jobs.live", jobs["needed"], most=cfg.max_jobs)
    tracing.count("jobs.slots", src.shape[0])
    live = jobs["len"] > 0
    covered_end = torch.max(torch.where(live, jobs["start"] + jobs["len"], 0))
    starts = torch.where(live, torch.clamp(jobs["start"], max=npad - group),
                         npad - group).to(torch.int32)
    jobs = {"start": starts, "len": jobs["len"], **where}
    out.update(unsorted=rows_all, perm=perm, rows=rows, sorted_ids=sorted_ids,
               jobs=jobs, bcells=bcells, covered_end=covered_end, src=src,
               grid_rows=grid_rows, live_below=live_below)
    return out


@functools.lru_cache(maxsize=None)
def _sparse_tables(origin_cell: Tuple[int, ...], device: torch.device):
    """The sparse domain's int32 constants on `device`, copied there once:
    the packed-key delta of each octant neighbour, the grid's origin cell
    and the 4^3 cell offsets of a block, row-major."""
    i32 = dict(dtype=torch.int32, device=device)
    return (torch.tensor(bk.sparse_octant_deltas(), **i32),
            torch.tensor(origin_cell, **i32),
            torch.tensor(list(np.ndindex(4, 4, 4)), **i32))


def _collider_free_inputs(wpad: int, jobs, npad: int, dev):
    """What the transfer and update kernels take in place of the CDF phase
    when the scene has no collider (as the JAX package passes them): one
    zero [1, wpad, 4] node tile that no kernel reads at nc = 0, gate level
    0 for every job, and zero particle-CDF rows [8, NPAD]."""
    return (torch.zeros((1, wpad, 4), dtype=torch.float32, device=dev),
            torch.zeros_like(jobs["len"]),
            torch.zeros((8, npad), dtype=torch.float32, device=dev))


def _cdf_mode(cfg: MpmConfig):
    """(static_desc, moving): the ((slot, shape), ...) of the never-moving
    and of the moving analytic colliders, as the kernels take them in the
    chan-free and gathered-hybrid modes; both empty in a mesh scene, which
    runs the dense mode, and in the sparse domain outside the chan-free
    mode, whose slot channel grid holds every collider."""
    if cfg.mesh_cids or (cfg.sparse and not cfg.cdf_chan_free):
        return (), ()
    desc = tuple(enumerate(cfg.collider_types))
    return (tuple(c for c in desc if c[0] in cfg.static_slots),
            tuple(c for c in desc if c[0] not in cfg.static_slots))


def _sparse_chan_grid(bodies, meshes, cfg: MpmConfig, act):
    """Channel grid [amax + 1, 64, 4] of the sparse domain: every analytic
    collider's node CDF at the nodes of the active slots (block coords x 4
    + origin + cell offset, times h, slot by slot, nodes row-major), with
    the mesh pass on the same slots merged in."""
    grid = cfg.grid
    _, origin, off = _sparse_tables(grid.origin_cell, act.device)
    cells = (bk.sparse_key_coords(act)[:, None, :] * 4 + origin + off[None])
    npos = [(cells[..., a].to(torch.float32) * grid.cell_width).reshape(-1)
            for a in range(3)]
    tri = node_cdf(cfg.collider_types, bodies.shape_params, bodies.rot, bodies.pos,
                   npos, grid.cell_width)
    if cfg.mesh_cids:
        with tracing.span("mpm.mesh_pass"):
            key, word = rigid_cdf.mesh_pass_sparse(meshes, bodies, grid, act, cfg.amax)
        n = act.shape[0] * 64
        tri = rigid_cdf.merge_mesh_into_node_cdf(*tri, key[:n], word[:n])
    return _cdf_chan_grid(*tri, cfg.amax, 64)


def _cdf_phase_3d(bodies, cfg: MpmConfig, static_chan, src, bcells, grid_rows,
                  static_cdf=None, meshes=None, act=None):
    """Node tiles, per-job gate levels and the never-moving and moving
    colliders the kernels evaluate in-kernel, for the CDF mode of cfg (see
    the module docstring); act: the sparse domain's active table."""
    static_desc, moving = _cdf_mode(cfg)
    h = cfg.grid.cell_width
    wsh, wvol, wpad = R.window_geom(cfg.by)
    dev = bcells.device
    if cfg.cdf_chan_free:
        # No tiles: level 1 where a static collider may be in reach, 2
        # where a moving one may be.
        jbody = torch.zeros(bcells.shape[0], dtype=torch.int32, device=dev)
        if static_desc:
            hit = _moving_reach_gate(bcells, bodies, static_desc, wsh, h)
            jbody = torch.where(hit, 1, jbody).to(torch.int32)
        if moving:
            hit = _moving_reach_gate(bcells, bodies, moving, wsh, h)
            jbody = torch.where(hit, 2, jbody).to(torch.int32)
        return (torch.zeros((1, wpad, 4), dtype=torch.float32, device=dev),
                jbody, static_desc, moving)
    if cfg.sparse:
        # Every collider at the active slots' nodes, every substep.
        static_chan = _sparse_chan_grid(bodies, meshes, cfg, act)
    elif static_chan is None:
        # Dense (no never-moving collider, or a mesh): every collider in the
        # tiles, the static slots' triple of the frame merged in.
        static_chan = _cdf_chan_grid(*_node_cdf_full(bodies, cfg, static_cdf, meshes),
                                     grid_rows, int(np.prod(bk.block_shape(3, cfg.by))))
        static_desc, moving = (), ()
    with tracing.span("mpm.gather_nodes", device=dev.type == "cuda"):
        ntiles = bk.gather_tiles(static_chan, src, wpad, 4)
    jbody = _jbody_gate(ntiles, wvol, cfg.static_slots)
    if moving:
        # Gathered hybrid: moving colliders possibly in reach force level 2.
        with tracing.span("mpm.moving_gate"):
            gate = _moving_reach_gate(bcells, bodies, moving, wsh, h)
        jbody = torch.maximum(jbody, torch.where(gate, 2, 0).to(torch.int32))
    return ntiles, jbody, static_desc, moving


def _scatter(mm, ph, cfg: MpmConfig):
    """The window scatter of the P2G tiles mm into a fresh grid [grid_rows +
    1, bsd, d + 1] (momentum, mass).  On the card a bounded grid's pull
    kernel writes every row (no zero fill; counter "scatter.pull" 1); the
    CPU and the sparse slot scatter add into zeros (add_rows), and the slot
    scatter's ghost is zeroed after (it drops the tiles aimed there: dead
    jobs, and octants missing from an overflowed table)."""
    dev = mm.device
    cuda = dev.type == "cuda"
    pull = cuda and not cfg.sparse
    tracing.count("scatter.pull", int(pull))
    dim = cfg.grid.dim
    shape = (ph["grid_rows"] + 1, int(np.prod(bk.block_shape(dim, cfg.by))), dim + 1)
    grid_mm = (torch.empty if pull else torch.zeros)(shape, dtype=torch.float32,
                                                     device=dev)
    with tracing.span("mpm.scatter", device=cuda):
        if pull:
            bk.scatter_tiles_pull(grid_mm, mm, ph["jobs"]["block"], ph["cum"],
                                  bk.num_blocks(cfg.grid, cfg.by), cfg.by)
        else:
            bk.scatter_tiles(grid_mm, mm, ph["src"])
        if cfg.sparse:
            grid_mm[ph["grid_rows"]].zero_()
    return grid_mm


def _substep(rows_all, bodies, params, cfg: MpmConfig, n: int, static_chan,
             mtable, diag: StepDiag, record: Optional[dict] = None,
             static_cdf=None, meshes=None, comm=None):
    """One 3D substep on the [PCHAN, NPAD] rows (lanes >= n are padding).
    static_cdf: the frame's node-CDF triple of the static slots, merged in
    the dense mode; meshes: the mesh colliders of the state; comm: this
    rank's Comm in a multi-device run (see the module docstring).

    record: when a dict is given, the inputs and outputs of the five
    kernels are stored in it (kernel checks and tests read them); under
    fold_vel its grid_mm and ftiles hold raw momentum and mass."""
    grid = cfg.grid
    by, group, nc = cfg.by, cfg.group, cfg.num_colliders
    h = grid.cell_width
    wpad = R.window_geom(by)[2]
    npad = rows_all.shape[1]
    dev = rows_all.device
    cuda = dev.type == "cuda"
    bodies = body_mod.update_world_mass_properties(bodies)
    with tracing.span("mpm.jobs"):
        ph = _job_phase(rows_all, cfg, n, diag, comm)
    rows_all, jobs, bcells, src = ph["rows"], ph["jobs"], ph["bcells"], ph["src"]
    grid_rows = ph["grid_rows"]
    static_desc, moving = _cdf_mode(cfg)
    chan_free = cfg.cdf_chan_free
    btable = _body_table(bodies, params, grid)
    if nc > 0:
        # Particle CDF + P2G against the node tiles, colliders evaluated
        # in-kernel where the mode and the gate say so.
        pdata = rows_all[:R.NCHAN].clone()
        with tracing.span("mpm.cdf"):
            ntiles, jbody, static_desc, moving = _cdf_phase_3d(
                bodies, cfg, static_chan, src, bcells, grid_rows, static_cdf, meshes,
                ph.get("act"))
        if moving and not chan_free and tracing.active():
            # The gathered-hybrid mode's live jobs at gate level 2, where A
            # and B evaluate the moving colliders: a fresh 0-d sum, which
            # keeps no larger tensor alive until the tracer reads it.
            tracing.count("jobs.moving", ((jbody == 2) & (jobs["len"] > 0)).sum())
        with tracing.span("mpm.p2g"):
            mm, imp, pcdf = p2g_cdf_tiles(pdata, ntiles, btable, jobs, bcells, jbody,
                                          h, by, group, npad, nc, moving,
                                          static_desc, chan_free)
        pdata[R.AFF] = pcdf[0, :npad]
        pdata[R.NX:R.NZ + 1] = pcdf[2:5, :npad]
        pdata[R.AFF_SPARE] = pcdf[5, :npad]
    else:
        # No collider: plain APIC P2G (kernel F), no particle CDF.
        pdata = rows_all[:R.NCHAN]
        ntiles, jbody, pcdf = _collider_free_inputs(wpad, jobs, npad, dev)
        with tracing.span("mpm.p2g"):
            mm, imp = p2g_tiles(pdata, ntiles, btable, jobs, bcells, jbody, h, by,
                                nc)
    grid_mm = _scatter(mm, ph, cfg)
    lin_imp = imp[0, 0:3, :bodies.count].T
    ang_imp = imp[0, 3:6, :bodies.count].T
    if comm is not None:
        grid_mm, lin_imp, ang_imp = _exchange(grid_mm, lin_imp, ang_imp, ph, cfg,
                                              comm, diag)

    # Grid velocity (or folded into G2P), G2P, particle update, bodies.
    if not cfg.fold_vel:
        grid_mm[..., :3] = _grid_velocity(grid_mm, params, grid)
    with tracing.span("mpm.gather_grid", device=cuda):
        ftiles = bk.gather_tiles(grid_mm, src, wpad, 4)
    with tracing.span("mpm.g2p"):
        krows = g2p_rows(pdata, ftiles, ntiles, btable, jobs, bcells, jbody, h, by,
                         group, npad, nc, moving, static_desc, chan_free,
                         cfg.fold_vel)
    with tracing.span("mpm.update"):
        rows_out = update_rows(rows_all, krows, pcdf, ph["sorted_ids"],
                               ph["covered_end"], btable, mtable, params.dt, h, nc,
                               max(cfg.n_materials, 1), ph["live_below"],
                               cfg.elastic_model)
    if record is not None:
        record.update(ph, jbody=jbody, ntiles=ntiles, btable=btable,
                      moving=moving, static_desc=static_desc,
                      chan_free=chan_free, fold_vel=cfg.fold_vel,
                      pdata=pdata, mm=mm, imp=imp, pcdf=pcdf, ftiles=ftiles,
                      krows=krows, mtable=mtable, rows_out=rows_out,
                      grid_mm=grid_mm)
    with tracing.span("mpm.rigid"):
        bodies = rigid_bodies_update(bodies, lin_imp, ang_imp, params, cfg)
    return rows_out, bodies


def _substep_2d(rows_all, bodies, params, cfg: MpmConfig, n: int, static_chan,
                mtable, diag: StepDiag, record: Optional[dict] = None,
                static_cdf=None, meshes=None, comm=None):
    """One 2D substep on the [32, NPAD] rows (the gathered, dense,
    chan-free and collider-free branches of the JAX package's
    _substep_pallas_rows_2d): in chan-free mode the kernels evaluate every
    collider at the windows of the jobs a reach test gates; else
    static_chan, the frame's channel grid when every collider is static;
    else the node CDF is evaluated on the whole grid, the moving analytic
    colliders and the mesh pass of meshes merged with static_cdf (the
    frame's static part, None when no collider is static).  The kernels
    take the analytic colliders in the chan-free mode and none in the
    others, where they read only the tiles.  record: as for _substep (the
    2D kernels' inputs and outputs; its rows are kernel G's input, cloned
    before G patched them in place into pdata); comm: as for _substep."""
    grid = cfg.grid
    group, nc = cfg.group, cfg.num_colliders
    h = grid.cell_width
    npad = rows_all.shape[1]
    dev = rows_all.device
    cuda = dev.type == "cuda"
    bodies = body_mod.update_world_mass_properties(bodies)
    with tracing.span("mpm.jobs"):
        ph = _job_phase(rows_all, cfg, n, diag, comm)
    rows_all, jobs, bcells, src = ph["rows"], ph["jobs"], ph["bcells"], ph["src"]
    nb_total = ph["grid_rows"]
    btable = _body_table_2d(bodies, params, grid)
    chan_free = cfg.cdf_chan_free
    alldesc = tuple(sorted(sum(_cdf_mode(cfg), ()))) if chan_free else ()
    if nc > 0:
        with tracing.span("mpm.cdf"):
            if chan_free:
                # No tiles: one gate level where any collider may be in reach.
                jbody = _moving_reach_gate(bcells, bodies, alldesc, R2.WSH,
                                           h).to(torch.int32)
                ntiles = torch.zeros((1, R2.WPAD, 4), dtype=torch.float32, device=dev)
            else:
                if static_chan is None:
                    # Dense: a collider moves; G, H and I read the same channels.
                    static_chan = _cdf_chan_grid(
                        *_node_cdf_full(bodies, cfg, static_cdf, meshes), nb_total, 64)
                with tracing.span("mpm.gather_nodes", device=cuda):
                    ntiles = bk.gather_tiles(static_chan, src, R2.WPAD, 4)
                jbody = _jbody_gate(ntiles, R2.WVOL)
            if record is not None:
                ph["rows"] = rows_all.clone()   # kernel G's input, for the record
            # Kernel G patches rows AFF..AFF_SPARE (aff low, normal xy, aff
            # high) of the fresh sorted rows in place with the particle CDF
            # for P2G and G2P; kernel C reads none of them from rows_all.
            pcdf = pcdf_rows2d(rows_all, ntiles, jobs, bcells, jbody, h, group,
                               npad, nc, btable, alldesc, chan_free)
    else:
        # No collider: no particle CDF (kernel G), H and I at nc = 0.
        ntiles, jbody, pcdf = _collider_free_inputs(R2.WPAD, jobs, npad, dev)
    pdata = rows_all[:R2.NCHAN]
    with tracing.span("mpm.p2g"):
        mm, imp = p2g_tiles2d(pdata, ntiles, btable, jobs, bcells, jbody, h, nc,
                              alldesc, chan_free)
    grid_mm = _scatter(mm, ph, cfg)
    # The jobs' impulses in one fixed-order reduction (_split_impulses).
    imp_sum = imp.sum(0)
    lin_imp = imp_sum[0:2, :bodies.count].T
    ang_imp = imp_sum[2:3, :bodies.count].T
    if comm is not None:
        grid_mm, lin_imp, ang_imp = _exchange(grid_mm, lin_imp, ang_imp, ph, cfg,
                                              comm, diag)

    if not cfg.fold_vel:
        grid_mm[..., :2] = _grid_velocity(grid_mm, params, grid)
    with tracing.span("mpm.gather_grid", device=cuda):
        ftiles = bk.gather_tiles(grid_mm, src, R2.WPAD, 4)
    with tracing.span("mpm.g2p"):
        krows = g2p_rows2d(pdata, ftiles, ntiles, btable, jobs, bcells, jbody, h,
                           group, npad, nc, alldesc, chan_free, cfg.fold_vel)
    with tracing.span("mpm.update"):
        rows_out = update_rows2d(rows_all, krows, pcdf, ph["sorted_ids"],
                                 ph["covered_end"], btable, mtable, params.dt, h, nc,
                                 max(cfg.n_materials, 1), nb_total,
                                 cfg.elastic_model)
    if record is not None:
        record.update(ph, jbody=jbody, ntiles=ntiles, btable=btable,
                      alldesc=alldesc, chan_free=chan_free,
                      fold_vel=cfg.fold_vel, pdata=pdata, mm=mm, imp=imp,
                      pcdf=pcdf, ftiles=ftiles,
                      krows=krows, mtable=mtable, rows_out=rows_out,
                      grid_mm=grid_mm)
    with tracing.span("mpm.rigid"):
        bodies = rigid_bodies_update(bodies, lin_imp, ang_imp, params, cfg)
    return rows_out, bodies


def _dense_node_cdf(bodies, cfg: MpmConfig, meshes=None):
    """Node CDF (dist f32, aff int32, closest int32) [M] of every collider
    on the row-major grid: the analytic colliders at the node positions,
    then the mesh pass (on 4^3 / 8^2 blocks, the grid whole blocks as in
    the JAX package) merged in."""
    grid = cfg.grid
    dev = bodies.pos.device
    tri = node_cdf(cfg.collider_types, bodies.shape_params, bodies.rot, bodies.pos,
                   grid.node_position_channels(dev), grid.cell_width)
    if cfg.mesh_cids:
        key, word = rigid_cdf.mesh_pass(meshes, bodies, grid, 4)
        idx = bk.block_major_index(grid, dev)
        tri = rigid_cdf.merge_mesh_into_node_cdf(*tri, key[idx], word[idx])
    return tri


def _cdf_rows(rows, d: int):
    """[8, NPAD] particle-CDF rows of the rows' own affinity word, signed
    distance and normal (what a collider-free substep carries over)."""
    L = R if d == 3 else R2
    pcdf = torch.zeros((8, rows.shape[1]), dtype=torch.float32, device=rows.device)
    pcdf[0] = rows[L.AFF]
    pcdf[1] = rows[L.R_SD]
    pcdf[2:2 + d] = rows[L.NX:L.NX + d]
    pcdf[2 + d] = rows[L.AFF_SPARE]
    return pcdf


def sort_rows_by_block(rows, block_ids):
    """The [C, NPAD] row matrix, every particle and model field, stably
    sorted by block id (ops/blocked.sort_by_block on the row matrix;
    kernel D moves the rows): (sorted rows, sorted ids)."""
    sorted_ids, perm = torch.sort(block_ids, stable=True)
    return permute_lanes(rows, perm.to(torch.int32)), sorted_ids


def _sort_phase(rows, cfg: MpmConfig, n: int):
    """The blocked transfer's sort: the rows stably sorted by home block
    (4^3 / 8^2 blocks, padding lanes last; kernel D) and the job table
    (kernel E inside build_jobs)."""
    grid = cfg.grid
    nb_total = int(np.prod(bk.num_blocks(grid)))
    lane = torch.arange(rows.shape[1], device=rows.device)
    keys = bk.particle_block_ids_ch([rows[a] for a in range(grid.dim)], grid)
    keys = torch.where(lane < n, keys, nb_total + 1).to(torch.int32)
    rows, sorted_ids = sort_rows_by_block(rows, keys)
    return rows, bk.build_jobs(sorted_ids, nb_total, cfg.group, cfg.max_jobs)


def _substep_dense(rows, bodies, params, cfg: MpmConfig, n: int, n_t, zero_ids,
                   mtable, n_mat: int, record: Optional[dict] = None, meshes=None,
                   comm=None):
    """One substep of the dense or the blocked transfer on the [PCHAN, NPAD]
    rows (3D or 2D; the order of the module docstring).  n_t: n as a
    one-element int32 tensor on the rows' device; zero_ids: int32 zeros
    [NPAD] (kernel C then takes every lane below n as live).  record: when
    a dict is given, the kernels' inputs and outputs are stored in it;
    comm: this rank's Comm (the grid and impulses summed after P2G)."""
    grid = cfg.grid
    d, nc = grid.dim, cfg.num_colliders
    bodies = body_mod.update_world_mass_properties(bodies)
    jobs, live = None, n_t
    if cfg.transfer == "blocked":
        rows, jobs = _sort_phase(rows, cfg, n)
        live = live_end(jobs)
    btable = (_body_table if d == 3 else _body_table_2d)(bodies, params, grid)
    node_dist = node_aff = node_closest = None
    if nc > 0:
        node_dist, node_aff, node_closest = _dense_node_cdf(bodies, cfg, meshes)
        pcdf = dense_pcdf(rows, n, node_dist, node_aff, grid, nc)
    else:
        pcdf = _cdf_rows(rows, d)
    grid_mm, lin_imp, ang_imp = dense_p2g(rows, pcdf, n, live, node_aff, node_closest,
                                          btable, grid, nc, bodies.count)
    if comm is not None:
        grid_mm, lin_imp, ang_imp = _exchange(grid_mm, lin_imp, ang_imp, None, cfg,
                                              comm, None)
    grid_vel = _grid_velocity(grid_mm, params, grid)
    krows = dense_g2p(rows, pcdf, n, live, grid_vel, node_aff, node_closest, btable,
                      grid, nc)
    update = update_rows if d == 3 else update_rows2d
    rows_out = update(rows, krows, pcdf, zero_ids, n_t, btable, mtable, params.dt,
                      grid.cell_width, nc, n_mat, 1, cfg.elastic_model, centered=True)
    if record is not None:
        record.update(rows=rows, jobs=jobs, live=live, btable=btable,
                      node_dist=node_dist, node_aff=node_aff, node_closest=node_closest,
                      pcdf=pcdf, grid_mm=grid_mm, lin_imp=lin_imp, ang_imp=ang_imp,
                      grid_vel=grid_vel, krows=krows, mtable=mtable, n_mat=n_mat,
                      rows_out=rows_out)
    bodies = rigid_bodies_update(bodies, lin_imp, ang_imp, params, cfg)
    return rows_out, bodies


def _unpack(rows, state: SimState, models, bodies, n_mat: int) -> SimState:
    """The state of the first n lanes of a frame's rows (the particles and
    models of state updated, bodies and meshes given)."""
    L = R if state.particles.dim == 3 else R2
    particles, models = L.unpack_state_rows(rows[:, :state.particles.count],
                                            state.particles, models, n_mat=n_mat)
    return SimState(particles=particles, models=models, bodies=bodies,
                    meshes=state.meshes)


def step_dense(state: SimState, params: SimulationParams, cfg: MpmConfig,
               num_substeps: int, record: Optional[dict] = None, comm=None):
    """A frame of dense or blocked substeps (cfg.transfer) carrying the
    [PCHAN, NPAD] row matrix, packed and unpacked once; a state without a
    material table gets one (the row matrix carries material ids).  The
    blocked transfer returns the particles block-sorted.  record: see
    _substep_dense (filled by the frame's last substep); comm: this rank's
    Comm in a particle-sharded run."""
    L = R if cfg.grid.dim == 3 else R2
    models, n_mat = state.models, max(cfg.n_materials, 1)
    if models.mat_table is None:
        models, n_mat = attach_material_table(state.particles, models, limit=None)
    n = state.particles.count
    npad = pallas_npad(n, cfg.group)
    with tracing.span(tracing.FRAME):
        rows = L.pack_rows_padded(state.particles, models, npad)
        n_t = torch.full((1,), n, dtype=torch.int32, device=rows.device)
        zero_ids = torch.zeros(npad, dtype=torch.int32, device=rows.device)
        bodies = state.bodies
        for _ in range(num_substeps):
            with tracing.span(tracing.SUBSTEP):
                rows, bodies = _substep_dense(rows, bodies, params, cfg, n, n_t,
                                              zero_ids, models.mat_table, n_mat,
                                              record, state.meshes, comm)
        return _unpack(rows, state, models, bodies, n_mat)


def _dense_config(cfg: MpmConfig, transfer: str) -> MpmConfig:
    if cfg.sparse:
        raise ValueError("the sparse domain runs only on transfer='pallas'")
    return cfg if cfg.transfer == transfer else dataclasses.replace(cfg,
                                                                   transfer=transfer)


def substep(state: SimState, params: SimulationParams, cfg: MpmConfig,
            comm=None) -> SimState:
    """One substep of the dense transfer, whatever cfg.transfer says (it
    reads cfg.grid, the colliders and the models' options): step_dense of
    one substep, the rows packed and unpacked in this call.  comm: this
    rank's Comm in a particle-sharded run (the grid and the impulses are
    summed over the ranks after P2G)."""
    return step_dense(state, params, _dense_config(cfg, "dense"), 1, comm=comm)


def substep_blocked(state: SimState, params: SimulationParams, cfg: MpmConfig,
                    comm=None) -> SimState:
    """One substep of the blocked transfer (4^3 / 8^2 blocks, cfg.group and
    cfg.max_jobs; the job table is built anew): the particles come out
    block-sorted, `ids` tracks each one; lanes of jobs past max_jobs take
    no part.  comm: as for substep."""
    return step_dense(state, params, _dense_config(cfg, "blocked"), 1, comm=comm)


def _hoist(bodies, cfg: MpmConfig):
    """The frame hoist of the static colliders: (channel grid or None,
    node CDF triple), from the frame's bodies."""
    static_cdf = _node_cdf_static(bodies, cfg)
    dim = cfg.grid.dim
    if cfg.mesh_cids or (dim == 2 and len(cfg.static_slots) != cfg.num_colliders):
        return None, static_cdf
    nb_total = int(np.prod(bk.num_blocks(cfg.grid, cfg.by)))
    return _cdf_chan_grid(*static_cdf, nb_total,
                          int(np.prod(bk.block_shape(dim, cfg.by)))), static_cdf


def _substeps(cfg: MpmConfig, n: int, num_substeps: int, dt: float, record, comm,
              hoist: bool, rows, bodies, gravity, mtable, meshes):
    """The hoist and the substep loop of a kernel-path frame on the packed
    rows: (rows, bodies, StepDiag).  Its tensors come last, in the order
    _frame_graph copies them; the hoist is part of what a frame graph
    replays, so a replayed frame issues it with the substeps."""
    static_chan = static_cdf = None
    # Span "mpm.hoist" in every frame: empty where nothing is hoisted
    # (no analytic static collider, substep_pallas, chan-free, sparse).
    with tracing.span("mpm.hoist", device=rows.device.type == "cuda"):
        if hoist:
            static_chan, static_cdf = _hoist(bodies, cfg)
    substep = _substep if cfg.grid.dim == 3 else _substep_2d
    params = SimulationParams(dt=dt, gravity=gravity)
    diag = StepDiag.zeros(rows.device)
    for _ in range(num_substeps):
        with tracing.span(tracing.SUBSTEP):
            rows, bodies = substep(rows, bodies, params, cfg, n, static_chan, mtable,
                                   diag, record, static_cdf=static_cdf, meshes=meshes,
                                   comm=comm)
    return rows, bodies, diag


# Why a kernel-path frame runs its substeps eagerly (frame_graph_reason), and
# "capture_failed": its key's capture raised.
EAGER_REASONS = ("cpu", "record", "comm", "tracer", "capture_failed")
# Frame graphs kept, the least recently used dropped first.  A scene steps
# under one key; a few more come from a testbed that changes its substep
# count, a restore to another particle count, or substep_pallas (one
# substep) beside step_pallas.
_GRAPH_CACHE = 4
# key -> _FrameGraph, or None where the key's capture raised (its frames run
# eagerly), least recently used first.
_graphs = collections.OrderedDict()
_graph_counts = {"captures": 0, "replays": 0, **{r: 0 for r in EAGER_REASONS}}
# Kernel name (wgsparkl_tpu_torch.kernel_wrappers) -> its launches inside
# graph replays: each replay adds what its capture issued.
_replayed_launches = {}


@dataclasses.dataclass
class _FrameGraph:
    graph: "torch.cuda.CUDAGraph"
    inputs: list        # the graph-owned tensors it reads, in _leaves order
    outputs: tuple      # (rows, bodies, StepDiag), graph-owned
    launches: dict      # kernel name -> its launches the capture issued


def frame_graph_reason(device, record=None, comm=None) -> Optional[str]:
    """Why a kernel-path frame on `device` runs its substeps eagerly (one of
    EAGER_REASONS), or None where they replay as a CUDA graph: "cpu" off the
    card; "record" (the caller reads the kernels' inputs); "comm" (a
    multi-device run); "tracer" while the tracer is on, which it is under a
    profiler too (its spans and their device markers need the host code of
    every operation).  So a profile shows the eager frame, the same kernels
    on the same inputs, and not the replay that runs unprofiled.
    No configuration is excluded: on the card no substep reads the device
    from the host (the rigid update's one read, of the contact depths in
    rigid/contacts.py, is in the rigid solve's plain version, which runs on
    CPU tensors only; the card runs the rigid_solve kernel)."""
    if torch.device(device).type != "cuda":
        return "cpu"
    if record is not None:
        return "record"
    if comm is not None:
        return "comm"
    if tracing.active():
        return "tracer"
    return None


def frame_graph_stats() -> dict:
    """Counts of the kernel-path frames since the process started:
    "captures" (a key's first frame: run eagerly, then its substeps
    captured), "replays", and the eager frames by reason (EAGER_REASONS)."""
    return dict(_graph_counts)


def drop_frame_graphs() -> None:
    """Drop every frame graph: each key's next frame runs eagerly and
    captures anew.  A graph replays the functions its capture called, so a
    caller that binds others in a kernel entry's place drops the graphs
    before and after."""
    for dev in {key[5] for key, entry in _graphs.items() if entry is not None}:
        torch.cuda.synchronize(dev)     # no replay of a dropped graph is pending
    _graphs.clear()


def _leaves(tree) -> list:
    """The tensors of a frame's inputs or outputs, in a fixed order."""
    out = []
    bk._tree_map(out.append, tree)
    return out


def _record(loop, static, dev):
    """loop(*static) captured into a CUDA graph on a side stream of the
    device, nothing run: (graph, loop's outputs, graph-owned)."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev), torch.cuda.graph(graph, stream=torch.cuda.Stream(dev)):
        out = loop(*static)
    return graph, out


def _capture(loop, args, key):
    """Capture loop(*args') into a CUDA graph, args' graph-owned copies of
    args (contiguous, whatever the layout of args); nothing runs.  Kept
    under key, or None where the capture raised (with a warning; that key's
    frames then run eagerly)."""
    import wgsparkl_tpu_torch as wt

    dev = args[0].device
    static = bk._tree_map(lambda t: t.clone(memory_format=torch.contiguous_format), args)
    torch.cuda.synchronize(dev)     # no replay of a graph dropped below is pending
    while len(_graphs) >= _GRAPH_CACHE:
        _graphs.popitem(last=False)
    # The wrappers count the launches the host issues.  The capture's run
    # nothing: they are put back, and kept as what a replay runs.  (A check
    # may have bound a plain version, which counts nothing, in a wrapper's
    # place.)
    wrappers = {k: w for k, w in wt.kernel_wrappers().items() if hasattr(w, "launches")}
    before = {k: w.launches for k, w in wrappers.items()}
    try:
        graph, out = _record(loop, static, dev)
    except Exception as e:   # noqa: BLE001 - any failure falls back, counted
        torch.cuda.synchronize(dev)
        _graphs[key] = None
        cause = f" (after {e.__context__!r})" if e.__context__ is not None else ""
        warnings.warn(f"frame graph capture failed, the frames of this configuration "
                      f"and shape run eagerly: {e!r}{cause}", RuntimeWarning)
        return False
    finally:
        launches = {k: w.launches - before[k] for k, w in wrappers.items()
                    if w.launches != before[k]}
        for k, w in wrappers.items():
            w.launches = before[k]
    _graphs[key] = _FrameGraph(graph, _leaves(static), out, launches)
    return True


def _frame_graph(loop, args, leaves, key):
    """loop(*args), the substeps of a frame, as a CUDA graph replay:
    (rows, bodies, StepDiag).  The key's first call runs eagerly and then
    captures; later calls copy args' tensors (leaves) into the graph's own
    and replay it.  The rows returned are the graph's (the unpack copies
    every field of them); the bodies and the StepDiag are fresh copies."""
    entry = _graphs.get(key, False)
    if entry is False:
        out = loop(*args)
        _graph_counts["captures" if _capture(loop, args, key) else "capture_failed"] += 1
        return out
    _graphs.move_to_end(key)
    if entry is None:
        _graph_counts["capture_failed"] += 1
        return loop(*args)
    for dst, src in zip(entry.inputs, leaves):
        dst.copy_(src)
    entry.graph.replay()
    _graph_counts["replays"] += 1
    for k, c in entry.launches.items():
        _replayed_launches[k] = _replayed_launches.get(k, 0) + c
    rows, bodies, diag = entry.outputs
    return rows, bk._tree_map(torch.clone, bodies), bk._tree_map(torch.clone, diag)


def _frame_pallas(state: SimState, params: SimulationParams, cfg: MpmConfig,
                  num_substeps: int, record: Optional[dict], comm, hoist: bool):
    """num_substeps kernel-path substeps on the row matrix, packed and
    unpacked once: (state, StepDiag).  hoist: build the static colliders'
    node CDF once for the frame (step_pallas); without it every substep
    evaluates every collider (substep_pallas, as the JAX package's passes
    no static grid to its core).  On the card the substep loop replays as
    a CUDA graph, captured once per configuration and shape, unless
    frame_graph_reason gives a reason, the hoist with it; the pack and the
    unpack run eagerly."""
    dim = cfg.grid.dim
    L = R if dim == 3 else R2
    n = state.particles.count
    slack = 2 * cfg.migration_cap if _spatial(cfg, comm) else 0
    npad = pallas_npad(n + slack, cfg.group)
    with tracing.span(tracing.FRAME):
        with tracing.span("mpm.pack"):
            rows = L.pack_rows_padded(state.particles, state.models, npad)
        # The frame hoist of the static colliders (none in the sparse
        # domain, whose nodes change with the active table).
        hoist = bool(hoist and cfg.static_slots and not cfg.cdf_chan_free and not cfg.sparse)
        loop = functools.partial(_substeps, cfg, n, num_substeps, params.dt, record, comm,
                                 hoist)
        args = (rows, state.bodies, params.gravity, state.models.mat_table, state.meshes)
        reason = frame_graph_reason(rows.device, record, comm)
        if reason is None:
            leaves = _leaves(args)
            key = (cfg, num_substeps, n, hoist, params.dt, rows.device,
                   tuple(a is None for a in args),
                   tuple((tuple(t.shape), t.dtype) for t in leaves))
            rows, bodies, diag = _frame_graph(loop, args, leaves, key)
        else:
            _graph_counts[reason] += 1
            rows, bodies, diag = loop(*args)
        if slack:
            # Live lanes sort first: any past n are cut off with the padding.
            live = (rows[L.PM] > 0.0).sum(dtype=torch.int32)
            diag.live_lost = torch.maximum(diag.live_lost, live - n)
        with tracing.span("mpm.unpack"):
            out = _unpack(rows, state, state.models, bodies, max(cfg.n_materials, 1))
    return out, diag


def step_pallas(state: SimState, params: SimulationParams, cfg: MpmConfig,
                num_substeps: int, return_diag: bool = False,
                record: Optional[dict] = None, comm=None):
    """A frame of substeps carrying the [PCHAN, NPAD] row matrix; the
    static colliders' node CDF (as a channel grid in the gathered modes,
    as a triple in the dense mode) is built once per frame.  record: see
    _substep (filled by the frame's last substep); comm: this rank's Comm
    in a multi-device run.  Under the spatial decomposition the rows carry
    2 migration_cap more lanes of slack (where migrants land), and the live
    lanes past the shard's n at the frame's end count in
    StepDiag.live_lost."""
    out, diag = _frame_pallas(state, params, cfg, num_substeps, record, comm, True)
    return (out, diag) if return_diag else out


def substep_pallas(state: SimState, params: SimulationParams, cfg: MpmConfig,
                   comm=None) -> SimState:
    """One kernel-path substep (3D or 2D): the rows packed and unpacked in
    this call.  The static colliders are not hoisted: in the gathered modes
    every collider's node CDF is evaluated on the grid (the dense CDF
    mode's tiles), which gives the same triple as the frame's hoist merged
    with the moving ones.  comm: as for step_pallas."""
    return _frame_pallas(state, params, cfg, 1, None, comm, False)[0]


def step(state, params, cfg: MpmConfig, num_substeps: int):
    """num_substeps substeps of cfg.transfer's path."""
    if cfg.transfer == "pallas":
        return step_pallas(state, params, cfg, num_substeps)
    return step_dense(state, params, cfg, num_substeps)


def step_with_diag(state, params, cfg: MpmConfig, num_substeps: int):
    """`step` and the frame's StepDiag (zero on the dense and blocked paths,
    which keep no counter, as in the JAX package)."""
    if cfg.transfer == "pallas":
        return step_pallas(state, params, cfg, num_substeps, return_diag=True)
    return (step_dense(state, params, cfg, num_substeps),
            StepDiag.zeros(state.particles.pos.device))


def _sample_meshes(bodies, mesh_cids, dim: int, cell_width: float, device):
    """(MeshColliders of the mesh slots on device or None, the JAX package's
    sample job table size for them, 0 without)."""
    if not mesh_cids:
        return None, 0
    parts, vertex_cids, offset = [], [], 0
    for slot in mesh_cids:
        col = bodies[slot].collider
        sample = sampling.sample_polyline if dim == 2 else sampling.sample_trimesh
        parts.append(sample(col.vertices, col.indices, cell_width, collider_id=slot,
                            vertex_offset=offset))
        vertex_cids.append(np.full(len(col.vertices), slot, np.int32))
        offset += len(col.vertices)
    comb = sampling.combine(parts)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)  # noqa: E731
    meshes = rigid_cdf.MeshColliders(
        sample_local=t(comb.points), sample_prim=t(comb.primitives),
        sample_cid=t(comb.collider_ids), vertices_local=t(comb.vertices),
        vertex_cid=t(np.concatenate(vertex_cids)))
    group, chunk = MpmConfig.sample_group, MpmConfig.sample_chunk
    max_jobs = -(-comb.count // group) * 4 + 64
    return meshes, -(-max_jobs // chunk) * chunk


class MpmData:
    """Owns one scene's state and static configuration (port of
    wgsparkl_tpu.pipeline.MpmData, 3D and 2D).  The state lives on the
    particles' device.  transfer: "pallas" (the default here; the JAX
    package defaults to "dense"), "dense" or "blocked" (see the module
    docstring); the blocked and pallas paths size an automatic job table
    (max_jobs 0) as the JAX package does, 4 ceil(N / group) + 64 rounded up
    to job_chunk and to 64, and an explicit one to job_chunk; by != 4 and
    the sparse domain are pallas-only.  Mesh colliders are sampled here (polylines in 2D, trimeshes
    and heightfields in 3D, at cell_width / sqrt(2)); their slots are never
    static and the scene runs the dense CDF mode.  sparse: the unbounded 3D
    domain (by 4 only; the grid keeps only its cell width and origin), with
    kmax occupied blocks (default max_jobs) and amax active slots (default
    4 kmax, rounded up to a multiple of 8) a substep.  coupling:
    COUPLING_ONE_WAY / COUPLING_TWO_WAY a body (None: all two-way);
    materials: the pallas path holds at most 128 distinct ones (its
    [16, 128] material table; more raise ValueError, as in the JAX package),
    the dense and blocked transfers any number (a [16, M] table, M = 128
    ceil(count / 128));
    body_contacts: resolve the dynamic bodies' contacts (with
    False they keep their mass but pass through other colliders); joints:
    see _normalize_joints."""

    def __init__(self, params: SimulationParams, particles: Particles,
                 models: Models, bodies: Sequence[RigidBodyDesc],
                 cell_width: float, grid: Optional[GridConfig] = None,
                 grid_bounds=None, elastic_model: str = "corotated",
                 transfer: str = "pallas", group: int = 256,
                 job_chunk: int = 32,
                 max_jobs: int = 0, sparse: bool = False, kmax: int = 0,
                 amax: int = 0, by: int = 4, joints=(),
                 chan_free: Optional[bool] = None,
                 fold_vel: Optional[bool] = None,
                 coupling: Optional[Sequence[int]] = None,
                 body_contacts: bool = True):
        dim = particles.dim
        if transfer not in ("dense", "blocked", "pallas"):
            raise ValueError(f"unknown transfer {transfer!r}")
        if transfer != "pallas" and (sparse or by != 4):
            raise ValueError("the sparse domain and by != 4 need transfer='pallas'")
        if sparse and dim != 2 and by != 4:
            raise ValueError("the sparse domain uses isotropic 4^3 blocks (by=4)")
        if sparse and dim == 2:
            raise ValueError("the sparse (unbounded) domain is 3D-only")
        if dim == 2 and by != 4:
            raise ValueError("2D blocks are 8 x 8: by must be 4")
        if elastic_model not in ELASTIC_MODELS:
            raise ValueError(f"unknown elastic model {elastic_model!r}")
        if len(bodies) > 16:
            raise ValueError("at most 16 colliders (the 16-bit affinity word)")
        if coupling is None:
            coupling = tuple(COUPLING_TWO_WAY for _ in bodies)
        coupling = tuple(int(c) for c in coupling)
        if len(coupling) != len(bodies):
            raise ValueError(f"coupling: one mode a body ({len(bodies)}), "
                             f"got {len(coupling)}")
        device = particles.pos.device
        if grid is None:
            if grid_bounds is not None:
                lo, hi = grid_bounds
            else:
                pos = particles.pos.cpu().numpy()
                lo, hi = pos.min(0) - 8 * cell_width, pos.max(0) + 8 * cell_width
            grid = GridConfig.from_bounds(lo, hi, cell_width)
        if transfer == "blocked":
            bk.num_blocks(grid)     # raises unless the grid is whole blocks
        if dim == 3 and transfer == "pallas" and grid.shape[1] % by:
            grid = dataclasses.replace(
                grid, shape=(grid.shape[0], grid.shape[1] + by - grid.shape[1] % by,
                             grid.shape[2]))
        # The reference's rounding (job_chunk, then its band_chunk 64), kept
        # so both packages size their job tables alike.
        auto_jobs = max_jobs == 0 and transfer in ("blocked", "pallas")
        if auto_jobs:
            max_jobs = -(-particles.count // group) * 4 + 64
        max_jobs = -(-max_jobs // job_chunk) * job_chunk
        if auto_jobs and max_jobs % 64:
            max_jobs = -(-max_jobs // 64) * 64
            max_jobs = -(-max_jobs // job_chunk) * job_chunk
        if sparse:
            kmax = kmax or max_jobs
            amax = -(-(amax or 4 * kmax) // 8) * 8

        def zero(v):
            return v is None or not np.any(np.asarray(v, np.float32))

        collider_types = tuple(b.collider.shape_type for b in bodies)
        mesh_cids = tuple(i for i, t in enumerate(collider_types) if t in shp.MESH)
        meshes, sample_max_jobs = _sample_meshes(bodies, mesh_cids, dim, cell_width,
                                                 device)
        static_slots = tuple(i for i, b in enumerate(bodies)
                             if b.body_type == "fixed" and zero(b.linvel)
                             and zero(b.angvel) and i not in mesh_cids)
        world = build_rigid_world(bodies, dim, device)
        if chan_free is None:
            # The heuristic sees the analytic slots; a mesh scene gathers.
            adesc = tuple((i, t) for i, t in enumerate(collider_types)
                          if i not in mesh_cids)
            chan_free = transfer == "pallas" and not mesh_cids and _auto_chan_free(
                grid, by, adesc, world, particles.pos.cpu().numpy(),
                params.gravity.cpu().numpy())
        chan_free = bool(chan_free)
        models, n_mat = attach_material_table(
            particles, models, limit=128 if transfer == "pallas" else None)
        self.params = params
        self.bodies_desc = tuple(bodies)
        dynamic_slots = tuple(i for i, b in enumerate(bodies)
                              if b.body_type == "dynamic")
        self.config = MpmConfig(
            grid=grid, collider_types=collider_types, transfer=transfer,
            group=group, job_chunk=job_chunk, max_jobs=max_jobs, by=by,
            n_materials=n_mat, static_slots=static_slots,
            elastic_model=elastic_model, chan_free=chan_free,
            fold_vel=bool(fold_vel),
            dynamic_slots=dynamic_slots if body_contacts else (),
            coupling=coupling, joints=_normalize_joints(joints, bodies, dim),
            mesh_cids=mesh_cids, sample_max_jobs=sample_max_jobs,
            sparse=bool(sparse), kmax=kmax, amax=amax)
        self.state = SimState(particles=particles, models=models, bodies=world,
                              meshes=meshes)
        # The rigid update's static tables, on the state's device now.
        rigid_tables.tables(self.config, device)

    @property
    def num_particles(self) -> int:
        return self.state.particles.count


class MpmPipeline:
    """Stateless stepper (port of wgsparkl_tpu.pipeline.MpmPipeline).  The
    port compiles nothing: step_fn returns `step` bound to a configuration
    and a substep count (on the card a kernel-path frame replays its
    substeps as a CUDA graph, captured on the first call; _frame_pallas)."""

    def step(self, data: MpmData, num_substeps: int = 1,
             params: Optional[SimulationParams] = None) -> StepDiag:
        """num_substeps substeps of data's scene, in place on data.state,
        with data.params or `params`; returns the frame's StepDiag (zero on
        the dense and blocked transfers)."""
        params = data.params if params is None else params
        data.state, diag = step_with_diag(data.state, params, data.config, num_substeps)
        return diag

    def step_fn(self, cfg: MpmConfig, num_substeps: int):
        """(state, params) -> state after num_substeps substeps under cfg."""
        return functools.partial(step, cfg=cfg, num_substeps=num_substeps)
