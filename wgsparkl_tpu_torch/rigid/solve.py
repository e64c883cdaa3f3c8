"""The rigid solve of a substep: body contacts (rigid/contacts.py), then
joints (rigid/joints.py), on the velocities after the CPIC impulses,
integration and gravity (the end of pipeline.rigid_bodies_update).

`rigid_solve` is the wrapper of the hand-written kernel csrc/rigid_solve.cu
(one block, one launch a substep, no host sync); `rigid_solve_plain` its
plain PyTorch version, which the wrapper takes for CPU tensors.  The JAX
package runs the same solver as plain XLA (`resolve_contacts` then
`resolve_joints`, wgsparkl_tpu/pipeline.py `rigid_bodies_update`): a
Gauss-Seidel scan over contact samples and joint sweeps, sequential by
construction, which issued op by op would take thousands of launches a
substep.

`tables` holds what is static in a configuration (the ordered contact
pairs and their samples, the joint rows, the coupling mask) as tensors on
the device, built once per configuration and device.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.rigid import contacts as C
from wgsparkl_tpu_torch.rigid import joints as J

# Floats a contact sample's record and a joint's record take in the
# kernel's scratch (csrc/rigid_solve.cu CAND_F, JOINT_F); a sample also
# takes one word of the active-sample list.
CAND_F, JOINT_F = 20, 48
COUPLING_TWO_WAY = 2


@dataclasses.dataclass(frozen=True)
class RigidTables:
    pairs: tuple            # (b, bt, c, ct, two_way) per ordered pair
    pair_t: torch.Tensor    # [P, 5] int32
    cand_t: torch.Tensor    # [K, 2] int32: (pair, sample) in solve order
    offsets: torch.Tensor   # [S, d] f32: cuboid sample offsets
    joint_rows: tuple       # (b, c, kind) per joint
    joint_i: torch.Tensor   # [J, 3] int32
    joint_f: torch.Tensor   # [J, 16] f32
    coupling_mask: object   # [B, 1] f32 (1 two-way, 0 one-way) or None

    @property
    def empty(self) -> bool:
        return not self.pairs and not self.joint_rows


@functools.lru_cache(maxsize=64)
def _tables(collider_types, dynamic_slots, joints, coupling, dim: int, device: str):
    dev = torch.device(device)
    skip = frozenset((int(j[0]), int(j[1])) for j in joints)
    pairs = tuple(C.contact_pairs(collider_types, dynamic_slots, skip))
    cand = [(p, s) for p, pr in enumerate(pairs)
            for s in range(C.sample_count(pr[1], dim))]
    rows, jf = J.joint_table(joints, dim, dev)
    i32 = dict(dtype=torch.int32, device=dev)
    mask = None
    if any(int(m) != COUPLING_TWO_WAY for m in coupling):
        mask = torch.tensor([[1.0 if int(m) == COUPLING_TWO_WAY else 0.0]
                             for m in coupling], dtype=torch.float32, device=dev)
    return RigidTables(
        pairs=pairs,
        pair_t=torch.tensor([[b, bt, c, ct, int(tw)] for b, bt, c, ct, tw in pairs]
                            or [[0] * 5], **i32),
        cand_t=torch.tensor(cand or [[0, 0]], **i32),
        offsets=torch.as_tensor(C._cuboid_sample_offsets(dim), device=dev),
        joint_rows=tuple(rows),
        joint_i=torch.tensor(rows or [[0, 0, 0]], **i32),
        joint_f=jf if rows else torch.zeros((1, 16), dtype=torch.float32, device=dev),
        coupling_mask=mask)


def tables(cfg, device) -> RigidTables:
    """The static tables of configuration cfg (an MpmConfig) on device,
    built on first use and kept."""
    return _tables(tuple(cfg.collider_types), tuple(cfg.dynamic_slots),
                   tuple(cfg.joints), tuple(cfg.coupling), cfg.grid.dim,
                   str(torch.device(device)))


def rigid_solve_plain(world, linvel, angvel, dt: float, slop: float,
                      tab: RigidTables):
    """Contacts then joints on (linvel [B, d], angvel [B, na]); world: the
    RigidWorld with the integrated poses, fresh world_com and
    inv_inertia_world, and the prescribed velocities of non-dynamic
    bodies.  Returns the corrected (linvel, angvel)."""
    B = C.BodyScalars(world)
    V, W = C.velocity_tables(linvel, angvel)
    C.resolve_contacts(B, V, W, tab.pairs, dt, slop, offsets=tab.offsets)
    J.resolve_joints(B, V, W, tab.joint_rows, tab.joint_f, dt)
    return C.stack_tables(V, W)


def _f32(t):
    if t.dtype != torch.float32:
        raise ValueError(f"rigid_solve: float32 tensors only (got {t.dtype})")
    return t.contiguous()


def rigid_solve(world, linvel, angvel, dt: float, slop: float, tab: RigidTables):
    """rigid_solve_plain's function in one launch of csrc/rigid_solve.cu on
    CUDA tensors (its plain version on CPU tensors)."""
    if linvel.device.type == "cpu":
        return rigid_solve_plain(world, linvel, angvel, dt, slop, tab)
    nb, dim = linvel.shape
    if nb > 16 or dim not in (2, 3) or tuple(angvel.shape) != (nb, 3 if dim == 3 else 1):
        raise ValueError(f"rigid_solve: [B <= 16, d] velocities "
                         f"(got {tuple(linvel.shape)}, {tuple(angvel.shape)})")
    dev = linvel.device
    for t in (tab.pair_t, tab.offsets, tab.joint_f):
        if t.device != dev:
            raise ValueError(f"rigid_solve: tables on {t.device}, velocities on {dev}")
    args = [_f32(x) for x in (world.rot, world.pos, world.world_com, world.inv_mass,
                              world.inv_inertia_world, world.shape_params,
                              world.linvel, world.angvel, linvel, angvel)]
    k, nj = len(tab.cand_t) if tab.pairs else 0, len(tab.joint_rows)
    scratch = torch.empty(max(1, k * (CAND_F + 1) + nj * JOINT_F), dtype=torch.float32,
                          device=dev)
    lin_out, ang_out = torch.empty_like(args[8]), torch.empty_like(args[9])
    _cuda.launch("rigid_solve", "rigid_solve_cuda", "p" * 12 + "ipppipppiiffffifi",
                 *args, tab.pair_t, tab.cand_t, k, tab.offsets, tab.joint_i,
                 tab.joint_f, nj, scratch, lin_out, ang_out, nb, dim,
                 dt, slop, C.CONTACT_BETA, C.CONTACT_FRICTION, C.CONTACT_ITERATIONS,
                 J.beta_over_dt(dt), J.JOINT_ITERATIONS)
    rigid_solve.launches += 1
    return lin_out, ang_out


rigid_solve.launches = 0
