"""The mesh node-CDF pass: grid-node signed distances to mesh colliders (port
of wgsparkl_tpu/ops/rigid_cdf.py, the bounded grid's `mesh_node_cdf` and the
sparse domain's `mesh_node_cdf_sparse`; the port-only kernel
csrc/mesh_cdf.cu).

Mesh colliders (trimesh and heightfield in 3D, polyline in 2D) reach the
grid through their surface samples (rigid/sampling.py), transformed to
world space with their bodies' poses every substep.  For each sample and
each of its 3^d stencil nodes (base round(p / h) - 1 per axis, as a
particle's) the node is projected onto the sample's primitive: in 3D a
pair is valid where the node projects inside the triangle (three edge-plane
tests and a non-degenerate normal), in 2D where it projects strictly inside
the segment.  A valid pair gives the key (bits(|d|) & 0xFFFFFFF0) | slot,
d the signed distance to the primitive's plane or line, and per node the
smallest key wins; it also sets the affinity bit 1 << slot, and the sign
bit 1 << (slot + 16) where d < 0.

In the sparse domain (`mesh_node_cdf_sparse`) the nodes are those of the
active slots, slot by slot (slot * 64 + the node's row-major cell in its
4^3 block; the ghost slot stays empty): a sample whose block key is the
sentinel adds nothing, and a stencil node whose block is not in the
active table is dropped, as the JAX package's slot scatter drops it.

On the bounded grid both results are int32 words over the nodes in
block-major storage order:
keys filled with the bits of +inf (0x7F800000), affinity words with 0.  A
key is never negative (the distance is an absolute value), so the signed
int32 minimum orders keys as their distances; the slot in the low nibble
breaks ties, which the 16-collider cap keeps in range.  A sample whose
home block lies outside the grid adds nothing, and a stencil node past the
grid's high edge is dropped, as the JAX package's overflow bucket and ghost
block drop them.

The JAX package runs the pass as a lax.scan over a sample job table (a
block sort, one-hot window tiles, scatter-min/max), a work-around for the
TPU's lack of atomics; its table holds 4 ceil(S / 128) + 64 jobs and drops
the samples of jobs past it.  Here the minimum and the OR commute, so the
kernel issues atomicMin / atomicOr straight into the node grid from one
thread per sample: no sort, no job table, no sample dropped, and the same
bits in any thread order.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from wgsparkl_tpu_torch import _cuda
from wgsparkl_tpu_torch.collision.cdf_channel import bit
from wgsparkl_tpu_torch.grid import GridConfig
from wgsparkl_tpu_torch.math import div
from wgsparkl_tpu_torch.math import pose as pose_math
from wgsparkl_tpu_torch.ops import blocked as bk

INF_KEY = 0x7F800000   # +inf float32 bit pattern


@dataclasses.dataclass
class MeshColliders:
    """The mesh colliders' sample cloud and vertex pool, in their bodies'
    frames, on the state's device."""

    sample_local: torch.Tensor    # [S, d] f32
    sample_prim: torch.Tensor     # [S, d] int32 vertex ids (triangle / segment)
    sample_cid: torch.Tensor      # [S] int32 body slot of the owning collider
    vertices_local: torch.Tensor  # [V, d] f32
    vertex_cid: torch.Tensor      # [V] int32

    @property
    def count(self) -> int:
        return self.sample_local.shape[0]

    def to(self, device) -> "MeshColliders":
        return MeshColliders(*(getattr(self, f.name).to(device)
                               for f in dataclasses.fields(self)))


def world_transform(meshes: MeshColliders, bodies):
    """Samples and mesh vertices in world space with their bodies' poses:
    ([S, d], [V, d])."""
    sc, vc = meshes.sample_cid.long(), meshes.vertex_cid.long()
    sample_w = pose_math.transform_point(bodies.rot[sc], bodies.pos[sc],
                                         meshes.sample_local)
    verts_w = pose_math.transform_point(bodies.rot[vc], bodies.pos[vc],
                                        meshes.vertices_local)
    return sample_w.contiguous(), verts_w.contiguous()


def _geometry(grid: GridConfig, by: int):
    bsh = bk.block_shape(grid.dim, by)
    nb = bk.num_blocks(grid, by)
    return bsh, nb, int(np.prod(nb)) * int(np.prod(bsh))


def _dot(a, b):
    acc = a[0] * b[0]
    for i in range(1, len(a)):
        acc = acc + a[i] * b[i]
    return acc


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _pass_plain(sample_w, verts_w, prim, cid, grid: GridConfig, m: int, sample_ok,
                place):
    """The pass in the kernels' order of operations (dots and crosses
    spelled out, IEEE divisions) onto m nodes: sample_ok(rel) -> [S] bool
    for the grid-relative base cells rel (d int32 [S]); place(cell) ->
    ([S] bool, [S] node index) of a stencil node's grid-relative cell."""
    d = grid.dim
    h = grid.cell_width
    dev = sample_w.device
    rel = [torch.round(div(sample_w[:, a], h)).to(torch.int32) - 1
           - int(grid.origin_cell[a]) for a in range(d)]
    ok = sample_ok(rel)
    p = prim.long()
    va = [verts_w[p[:, 0], a] for a in range(d)]
    vb = [verts_w[p[:, 1], a] for a in range(d)]
    if d == 3:
        vc = [verts_w[p[:, 2], a] for a in range(d)]
        ab = [vb[a] - va[a] for a in range(3)]
        ac = [vc[a] - va[a] for a in range(3)]
        bc = [vc[a] - vb[a] for a in range(3)]
        n = _cross(ab, ac)
        nlen = torch.sqrt(_dot(n, n))
        e1, e2, e3 = _cross(ab, n), _cross(bc, n), _cross(ac, n)
        den = torch.clamp(nlen, min=1e-30)
    else:
        ab = [vb[a] - va[a] for a in range(2)]
        ab2 = torch.clamp(_dot(ab, ab), min=1e-30)
        perp = [-ab[1], ab[0]]
        plen = torch.clamp(torch.sqrt(_dot(perp, perp)), min=1e-30)
    bits = torch.tensor([bit(k) for k in range(32)], dtype=torch.int32, device=dev)
    keys, words, addrs = [], [], []
    for k in itertools.product(range(3), repeat=d):
        cell = [rel[a] + k[a] for a in range(d)]
        inside, addr = place(cell)
        valid = ok & inside
        x = [(cell[a] + int(grid.origin_cell[a])).to(torch.float32) * h
             for a in range(d)]
        ap = [x[a] - va[a] for a in range(d)]
        if d == 3:
            bp = [x[a] - vb[a] for a in range(3)]
            cp = [x[a] - vc[a] for a in range(3)]
            valid = (valid & (_dot(e1, ap) <= 0.0) & (_dot(e2, bp) <= 0.0)
                     & (_dot(e3, cp) >= 0.0) & (nlen > 0.0))
            signed = _dot(n, ap) / den
        else:
            t = _dot(ab, ap) / ab2
            valid = valid & (t > 0.0) & (t < 1.0)
            signed = _dot(perp, ap) / plen
        key = (torch.abs(signed).view(torch.int32) & -16) | cid
        word = bits[cid.long()] | torch.where(signed < 0.0, bits[cid.long() + 16], 0)
        keys.append(key)
        words.append(word.to(torch.int32))
        addrs.append(torch.where(valid, addr, m).long())
    key = torch.cat(keys)
    if bool((key < 0).any()):
        raise AssertionError("mesh node-CDF pass: a negative key")
    addr = torch.cat(addrs)
    key_grid = torch.full((m + 1,), INF_KEY, dtype=torch.int32, device=dev)
    key_grid.scatter_reduce_(0, addr, key, reduce="amin")
    word_grid = torch.zeros((m + 1,), dtype=torch.int32, device=dev)
    words = torch.cat(words)
    # OR as a maximum, bit by bit (PyTorch has no scatter-OR).
    for k in range(32):
        has = ((words & bits[k]) != 0).to(torch.int32)
        if bool(has.any()):
            got = torch.zeros((m + 1,), dtype=torch.int32, device=dev)
            got.scatter_reduce_(0, addr, has, reduce="amax")
            word_grid |= torch.where(got > 0, bits[k], 0).to(torch.int32)
    return key_grid[:m], word_grid[:m]


def mesh_node_cdf_plain(sample_w, verts_w, prim, cid, grid: GridConfig, by: int):
    """Plain version of mesh_node_cdf: (key, word), int32 [M] over the M
    grid nodes in block-major order."""
    d = grid.dim
    bsh, nb, m = _geometry(grid, by)
    st = bk.storage_strides(nb)

    def sample_ok(rel):
        ok = torch.ones(sample_w.shape[0], dtype=torch.bool, device=sample_w.device)
        for a in range(d):
            ok = ok & (rel[a] >= 0) & (rel[a] < grid.shape[a])
        return ok

    def place(cell):
        inside = cell[0] < grid.shape[0]
        for a in range(1, d):
            inside = inside & (cell[a] < grid.shape[a])
        blk = sum((cell[a] // bsh[a]) * st[a] for a in range(d))
        inner = cell[0] % bsh[0]
        for a in range(1, d):
            inner = inner * bsh[a] + cell[a] % bsh[a]
        return inside, blk * int(np.prod(bsh)) + inner

    return _pass_plain(sample_w, verts_w, prim, cid, grid, m, sample_ok, place)


def _check_pass_args(sample_w, verts_w, prim, cid, d: int):
    s = sample_w.shape[0]
    if (sample_w.dtype != torch.float32 or verts_w.dtype != torch.float32
            or prim.dtype != torch.int32 or cid.dtype != torch.int32):
        raise TypeError("the mesh pass takes f32 positions and int32 ids")
    if (tuple(sample_w.shape) != (s, d) or tuple(prim.shape) != (s, d)
            or tuple(cid.shape) != (s,) or verts_w.dim() != 2
            or verts_w.shape[1] != d):
        raise ValueError("the mesh pass: sample_w [S, d], prim [S, d], cid [S], "
                         "verts_w [V, d]")
    for t in (sample_w, verts_w, prim, cid):
        if not t.is_contiguous() or t.device != sample_w.device:
            raise ValueError("the mesh pass: contiguous tensors on one device")


def mesh_node_cdf(sample_w, verts_w, prim, cid, grid: GridConfig, by: int):
    """(key, word), int32 [M] over the grid nodes in block-major order: the
    two fills and one launch of the mesh_cdf kernel.  sample_w [S, d] and
    verts_w [V, d] f32 world positions, prim [S, d] and cid [S] int32."""
    if sample_w.device.type == "cpu":
        return mesh_node_cdf_plain(sample_w, verts_w, prim, cid, grid, by)
    d = grid.dim
    s = sample_w.shape[0]
    _check_pass_args(sample_w, verts_w, prim, cid, d)
    bsh, _, m = _geometry(grid, by)
    shape = tuple(grid.shape) + (1,) * (3 - d)
    origin = tuple(grid.origin_cell) + (0,) * (3 - d)
    bsh3 = tuple(bsh) + (1,) * (3 - d)
    key = torch.full((m,), INF_KEY, dtype=torch.int32, device=sample_w.device)
    word = torch.zeros((m,), dtype=torch.int32, device=sample_w.device)
    _cuda.launch("mesh_cdf", "mesh_cdf_cuda", "ppppii" + "i" * 9 + "fpp",
                 sample_w, verts_w, prim, cid, s, d, *shape, *origin, *bsh3,
                 np.float32(grid.cell_width), key, word)
    mesh_node_cdf.launches += 1
    return key, word


mesh_node_cdf.launches = 0


def mesh_pass(meshes: MeshColliders, bodies, grid: GridConfig, by: int):
    """The mesh node-CDF pass of the bodies' current poses: (key, word)."""
    sample_w, verts_w = world_transform(meshes, bodies)
    return mesh_node_cdf(sample_w, verts_w, meshes.sample_prim, meshes.sample_cid,
                         grid, by)


def mesh_node_cdf_sparse_plain(sample_w, verts_w, prim, cid, grid: GridConfig,
                                act, amax: int):
    """Plain version of mesh_node_cdf_sparse: (key, word), int32 [(amax + 1)
    x 64] over the nodes of the active slots (slot-major, nodes row-major in
    the 4^3 block; the ghost slot amax stays empty)."""
    def sample_ok(rel):
        ok = torch.ones(sample_w.shape[0], dtype=torch.bool, device=sample_w.device)
        for a in range(3):
            dig = torch.div(rel[a], 4, rounding_mode="floor") + bk.SPARSE_HALF
            ok = ok & (dig >= 0) & (dig < bk.SPARSE_DIM - 1)
        return ok

    def place(cell):
        dig = [torch.div(c, 4, rounding_mode="floor") + bk.SPARSE_HALF for c in cell]
        key = (dig[0] * bk.SPARSE_DIM + dig[2]) * bk.SPARSE_DIM + dig[1]
        slot = bk.sparse_slots(act, key, amax)
        inner = ((cell[0] % 4) * 4 + cell[1] % 4) * 4 + cell[2] % 4
        return slot < amax, slot * 64 + inner

    return _pass_plain(sample_w, verts_w, prim, cid, grid, (amax + 1) * 64,
                       sample_ok, place)


def mesh_node_cdf_sparse(sample_w, verts_w, prim, cid, grid: GridConfig, act,
                         amax: int):
    """The mesh pass addressed to the sparse domain's active slots (3D):
    (key, word), int32 [(amax + 1) x 64], nodes of slot s at s * 64 + their
    row-major cell in the block.  A sample whose block key is the sentinel
    adds nothing, and a stencil node whose block is not in act (sorted
    packed keys, [<= amax]) is dropped: the fills and one launch of the
    mesh_cdf kernel's slot-addressed entry."""
    if sample_w.device.type == "cpu":
        return mesh_node_cdf_sparse_plain(sample_w, verts_w, prim, cid, grid, act,
                                          amax)
    _check_pass_args(sample_w, verts_w, prim, cid, 3)
    if act.dtype != torch.int32 or act.dim() != 1 or not act.is_contiguous() \
            or act.device != sample_w.device or act.shape[0] > amax:
        raise ValueError("mesh_node_cdf_sparse: act contiguous int32 [<= amax] on "
                         "the samples' device")
    m = (amax + 1) * 64
    key = torch.full((m,), INF_KEY, dtype=torch.int32, device=sample_w.device)
    word = torch.zeros((m,), dtype=torch.int32, device=sample_w.device)
    _cuda.launch("mesh_cdf", "mesh_cdf_sparse_cuda", "ppppi" + "iii" + "fpipp",
                 sample_w, verts_w, prim, cid, sample_w.shape[0],
                 *grid.origin_cell, np.float32(grid.cell_width), act, act.shape[0],
                 key, word)
    mesh_node_cdf_sparse.launches += 1
    return key, word


mesh_node_cdf_sparse.launches = 0


def mesh_pass_sparse(meshes: MeshColliders, bodies, grid: GridConfig, act, amax: int):
    """The sparse mesh pass of the bodies' current poses: (key, word)."""
    sample_w, verts_w = world_transform(meshes, bodies)
    return mesh_node_cdf_sparse(sample_w, verts_w, meshes.sample_prim,
                                meshes.sample_cid, grid, act, amax)


def blocks_to_flat(blocked_arr, cfg: GridConfig):
    """Block-major [NB + 1, BS.., C] (4^3 / 8^2 blocks) -> row-major [M, C],
    the ghost block dropped."""
    return bk.from_blocks(blocked_arr, cfg)


def merge_mesh_into_node_cdf(node_dist, node_aff, node_closest, key, word):
    """Merge the mesh pass into an analytic node-CDF triple (dist f32, aff
    int32, closest int32): a mesh key strictly closer than the analytic
    distance takes the node (its distance, its slot); affinity words OR."""
    finite = key < INF_KEY
    mesh_dist = (key & -16).view(torch.float32)
    closer = finite & (mesh_dist < node_dist)
    return (torch.where(closer, mesh_dist, node_dist), node_aff | word,
            torch.where(closer, key & 0xF, node_closest))
