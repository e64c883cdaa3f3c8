"""Plain mesh-collider geometry of the reference: surface sampling of
polylines (2D) and triangle meshes (3D), the heightfield's triangulation,
and the node CDF that the samples give.

The semantics are upstream wgsparkl's (`particle3d.rs` / `particle2d.rs`
samplers, `p2g_cdf.wgsl` projections): every segment, triangle face and
unique triangle edge is covered by samples at cell_width / sqrt(2); a grid
node within a sample's 3^d stencil (base cell round(p / h) - 1) that
projects inside the sample's primitive gets the primitive's collider bit,
the collider's sign bit where it lies below the primitive, and the
primitive's unsigned distance; per node the closest such primitive wins.
Everything here is numpy (sampling, at build time) or plain torch (the node
CDF), in the dtype it is given.
"""

from __future__ import annotations

import numpy as np
import torch


def heightfield_trimesh(heights, scale):
    """A regular heightfield [nx, nz] over x in [-sx/2, sx/2] and z in
    [-sz/2, sz/2] at y = heights * sy as (vertices [nx nz, 3], triangles
    [2 (nx-1)(nz-1), 3]): rapier's HeightField::to_trimesh, two triangles a
    quad, (v00, v10, v11) and (v00, v11, v01)."""
    heights = np.asarray(heights, np.float64)
    nx, nz = heights.shape
    x = np.linspace(-scale[0] / 2, scale[0] / 2, nx)
    z = np.linspace(-scale[2] / 2, scale[2] / 2, nz)
    gx, gz = np.meshgrid(x, z, indexing="ij")
    verts = np.stack([gx.ravel(), heights.ravel() * scale[1], gz.ravel()], -1)
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(nz - 1), indexing="ij")
    v00 = (i * nz + j).ravel()
    v01, v10, v11 = v00 + 1, v00 + nz, v00 + nz + 1
    tris = np.stack([np.stack([v00, v10, v11], -1), np.stack([v00, v11, v01], -1)],
                    1).reshape(-1, 3)
    return verts, tris


def _segment_samples(a, b, spacing):
    """Samples of segments a -> b ([E, d] each): per segment
    n = max(ceil(|b - a| / spacing), 1) + 1 evenly spaced points, ends
    included.  Returns (points [P, d], segment index [P])."""
    n = np.maximum(np.ceil(np.linalg.norm(b - a, axis=-1) / spacing), 1).astype(np.int64)
    pts, idx = [], []
    for k in np.unique(n):
        sel = np.nonzero(n == k)[0]
        t = (np.arange(k + 1, dtype=np.float64) / k)[None, :, None]
        p = a[sel, None, :] * (1 - t) + b[sel, None, :] * t
        pts.append(p.reshape(-1, a.shape[1]))
        idx.append(np.repeat(sel, k + 1))
    return np.concatenate(pts), np.concatenate(idx)


def _face_pattern(n1: int, n2: int):
    """The barycentric lattice of a face with n1 steps along e1 and n2
    along e2: (u, v) pairs, the extent along e2 shrinking with u."""
    uv = []
    for i in range(n1 + 1):
        u = i / n1
        m = int(np.ceil((1.0 - u) * n2))
        if m == 0:
            uv.append((u, 0.0))
            continue
        for v in np.arange(m + 1, dtype=np.float64) / n2:
            if v <= 1.0 - u + 1e-9:
                uv.append((u, v))
    return np.asarray(uv)


def sample_polylines(vertices, segments, cell_width):
    """Samples of a 2D polyline: (points [S, 2], primitive vertex ids [S, 2])."""
    v = np.asarray(vertices, np.float64)
    seg = np.asarray(segments, np.int64)
    pts, idx = _segment_samples(v[seg[:, 0]], v[seg[:, 1]], cell_width / np.sqrt(2.0))
    return pts, seg[idx]


def sample_trimesh(vertices, triangles, cell_width):
    """Samples of a triangle mesh: every face's barycentric lattice, then
    every unique edge (carried by the first triangle that has it):
    (points [S, 3], primitive vertex ids [S, 3])."""
    v = np.asarray(vertices, np.float64)
    tri = np.asarray(triangles, np.int64)
    spacing = cell_width / np.sqrt(2.0)
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    e1, e2 = b - a, c - a
    n1 = np.maximum(np.ceil(np.linalg.norm(e1, axis=-1) / spacing), 1).astype(np.int64)
    n2 = np.maximum(np.ceil(np.linalg.norm(e2, axis=-1) / spacing), 1).astype(np.int64)
    pts, prims = [], []
    for k1, k2 in sorted(set(zip(n1.tolist(), n2.tolist()))):
        sel = np.nonzero((n1 == k1) & (n2 == k2))[0]
        uv = _face_pattern(k1, k2)
        p = (a[sel, None, :] + uv[None, :, :1] * e1[sel, None, :]
             + uv[None, :, 1:] * e2[sel, None, :])
        pts.append(p.reshape(-1, 3))
        prims.append(np.repeat(tri[sel], len(uv), axis=0))
    # Unique edges, each with the first triangle that holds it.
    edges = np.concatenate([tri[:, [0, 1]], tri[:, [1, 2]], tri[:, [2, 0]]])
    owner = np.concatenate([np.arange(len(tri))] * 3)
    edges = np.sort(edges, axis=1)
    keep = edges[:, 0] != edges[:, 1]
    edges, owner = edges[keep], owner[keep]
    key = edges[:, 0] * (len(v) + 1) + edges[:, 1]
    order = np.lexsort((owner, key))
    first = np.ones(len(order), bool)
    first[1:] = key[order][1:] != key[order][:-1]
    edges, owner = edges[order][first], owner[order][first]
    ep, eidx = _segment_samples(v[edges[:, 0]], v[edges[:, 1]], spacing)
    pts.append(ep)
    prims.append(tri[owner[eidx]])
    return np.concatenate(pts), np.concatenate(prims)


def node_cdf(samples, prims, slots, verts, nc: int, grid, dtype=torch.float64):
    """Node CDF of mesh colliders on the grid: (dist [M] (inf where no
    primitive reaches), closest slot [M] (-1), affinity word [M] int64: bit
    c, and bit 16 + c where the node lies below a primitive of slot c).

    samples [S, d] world positions, prims [S, d] vertex ids into verts [V,
    d] (world), slots [S] the collider slot of each sample; grid: the
    reference's Grid.  A sample whose base cell is off the grid adds
    nothing, nor does a stencil node past the grid's high edge.  3D: a node
    counts where it projects inside the triangle (edges inclusive, normal
    non-degenerate); 2D: strictly inside the segment."""
    d, h = grid.dim, grid.h
    dev = samples.device
    m = grid.num_nodes
    origin = torch.tensor(grid.origin, device=dev)
    shape = torch.tensor(grid.shape, device=dev)
    base = torch.round(samples / h).long() - 1
    ok = ((base - origin >= 0) & (base - origin < shape)).all(1)
    base, prims, slots = base[ok], prims[ok], slots[ok]
    va, vb = verts[prims[:, 0]], verts[prims[:, 1]]
    if d == 3:
        vc = verts[prims[:, 2]]
        nrm = torch.linalg.cross(vb - va, vc - va)
        area2 = (nrm * nrm).sum(1)
        unit = nrm / torch.sqrt(torch.clamp(area2, min=1e-300)).unsqueeze(1)
    else:
        ab = vb - va
        len2 = (ab * ab).sum(1)
        perp = torch.stack([-ab[:, 1], ab[:, 0]], 1)
        unit = perp / torch.sqrt(torch.clamp(len2, min=1e-300)).unsqueeze(1)
    offsets = torch.cartesian_prod(*([torch.arange(3, device=dev)] * d)).reshape(-1, d)

    def pairs():
        for k in offsets:
            cell = base + k
            inside_grid = (cell - origin < shape).all(1)
            x = cell.to(dtype) * h
            ap = x - va
            signed = (unit * ap).sum(1)
            if d == 3:
                # Barycentric coordinates of the node's projection.
                q = ap - signed.unsqueeze(1) * unit
                e1, e2 = vb - va, vc - va
                d11, d12, d22 = (e1 * e1).sum(1), (e1 * e2).sum(1), (e2 * e2).sum(1)
                q1, q2 = (q * e1).sum(1), (q * e2).sum(1)
                den = d11 * d22 - d12 * d12
                safe = torch.where(den > 0, den, torch.ones_like(den))
                s = (d22 * q1 - d12 * q2) / safe
                t = (d11 * q2 - d12 * q1) / safe
                valid = (area2 > 0) & (s >= 0) & (t >= 0) & (s + t <= 1)
            else:
                t = (ab * ap).sum(1) / torch.clamp(len2, min=1e-300)
                valid = (t > 0) & (t < 1)
            valid = valid & inside_grid
            flat = grid.flat(cell)
            yield flat[valid], signed[valid], slots[valid]

    dist = torch.full((m,), float("inf"), dtype=dtype, device=dev)
    for flat, signed, _ in pairs():
        dist.scatter_reduce_(0, flat, signed.abs(), reduce="amin")
    closest = torch.full((m,), 64, dtype=torch.long, device=dev)
    has = torch.zeros((m, nc), dtype=torch.long, device=dev)
    neg = torch.zeros((m, nc), dtype=torch.long, device=dev)
    for flat, signed, slot in pairs():
        best = signed.abs() == dist[flat]
        closest.scatter_reduce_(0, flat[best], slot[best], reduce="amin")
        col = flat * nc + slot
        has.view(-1).scatter_reduce_(0, col, torch.ones_like(col), reduce="amax")
        neg.view(-1).scatter_reduce_(0, col, (signed < 0).long(), reduce="amax")
    closest = torch.where(closest == 64, -1, closest)
    bits = 2 ** torch.arange(nc, device=dev)
    aff = (has * bits).sum(1) | ((neg * bits).sum(1) << 16)
    return dist, closest, aff


def surface_cdf(verts, points, prims, pose, grid, dtype, device):
    """One mesh collider's node CDF from its surface at a pose: (dist [M],
    the nodes it reaches [M] bool, the nodes below it [M] bool).  verts [V,
    d], points [S, d] and prims [S, d] are in the body's frame; the samples
    are stored at float32, as the configurations state, and placed by the
    pose (translation [d], rotation matrix [d, d], float64): x R^T + t."""
    shift, rot = (np.asarray(x, np.float64) for x in pose)
    t = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    pts = points.astype(np.float32).astype(np.float64) @ rot.T + shift
    dist, _, aff = node_cdf(t(pts).to(dtype), t(prims), t(np.zeros(len(pts), np.int64)),
                            t(verts @ rot.T + shift).to(dtype), 1, grid, dtype)
    return dist, (aff & 1) != 0, ((aff >> 16) & 1) != 0
