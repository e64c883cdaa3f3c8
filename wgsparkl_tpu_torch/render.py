"""Render prep: per-particle instance data and debug colour modes (port of
wgsparkl_tpu/render.py).

`prep_instances` gives, per particle, the deformation matrix (particles
draw as sheared boxes), the position, a colour in the selected debug mode
and the radius, as tensors on the state's device; `write_ply` dumps an
instance buffer as a coloured point cloud and `collider_surface_points`
samples the colliders' surfaces at their current poses, both in numpy on
the host.  viewer.py rasterizes either.
"""

from __future__ import annotations

import numpy as np
import torch

MODE_DEFAULT = 0
MODE_VOLUME = 1
MODE_VELOCITY = 2
MODE_CDF_NORMALS = 3
MODE_CDF_DISTANCES = 4
MODE_CDF_SIGNS = 5

MODES = {
    "default": MODE_DEFAULT,
    "volume": MODE_VOLUME,
    "velocity": MODE_VELOCITY,
    "cdf_normals": MODE_CDF_NORMALS,
    "cdf_distances": MODE_CDF_DISTANCES,
    "cdf_signs": MODE_CDF_SIGNS,
}


def _hsv_ramp(t):
    """Blue -> green -> red ramp of scalars in [0, 1]: [N] -> [N, 3]."""
    t = torch.clamp(t, 0.0, 1.0)
    r = torch.clamp(2.0 * t - 1.0, 0.0, 1.0)
    g = 1.0 - torch.abs(2.0 * t - 1.0)
    b = torch.clamp(1.0 - 2.0 * t, 0.0, 1.0)
    return torch.stack([r, g, b], dim=-1)


def _rgb(c, dev):
    return torch.tensor(c, dtype=torch.float32, device=dev)


def prep_instances(particles, base_color=(0.3, 0.5, 0.9), mode: int = MODE_DEFAULT,
                   cell_width: float = 1.0):
    """Instance buffer: dict(position, deformation, color, scale) of tensors
    on the particles' device; deformation = def_grad, so that a renderer
    can draw sheared boxes."""
    p = particles
    n, d = p.pos.shape
    dev = p.pos.device
    base = _rgb(base_color, dev).expand(n, 3)
    if mode == MODE_DEFAULT:
        color = base
    elif mode == MODE_VOLUME:
        color = _hsv_ramp((torch.linalg.det(p.def_grad) - 0.5) / 1.0)
    elif mode == MODE_VELOCITY:
        speed = torch.linalg.vector_norm(p.vel, dim=-1)
        color = _hsv_ramp(speed / (speed.max() + 1e-6))
    elif mode == MODE_CDF_NORMALS:
        nrm = p.cdf_normal
        if d == 2:
            nrm = torch.cat([nrm, torch.zeros((n, 1), device=dev)], dim=-1)
        color = nrm * 0.5 + 0.5
    elif mode == MODE_CDF_DISTANCES:
        sd = p.cdf_signed_distance / (1.5 * cell_width)
        color = torch.where((sd != 0.0)[:, None], _hsv_ramp(sd * 0.5 + 0.5), base)
    elif mode == MODE_CDF_SIGNS:
        sd = p.cdf_signed_distance[:, None]
        color = torch.where(sd < 0, _rgb((1.0, 0.1, 0.1), dev),
                            torch.where(sd > 0, _rgb((0.1, 1.0, 0.1), dev),
                                        _rgb((0.5, 0.5, 0.5), dev)))
    else:
        raise ValueError(f"unknown render mode {mode}")
    return {"position": p.pos, "deformation": p.def_grad, "color": color,
            "scale": p.init_radius}


def as_numpy(x):
    """A tensor (on any device) or array-like as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def write_ply(path: str, instances, max_points: int | None = None) -> None:
    """Dump an instance buffer as a colored point cloud (.ply, ascii)."""
    pos = as_numpy(instances["position"])
    col = np.clip(as_numpy(instances["color"]) * 255, 0, 255).astype(np.uint8)
    if pos.shape[1] == 2:
        pos = np.concatenate([pos, np.zeros((len(pos), 1), pos.dtype)], axis=1)
    if max_points is not None and len(pos) > max_points:
        sel = np.linspace(0, len(pos) - 1, max_points).astype(np.int64)
        pos, col = pos[sel], col[sel]
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(pos)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        for (x, y, z), (r, g, b) in zip(pos, col):
            f.write(f"{x:.5f} {y:.5f} {z:.5f} {r} {g} {b}\n")


def collider_surface_points(descs, rot, pos, spacing: float,
                            max_points: int = 30_000):
    """World-space surface points of every collider, for rendering:
    procedural samples of each analytic shape and the vertices of each mesh,
    posed with the bodies' current rotation and translation (quaternion
    w, x, y, z in 3D, (cos, sin) in 2D), for the same point cloud as the
    particles.

    descs: RigidBodyDesc sequence; rot / pos: the current poses (tensors or
    arrays).  Returns [K, d] f32 world points (K = 0 without colliders)."""
    from wgsparkl_tpu_torch.collision import shapes as shp

    rot = as_numpy(rot)
    pos = as_numpy(pos)
    d = pos.shape[1] if len(descs) else 3
    out = []

    def _grid2(ha, hb, sp):
        na = max(int(np.ceil(2 * ha / sp)), 1)
        nb = max(int(np.ceil(2 * hb / sp)), 1)
        u = np.linspace(-ha, ha, na + 1)
        v = np.linspace(-hb, hb, nb + 1)
        uu, vv = np.meshgrid(u, v, indexing="ij")
        return uu.reshape(-1), vv.reshape(-1)

    for i, desc in enumerate(descs):
        c = desc.collider
        t = c.shape_type
        if t == shp.SHAPE_CUBOID:
            he = list(c.params) + [0.0] * (3 - len(c.params))
            faces = []
            if d == 2:
                for sgn in (-1.0, 1.0):
                    u = np.linspace(-he[0], he[0],
                                    max(int(2 * he[0] / spacing), 1) + 1)
                    faces.append(np.stack([u, np.full_like(u, sgn * he[1])], -1))
                    v = np.linspace(-he[1], he[1],
                                    max(int(2 * he[1] / spacing), 1) + 1)
                    faces.append(np.stack([np.full_like(v, sgn * he[0]), v], -1))
            else:
                for ax in range(3):
                    a1, a2 = [k for k in range(3) if k != ax]
                    uu, vv = _grid2(he[a1], he[a2], spacing)
                    for sgn in (-1.0, 1.0):
                        f = np.zeros((len(uu), 3), np.float64)
                        f[:, ax] = sgn * he[ax]
                        f[:, a1] = uu
                        f[:, a2] = vv
                        faces.append(f)
            local = np.concatenate(faces, axis=0)
        elif t == shp.SHAPE_BALL:
            r = c.params[0]
            n = max(int(4 * np.pi * r * r / (spacing * spacing)), 16)
            if d == 2:
                a = np.linspace(0, 2 * np.pi, n, endpoint=False)
                local = r * np.stack([np.cos(a), np.sin(a)], -1)
            else:
                k = np.arange(n) + 0.5
                phi = np.arccos(1 - 2 * k / n)
                th = np.pi * (1 + 5 ** 0.5) * k
                local = r * np.stack(
                    [np.sin(phi) * np.cos(th), np.cos(phi),
                     np.sin(phi) * np.sin(th)], -1)
        elif t == shp.SHAPE_CAPSULE:
            hh, r = c.params[0], c.params[1]
            n = max(int(2 * np.pi * r / spacing), 8)
            m = max(int(2 * hh / spacing), 1) + 1
            if d == 2:
                a = np.linspace(0, 2 * np.pi, n, endpoint=False)
                ring = r * np.stack([np.cos(a), np.sin(a)], -1)
                local = np.concatenate([
                    ring + np.array([0.0, hh]), ring + np.array([0.0, -hh]),
                    np.stack([np.full(m, r), np.linspace(-hh, hh, m)], -1),
                    np.stack([np.full(m, -r), np.linspace(-hh, hh, m)], -1),
                ])
            else:
                a = np.linspace(0, 2 * np.pi, n, endpoint=False)
                ys = np.linspace(-hh, hh, m)
                cyl = np.stack([
                    np.repeat(np.cos(a), m) * r,
                    np.tile(ys, n),
                    np.repeat(np.sin(a), m) * r,
                ], -1)
                k = np.arange(n) + 0.5
                phi = np.arccos(1 - 2 * k / n)
                th = np.pi * (1 + 5 ** 0.5) * k
                sph = r * np.stack(
                    [np.sin(phi) * np.cos(th), np.cos(phi),
                     np.sin(phi) * np.sin(th)], -1)
                caps = np.concatenate([
                    sph[sph[:, 1] >= 0] + np.array([0.0, hh, 0.0]),
                    sph[sph[:, 1] < 0] + np.array([0.0, -hh, 0.0]),
                ])
                local = np.concatenate([cyl, caps])
        elif t == shp.SHAPE_HALFSPACE:
            ext = 24 * spacing
            if d == 2:
                u = np.linspace(-ext, ext, 49)
                local = np.stack([u, np.zeros_like(u)], -1)
            else:
                uu, vv = _grid2(ext, ext, 2 * spacing)
                local = np.stack([uu, np.zeros_like(uu), vv], -1)
        elif c.vertices is not None:
            local = np.asarray(c.vertices, np.float64)
        else:
            continue
        local = local[:, :d]
        # pose: rotate + translate (quat wxyz in 3D, cos/sin in 2D).
        ri = rot[i]
        if d == 3:
            w, x, y, z = ri
            rm = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ])
        else:
            cth, sth = ri
            rm = np.array([[cth, -sth], [sth, cth]])
        out.append(local @ rm.T + pos[i][None, :])
    if not out:
        return np.zeros((0, d), np.float32)
    pts = np.concatenate(out, axis=0).astype(np.float32)
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(np.int64)
        pts = pts[sel]
    return pts
