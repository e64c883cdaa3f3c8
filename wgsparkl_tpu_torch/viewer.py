"""Offline viewer: instance buffers and PLY dumps to PNG, GIF or MP4 (a copy
of wgsparkl_tpu/viewer.py, numpy only: the port imports nothing of the JAX
package).

A dependency-light numpy point-splat rasterizer with a perspective camera,
z-ordering and depth-cue shading, over the per-particle instance data that
render.prep_instances produces (position, deformation, color, scale) or
the PLYs render.write_ply writes; `turntable` renders an orbit around the
scene and assembles an MP4 or GIF.

One command renders a runner's dump:

    python -m wgsparkl_tpu_torch.viewer DUMP_DIR --out sand3.mp4
    python -m wgsparkl_tpu_torch.viewer frame_00040.ply --out still.png

(Directories of frame_*.ply animate the frames; a single .ply gets a
camera turntable instead.)
"""

from __future__ import annotations

import argparse
import glob
import os
from typing import Optional, Sequence

import numpy as np


# ------------------------------------------------------------------ camera
def _look_at(center, azimuth_deg: float, elevation_deg: float, dist: float):
    """Camera rotation (world->view) + eye position for an orbit camera."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    # Eye on the orbit sphere (y up).
    eye = center + dist * np.array(
        [np.cos(el) * np.sin(az), np.sin(el), np.cos(el) * np.cos(az)]
    )
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0]))
    nr = np.linalg.norm(right)
    if nr < 1e-6:
        right = np.array([1.0, 0.0, 0.0])
    else:
        right = right / nr
    up = np.cross(right, fwd)
    rot = np.stack([right, up, fwd])  # rows: view axes
    return rot, eye


def render_points(
    pos: np.ndarray,
    color: np.ndarray,
    scale,
    width: int = 960,
    height: int = 720,
    azimuth: float = 35.0,
    elevation: float = 22.0,
    center: Optional[np.ndarray] = None,
    dist: Optional[float] = None,
    fov_deg: float = 40.0,
    background=(18, 20, 26),
    max_radius_px: int = 6,
) -> np.ndarray:
    """Rasterize a colored point cloud -> uint8 [H, W, 3].

    Painter's algorithm (far-to-near overwrite) with square splats whose
    pixel radius follows perspective (world radius `scale` / view depth) —
    the cheap, fully-vectorized stand-in for the reference's instanced
    cubes.  Depth-cue shading darkens far particles slightly so piles read
    as 3D.
    """
    pos = np.asarray(pos, np.float64)
    if pos.shape[1] == 2:  # 2D scenes render in the z=0 plane
        pos = np.concatenate([pos, np.zeros((len(pos), 1))], axis=1)
    color = np.asarray(color, np.float64)
    scale = np.broadcast_to(np.asarray(scale, np.float64).ravel(), (len(pos),))

    lo, hi = pos.min(0), pos.max(0)
    c = (lo + hi) / 2 if center is None else np.asarray(center, np.float64)
    extent = float(np.linalg.norm(hi - lo)) or 1.0
    d = 1.2 * extent if dist is None else float(dist)

    rot, eye = _look_at(c, azimuth, elevation, d)
    v = (pos - eye) @ rot.T                      # [N, 3] view space
    z = v[:, 2]
    keep = z > 1e-3 * d
    v, z, color, scale = v[keep], z[keep], color[keep], scale[keep]

    f = 0.5 * height / np.tan(np.deg2rad(fov_deg) / 2)
    px = (f * v[:, 0] / z + width / 2).astype(np.int64)
    py = (height / 2 - f * v[:, 1] / z).astype(np.int64)
    rpx = np.clip((f * scale / z).astype(np.int64), 1, max_radius_px)

    inside = (px >= 0) & (px < width) & (py >= 0) & (py < height)
    px, py, z, color, rpx = px[inside], py[inside], z[inside], color[inside], rpx[inside]

    # Far-to-near: later (nearer) writes win.
    order = np.argsort(-z, kind="stable")
    px, py, z, color, rpx = px[order], py[order], z[order], color[order], rpx[order]

    # Depth-cue shading.
    if len(z):
        zn = (z - z.min()) / max(z.ptp() if hasattr(z, "ptp") else np.ptp(z), 1e-9)
        shade = (1.0 - 0.45 * zn)[:, None]
        col8 = np.clip(color * shade * 255.0, 0, 255).astype(np.uint8)
    else:
        col8 = np.zeros((0, 3), np.uint8)

    img = np.empty((height, width, 3), np.uint8)
    img[...] = np.asarray(background, np.uint8)
    rmax = int(rpx.max()) if len(rpx) else 0
    for dy in range(-rmax, rmax + 1):
        for dx in range(-rmax, rmax + 1):
            m = (np.maximum(abs(dx), abs(dy)) <= rpx)
            if not m.any():
                continue
            yy = np.clip(py[m] + dy, 0, height - 1)
            xx = np.clip(px[m] + dx, 0, width - 1)
            img[yy, xx] = col8[m]
    return img


def render_instances(instances, **kw) -> np.ndarray:
    """Rasterize a render.prep_instances buffer (uses det(F)^(1/3) as a
    cheap volumetric size cue for the deformation the reference's vertex
    shader applies per cube)."""
    pos = np.asarray(instances["position"])
    color = np.asarray(instances["color"])
    scale = np.asarray(instances["scale"]).ravel()
    defo = np.asarray(instances.get("deformation")) if "deformation" in instances else None
    if defo is not None and defo.ndim == 3 and defo.shape[1] == defo.shape[2]:
        j = np.abs(np.linalg.det(defo))
        scale = scale * np.clip(np.cbrt(np.maximum(j, 1e-6)), 0.5, 2.0)
    return render_points(pos, color, scale, **kw)


# ------------------------------------------------------------------ inputs
def read_ply(path: str):
    """Read the ascii point-cloud PLYs written by render.write_ply."""
    with open(path) as fh:
        assert fh.readline().strip() == "ply"
        n = 0
        for line in fh:
            t = line.strip()
            if t.startswith("element vertex"):
                n = int(t.split()[-1])
            if t == "end_header":
                break
        data = np.loadtxt(fh, max_rows=n)
    pos = data[:, 0:3].astype(np.float32)
    col = (data[:, 3:6] / 255.0).astype(np.float32) if data.shape[1] >= 6 else (
        np.full((n, 3), 0.6, np.float32)
    )
    return pos, col


def save_video(frames: Sequence[np.ndarray], out: str, fps: int = 24):
    """PNG / MP4 / GIF by extension (single frame -> PNG)."""
    ext = os.path.splitext(out)[1].lower()
    if ext == ".png" or len(frames) == 1:
        from PIL import Image

        Image.fromarray(frames[0]).save(
            out if ext == ".png" else out + ".png"
        )
        return
    if ext == ".gif":
        from PIL import Image

        ims = [Image.fromarray(f) for f in frames]
        ims[0].save(
            out, save_all=True, append_images=ims[1:],
            duration=int(1000 / fps), loop=0,
        )
        return
    import imageio

    imageio.mimsave(out, frames, fps=fps)


def turntable(
    pos, color, scale, out: str, n_frames: int = 36, elevation: float = 22.0,
    width: int = 960, height: int = 720, fps: int = 12, **kw,
):
    """Orbit the camera around a static cloud -> video/GIF."""
    frames = [
        render_points(
            pos, color, scale, width=width, height=height,
            azimuth=360.0 * k / n_frames, elevation=elevation, **kw,
        )
        for k in range(n_frames)
    ]
    save_video(frames, out, fps=fps)
    return frames


def render_ply_sequence(paths: Sequence[str], out: str, scale: float = 0.25,
                        fps: int = 24, **kw):
    """Animate a directory of frame_*.ply dumps with a fixed camera whose
    framing is fit on the LAST frame (piles settle outward)."""
    last_pos, _ = read_ply(paths[-1])
    lo, hi = last_pos.min(0), last_pos.max(0)
    center = (lo + hi) / 2
    dist = 1.2 * (float(np.linalg.norm(hi - lo)) or 1.0)
    frames = []
    for p in paths:
        pos, col = read_ply(p)
        frames.append(
            render_points(pos, col, scale, center=center, dist=dist, **kw)
        )
    save_video(frames, out, fps=fps)
    return frames


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("input", help=".ply file or directory of frame_*.ply")
    ap.add_argument("--out", default="out.mp4", help=".png/.gif/.mp4 output")
    ap.add_argument("--scale", type=float, default=0.25,
                    help="world-space particle radius for PLY inputs")
    ap.add_argument("--frames", type=int, default=36,
                    help="turntable frame count for single-PLY input")
    ap.add_argument("--fps", type=int, default=18)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=720)
    args = ap.parse_args(argv)

    if os.path.isdir(args.input):
        paths = sorted(glob.glob(os.path.join(args.input, "*.ply")))
        if not paths:
            raise SystemExit(f"no .ply files in {args.input}")
        render_ply_sequence(
            paths, args.out, scale=args.scale, fps=args.fps,
            width=args.width, height=args.height,
        )
        print(f"wrote {args.out} ({len(paths)} frames)")
    else:
        pos, col = read_ply(args.input)
        turntable(
            pos, col, args.scale, args.out, n_frames=args.frames,
            fps=args.fps, width=args.width, height=args.height,
        )
        print(f"wrote {args.out} (turntable, {args.frames} frames)")


if __name__ == "__main__":
    main()
