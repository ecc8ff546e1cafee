"""Generate a synthetic scene by analytic raytracing, without Pillow.

The port's counterpart of ``tools/make_synthetic_scene.py``: the same
scenes (the lambertian spheres, the outward 360 ring, the forward-facing
LLFF layout and the high-frequency texture scene), the same cameras, the
same numpy raytracing and the same flags, so it writes the same files:
``transforms_{train,val,test}.json`` and RGBA PNG renders in the Blender
layout the loader expects (``loader.py:12-36``), or ``images/`` and
``poses_bounds.npy`` in the LLFF layout. The PNGs are written by the port's
own encoder (``data/imagefile.py``), so it runs where Pillow is absent.

Usage:
    python -m tinynerf_torch.tools.make_synthetic_scene out_dir --hw 100 --views 30
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from tinynerf_torch.data.imagefile import write_png

SPHERES = [
    # (center, radius, albedo)
    (np.array([0.0, 0.0, 0.0]), 0.9, np.array([0.85, 0.25, 0.20])),
    (np.array([0.9, 0.6, -0.4]), 0.45, np.array([0.20, 0.55, 0.90])),
    (np.array([-0.8, -0.5, 0.5]), 0.5, np.array([0.95, 0.80, 0.25])),
]
LIGHT_DIR = np.array([0.5, 1.0, 0.25]) / np.linalg.norm([0.5, 1.0, 0.25])
CAMERA_ANGLE_X = 0.7
RADIUS = 4.0


def look_at(position: np.ndarray) -> np.ndarray:
    back = position / np.linalg.norm(position)
    up_hint = np.array([0.0, 1.0, 0.0])
    right = np.cross(up_hint, back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, back, position
    return c2w


def ray_sphere(origin, dirs, center, radius):
    """First-hit distances (inf when missed). dirs (N,3) unit."""
    oc = origin - center
    b = dirs @ oc
    c = oc @ oc - radius * radius
    disc = b * b - c
    hit = disc > 0
    sqrt_d = np.sqrt(np.maximum(disc, 0.0))
    t = -b - sqrt_d
    t = np.where(hit & (t > 1e-3), t, np.inf)
    return t


def render_view(c2w: np.ndarray, hw: int) -> np.ndarray:
    """(hw, hw, 4) uint8 RGBA, alpha=0 where no geometry (matching Blender
    synthetic exports — the loader composites onto white)."""
    focal = 0.5 * hw / np.tan(0.5 * CAMERA_ANGLE_X)
    # the reference convention: row -> x, col -> y (Q12); render with the
    # SAME convention so training reconstructs the observed images
    rr, cc = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    x_c = rr.reshape(-1) - 0.5 * hw
    y_c = -cc.reshape(-1) + 0.5 * hw
    z_c = np.full_like(x_c, -focal, dtype=np.float64)
    d_cam = np.stack([x_c, y_c, z_c], axis=1)
    d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
    d_world = d_cam @ c2w[:3, :3].T
    origin = c2w[:3, 3]

    best_t = np.full(hw * hw, np.inf)
    color = np.zeros((hw * hw, 3))
    for center, radius, albedo in SPHERES:
        t = ray_sphere(origin, d_world, center, radius)
        closer = t < best_t
        if not closer.any():
            continue
        pts = origin + t[closer, None] * d_world[closer]
        normals = (pts - center) / radius
        lambert = np.clip(normals @ LIGHT_DIR, 0.0, 1.0)
        color[closer] = albedo * (0.25 + 0.75 * lambert[:, None])
        best_t = np.where(closer, t, best_t)

    alpha = np.isfinite(best_t).astype(np.float64)
    rgba = np.concatenate([color, alpha[:, None]], axis=1)
    return (np.clip(rgba, 0, 1).reshape(hw, hw, 4) * 255).astype(np.uint8)


# --- high-frequency "texture" scene family (scene family #2) -------------
# Same capture protocol as the lambertian-spheres scene (inward orbit at
# RADIUS=4, CAMERA_ANGLE_X=0.7, content inside |p| < 1.5 so the sync
# ingest's near/far 2/6 box and the presets' GRID_EXTENT=1.5 carry over
# unchanged) but with the content classes the flat-albedo scene lacks —
# the ones the reference's real scenes (lego's texture, fern's foliage)
# stress: checkered/striped albedo (high spatial frequency), a glossy
# strongly view-dependent specular term, thin rods, and a checkered
# ground disk seen at grazing angles. Exists to re-test every frontier
# closed on the low-frequency scene (VERDICT r4 #2).

_CHECK_A = np.array([0.92, 0.16, 0.12])
_CHECK_B = np.array([0.95, 0.92, 0.85])
_STRIPE_A = np.array([0.15, 0.35, 0.9])
_STRIPE_B = np.array([0.95, 0.85, 0.2])
_GROUND_A = np.array([0.12, 0.12, 0.14])
_GROUND_B = np.array([0.85, 0.85, 0.8])
_ROD_A = np.array([0.9, 0.2, 0.85])
_ROD_B = np.array([0.95, 0.95, 0.95])

_RODS = [
    # (endpoint A, endpoint B, radius) — thin structures, all inside r<1.45
    (np.array([-1.1, -0.9, -0.55]), np.array([0.95, 0.85, 0.3]), 0.025),
    (np.array([-0.85, 0.9, -0.55]), np.array([0.8, -0.8, 0.6]), 0.03),
    (np.array([0.3, -1.05, 0.85]), np.array([0.35, 0.95, 0.8]), 0.025),
]
_DISK_Y, _DISK_R = -1.0, 1.05


def ray_cylinder(origin, dirs, a, b, radius):
    """First-hit distances on a finite (uncapped) cylinder from a to b.

    Solves the quadratic of the ray against the infinite cylinder around
    axis (b-a), then rejects hits whose axial coordinate falls outside the
    segment. Returns (t, hit_points_normal_fn inputs) as (t, axis unit)."""
    axis = b - a
    length = np.linalg.norm(axis)
    axis = axis / length
    oc = origin - a
    d_perp = dirs - np.outer(dirs @ axis, axis)
    oc_perp = oc - (oc @ axis) * axis
    A = np.sum(d_perp * d_perp, axis=1)
    B = d_perp @ oc_perp
    C = oc_perp @ oc_perp - radius * radius
    disc = B * B - A * C
    ok = (disc > 0) & (A > 1e-12)
    sqrt_d = np.sqrt(np.maximum(disc, 0.0))
    t = np.where(ok, (-B - sqrt_d) / np.maximum(A, 1e-12), np.inf)
    s = oc @ axis + t * (dirs @ axis)          # axial coordinate of the hit
    t = np.where(ok & (t > 1e-3) & (s >= 0.0) & (s <= length), t, np.inf)
    return t, axis, length


def render_view_texture(c2w: np.ndarray, hw: int) -> np.ndarray:
    """(hw, hw, 4) uint8 RGBA of the high-frequency scene (transparent
    background, like the Blender exports the loader composites to white).

    Shading = ambient + lambert + per-object Blinn-Phong specular (the
    specular lobe moves with the camera — genuinely view-dependent GT)."""
    focal = 0.5 * hw / np.tan(0.5 * CAMERA_ANGLE_X)
    rr, cc = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    x_c = rr.reshape(-1) - 0.5 * hw
    y_c = -cc.reshape(-1) + 0.5 * hw
    z_c = np.full_like(x_c, -focal, dtype=np.float64)
    d_cam = np.stack([x_c, y_c, z_c], axis=1)
    d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
    d_world = d_cam @ c2w[:3, :3].T
    origin = c2w[:3, 3]

    best_t = np.full(hw * hw, np.inf)
    color = np.zeros((hw * hw, 3))

    def shade(mask, t, normals, albedo, spec=0.0, shin=32.0):
        nonlocal best_t, color
        if not mask.any():
            return
        lambert = np.clip(normals @ LIGHT_DIR, 0.0, 1.0)
        out = albedo * (0.25 + 0.75 * lambert[:, None])
        if spec > 0.0:
            view = -d_world[mask]
            half = LIGHT_DIR + view
            half /= np.linalg.norm(half, axis=1, keepdims=True)
            hl = np.clip(np.sum(normals * half, axis=1), 0.0, 1.0) ** shin
            out = out + spec * hl[:, None]
        color[mask] = np.clip(out, 0.0, 1.0)
        best_t = np.where(mask, t, best_t)

    # 1. big checkered sphere: 16 longitude x 8 latitude checks
    center, radius = np.array([0.0, 0.05, 0.0]), 0.9
    t = ray_sphere(origin, d_world, center, radius)
    closer = t < best_t
    if closer.any():
        pts = origin + t[closer, None] * d_world[closer]
        n = (pts - center) / radius
        phi = np.arctan2(n[:, 2], n[:, 0])
        theta = np.arccos(np.clip(n[:, 1], -1, 1))
        check = ((np.floor(phi / (2 * np.pi) * 16)
                  + np.floor(theta / np.pi * 8)) % 2).astype(bool)
        alb = np.where(check[:, None], _CHECK_A, _CHECK_B)
        shade(closer, t, n, alb, spec=0.15, shin=16.0)

    # 2. finely striped sphere (24 longitude stripes)
    center, radius = np.array([0.85, 0.55, -0.35]), 0.42
    t = ray_sphere(origin, d_world, center, radius)
    closer = t < best_t
    if closer.any():
        pts = origin + t[closer, None] * d_world[closer]
        n = (pts - center) / radius
        phi = np.arctan2(n[:, 2], n[:, 0])
        stripe = (np.sin(12.0 * phi) > 0.0)
        alb = np.where(stripe[:, None], _STRIPE_A, _STRIPE_B)
        shade(closer, t, n, alb, spec=0.3, shin=24.0)

    # 3. glossy sphere: dark albedo + strong tight specular highlight
    center, radius = np.array([-0.75, -0.45, 0.45]), 0.48
    t = ray_sphere(origin, d_world, center, radius)
    closer = t < best_t
    if closer.any():
        pts = origin + t[closer, None] * d_world[closer]
        n = (pts - center) / radius
        shade(closer, t, n, np.array([0.08, 0.32, 0.14]), spec=0.9, shin=80.0)

    # 4. thin striped rods
    for a, b, radius in _RODS:
        t, axis, length = ray_cylinder(origin, d_world, a, b, radius)
        closer = t < best_t
        if not closer.any():
            continue
        pts = origin + t[closer, None] * d_world[closer]
        s = (pts - a) @ axis
        n = pts - a - s[:, None] * axis
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        stripe = (np.sin(s / length * 30.0 * np.pi) > 0.0)
        alb = np.where(stripe[:, None], _ROD_A, _ROD_B)
        shade(closer, t, n, alb, spec=0.2, shin=32.0)

    # 5. checkered ground disk (grazing-angle high frequency)
    denom = d_world[:, 1]
    t = np.where(np.abs(denom) > 1e-9,
                 (_DISK_Y - origin[1]) / np.where(np.abs(denom) > 1e-9,
                                                  denom, 1.0), np.inf)
    pts = origin[None, :] + t[:, None] * d_world
    in_disk = (t > 1e-3) & (pts[:, 0] ** 2 + pts[:, 2] ** 2 < _DISK_R ** 2)
    t = np.where(in_disk, t, np.inf)
    closer = t < best_t
    if closer.any():
        p = pts[closer]
        check = ((np.floor(p[:, 0] / 0.18)
                  + np.floor(p[:, 2] / 0.18)) % 2).astype(bool)
        alb = np.where(check[:, None], _GROUND_A, _GROUND_B)
        n = np.tile(np.array([0.0, 1.0, 0.0]), (p.shape[0], 1))
        shade(closer, t, n, alb, spec=0.25, shin=16.0)

    alpha = np.isfinite(best_t).astype(np.float64)
    rgba = np.concatenate([color, alpha[:, None]], axis=1)
    return (np.clip(rgba, 0, 1).reshape(hw, hw, 4) * 255).astype(np.uint8)


def make_texture_scene(out_dir: str, hw: int = 100, views: int = 30,
                       val_views: int = 5, test_views: int = 5) -> None:
    """Blender-format high-frequency scene at the standard protocol
    (identical camera schedule to make_scene, only the content differs)."""
    splits = {"train": views, "val": val_views, "test": test_views}
    for mode, n in splits.items():
        frames = []
        img_dir = os.path.join(out_dir, mode)
        os.makedirs(img_dir, exist_ok=True)
        for i in range(n):
            theta = 2 * np.pi * (i / n + (0.33 if mode == "val" else
                                          0.71 if mode == "test" else 0.0))
            elev = np.deg2rad(-25.0 + 10.0 * np.sin(2.1 * theta))
            position = RADIUS * np.array([
                np.sin(theta) * np.cos(elev), -np.sin(elev),
                np.cos(theta) * np.cos(elev)])
            c2w = look_at(position)
            write_png(os.path.join(img_dir, f"r_{i}.png"), render_view_texture(c2w, hw))
            frames.append({"file_path": f"./{mode}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{mode}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    print(f"wrote {sum(splits.values())} texture views at {hw}x{hw} "
          f"-> {out_dir}")


def make_llff_scene(out_dir: str, hw: int = 100, views: int = 20) -> None:
    """Forward-facing variant in the LLFF on-disk layout: ``images/`` +
    ``poses_bounds.npy`` with the [down, right, back] disk basis the loader
    converts via (col1, -col0, col2) (reference ``loader.py:49-50``).
    Composites onto white (llff ingest has no alpha path)."""
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    focal = 0.5 * hw / np.tan(0.5 * CAMERA_ANGLE_X)
    rng = np.random.default_rng(3)
    rows = np.zeros((views, 17))
    for i in range(views):
        position = np.array([0.35 * rng.normal(), 0.2 * rng.normal(),
                             RADIUS + 0.15 * rng.normal()])
        c2w = look_at(position)
        rgba = render_view(c2w, hw).astype(np.float64) / 255.0
        rgb = rgba[..., :3] * rgba[..., 3:] + (1.0 - rgba[..., 3:])
        write_png(os.path.join(img_dir, f"img_{i}.png"), (rgb * 255).astype(np.uint8))
        # store in the LLFF disk basis (inverse of the loader's shuffle)
        rot = c2w[:3, :3]
        disk_rot = np.stack([-rot[:, 1], rot[:, 0], rot[:, 2]], axis=1)
        pose = np.concatenate(
            [np.concatenate([disk_rot, c2w[:3, 3:4]], axis=1),
             np.array([[hw], [hw], [focal]])], axis=1)
        near = float(np.linalg.norm(position)) - 2.0
        far = float(np.linalg.norm(position)) + 2.0
        rows[i] = np.concatenate([pose.flatten(), [near, far]])
    np.save(os.path.join(out_dir, "poses_bounds.npy"), rows)
    print(f"wrote {views} llff views at {hw}x{hw} -> {out_dir}")


# --- outward-facing unbounded-360 variant (VERDICT r3 #2) ---------------
# Cameras sit on a SMALL ring near the origin looking OUTWARD; content
# spans two orders of magnitude of depth (spheres at r~2-18 plus a
# procedurally-shaded environment shell at r=60, hit by every escaping
# ray). No bounded [near, far] box both contains the near spheres at
# usable resolution and reaches the shell — the capability CONTRACT +
# LINDISP exist for, and one the reference cannot express at all (its
# march is a fixed 2..6 box, nerf.py:288-295).
RING_RADIUS = 0.3
ENV_RADIUS = 60.0


def _spheres_360():
    """Content in every direction across two depth octaves — like a real
    360 capture (ground, trees, buildings), not an empty sky. Mid-range
    (r ~2.5-20) dominates the pixel budget: that is where parallax across
    the camera ring matters, i.e. where a direction-only (view-dependent
    shortcut) model fails and actual spatial representation is required.
    Deterministic (seeded) so every generated capture is identical."""
    rng = np.random.default_rng(42)
    spheres = [
        # near anchors (hand-placed so the ring always has close geometry)
        (np.array([2.5, 0.0, 0.0]), 0.8, np.array([0.85, 0.25, 0.20])),
        (np.array([-1.8, 0.3, 1.8]), 0.7, np.array([0.20, 0.55, 0.90])),
        (np.array([0.4, -0.4, -2.6]), 0.9, np.array([0.95, 0.80, 0.25])),
        (np.array([-2.2, 0.5, -2.0]), 0.75, np.array([0.30, 0.80, 0.40])),
    ]
    for _ in range(28):
        az = rng.uniform(0.0, 2 * np.pi)
        el = np.deg2rad(rng.normal(0.0, 18.0))
        r = float(np.exp(rng.uniform(np.log(3.0), np.log(20.0))))
        d = np.array([np.sin(az) * np.cos(el), np.sin(el),
                      np.cos(az) * np.cos(el)])
        radius = r * rng.uniform(0.08, 0.18)  # ~constant angular size
        albedo = rng.uniform(0.2, 0.95, size=3)
        spheres.append((r * d, radius, albedo))
    return spheres


SPHERES_360 = _spheres_360()


def _env_shell(dirs: np.ndarray) -> np.ndarray:
    """Smooth direction-indexed environment color (the 'sky at infinity'):
    low-frequency bands so the field can represent it near the contraction
    boundary without aliasing."""
    d = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    r = 0.55 + 0.35 * np.sin(2.0 * d[:, 0] + 4.0 * d[:, 2])
    g = 0.55 + 0.35 * np.sin(3.0 * d[:, 1] - 2.0 * d[:, 0] + 1.0)
    b = 0.65 + 0.30 * np.cos(2.5 * d[:, 2] + 1.5 * d[:, 1])
    return np.clip(np.stack([r, g, b], axis=1), 0.0, 1.0)


def look_outward(position: np.ndarray, direction: np.ndarray) -> np.ndarray:
    """c2w for a camera AT ``position`` looking ALONG ``direction``."""
    back = -direction / np.linalg.norm(direction)
    up_hint = np.array([0.0, 1.0, 0.0])
    right = np.cross(up_hint, back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, back, position
    return c2w


def render_view_360(c2w: np.ndarray, hw: int) -> np.ndarray:
    """(hw, hw, 4) uint8 RGBA over SPHERES_360 + the environment shell
    (alpha=1 everywhere: every ray terminates on geometry or the shell)."""
    focal = 0.5 * hw / np.tan(0.5 * CAMERA_ANGLE_X)
    rr, cc = np.meshgrid(np.arange(hw), np.arange(hw), indexing="ij")
    x_c = rr.reshape(-1) - 0.5 * hw
    y_c = -cc.reshape(-1) + 0.5 * hw
    z_c = np.full_like(x_c, -focal, dtype=np.float64)
    d_cam = np.stack([x_c, y_c, z_c], axis=1)
    d_cam /= np.linalg.norm(d_cam, axis=1, keepdims=True)
    d_world = d_cam @ c2w[:3, :3].T
    origin = c2w[:3, 3]

    best_t = np.full(hw * hw, np.inf)
    color = _env_shell(d_world)  # miss -> environment at infinity
    for center, radius, albedo in SPHERES_360:
        t = ray_sphere(origin, d_world, center, radius)
        closer = t < best_t
        if not closer.any():
            continue
        pts = origin + t[closer, None] * d_world[closer]
        normals = (pts - center) / radius
        lambert = np.clip(normals @ LIGHT_DIR, 0.0, 1.0)
        color[closer] = albedo * (0.25 + 0.75 * lambert[:, None])
        best_t = np.where(closer, t, best_t)

    rgba = np.concatenate([color, np.ones((hw * hw, 1))], axis=1)
    return (np.clip(rgba, 0, 1).reshape(hw, hw, 4) * 255).astype(np.uint8)


def make_360_scene(out_dir: str, hw: int = 100, views: int = 30,
                   val_views: int = 5, test_views: int = 5) -> None:
    """Blender-format outward-facing 360 scene: cameras on a RING_RADIUS
    ring sweeping all azimuths. Pair with NEAR=0.1 FAR=80 (the sync
    ingest's hardcoded 2/6 box sees almost nothing of this scene) and the
    CONTRACT+LINDISP stack — conf/synthetic360.ini is the tuned recipe."""
    splits = {"train": views, "val": val_views, "test": test_views}
    for mode, n in splits.items():
        frames = []
        img_dir = os.path.join(out_dir, mode)
        os.makedirs(img_dir, exist_ok=True)
        for i in range(n):
            theta = 2 * np.pi * (i / n + (0.37 if mode == "val" else
                                          0.67 if mode == "test" else 0.0))
            elev = np.deg2rad(8.0 * np.sin(1.7 * theta + 0.4))
            position = RING_RADIUS * np.array(
                [np.sin(theta), 0.25 * np.cos(2.3 * theta), np.cos(theta)])
            direction = np.array([
                np.sin(theta) * np.cos(elev), np.sin(elev),
                np.cos(theta) * np.cos(elev)])
            c2w = look_outward(position, direction)
            write_png(os.path.join(img_dir, f"r_{i}.png"), render_view_360(c2w, hw))
            frames.append({"file_path": f"./{mode}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{mode}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    print(f"wrote {sum(splits.values())} outward-360 views at {hw}x{hw} "
          f"-> {out_dir}")


def make_scene(out_dir: str, hw: int = 100, views: int = 30,
               val_views: int = 5, test_views: int = 5) -> None:
    rng = np.random.default_rng(0)
    splits = {"train": views, "val": val_views, "test": test_views}
    for mode, n in splits.items():
        frames = []
        img_dir = os.path.join(out_dir, mode)
        os.makedirs(img_dir, exist_ok=True)
        for i in range(n):
            theta = 2 * np.pi * (i / n + (0.33 if mode == "val" else
                                          0.71 if mode == "test" else 0.0))
            elev = np.deg2rad(-25.0 + 10.0 * np.sin(2.1 * theta))
            position = RADIUS * np.array([
                np.sin(theta) * np.cos(elev), -np.sin(elev),
                np.cos(theta) * np.cos(elev)])
            c2w = look_at(position)
            write_png(os.path.join(img_dir, f"r_{i}.png"), render_view(c2w, hw))
            frames.append({"file_path": f"./{mode}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(out_dir, f"transforms_{mode}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    print(f"wrote {sum(splits.values())} views at {hw}x{hw} -> {out_dir}")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Write a synthetic scene (no Pillow).")
    parser.add_argument("out_dir")
    parser.add_argument("--hw", type=int, default=100)
    parser.add_argument("--views", type=int, default=30)
    parser.add_argument("--format", type=str, default="sync",
                        choices=["sync", "llff", "360", "texture"])
    args = parser.parse_args(argv)
    if args.format == "llff":
        make_llff_scene(args.out_dir, hw=args.hw, views=args.views)
    elif args.format == "360":
        make_360_scene(args.out_dir, hw=args.hw, views=args.views)
    elif args.format == "texture":
        make_texture_scene(args.out_dir, hw=args.hw, views=args.views)
    else:
        make_scene(args.out_dir, hw=args.hw, views=args.views)


if __name__ == "__main__":
    main()
