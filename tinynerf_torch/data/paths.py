"""Free-viewpoint camera paths for video rendering (``--mode=path``) and
single viewpoints for the render service (``tools/serve_render.py``).

A copy of ``tinynerf/data/paths.py``: ``make_path`` and its generators, and
the viewer's single-pose helpers :func:`orbit_pose` and :func:`free_pose`.

Three scene-appropriate generators, all emitting the framework's native
(N, 17) pose-row format so the render stack consumes them unchanged:

- :func:`orbit_path` — a constant-radius 360-degree orbit looking at the
  origin, matched to the training cameras' radius/elevation (Blender-style
  inward-facing rigs);
- :func:`pan_path` — a 360-degree outward pan from the training ring for
  unbounded-360 captures (auto-selected via :func:`is_outward_rig`);
- :func:`spiral_path` — the standard LLFF spiral around the average camera
  for forward-facing captures, with degeneracy fallbacks so an inward 360
  rig still produces well-formed poses.

``res_scale`` scales the h/w/f column, so a 2x path renders e.g. a
1600x1600-class video from 800-class training intrinsics.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from tinynerf_torch.data.poses import average_pose, view_matrix, _normalize


def _rows_from_c2ws(c2ws: np.ndarray, hwf: np.ndarray, near: float,
                    far: float) -> np.ndarray:
    n = c2ws.shape[0]
    rows = np.zeros((n, 17))
    for i in range(n):
        pose = np.concatenate([c2ws[i], hwf.reshape(3, 1)], axis=1)
        rows[i] = np.concatenate([pose.flatten(), [near, far]])
    return rows


def _split_rows(pose_rows: np.ndarray):
    c2ws = pose_rows[:, :15].reshape(-1, 3, 5)[:, :, :4]
    hwf = pose_rows[0, :15].reshape(3, 5)[:, 4]
    near = float(pose_rows[:, 15].min())
    far = float(pose_rows[:, 16].max())
    return c2ws, hwf, near, far


def _orbit_geometry(pose_rows: np.ndarray):
    """Shared orbit-sphere fit: (radius, elevation, hwf, near, far) of the
    training rig (mean camera radius/elevation around the origin)."""
    c2ws, hwf, near, far = _split_rows(np.asarray(pose_rows, np.float64))
    centers = c2ws[:, :, 3]
    radii = np.linalg.norm(centers, axis=1)
    radius = float(radii.mean())
    if radius < 1e-6:
        radius = 0.5 * (near + far)
    # mean elevation, clamped away from the poles so `up` stays transverse
    elev = float(np.arcsin(np.clip(centers[:, 1] / np.maximum(radii, 1e-9),
                                   -1.0, 1.0)).mean())
    elev = float(np.clip(elev, -1.4, 1.4))
    return radius, elev, hwf, near, far


def _orbit_c2w(radius: float, theta: float, elev: float) -> np.ndarray:
    """Origin-looking camera at spherical (radius, azimuth, elevation)."""
    up = np.array([0.0, 1.0, 0.0])
    pos = radius * np.array([np.sin(theta) * np.cos(elev),
                             np.sin(elev),
                             np.cos(theta) * np.cos(elev)])
    return view_matrix(pos, up, pos)  # back == normalized position


def orbit_path(pose_rows: np.ndarray, n_views: int = 120,
               res_scale: float = 1.0) -> np.ndarray:
    """360-degree orbit at the training cameras' mean radius and elevation,
    every camera looking exactly at the origin (back axis == position/r)."""
    radius, elev, hwf, near, far = _orbit_geometry(pose_rows)
    out = np.zeros((n_views, 3, 4))
    for i, theta in enumerate(np.linspace(0.0, 2.0 * np.pi, n_views,
                                          endpoint=False)):
        out[i] = _orbit_c2w(radius, theta, elev)
    return _rows_from_c2ws(out, hwf * res_scale, near, far)


def orbit_pose(pose_rows: np.ndarray, theta_deg: float,
               elev_deg: Optional[float] = None, radius_scale: float = 1.0,
               res_scale: float = 1.0) -> np.ndarray:
    """ONE free-viewpoint pose row on (a scaling of) the training rig's
    orbit sphere — the interactive-viewer parameterization
    (tools/serve_render.py): azimuth/elevation in degrees, radius relative
    to the rig's mean. ``elev_deg=None`` keeps the rig's mean elevation."""
    base_radius, elev, hwf, near, far = _orbit_geometry(pose_rows)
    if elev_deg is not None:
        elev = float(np.clip(np.deg2rad(elev_deg), -1.4, 1.4))
    radius = base_radius * float(radius_scale)
    c2w = _orbit_c2w(radius, np.deg2rad(theta_deg), elev)
    # near/far track the radius change so the march still brackets the scene
    shift = radius - base_radius
    near = max(near + shift, 1e-3)
    far = far + shift
    return _rows_from_c2ws(c2w[None], hwf * res_scale, near, far)[0]


def is_outward_rig(pose_rows: np.ndarray) -> bool:
    """True when the training cameras look AWAY from the origin (an
    unbounded-360 capture: a ring near the center looking out), detected
    from the mean alignment of each camera's back axis with its position
    direction — inward orbit rigs score ~+1 (back == pos/|pos|), outward
    rings ~-1, forward-facing rigs ~0."""
    c2ws, _hwf, _near, _far = _split_rows(np.asarray(pose_rows, np.float64))
    centers = c2ws[:, :, 3]
    norms = np.linalg.norm(centers, axis=1)
    ok = norms > 1e-6
    if not ok.any():
        return False
    align = np.sum(c2ws[ok, :, 2] * (centers[ok] / norms[ok, None]), axis=1)
    return float(align.mean()) < -0.3


def _pan_geometry(pose_rows: np.ndarray):
    """Outward-ring fit: (ring radius, mean look elevation, hwf, near, far)."""
    c2ws, hwf, near, far = _split_rows(np.asarray(pose_rows, np.float64))
    centers = c2ws[:, :, 3]
    radius = float(np.linalg.norm(centers, axis=1).mean())
    look = -c2ws[:, :, 2]
    elev = float(np.arcsin(np.clip(look[:, 1], -1.0, 1.0)).mean())
    return radius, float(np.clip(elev, -1.4, 1.4)), hwf, near, far


def _pan_c2w(radius: float, theta: float, elev: float) -> np.ndarray:
    """Camera ON the ring at azimuth theta, looking OUTWARD along it."""
    up = np.array([0.0, 1.0, 0.0])
    direction = np.array([np.sin(theta) * np.cos(elev),
                          np.sin(elev),
                          np.cos(theta) * np.cos(elev)])
    pos = radius * np.array([np.sin(theta), 0.0, np.cos(theta)])
    return view_matrix(-direction, up, pos)


def pan_path(pose_rows: np.ndarray, n_views: int = 120,
             res_scale: float = 1.0) -> np.ndarray:
    """360-degree outward pan from the training ring — the natural video
    path for unbounded-360 captures (an orbit_path would look INWARD at
    the camera ring and render nothing). Selected automatically by
    :func:`make_path` / :func:`free_pose` via :func:`is_outward_rig`."""
    radius, elev, hwf, near, far = _pan_geometry(pose_rows)
    out = np.zeros((n_views, 3, 4))
    for i, theta in enumerate(np.linspace(0.0, 2.0 * np.pi, n_views,
                                          endpoint=False)):
        out[i] = _pan_c2w(radius, theta, elev)
    return _rows_from_c2ws(out, hwf * res_scale, near, far)


def free_pose(pose_rows: np.ndarray, theta_deg: float,
              elev_deg: Optional[float] = None, radius_scale: float = 1.0,
              res_scale: float = 1.0) -> np.ndarray:
    """ONE rig-appropriate free-viewpoint pose row (the interactive-viewer
    parameterization): outward pan on 360 rings, origin-looking orbit
    otherwise. On rings, ``radius_scale`` slides the camera along the ring
    radius (bounds already span the scene, so near/far stay put) and
    ``elev_deg`` tilts the LOOK direction, not the position."""
    if not is_outward_rig(pose_rows):
        return orbit_pose(pose_rows, theta_deg, elev_deg=elev_deg,
                          radius_scale=radius_scale, res_scale=res_scale)
    radius, elev, hwf, near, far = _pan_geometry(pose_rows)
    if elev_deg is not None:
        elev = float(np.clip(np.deg2rad(elev_deg), -1.4, 1.4))
    c2w = _pan_c2w(radius * float(radius_scale), np.deg2rad(theta_deg), elev)
    return _rows_from_c2ws(c2w[None], hwf * res_scale, near, far)[0]


def spiral_path(pose_rows: np.ndarray, n_views: int = 120,
                res_scale: float = 1.0, rots: float = 2.0,
                zrate: float = 0.5) -> np.ndarray:
    """LLFF-style spiral around the average camera of a forward-facing rig.

    Radii come from the 90th percentile of the camera offsets expressed in
    the average camera's frame; the look target sits at the standard LLFF
    focus depth blended from the scene bounds. All constructions normalize,
    so the emitted rotations are orthonormal even on degenerate rigs.
    """
    c2ws, hwf, near, far = _split_rows(np.asarray(pose_rows, np.float64))
    avg = average_pose(c2ws)                      # (3, 4) [right up back | pos]
    up = _normalize(c2ws[:, :, 1].sum(axis=0),
                    fallback=np.array([0.0, 1.0, 0.0]))

    # camera offsets in the average frame -> spiral radii
    rel = (c2ws[:, :, 3] - avg[:, 3]) @ avg[:, :3]      # (N, 3)
    rads = np.percentile(np.abs(rel), 90, axis=0) + 1e-3

    # focus depth (LLFF dt = 0.75 blend of close/infinity planes)
    close_depth, inf_depth = max(near * 0.9, 1e-3), far * 5.0
    dt = 0.75
    focus = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
    look = avg[:, :3] @ np.array([0.0, 0.0, -focus]) + avg[:, 3]

    out = np.zeros((n_views, 3, 4))
    thetas = np.linspace(0.0, 2.0 * np.pi * rots, n_views, endpoint=False)
    for i, theta in enumerate(thetas):
        offset = np.array([np.cos(theta) * rads[0],
                           -np.sin(theta) * rads[1],
                           -np.sin(theta * zrate) * rads[2]])
        pos = avg[:, :3] @ offset + avg[:, 3]
        back = _normalize(pos - look, fallback=avg[:, 2])
        out[i] = view_matrix(back, up, pos)
    return _rows_from_c2ws(out, hwf * res_scale, near, far)


def make_path(pose_rows: np.ndarray, data_type: str, n_views: int = 120,
              res_scale: float = 1.0) -> np.ndarray:
    """Scene-appropriate path: spiral for forward-facing llff captures,
    outward pan for unbounded-360 rings, orbit for inward-facing
    synthetic rigs."""
    if data_type == "llff":
        return spiral_path(pose_rows, n_views, res_scale=res_scale)
    if is_outward_rig(pose_rows):
        return pan_path(pose_rows, n_views, res_scale=res_scale)
    return orbit_path(pose_rows, n_views, res_scale=res_scale)
