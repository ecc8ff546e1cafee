"""Plain PyTorch training steps of a NeRF configuration, for the check: the
first steps from the benchmark's weights on the benchmark's scene, with the
loss, the gradients and Adam written out.

A step draws its batch of ``BATCH_RAY`` pixels uniformly with replacement
(``randint`` over the flat index ``view * H * W + row * W + col``) from a
generator on the device seeded as the program's is; at every
``OCC_UPDATE_EVERY``-th iteration (the first included) it then refreshes
the occupancy grid from the same generator (``render.occ_refresh``). The
loss is the sum of squared errors of both passes over rays and channels,
plus the configuration's terms of the weights alone. Adam has betas 0.9
and 0.999 and ``eps = 1e-7`` outside the square root, bias-corrected
moments, the ``EXP`` schedule ``LEARNING * LR_GAMMA ** (it / DECAY_END)``,
and each leaf's rate times its multiplier.

The program draws in that order (its batch, then the refresh's cells and
jitter), so both sides see the same rays and probes; that order is the one
thing of the program's this reference follows.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nerfbench.reference import render

B1, B2, EPS = 0.9, 0.999, 1e-7


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(path, tensor)`` of every leaf, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix.lstrip("/"), tree)]


def tree(values: Dict[str, torch.Tensor]):
    """The nested dict of ``leaves``' paths."""
    out: dict = {}
    for path, t in values.items():
        node = out
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = t
    return out


def learning_rate(ini: dict, it: int) -> float:
    if ini["SCHED"].upper() != "EXP" or it >= ini["DECAY_END"]:
        raise ValueError("the reference follows the EXP schedule before DECAY_END")
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    return float(f32(ini["LEARNING"]) * torch.pow(f32(ini["LR_GAMMA"]),
                                                  f32(float(it)) / f32(float(ini["DECAY_END"]))))


class Scene:
    """The benchmark's scene on the host: ``images`` (N, H, W, 3) float32,
    ``poses`` (N, 17), the intrinsics."""

    def __init__(self, images: np.ndarray, poses: np.ndarray, height: int, width: int,
                 focal: float):
        self.images, self.poses = images, poses
        self.height, self.width, self.focal = height, width, focal


def true_fp32() -> None:
    """Float32 products in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def follow(module, ini: dict, params0, scene: Scene, gen_seed: int, steps: int,
           q: Callable = lambda x: x, keep: Optional[int] = None, scale: float = 1.0,
           device=None) -> dict:
    """The first ``steps`` steps from ``params0``: ``{"loss": [...], "grad":
    {path: the first step's gradient}, "step": {path: the change after the
    last step}, "occ": the raw grid after the first step}``, on the CPU. ``q`` rounds the fields' values (``precision.py``). ``keep``
    and ``scale`` take only the first ``keep`` rays of each batch into the
    loss, times ``scale`` (the check's planted faults)."""
    true_fp32()
    device = device or leaves(params0)[0][1].device
    for key in ("STRATIFIED", "LINDISP", "CONTRACT", "NDC", "COMPAT_SORT", "FUSED_RENDER"):
        if ini.get(key):
            raise ValueError(f"the reference does not follow {key}")
    start = {p: t.detach().to(device, torch.float32).clone() for p, t in leaves(params0)}
    cur = {p: t.clone() for p, t in start.items()}
    mu = {p: torch.zeros_like(t) for p, t in cur.items()}
    nu = {p: torch.zeros_like(t) for p, t in cur.items()}
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    h, w = scene.height, scene.width
    pixels = torch.from_numpy(scene.images.reshape(-1, 3))
    poses = torch.as_tensor(np.asarray(scene.poses, np.float32), device=device)
    kinv = render.k_inv(h, w, scene.focal, device)
    res, extent = ini["OCC_RES"], ini["OCC_EXTENT"]
    raw, density = render.occ_init(res, device) if ini["OCC_GRID"] else (None, None)
    subset = max(1, int(res ** 3 * ini["OCC_SUBSET"]))
    if ini["OCC_GRID"] and subset >= res ** 3:
        raise ValueError("the reference follows a partial refresh (OCC_SUBSET < 1)")
    n_march = render.march_steps(res, extent, float(np.max(scene.poses[:, 16] - scene.poses[:, 15])))
    out = {"loss": [], "grad": {}, "step": {}, "occ": None}
    for it in range(steps):
        idx = torch.randint(0, pixels.shape[0], (ini["BATCH_RAY"],), generator=gen,
                            device=device)
        params = tree({p: t.requires_grad_(True) for p, t in cur.items()})
        main, prop = module.fields(params, ini, q)
        if ini["OCC_GRID"] and it % ini["OCC_UPDATE_EVERY"] == 0:
            plain, _ = module.fields(tree({p: t.detach() for p, t in cur.items()}), ini, q)
            raw, density = render.occ_refresh(raw, plain, gen, subset, extent)
            if it == 0:
                out["occ"] = raw.cpu()
        sel = idx if keep is None else idx[:keep]
        pic = sel // (h * w)
        rows = ((sel % (h * w)) // w).float()
        cols = (sel % w).float()
        rgb = pixels[sel.cpu()].to(device)
        c_co, c_fi = render.render_rays(main, prop, rows, cols, poses[pic], kinv, ini,
                                        density, n_march)
        loss = scale * (torch.sum(torch.square(c_co - rgb)) + torch.sum(torch.square(c_fi - rgb)))
        extra = module.param_loss(params, ini)
        if extra is not None:
            loss = loss + extra
        names = list(cur)
        grads = torch.autograd.grad(loss, [cur[p] for p in names], allow_unused=True)
        grads = {p: torch.zeros_like(cur[p]) if g is None else g for p, g in zip(names, grads)}
        out["loss"].append(float(loss.detach()))
        if it == 0:
            out["grad"] = {p: g.detach().cpu() for p, g in grads.items()}
        lr = learning_rate(ini, it)
        t = it + 1
        with torch.no_grad():
            for p in names:
                g = grads[p]
                mu[p] = B1 * mu[p] + (1.0 - B1) * g
                nu[p] = B2 * nu[p] + (1.0 - B2) * g * g
                rate = lr * module.lr_scale(p, ini)
                cur[p] = (cur[p] - rate * (mu[p] / (1.0 - B1 ** t))
                          / (torch.sqrt(nu[p] / (1.0 - B2 ** t)) + EPS)).detach()
    out["step"] = {p: (cur[p] - start[p]).cpu() for p in cur}
    return out


@torch.no_grad()
def render_frame(module, ini: dict, params, pose17: np.ndarray, height: int, width: int,
                 focal: float, n_march: int, q: Callable = lambda x: x,
                 block: int = 32768, device=None) -> np.ndarray:
    """One (H, W, 3) frame of the fine pass, rays in blocks of ``block``,
    with an all-occupied occupancy grid where the configuration has one."""
    true_fp32()
    device = device or leaves(params)[0][1].device
    main, prop = module.fields(params, ini, q)
    kinv = render.k_inv(height, width, focal, device)
    density = render.occ_init(ini["OCC_RES"], device)[1] if ini["OCC_GRID"] else None
    pose = torch.as_tensor(np.asarray(pose17, np.float32), device=device)
    n = height * width
    out = torch.empty((n, 3), device=device)
    for s in range(0, n, block):
        idx = torch.arange(s, min(s + block, n), device=device)
        rows, cols = (idx // width).float(), (idx % width).float()
        out[s:s + idx.shape[0]] = render.render_rays(
            main, prop, rows, cols, pose.expand(idx.shape[0], 17), kinv, ini, density,
            n_march)[1]
    return out.reshape(height, width, 3).cpu().numpy()
