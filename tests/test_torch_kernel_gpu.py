"""The CUDA field kernels (forward and backward) against their plain PyTorch
versions, on the card.

This file imports neither JAX nor ``tinynerf``, so it also runs on a machine
that has only PyTorch with CUDA:

    python -m pytest --noconftest tests/test_torch_kernel_gpu.py -q

(``--noconftest`` skips ``tests/conftest.py``, which configures JAX.)
Without a card the test skips itself.
"""

import numpy as np
import pytest
import torch

from tinynerf_torch.core import mlp
from tinynerf_torch.kernels import mlp_kernel as mk


def _dyadic_rays(seed, B, N):
    """Coordinates quantized to 1/16, so o + t*d is exact in float32."""
    rng = np.random.default_rng(seed)
    q = lambda x: np.round(x * 16.0) / 16.0
    origins = q(rng.uniform(-1, 1, (B, 3))).astype(np.float32)
    d = rng.normal(size=(B, 3))
    dirs = q(d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    ts = np.sort(q(rng.uniform(2.0, 6.0, (B, N))).astype(np.float32), axis=1)
    return origins, dirs, ts


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays,n_samples", [(4096, 64), (4096, 128), (13, 7)])
def test_kernel_matches_plain_on_card(n_rays, n_samples):
    """At the render path's shapes (B=4096, N=64 and 128) and at a ragged
    one. Tolerances: color 1e-5, sigma 1e-4 abs + 1e-4 rel; cuBLAS and the
    kernel sum in different orders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    params = mlp.init_network(torch.Generator().manual_seed(0), dev)
    o, d, t = (torch.from_numpy(a).to(dev)
               for a in _dyadic_rays(n_samples, n_rays, n_samples))
    before = mk.field_rays.launches
    with torch.no_grad():
        planes, sigma = mk.field_rays(params, o, d, t)
        p_planes, p_sigma = mk.field_rays_plain(params, o, d, t)
    torch.cuda.synchronize()
    assert mk.field_rays.launches == before + 1
    for a, b in zip(planes, p_planes):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(sigma, p_sigma, atol=1e-4, rtol=1e-4)


def _errors(kernel, plain):
    """error / max|plain| for every output of field_rays_bwd."""
    (kg, *k_rest), (pg, *p_rest) = kernel, plain
    pairs = [(f"{n}.{k}", kg[n][k], pg[n][k]) for n in pg for k in ("w", "b")]
    pairs += list(zip(("d_origins", "d_dirs", "d_ts"), k_rest, p_rest))
    return {name: float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for name, a, b in pairs}


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays,n_samples", [
    (400, 64), (400, 128), (600, 128), (13, 7), (5, 100)])
def test_bwd_kernel_matches_plain_on_card(n_rays, n_samples):
    """At a training step's shapes (B=400, N=64 and 128), across two chunks
    of rows (600 x 128 > 65,536) and at ragged ones: every gradient within
    1e-4 of max|plain|. Rows whose smallest |pre-activation| is under 2e-6
    get zero cotangents: there the two float32 sums may take the other side
    of a ReLU, which is not a fault of either. Two calls agree bit for bit
    (no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    params = mlp.init_network(torch.Generator().manual_seed(1), dev)
    o, d, t = (torch.from_numpy(a).to(dev)
               for a in _dyadic_rays(n_rays, n_rays, n_samples))
    keep = (mk.preactivation_margin(params, o, d, t) > 2e-6).float()
    rng = np.random.default_rng(n_samples)
    cots = [torch.from_numpy(rng.normal(size=t.shape).astype(np.float32)).to(dev) * keep
            for _ in range(4)]
    before = mk.field_rays_bwd.launches
    kernel = mk.field_rays_bwd(params, o, d, t, *cots)
    again = mk.field_rays_bwd(params, o, d, t, *cots)
    plain = mk.field_rays_bwd_plain(params, o, d, t, *cots)
    torch.cuda.synchronize()
    assert mk.field_rays_bwd.launches == before + 2
    errors = _errors(kernel, plain)
    assert max(errors.values()) <= 1e-4, errors
    assert all(e == 0 for e in _errors(kernel, again).values())
