"""The grid field's bf16 sigmoid (``gridfield.sigmoid_bf16``) against the JAX
package's ``jax.nn.sigmoid`` on bf16 values: the same forward steps and
JAX's gradient rule for ``lax.logistic``, ``g * (ans * (1 - ans))``. Autograd
through the forward's steps gave a NaN gradient where ``exp(-x)``
overflows (a decoder logit below -88.7): the validate protocol's ``full``
family reached one in its proposal grid between steps 2,000 and 4,000 on
an H100, and every param turned NaN."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tinynerf.core import gridfield as jgf
from tinynerf_torch import ckpt
from tinynerf_torch.core import gridfield, mlp
from tests.torch_workers import torch_threads  # noqa: F401 (autouse)

# XLA on the CPU flushes results below the smallest normal float32 (2^-126)
# to zero and the port keeps them: values may differ by that, gradients by
# that times the cotangent
SUBNORMAL = 2.0 ** -126


def _logits():
    x = np.concatenate([np.linspace(-120.0, 40.0, 4001),
                        [-89.5, -88.8, -88.7, -88.6, -1e-3, 0.0, 1e-3]]).astype(np.float32)
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def test_sigmoid_bf16_matches_jax_logistic():
    """Values and the VJP equal JAX's on bf16 logits from -120 to 40, the
    overflow of ``exp(-x)`` below -88.7 included; every gradient finite."""
    x = _logits().copy()
    g = np.array(jnp.asarray(np.random.default_rng(0).normal(size=x.shape).astype(np.float32))
                 .astype(jnp.bfloat16).astype(jnp.float32))
    ans, vjp = jax.vjp(jax.nn.sigmoid, jnp.asarray(x).astype(jnp.bfloat16))
    (gj,) = vjp(jnp.asarray(g).astype(jnp.bfloat16))
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = gridfield.sigmoid_bf16(xt)
    (gt,) = torch.autograd.grad(yt, xt, torch.from_numpy(g))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(ans, np.float32), rtol=0,
                               atol=SUBNORMAL)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj, np.float32), rtol=0,
                               atol=SUBNORMAL * np.abs(g).max())
    assert np.isfinite(gt.numpy()).all()
    assert torch.equal(yt.detach(), mlp.round_bf16(yt.detach()))   # bf16 values


@pytest.mark.parametrize("bias", [-100.0, 0.0])
def test_grid_field_bf16_gradient_is_finite_and_jax_s(bias):
    """A small grid's point field at bf16 with the decoder's color bias at
    ``bias`` (-100: every logit below the overflow): every gradient is
    finite; the decoder's weights and the line tables within 1e-3 of
    max|ref| of the JAX package's (autograd through the sigmoid's steps
    missed by 6e-3 to 8e-3 at bias 0); the color bias, whose gradient is a
    sum over the rows that the two packages round in another order, at
    cosine >= 0.9999."""
    jparams = jgf.init_grid_field(jax.random.PRNGKey(4), res=16, n_density=4, n_app=8,
                                  decoder_width=16, extent=1.5)
    jparams["decoder"]["color"]["b"] = jparams["decoder"]["color"]["b"] + bias
    rng = np.random.default_rng(5)
    pts = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
    d = rng.normal(size=(200, 3))
    dirs = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    w = rng.normal(size=(200, 3)).astype(np.float32)

    def jloss(p):
        c, s = jgf.apply_grid_field(p, jnp.asarray(pts), jnp.asarray(dirs), n_density=4,
                                    compute_dtype=jnp.bfloat16)
        return jnp.sum(jnp.stack(c, axis=-1).astype(jnp.float32) * w) + jnp.sum(
            s.astype(jnp.float32))

    jg = jax.grad(jloss)(jparams)
    params = ckpt.params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    leaves = {("decoder", "color", "w"): params["decoder"]["color"]["w"],
              ("decoder", "color", "b"): params["decoder"]["color"]["b"],
              ("decoder", "hidden", "w"): params["decoder"]["hidden"]["w"],
              ("lines", "x"): params["lines"]["x"]}
    for t in leaves.values():
        t.requires_grad_(True)
    color, sigma = gridfield.apply_grid_field(params, torch.from_numpy(pts),
                                              torch.from_numpy(dirs), n_density=4,
                                              precision="bf16")
    loss = torch.sum(color * torch.from_numpy(w)) + torch.sum(sigma)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    for key, g in zip(leaves, grads):
        ref = np.asarray(jg[key[0]][key[1]][key[2]] if len(key) == 3 else jg[key[0]][key[1]],
                         np.float64)
        got = g.numpy().astype(np.float64)
        assert np.isfinite(got).all(), key
        if key == ("decoder", "color", "b"):
            if ref.any():   # at bias -100 every logit saturates: JAX's is 0
                cos = got.ravel() @ ref.ravel() / (np.linalg.norm(got) * np.linalg.norm(ref))
                assert cos >= 0.9999, (key, cos)
            else:
                assert np.abs(got).max() <= SUBNORMAL * np.abs(w).max(), key
        else:
            err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
            assert err <= 1e-3, (key, err)
