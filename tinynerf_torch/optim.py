"""Adam and the learning-rate schedules, as functions over parameter dicts.

Counterpart of ``tinynerf/optim.py``. Adam has ``torch.optim.Adam``'s
semantics (bias-corrected moments, eps **outside** the sqrt, the reference's
``betas=(0.9, 0.999), eps=1e-7``) but the JAX package's formula order,
``p - lr * (m / bc1) / (sqrt(v / bc2) + eps)`` with ``b ** t`` in float32,
which ``torch.optim.Adam`` orders differently; so it is written out here.

Schedules (reference ``nerf.py:426-427``):

- ``EXP``: ``learning * gamma ** (iter / decay_end)`` while
  ``iter < decay_end``, else ``learning * (gamma * learning)``: the
  post-decay multiplier really is ``gamma * learning`` (reference quirk Q6);
- ``MULTISTEP``: ``learning * gamma ** (#milestones <= iter)``.

Both are closed-form in the iteration, so a resumed run continues its
schedule exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

Tree = Dict[str, Any]  # nested dicts of tensors, like the parameters


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


@dataclasses.dataclass
class AdamState:
    count: int   # updates applied
    mu: Tree     # first moments, shaped like the parameters
    nu: Tree     # second moments


def adam_init(params: Tree) -> AdamState:
    zeros = lambda p: torch.zeros_like(p)
    return AdamState(count=0, mu=tree_map(zeros, params),
                     nu=tree_map(zeros, params))


def leaves(tree: Tree) -> List[torch.Tensor]:
    """The leaves of ``tree``, keys sorted at every level (as JAX orders a
    dict), so two trees of one structure line up whatever their insertion
    order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def unflatten_like(tree: Tree, flat: List[torch.Tensor]) -> Tree:
    """Inverse of ``leaves``: ``flat`` put back into ``tree``'s nesting."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(tree)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return torch.tensor(x, dtype=torch.float32).item()


def adam_rates(count: int, lr: float, n_leaves: int, lr_scale: Optional[Tree] = None,
               b1: float = 0.9, b2: float = 0.999) -> List[float]:
    """The scalars of Adam's update number ``count`` (1 for the first),
    float32 values computed on the host: ``[1 - b1 ** count, 1 - b2 **
    count]`` (the power in float32), then each of the ``n_leaves`` leaves'
    rate, ``lr`` or ``lr`` times its ``lr_scale`` multiplier, each product
    rounded to float32. ``adam_update`` reads them as tensors."""
    t = torch.tensor(float(count), dtype=torch.float32)
    pw = lambda b: torch.pow(torch.tensor(b, dtype=torch.float32), t)
    lr = _f32(float(lr))
    rate = ([lr] * n_leaves if lr_scale is None
            else [_f32(lr * _f32(float(s))) for s in leaves(lr_scale)])
    return [(1.0 - pw(b1)).item(), (1.0 - pw(b2)).item()] + rate


def rate_groups(n_leaves: int, lr_scale: Optional[Tree] = None) -> List[List[int]]:
    """The leaves' indices grouped by their ``lr_scale`` multiplier (one group
    without one): the leaves of a group share one rate, so a group's update
    is one multi-tensor launch."""
    if lr_scale is None:
        return [list(range(n_leaves))]
    groups: Dict[float, List[int]] = {}
    for i, s in enumerate(leaves(lr_scale)):
        groups.setdefault(float(s), []).append(i)
    return list(groups.values())


def _device_rates(values: List[float], device: torch.device) -> torch.Tensor:
    """``values`` as a float32 tensor on ``device``; to the card through a
    pinned buffer and an asynchronous copy, so the host does not wait for the
    card's queue."""
    host = torch.tensor(values, dtype=torch.float32)
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)


def adam_update(grads: Tree, state: AdamState, params: Tree,
                lr: float, b1: float = 0.9, b2: float = 0.999,
                eps: float = 1e-7, lr_scale: Optional[Tree] = None,
                rates: Optional[torch.Tensor] = None):
    """One Adam step. Returns ``(new_params, new_state)``; the inputs are not
    modified. ``lr`` is the learning rate (a float32 value); ``lr_scale`` an
    optional tree of per-leaf multipliers of it. The step's scalars
    (``adam_rates``) are read as tensors on the params' device: ``rates``, a
    float32 ``(n_leaves + 2,)`` row of them (a CUDA graph's, which then
    ignores ``lr``), or else made here from ``lr``. Every scalar is a float32
    value, so each elementwise operation rounds as the JAX package's does;
    the leaves go through PyTorch's multi-tensor (``_foreach``) operations,
    a few launches per step instead of a few per leaf."""
    count = state.count + 1
    g, p = leaves(grads), leaves(params)
    if rates is None:
        rates = _device_rates(adam_rates(count, lr, len(p), lr_scale, b1, b2), p[0].device)
    mu = torch._foreach_add(torch._foreach_mul(leaves(state.mu), _f32(b1)),
                            torch._foreach_mul(g, _f32(1 - b1)))
    nu = torch._foreach_add(
        torch._foreach_mul(leaves(state.nu), _f32(b2)),
        torch._foreach_mul(torch._foreach_mul(g, _f32(1 - b2)), g))
    step = torch._foreach_div(mu, rates[0])
    for group in rate_groups(len(p), lr_scale):
        torch._foreach_mul_([step[i] for i in group], rates[2 + group[0]])
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, rates[1])),
                               _f32(eps))
    new_p = torch._foreach_sub(p, torch._foreach_div(step, denom))
    return (unflatten_like(params, new_p),
            AdamState(count=count, mu=unflatten_like(params, mu),
                      nu=unflatten_like(params, nu)))


def exp_schedule(iteration: int, learning: float, gamma: float,
                 decay_end: float) -> torch.Tensor:
    """Reference EXP schedule, Q6-exact, as a float32 scalar."""
    it = torch.tensor(float(iteration), dtype=torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    if iteration < decay_end:
        mult = torch.pow(f32(gamma), it / f32(decay_end))
    else:
        mult = f32(gamma * learning)   # the product in double, then rounded
    return f32(learning) * mult


def multistep_schedule(iteration: int, learning: float, gamma: float,
                       milestones: Sequence[int]) -> torch.Tensor:
    """Reference MultiStepLR: ``learning * gamma ** (#milestones <= iter)``."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)
    crossed = sum(1 for m in milestones if float(m) <= float(iteration))
    return f32(learning) * torch.pow(f32(gamma), f32(float(crossed)))


def make_lr_fn(cfg) -> Callable[[int], torch.Tensor]:
    """Schedule closure from a :class:`tinynerf_torch.config.Config`."""
    if cfg.sched.upper() == "EXP":
        return lambda it: exp_schedule(it, cfg.learning, cfg.lr_gamma,
                                       float(cfg.decay_end))
    return lambda it: multistep_schedule(it, cfg.learning, cfg.lr_gamma,
                                         cfg.lr_milestone)
