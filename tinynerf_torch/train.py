"""The training step: sample -> render -> loss -> grad -> Adam.

Counterpart of ``tinynerf/train.py`` for the 8x256 MLP field, at fp32 or
bf16, with or without the occupancy grid (no grid field or proposal). A step
draws a batch (or takes the caller's indices); with ``OCC_GRID``, every
``OCC_UPDATE_EVERY`` iterations it first refreshes the grid from the current
params (on the card, through the flat field kernel); it renders both passes
through the field (``eval.make_field_fn``: on the card both field calls run
the forward kernel and, in the backward, the recompute-backward kernel),
takes the gradient of ``render.ray_loss`` with autograd and applies
``optim.adam_update`` at the schedule's rate for the current iteration.

The JAX package fuses several steps into one XLA program (``lax.scan`` in
``make_multi_step`` / ``make_chunked_*``) only to amortise XLA's dispatch;
the port runs one step per call (ROADMAP queue 1 lists the counterpart,
CUDA graphs).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from tinynerf_torch import optim
from tinynerf_torch.config import Config
from tinynerf_torch.core import mlp, occupancy, render
from tinynerf_torch.data.rays import RayBatch, RayTable
from tinynerf_torch.eval import make_field_fn  # one field for training and rendering

Metrics = dict


@dataclasses.dataclass
class TrainState:
    params: mlp.Params
    opt: optim.AdamState
    iteration: int                # drives the LR schedule and resume
    generator: torch.Generator    # batch draws, stratified jitter, grid probes
    occ: Optional[occupancy.OccGrid] = None  # with OCC_GRID


def init_state(cfg: Config, device: torch.device,
               params: Optional[mlp.Params] = None,
               opt_state: Optional[optim.AdamState] = None,
               iteration: int = 0,
               generator: Optional[torch.Generator] = None,
               occ: Optional[occupancy.OccGrid] = None) -> TrainState:
    """Fresh or resumed state. Fresh weights are ``mlp.init_network`` from a
    CPU generator seeded with ``SEED``; the sampling generator lives on
    ``device`` and is seeded with ``SEED + 1``. With ``OCC_GRID`` and no
    resumed ``occ``, the grid starts all occupied (``occupancy.init_grid``)."""
    if cfg.fine_field != "mlp" or cfg.proposal:
        raise NotImplementedError(
            "only the reference MLP trains in the port; FINE_FIELD=grid and "
            "PROPOSAL are ROADMAP queue 1, slice 4: the grid field and the proposal grid")
    if params is None:
        params = mlp.init_network(torch.Generator().manual_seed(cfg.seed), device)
    if opt_state is None:
        opt_state = optim.adam_init(params)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    if cfg.occ_grid and occ is None:
        occ = occupancy.init_grid(cfg.occ_res, cfg.occ_extent, cfg.occ_thresh, device)
    return TrainState(params=params, opt=opt_state, iteration=iteration,
                      generator=generator, occ=occ if cfg.occ_grid else None)


def make_loss_fn(cfg: Config, k_inv: torch.Tensor,
                 field_fn: Optional[render.FieldFn] = None) -> Callable:
    """``loss(params, batch, generator, occ) -> (loss, (C_coarse, C_fine))``;
    the generator jitters the coarse samples when ``STRATIFIED`` is on, and
    ``occ`` (the occupancy grid, or None) tightens the rays' bounds."""
    field_fn = field_fn or make_field_fn(cfg)

    def loss_fn(params: mlp.Params, batch: RayBatch,
                generator: Optional[torch.Generator] = None,
                occ: Optional[occupancy.OccGrid] = None):
        c_co, c_fi = render.render_rays(
            params, batch.rows, batch.cols, batch.pose17, k_inv,
            cfg.n_coarse, cfg.n_fine, field_fn=field_fn,
            generator=generator if cfg.stratified else None,
            compat_sort=cfg.compat_sort, merge_impl="permute",
            white_bkgd=cfg.white_bkgd, occ_grid=occ,
            occ_march=cfg.occ_march_steps, occ_contract=cfg.contract,
            occ_march_res=cfg.occ_march_res)
        return render.ray_loss(c_co, c_fi, batch.rgb), (c_co, c_fi)

    return loss_fn


def loss_and_grads(loss_fn: Callable, params: mlp.Params, batch: RayBatch,
                   generator: Optional[torch.Generator] = None,
                   occ: Optional[occupancy.OccGrid] = None):
    """``(loss, (C_coarse, C_fine), grads)``, grads shaped like ``params``."""
    leaves = optim.tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, (c_co, c_fi) = loss_fn(leaves, batch, generator, occ)
        flat = torch.autograd.grad(loss, optim.leaves(leaves))
    return (loss.detach(), (c_co.detach(), c_fi.detach()),
            optim.unflatten_like(leaves, list(flat)))


def refresh_occ(cfg: Config, state: TrainState, field_fn: render.FieldFn,
                draws=None) -> Optional[occupancy.OccGrid]:
    """The grid this step renders with: ``state.occ`` refreshed from the
    current params when ``iteration % OCC_UPDATE_EVERY == 0`` (probing
    ``int(OCC_RES**3 * OCC_SUBSET)`` cells, or all of them at a subset of 1),
    else as it is. Draws come from the state's generator unless ``draws``
    (``occupancy.update_grid``) are given."""
    if state.occ is None or state.iteration % cfg.occ_update_every != 0:
        return state.occ
    n_total = cfg.occ_res ** 3
    subset = None if cfg.occ_subset >= 1.0 else max(1, int(n_total * cfg.occ_subset))
    return occupancy.update_grid(state.occ, state.params, field_fn,
                                 generator=state.generator, subset=subset,
                                 contract=cfg.contract, draws=draws)


def _apply_batch(cfg: Config, loss_fn: Callable, lr_fn: Callable,
                 field_fn: render.FieldFn, state: TrainState, batch: RayBatch,
                 occ_draws=None) -> Tuple[TrainState, Metrics]:
    """Shared step body: grid refresh -> grad -> Adam -> metrics. The
    metrics stay on the device (no synchronisation); ``lr`` is a float32 CPU
    scalar."""
    occ = refresh_occ(cfg, state, field_fn, occ_draws)
    loss, (_, c_fi), grads = loss_and_grads(loss_fn, state.params, batch,
                                            state.generator, occ)
    lr = lr_fn(state.iteration)
    params, opt = optim.adam_update(grads, state.opt, state.params, lr.item())
    metrics = {"loss": loss, "lr": lr,
               "c_true0": batch.rgb[0], "c_fine0": c_fi[0],
               # the batch, for the host-side preview canvas
               "rows": batch.rows, "cols": batch.cols,
               "rgb": batch.rgb, "pic": batch.pic}
    return TrainState(params=params, opt=opt, iteration=state.iteration + 1,
                      generator=state.generator, occ=occ), metrics


def make_train_step(cfg: Config, table: RayTable, k_inv: torch.Tensor,
                    field_fn: Optional[render.FieldFn] = None,
                    ) -> Callable[[TrainState], Tuple[TrainState, Metrics]]:
    """``step(state) -> (state, metrics)`` over a batch of ``BATCH_RAY``
    pixels drawn uniformly with replacement."""
    field_fn = field_fn or make_field_fn(cfg)
    loss_fn = make_loss_fn(cfg, k_inv, field_fn)
    lr_fn = optim.make_lr_fn(cfg)

    def step(state: TrainState) -> Tuple[TrainState, Metrics]:
        batch = table.sample(state.generator, cfg.batch_ray)
        return _apply_batch(cfg, loss_fn, lr_fn, field_fn, state, batch)

    return step


def make_indexed_train_step(cfg: Config, table: RayTable, k_inv: torch.Tensor,
                            field_fn: Optional[render.FieldFn] = None,
                            ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``step(state, idx, occ_draws=None) -> (state, metrics)`` over the
    given (B,) flat pixel indices: the epoch path (a without-replacement
    permutation, the reference DataLoader's ``shuffle=True,
    drop_last=True``), and the way tests feed the JAX package's index stream
    (and, through ``occ_draws``, its grid-refresh draws)."""
    field_fn = field_fn or make_field_fn(cfg)
    loss_fn = make_loss_fn(cfg, k_inv, field_fn)
    lr_fn = optim.make_lr_fn(cfg)

    def step(state: TrainState, idx: torch.Tensor,
             occ_draws=None) -> Tuple[TrainState, Metrics]:
        return _apply_batch(cfg, loss_fn, lr_fn, field_fn, state,
                            table.gather(idx), occ_draws)

    return step
