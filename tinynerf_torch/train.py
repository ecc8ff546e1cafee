"""The training step: sample -> render -> loss -> grad -> Adam.

Counterpart of ``tinynerf/train.py`` for the 8x256 MLP field and the CP
grid field (``FINE_FIELD = grid``), with or without a proposal field
(``PROPOSAL``: the proposal grid, ``PROP_FIELD = grid``, or the proposal
MLP, ``PROP_FIELD = mlp``), at fp32 or bf16, with or without the occupancy
grid. A step draws a batch (or takes the caller's indices, or under
``HOST_FEED`` the caller's batch); with
``OCC_GRID``, every ``OCC_UPDATE_EVERY`` iterations it first refreshes the
grid from the main field's current params through its point field (the MLP:
on the card, the flat field kernel; the grid field: its plain point field,
as in the JAX package); it renders both passes (``eval.make_field_fn`` /
``make_prop_field_fn``: on the card the MLP's calls run kernels 1 and 2, the
grid fields' calls under ``GRID_PALLAS`` kernels 5 and 6, the proposal
MLP's under ``PROP_PALLAS`` kernels 7 and 8), takes the
gradient of ``render.ray_loss`` (plus ``GRID_TV`` times the fine grid's
``tv_loss``, ``DIST_LOSS`` times the summed distortion loss and
``PROP_INTERLEVEL`` times the summed interlevel loss) with autograd and
applies ``optim.adam_update`` at the schedule's rate for the current
iteration, the grids' line tables at ``GRID_LR_MULT`` times it
(``make_lr_scale``). Under ``CONTRACT`` the fields take contracted points
(``eval.make_field_fn``): the MLP's calls then run kernels 3 and 4, and the
contracted occupancy grid probes through the same wrapper; under ``NDC``
(``ndc_params``, the Runner's) the rays march the NDC cube.

The JAX package fuses several steps into one XLA program (``lax.scan`` in
``make_multi_step`` / ``make_chunked_*``) only to amortise XLA's dispatch;
the port runs one step per call (ROADMAP queue 1 lists the counterpart,
CUDA graphs).

``upsample_grid_state`` resizes the fine grid's tables and their Adam
moments between steps (``GRID_UPSAMPLE``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from tinynerf_torch import optim
from tinynerf_torch.config import Config
from tinynerf_torch.core import gridfield, mlp, occupancy, proposal, render
from tinynerf_torch.data.rays import RayBatch, RayTable
# one field for training and rendering
from tinynerf_torch.eval import (check_supported, make_field_fn, make_prop_field_fn,
                                 net_params, prop_params)
from tinynerf_torch.parallel import mesh as meshlib

Metrics = dict
# the proposal field's fresh weights come from a generator seeded SEED + 2 (SEED
# seeds the main field's, SEED + 1 the sampling generator)
PROP_SEED_OFFSET = 2


@dataclasses.dataclass
class TrainState:
    params: Any                   # the main field's, or the {"net", "prop"} pair
    opt: optim.AdamState
    iteration: int                # drives the LR schedule and resume
    generator: torch.Generator    # batch draws, stratified jitter, grid probes
    occ: Optional[occupancy.OccGrid] = None  # with OCC_GRID


def _fresh_params(cfg: Config, device: torch.device) -> Any:
    """``mlp.init_network`` or ``gridfield.init_grid_field`` from a CPU
    generator seeded with ``SEED``; with ``PROPOSAL`` the ``{"net", "prop"}``
    pair, the proposal grid or MLP from a generator seeded ``SEED + 2``."""
    gen = torch.Generator().manual_seed(cfg.seed)
    if cfg.fine_field == "grid":
        net = gridfield.init_grid_field(
            gen, res=cfg.grid_res, n_density=cfg.grid_comp_density,
            n_app=cfg.grid_comp_app, decoder_width=cfg.grid_decoder_width,
            extent=cfg.grid_extent, hybrid=cfg.grid_hybrid,
            sigma_width=cfg.grid_sigma_width, levels=cfg.grid_levels, device=device)
    else:
        net = mlp.init_network(gen, device)
    if not cfg.proposal:
        return net
    prop_gen = torch.Generator().manual_seed(cfg.seed + PROP_SEED_OFFSET)
    if cfg.prop_field == "mlp":
        prop = proposal.init_proposal(prop_gen, cfg.proposal_width, cfg.proposal_depth,
                                      cfg.proposal_enc_l, device)
    else:
        prop = gridfield.init_grid_field(
            prop_gen, res=cfg.prop_grid_res, n_density=cfg.prop_grid_comp_density,
            n_app=cfg.prop_grid_comp_app, decoder_width=cfg.prop_grid_decoder_width,
            extent=cfg.grid_extent, hybrid=cfg.prop_grid_hybrid, device=device)
    return {"net": net, "prop": prop}


def check_resumed(cfg: Config, params: Any) -> None:
    """Refuse resumed params whose proposal MLP disagrees with the config
    (``PROP_FIELD``, ``PROPOSAL_WIDTH``, ``PROPOSAL_DEPTH``,
    ``PROPOSAL_ENC_L``), naming the key. A main grid whose level count is
    not ``GRID_LEVELS`` keeps the checkpoint's levels, with the JAX
    package's warning (``tinynerf/train.py:50-62``)."""
    lines = net_params(cfg, params).get("lines") if cfg.fine_field == "grid" else None
    if lines is not None and gridfield.num_levels(lines) != cfg.grid_levels:
        print(f"WARNING: checkpoint has {gridfield.num_levels(lines)} grid level(s) "
              f"but GRID_LEVELS={cfg.grid_levels}; the checkpoint's "
              "level structure wins (resume cannot restructure the "
              "pyramid)")
    if not (cfg.proposal and cfg.prop_field == "mlp"):
        return
    if not proposal.is_proposal(params["prop"]):
        raise ValueError("the checkpoint's proposal field is not the proposal MLP, which "
                         "PROP_FIELD = mlp sets")
    proposal.check_config(params["prop"], cfg.proposal_width, cfg.proposal_depth,
                          cfg.proposal_enc_l)


def init_state(cfg: Config, device: torch.device,
               params: Optional[Any] = None,
               opt_state: Optional[optim.AdamState] = None,
               iteration: int = 0,
               generator: Optional[torch.Generator] = None,
               occ: Optional[occupancy.OccGrid] = None) -> TrainState:
    """Fresh or resumed state. Fresh weights: ``_fresh_params``; resumed ones
    must agree with the config's proposal MLP (``check_resumed``). The sampling
    generator lives on ``device`` and is seeded with ``SEED + 1``. With
    ``OCC_GRID`` and no resumed ``occ``, the grid starts all occupied
    (``occupancy.init_grid``). A config the port cannot train yet is refused
    by name (``eval.check_supported``)."""
    check_supported(cfg)
    if params is None:
        params = _fresh_params(cfg, device)
    else:
        check_resumed(cfg, params)
    if opt_state is None:
        opt_state = optim.adam_init(params)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    if cfg.occ_grid and occ is None:
        occ = occupancy.init_grid(cfg.occ_res, cfg.occ_extent, cfg.occ_thresh, device)
    return TrainState(params=params, opt=opt_state, iteration=iteration,
                      generator=generator, occ=occ if cfg.occ_grid else None)


def make_lr_scale(cfg: Config, params: Any) -> Optional[Any]:
    """Per-leaf learning-rate multipliers for ``optim.adam_update``, or None:
    a table ``{x,y,z}{l}`` under ``lines`` (the main grid's and the proposal
    grid's) at ``GRID_LR_MULT * GRID_LEVEL_LR ** l`` (level 0 is ``x, y,
    z``), every other leaf at 1 (a ``sigma_net``, the decoders and the
    proposal MLP included); None unless a grid field trains with a
    multiplier other than 1."""
    uses_grid = cfg.fine_field == "grid" or (cfg.proposal and cfg.prop_field == "grid")
    if not uses_grid or (cfg.grid_lr_mult == 1.0 and cfg.grid_level_lr == 1.0):
        return None

    level = lambda name: int(name[1:]) if name[1:].isdigit() else 0

    def scale(tree):
        out = {}
        for k, v in tree.items():
            if k == "lines":
                out[k] = {name: cfg.grid_lr_mult * cfg.grid_level_lr ** level(name)
                          for name in v}
            else:
                out[k] = scale(v) if isinstance(v, dict) else 1.0
        return out

    return scale(params)


def make_loss_fn(cfg: Config, k_inv: torch.Tensor,
                 field_fn: Optional[render.FieldFn] = None,
                 prop_field_fn: Optional[render.FieldFn] = None,
                 ndc_params=None, param_terms: bool = True) -> Callable:
    """``loss(params, batch, generator, occ, jitter=None) -> (loss,
    (C_coarse, C_fine))``; the generator (or the given (B, N_c) ``jitter``)
    jitters the coarse samples when ``STRATIFIED`` is on, and ``occ`` (the
    occupancy grid, or None) tightens the rays' bounds. With
    ``PROPOSAL``, ``params`` is the ``{"net", "prop"}`` pair and the coarse
    pass runs the proposal field; there ``DIST_LOSS`` and ``PROP_INTERLEVEL``
    add their weight times the per-ray losses summed over the batch (the
    house sum-loss scale), and without ``PROPOSAL`` they raise the JAX
    package's ``ValueError``. With ``FINE_FIELD = grid`` and ``GRID_TV`` the
    loss adds ``GRID_TV * tv_loss`` of the main grid. ``ndc_params`` marches
    the NDC cube. ``param_terms=False`` leaves out the terms of the params
    alone (``GRID_TV``): a rank of a data-parallel step that is not its
    group's first, so that the sum over ranks counts them once."""
    field_fn = field_fn or make_field_fn(cfg)
    prop_fn = prop_field_fn or make_prop_field_fn(cfg)
    want_dist = cfg.dist_loss > 0.0
    want_il = cfg.prop_interlevel > 0.0
    if (want_dist or want_il) and not cfg.proposal:
        raise ValueError("DIST_LOSS / PROP_INTERLEVEL require PROPOSAL=True "
                         "(see render.distortion_loss / interlevel_loss)")

    def loss_fn(params: Any, batch: RayBatch,
                generator: Optional[torch.Generator] = None,
                occ: Optional[occupancy.OccGrid] = None,
                jitter: Optional[torch.Tensor] = None):
        out = render.render_rays(
            net_params(cfg, params), batch.rows, batch.cols, batch.pose17, k_inv,
            cfg.n_coarse, cfg.n_fine, field_fn=field_fn,
            generator=generator if cfg.stratified else None,
            compat_sort=cfg.compat_sort, ndc_params=ndc_params,
            merge_impl="permute", white_bkgd=cfg.white_bkgd, occ_grid=occ,
            occ_march=cfg.occ_march_steps, occ_contract=cfg.contract,
            occ_march_res=cfg.occ_march_res,
            prop_params=prop_params(cfg, params), prop_field_fn=prop_fn,
            want_dist=want_dist, want_interlevel=want_il, lindisp=cfg.lindisp,
            jitter=jitter if cfg.stratified else None)
        c_co, c_fi = out[0], out[1]
        loss = render.ray_loss(c_co, c_fi, batch.rgb)
        if want_dist:
            loss = loss + cfg.dist_loss * torch.sum(out[2]["dist"])
        if want_il:
            loss = loss + cfg.prop_interlevel * torch.sum(out[2]["interlevel"])
        if cfg.fine_field == "grid" and cfg.grid_tv > 0.0 and param_terms:
            loss = loss + cfg.grid_tv * gridfield.tv_loss(net_params(cfg, params))
        return loss, (c_co, c_fi)

    return loss_fn


def loss_and_grads(loss_fn: Callable, params: Any, batch: RayBatch,
                   generator: Optional[torch.Generator] = None,
                   occ: Optional[occupancy.OccGrid] = None,
                   jitter: Optional[torch.Tensor] = None):
    """``(loss, (C_coarse, C_fine), grads)``, grads shaped like ``params``. A
    leaf the loss does not reach (a grid's ``extent``) gets a zero gradient,
    as under ``jax.grad``, so Adam leaves it exactly as it is."""
    leaves = optim.tree_map(lambda t: t.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss, (c_co, c_fi) = loss_fn(leaves, batch, generator, occ, jitter=jitter)
        flat = torch.autograd.grad(loss, optim.leaves(leaves), materialize_grads=True)
    return (loss.detach(), (c_co.detach(), c_fi.detach()),
            optim.unflatten_like(leaves, list(flat)))


def refresh_occ(cfg: Config, state: TrainState, field_fn: render.FieldFn,
                draws=None, mesh: Optional[meshlib.Mesh] = None,
                ) -> Optional[occupancy.OccGrid]:
    """The grid this step renders with: ``state.occ`` refreshed from the main
    field's current params when ``iteration % OCC_UPDATE_EVERY == 0`` (probing
    ``int(OCC_RES**3 * OCC_SUBSET)`` cells, or all of them at a subset of 1;
    under ``CONTRACT`` at the cells' inverse-contracted points), else as it
    is. Draws come from the state's generator unless ``draws``
    (``occupancy.update_grid``) are given. Under a ``mesh`` the probes are
    partitioned over its data group (``update_grid``'s ``cell_split``)."""
    if state.occ is None or state.iteration % cfg.occ_update_every != 0:
        return state.occ
    n_total = cfg.occ_res ** 3
    subset = None if cfg.occ_subset >= 1.0 else max(1, int(n_total * cfg.occ_subset))
    return occupancy.update_grid(state.occ, net_params(cfg, state.params), field_fn,
                                 generator=state.generator, subset=subset,
                                 contract=cfg.contract, draws=draws, cell_split=mesh)


def _apply_batch(cfg: Config, parts, state: TrainState, batch: RayBatch,
                 occ_draws=None, n_rays: Optional[int] = None) -> Tuple[TrainState, Metrics]:
    """Shared step body: grid refresh -> grad -> Adam -> metrics. The
    metrics stay on the device (no synchronisation); ``lr`` is a float32 CPU
    scalar. Under a mesh the gradient is the rank's rows' summed over the
    data group (``mesh.make_grad_fn``), Adam runs alike on every rank, the
    loss is the whole batch's and the batch fields of the metrics are the
    rank's rows; ``n_rays`` says that ``batch`` is already the rank's rows
    of a batch of that many."""
    mesh, loss_fn, lr_fn, field_fn, grad_fn = parts
    occ = refresh_occ(cfg, state, field_fn, occ_draws, mesh)
    if mesh is None:
        loss, (_, c_fi), grads = loss_and_grads(loss_fn, state.params, batch,
                                                state.generator, occ)
    else:
        loss, (_, c_fi), grads = grad_fn(state.params, batch, state.generator, occ,
                                         n_rays=n_rays)
        if n_rays is None:
            batch = mesh.local_rows(batch)
    lr = lr_fn(state.iteration)
    params, opt = optim.adam_update(grads, state.opt, state.params, lr.item(),
                                    lr_scale=make_lr_scale(cfg, state.params))
    metrics = {"loss": loss, "lr": lr,
               "c_true0": batch.rgb[0], "c_fine0": c_fi[0],
               # the batch, for the host-side preview canvas
               "rows": batch.rows, "cols": batch.cols,
               "rgb": batch.rgb, "pic": batch.pic}
    return TrainState(params=params, opt=opt, iteration=state.iteration + 1,
                      generator=state.generator, occ=occ), metrics


def _step_parts(cfg: Config, k_inv: torch.Tensor, field_fn: Optional[render.FieldFn],
                ndc_params, mesh: Optional[meshlib.Mesh]):
    """``(mesh, loss_fn, lr_fn, field_fn, grad_fn)`` of a step builder. On a
    rank that is not its data group's first, the loss leaves out the params'
    own terms (``make_loss_fn``'s ``param_terms``)."""
    field_fn = field_fn or make_field_fn(cfg)
    loss_fn = make_loss_fn(cfg, k_inv, field_fn, ndc_params=ndc_params,
                           param_terms=mesh is None or mesh.data_index == 0)
    grad_fn = (None if mesh is None else
               meshlib.make_grad_fn(loss_fn, mesh, cfg.n_coarse if cfg.stratified else None))
    return mesh, loss_fn, optim.make_lr_fn(cfg), field_fn, grad_fn


def make_train_step(cfg: Config, table: RayTable, k_inv: torch.Tensor,
                    field_fn: Optional[render.FieldFn] = None, ndc_params=None,
                    mesh: Optional[meshlib.Mesh] = None,
                    ) -> Callable[[TrainState], Tuple[TrainState, Metrics]]:
    """``step(state) -> (state, metrics)`` over a batch of ``BATCH_RAY``
    pixels drawn uniformly with replacement. Under a ``mesh`` every rank
    draws the whole batch from its generator (the same on every rank) and
    computes its rows (``_apply_batch``)."""
    parts = _step_parts(cfg, k_inv, field_fn, ndc_params, mesh)

    def step(state: TrainState) -> Tuple[TrainState, Metrics]:
        batch = table.sample(state.generator, cfg.batch_ray)
        return _apply_batch(cfg, parts, state, batch)

    return step


def make_host_fed_train_step(cfg: Config, k_inv: torch.Tensor,
                             field_fn: Optional[render.FieldFn] = None, ndc_params=None,
                             mesh: Optional[meshlib.Mesh] = None,
                             ) -> Callable[[TrainState, RayBatch], Tuple[TrainState, Metrics]]:
    """``step(state, batch) -> (state, metrics)`` over a ``RayBatch`` the
    caller gives (``HOST_FEED``: a batch of the host ray store,
    ``data/native.py``, put on the device by ``RayTable.upload``). Under a
    ``mesh`` the batch is the rank's rows (``mesh.local_rows``) of a batch
    of ``BATCH_RAY``."""
    parts = _step_parts(cfg, k_inv, field_fn, ndc_params, mesh)

    def step(state: TrainState, batch: RayBatch) -> Tuple[TrainState, Metrics]:
        return _apply_batch(cfg, parts, state, batch,
                            n_rays=None if mesh is None else cfg.batch_ray)

    return step


def upsample_grid_state(cfg: Config, state: TrainState, new_res: int) -> TrainState:
    """``GRID_UPSAMPLE``'s step (``tinynerf/train.py:267-290``): the fine grid's
    line tables and Adam's ``mu`` and ``nu`` for them resampled to ``new_res``
    nodes an axis (``gridfield.upsample_lines``; ``nu`` stays non-negative,
    since the weights are). The decoder, the proposal field, the iteration,
    Adam's count, the generator and the occupancy grid stay as they are. A
    step made before the resize holds no table, so it serves after it too."""
    def resize(tree):
        if cfg.proposal:
            return dict(tree, net=gridfield.upsample_lines(tree["net"], new_res))
        return gridfield.upsample_lines(tree, new_res)

    return dataclasses.replace(
        state, params=resize(state.params),
        opt=dataclasses.replace(state.opt, mu=resize(state.opt.mu), nu=resize(state.opt.nu)))


def make_indexed_train_step(cfg: Config, table: RayTable, k_inv: torch.Tensor,
                            field_fn: Optional[render.FieldFn] = None, ndc_params=None,
                            mesh: Optional[meshlib.Mesh] = None,
                            ) -> Callable[..., Tuple[TrainState, Metrics]]:
    """``step(state, idx, occ_draws=None) -> (state, metrics)`` over the
    given (B,) flat pixel indices: the epoch path (a without-replacement
    permutation, the reference DataLoader's ``shuffle=True,
    drop_last=True``), and the way tests feed the JAX package's index stream
    (and, through ``occ_draws``, its grid-refresh draws). Under a ``mesh``
    every rank takes the same indices and computes its rows."""
    parts = _step_parts(cfg, k_inv, field_fn, ndc_params, mesh)

    def step(state: TrainState, idx: torch.Tensor,
             occ_draws=None) -> Tuple[TrainState, Metrics]:
        return _apply_batch(cfg, parts, state, table.gather(idx), occ_draws)

    return step
