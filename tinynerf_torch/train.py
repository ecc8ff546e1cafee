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
``make_multi_step`` / ``make_chunked_*``); the port's counterparts here take
a chunk of steps a call with the same metrics (the scalars stacked, the
preview fields of the last step). On the CPU a chunk is its plain version,
the steps one after another; on the card each step of a chunk is the
replay of a CUDA graph (``graphs.StepGraphs``), under a mesh too where its
collectives run over NCCL; under gloo a chunk is a host loop of steps
(``graphs_take``). Adam's scalars of a chunk
are made on the host and read as tensors (``optim.adam_rates``), so a
graph's replay takes each step's own.

``upsample_grid_state`` resizes the fine grid's tables and their Adam
moments between steps (``GRID_UPSAMPLE``).

With spans on (``profiling.spans_on``, ``TRACE_SPANS``) a step times its
layers on the card (``profiling.section``): it opens the device stopwatch
and runs its parts as the sections ``step.sample`` (the batch's draw or
gather), ``step.refresh`` (the occupancy refresh, on a step that refreshes),
``step.render`` (the loss's forward: the renderer and ``ray_loss``),
``step.backward`` (autograd) and ``step.adam``; the kernel wrappers nest
theirs (``field.fwd``, ``field.bwd``, ...). A chunk's host time is the span
``chunk``, with ``chunk.rates`` (``chunk_rates``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from tinynerf_torch import optim, profiling
from tinynerf_torch.config import Config
from tinynerf_torch.core import gridfield, mlp, occupancy, proposal, render
from tinynerf_torch.data.rays import RayBatch, RayTable
# one field for training and rendering
from tinynerf_torch.eval import (check_supported, make_field_fn, make_prop_field_fn,
                                 net_params, prop_params)
from tinynerf_torch.parallel import distributed as dist, mesh as meshlib

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
        with profiling.section("step.render"):
            loss, (c_co, c_fi) = loss_fn(leaves, batch, generator, occ, jitter=jitter)
        with profiling.section("step.backward"):
            flat = torch.autograd.grad(loss, optim.leaves(leaves), materialize_grads=True)
    return (loss.detach(), (c_co.detach(), c_fi.detach()),
            optim.unflatten_like(leaves, list(flat)))


def refresh_occ(cfg: Config, state: TrainState, field_fn: render.FieldFn,
                draws=None, mesh: Optional[meshlib.Mesh] = None,
                refresh: Optional[bool] = None) -> Optional[occupancy.OccGrid]:
    """The grid this step renders with: ``state.occ`` refreshed from the main
    field's current params when ``iteration % OCC_UPDATE_EVERY == 0``, or
    where the caller says so (``refresh``: a step graph's, decided on the
    host for the iteration it replays at) (probing
    ``int(OCC_RES**3 * OCC_SUBSET)`` cells, or all of them at a subset of 1;
    under ``CONTRACT`` at the cells' inverse-contracted points), else as it
    is. Draws come from the state's generator unless ``draws``
    (``occupancy.update_grid``) are given. Under a ``mesh`` the probes are
    partitioned over its data group (``update_grid``'s ``cell_split``)."""
    if refresh is None:
        refresh = state.iteration % cfg.occ_update_every == 0
    if state.occ is None or not refresh:
        return state.occ
    n_total = cfg.occ_res ** 3
    subset = None if cfg.occ_subset >= 1.0 else max(1, int(n_total * cfg.occ_subset))
    with profiling.section("step.refresh"):
        return occupancy.update_grid(state.occ, net_params(cfg, state.params), field_fn,
                                     generator=state.generator, subset=subset,
                                     contract=cfg.contract, draws=draws, cell_split=mesh)


def _apply_batch(cfg: Config, parts, state: TrainState, batch: RayBatch,
                 occ_draws=None, n_rays: Optional[int] = None,
                 rates: Optional[torch.Tensor] = None,
                 refresh: Optional[bool] = None) -> Tuple[TrainState, Metrics]:
    """Shared step body: grid refresh -> grad -> Adam -> metrics. The
    metrics stay on the device (no synchronisation); ``lr`` is a float32 CPU
    scalar. ``rates`` (a chunk's row of ``optim.adam_rates``, on the device)
    and ``refresh`` (``refresh_occ``'s) stand for what the step would
    otherwise derive from the iteration on the host. Under a mesh the
    gradient is the rank's rows' summed over the
    data group (``mesh.make_grad_fn``), Adam runs alike on every rank, the
    loss is the whole batch's and the batch fields of the metrics are the
    rank's rows; ``n_rays`` says that ``batch`` is already the rank's rows
    of a batch of that many."""
    mesh, loss_fn, lr_fn, field_fn, grad_fn = parts
    occ = refresh_occ(cfg, state, field_fn, occ_draws, mesh, refresh)
    if mesh is None:
        loss, (_, c_fi), grads = loss_and_grads(loss_fn, state.params, batch,
                                                state.generator, occ)
    else:
        loss, (_, c_fi), grads = grad_fn(state.params, batch, state.generator, occ,
                                         n_rays=n_rays)
        if n_rays is None:
            batch = mesh.local_rows(batch)
    lr = lr_fn(state.iteration)
    with profiling.section("step.adam"):
        params, opt = optim.adam_update(grads, state.opt, state.params, lr.item(),
                                        lr_scale=make_lr_scale(cfg, state.params), rates=rates)
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


def _described(step: Callable, cfg: Config, mesh: Optional[meshlib.Mesh],
               indexed: Optional[bool]) -> Callable:
    """``step`` with what a chunk of it needs to know: its config, its mesh
    and whether it takes indices (True), draws its batch (False) or is
    given one (None, ``HOST_FEED``). Every step also takes ``rates`` and
    ``refresh`` (``_apply_batch``)."""
    step.cfg, step.mesh, step.indexed = cfg, mesh, indexed
    return step


def make_train_step(cfg: Config, table: RayTable, k_inv: torch.Tensor,
                    field_fn: Optional[render.FieldFn] = None, ndc_params=None,
                    mesh: Optional[meshlib.Mesh] = None,
                    ) -> Callable[[TrainState], Tuple[TrainState, Metrics]]:
    """``step(state) -> (state, metrics)`` over a batch of ``BATCH_RAY``
    pixels drawn uniformly with replacement. Under a ``mesh`` every rank
    draws the whole batch from its generator (the same on every rank) and
    computes its rows (``_apply_batch``)."""
    parts = _step_parts(cfg, k_inv, field_fn, ndc_params, mesh)

    def step(state: TrainState, **kw) -> Tuple[TrainState, Metrics]:
        with profiling.section("step", state.generator.device):
            with profiling.section("step.sample"):
                batch = table.sample(state.generator, cfg.batch_ray)
            return _apply_batch(cfg, parts, state, batch, **kw)

    return _described(step, cfg, mesh, indexed=False)


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

    def step(state: TrainState, batch: RayBatch, **kw) -> Tuple[TrainState, Metrics]:
        with profiling.section("step", state.generator.device):
            return _apply_batch(cfg, parts, state, batch,
                                n_rays=None if mesh is None else cfg.batch_ray, **kw)

    return _described(step, cfg, mesh, indexed=None)


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
             occ_draws=None, **kw) -> Tuple[TrainState, Metrics]:
        with profiling.section("step", state.generator.device):
            with profiling.section("step.sample"):
                batch = table.gather(idx)
            return _apply_batch(cfg, parts, state, batch, occ_draws, **kw)

    return _described(step, cfg, mesh, indexed=True)


# the fields of a chunk's metrics taken from its last step (the preview
# canvas's batch and the [ITER] line's first pixel), as the JAX package's
LAST_STEP_FIELDS = ("c_true0", "c_fine0", "rows", "cols", "rgb", "pic")


def chunk_rates(cfg: Config, state: TrainState, unroll: int,
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rates (unroll, n_leaves + 2), lrs (unroll,))``, float32 on the host:
    Adam's scalars for the next ``unroll`` steps from ``state``
    (``optim.adam_rates``) and their learning rates (the schedule's)."""
    lr_fn = optim.make_lr_fn(cfg)
    scale = make_lr_scale(cfg, state.params)
    n = len(optim.leaves(state.params))
    lrs = torch.stack([lr_fn(state.iteration + k) for k in range(unroll)])
    rates = torch.tensor([optim.adam_rates(state.opt.count + 1 + k, float(lrs[k]), n, scale)
                          for k in range(unroll)], dtype=torch.float32)
    return rates, lrs


def graphs_take(step_fn: Callable, device: torch.device) -> bool:
    """Whether a chunk of ``step_fn`` replays CUDA graphs on ``device``: on
    the card, without a mesh or under one whose data group's collectives a
    graph can record (NCCL, ``distributed.captures``). On the CPU, and on
    the card under gloo, which copies its collectives through the host, the
    chunk is a host loop of steps. The backend decides, before any work."""
    mesh = step_fn.mesh
    return torch.device(device).type == "cuda" and (mesh is None or dist.captures(mesh.data))


class ChunkedStep:
    """``unroll`` steps of ``step_fn`` a call, the counterpart of the JAX
    package's scan-fused chunks: ``chunk(state) -> (state, metrics)``, or
    with an indexed step ``chunk(state, idx)`` over an ``(unroll, B)`` index
    chunk. ``loss`` and ``lr`` are stacked ``(unroll,)`` (``loss`` on the
    device, ``lr`` on the host) and the ``LAST_STEP_FIELDS`` are the last
    step's. Each step reads its own row of ``chunk_rates``.

    On the CPU the steps run one after another (the plain version); tests
    may pass ``occ_draws``, one ``refresh_occ`` draw (or None) a step. On the
    card the chunk replays step graphs (``graphs.StepGraphs``), which take
    the state's tensors as their own and update them in place: the state
    passed in is spent, as the JAX package donates it; under a mesh, each
    rank its own graphs, which hold the step's collectives (NCCL). Under a
    mesh over gloo the steps run one after another on the card too
    (``graphs_take``). A capture or replay error raises."""

    def __init__(self, step_fn: Callable, unroll: int):
        if step_fn.indexed is None:
            raise ValueError("a chunk draws or indexes its batches: a host-fed step "
                             "(HOST_FEED) runs one step per call")
        self.step_fn, self.unroll = step_fn, unroll
        self.graphs = None   # graphs.StepGraphs, made at the first call on the card

    def __call__(self, state: TrainState, idx: Optional[torch.Tensor] = None,
                 occ_draws=None) -> Tuple[TrainState, Metrics]:
        if (idx is not None) != bool(self.step_fn.indexed):
            raise ValueError("an indexed step's chunk takes an (unroll, B) index chunk, "
                             "and only it")
        if idx is not None and idx.shape[0] != self.unroll:
            raise ValueError(f"index chunk of {idx.shape[0]} rows for {self.unroll} steps")
        with profiling.span("chunk"):
            return self._chunk(state, idx, occ_draws)

    def _chunk(self, state: TrainState, idx: Optional[torch.Tensor], occ_draws,
               ) -> Tuple[TrainState, Metrics]:
        with profiling.span("chunk.rates"):
            rates, lrs = chunk_rates(self.step_fn.cfg, state, self.unroll)
        if graphs_take(self.step_fn, state.generator.device):
            if occ_draws is not None:
                raise ValueError("occ_draws is a test hook of the plain chunk (the CPU)")
            if self.graphs is None:
                from tinynerf_torch.graphs import StepGraphs
                self.graphs = StepGraphs(self.step_fn, self.unroll)
            return self.graphs(state, rates, lrs, idx)
        losses = []
        rates = rates.to(state.generator.device)
        for k in range(self.unroll):
            kw = dict(rates=rates[k])
            if occ_draws is not None:
                kw["occ_draws"] = occ_draws[k]
            args = (state,) if idx is None else (state, idx[k])
            state, metrics = self.step_fn(*args, **kw)
            losses.append(metrics["loss"])
        return state, {"loss": torch.stack(losses), "lr": lrs,
                       **{f: metrics[f] for f in LAST_STEP_FIELDS}}


def make_chunked_step(step_fn: Callable, unroll: int) -> ChunkedStep:
    """``make_train_step``'s steps ``unroll`` at a time, keeping the whole
    stream of per-step metrics (``ChunkedStep``): the Runner's training
    loop (``tinynerf/train.py:515-533``)."""
    if step_fn.indexed:
        raise ValueError("an indexed step's chunk is make_chunked_indexed_step")
    return ChunkedStep(step_fn, unroll)


def make_chunked_indexed_step(step_fn: Callable, unroll: int) -> ChunkedStep:
    """``make_indexed_train_step``'s steps over an ``(unroll, B)`` index chunk
    (``ChunkedStep``): the val epoch (``tinynerf/train.py:495-512``)."""
    if not step_fn.indexed:
        raise ValueError("make_chunked_indexed_step takes make_indexed_train_step's step")
    return ChunkedStep(step_fn, unroll)


def make_multi_step(step_fn: Callable, unroll: int,
                    ) -> Callable[[TrainState], Tuple[TrainState, torch.Tensor]]:
    """``multi(state) -> (state, losses (unroll,))``: ``make_chunked_step``
    keeping only the losses (``tinynerf/train.py:481-492``), for benchmarks
    and headless training."""
    chunk = make_chunked_step(step_fn, unroll)

    def multi(state: TrainState, **kw) -> Tuple[TrainState, torch.Tensor]:
        state, metrics = chunk(state, **kw)
        return state, metrics["loss"]

    return multi
