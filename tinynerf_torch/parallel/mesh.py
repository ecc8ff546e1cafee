"""Ray data parallelism over the ranks of a job.

Counterpart of ``tinynerf/parallel/mesh.py``. There a ``jax.sharding.Mesh``
spans the devices and XLA partitions the step, inserting the gradient
``psum``; here each rank is one process with one card, and the mesh is the
rank's place in the job:

- ``Mesh``: ``n_data x n_sample`` ranks, rank r at data index
  ``r // n_sample`` and sample index ``r % n_sample`` (``make_mesh_2d``'s
  row-major device grid). Its ``data`` group holds the ranks that share
  r's sample index (they split a ray batch), its ``sample`` group the ranks
  that share r's data index (they split a frame's fine samples,
  ``parallel/sample_shard.py``). Without ``SAMPLE_SHARD``, ``data`` is the
  whole job.
- ``local_rows`` is the counterpart of ``batch_sharding``: the rank's
  contiguous span of a ray axis (the first spans one row longer where the
  rows do not divide), and ``gather_rows`` assembles every span in rank
  order.
- ``make_grad_fn`` is ``make_shardmap_grad_fn``'s: the loss and its
  gradient on the rank's rays, then one ``all_reduce(SUM)`` over the data
  group. The loss is a sum over rays, so the sum of the ranks' gradients is
  the one-rank gradient; ``DistributedDataParallel`` would divide by the
  world size instead.
- ``sharded_render_chunk`` splits a chunk's rays over the data group and
  gathers the colors back.
- ``replicate_state`` gives every rank rank 0's state bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as tdist

from tinynerf_torch.parallel import distributed as dist


@dataclasses.dataclass
class Mesh:
    """This rank's place in an ``n_data x n_sample`` job."""

    n_data: int
    n_sample: int
    rank: int
    data: dist.Group      # the ranks of this rank's sample index
    sample: dist.Group    # the ranks of this rank's data index

    @property
    def size(self) -> int:
        return self.n_data * self.n_sample

    @property
    def data_index(self) -> int:
        return self.rank // self.n_sample

    @property
    def sample_index(self) -> int:
        return self.rank % self.n_sample

    def span(self, n: int) -> slice:
        """This rank's rows of a ray axis of ``n`` rows."""
        sizes = dist.split_sizes(n, self.n_data)
        start = sum(sizes[:self.data_index])
        return slice(start, start + sizes[self.data_index])

    def local_rows(self, x: Any) -> Any:
        """This rank's rows of ``x``: a tensor or array, or a tuple of them
        (a ``RayBatch``) split alike."""
        if isinstance(x, tuple):
            parts = [self.local_rows(v) for v in x]
            return type(x)(*parts) if hasattr(x, "_fields") else tuple(parts)
        return x[self.span(x.shape[0])]

    def gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The ``n`` rows of which every rank of the data group holds its
        ``span``, in order, on every rank."""
        return dist.gather_rows(local, dist.split_sizes(n, self.n_data), self.data)

    def sum_over_data(self, t: torch.Tensor) -> torch.Tensor:
        return dist.all_reduce(t, "sum", self.data)


def make_mesh_2d(n_data: int, n_sample: int) -> Mesh:
    """``n_data x n_sample`` mesh over every rank of the job: rays over
    ``data``, a frame's fine samples over ``sample`` (``SAMPLE_SHARD``)."""
    n = n_data * n_sample
    world = dist.world_size()
    if n != world:
        raise ValueError(f"a {n_data} x {n_sample} mesh needs {n} ranks; the job has {world}")
    rank = dist.rank()
    data, sample = dist.SELF, dist.SELF
    # every rank creates every group, in one order
    if n_sample == 1:
        data = None
    elif n_data == 1:
        sample = None
    else:
        for s in range(n_sample):
            g = tdist.new_group([d * n_sample + s for d in range(n_data)])
            if rank % n_sample == s:
                data = g
        for d in range(n_data):
            g = tdist.new_group([d * n_sample + s for s in range(n_sample)])
            if rank // n_sample == d:
                sample = g
    return Mesh(n_data=n_data, n_sample=n_sample, rank=rank, data=data, sample=sample)


def make_mesh() -> Mesh:
    """1-D mesh over the ray axis: every rank of the job."""
    return make_mesh_2d(dist.world_size(), 1)


def check_mesh(cfg, world: int) -> None:
    """Refuse, by name, a ``MESH_SHAPE`` other than the job's ``world`` size
    (unset or ``auto`` is the world size; 1 or less is one rank) and a
    ``SAMPLE_SHARD`` that does not divide a mesh of more than one rank
    (``tinynerf/parallel/mesh.py:125-127``)."""
    n = world if cfg.mesh_shape is None else max(cfg.mesh_shape, 1)
    if n != world:
        raise ValueError(
            f"MESH_SHAPE={cfg.mesh_shape} asks for {n} ranks but this job has {world} (its "
            f"world size): run `python -m tinynerf_torch` outside a job, which starts them, "
            f"or `torchrun --nproc-per-node {n} -m tinynerf_torch`")
    ss = cfg.sample_shard or 0
    if n > 1 and ss > 1 and n % ss != 0:
        raise ValueError(f"SAMPLE_SHARD={ss} must divide the device count {n}")


def mesh_for_config(cfg) -> Optional[Mesh]:
    """The mesh a config asks for in this job; None on one rank.
    ``SAMPLE_SHARD > 1`` folds a sample axis into a 2-D mesh: the train
    step still splits only rays (over ``data``), while frames also spread
    their fine samples over ``sample``."""
    n = dist.world_size()
    check_mesh(cfg, n)
    if n <= 1:
        return None
    ss = cfg.sample_shard or 0
    if ss > 1:
        return make_mesh_2d(n // ss, ss)
    return make_mesh()


def replicate_state(state: Any) -> Any:
    """Rank 0's ``state`` (a ``TrainState``, or any tree of tensors) on
    every rank of the job, bit for bit, with the sampling generator's state
    too. Returns ``state``; no-op on one rank."""
    if dist.world_size() == 1:
        return state
    if not dataclasses.is_dataclass(state):
        return dist.put_replicated(state)
    for f in dataclasses.fields(state):
        value = getattr(state, f.name)
        if isinstance(value, torch.Generator):
            gstate = value.get_state()
            value.set_state(dist.broadcast(gstate, 0))
        else:
            dist.put_replicated(value)
    return state


def reduce_grads(mesh: Mesh, loss: torch.Tensor, grads: List[torch.Tensor]):
    """``(loss, grads)`` summed over the data group in one ``all_reduce``:
    the leaves flattened into one buffer with the loss."""
    flat = torch.cat([loss.reshape(1).to(torch.float32)]
                     + [g.reshape(-1).to(torch.float32) for g in grads])
    mesh.sum_over_data(flat)
    out, at = [], 1
    for g in grads:
        out.append(flat[at:at + g.numel()].view(g.shape).to(g.dtype))
        at += g.numel()
    return flat[0].to(loss.dtype), out


def sharded_render_chunk(render_fn: Callable, mesh: Mesh) -> Callable:
    """``render_fn(params, rows, cols, pose17) -> out`` (a tensor, or a
    tuple of them, each of a row a ray) wrapped so that each rank renders
    its rows of the chunk and every rank returns the whole chunk's (the
    frame path over the ranks)."""
    def wrapped(params, rows, cols, pose17):
        n = rows.shape[0]
        out = render_fn(params, *(mesh.local_rows(x) for x in (rows, cols, pose17)))
        if isinstance(out, tuple):
            return tuple(mesh.gather_rows(o, n) for o in out)
        return mesh.gather_rows(out, n)

    return wrapped


def make_grad_fn(loss_fn: Callable, mesh: Mesh, n_coarse: Optional[int] = None) -> Callable:
    """``grad_fn(params, batch, generator=None, occ=None, n_rays=None) ->
    (loss, (C_coarse, C_fine), grads)``, the rank's share of a step: the
    loss and gradient of ``loss_fn`` (``train.make_loss_fn``'s) on the
    rank's rows of ``batch``, summed over the data group. The colors are
    the rank's rows'.

    ``batch`` is the whole batch, or with ``n_rays`` the rank's rows of a
    batch of ``n_rays`` (a host batch uploaded in part). With
    ``n_coarse`` (``STRATIFIED``) the coarse jitter of the whole batch is
    drawn from ``generator`` and the rank takes its rows, so that the rays
    see the one-rank step's jitter."""
    from tinynerf_torch import optim
    from tinynerf_torch.train import loss_and_grads

    def grad_fn(params, batch, generator=None, occ=None, n_rays: Optional[int] = None):
        n = batch.rows.shape[0] if n_rays is None else n_rays
        jitter = None
        if n_coarse is not None and generator is not None:
            jitter = mesh.local_rows(torch.rand((n, n_coarse), generator=generator,
                                                device=batch.rows.device))
        local = batch if n_rays is not None else mesh.local_rows(batch)
        loss, colors, grads = loss_and_grads(loss_fn, params, local, None, occ, jitter=jitter)
        flat = optim.leaves(grads)
        loss, flat = reduce_grads(mesh, loss, flat)
        return loss, colors, optim.unflatten_like(grads, flat)

    return grad_fn
