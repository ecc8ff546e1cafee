"""Processes and collectives of a job over several ranks, one card each.

Counterpart of ``tinynerf/parallel/distributed.py``. JAX drives every local
device from one process; PyTorch's idiom is one process per card, which the
port follows:

- ``maybe_initialize`` joins the job a launcher describes: ``torchrun``'s
  variables (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
  ``LOCAL_RANK``), or the JAX package's three (``COORDINATOR_ADDRESS`` as
  ``host:port``, ``NUM_PROCESSES``, ``PROCESS_ID``). ``NUM_PROCESSES=1``
  without a coordinator is a single process, as it is there.
- ``spawn`` starts a job of its own: n ranks through
  ``torch.multiprocessing``, meeting at a file under a temporary directory
  (the CLI's ``MESH_SHAPE = n`` outside a job).
- NCCL where each rank has a card of its own, gloo on the CPU. More NCCL
  ranks than cards is refused by name (``check_ranks_fit``); a caller may
  pass ``backend="gloo"`` and one ``device_index`` to put several ranks on
  one card. Nothing switches backend or device on its own.
- Each rank selects its card (``torch.cuda.set_device``) before its first
  kernel is built or launched: the kernels' C entries launch on the current
  device.

The collectives here (``all_reduce``, ``all_gather``, ``broadcast``) take a
tensor on the CPU or on a card under either backend: gloo's run on a host
copy of a card's tensor and NCCL's on a card copy of a host tensor, so that
one code serves both. A group of one
rank makes them identities. Every rank of the group must call each of them,
in the same order.

Under NCCL a card's tensor stays on the card: ``all_reduce``, ``all_gather``
(one ``all_gather_into_tensor``) and ``gather_rows`` copy nothing through the
host and read no value there, so a CUDA graph can record them
(``captures``; ``graphs.py``). Gloo's copy through the host and cannot be
recorded.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import os
import tempfile
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

# a group handle of these functions: a ProcessGroup, None for the world, or
# SELF, the group of this rank alone (on which every collective is the identity)
Group = Optional[Any]
SELF = "self"

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    return int(raw) if raw not in (None, "") else None


def check_ranks_fit(backend: str, local_rank: int, n_cards: int) -> None:
    """NCCL needs a card for each rank of a machine: refuse, by name, a
    local rank without one."""
    if backend == "nccl" and local_rank >= n_cards:
        raise ValueError(
            f"NCCL rank {local_rank} of this machine has no card of its own: the machine "
            f"has {n_cards}; run at most {n_cards} ranks a machine, or pass "
            "backend='gloo' to put several ranks on one card")


def _job_from_env() -> Optional[dict]:
    """The job a launcher describes in the environment, ``{"init_method",
    "world_size", "rank", "local_rank"}``, or None outside one (and for
    ``NUM_PROCESSES=1`` without a coordinator)."""
    coordinator = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator:
        world, rank = _env_int("NUM_PROCESSES"), _env_int("PROCESS_ID")
        if world is None or rank is None:
            raise ValueError("COORDINATOR_ADDRESS needs NUM_PROCESSES and PROCESS_ID")
        return {"init_method": f"tcp://{coordinator}", "world_size": world, "rank": rank,
                "local_rank": _env_int("LOCAL_RANK")}
    if os.environ.get("MASTER_ADDR") and _env_int("WORLD_SIZE") is not None:
        world = _env_int("WORLD_SIZE")
        if world <= 1:
            return None
        return {"init_method": "env://", "world_size": world, "rank": _env_int("RANK") or 0,
                "local_rank": _env_int("LOCAL_RANK")}
    return None


def maybe_initialize(init_method: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     device: str = "cuda", backend: Optional[str] = None,
                     device_index: Optional[int] = None) -> bool:
    """Join the job if one is configured (the arguments, else the
    environment: ``_job_from_env``); True when more than one rank runs
    afterwards. Idempotent.

    ``device="cuda"``: the rank's card is ``device_index`` (default its
    local rank: ``LOCAL_RANK``, else its rank) and the backend NCCL unless
    ``backend`` says otherwise; ``device="cpu"``: gloo."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if init_method is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_method needs num_processes and process_id")
        job = {"init_method": init_method, "world_size": num_processes, "rank": process_id,
               "local_rank": None}
    else:
        job = _job_from_env()
        if job is None:
            return False
    rank = job["rank"]
    local = rank if job["local_rank"] is None else job["local_rank"]
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is "
                               "False; pass device='cpu' to run the ranks on the CPU")
        n_cards = torch.cuda.device_count()
        check_ranks_fit(backend, local, n_cards)
        index = local if device_index is None else device_index
        if index >= n_cards:
            raise ValueError(f"rank {rank} asks for card {index}; the machine has {n_cards}")
        torch.cuda.set_device(index)
    elif backend == "nccl":
        raise ValueError("NCCL runs on cards; ranks on the CPU take backend='gloo'")
    dist.init_process_group(backend, init_method=job["init_method"],
                            world_size=job["world_size"], rank=rank)
    return dist.get_world_size() > 1


def shutdown() -> None:
    """Leave the job (no-op outside one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size(group: Group = None) -> int:
    if group is SELF or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def rank(group: Group = None) -> int:
    if group is SELF or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def process_info() -> dict:
    return {"process_index": rank(), "process_count": world_size(),
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "device": (f"cuda:{torch.cuda.current_device()}"
                       if dist.is_initialized() and dist.get_backend() == "nccl" else None)}


def is_main_process() -> bool:
    """True on the rank that writes artifacts (checkpoints, previews,
    frames, metric logs): rank 0, and every single-process run."""
    return rank() == 0


def is_multiprocess() -> bool:
    return world_size() > 1


def captures(group: Group = None) -> bool:
    """Whether a CUDA graph can record ``group``'s collectives: true under
    NCCL, which runs them on the card, and for a group of one rank, which
    has none; false under gloo, which copies through the host."""
    if world_size(group) == 1:
        return True
    return dist.get_backend(group) == "nccl"


def _comm_device(group: Group) -> torch.device:
    """Where ``group``'s backend takes tensors: gloo on the host, NCCL on
    this rank's card."""
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def all_reduce(t: torch.Tensor, op: str = "sum", group: Group = None) -> torch.Tensor:
    """``t`` reduced over ``group`` (``op``: sum, min or max), in place."""
    if world_size(group) == 1:
        return t
    dev = _comm_device(group)
    work = t if t.device == dev else t.to(dev)
    dist.all_reduce(work, _OPS[op], group=group)
    if work is not t:
        t.copy_(work)
    return t


def all_gather(t: torch.Tensor, group: Group = None) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on every rank), in the group's rank
    order, on ``t``'s device."""
    n = world_size(group)
    if n == 1:
        return [t]
    if t.is_cuda and dist.get_backend(group) == "nccl":
        src = t.contiguous()
        out = src.new_empty((n, *src.shape))
        dist.all_gather_into_tensor(out, src, group=group)
        return list(out.unbind(0))
    src = t.to(_comm_device(group)).contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def broadcast(t: torch.Tensor, src: int = 0, group: Group = None) -> torch.Tensor:
    """``t`` overwritten, in place, with global rank ``src``'s."""
    if world_size(group) == 1:
        return t
    dev = _comm_device(group)
    work = t if t.device == dev else t.to(dev)
    dist.broadcast(work, src, group=group)
    if work is not t:
        t.copy_(work)
    return t


def split_sizes(n: int, parts: int) -> List[int]:
    """Rows of each of ``parts`` contiguous spans of ``n`` rows, the first
    ``n % parts`` one longer (``torch.tensor_split``'s)."""
    return [n // parts + (1 if i < n % parts else 0) for i in range(parts)]


def gather_rows(local: torch.Tensor, sizes: Sequence[int], group: Group = None) -> torch.Tensor:
    """The rows of every rank, concatenated in rank order, where rank i
    holds ``sizes[i]`` of them (``local``, this rank's)."""
    if len(sizes) == 1:
        return local
    width = max(sizes)
    pad = width - local.shape[0]
    if pad:
        local = torch.cat([local, local.new_zeros((pad, *local.shape[1:]))])
    parts = all_gather(local, group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)])


def put_replicated(tree: Any, group: Group = None) -> Any:
    """Every tensor leaf of ``tree`` (through dicts, lists, tuples and
    dataclasses) overwritten in place with rank 0's, so that every rank
    holds the same state bit for bit. Returns ``tree``."""
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            put_replicated(getattr(tree, f.name), group)
    elif isinstance(tree, dict):
        for v in tree.values():
            put_replicated(v, group)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            put_replicated(v, group)
    elif isinstance(tree, torch.Tensor):
        broadcast(tree, 0, group)
    return tree


def barrier() -> None:
    """Every rank waits here for the others (no-op in a single process)."""
    if world_size() <= 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def to_host(x: torch.Tensor, group: Group = None):
    """A tensor split over ``group``'s ranks along axis 0 (each rank's
    contiguous rows, in rank order) -> the whole array as numpy, on every
    rank. Every rank of the group must call it."""
    if world_size(group) == 1:
        return x.detach().cpu().numpy()
    counts = all_gather(torch.tensor([x.shape[0]], device=x.device), group)
    return gather_rows(x.detach(), [int(c) for c in counts], group).cpu().numpy()


def params_digest(tree: Any) -> str:
    """sha256 of every leaf's bytes, keys sorted at every level: equal on
    two ranks exactly when their params are equal bit for bit."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())

    walk(tree)
    return h.hexdigest()


def _target(spec: str):
    module, _, name = spec.partition(":")
    return getattr(importlib.import_module(module), name)


def _rank_entry(rank: int, n: int, init_method: str, device: str, backend: Optional[str],
                device_index: Optional[int], target: str, args: tuple) -> None:
    if torch.device(device).type == "cpu" and not os.environ.get("OMP_NUM_THREADS"):
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    maybe_initialize(init_method, n, rank, device=device, backend=backend,
                     device_index=device_index)
    try:
        _target(target)(*args)
    finally:
        shutdown()


def spawn(target: str, n: int, device: str, args: tuple = (), *,
          backend: Optional[str] = None, device_index: Optional[int] = None) -> None:
    """Run ``module:function(*args)`` in ``n`` new ranks of one job
    (``torch.multiprocessing``, one process each), and wait for them; a
    rank that raises makes this raise. The ranks meet at a file in a new
    temporary directory. On the card each rank takes card ``rank`` unless
    ``device_index`` names one for all, which needs ``backend="gloo"``;
    fewer cards than ranks is refused by name, and the CPU never stands in
    for a card."""
    import torch.multiprocessing as mp

    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is "
                               "False; pass device='cpu' to run the ranks on the CPU")
        if device_index is None:
            check_ranks_fit(backend or "nccl", n - 1, torch.cuda.device_count())
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "rendezvous")
        mp.spawn(_rank_entry, args=(n, init, device, backend, device_index, target, args),
                 nprocs=n, join=True)
