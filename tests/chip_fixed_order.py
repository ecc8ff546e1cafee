#!/usr/bin/env python3
"""Repeatability and cost of a tree's training steps, on one CUDA card.

    cd <tree> && python3 <this checkout>/tests/chip_fixed_order.py [label] [--diag]

It imports ``chip_smoke`` and ``tinynerf_torch`` from the current directory,
so that one call on one card can run a parent tree (unpacked with ``git
archive``) and the change in turns (parent, change, change, parent). For
each of ``chip_smoke.py`` phase 30's six training paths (``graph_paths``: lego
fp32, lego_occ, lego_grid, lego_prop, unbounded360-mlp, the flagship), from
one seeded state:

- two runs of ``2 GRAPH_K`` eager steps (the tensor-rate step, as a chunk
  takes it): whether they end bit for bit equal (losses and state), and the
  largest relative difference of their losses;
- with ``--diag``, the same pair under
  ``torch.use_deterministic_algorithms(True, warn_only=True)``: the
  operations PyTorch warns about (those with no deterministic form on the
  card), and whether the pair then repeats;
- the graphed step's ms (host clock around three synchronised chunks of
  ``GRAPH_K`` after two, the first of which captures), for the paths in
  ``TIMED``.

The last line is one JSON object of it all, with the label and the card's
name and power limit. Needs a CUDA card and nvcc; imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

# the paths whose graphed step is timed (the resampler's and the grid's gathers)
TIMED = ("lego", "lego_occ", "unbounded360_mlp", "lego_hybrid")
TIMED_CHUNKS = 3


def eager_pair(cs, step, cfg, s0, dev):
    """Two runs of 2 GRAPH_K eager steps from ``s0``: (bit-identical, the
    losses' largest relative difference)."""
    import torch
    from tinynerf_torch import train
    n = 2 * cs.GRAPH_K

    def run():
        st = cs.clone_state(s0)
        rates = train.chunk_rates(cfg, st, n)[0].to(dev)
        losses = []
        for k in range(n):
            st, m = step(st, rates=rates[k])
            losses.append(m["loss"])
        return st, torch.stack(losses)

    (a, la), (b, lb) = run(), run()
    torch.cuda.synchronize()
    same = bool(torch.equal(la, lb)) and all(
        torch.equal(x, y) for x, y in zip(cs.state_tensors(a), cs.state_tensors(b)))
    return same, float(((la - lb).abs() / lb.abs()).max())


def graphed_ms(cs, step, s0) -> list:
    """ms/step of TIMED_CHUNKS graphed chunks of GRAPH_K, each alone."""
    import torch
    from tinynerf_torch import train
    chunk = train.make_chunked_step(step, cs.GRAPH_K)
    g = cs.clone_state(s0)
    for _ in range(2):
        g, _ = chunk(g)
    out = []
    for _ in range(TIMED_CHUNKS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g, _ = chunk(g)
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / cs.GRAPH_K)
    return out


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    label = args[0] if args else os.getcwd()
    diag = "--diag" in sys.argv
    sys.path.insert(0, os.getcwd())
    import torch
    import chip_smoke as cs
    from tinynerf_torch import train
    from tinynerf_torch.kernels import build
    from tinynerf_torch.runner import Runner
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(label, torch.__version__, torch.version.cuda, card.strip(), flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda:0")
    out = {"label": label, "card": card.strip(), "paths": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name, cfg, scene in cs.graph_paths(tmp):
            runner = Runner(cfg, device="cuda", scene=scene)
            step = train.make_train_step(cfg, runner.train_table, runner.k_inv)
            s0 = cs.clone_state(runner.state)
            del runner
            rec = {}
            rec["eager_repeats"], rec["eager_loss_max_rel"] = eager_pair(cs, step, cfg, s0, dev)
            if diag:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    torch.use_deterministic_algorithms(True, warn_only=True)
                    try:
                        same, rel = eager_pair(cs, step, cfg, s0, dev)
                    finally:
                        torch.use_deterministic_algorithms(False)
                rec["deterministic_mode"] = {
                    "repeats": same, "loss_max_rel": rel,
                    "warned": sorted({str(w.message).split(".")[0][:160] for w in caught})}
            if name in TIMED:
                rec["graphed_ms"] = graphed_ms(cs, step, s0)
            print(name, json.dumps(rec), flush=True)
            out["paths"][name] = rec
            del s0, step
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
