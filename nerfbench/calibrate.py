"""The check's readings over many seeds, from which a cell's limits are set:

    python3 -m nerfbench.calibrate --workload <cell> --seeds 1,2,3 \
        --roles program,control,half_batch [--out file.jsonl]

Each role's numbers (``check.py``, every candidate, not only those a
cell's limits compare) against the float32 reference, a JSON line a seed:

- ``program``: the program's first steps through the window's own object
  (training; on several ranks for a cell of several), or the frames a run
  compares (a frame cell), at the cell's own size, without the window;
- ``control``: the reference computed at float8 (``precision.fp8``) in the
  program's place;
- ``half_batch``: the reference with half of each batch left out, the sum
  over the rest doubled (training);
- ``no_exchange``: the reference with a rank's share of each batch alone,
  as a data-parallel step without its all-reduce (training on ranks).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import queue
import sys
import time

import numpy as np
import torch

from nerfbench import check, harness, scene as scenelib
from nerfbench.cells import render as render_cell, train as train_cell
from nerfbench.reference import precision, train as reftrain

# the frames a window holds (38-39 of 0.78-0.79 s in BENCHMARK.json's 30 s),
# from which a run draws those it compares
FRAMES_IN_WINDOW = 38


def raw(side: dict, ref: dict) -> dict:
    """What the numbers were worked out from: each step's loss, and per
    leaf the gradient's and the change's gap of norms, norm of the
    difference and reference norm (``check.leaf_table``)."""
    return {"loss": [side["loss"], ref["loss"]],
            "grad": check.leaf_table(side, ref, "grad"),
            "step": check.leaf_table(side, ref, "step")}


def train_program(cell, seed, device: str, ranks: int = 1) -> dict:
    dev = harness.start(device)
    chunk, state, inputs = train_cell.build(cell, seed, dev, ranks)
    state, prog = train_cell.first_steps(chunk, state, inputs)
    del chunk, state
    train_cell.free(dev)
    ref = train_cell.reference_readings(cell, inputs, dev)
    numbers = check.train_numbers(prog, ref, getattr(inputs["module"], "LEAF_GROUPS", None))
    numbers["digest"] = prog["digest"]
    numbers["raw"] = raw(prog, ref)
    return numbers


def _program_ranks(rank, ranks, init, cell, seeds, device, results):
    from tinynerf_torch.parallel import distributed as pdist
    pdist.maybe_initialize(init, ranks, rank, device=device)
    try:
        for seed in seeds:
            results.put((seed, rank, train_program(cell, seed, device, ranks)))
    finally:
        pdist.shutdown()


def train_roles(cell, seed, roles, dev) -> dict:
    inputs = train_cell.make_inputs(cell, seed, dev)
    inputs.pop("params_tree")
    ref = train_cell.reference_readings(cell, inputs, dev)
    b, ranks = cell.ini["BATCH_RAY"], cell.traffic.get("ranks", 1)
    faults = {"control": dict(q=precision.fp8), "half_batch": dict(keep=b // 2, scale=2.0),
              "no_exchange": dict(keep=b // ranks)}
    out = {}
    for role in roles:
        side = train_cell.reference_readings(cell, inputs, dev, **faults[role])
        out[role] = dict(check.train_numbers(side, ref, getattr(inputs["module"], "LEAF_GROUPS",
                                                                None)), raw=raw(side, ref))
    return out


def frame_roles(cell, seed, roles, dev) -> dict:
    spec = cell.traffic["scene"]
    rng = np.random.default_rng(harness.sub_seed(seed, 4))
    picks = 1 + rng.choice(FRAMES_IN_WINDOW, size=cell.traffic["check_frames"], replace=False)
    path = scenelib.orbit(spec, cell.traffic["path_views"])
    poses = [path[i % len(path)] for i in sorted(picks)]
    out = {}
    if "program" in roles:
        frame_fn, params, _, module = render_cell.build(cell, seed, dev)
        frame_fn(params, path[0])
        frames = [frame_fn(params, p) for p in poses]
        host = {p: t.detach().cpu() for p, t in reftrain.leaves(params)}
        del frame_fn, params
        train_cell.free(dev)
    else:
        module = cell.reference()
        params = module.init_params(cell.ini, torch.Generator(device=dev).manual_seed(
            harness.sub_seed(seed, 3)), dev)
        host = {p: t.detach().cpu() for p, t in reftrain.leaves(params)}
    params = reftrain.tree({p: t.to(dev) for p, t in host.items()})
    n_march = render_cell.refrender.march_steps(cell.ini["OCC_RES"], cell.ini["OCC_EXTENT"],
                                                float(spec["far"] - spec["near"]))

    def render(q):
        return [reftrain.render_frame(module, cell.ini, params, p, spec["height"],
                                      spec["width"], scenelib.focal_of(spec), n_march, q=q,
                                      device=dev) for p in poses]

    refs = render(precision.fp32)
    if "program" in roles:
        out["program"] = check.frame_numbers(frames, refs)
    if "control" in roles:
        out["control"] = check.frame_numbers(render(precision.fp8), refs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m nerfbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--roles", default="program,control")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    roles = args.roles.split(",")
    dev = harness.start("cuda" if torch.cuda.is_available() else "cpu")
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()

    kind, ranks = cell.traffic["kind"], cell.traffic.get("ranks", 1)
    if kind == "train" and "program" in roles and ranks > 1:
        ctx = multiprocessing.get_context("spawn")
        results = ctx.Queue()
        init = f"tcp://127.0.0.1:{train_cell._free_port()}"
        procs = [ctx.Process(target=_program_ranks,
                             args=(r, ranks, init, cell, seeds, dev.type, results))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        got = {}
        while len(got) < ranks * len(seeds) and any(p.is_alive() for p in procs):
            try:
                seed, rank, numbers = results.get(timeout=5)
            except queue.Empty:
                continue
            got[seed, rank] = numbers
            per = [got.get((seed, r)) for r in range(ranks)]
            if all(per):
                worst = check.worst([{k: v for k, v in n.items() if k not in ("digest", "raw")}
                                     for n in per])
                worst["rank_mismatch"] = float(sum(n["digest"] != per[0]["digest"] for n in per))
                emit({"workload": cell.name, "seed": seed, "role": "program", "numbers": worst})
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        results.join_thread()
        roles = [r for r in roles if r != "program"]
    for seed in seeds:
        t0 = time.time()
        if kind == "train":
            out = {}
            if "program" in roles:
                numbers = train_program(cell, seed, dev.type)
                numbers.pop("digest")
                out["program"] = numbers
            rest = [r for r in roles if r != "program"]
            if rest:
                out.update(train_roles(cell, seed, rest, dev))
        else:
            out = frame_roles(cell, seed, roles, dev)
        for role, numbers in out.items():
            extra = numbers.pop("raw", None)
            emit({"workload": cell.name, "seed": seed, "role": role, "numbers": numbers,
                  "raw": extra, "seconds": time.time() - t0})
        train_cell.free(dev)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
