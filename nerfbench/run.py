"""One run of one cell:

    python3 -m nerfbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
It prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end
metrics; ``--trace 1``: its per-layer metrics, read from a traced span of a
few calls), ``device`` and, last, ``checks``, each number compared beside
its limit (also the last lines of standard error). It exits non-zero and
prints no result without enough cards, or where the process holds JAX or
the JAX package when the run is done.
"""

from __future__ import annotations

import argparse
import importlib
import json
import math
import re
import sys
import time
from types import SimpleNamespace
from typing import List, Optional

import torch

from nerfbench import check, counts, harness


def kind_module(kind: str):
    """The module that runs a traffic kind: ``nerfbench/cells/<kind>.py``,
    found by the traffic file's ``kind``."""
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", kind):
        raise ValueError(f"no traffic kind {kind!r}")
    return importlib.import_module(f"nerfbench.cells.{kind}")


def per_layer(cell: harness.Cell, out: dict) -> dict:
    """The cell's per-layer metrics from the traced span; a reader that
    finds nothing to read gives None and its metric is left out."""
    results = out["results"]
    # a rank whose trace lost kernel records (trace.py) reads nothing
    spans = [r["span"] for r in results if not r["span"].records_lost]
    if not spans:
        return {}
    run = SimpleNamespace(kind=cell.traffic["kind"], ini=cell.ini, traffic=cell.traffic,
                          field=cell.config["field"], model=cell.reference(), spans=spans,
                          calls=out["calls"], refreshes=out["refreshes"], chips=cell.chips,
                          counts=counts,
                          peak=counts.peaks(results[0]["device_kind"]))
    values = {}
    for m in cell.per_layer:
        value = harness.metric_reader(m["name"]).read(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    return values


def breakdown(results: List[dict]) -> dict:
    """The first rank's whose trace kept its records, else rank 0's."""
    span = next((r["span"] for r in results if not r["span"].records_lost),
                results[0]["span"])
    return {"device_ops": span.device_ops, "idle_gaps": span.idle_gaps}


def execute(cell: harness.Cell, seed: int, seconds: float, traced: bool, device: str,
            t_start: float, patch: Optional[str] = None) -> dict:
    """The result line's object, without the look for cards; under
    ``_numbers`` every number the check read, under ``_forbidden`` the
    forbidden modules the run's processes held."""
    out = kind_module(cell.traffic["kind"]).run(cell, seed, seconds, traced, device, t_start, patch)
    results = out["results"]
    numbers = out["numbers"]
    if traced:
        metrics = per_layer(cell, out)
    else:
        metrics = {m["name"]: {"value": out["values"][m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": results[0]["device_kind"], "count": len(results),
           "memory_peak_bytes": max(r["mem_peak"] for r in results)}
    if traced:
        spans = [r["span"] for r in results if not r["span"].records_lost] or [
            r["span"] for r in results]
        dev["busy_s"] = sum(s.busy_s for s in spans) / len(spans)
        dev["window_s"] = max(s.window_s for s in spans)
    line = {"correct": check.verdict(numbers, cell.limits) and out["failed"] == 0,
            "attempted": out["attempted"], "failed": out["failed"], "metrics": metrics,
            "device": dev}
    if traced:
        line["breakdown"] = breakdown(results)
    line["checks"] = check.lines(numbers, cell.limits)
    line["_forbidden"] = out["forbidden"]
    line["_numbers"] = numbers
    return line


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.time() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="python3 -m nerfbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"nerfbench: {args.workload} needs {cell.chips} CUDA card(s); this machine "
              f"has {n}", file=sys.stderr)
        return 2
    line = execute(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    found = sorted(set(line.pop("_forbidden")) | set(harness.forbidden_modules()))
    numbers = line.pop("_numbers")
    if found:
        print(f"nerfbench: the run loaded {', '.join(found)}, which the port must not use",
              file=sys.stderr)
        return 3
    print("numbers " + json.dumps({k: str(v) if not math.isfinite(v) else v
                                    for k, v in numbers.items()}), file=sys.stderr)
    for c in line["checks"].values():
        if c["value"] is not None and not math.isfinite(c["value"]):
            c["value"] = str(c["value"])     # JSON has no infinity
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
