"""Runs of one cell, each a process of its own, as a check makes them:

    python3 -m nerfbench.sweep --workload <cell> --seconds <s> --seeds 1,2,3 \
        [--sets 2] [--trace-seeds 4,5,6] [--out file.jsonl]

Each set runs every seed once with ``--trace 0``; then each trace seed
once with ``--trace 1``. Each run's record (its result line, exit code,
seconds and the end of its standard error) is a JSON line; the last line
is the summary: for each end-to-end metric and set the values, their
median and their spread, the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) over the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

RUN_TIMEOUT_S = 1300


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "nerfbench", "--workload", workload, "--seed", str(seed),
           "--seconds", str(seconds), "--trace", str(trace)]
    t0 = time.time()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out, err = (x.decode() if isinstance(x, bytes) else x for x in (out, err))
    line = None
    lines = [ln for ln in out.splitlines() if ln.strip()]
    if rc == 0 and lines:
        try:
            line = json.loads(lines[-1])
        except json.JSONDecodeError:
            line = None
    return {"seed": seed, "trace": trace, "rc": rc, "seconds": time.time() - t0,
            "line": line, "stderr_tail": err[-3000:]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m nerfbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    sink = open(args.out, "a") if args.out else None

    def emit(rec):
        text = json.dumps(rec)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    sets = []
    for k in range(args.sets):
        runs = []
        for seed in seeds:
            rec = dict(one(args.workload, seed, args.seconds, 0), set=k)
            emit(rec)
            runs.append(rec)
        sets.append(runs)
    for seed in [int(s) for s in args.trace_seeds.split(",") if s]:
        emit(one(args.workload, seed, args.seconds, 1))
    summary = {"workload": args.workload, "seconds": args.seconds, "sets": []}
    for runs in sets:
        good = [r["line"] for r in runs if r["line"]]
        names = sorted({m for line in good for m in line["metrics"]})
        summary["sets"].append({
            "correct": [bool(line["correct"]) for line in good], "failed_runs": len(runs) - len(good),
            "metrics": {m: {"values": [line["metrics"][m]["value"] for line in good],
                            "median": statistics.median(line["metrics"][m]["value"] for line in good),
                            "spread": spread([line["metrics"][m]["value"] for line in good])}
                        for m in names}})
    emit({"summary": summary})
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
