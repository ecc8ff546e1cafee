"""The VALIDATION.md convergence protocol against the port, in one command.

The port's counterpart of ``tools/validate.py``, with its ``BASE`` INI, its
``FAMILY`` table and its flags. It writes the capture with the port's scene
maker (``python -m tinynerf_torch.tools.make_synthetic_scene``, no Pillow)
where ``--scene`` does not exist, writes the protocol INI of a family
(``BASE``, then the family's keys, then ``--extra``, later keys winning) to
``<out>/val.ini``, runs the port's CLI on it (``python -m tinynerf_torch
--conf <out>/val.ini``: train, then render the test split and score it), on
the card unless ``--cpu`` (which passes ``--device cpu``), and prints one
JSON row: ``family``, ``iters``, ``psnr_db``, ``ssim``,
``sustained_rays_per_sec`` (the median of the ``[RAYS/S]`` readings after
the first window), ``wall_s`` and ``ini``. The CLI's log is kept at
``<out>/train.log``.

Families (--family): ``reference``, ``proposal``, ``full`` (the default:
PROPOSAL + OCC_GRID + WHITE_BKGD on the 8x256 MLP), ``grid``, ``hybrid``,
``levels``, ``u360``, ``u360_occ``, ``u360_nowarp``, ``u360_bigbox`` (pair
with ``--scene-format 360``), ``llff_hybrid``, ``llff_full`` (pair with
``--scene-format llff``); ``tools/validate.py`` says what each runs.

Usage:
    python -m tinynerf_torch.tools.validate --out <dir> --iters 20000
    python -m tinynerf_torch.tools.validate --family grid --iters 20000 --extra GRID_RES=128
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

# the directory that holds the tinynerf_torch package, for the subprocesses
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BASE = """[spheres]
IMG_DIR = {scene}/
RESULTS_PATH = {out}/results/
CKPT_PATH = {out}/ckpt/
LOG_DIR = {out}/runs/
TOTAL_ITER = {iters}
BATCH_RAY = {batch}
LEARNING = 5e-4
N_COARSE = 64
N_FINE = {n_fine}
DATA_TYPE = sync
STEP = {step}
DECAY_END = 200000
SCHED = EXP
CONTINUE = False
PRECISION = bf16
"""

FAMILY = {
    "reference": "",
    "proposal": "PROPOSAL = True\n",
    "full": ("PROPOSAL = True\nWHITE_BKGD = True\nOCC_GRID = True\n"
             "OCC_RES = 64\nOCC_EXTENT = 1.5\nOCC_THRESH = 0.01\n"
             "OCC_UPDATE_EVERY = 256\nOCC_SUBSET = 0.125\n"),
    "grid": ("PROPOSAL = True\nWHITE_BKGD = True\nOCC_GRID = True\n"
             "OCC_RES = 64\nOCC_EXTENT = 1.5\nOCC_THRESH = 0.01\n"
             "OCC_UPDATE_EVERY = 256\nOCC_SUBSET = 0.125\n"
             "FINE_FIELD = grid\nGRID_EXTENT = 1.5\nGRID_RES = 256\n"
             "GRID_COMP_DENSITY = 64\nGRID_COMP_APP = 64\n"
             "GRID_DECODER_WIDTH = 128\nGRID_LR_MULT = 20\nGRID_TV = 0.1\n"),
}
# flagship since late round 3: the grid stack + the NGP-style density MLP
# (GRID_HYBRID) on BOTH fields — measured strictly dominant over the plain
# CP sum and the MLP fine net, and the proposal-side MLP adds +1.16 dB
# @20k / +2.10 dB @100k at <=1.5% step cost (VALIDATION.md)
FAMILY["hybrid"] = (FAMILY["grid"] + "GRID_HYBRID = True\n"
                    + "PROP_GRID_HYBRID = True\n"
                    # res 384 > 256 (+1.18 dB @20k, +0.61 @100k) > 512
                    # at ~1-2% step cost (VALIDATION.md queue 10)
                    + "GRID_RES = 384\n")

# the convergence-quality preset (conf/lego_levels.ini): flagship + the
# UNFOLDED GRID_LEVELS=2 pyramid at 384+192. The non-nested lattices are
# load-bearing: summing two independently-interpolated piecewise-linear
# levels yields ~576 distinct breakpoints/axis, and that effective
# refinement is where most of the preset's converged +0.39 dB lives —
# the folded nested variant (385+193, function-identical to its unfolded
# form) soaks to only 40.88, flagship-level (VALIDATION.md round 5).
FAMILY["levels"] = FAMILY["hybrid"] + "GRID_LEVELS = 2\n"

# --- unbounded-360 protocol (VERDICT r3 #2): pair with --scene-format 360.
# Hybrid-grid stack WITHOUT the occupancy grid (its bounded extent boxes
# the origin, not this scene's unbounded content) on the outward ring
# capture: near spheres at r~2 through an environment shell at r=60.
# u360 = full CONTRACT+LINDISP warp, grid spanning the radius-2
# contraction ball; u360_nowarp ablates ONLY the warp (same capacity —
# the bounded field clamps past r=2); u360_bigbox is the naive "make the
# box huge" fix (linear march + extent 80, resolution/unit collapses).
_U360_BASE = ("PROPOSAL = True\nFINE_FIELD = grid\nGRID_HYBRID = True\n"
              "PROP_GRID_HYBRID = True\nGRID_RES = 384\n"
              "GRID_COMP_DENSITY = 64\nGRID_COMP_APP = 64\n"
              "GRID_DECODER_WIDTH = 128\nGRID_LR_MULT = 20\nGRID_TV = 0.1\n"
              # NEAR sets the lindisp anchor: it must sit just inside the
              # nearest content (~1.7 world units on the generated capture)
              # or disparity spacing wastes most of the march in empty
              # space (near=0.1 put HALF the samples inside r<0.2 —
              # measured -1.3 dB on the v1 capture)
              "STRATIFIED = True\nNEAR = 1.0\nFAR = 80\n")
FAMILY["u360"] = (_U360_BASE
                  + "CONTRACT = True\nLINDISP = True\nGRID_EXTENT = 2.0\n")
# + contracted occupancy grid (cells in the radius-2 ball, disparity march)
FAMILY["u360_occ"] = (FAMILY["u360"]
                      + "OCC_GRID = True\nOCC_RES = 64\nWHITE_BKGD = True\n"
                      + "OCC_UPDATE_EVERY = 256\nOCC_SUBSET = 0.125\n")
FAMILY["u360_nowarp"] = _U360_BASE + "GRID_EXTENT = 2.0\n"
FAMILY["u360_bigbox"] = _U360_BASE + "GRID_EXTENT = 80.0\n"

# --- forward-facing (fern-style) protocol: pair with --scene-format llff.
# The reference's second headline scene is LLFF fern (conf/fern.ini):
# poses_bounds.npy ingest, per-ray near/far, raw-unit marching, identical
# train/val/test splits (Q10 — test PSNR is training-view PSNR, exactly
# the reference's evidence regime). llff_hybrid runs the flagship family
# on that path; llff_full is the MLP-fine stack control (round 1 only
# ever measured the plain MLP at 80x80/4k). The generated capture's
# spheres sit inside r~1.4, so the sync families' extent-1.5 grids and
# occ box carry over unchanged; WHITE_BKGD matches the white-composited
# LLFF pngs.
FAMILY["llff_hybrid"] = FAMILY["hybrid"] + "DATA_TYPE = llff\n"
FAMILY["llff_full"] = FAMILY["full"] + "DATA_TYPE = llff\n"


def write_ini(args: argparse.Namespace) -> str:
    """Merge ``BASE`` <- the family <- ``--extra`` as key/value pairs (later
    wins, so an override never repeats a key: configparser is strict), write
    ``<out>/val.ini`` and return its path."""
    pairs: dict = {}
    base = BASE.format(scene=args.scene.rstrip("/"), out=args.out,
                       iters=args.iters, batch=args.batch,
                       n_fine=args.n_fine, step=min(2000, args.iters))
    for line in (base + FAMILY[args.family]).splitlines():
        if "=" in line:
            key, _, value = line.partition("=")
            pairs[key.strip()] = value.strip()
    for kv in args.extra:
        key, _, value = kv.partition("=")
        pairs[key.strip()] = value.strip()
    ini = "[spheres]\n" + "".join(f"{k} = {v}\n" for k, v in pairs.items())
    os.makedirs(args.out, exist_ok=True)
    ini_path = os.path.join(args.out, "val.ini")
    with open(ini_path, "w") as fh:
        fh.write(ini)
    return ini_path


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="The validate protocol on the port.")
    parser.add_argument("--family", choices=sorted(FAMILY), default="full")
    parser.add_argument("--out", type=str,
                        default=os.path.join(tempfile.gettempdir(), "tinynerf_val"))
    parser.add_argument("--scene", type=str,
                        default=os.path.join(tempfile.gettempdir(), "spheres100"),
                        help="capture dir (generated if absent)")
    parser.add_argument("--hw", type=int, default=100,
                        help="capture resolution (protocol: 100)")
    parser.add_argument("--views", type=int, default=100,
                        help="training views (protocol: 100)")
    parser.add_argument("--iters", type=int, default=20000)
    parser.add_argument("--batch", type=int, default=1024)
    parser.add_argument("--n-fine", type=int, default=128)
    parser.add_argument("--extra", action="append", default=[],
                        metavar="KEY=VALUE", help="extra INI keys (repeat)")
    parser.add_argument("--scene-format", default="sync",
                        choices=["sync", "360", "llff", "texture"],
                        help="capture generator: inward spheres (protocol "
                             "default), the outward unbounded-360 ring "
                             "(u360* families), the forward-facing LLFF "
                             "layout (llff_* families), or the "
                             "high-frequency texture/specular/thin-rod "
                             "scene (pair with the sync families)")
    parser.add_argument("--cpu", action="store_true",
                        help="run the CLI on the CPU (--device cpu; smoke runs only)")
    args = parser.parse_args(argv)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    if not os.path.isdir(args.scene):
        subprocess.run(
            [sys.executable, "-m", "tinynerf_torch.tools.make_synthetic_scene",
             args.scene, "--hw", str(args.hw), "--views", str(args.views),
             "--format", args.scene_format],
            check=True, env=env)
    ini_path = write_ini(args)

    cmd = [sys.executable, "-m", "tinynerf_torch", "--conf", ini_path,
           "--device", "cpu" if args.cpu else "cuda"]
    t0 = time.time()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    rays = []
    psnr = ssim = None
    log_path = os.path.join(args.out, "train.log")
    with open(log_path, "w") as logf:
        for line in proc.stdout:
            logf.write(line)
            sys.stderr.write(line)
            m = re.search(r"\[RAYS/S\] ([\d,]+)", line)
            if m:
                rays.append(float(m.group(1).replace(",", "")))
            m = re.search(r"Test PSNR: ([\d.]+) dB .*\(SSIM ([\d.]+)\)", line)
            if m:
                psnr, ssim = float(m.group(1)), float(m.group(2))
    rc = proc.wait()
    if rc != 0:
        sys.exit(f"training run failed (rc {rc}); log: {log_path}")

    # sustained = median of the per-STEP meter after the first window (which
    # carries the kernels' first launches)
    sustained = sorted(rays[1:])[len(rays[1:]) // 2] if len(rays) > 1 else (
        rays[0] if rays else None)
    print(json.dumps({
        "family": args.family, "iters": args.iters,
        "psnr_db": psnr, "ssim": ssim,
        "sustained_rays_per_sec": sustained,
        "wall_s": round(time.time() - t0, 1),
        "ini": ini_path}))


if __name__ == "__main__":
    main()
