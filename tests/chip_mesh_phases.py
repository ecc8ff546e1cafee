"""``chip_smoke.py``'s phase 31 alone, on a machine with two cards or more:
phase 30's graphed chunks and frames under a mesh of NCCL ranks, one card
each, without the whole smoke test.

    python3 tests/chip_mesh_phases.py

Builds the kernels, then runs ``chip_smoke.mesh_phases``: N = 4 ranks where
the machine has four cards, else 2 (one card: it prints that there is no
NCCL job and exits 0). Prints its numbers, then one JSON line of them.
About two and a half minutes on four H100s, the build included. Under
gloo (several ranks on one card, or the CPU) a chunk is a host loop of
steps and a frame a host loop of chunks; this script needs NCCL.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, REPO)
    import torch
    import chip_smoke as cs
    from tinynerf_torch.kernels import build
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0),
          torch.cuda.device_count(),
          subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = cs.mesh_phases(tmp)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
