"""``chip_smoke.py``'s phase 32 alone, on the card: ``GRID_LOOKUP = gather``
on lego_grid with ``GRID_PALLAS`` (bf16 and fp32) and on the flagship, and the
reference state-dict bridge, without the whole smoke test.

    python3 tests/chip_gather_phases.py

Builds the kernels, then runs ``chip_smoke.gather_phases`` and prints its
numbers as one JSON line.
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
          subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    build.build_all()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out = cs.gather_phases(tmp)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
