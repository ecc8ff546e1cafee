"""``python3 -m nerfbench``: see ``nerfbench/run.py``."""

import time

T_START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed place inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(_ROOT, "build", "nerfbench", _sub)
# keep libraries that can load JAX by themselves from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from nerfbench.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
