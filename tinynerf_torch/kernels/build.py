"""Build a CUDA source of ``tinynerf_torch/csrc`` into a shared library with
``nvcc`` and load it with ``ctypes``.

Each source exposes a plain C interface, so it is compiled without PyTorch's
headers (seconds, not minutes). The library goes under ``build/tinynerf_torch/``
at the root of the checkout, named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source is rebuilt and an
unchanged one is reused. Nothing here runs at import time: a library is built
at the first call that launches its kernel, or by ``build_all``, which starts
one ``nvcc`` per source at once.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tinynerf_torch")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# per source: seconds the build took (0.0 when reused) and the ptxas report
build_log: Dict[str, Dict[str, object]] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or the toolkit's default
    install prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit")


def _ptxas_lines(text: str) -> List[str]:
    return [ln.strip() for ln in text.splitlines()
            if "registers" in ln or "spill" in ln or "smem" in ln]


def _lib_path(source: str) -> str:
    """Where ``csrc/<source>`` builds to: named by a hash of the source, the
    shared headers and the flags."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, source)] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _build(sources: List[str]) -> None:
    """Compile every source whose library is missing, one ``nvcc`` process
    per source, all started together; record each one's seconds and ptxas
    report in ``build_log``. Call with ``_lock`` held."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    t0 = time.perf_counter()
    for source in sources:
        lib_path = _lib_path(source)
        if not os.path.isfile(lib_path):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC_DIR, source)]
            running[source] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed = []
    for source, (tmp, proc) in running.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {source} ({proc.returncode}):\n{out}")
            continue
        lib_path = _lib_path(source)
        with open(lib_path + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, lib_path)
        build_log[source] = {"seconds": seconds, "ptxas": _ptxas_lines(out)}
    if failed:
        raise RuntimeError("\n".join(failed))
    for source in sources:
        if source not in build_log:
            with open(_lib_path(source) + ".log") as f:
                build_log[source] = {"seconds": 0.0,
                                     "ptxas": _ptxas_lines(f.read())}


def build_all() -> None:
    """Build the library of every ``csrc/*.cu`` in parallel, without loading
    them."""
    with _lock:
        _build(sorted(os.path.basename(p)
                      for p in glob.glob(os.path.join(CSRC_DIR, "*.cu"))))


def load_library(source: str) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` for sm_90a (once per content) and load it."""
    with _lock:
        if source not in _libs:
            _build([source])
            _libs[source] = ctypes.CDLL(_lib_path(source))
        return _libs[source]
