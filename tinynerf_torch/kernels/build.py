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
import re
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
    """ptxas' register, spill and shared memory lines, each kernel's after
    an ``entry <mangled name>`` line."""
    lines = []
    for ln in text.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            lines.append(f"entry {entry.group(1)}")
        elif "registers" in ln or "spill" in ln or "smem" in ln:
            lines.append(ln.strip())
    return lines


def _flags(defines) -> List[str]:
    return NVCC_FLAGS + [f"-D{d}" for d in defines]


def _lib_path(source: str, defines=()) -> str:
    """Where ``csrc/<source>`` builds to (with ``-D`` for each of
    ``defines``): named by a hash of the source, the shared headers and the
    flags."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC_DIR, source)] + sorted(
            glob.glob(os.path.join(CSRC_DIR, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(defines)).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:16]}.so")


def _key(source: str, defines=()) -> str:
    """``build_log``'s and the loaded libraries' key of a build: the source,
    then each define after a space."""
    return " ".join([source, *defines])


def _build(builds) -> None:
    """Compile every (source, defines) build whose library is missing, one
    ``nvcc`` process each, all started together; record each one's seconds
    and ptxas report in ``build_log``. Call with ``_lock`` held."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    t0 = time.perf_counter()
    for source, defines in builds:
        lib_path = _lib_path(source, defines)
        if not os.path.isfile(lib_path):
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            cmd = [find_nvcc(), *_flags(defines), "-o", tmp,
                   os.path.join(CSRC_DIR, source)]
            running[source, defines] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    failed = []
    for (source, defines), (tmp, proc) in running.items():
        out, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {_key(source, defines)} ({proc.returncode}):\n{out}")
            continue
        lib_path = _lib_path(source, defines)
        with open(lib_path + ".log", "w") as f:
            f.write(out)
        os.replace(tmp, lib_path)
        build_log[_key(source, defines)] = {"seconds": seconds, "ptxas": _ptxas_lines(out)}
    if failed:
        raise RuntimeError("\n".join(failed))
    for source, defines in builds:
        if _key(source, defines) not in build_log:
            with open(_lib_path(source, defines) + ".log") as f:
                build_log[_key(source, defines)] = {"seconds": 0.0,
                                                    "ptxas": _ptxas_lines(f.read())}


def build_all(variants=()) -> None:
    """Build the library of every ``csrc/*.cu`` and of each (source,
    defines) in ``variants`` in parallel, without loading them."""
    with _lock:
        _build([(os.path.basename(p), ()) for p in
                sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))]
               + [(source, tuple(defines)) for source, defines in variants])


def load_library(source: str, defines=()) -> ctypes.CDLL:
    """Compile ``csrc/<source>`` for sm_90a, with ``-D`` for each of
    ``defines`` (once per content), and load it."""
    defines = tuple(defines)
    with _lock:
        key = _key(source, defines)
        if key not in _libs:
            _build([(source, defines)])
            _libs[key] = ctypes.CDLL(_lib_path(source, defines))
        return _libs[key]


def _demangle(names: List[str]) -> List[str]:
    """Readable kernel names through the toolkit's ``cu++filt``, else the
    mangled ones."""
    tool = os.path.join(os.path.dirname(os.path.realpath(find_nvcc())), "cu++filt")
    if not os.path.isfile(tool):
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return out if len(out) == len(names) else names


def mma_counts(key: str) -> Dict[str, int]:
    """For each kernel in the built library of a ``build_log`` key (a
    ``csrc`` source, then its defines), the number of tensor-core
    instructions (``HMMA``, ``HGMMA``) in its SASS, read with the toolkit's
    ``cuobjdump -sass``. Build the library first."""
    tool = os.path.join(os.path.dirname(os.path.realpath(find_nvcc())), "cuobjdump")
    source, *defines = key.split()
    sass = subprocess.run([tool, "-sass", _lib_path(source, defines)], capture_output=True,
                          text=True, check=True).stdout
    names, counts = [], []
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            names.append(found.group(1))
            counts.append(0)
        elif names and re.search(r"\bH(G)?MMA\b", line):
            counts[-1] += 1
    return dict(zip(_demangle(names), counts))
