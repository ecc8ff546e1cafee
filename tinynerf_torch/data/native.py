"""ctypes binding of the port's host ray store (``csrc/raystore.cpp``).

The host-fed data path (``HOST_FEED``): the flattened pixel table stays on
the host, owned or memory-mapped, and a C++ background thread assembles
batches into a ring, deterministically (a counter-based generator makes
batch ``i`` the same whatever the timing). Counterpart of
``tinynerf/data/native.py``, with the same generator, so that batch ``i`` of
a seed is the same in both packages.

The library is built at first use with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` into ``build/tinynerf_torch/`` at the root of the checkout,
named by a hash of the source and the flags, under a temporary name of the
process and moved into place, so that processes building it at once do not
read a half-written file. A build that fails raises with the compiler's
message: nothing falls back to another store. ``NumpyRayStore`` is the plain
version of the same stream, which the tests hold the native store against;
it is used only where a caller asks for it by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "raystore.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "tinynerf_torch")
GXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}

Batch = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def _lib_path(source: str) -> str:
    """Where ``source`` builds to: named by a hash of its bytes (when it
    exists) and the flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    if os.path.isfile(source):
        with open(source, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libraystore-{h.hexdigest()[:16]}.so")


def _build(source: str, lib_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run(["g++", *GXX_FLAGS, source, "-o", tmp],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build the host ray store from {source} "
                           f"({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)


def load_library() -> ctypes.CDLL:
    """Build ``SOURCE`` unless its library is there, load it and declare its
    C interface. Raises ``RuntimeError`` with the compiler's message where
    the build fails."""
    source = SOURCE
    with _lock:
        if source in _libs:
            return _libs[source]
        lib_path = _lib_path(source)
        if not os.path.isfile(lib_path):
            _build(source, lib_path)
        lib = ctypes.CDLL(lib_path)
        lib.rs_create.restype = ctypes.c_void_p
        lib.rs_create.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64]
        lib.rs_create_mmap.restype = ctypes.c_void_p
        lib.rs_create_mmap.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint64]
        lib.rs_sample.restype = None
        lib.rs_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.rs_prefetch_start.restype = None
        lib.rs_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.rs_next.restype = ctypes.c_int64
        lib.rs_next.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.rs_destroy.restype = None
        lib.rs_destroy.argtypes = [ctypes.c_void_p]
        _libs[source] = lib
        return lib


def _out_buffers(batch: int) -> Batch:
    return (np.empty(batch, np.float32), np.empty(batch, np.float32),
            np.empty((batch, 3), np.float32), np.empty((batch, 17), np.float32),
            np.empty(batch, np.int32))


def _ptrs(arrays):
    return [a.ctypes.data_as(ctypes.c_void_p) for a in arrays]


class HostRayStore:
    """The native threaded batch source over a host pixel table::

        store = HostRayStore(pixels, poses, height, width, seed=624)
        rows, cols, rgb, pose, pic = store.sample(batch_index, batch)  # synchronous
        store.start(batch, depth=3)   # the background prefetch ring
        rows, cols, rgb, pose, pic = store.next()
        store.close()

    ``pixels`` is (num_pix, 3) float32 or uint8 (uint8 is dequantised to
    float32 in C++, ``x * (1.0f / 255.0f)``); ``poses`` is (num_pics, 17)
    float32. Both are copied in. Batches are deterministic in (seed,
    batch_index): the prefetched stream equals the synchronous one.
    """

    def __init__(self, pixels: np.ndarray, poses: np.ndarray, height: int,
                 width: int, seed: int = 0):
        self._lib = load_library()
        is_u8 = pixels.dtype == np.uint8
        pixels = np.ascontiguousarray(pixels, dtype=np.uint8 if is_u8 else np.float32)
        poses = np.ascontiguousarray(poses, dtype=np.float32)
        if pixels.ndim != 2 or pixels.shape[1] != 3 or poses.shape[1:] != (17,):
            raise ValueError(f"pixels must be (N, 3) and poses (P, 17), got "
                             f"{pixels.shape} and {poses.shape}")
        if pixels.shape[0] > poses.shape[0] * int(height) * int(width):
            raise ValueError("more pixels than the poses' images hold")
        self._handle = self._lib.rs_create(
            pixels.ctypes.data_as(ctypes.c_void_p), int(is_u8), pixels.shape[0],
            poses.ctypes.data_as(ctypes.c_void_p), poses.shape[0],
            int(height), int(width), ctypes.c_uint64(seed))
        if not self._handle:
            raise RuntimeError("rs_create failed")
        self._batch = 0

    @classmethod
    def from_pixel_file(cls, pixel_path: str, is_u8: bool, num_pix: int,
                        poses: np.ndarray, height: int, width: int,
                        seed: int = 0) -> "HostRayStore":
        """A store over a raw little-endian pixel file, memory-mapped (no
        copy): for tables that must not be duplicated in host memory."""
        self = cls.__new__(cls)
        self._lib = load_library()
        poses = np.ascontiguousarray(poses, dtype=np.float32)
        self._handle = self._lib.rs_create_mmap(
            pixel_path.encode(), int(is_u8), int(num_pix),
            poses.ctypes.data_as(ctypes.c_void_p), poses.shape[0],
            int(height), int(width), ctypes.c_uint64(seed))
        if not self._handle:
            raise RuntimeError(f"rs_create_mmap failed for {pixel_path} (missing or "
                               f"shorter than {num_pix} pixels)")
        self._batch = 0
        return self

    def sample(self, batch_index: int, batch: int) -> Batch:
        """Batch ``batch_index`` of ``batch`` rays, drawn now (no prefetch
        thread). Not to be mixed with a running prefetcher."""
        out = _out_buffers(batch)
        self._lib.rs_sample(self._handle, int(batch_index), int(batch), *_ptrs(out))
        return out

    def start(self, batch: int, depth: int = 3) -> None:
        """Start the background prefetcher with a ``depth``-slot ring."""
        self._batch = int(batch)
        self._lib.rs_prefetch_start(self._handle, int(batch), int(depth))

    def next(self) -> Batch:
        """The next prefetched batch (waits for it). Each call returns new
        arrays."""
        out = _out_buffers(self._batch)
        self._lib.rs_next(self._handle, *_ptrs(out))
        return out

    def close(self) -> None:
        """Stop the prefetcher and free the store."""
        if getattr(self, "_handle", None):
            self._lib.rs_destroy(self._handle)
            self._handle = None

    def __del__(self):  # close() is the contract; this frees a forgotten store
        try:
            self.close()
        except Exception:
            pass


_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_U32 = np.uint64(32)


def _squares32(ctr: np.ndarray, key: np.uint64) -> np.ndarray:
    """``squares32`` of ``csrc/raystore.cpp`` over uint64 counters (numpy's
    uint64 arithmetic wraps as C++'s does)."""
    rot = lambda v: (v >> _U32) | (v << _U32)
    with np.errstate(over="ignore"):
        x = ctr * key
        y = x
        z = y + key
        x = rot(x * x + y)
        x = rot(x * x + z)
        x = rot(x * x + y)
        return (x * x + z) >> _U32


class NumpyRayStore:
    """The plain version of ``HostRayStore``: the same API and the same
    stream (``squares32`` on the counter ``(batch_index << 32) | j``, a 64-bit
    draw modulo the pixel count), batch for batch bit-equal to it, drawn
    synchronously: ``next()`` draws on demand. The JAX package's numpy store
    draws another stream (Philox)."""

    def __init__(self, pixels: np.ndarray, poses: np.ndarray, height: int,
                 width: int, seed: int = 0):
        self._u8 = pixels.dtype == np.uint8
        self._pixels = pixels
        self._poses = np.asarray(poses, np.float32)
        self._pic_size = int(height) * int(width)
        self._width = int(width)
        self._key = np.uint64(((int(seed) * _GOLDEN) & _MASK64) | 1)
        self._batch = 0
        self._next_index = 0

    def sample(self, batch_index: int, batch: int) -> Batch:
        j = np.arange(batch, dtype=np.uint64)
        ctr = (np.uint64(batch_index) << _U32) | j
        draw = ((_squares32(ctr, self._key) << _U32)
                | _squares32(ctr ^ np.uint64(_GOLDEN), self._key))
        idx = (draw % np.uint64(self._pixels.shape[0])).astype(np.int64)
        pic = idx // self._pic_size
        in_pic = idx % self._pic_size
        rgb = self._pixels[idx]
        if self._u8:
            rgb = rgb.astype(np.float32) * (np.float32(1.0) / np.float32(255.0))
        return ((in_pic // self._width).astype(np.float32),
                (in_pic % self._width).astype(np.float32),
                np.ascontiguousarray(rgb, np.float32),
                self._poses[pic], pic.astype(np.int32))

    def start(self, batch: int, depth: int = 3) -> None:
        self._batch = int(batch)
        self._next_index = 0

    def next(self) -> Batch:
        out = self.sample(self._next_index, self._batch)
        self._next_index += 1
        return out

    def close(self) -> None:
        pass


def make_ray_store(pixels: np.ndarray, poses: np.ndarray, height: int,
                   width: int, seed: int = 0) -> HostRayStore:
    """The native store. Unlike the JAX package's, it never falls back to
    the numpy store: a failed build raises (``load_library``)."""
    return HostRayStore(pixels, poses, height, width, seed=seed)
