"""ctypes binding of the C++ batch sampler and prefetcher (mirror of
``neusky_tpu/data/native_sampler.py``).

``csrc/batch_sampler.cpp`` (the JAX package's ``native/batch_sampler.cpp``
with the sky rays drawn by the prefetch thread) builds per-image tables of
static and sky pixels, draws fixed-shape [U images × R rays] batches and
sky rays from one xorshift128+ stream, and fills a ring buffer of batches
from a background thread.  Given the same seed and the same synchronous
calls it draws what the JAX package's binding draws.

The library is built with ``g++`` at first use into ``neusky_torch/_build/``
(its name keyed by the source's hash).  Where it cannot be built this module
raises: a run that asked for the native sampler never runs the numpy one
instead (the JAX package falls back to it).

Once prefetching has started, the prefetch thread alone advances the
stream: it draws each batch and then that batch's sky rays, so the
prefetched stream equals the synchronous one (``sample_batch``, then
``sample_sky``) draw for draw, however the caller paces its calls.  (JAX's
source draws the sky on the caller's thread, racing its prefetch thread.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "batch_sampler.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Build output, keyed by the source's hash so an edit rebuilds."""
    tag = hashlib.sha1(SOURCE.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"libbatch_sampler_{tag}.so"


def build() -> Path:
    """Compile the sampler (no-op if the library for this source exists);
    raises ``RuntimeError`` when it cannot."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native batch sampler needs g++, and none was found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the native batch sampler failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sampler_create.restype = ctypes.c_void_p
    lib.sampler_create.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
    lib.sampler_destroy.restype = None
    lib.sampler_destroy.argtypes = [ctypes.c_void_p]
    lib.sampler_has_sky.restype = ctypes.c_int
    lib.sampler_has_sky.argtypes = [ctypes.c_void_p]
    lib.sampler_sample_batch.restype = None
    lib.sampler_sample_batch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, i32p, i64p, f32p, f32p]
    lib.sampler_sample_sky.restype = None
    lib.sampler_sample_sky.argtypes = [ctypes.c_void_p, ctypes.c_int, i32p, i64p]
    lib.sampler_start_prefetch.restype = None
    lib.sampler_start_prefetch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.sampler_next_batch.restype = None
    lib.sampler_next_batch.argtypes = [ctypes.c_void_p, i32p, i64p, f32p, f32p, i32p, i64p]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeBatchSampler:
    """A native sampler over float32 copies of ``images`` [C, H, W, 3] and
    ``masks`` [C, H, W, 4] that it keeps alive.  Draws return host numpy:
    image rows [U] int32, flat pixels [U·R] int64, rgb [U·R, 3] and mask
    [U·R, 4] float32."""

    def __init__(self, images: np.ndarray, masks: np.ndarray, seed: int = 0):
        self._lib = _load()
        c, h, w = images.shape[:3]
        self._images = np.ascontiguousarray(images.reshape(c, h * w, 3), np.float32)
        self._masks = np.ascontiguousarray(masks.reshape(c, h * w, 4), np.float32)
        self.num_images, self.height, self.width = c, h, w
        self._handle = self._lib.sampler_create(
            _ptr(self._images, ctypes.c_float), _ptr(self._masks, ctypes.c_float), c, h, w, seed)
        self._prefetching: Optional[Tuple[int, int, int]] = None

    def close(self) -> None:
        """Stop the prefetch thread and free the native state."""
        if getattr(self, "_handle", None):
            self._lib.sampler_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()

    @property
    def has_sky(self) -> bool:
        return bool(self._lib.sampler_has_sky(self._handle))

    @staticmethod
    def _alloc(u: int, r: int):
        return (np.empty(u, np.int32), np.empty(u * r, np.int64), np.empty((u * r, 3), np.float32),
                np.empty((u * r, 4), np.float32))

    @staticmethod
    def _ptrs(rows, pixels, rgb, mask):
        return (_ptr(rows, ctypes.c_int32), _ptr(pixels, ctypes.c_int64), _ptr(rgb, ctypes.c_float),
                _ptr(mask, ctypes.c_float))

    def sample_batch(self, u: int, r: int):
        """One batch drawn now, on the calling thread (not while
        prefetching)."""
        out = self._alloc(u, r)
        self._lib.sampler_sample_batch(self._handle, u, r, *self._ptrs(*out))
        return out

    def sample_sky(self, n: int):
        """(image rows [n] int32, flat sky pixels [n] int64), drawn now on
        the calling thread (not while prefetching)."""
        rows, pixels = np.empty(n, np.int32), np.empty(n, np.int64)
        self._lib.sampler_sample_sky(self._handle, n, _ptr(rows, ctypes.c_int32), _ptr(pixels, ctypes.c_int64))
        return rows, pixels

    def start_prefetch(self, u: int, r: int, queue_depth: int = 4, num_sky: int = 0) -> None:
        """Start the background thread that keeps ``queue_depth`` batches of
        U × R ready, each followed by its ``num_sky`` sky rays."""
        self._lib.sampler_start_prefetch(self._handle, u, r, num_sky, queue_depth)
        self._prefetching = (u, r, num_sky)

    def next_batch(self):
        """The next prefetched batch (waits for one): image rows, flat
        pixels, rgb and mask, then, when prefetching with sky rays, their
        image rows [S] int32 and flat pixels [S] int64."""
        if self._prefetching is None:
            raise RuntimeError("next_batch before start_prefetch")
        u, r, n_sky = self._prefetching
        out = self._alloc(u, r)
        sky = (np.empty(n_sky, np.int32), np.empty(n_sky, np.int64))
        self._lib.sampler_next_batch(self._handle, *self._ptrs(*out), _ptr(sky[0], ctypes.c_int32),
                                     _ptr(sky[1], ctypes.c_int64))
        return out + sky if n_sky else out
