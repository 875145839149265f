"""ctypes binding of the native JPEG decode + letterbox loader
(``native/loader.cc``).

The C++ library is a persistent worker pool: libjpeg decode, half-pixel
bilinear resize and the reference letterbox geometry, into one contiguous
(N, S, S, 3) BGR uint8 batch.  This module builds it with ``g++`` into
``build/litepi_tpu_torch/`` at first use, named by a hash of the source,
the flags and the host CPU (``-march=native`` code runs only where it was
built), so a changed source or another host rebuilds and an unchanged one
loads at once.  It never loads or writes the library in ``native/``.

:func:`available` says whether the library built; callers keep a cv2 path
for when it did not (no compiler or no libjpeg).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "loader.cc"
BUILD_DIR = ROOT / "build" / "litepi_tpu_torch"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpthread")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _host_cpu() -> str:
    """The CPU model and feature flags, which ``-march=native`` code
    depends on."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.machine()
    keep = [l for l in lines if l.startswith(("model name", "flags"))][:2]
    return platform.machine() + "\n".join(keep)


def library_path() -> Path:
    key = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS + LIBS).encode() + _host_cpu().encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"liblitepi_loader-{key}.so"


def _load_library() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    if _lib is not None or _build_error is not None:
        return _lib
    try:
        path = library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".tmp{os.getpid()}")
            cmd = ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LIBS]
            out = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if out.returncode != 0:
                tmp.unlink(missing_ok=True)
                _build_error = out.stderr or f"g++ exited {out.returncode}"
                return None
            os.replace(tmp, path)  # atomic: a reader never sees half a library
        lib = ctypes.CDLL(str(path))
    except (OSError, subprocess.SubprocessError) as e:
        _build_error = str(e)
        return None
    lib.lp_create_loader.restype = ctypes.c_void_p
    lib.lp_create_loader.argtypes = [ctypes.c_int] * 4
    lib.lp_destroy_loader.argtypes = [ctypes.c_void_p]
    lib.lp_load_batch.restype = ctypes.c_int
    lib.lp_load_batch.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    """True when the native loader built (or was built before) and loaded."""
    return _load_library() is not None


def build_error() -> Optional[str]:
    """Why the loader is not available, or None."""
    _load_library()
    return _build_error


class NativeBatchLoader:
    """Persistent-pool batched JPEG decode + letterbox.

    ``load(paths)`` returns (N, S, S, 3) BGR uint8 canvases and (N, 5)
    float32 geoms rows (ratio, dw, dh, orig_w, orig_h); ratio 0 marks a
    frame that failed to decode (its canvas is all padding).
    ``scaled_decode`` turns on libjpeg's DCT-domain scaled decode, a
    throughput option whose pixels differ slightly from a full decode.
    """

    def __init__(
        self,
        threads: int = 8,
        out_size: int = 640,
        pad_value: int = 114,
        scaled_decode: bool = False,
    ) -> None:
        lib = _load_library()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self.out_size = out_size
        self.scaled_decode = scaled_decode
        self._handle = lib.lp_create_loader(threads, out_size, pad_value, int(scaled_decode))

    def load(
        self, paths: Sequence[str], out: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Decode ``paths`` into ``out`` (a C-contiguous (N, S, S, 3) uint8
        array, for example a view of pinned memory) or a new array; returns
        (canvases, geoms)."""
        n = len(paths)
        shape = (n, self.out_size, self.out_size, 3)
        if out is None:
            out = np.empty(shape, np.uint8)
        elif out.shape != shape or out.dtype != np.uint8 or not out.flags.c_contiguous:
            raise ValueError(f"out must be a C-contiguous {shape} uint8 array")
        geoms = np.empty((n, 5), np.float32)
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        self._lib.lp_load_batch(self._handle, arr, n, out.ctypes.data, geoms.ctypes.data)
        return out, geoms

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.lp_destroy_loader(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - gc timing
        try:
            self.close()
        except Exception:
            pass
