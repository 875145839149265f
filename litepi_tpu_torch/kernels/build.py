"""Build the CUDA sources in ``litepi_tpu_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``.  Libraries go to
``build/litepi_tpu_torch/`` at the root of the checkout, named by a hash of
the source and the flags, so a changed source rebuilds and an unchanged one
loads at once.  :func:`build` starts one ``nvcc`` per source that needs it,
all at once, and waits for all of them.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so that no
multiply-add is contracted into an FMA: the kernels then round exactly as
their plain PyTorch versions do (one rounding per operation), which the
NMS kernel's bit-equal IoU threshold test depends on.  A kernel that wants
fused multiply-adds (the stem's convolution sum) writes them out.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "litepi_tpu_torch"
SOURCES = ("nms", "roi", "stem", "act", "vocab")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "--fmad=false",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source whose library is missing, in parallel.

    Returns {name: library path}.  The compiler's resource report
    (``-Xptxas -v``) is kept beside each library as ``<lib>.log``.
    Raises with the compiler's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    jobs = {}
    for name, lib in paths.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
            tmp,
        )
    failures = []
    for name, (proc, tmp) in jobs.items():
        out, _ = proc.communicate()
        lib = paths[name]
        if proc.returncode != 0:
            failures.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        Path(str(lib) + ".log").write_text(out)
        os.replace(tmp, lib)  # atomic: a reader never sees half a library
    if failures:
        raise RuntimeError("kernel build failed\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
