"""Build and load the package's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/loans_tpu_torch/`` at the repository root, keyed by a hash of the
source, the shared ``csrc/*.cuh`` headers and the flags, and loaded with
``ctypes``. Importing this module
compiles nothing; ``build_all`` compiles every library at once, one
``nvcc`` per source, all started together. ``nvcc`` is taken from
``$CUDA_HOME/bin`` (default ``/usr/local/cuda``) or the ``PATH``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "loans_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers and spills, kept in the build log
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of each library: name -> (argtypes, restype).
SIGNATURES = {
    "separable_sampler": {
        "separable_sampler_fwd": ([_P, _P, _P] + [_I] * 7 + [_P], _I),
        "separable_sampler_bwd_theta": ([_P] * 4 + [_I] * 7 + [_P], _I),
        "separable_sampler_bwd_images": ([_P] * 4 + [_I] * 7 + [_P], _I),
    },
    "rotated_sampler": {
        "rotated_sampler_fwd": ([_P, _P, _P] + [_I] * 7 + [_P], _I),
        "rotated_sampler_bwd_theta": ([_P] * 4 + [_I] * 7 + [_P], _I),
        "rotated_sampler_bwd_images": ([_P] * 4 + [_I] * 7 + [_P], _I),
    },
}
_COMMON = {"loans_cuda_error_string": ([_I], ctypes.c_char_p)}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """Where the built library for ``csrc/<name>.cu`` lives: keyed by that
    source, the shared headers ``csrc/*.cuh`` it may include, and the
    flags."""
    sources = [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))]
    text = b"".join(path.read_bytes() for path in sources) + " ".join(NVCC_FLAGS).encode()
    key = hashlib.sha256(text).hexdigest()
    return BUILD_DIR / f"lib{name}_{key[:16]}.so"


def _build(name: str) -> None:
    """Compile ``csrc/<name>.cu`` unless its library exists. The
    compiler's output goes to a ``.log`` beside the library."""
    so = library_path(name)
    if so.exists():
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name}.cu ({' '.join(cmd)}):\n{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent build never sees half a file


def build_all() -> None:
    """Compile every library of ``SIGNATURES`` that is missing, one
    ``nvcc`` process per source, all running at once."""
    with concurrent.futures.ThreadPoolExecutor(len(SIGNATURES)) as pool:
        list(pool.map(_build, SIGNATURES))  # re-raises a failed build


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed, load it and declare its entry
    points."""
    _build(name)
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, (argtypes, restype) in {**_COMMON, **SIGNATURES[name]}.items():
        entry = getattr(lib, fn)
        entry.argtypes = argtypes
        entry.restype = restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.loans_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {err})")
