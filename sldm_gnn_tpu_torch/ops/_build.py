"""Build and load the port's CUDA kernels.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so the build takes seconds, not minutes). It runs at
first use, into ``_build/`` beside the package (listed in ``.gitignore``).
The library's file name carries a hash of the sources and flags; the
build writes a temporary name and renames it into place, so a build that
is cut off leaves no half-written library behind.

Every C entry point returns ``cudaGetLastError()`` after its launch (0 on
success); :func:`check` raises on anything else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# what the last build in this process printed (ptxas register and shared
# memory lines) and how long it took; None when the library was cached
build_log: str | None = None
build_seconds: float | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libsldm_kernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    global build_log, build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sorted(CSRC.glob("*.cu"))]]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr


def _bind(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gru_fwd_launch.argtypes = [
        p, i64, i64, i, i, i, i,  # x, stride_n, stride_t, N, T, D, H
        p, p, p, p,               # w_ih bf16, b_ih f32, w_hh bf16, b_hh f32
        p, p, p,                  # h_last f32 or NULL, hs bf16 or NULL, stream
    ]
    lib.gru_fwd_launch.restype = i
    lib.knn_topk_launch.argtypes = [p, i, p, i, i, p, p, p]
    lib.knn_topk_launch.restype = i
    lib.sldm_error_string.argtypes = [i]
    lib.sldm_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _build(path)
            lib = ctypes.CDLL(str(path))
            _bind(lib)
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.sldm_error_string(code).decode()
        raise RuntimeError(f"{what} failed: error {code}: {msg}")
