"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc``, all
started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
the build takes seconds, not minutes). It runs at first use, into
``_build/`` beside the package (listed in ``.gitignore``).
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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
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
    nvcc = _nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    objs = [tmp.with_name(f"{tmp.name}.{p.stem}.o") for p in sources]
    t0 = time.perf_counter()
    logs = []
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        failed = []
        try:
            for src, proc in zip(sources, procs):
                text = proc.communicate(timeout=BUILD_TIMEOUT_S)[0]
                logs.append(text)
                if proc.returncode != 0:
                    failed.append(f"nvcc {src.name} failed ({proc.returncode}):\n{text}")
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        if failed:
            raise RuntimeError("\n".join(failed))
        link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True, timeout=BUILD_TIMEOUT_S)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n"
                               f"{link.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.gru_fwd_launch.argtypes = [
        p, i64, i64, i, i, i, i,  # x, stride_n, stride_t, N, T, D, H
        p, p, p, p,               # w_ih bf16, b_ih f32, w_hh bf16, b_hh f32
        p, p, p,                  # h_last f32 or NULL, hs bf16 or NULL, stream
    ]
    lib.gru_fwd_launch.restype = i
    lib.gru_fwd_sg_launch.argtypes = [
        p, i64, i64, i, i, i, i,  # x, stride_n, stride_t, N, T, D, H
        p, p, p, p,               # w_ih bf16, b_ih f32, w_hh bf16, b_hh f32
        p, p, p,                  # hs bf16, gates bf16, stream
    ]
    lib.gru_fwd_sg_launch.restype = i
    pi = ctypes.POINTER(ctypes.c_int)
    lib.gru_fwd_route.argtypes = [i, i, pi]  # D, H, -> route
    lib.gru_fwd_route.restype = i
    for name in ("gru_bwd_grid", "gru_bwd_sg_grid"):
        getattr(lib, name).argtypes = [i, i, i, i, ctypes.POINTER(i64)]  # N, T, D, H, -> bytes
        getattr(lib, name).restype = i
    for name in ("gru_bwd_route", "gru_bwd_sg_route"):
        getattr(lib, name).argtypes = [i, i, pi]  # D, H, -> route
        getattr(lib, name).restype = i
    lib.gru_bwd_launch.argtypes = [
        p, i64, i64, p,           # x, stride_n, stride_t, hs
        p, i64, i64, i,           # g, stride_n, stride_t, seq_cot
        i, i, i, i,               # N, T, D, H
        p, p, p, p,               # w_ih, b_ih, w_hh, b_hh
        p, p, i64, p, p,          # dx or NULL, workspace, its bytes, out, stream
    ]
    lib.gru_bwd_launch.restype = i
    lib.gru_bwd_sg_launch.argtypes = [
        p, i64, i64, p, p,        # x, stride_n, stride_t, hs, gates
        p, i64, i64, i,           # g, stride_n, stride_t, seq_cot
        i, i, i, i,               # N, T, D, H
        p, p,                     # w_ih, w_hh
        p, p, i64, p, p,          # dx or NULL, workspace, its bytes, out, stream
    ]
    lib.gru_bwd_sg_launch.restype = i
    lib.gru_scan_fwd_launch.argtypes = [
        p, i64, i64, p, p,        # xproj, stride_t, stride_b, w_hh, b_hh
        i, i, i, p, p,            # T, B, H, hs, stream
    ]
    lib.gru_scan_bwd_rows.argtypes = [i, pi]  # H, -> rows
    lib.gru_scan_bwd_grid.argtypes = [i, i, pi]  # B, H, -> blocks
    lib.gru_scan_bwd_launch.argtypes = [
        p, i64, i64, p, p, p,     # xproj, stride_t, stride_b, hs, w_hh, b_hh
        p, i64, i64, i, i, i,     # g, stride_t, stride_b, T, B, H
        p, p, i, p, p,            # dxproj, partial, blocks, out, stream
    ]
    for name in ("gru_scan_fwd_launch", "gru_scan_bwd_rows", "gru_scan_bwd_grid",
                 "gru_scan_bwd_launch"):
        getattr(lib, name).restype = i
    f = ctypes.c_float
    lib.spmm_banded_launch.argtypes = [
        p, i, i, p, p, p, i,      # a, a_f32, wide, bo, cmap, woff, k
        i, i, i,                  # nb, s_span, tile
        p, i, i, p, p, p, p,      # x, x_bf16, D, cs, rs, out, stream
    ]
    lib.sage_fwd_launch.argtypes = [
        p, i, p, p, p,            # a, a_f32, bo, cmap, woff
        p, i, i, i, i,            # rs, nb, s_span, tile, k
        p, i, i, i, p, p,         # x, x_bf16, D, H, wl, wr
        p, p, p, f, i, f,         # bias, gamma, beta, eps, has_act, slope
        p, i, p, p, p, p,         # r_c, r_bf16, rg, out, xhat, rstd
        p, p, p,                  # ypre, rg_b, stream
    ]
    lib.sage_dw_parts.argtypes = [i, pi]  # rows, -> parts
    lib.sage_bwd_launch.argtypes = [
        p, i, p, p, p,              # a, a_f32, bo, cmap, woff
        p, p, i, i, i, i,           # cs, rstd, nb, s_span, tile, k
        p, i, p, i, i,              # R, r_bf16, O, o_bf16, H
        p, p, i, p, i, p,           # wlt, wrt, D, t_c, tc_bf16, rg
        p, i, p, i, p, i,           # x, x_bf16, dx, dx_bf16, t_out, t_bf16
        p, i, p, p,                 # partial, parts, dw, stream
    ]
    lib.ln_bwd_prologue_launch.argtypes = [
        i, i, p, i, p, i, p, p, p, i,  # nb, tile, g, g_bf16, xhat, xh_bf16, rstd, gamma, beta, H
        i, f, p, p, p, p, p,           # has_act, slope, dyu, dyo, stats, dstats, stream
    ]
    lib.spmm_onehot_launch.argtypes = [
        p, p, p, p, i,            # row_ptr, perm, src_row, weight, rows
        p, i, i, i, p, p,         # x, x_bf16, D, round, out, stream
    ]
    lib.spmm_dense_launch.argtypes = [
        p, i, p, i, i, i,         # a, a_kind, src_blk, nb, s_max, tile
        p, i, i, p, p, p,         # x, x_bf16, D, rs, out, stream
    ]
    lib.spmm_gather_launch.argtypes = [
        p, i, p, p, i, i, i, i,   # codes, code_rows, mult, woff, nb, tile, k, R
        p, i, i, p, p, p,         # x, x_bf16, D, rs, out, stream
    ]
    lib.spmm_banded_int8_launch.argtypes = [
        p, p, i, i, i,            # a, bo, nb, s_span, tile
        p, i, p, p, p, p,         # xq, D, x_scale, rs, out, stream
    ]
    lib.quant_rows_launch.argtypes = [
        p, i, i, i, ctypes.c_uint32,  # x, rows, D, stochastic, seed
        p, p, p,                      # q, scale, stream
    ]
    lib.spmm_onehot_int8_launch.argtypes = [
        p, p, p, p, p, i, i, i,   # row_ptr, perm, block_meta, src_local, weight, ec, tile, rows
        p, i, p, i, i, p, p,      # xq, D, scales, per_row, out_bf16, out, stream
    ]
    lib.spmm_mk_launch.argtypes = [
        p, p, p, p, p, i,         # row_ptr, grp_src, grp_ptr, perm, weight, rows
        p, i, i, i, p, p,         # x, x_bf16, D, fast, out, stream
    ]
    lib.sddmm_launch.argtypes = [
        p, p, p, p, i, i, i,      # block_meta, src_local, dst_local, weight, W, ec, tile
        p, p, i, p, p,            # x, y, D, out, stream
    ]
    for name in ("spmm_banded_launch", "sage_fwd_launch", "sage_dw_parts", "sage_bwd_launch",
                 "ln_bwd_prologue_launch", "spmm_onehot_launch", "spmm_dense_launch",
                 "spmm_gather_launch", "spmm_banded_int8_launch", "quant_rows_launch",
                 "spmm_onehot_int8_launch", "sddmm_launch", "spmm_mk_launch"):
        getattr(lib, name).restype = i
    lib.knn_topk_launch.argtypes = [p, i, p, i, i, p, p, p]
    lib.knn_topk_launch.restype = i
    lib.knn_topk_plan.argtypes = [i, pi]  # V, -> warps a point
    lib.knn_topk_plan.restype = i
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
