"""Build and bind the port's hand-written CUDA kernels.

Every `csrc/*.cu` compiles with nvcc for `sm_90a` (one nvcc process per
source, all started together) and links into one shared library with a
plain C interface, loaded with ctypes. Nothing includes PyTorch's
headers, so a cold build takes seconds. The build runs at first use,
into `csrc/build/` beside the sources, and is redone whenever a source
is newer than the library.

Each C entry point launches on the stream it is given, allocates
nothing and returns `cudaGetLastError()` as an int; `check()` turns a
non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time

import torch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
LIB_PATH = BUILD_DIR / "libfa_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "--expt-relaxed-constexpr"]

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float16: 0, torch.bfloat16: 1}

# Weight storage codes of csrc/matmul_core.cuh: a dense weight in the
# activation's own dtype, int8, the two fp8 formats, packed int4.
WEIGHT_CODES = {"dense": 0, torch.int8: 1, torch.float8_e4m3fn: 2,
                torch.float8_e5m2: 3, "int4": 4}

_lock = threading.Lock()
_lib = None

_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, lse, B, Hq, Hkv, Nq, Nk, D, causal, offset, scale,
    # dtype, stream
    "fa_flash_fwd": [_vp, _vp, _vp, _vp, _vp] + [_i32] * 8
    + [_f32, _i32, _vp],
    # q, k, v, do, lse, delta, dq, B, Hq, Hkv, Nq, Nk, D, causal,
    # offset, scale, dtype, stream
    "fa_flash_bwd_dq": [_vp] * 7 + [_i32] * 8 + [_f32, _i32, _vp],
    # q, k, v, do, lse, delta, dk, dv, B, Hq, Hkv, Nq, Nk, D, causal,
    # offset, scale, dtype, stream
    "fa_flash_bwd_dkv": [_vp] * 8 + [_i32] * 8 + [_f32, _i32, _vp],
    # q, k_pool, v_pool, page_table, lengths, o, lse, B, Hq, Hkv,
    # num_pages, page_size, table_width, D, scale, dtype, stream
    "fa_paged_decode": [_vp] * 7 + [_i32] * 7 + [_f32, _i32, _vp],
    # q, k, v, lengths, o, B, Hq, Hkv, S, D, scale, dtype, stream
    "fa_decode": [_vp] * 5 + [_i32] * 5 + [_f32, _i32, _vp],
    # x, w, scale (or NULL), y, M, K, F, weight code, dtype, stream
    "fa_quant_matmul": [_vp] * 4 + [_i32] * 5 + [_vp],
    # x, w, scale (or NULL), offsets, y, M, K, F, E, weight code, dtype,
    # stream
    "fa_grouped_matmul": [_vp] * 5 + [_i32] * 6 + [_vp],
}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or put the CUDA "
                       "toolkit's bin directory on PATH)")


def _stale(sources) -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    deps = list(sources) + list(CSRC.glob("*.cuh"))
    return any(p.stat().st_mtime > built for p in deps)


def build(verbose: bool = False) -> float:
    """Compile csrc/*.cu into LIB_PATH if it is missing or stale.
    Returns the seconds spent (0.0 when the library was current)."""
    sources = sorted(CSRC.glob("*.cu"))
    if not _stale(sources):
        return 0.0
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC),
                   "-c", str(src), "-o", str(obj)]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        failed = []
        for src, proc in procs:
            out, _ = proc.communicate(timeout=600)
            if proc.returncode:
                failed.append(f"{src.name}:\n{out}")
            elif verbose and out:
                print(out)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = pathlib.Path(tmp) / LIB_PATH.name
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib), *objs],
            capture_output=True, text=True, timeout=600)
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + link.stdout
                               + link.stderr)
        os.replace(tmp_lib, LIB_PATH)
    return time.perf_counter() - t0


def lib():
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(str(LIB_PATH))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.fa_error_string.argtypes = [ctypes.c_int]
            handle.fa_error_string.restype = ctypes.c_char_p
            _lib = handle
    return _lib


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code:
        msg = lib().fa_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({msg})")
