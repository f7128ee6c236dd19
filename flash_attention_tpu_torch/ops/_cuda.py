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

import contextlib
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

# dtype codes shared with csrc/common.cuh. Every kernel of B1-B10 takes
# all three (fp32 products in full fp32 on the CUDA cores, the JAX
# kernels' Precision.HIGHEST); the probe kernels (P1-P3) take bf16 only.
DTYPE_CODES = {torch.float16: 0, torch.bfloat16: 1, torch.float32: 2}

# Storage codes of int8 / fp8 values (csrc/common.cuh kInt8, kE4M3,
# kE5M2; 0 is a value in the compute dtype itself).
STORE_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2, torch.float8_e5m2: 3}

# Weight storage codes of B6-B9's kernels: a dense weight in the
# activation's own dtype, int8, the two fp8 formats, packed int4.
WEIGHT_CODES = {"dense": 0, **STORE_CODES, "int4": 4}

_lock = threading.Lock()
_lib = None

_vp, _i32, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, k scales (or NULL), v scales (or NULL), o, lse, qseg (or
    # NULL), kvseg (or NULL), B, Hq, Hkv, Nq, Nk, D, causal, offset,
    # window (0 = none), split (0, 1 bulk, 2 band), band, scale, dtype,
    # kv store, stream
    "fa_flash_fwd": [_vp] * 9 + [_i32] * 11 + [_f32, _i32, _i32, _vp],
    # q, k, v, do, lse, delta, dq, qseg (or NULL), kvseg (or NULL), B,
    # Hq, Hkv, Nq, Nk, D, causal, offset, window (0 = none), scale,
    # dtype, stream
    "fa_flash_bwd_dq": [_vp] * 9 + [_i32] * 9 + [_f32, _i32, _vp],
    # q, k, v, do, lse, delta, dk, dv, qseg (or NULL), kvseg (or NULL),
    # B, Hq, Hkv, Nq, Nk, D, causal, offset, window (0 = none), scale,
    # dtype, stream
    "fa_flash_bwd_dkv": [_vp] * 10 + [_i32] * 9 + [_f32, _i32, _vp],
    # q, k_pool, v_pool, k scales (or NULL), v scales (or NULL),
    # page_table, lengths, window starts (or NULL), o, lse, B, Hq, Hkv,
    # num_pages, page_size, table_width, D, qpos_spread, scale, dtype,
    # kv store, fold_scales, body, splits, workspace (or NULL), counters
    # (or NULL), stream
    "fa_paged_decode": [_vp] * 10 + [_i32] * 8 + [_f32] + [_i32] * 5
    + [_vp] * 3,
    # q, k, v, k scales (or NULL), v scales (or NULL), lengths, o, B, Hq,
    # Hkv, S, D, window (0 = none), scale, dtype, kv store, body, splits,
    # workspace (or NULL), counters (or NULL), stream
    "fa_decode": [_vp] * 7 + [_i32] * 6 + [_f32] + [_i32] * 4 + [_vp] * 3,
    # x, w, scale (or NULL), y, M, K, F, weight code, dtype, body, tile
    # rows, splits, k_chunk, workspace (or NULL), counters (or NULL),
    # stream
    "fa_quant_matmul": [_vp] * 4 + [_i32] * 9 + [_vp] * 3,
    # x, w, scale (or NULL), offsets, y, M, K, F, E, weight code, dtype,
    # body, tile rows, splits, k_chunk, workspace (or NULL), counters (or
    # NULL), stream
    "fa_grouped_matmul": [_vp] * 5 + [_i32] * 10 + [_vp] * 3,
    # q, k, v, o, m, l, B, H, Nq, Nk, D, block_q, block_kv, scale, dtype,
    # stream
    "fa_fa1_fwd": [_vp] * 6 + [_i32] * 7 + [_f32, _i32, _vp],
    # q, k, v, o, B, Hq, Hkv, Nq, Nk, D, block_q, block_kv, causal,
    # scale, dtype, stream
    "fa_fa2_inloop_fwd": [_vp] * 4 + [_i32] * 9 + [_f32, _i32, _vp],
    # q, k, v, o, B, H, Nq, Nk, D, block_q, block_kv, scale, dtype,
    # stream
    "fa_naive_fwd": [_vp] * 4 + [_i32] * 7 + [_f32, _i32, _vp],
    # The probes' kernels (flash_attention_tpu_torch/scripts/).
    # P1: x, w (offset-binary int4), scale, y, M, K, F, variant (1 float
    # domain, 2 int domain), body, splits, k_chunk, workspace (or NULL),
    # counters (or NULL), stream
    "fa_probe_int4_matmul": [_vp] * 4 + [_i32] * 7 + [_vp] * 3,
    # P2 v2: q, k_pool, v_pool, k scales, v scales, page_table, lengths,
    # o, lse, B, Hq, Hkv, num_pages, page_size, table_width, D, scale,
    # stream
    "fa_probe_paged_int8_v2": [_vp] * 9 + [_i32] * 7 + [_f32, _vp],
    # P3: x, w (int4), scale, keys (uint64 scratch), ids, values, M, K,
    # V, chunk, body, stream
    "fa_probe_lmhead_argmax": [_vp] * 6 + [_i32] * 5 + [_vp],
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
    Returns the seconds spent (0.0 when the library was current). With
    `verbose`, prints each source's ptxas report and its compile time."""
    sources = sorted(CSRC.glob("*.cu"))
    if not _stale(sources):
        return 0.0
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp, \
            contextlib.ExitStack() as logs:
        objs, procs = [], {}
        for src in sources:
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-I", str(CSRC),
                   "-c", str(src), "-o", str(obj)]
            if verbose:
                cmd += ["-Xptxas", "-v"]
            log = logs.enter_context(
                open(pathlib.Path(tmp) / (src.stem + ".log"), "w+"))
            procs[src] = (subprocess.Popen(cmd, stdout=log,
                                           stderr=subprocess.STDOUT), log)
            objs.append(str(obj))
        done = {}
        while len(done) < len(procs):
            for src, (proc, _) in procs.items():
                if src not in done and proc.poll() is not None:
                    done[src] = time.perf_counter() - t0
            if time.perf_counter() - t0 > 900:
                for proc, _ in procs.values():
                    proc.kill()
                raise RuntimeError("nvcc took over 900 s")
            time.sleep(0.05)
        failed = []
        for src, (proc, log) in procs.items():
            log.seek(0)
            out = log.read()
            if proc.returncode:
                failed.append(f"{src.name}:\n{out}")
            elif verbose:
                print(out + f"nvcc {src.name}: {done[src]:.1f} s", flush=True)
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
    if _lib is not None:
        return _lib
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


# The current stream's handle without building a torch.cuda.Stream (the
# binding CUDA builds of torch have; its value is the same).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def stream_handle(device: torch.device) -> int:
    if _raw_stream is not None and device.index is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


_scratch: dict = {}


def scratch(device, stream: int, n_floats: int, n_counters: int):
    """(workspace, counters) of the kernels that merge split partials
    inside their launch (B4 / B5's split body, B6-B8's split-K decode
    body, B6-B9's fp32 FFMA body) on `device` for launches on `stream`:
    at least n_floats fp32 values and n_counters zero int32 counters
    (each launch's last block of a unit resets its own). Launches on one
    stream run in order, so each stream keeps one pair, allocated once
    and grown when a launch needs more; a launch on another stream never
    sees these counters."""
    key = (device, stream)
    ws, counters = _scratch.get(key, (None, None))
    if ws is None or ws.numel() < n_floats:
        ws = torch.empty(max(n_floats, 1 << 20), dtype=torch.float32,
                         device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(max(n_counters, 4096), dtype=torch.int32,
                               device=device)
    _scratch[key] = ws, counters
    return ws, counters


def check(code: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error."""
    if code:
        msg = lib().fa_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} "
                           f"({msg})")
