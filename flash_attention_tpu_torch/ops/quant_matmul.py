"""Weight-only quantized and weight-streaming matrix products (port of
`flash_attention_tpu/ops/quant_matmul.py`).

Three wrappers share one hand-written CUDA kernel, `csrc/quant_matmul.cu`,
templated over the weight's storage:

  * `quant_matmul` (B6, the port of the Pallas `_kernel`):
    y[m, f] = x[m, k] @ (Wq[k, f] * s[f]) with Wq int8 or fp8
    (e4m3 / e5m2) and one fp32 scale per output channel, applied to the
    fp32 sum once at the store;
  * `int4_matmul` (B7, the port of `_int4_kernel`): y = x @ dequant(W)
    for packed int4 W (byte j of a column holds logical rows 2j, low
    nibble, and 2j + 1, high nibble) with one fp32 scale per 128 rows
    and column; each weight is multiplied by its group scale in fp32 and
    rounded to the activation type before the product;
  * `dense_matmul` (B8, the port of `_dense_kernel`): y = x @ W with W
    in the activation's own 16-bit type, fp32 sum.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
PyTorch version beside each wrapper, which does the kernel's roundings.
The kernel and the plain versions take fp16, bf16 and fp32 activations
(fp32 products in full fp32 on the CUDA cores; B8's weight in the
activation's dtype).

Which body a launch runs is decided from the shape before the launch
(`matmul_body`): fp32 activations take the register-blocked FFMA body of
`csrc/matmul_f32.cuh` (`ffma_plan` sizes its tile and splits); fp16 /
bf16 operands that TMA can address take the Hopper bodies of
`csrc/matmul_sm90.cuh` -- the split-K decode body for at most
DECODE_MAX_ROWS rows (`decode_split_plan` sizes its splits), the wgmma
prefill body above -- and fp16 / bf16 operands with a base or row stride
that is not a multiple of 16 bytes the first body of
`csrc/matmul_core.cuh`.

`quantize_weight` and `quantize_weight_int4` are numpy computations, as
in the JAX package, and give the same bytes and scales.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.quant import (
    _QMAX,
    tile_to_f32,
    widen_scaled,
)

INT4_GROUP = 128   # logical K rows per int4 scale group

# The bodies of B6-B9 and their C codes: the first body
# (csrc/matmul_core.cuh), the Hopper prefill and split-K decode bodies
# (csrc/matmul_sm90.cuh), the fp32 FFMA body (csrc/matmul_f32.cuh).
BODY_CODES = {"first": 0, "prefill": 1, "decode": 2, "ffma": 3}
DECODE_MAX_ROWS = 64   # the split-K body's x rows (padded to 16 or 64)
DECODE_TILE_F = 64     # columns of y a decode block owns
SPLIT_ROWS = INT4_GROUP   # a split's K rows are a multiple of this
SM_COUNT = 132         # the H100's SMs; the split bodies fit two a SM
FFMA_TILE_ROWS = (16, 32, 64, 128)   # rows of y an FFMA block may own
FFMA_TILE_F = 128      # columns of y an FFMA block owns

# Launches of the B6, B7 and B8 kernels (each incremented only where its
# kernel is launched).
quant_matmul_launches = 0
int4_matmul_launches = 0
dense_matmul_launches = 0
# Launches of each on fp32 activations (also counted above).
quant_matmul_fp32_launches = 0
int4_matmul_fp32_launches = 0
dense_matmul_fp32_launches = 0
# fp16 / bf16 launches of B6-B9 on the first body (operands TMA cannot
# address; also counted above and in ops/grouped.py's counter).
matmul_first_body_launches = 0
# Launches of B6-B9 on the fp32 FFMA body (every fp32 launch; also
# counted above and in ops/grouped.py's counters).
matmul_ffma_launches = 0


# --- plain versions ------------------------------------------------------


def quant_matmul_plain(x, w_q, w_scale):
    """B6's function in plain PyTorch: Wq widened exactly to x's dtype,
    fp32 sum, the per-channel scale on the fp32 sum, one rounding to x's
    dtype."""
    w = tile_to_f32(w_q).to(x.dtype).float()
    return ((x.float() @ w) * w_scale.float()).to(x.dtype)


def int4_unpack(packed: torch.Tensor) -> torch.Tensor:
    """Packed int4 [..., K/2, F] (int8 or uint8 bytes) -> int8 [..., K, F]:
    byte j gives row 2j (low nibble) and row 2j + 1 (high nibble), each a
    two's-complement nibble in -8..7, sign-extended by arithmetic shifts
    of the byte (no int32 copy: the MoE one-hot path unpacks whole
    expert stacks)."""
    b = packed.view(torch.int8)
    *lead, kp2, f = b.shape
    return torch.stack([(b << 4) >> 4, b >> 4], dim=-2).reshape(
        *lead, 2 * kp2, f)


def int4_dequant(packed, scales, dtype):
    """[..., K, F] weights in `dtype` from packed [..., K/2, F] and scales
    [..., K/128, F]: each value times its group scale in fp32, then one
    rounding (the kernel's numerics)."""
    q = int4_unpack(packed)
    *lead, k, f = q.shape
    w = widen_scaled(q.reshape(*lead, k // INT4_GROUP, INT4_GROUP, f),
                     scales[..., None, :], dtype)
    return w.reshape(*lead, k, f)


def int4_matmul_plain(x, w_packed, w_scales):
    """B7's function in plain PyTorch."""
    w = int4_dequant(w_packed, w_scales, x.dtype).float()
    return (x.float() @ w).to(x.dtype)


def dense_matmul_plain(x, w):
    """B8's function in plain PyTorch: fp32 sum, one rounding."""
    return (x.float() @ w.float()).to(x.dtype)


# --- kernel launches -----------------------------------------------------


def _check_cuda(kernel, x, **tensors):
    """What the kernel takes: fp16 / bf16 / fp32 activations, every
    tensor on x's device and contiguous."""
    if x.dtype not in _cuda.DTYPE_CODES:
        raise TypeError(f"{kernel} takes fp16/bf16/fp32 activations, got "
                        f"{x.dtype}")
    for name, t in dict(x=x, **tensors).items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def tma_ready(x, w, storage, scale=None) -> bool:
    """Whether TMA can address the operands of a B6-B9 launch: x [M, K]
    and the weight ([K, F] or an [E, K, F] stack; int4 packed [.., K/2,
    F]) with 16-byte aligned bases and rows, and the scales the Hopper
    bodies load by TMA (int4's group rows, a grouped stack's rows)."""
    k, f = x.shape[1], w.shape[-1]
    row_bytes = f * (w.element_size() if storage == "dense" else 1)
    ok = (k > 0 and x.data_ptr() % 16 == 0 and k * x.element_size() % 16 == 0
          and w.data_ptr() % 16 == 0 and row_bytes % 16 == 0)
    if scale is not None and (storage == "int4" or scale.dim() == 2):
        ok = ok and scale.data_ptr() % 16 == 0 and f * 4 % 16 == 0
    return ok


def matmul_body(m, dtype, *, aligned, grouped=False) -> str:
    """The body a B6-B9 launch runs: "ffma" (fp32 activations, any
    alignment), "decode" (the split-K body, B6-B8 at <= DECODE_MAX_ROWS
    rows), "prefill" (the wgmma body: more rows, and B9 at any row count)
    or "first" (fp16 / bf16 operands TMA cannot address: `aligned` is
    `tma_ready`)."""
    if dtype == torch.float32:
        return "ffma"
    if not aligned:
        return "first"
    if grouped or m > DECODE_MAX_ROWS:
        return "prefill"
    return "decode"


def decode_split_plan(k, f, *, sms=SM_COUNT) -> tuple[int, int]:
    """(splits, k_chunk) of the decode body for K = k, F = f: K is cut
    into `splits` ranges of k_chunk rows (a multiple of SPLIT_ROWS, so an
    int4 group's scale row lies in one range; the last range may be
    shorter), as many as leave at least two blocks an SM over the
    F / DECODE_TILE_F column tiles where K has the rows for it."""
    groups = -(-k // SPLIT_ROWS)
    tiles = -(-f // DECODE_TILE_F)
    k_chunk = max(1, groups * tiles // (2 * sms)) * SPLIT_ROWS
    return -(-k // k_chunk), k_chunk


def ffma_plan(m, k, f, *, sms=SM_COUNT) -> tuple[int, int, int]:
    """(rows, splits, k_chunk) of the fp32 FFMA body for M = m, K = k,
    F = f: a block owns `rows` x FFMA_TILE_F of y, the fewest of
    FFMA_TILE_ROWS that hold m (128 above that); K is cut into `splits`
    ranges of k_chunk rows (a multiple of SPLIT_ROWS, so an int4 group
    lies in one range; the last range may be shorter, none is empty), as
    many as leave at least two blocks an SM where K has the rows for it
    (decode_split_plan's rule over this body's tiles)."""
    rows = next((r for r in FFMA_TILE_ROWS if r >= m), FFMA_TILE_ROWS[-1])
    tiles = -(-m // rows) * -(-f // FFMA_TILE_F)
    groups = -(-k // SPLIT_ROWS)
    k_chunk = max(1, groups * tiles // (2 * sms)) * SPLIT_ROWS
    return rows, max(1, -(-k // k_chunk)), k_chunk


def _split_args(body, m, k, f, device, stream):
    """(tile rows, splits, k_chunk, workspace, counters) of a B6-B9
    launch: the split bodies' plans and, for more than one split, the
    stream's scratch (one counter per tile)."""
    if body == "ffma":
        rows, splits, k_chunk = ffma_plan(m, k, f)
        tiles = -(-m // rows) * -(-f // FFMA_TILE_F)
    elif body == "decode":
        rows = 0
        splits, k_chunk = decode_split_plan(k, f)
        tiles = -(-f // DECODE_TILE_F)
    else:
        return 0, 1, 0, None, None
    ws, counters = None, None
    if splits > 1:
        ws, counters = _cuda.scratch(device, stream, splits * m * f, tiles)
    return rows, splits, k_chunk, ws, counters


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(kernel, x, w, scale, storage):
    global matmul_first_body_launches, matmul_ffma_launches
    m, k = x.shape
    f = w.shape[1]
    y = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0 or f == 0:
        return y
    body = matmul_body(m, x.dtype, aligned=tma_ready(x, w, storage, scale))
    stream = _cuda.stream_handle(x.device)
    rows, splits, k_chunk, ws, counters = _split_args(body, m, k, f,
                                                      x.device, stream)
    code = _cuda.lib().fa_quant_matmul(
        x.data_ptr(), w.data_ptr(), _ptr(scale), y.data_ptr(), m, k, f,
        _cuda.WEIGHT_CODES[storage], _cuda.DTYPE_CODES[x.dtype],
        BODY_CODES[body], rows, splits, k_chunk, _ptr(ws), _ptr(counters),
        stream)
    _cuda.check(code, kernel)
    matmul_first_body_launches += body == "first"
    matmul_ffma_launches += body == "ffma"
    return y


def _quant_matmul_cuda(x, w_q, w_scale):
    global quant_matmul_launches, quant_matmul_fp32_launches
    _check_cuda("B6", x, w_q=w_q, w_scale=w_scale)
    if w_scale.dtype != torch.float32:
        raise TypeError("B6 takes fp32 scales")
    y = _launch("quant_matmul", x, w_q, w_scale, w_q.dtype)
    quant_matmul_launches += 1
    quant_matmul_fp32_launches += x.dtype == torch.float32
    return y


def _int4_matmul_cuda(x, w_packed, w_scales):
    global int4_matmul_launches, int4_matmul_fp32_launches
    _check_cuda("B7", x, w_packed=w_packed, w_scales=w_scales)
    if w_scales.dtype != torch.float32:
        raise TypeError("B7 takes fp32 scales")
    y = _launch("int4_matmul", x, w_packed, w_scales, "int4")
    int4_matmul_launches += 1
    int4_matmul_fp32_launches += x.dtype == torch.float32
    return y


def _dense_matmul_cuda(x, w):
    global dense_matmul_launches, dense_matmul_fp32_launches
    _check_cuda("B8", x, w=w)
    if w.dtype != x.dtype:
        raise TypeError(f"B8 takes a weight of the activation's dtype "
                        f"({x.dtype}), got {w.dtype}")
    y = _launch("dense_matmul", x, w, None, "dense")
    dense_matmul_launches += 1
    dense_matmul_fp32_launches += x.dtype == torch.float32
    return y


def _dispatch(x, cuda_fn, plain_fn, *args):
    if x.is_cuda:
        return cuda_fn(x, *args)
    if x.device.type == "cpu":
        return plain_fn(x, *args)
    raise ValueError(f"unsupported device {x.device}")


# --- public wrappers -----------------------------------------------------


def quant_matmul(x, w_q, w_scale):
    """y[m, f] = x[m, k] @ (w_q[k, f] * w_scale[f]).

    x: fp16/bf16/fp32; w_q: int8, float8_e4m3fn or
    float8_e5m2; w_scale: fp32 per output channel.
    """
    m, k = x.shape
    k2, f = w_q.shape
    if k != k2 or tuple(w_scale.shape) != (f,):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"w{tuple(w_q.shape)} scale{tuple(w_scale.shape)}")
    if w_q.dtype not in _QMAX:
        raise TypeError(f"w_q must be int8 or fp8, got {w_q.dtype}")
    return _dispatch(x, _quant_matmul_cuda, quant_matmul_plain, w_q,
                     w_scale)


# The JAX package's name from before the kernel took fp8 weights.
int8_matmul = quant_matmul


def int4_matmul(x, w_packed, w_scales):
    """y[m, f] = x[m, k] @ dequant(w_packed, w_scales).

    x: fp16/bf16/fp32 [M, K]; w_packed: int8 [K/2, F];
    w_scales: fp32 [K/INT4_GROUP, F]. K must be a multiple of
    INT4_GROUP.
    """
    m, k = x.shape
    kp2, f = w_packed.shape
    if k != 2 * kp2 or k % INT4_GROUP:
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} packed"
                         f"{tuple(w_packed.shape)} (K % {INT4_GROUP} != 0?)")
    if tuple(w_scales.shape) != (k // INT4_GROUP, f):
        raise ValueError(f"scales {tuple(w_scales.shape)} != "
                         f"({k // INT4_GROUP}, {f})")
    return _dispatch(x, _int4_matmul_cuda, int4_matmul_plain, w_packed,
                     w_scales)


def dense_matmul(x, w):
    """y[m, f] = x[m, k] @ w[k, f], a weight-streaming product with an
    fp32 sum (the JAX package's opt-in skinny-activation path)."""
    m, k = x.shape
    k2, _ = w.shape
    if k != k2:
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"w{tuple(w.shape)}")
    return _dispatch(x, _dense_matmul_cuda, dense_matmul_plain, w)


# --- least work per call -------------------------------------------------


def quant_matmul_cost(m, k, f, x_itemsize=2):
    """(flops, bytes) of B6: x, the one-byte W and the fp32 scales read
    once, y written once."""
    return 2 * m * k * f, (m * k + m * f) * x_itemsize + k * f + 4 * f


def dense_matmul_cost(m, k, f, itemsize=2):
    """(flops, bytes) of B8: x and W read once, y written once."""
    return 2 * m * k * f, (m * k + m * f + k * f) * itemsize


def int4_matmul_cost(m, k, f, x_itemsize=2):
    """(flops, bytes) of B7: the packed bytes (K/2 x F), the group
    scales (K/128 x F fp32), x and y."""
    return (2 * m * k * f,
            (m * k + m * f) * x_itemsize + (k // 2) * f
            + 4 * (k // INT4_GROUP) * f)


# --- quantizers (numpy, as in the JAX package) ---------------------------


def _np32(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, np.float32)


def quantize_weight(w, *, axis_out=-1, dtype=torch.int8):
    """Per-output-channel int8 / fp8 quantization of a 2D weight [K, F]
    (axis_out names the non-contracted axis). Returns (q, scale) as CPU
    tensors: q in `dtype`, scale fp32 [F]."""
    if axis_out not in (-1, 1):
        raise ValueError("weights must be [contract, out]")
    if dtype not in _QMAX:
        raise TypeError(f"dtype must be int8 or fp8, got {dtype}")
    qmax = _QMAX[dtype]
    wf = _np32(w)
    absmax = np.abs(wf).max(axis=0)
    scale = np.maximum(absmax / qmax, 1e-12)
    q = wf / scale[None, :]
    if dtype == torch.int8:
        q = np.clip(np.round(q), -qmax, qmax).astype(np.int8)
        return torch.from_numpy(q), torch.from_numpy(scale)
    # fp8: clip to the finite max, so no NaN / inf code is ever emitted.
    q = torch.from_numpy(np.clip(q, -qmax, qmax)).to(dtype)
    return q, torch.from_numpy(scale)


def quantize_weight_int4(w):
    """Group-wise (INT4_GROUP rows x channel) symmetric int4
    round-to-nearest of a 2D weight [K, F]. Returns (packed int8
    [K/2, F], scales fp32 [K/INT4_GROUP, F]) as CPU tensors; nibbles in
    -7..7."""
    wf = _np32(w)
    k, f = wf.shape
    if k % INT4_GROUP:
        raise ValueError(f"K={k} must be a multiple of {INT4_GROUP}")
    g = wf.reshape(k // INT4_GROUP, INT4_GROUP, f)
    scale = np.maximum(np.abs(g).max(axis=1) / 7.0, 1e-12)
    q = np.clip(np.round(g / scale[:, None, :]), -7, 7).astype(np.int32)
    q = q.reshape(k, f)
    lo = q[0::2] & 0xF
    hi = q[1::2] & 0xF
    packed = ((hi << 4) | lo).astype(np.uint8).view(np.int8)
    return torch.from_numpy(packed), torch.from_numpy(
        scale.astype(np.float32))
