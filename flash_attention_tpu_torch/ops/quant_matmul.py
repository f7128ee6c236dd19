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
The kernel takes fp16 / bf16 activations; the plain versions also take
fp32 (the CPU parity tests run in fp32).

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

# Launches of the B6, B7 and B8 kernels (each incremented only where its
# kernel is launched).
quant_matmul_launches = 0
int4_matmul_launches = 0
dense_matmul_launches = 0


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
    """What the kernel takes: fp16 / bf16 activations, every tensor on
    x's device and contiguous."""
    if x.dtype not in _cuda.DTYPE_CODES:
        raise TypeError(f"{kernel} takes fp16/bf16 activations, got "
                        f"{x.dtype}")
    for name, t in dict(x=x, **tensors).items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _launch(kernel, x, w, scale, weight_code):
    m, k = x.shape
    f = w.shape[1]
    y = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0 or f == 0:
        return y
    code = _cuda.lib().fa_quant_matmul(
        x.data_ptr(), w.data_ptr(),
        None if scale is None else scale.data_ptr(), y.data_ptr(), m, k,
        f, weight_code, _cuda.DTYPE_CODES[x.dtype],
        _cuda.stream_handle(x.device))
    _cuda.check(code, kernel)
    return y


def _quant_matmul_cuda(x, w_q, w_scale):
    global quant_matmul_launches
    _check_cuda("B6", x, w_q=w_q, w_scale=w_scale)
    if w_scale.dtype != torch.float32:
        raise TypeError("B6 takes fp32 scales")
    y = _launch("quant_matmul", x, w_q, w_scale,
                _cuda.WEIGHT_CODES[w_q.dtype])
    quant_matmul_launches += 1
    return y


def _int4_matmul_cuda(x, w_packed, w_scales):
    global int4_matmul_launches
    _check_cuda("B7", x, w_packed=w_packed, w_scales=w_scales)
    if w_scales.dtype != torch.float32:
        raise TypeError("B7 takes fp32 scales")
    y = _launch("int4_matmul", x, w_packed, w_scales,
                _cuda.WEIGHT_CODES["int4"])
    int4_matmul_launches += 1
    return y


def _dense_matmul_cuda(x, w):
    global dense_matmul_launches
    _check_cuda("B8", x, w=w)
    if w.dtype != x.dtype:
        raise TypeError(f"B8 takes a weight of the activation's dtype "
                        f"({x.dtype}), got {w.dtype}")
    y = _launch("dense_matmul", x, w, None, _cuda.WEIGHT_CODES["dense"])
    dense_matmul_launches += 1
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

    x: fp16/bf16 (fp32 on the CPU); w_q: int8, float8_e4m3fn or
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

    x: fp16/bf16 (fp32 on the CPU) [M, K]; w_packed: int8 [K/2, F];
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
