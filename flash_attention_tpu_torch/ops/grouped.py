"""Grouped (ragged) matrix product over expert-sorted rows,
y[i] = x[i] @ w[g(i)] (port of `flash_attention_tpu/ops/grouped.py`).

The dropless MoE path (models/moe.py `moe_mlp_grouped`) sorts each
token's top-k expert choices by expert, so the rows of one expert are
contiguous, and runs one ragged product per expert weight stack.
`group_sizes[e]` counts expert e's rows; the group offsets are
`[0, cumsum(group_sizes)] + base`, and rows outside
`[offsets[0], offsets[E])` come back zero (rows before `base`, rows past
the data).

Three wrappers share one hand-written CUDA kernel, B9
(`csrc/grouped_matmul.cu`), templated over the expert stack's storage:

  * `grouped_matmul`: dense w [E, K, F] in the activation's type;
  * `grouped_quant_matmul`: int8 / fp8 w_q [E, K, F] with fp32 scales
    [E, F] per (expert, output channel);
  * `grouped_int4_matmul`: packed int4 [E, K/2, F] (byte j = logical rows
    2j, low nibble, and 2j + 1, high nibble) with fp32 scales
    [E, K/128, F].

Numerics, as in the JAX kernel: fp32 sums, the output in x's type; an
int8 / fp8 weight is multiplied by its scale in fp32 and rounded to x's
type before the product, an int4 value by its group scale likewise.

A CUDA tensor launches the kernel or raises; a CPU tensor runs the plain
PyTorch version beside each wrapper, which does the kernel's roundings.
The kernel takes fp16 / bf16 activations; the plain versions also take
fp32. The offsets stay on the device: the kernel's grid is sized from M
and F, never from the group sizes. Three devices of the TPU kernel have
no counterpart: its visit plan (`make_visit_plan`, the TPU grid's
schedule), its padding of x and w (the kernel masks its loads) and the
int4 wrapper's even/odd split of x (x is read at full width).
"""

from __future__ import annotations

import torch

from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.quant import _QMAX, widen_scaled
from flash_attention_tpu_torch.ops.quant_matmul import (
    INT4_GROUP,
    _check_cuda,
    _dispatch,
    int4_dequant,
)

# Launches of the B9 kernel (incremented only where it is launched).
grouped_matmul_launches = 0


def _offsets(group_sizes, base=None) -> torch.Tensor:
    """int32 [E + 1]: [0, cumsum(group_sizes)] + base, on group_sizes'
    device. `base` is None, an int or a 0-d tensor."""
    offs = torch.zeros(group_sizes.shape[0] + 1, dtype=torch.int32,
                       device=group_sizes.device)
    offs[1:] = torch.cumsum(group_sizes.to(torch.int32), 0,
                            dtype=torch.int32)
    if base is not None:
        offs = offs + torch.as_tensor(base, dtype=torch.int32,
                                      device=offs.device)
    return offs


# --- plain versions ------------------------------------------------------


def _grouped_plain(x, group_sizes, expert_weight, e, f, base):
    """out[rows of group g] = x[those rows] @ expert_weight(g) (fp32
    sums), every other row zero. expert_weight(g) is expert g's [K, F]
    weight, already in the type the product sees."""
    m = x.shape[0]
    offs = _offsets(group_sizes, base).tolist()
    out = torch.zeros((m, f), dtype=torch.float32, device=x.device)
    for g in range(e):
        lo, hi = max(offs[g], 0), min(offs[g + 1], m)
        if lo < hi:
            out[lo:hi] += x[lo:hi].float() @ expert_weight(g).float()
    return out.to(x.dtype)


def grouped_matmul_plain(x, group_sizes, w, *, base=None):
    """B9 on a dense stack in plain PyTorch."""
    return _grouped_plain(x, group_sizes, lambda g: w[g], w.shape[0],
                          w.shape[2], base)


def grouped_quant_matmul_plain(x, group_sizes, w_q, w_scale, *, base=None):
    """B9 on an int8 / fp8 stack in plain PyTorch: each expert's weight
    times its channel scale in fp32, rounded to x's type."""
    return _grouped_plain(
        x, group_sizes,
        lambda g: widen_scaled(w_q[g], w_scale[g], x.dtype),
        w_q.shape[0], w_q.shape[2], base)


def grouped_int4_matmul_plain(x, group_sizes, w_packed, w_scales, *,
                              base=None):
    """B9 on a packed int4 stack in plain PyTorch: each nibble times its
    group scale in fp32, rounded to x's type."""
    return _grouped_plain(
        x, group_sizes,
        lambda g: int4_dequant(w_packed[g], w_scales[g], x.dtype),
        w_packed.shape[0], w_packed.shape[2], base)


def grouped_matmul_reference(x, group_sizes, w):
    """Exact reference (masked per-expert fp32 accumulation over every
    row), as the JAX package's."""
    m = x.shape[0]
    offs = _offsets(group_sizes).tolist()
    rows = torch.arange(m, device=x.device)
    out = torch.zeros((m, w.shape[2]), dtype=torch.float32, device=x.device)
    for g in range(w.shape[0]):
        keep = (rows >= offs[g]) & (rows < offs[g + 1])
        xg = torch.where(keep[:, None], x.float(), 0.0)
        out = out + xg @ w[g].float()
    return out.to(x.dtype)


# --- kernel launch -------------------------------------------------------


def _grouped_cuda(x, group_sizes, w, scale, base, weight_code):
    global grouped_matmul_launches
    _check_cuda("B9", x, group_sizes=group_sizes, w=w,
                **({} if scale is None else {"scale": scale}))
    if scale is not None and scale.dtype != torch.float32:
        raise TypeError("B9 takes fp32 scales")
    m, k = x.shape
    e, f = w.shape[0], w.shape[2]
    y = torch.empty((m, f), dtype=x.dtype, device=x.device)
    if m == 0 or f == 0:
        return y
    offs = _offsets(group_sizes, base)
    code = _cuda.lib().fa_grouped_matmul(
        x.data_ptr(), w.data_ptr(),
        None if scale is None else scale.data_ptr(), offs.data_ptr(),
        y.data_ptr(), m, k, f, e, weight_code, _cuda.DTYPE_CODES[x.dtype],
        _cuda.stream_handle(x.device))
    _cuda.check(code, "grouped_matmul")
    grouped_matmul_launches += 1
    return y


def _dense_cuda(x, group_sizes, w, *, base=None):
    if w.dtype != x.dtype:
        raise TypeError(f"B9 takes a dense stack of the activation's dtype "
                        f"({x.dtype}), got {w.dtype}")
    return _grouped_cuda(x, group_sizes, w, None, base,
                         _cuda.WEIGHT_CODES["dense"])


def _quant_cuda(x, group_sizes, w_q, w_scale, *, base=None):
    return _grouped_cuda(x, group_sizes, w_q, w_scale, base,
                         _cuda.WEIGHT_CODES[w_q.dtype])


def _int4_cuda(x, group_sizes, w_packed, w_scales, *, base=None):
    return _grouped_cuda(x, group_sizes, w_packed, w_scales, base,
                         _cuda.WEIGHT_CODES["int4"])


# --- public wrappers -----------------------------------------------------


def _check_groups(group_sizes, e):
    if tuple(group_sizes.shape) != (e,):
        raise ValueError(f"group_sizes {tuple(group_sizes.shape)} != ({e},)")


def grouped_matmul(x, group_sizes, w, *, base=None):
    """y[i] = x[i] @ w[g(i)] for rows sorted by group.

    x: [M, K] fp16/bf16 (fp32 on the CPU); group_sizes: [E] int; w:
    [E, K, F] dense; base: optional row offset of group 0 (int or 0-d
    tensor). Rows outside [base, base + sum(group_sizes)) come back 0.
    """
    m, k = x.shape
    e, k2, f = w.shape
    if k != k2 or tuple(group_sizes.shape) != (e,):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"w{tuple(w.shape)} gs{tuple(group_sizes.shape)}")
    return _dispatch(x, lambda *a: _dense_cuda(*a, base=base),
                     lambda *a: grouped_matmul_plain(*a, base=base),
                     group_sizes, w)


def grouped_quant_matmul(x, group_sizes, w_q, w_scale, *, base=None):
    """Grouped product with an int8 / fp8 expert stack: w_q [E, K, F],
    w_scale fp32 [E, F] per (expert, output channel)."""
    m, k = x.shape
    e, k2, f = w_q.shape
    if k != k2 or tuple(w_scale.shape) != (e, f):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} "
                         f"w{tuple(w_q.shape)} s{tuple(w_scale.shape)}")
    if w_q.dtype not in _QMAX:
        raise TypeError(f"w_q must be int8 or fp8, got {w_q.dtype}")
    _check_groups(group_sizes, e)
    return _dispatch(x, lambda *a: _quant_cuda(*a, base=base),
                     lambda *a: grouped_quant_matmul_plain(*a, base=base),
                     group_sizes, w_q, w_scale)


def grouped_int4_matmul(x, group_sizes, w_packed, w_scales, *, base=None):
    """Grouped product with a packed int4 expert stack: w_packed
    [E, K/2, F] row-pair nibbles, w_scales fp32 [E, K/INT4_GROUP, F]. K
    must be a multiple of INT4_GROUP."""
    m, k = x.shape
    e, kp2, f = w_packed.shape
    if k != 2 * kp2 or k % INT4_GROUP:
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} packed"
                         f"{tuple(w_packed.shape)} (K % {INT4_GROUP})")
    if tuple(w_scales.shape) != (e, k // INT4_GROUP, f):
        raise ValueError(f"scales {tuple(w_scales.shape)} != "
                         f"({e}, {k // INT4_GROUP}, {f})")
    _check_groups(group_sizes, e)
    return _dispatch(x, lambda *a: _int4_cuda(*a, base=base),
                     lambda *a: grouped_int4_matmul_plain(*a, base=base),
                     group_sizes, w_packed, w_scales)


# --- least work per call -------------------------------------------------


def grouped_cost(m, k, f, e, storage, x_itemsize=2):
    """(flops, bytes) of B9 for m live rows over e experts that hold a
    row: x read and y written once (m rows), each of those experts'
    weights and scales read once. storage: "dense" (in x's type),
    "int8", "fp8" or "int4"."""
    per_expert = {"dense": k * f * x_itemsize,
                  "int8": k * f + 4 * f, "fp8": k * f + 4 * f,
                  "int4": k * f // 2 + 4 * (k // INT4_GROUP) * f}
    if storage not in per_expert:
        raise ValueError(f"storage must be one of {list(per_expert)}")
    return (2 * m * k * f,
            (m * k + m * f) * x_itemsize + e * per_expert[storage])
