"""Paged decode attention (port of `flash_attention_tpu/ops/paged.py`).

`paged_flash_decode` launches the hand-written CUDA kernel
`csrc/paged_decode.cu` (B4, the port of the Pallas `_paged_kernel`) on
CUDA tensors and runs `paged_flash_decode_plain`, the same function in
plain PyTorch, on CPU tensors. A CUDA tensor launches the kernel or
raises.

Pool layout: [Hkv, num_pages, page_size, D]; one page id addresses the
same slot in every head's pool. The page table [B, W] lists each
sequence's pages; entries past its live pages are never read, so the
table width W does not decide how much the kernel reads.
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.config import (
    CUDA_HEAD_DIMS,
    PAGED_MAX_ROWS,
    cdiv,
)
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.decode import flash_decode_plain

DEFAULT_PAGE_SIZE = 256

# Launches of the B4 kernel (incremented only where it is launched), and
# of those, the launches that took its window-starts branch.
paged_decode_launches = 0
paged_decode_window_launches = 0


def _gather(pool, page_table):
    """[Hkv, P, ps, D] pool -> [B, Hkv, W*ps, D] float32 per-sequence
    caches, following each table row."""
    hkv, _, ps, d = pool.shape
    b, w = page_table.shape
    g = pool[:, page_table.long()]                 # [Hkv, B, W, ps, D]
    return g.permute(1, 0, 2, 3, 4).reshape(b, hkv, w * ps, d).float()


def paged_flash_decode_plain(q, k_pool, v_pool, page_table, lengths, *,
                             scale, starts=None, qpos_spread=1):
    """B4's function in plain PyTorch: gather the pages, then B5's plain
    version over them (fp32 masked softmax over positions < lengths[b],
    and >= starts[b] + (r % qpos_spread) for row r of each kv head's
    group when window starts are given; probabilities rounded to the
    input dtype for the PV product). Returns (o [B, Hq, D] in q's dtype,
    lse [B, Hq] fp32); a row that sees nothing gives O = 0 and LSE =
    INIT_M * scale."""
    return flash_decode_plain(q, _gather(k_pool, page_table),
                              _gather(v_pool, page_table), lengths,
                              scale=scale, return_lse=True, starts=starts,
                              qpos_spread=qpos_spread)


def _paged_decode_cuda(q, k_pool, v_pool, page_table, lengths, *, scale,
                       starts=None, qpos_spread=1):
    global paged_decode_launches, paged_decode_window_launches
    b, hq, d = q.shape
    hkv, num_pages, page_size, _ = k_pool.shape
    rows = hq // hkv
    if q.dtype not in _cuda.DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"B4 takes fp16/bf16 q and pools of one dtype "
                        f"(got {q.dtype}, {k_pool.dtype}, {v_pool.dtype})")
    if d not in CUDA_HEAD_DIMS:
        raise NotImplementedError(
            f"B4 is built for head dims {CUDA_HEAD_DIMS}, got {d}")
    if rows > PAGED_MAX_ROWS:
        raise NotImplementedError(
            f"B4 takes at most {PAGED_MAX_ROWS} query rows per kv head "
            f"(GQA group x folded positions), got {rows}")
    if rows % qpos_spread:
        raise ValueError(f"qpos_spread={qpos_spread} must divide the "
                         f"{rows} rows of each kv head")
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("page_table", page_table), ("lengths", lengths)]
    if starts is not None:
        tensors.append(("window_starts", starts))
    if any(t.dtype != torch.int32 for _, t in tensors[3:]):
        raise TypeError("page_table, lengths and window_starts must be "
                        "int32")
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    o = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    if b == 0:
        return o, lse
    code = _cuda.lib().fa_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        page_table.data_ptr(), lengths.data_ptr(),
        None if starts is None else starts.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, num_pages, page_size,
        page_table.shape[1], d, qpos_spread, scale,
        _cuda.DTYPE_CODES[q.dtype], _cuda.stream_handle(q.device))
    paged_decode_launches += 1
    paged_decode_window_launches += starts is not None
    _cuda.check(code, "paged_decode")
    return o, lse


def _window_starts(lengths, window, window_starts):
    """The per-sequence lowest visible stored position of the first
    folded query (raw, possibly negative), or None without a window."""
    if window is not None and window < 1:
        raise ValueError("window must be >= 1")
    if window_starts is not None:
        return torch.as_tensor(window_starts, dtype=torch.int32,
                               device=lengths.device)
    if window is not None:
        return (lengths - window).to(torch.int32)
    return None


def paged_flash_decode(q, k_pool, v_pool, page_table, lengths, *,
                       k_scales=None, v_scales=None, scale=None,
                       window=None, window_starts=None, qpos_spread=1,
                       return_lse=False):
    """Decode attention over paged KV pools.

    q: [B, Hq, D]; k_pool, v_pool: [Hkv, num_pages, page_size, D];
    page_table: [B, W] int32; lengths: [B] int32 live tokens per
    sequence. `window` makes only positions >= lengths - window visible;
    `window_starts` [B] int32 (may be negative) gives the lowest visible
    position of the first folded query explicitly, overriding `window`.
    `qpos_spread` consecutive query positions may be folded into the
    head dim (t fastest); under a window folded query t's start is
    window_starts + t, without one the fold changes nothing. Pages
    entirely below the window are not read. Returns [B, Hq, D], or
    (o, lse [B, Hq] fp32) with return_lse.
    """
    if k_scales is not None or v_scales is not None:
        raise NotImplementedError(
            "quantized pools arrive with the quantized-KV slice")
    b, hq, d = q.shape
    hkv = k_pool.shape[0]
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")
    if qpos_spread > 1 and hq % qpos_spread:
        raise ValueError(f"qpos_spread={qpos_spread} must divide Hq={hq}")
    if page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(
            f"page_table {tuple(page_table.shape)} / lengths "
            f"{tuple(lengths.shape)} do not match batch {b}")
    starts = _window_starts(lengths, window, window_starts)
    spread = qpos_spread if starts is not None else 1
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    kw = dict(scale=float(scale), starts=starts, qpos_spread=spread)
    if q.is_cuda:
        o, lse = _paged_decode_cuda(q, k_pool, v_pool, page_table,
                                    lengths, **kw)
    elif q.device.type == "cpu":
        o, lse = paged_flash_decode_plain(q, k_pool, v_pool, page_table,
                                          lengths, **kw)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return (o, lse) if return_lse else o


def paged_decode_reference(q, k_pool, v_pool, page_table, lengths, *,
                           scale=None, window=None, window_starts=None,
                           qpos_spread=1):
    """Exact fp32 reference: the plain version on fp32 inputs (same
    masks), output in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    starts = _window_starts(lengths, window, window_starts)
    o, _ = paged_flash_decode_plain(
        q.float(), k_pool.float(), v_pool.float(), page_table, lengths,
        scale=float(scale), starts=starts,
        qpos_spread=qpos_spread if starts is not None else 1)
    return o.to(q.dtype)


def paged_decode_cost(lengths, hq, hkv, d, itemsize, page_size,
                      starts=None, qpos_spread=1):
    """(flops, bytes) B4 must do at least for these lengths (and window
    starts): each position some row sees has its K and V rows read once
    per kv head and does 4 D FLOPs for each row that sees it; q, the
    table entries of the pages read, the lengths (and starts) read once,
    O and LSE written once."""
    lengths = [int(x) for x in lengths]
    b = len(lengths)
    nbytes = 0 if starts is None else 4 * b
    starts = [0] * b if starts is None else [int(x) for x in starts]
    rows = hq // hkv
    tokens = pages = seen = 0
    for n, s0 in zip(lengths, starts):
        lo = min(max(s0, 0), n)
        tokens += n - lo
        pages += cdiv(n, page_size) - lo // page_size
        seen += sum(max(0, n - max(s0 + r % qpos_spread, 0))
                    for r in range(rows))
    flops = 4 * hkv * seen * d
    nbytes += (2 * hkv * tokens * d * itemsize + 2 * b * hq * d * itemsize
               + 4 * b * hq + 4 * (pages + b))
    return flops, nbytes
