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

Quantized pools hold int8 / fp8 codes with fp32 scales [Hkv, num_pages,
page_size/128, D] (page_size a multiple of 128): the default body widens
each code times its scale in fp32 and rounds it to q's dtype before the
product (the JAX kernel's numerics); `fold_scales` (int8 only) folds the
K scales into q per 128-token block and the V scales into each block's
partial PV sum, so the codes enter the products unscaled.

fp16 / bf16 queries over pools whose page size is a multiple of 16 run
the split body B4 shares with B5 (`decode.decode_body`; sized by
`decode.split_plan` from the table's width and an integer window, never
from values on the card); fp32 queries and other page sizes the first
body. `paged_flash_decode_split_plain` is the split body's algorithm in
plain PyTorch.
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.config import CUDA_HEAD_DIMS, cdiv
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.decode import (
    BODY_CODES,
    SPLIT_ROWS,
    finish_rows,
    flash_decode_plain,
    flash_decode_split_plain,
    _plans,
    hidden,
    launch_plan,
    masked_softmax,
    split_merge_plain,
)
from flash_attention_tpu_torch.ops.quant import (
    QUANT_BLOCK,
    check_quant_cuda,
    dequantize_blocks,
    is_dense,
)

DEFAULT_PAGE_SIZE = 256

# Launches of the B4 kernel (incremented only where it is launched), and
# of those, the launches that took its window-starts branch, those over
# quantized pools, and those of the fold_scales body.
paged_decode_launches = 0
paged_decode_window_launches = 0
paged_decode_quant_launches = 0
paged_decode_fold_launches = 0
# Launches of B4 with an fp32 q (dense fp32 pools or any quantized
# storage; also counted in paged_decode_launches).
paged_decode_fp32_launches = 0
# fp16 / bf16 launches of B4 on the first body (dense pools whose page
# size is not a multiple of 16; also counted in paged_decode_launches).
paged_decode_first_body_launches = 0


def _gather(pool, page_table):
    """[Hkv, P, n, D] pool (pages, or their scale rows) -> [B, Hkv, W*n,
    D] per-sequence caches in the pool's dtype, following each table
    row."""
    hkv, _, n, d = pool.shape
    b, w = page_table.shape
    g = pool[:, page_table.long()]                 # [Hkv, B, W, n, D]
    return g.permute(1, 0, 2, 3, 4).reshape(b, hkv, w * n, d)


def _gather_dequant(pool, scales, page_table, dtype):
    """Gathered codes times their block's scales in fp32, rounded to
    `dtype` (the JAX kernel's dequantization)."""
    codes = _gather(pool, page_table)
    b, hkv, s, d = codes.shape
    return dequantize_blocks(
        codes.reshape(b, hkv, s // QUANT_BLOCK, QUANT_BLOCK, d),
        _gather(scales, page_table), dtype).reshape(b, hkv, s, d)


def _fold_parts(q, kc, vc, ks, vs, scale):
    """The fold_scales body's scores and PV product in plain PyTorch over
    gathered int8 codes kc, vc [B, Hkv, S, D] and scales ks, vs [B, Hkv,
    S/128, D]: per 128-token block, q times the block's K scale row in
    fp32, rounded to q's dtype, against the unscaled codes; each block's
    PV partial (probabilities rounded to q's dtype) times the block's V
    scale row. Returns (scaled scores [B, Hkv, G, S], pv)."""
    b, hq, d = q.shape
    hkv, s = kc.shape[1], kc.shape[2]
    g, nb = hq // hkv, s // QUANT_BLOCK
    qs = (q.float().reshape(b, hkv, g, 1, d) * ks[:, :, None]).to(
        q.dtype).float()                                # [B, Hkv, G, nb, D]
    kb = kc.reshape(b, hkv, nb, QUANT_BLOCK, d)
    sc = torch.einsum("bhgnd,bhntd->bhgnt", qs, kb).reshape(
        b, hkv, g, s) * scale

    def pv(p):
        pb = p.to(q.dtype).float().reshape(b, hkv, g, nb, QUANT_BLOCK)
        part = torch.einsum("bhgnt,bhntd->bhgnd", pb,
                            vc.reshape(b, hkv, nb, QUANT_BLOCK, d))
        return (part * vs[:, :, None]).sum(dim=3)

    return sc, pv


def _fold_plain(q, kc, vc, ks, vs, lengths, *, scale, starts, qpos_spread):
    """The fold_scales body in plain PyTorch (_fold_parts, then the
    masked softmax)."""
    sc, pv = _fold_parts(q, kc, vc, ks, vs, scale)
    p, l, lse = masked_softmax(sc, lengths, starts, qpos_spread)
    return finish_rows(pv(p), l, lse, q.shape, q.dtype, scale, True)


def paged_flash_decode_plain(q, k_pool, v_pool, page_table, lengths, *,
                             scale, starts=None, qpos_spread=1,
                             k_scales=None, v_scales=None,
                             fold_scales=False):
    """B4's function in plain PyTorch: gather the pages, then B5's plain
    version over them (fp32 masked softmax over positions < lengths[b],
    and >= starts[b] + (r % qpos_spread) for row r of each kv head's
    group when window starts are given; probabilities rounded to the
    pools' dtype for the PV product). Quantized pools are dequantized to
    q's dtype as they are gathered, or run the fold_scales body. Returns
    (o [B, Hq, D] in q's dtype, lse [B, Hq] fp32); a row that sees
    nothing gives O = 0 and LSE = INIT_M * scale."""
    kw = dict(scale=scale, starts=starts, qpos_spread=qpos_spread)
    if k_scales is None:
        k, v = _gather(k_pool, page_table), _gather(v_pool, page_table)
    elif fold_scales:
        return _fold_plain(
            q, *(_gather(t, page_table).float()
                 for t in (k_pool, v_pool, k_scales, v_scales)),
            lengths, **kw)
    else:
        k = _gather_dequant(k_pool, k_scales, page_table, q.dtype)
        v = _gather_dequant(v_pool, v_scales, page_table, q.dtype)
    return flash_decode_plain(q, k, v, lengths, return_lse=True, **kw)


def paged_flash_decode_split_plain(q, k_pool, v_pool, page_table, lengths,
                                   *, scale, splits, starts=None,
                                   qpos_spread=1, k_scales=None,
                                   v_scales=None, fold_scales=False):
    """paged_flash_decode_plain computed as the split body computes it:
    the pages gathered (quantized pools dequantized to q's dtype, or the
    fold_scales body), then each of `splits` shares of a sequence's
    visible positions a partial, merged in split order
    (decode.split_merge_plain). Returns (o, lse)."""
    kw = dict(scale=scale, splits=splits, starts=starts,
              qpos_spread=qpos_spread, return_lse=True)
    if k_scales is None:
        k, v = _gather(k_pool, page_table), _gather(v_pool, page_table)
    elif fold_scales:
        sc, pv = _fold_parts(q, *(_gather(t, page_table).float() for t in
                                  (k_pool, v_pool, k_scales, v_scales)),
                             scale)
        return split_merge_plain(
            sc, hidden(sc, lengths, starts, qpos_spread), lengths, starts,
            splits, pv, q.shape, q.dtype, scale, True)
    else:
        k = _gather_dequant(k_pool, k_scales, page_table, q.dtype)
        v = _gather_dequant(v_pool, v_scales, page_table, q.dtype)
    return flash_decode_split_plain(q, k, v, lengths, **kw)


def _check_paged_cuda(q, k_pool, v_pool, page_table, lengths, *, starts,
                      qpos_spread, k_scales, v_scales) -> int:
    """What B4 takes (it launches nothing): an fp16 / bf16 / fp32 q over
    pools of its dtype or over int8 / fp8 codes with fp32 scales, a built
    head dim, int32 tables, one device, contiguous. Returns the storage
    code (csrc/common.cuh)."""
    d = q.shape[-1]
    rows = q.shape[1] // k_pool.shape[0]
    if k_scales is not None:
        if q.dtype not in _cuda.DTYPE_CODES:
            raise TypeError(f"B4 takes an fp16/bf16/fp32 q (got "
                            f"{q.dtype})")
        store = check_quant_cuda("B4", (k_pool, v_pool),
                                 (k_scales, v_scales))
    elif q.dtype not in _cuda.DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"B4 takes fp16/bf16/fp32 q and pools of one "
                        f"dtype (got {q.dtype}, {k_pool.dtype}, "
                        f"{v_pool.dtype})")
    else:
        store = 0
    if d not in CUDA_HEAD_DIMS:
        raise NotImplementedError(
            f"B4 is built for head dims {CUDA_HEAD_DIMS}, got {d}")
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
    dev = q.get_device()   # an int: cheaper to compare than torch.device
    for name, t in tensors:
        if t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return store


def _paged_decode_cuda(q, k_pool, v_pool, page_table, lengths, *, scale,
                       starts=None, qpos_spread=1, k_scales=None,
                       v_scales=None, fold_scales=False, window=None):
    global paged_decode_launches, paged_decode_window_launches
    global paged_decode_quant_launches, paged_decode_fold_launches
    global paged_decode_fp32_launches, paged_decode_first_body_launches
    b, hq, d = q.shape
    hkv, num_pages, page_size, _ = k_pool.shape
    quantized = k_scales is not None
    store = _check_paged_cuda(q, k_pool, v_pool, page_table, lengths,
                              starts=starts, qpos_spread=qpos_spread,
                              k_scales=k_scales, v_scales=v_scales)
    o = torch.empty_like(q)
    lse = q.new_empty((b, hq), dtype=torch.float32)
    if b == 0:
        return o, lse
    stream = _cuda.stream_handle(q.device)
    width = page_table.shape[1]
    # A unit sees at most the table's positions, and under an integer
    # window at most the window.
    span = width * page_size if window is None \
        else min(width * page_size, window)
    key = (q.dtype, b, hq, hkv, page_size, width, d, span, q.get_device(),
           stream)
    plan = _plans.get(key) or launch_plan(
        key, q.dtype, page_size, b * hkv * cdiv(hq // hkv, SPLIT_ROWS), span,
        d, q.device, stream)
    body, splits, ws, counters = plan[:4]
    code = _cuda.lib().fa_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scales.data_ptr() if quantized else None,
        v_scales.data_ptr() if quantized else None,
        page_table.data_ptr(), lengths.data_ptr(),
        None if starts is None else starts.data_ptr(), o.data_ptr(),
        lse.data_ptr(), b, hq, hkv, num_pages, page_size, width, d,
        qpos_spread, scale,
        _cuda.DTYPE_CODES[q.dtype], store, int(fold_scales),
        BODY_CODES[body], splits, ws, counters, stream)
    fp32 = q.dtype == torch.float32
    paged_decode_launches += 1
    paged_decode_window_launches += starts is not None
    paged_decode_quant_launches += quantized
    paged_decode_fold_launches += fold_scales
    paged_decode_fp32_launches += fp32
    paged_decode_first_body_launches += body == "first" and not fp32
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
                       return_lse=False, fold_scales=False):
    """Decode attention over paged KV pools.

    q: [B, Hq, D]; k_pool, v_pool: [Hkv, num_pages, page_size, D];
    page_table: [B, W] int32; lengths: [B] int32 live tokens per
    sequence. `window` makes only positions >= lengths - window visible;
    `window_starts` [B] int32 (may be negative) gives the lowest visible
    position of the first folded query explicitly, overriding `window`.
    `qpos_spread` consecutive query positions may be folded into the
    head dim (t fastest); under a window folded query t's start is
    window_starts + t, without one the fold changes nothing. Pages
    entirely below the window are not read. int8 / fp8 pools come with
    k_scales / v_scales [Hkv, num_pages, page_size/128, D] fp32;
    `fold_scales` (int8 pools only) takes the fold_scales body. Returns
    [B, Hq, D], or (o, lse [B, Hq] fp32) with return_lse.
    """
    quantized = k_scales is not None
    if quantized != (v_scales is not None):
        raise ValueError("k_scales and v_scales must be given together")
    if fold_scales and (not quantized or k_pool.dtype != torch.int8):
        raise ValueError(
            "fold_scales is the int8 fast path: requires int8 pools with "
            "k_scales/v_scales")
    b, hq, d = q.shape
    hkv, num_pages, page_size = k_pool.shape[:3]
    if quantized:
        want = (hkv, num_pages, page_size // QUANT_BLOCK, d)
        if page_size % QUANT_BLOCK:
            raise ValueError(f"page_size must be a multiple of "
                             f"{QUANT_BLOCK}")
        if tuple(k_scales.shape) != want or tuple(v_scales.shape) != want:
            raise ValueError(f"scales must be {want}, got "
                             f"{tuple(k_scales.shape)} / "
                             f"{tuple(v_scales.shape)}")
    elif not (is_dense(k_pool) and is_dense(v_pool)):
        raise TypeError(f"int8 / fp8 pools need k_scales / v_scales (got "
                        f"{k_pool.dtype} / {v_pool.dtype} pools)")
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
    kw = dict(scale=float(scale), starts=starts, qpos_spread=spread,
              k_scales=k_scales, v_scales=v_scales, fold_scales=fold_scales)
    if q.is_cuda:
        o, lse = _paged_decode_cuda(
            q, k_pool, v_pool, page_table, lengths, **kw,
            window=window if window_starts is None else None)
    elif q.device.type == "cpu":
        o, lse = paged_flash_decode_plain(q, k_pool, v_pool, page_table,
                                          lengths, **kw)
    else:
        raise ValueError(f"unsupported device {q.device}")
    return (o, lse) if return_lse else o


def validate_paged_inputs(k_pool, page_table, lengths, *, page_size=None):
    """The guard of the page-table path (JAX `validate_paged_inputs`,
    an opt-in checkify guard there): raises ValueError, with the JAX
    messages, when a page id lies outside [0, num_pages) or a length
    outside [0, W * page_size]. B4 reads `page_table[p]` unchecked and
    the plain gather wraps a negative id, so callers that cannot trust
    their tables call this first; `paged_flash_decode` does not. Takes
    the pool's codes when it is quantized (shape [Hkv, num_pages,
    page_size, D] either way). On the card each check reads back one
    reduced flag."""
    num_pages = k_pool.shape[1]
    ps = page_size or k_pool.shape[2]
    capacity = page_table.shape[1] * ps
    if not bool(((page_table >= 0) & (page_table < num_pages)).all()):
        raise ValueError(f"page_table contains out-of-range page ids "
                         f"(pool has {num_pages} pages)")
    if not bool(((lengths >= 0) & (lengths <= capacity)).all()):
        raise ValueError(f"lengths exceed page-table capacity "
                         f"({capacity} tokens)")


def paged_decode_reference(q, k_pool, v_pool, page_table, lengths, *,
                           k_scales=None, v_scales=None, scale=None,
                           window=None, window_starts=None, qpos_spread=1):
    """Exact fp32 reference: the plain version on fp32 inputs (same
    masks; quantized pools dequantized to fp32), output in q's dtype."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    starts = _window_starts(lengths, window, window_starts)
    if k_scales is not None:
        k = _gather_dequant(k_pool, k_scales, page_table, torch.float32)
        v = _gather_dequant(v_pool, v_scales, page_table, torch.float32)
    else:
        k, v = (_gather(t, page_table).float() for t in (k_pool, v_pool))
    o, _ = flash_decode_plain(
        q.float(), k, v, lengths, scale=float(scale), return_lse=True,
        starts=starts, qpos_spread=qpos_spread if starts is not None else 1)
    return o.to(q.dtype)


def paged_decode_cost(lengths, hq, hkv, d, itemsize, page_size,
                      starts=None, qpos_spread=1, kv_itemsize=None):
    """(flops, bytes) B4 must do at least for these lengths (and window
    starts): each position some row sees has its K and V rows read once
    per kv head and does 4 D FLOPs for each row that sees it; q, the
    table entries of the pages read, the lengths (and starts) read once,
    O and LSE written once. With `kv_itemsize` (1 for int8 / fp8 pools)
    the K/V rows count at that width, plus the fp32 scale row of every
    128-token block that holds a position some row sees."""
    lengths = [int(x) for x in lengths]
    b = len(lengths)
    nbytes = 0 if starts is None else 4 * b
    starts = [0] * b if starts is None else [int(x) for x in starts]
    rows = hq // hkv
    tokens = pages = seen = blocks = 0
    for n, s0 in zip(lengths, starts):
        lo = min(max(s0, 0), n)
        tokens += n - lo
        pages += cdiv(n, page_size) - lo // page_size
        blocks += cdiv(n, QUANT_BLOCK) - lo // QUANT_BLOCK
        seen += sum(max(0, n - max(s0 + r % qpos_spread, 0))
                    for r in range(rows))
    flops = 4 * hkv * seen * d
    kv_bytes = (2 * hkv * tokens * d * itemsize if kv_itemsize is None
                else 2 * hkv * d * (tokens * kv_itemsize + 4 * blocks))
    nbytes += (kv_bytes + 2 * b * hq * d * itemsize + 4 * b * hq
               + 4 * (pages + b))
    return flops, nbytes
