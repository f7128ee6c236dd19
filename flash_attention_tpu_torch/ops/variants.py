"""Kernel-study variants: FA1-style, FA2 in-loop normalization, naive
(port of `flash_attention_tpu/ops/variants.py`).

The reference project is a kernel study: several implementations of one
attention forward, benchmarked against each other. Each variant here
launches a hand-written CUDA kernel on CUDA tensors and runs its plain
PyTorch version on CPU tensors (no fallback between the two):

  * `flash_attention_fa1` (B10a, `csrc/variants_fa1.cu`): the FA1
    recurrence `l_new = e^{m_old-m_new} l_old + e^{m~-m_new} l~` with
    P~ taken against the tile max m~ and one final `O / l`; returns
    (o, m, l) with m and l as separate fp32 [B, H, Nq] tensors (the JAX
    kernel's lane-replicated [..., 128] layout is a TPU device). The
    tile comes from the FA1 tile law on an element budget `m_budget`
    (`fa1_tile_sizes` gives the JAX package's lane-rounded tiles;
    `fa1_kernel_tile` the pair this port compiles for Hopper).
  * `flash_attention_fa2_inloop` (B10b, `csrc/variants_fa2.cu`): the
    accumulator kept normalized inside the loop, `acc = acc*alpha +
    pv*beta` with `alpha = l_i e^{m_i-m_ij} / l_ij`, `beta = 1 / l_ij`;
    causal (offset Nk - Nq) and GQA.
  * `naive_attention_pallas` (B10c, `csrc/variants_naive.cu`): exact
    two-pass softmax, every K tile read twice on purpose (the name is
    the JAX package's).

Tiles (`config.BlockSizes`): on the card each kernel takes only the
tiles it was compiled for and raises ValueError naming them; on the CPU
the plain versions tile K/V by `block_kv` (clamped to the lane-rounded
length, as the JAX kernels clamp) so that they repeat the kernel's
recurrence tile by tile. All variants are forward-only study kernels.
"""

from __future__ import annotations

import math

import torch

from flash_attention_tpu_torch.config import LANES, cdiv, round_up
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.flash import (
    INIT_M,
    _check_cuda_inputs,
    fwd_cost,
)

__all__ = [
    "fa1_tile_sizes",
    "fa1_kernel_tile",
    "flash_attention_fa1",
    "flash_attention_fa2_inloop",
    "naive_attention_pallas",
]

# Launches of B10a, B10b and B10c (each incremented only where its
# kernel is launched).
fa1_launches = 0
fa2_inloop_launches = 0
naive_launches = 0
# Launches of B10a's 16 x 16 fp16 / bf16 body (csrc/study_sm80.cuh; also
# counted in fa1_launches).
fa1_tile16_launches = 0
# Launches of B10a, B10b and B10c on fp32 inputs, the register-blocked
# FFMA body of csrc/study_f32.cuh (also counted in each kernel's total).
study_f32_launches = 0

# The (block_q, block_kv) pairs csrc/variants_fa1.cu instantiates: for
# fp16 / bf16 16 x 16 on the mma.sync body (csrc/study_sm80.cuh) and 64 x
# 64 on the Hopper body (csrc/study_sm90.cuh), at every head dim; for fp32
# both on csrc/study_f32.cuh, 64 x 64 only up to D = 128 (the set the
# first fp32 body's shared memory allowed, kept).
FA1_TILES = ((16, 16), (64, 64))
SMEM_LIMIT = 232448        # bytes of shared memory a block may use


def _fp32_above_128(dtype, head_dim: int) -> bool:
    """fp32 at D > 128: no 64 x 64 B10a, 32 x 64 B10b / B10c."""
    return dtype.itemsize == 4 and head_dim > 128


def fa1_compiled_tiles(dtype, head_dim: int) -> list[tuple[int, int]]:
    """The FA1 tiles the card has for this dtype and head dim."""
    return [(16, 16)] if _fp32_above_128(dtype, head_dim) else list(FA1_TILES)


def study_tile(dtype, head_dim: int) -> tuple[int, int]:
    """The one tile B10b and B10c are compiled for (csrc/study.cuh
    DefaultTile): 64 x 64, or 32 x 64 for fp32 at D = 256. It is the
    block the wrapper requires to divide Nq and Nk, as the JAX kernels
    require theirs."""
    return (32, 64) if _fp32_above_128(dtype, head_dim) else (64, 64)


def fa1_law(m_budget_elems: int, head_dim: int) -> tuple[int, int]:
    """The raw FA1 tile law: Bc = ceil(M / 4d), Br = min(Bc, d)
    (flashAttention.cu:17-18)."""
    bc = cdiv(m_budget_elems, 4 * head_dim)
    return min(bc, head_dim), bc


def fa1_tile_sizes(m_budget_elems: int, head_dim: int) -> tuple[int, int]:
    """The JAX package's FA1 tiles: the raw law rounded up to lane
    multiples (the TPU's granularity), at least one lane each."""
    br, bc = fa1_law(m_budget_elems, head_dim)
    return max(round_up(br, LANES), LANES), max(round_up(bc, LANES), LANES)


def fa1_kernel_tile(m_budget_elems: int, head_dim: int,
                    dtype) -> tuple[int, int]:
    """The tile B10a takes for an element budget: the smallest compiled
    pair that covers the raw law in both dims (the port's rounding up,
    as the JAX package rounds up to lanes), or, when none does, the
    largest compiled pair that fits shared memory at this D and dtype."""
    br, bc = fa1_law(m_budget_elems, head_dim)
    tiles = fa1_compiled_tiles(dtype, head_dim)
    covering = [t for t in tiles if t[0] >= br and t[1] >= bc]
    if covering:
        return min(covering, key=lambda t: t[0] * t[1])
    return max(tiles, key=lambda t: t[0] * t[1])


def study_cost(batch, hq, hkv, nq, nk, d, causal, itemsize, *,
               stats: int = 0):
    """(flops, bytes) the study kernels' function needs at least: 4 D
    FLOPs per visible (row, col) pair; q and the kv rows seen read once,
    O written once, plus `stats` fp32 values per row (FA1's m and l)."""
    flops, nbytes = fwd_cost(batch, hq, hkv, nq, nk, d, causal, itemsize)
    return flops, nbytes + 4 * batch * hq * nq * (stats - 1)


def _card_tile(kernel, dtype, d, block_sizes, compiled):
    if block_sizes is None:
        return max(compiled, key=lambda t: t[0] * t[1])
    tile = (block_sizes.block_q, block_sizes.block_kv)
    if tile not in compiled:
        raise ValueError(
            f"{kernel} on the card is compiled for (block_q, block_kv) in "
            f"{compiled} at head dim {d} and {dtype}; got {tile}")
    return tile


def _cpu_tile(block_sizes, default, nq, nk):
    """The JAX kernels' clamp of a tile to the lane-rounded lengths."""
    if block_sizes is None:
        return default
    return (min(block_sizes.block_q, round_up(nq, LANES)),
            min(block_sizes.block_kv, round_up(nk, LANES)))


def _acc_dtype(q):
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _kv_tiles(k, v, block_kv, group, acc):
    """(j0, k tile, v tile) over the kv rows, heads expanded to q's."""
    for j0 in range(0, k.shape[2], block_kv):
        kt = k[:, :, j0:j0 + block_kv]
        vt = v[:, :, j0:j0 + block_kv]
        yield (j0, torch.repeat_interleave(kt, group, dim=1).to(acc),
               torch.repeat_interleave(vt, group, dim=1))


def _check(q, k, v, mha_only, name):
    batch, hq, _, d = q.shape
    if k.shape[0] != batch or k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)}")
    hkv = k.shape[1]
    if mha_only and hq != hkv:
        raise ValueError(f"{name} study kernel is MHA-only (Hq == Hkv); "
                         f"got Hq={hq}, Hkv={hkv}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} must be a multiple of Hkv={hkv}")


def _scale(scale, d):
    scale = 1.0 / math.sqrt(d) if scale is None else float(scale)
    if scale <= 0:
        raise ValueError("softmax scale must be positive")
    return scale


# ---------------------------------------------------------------------------
# B10a: FA1-style forward (separate m / l outputs, deferred normalization)
# ---------------------------------------------------------------------------


def flash_attention_fa1_plain(q, k, v, *, scale, block_kv):
    """B10a's function in plain PyTorch, K/V tiled by `block_kv` (the
    last tile ragged): per tile P~ = exp(S - m~) against the tile max,
    l~ = rowsum P~, then m / l / acc by the FA1 recurrence, P~ rounded
    to v's dtype for the PV product; O = acc / l (l == 0 read as 1).
    Returns (o, m, l), m and l fp32 [B, H, Nq], m in scaled units."""
    acc_t = _acc_dtype(q)
    batch, h, nq, d = q.shape
    qf = q.to(acc_t)
    m = torch.full((batch, h, nq), INIT_M, dtype=acc_t, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, h, nq, d), dtype=acc_t, device=q.device)
    for _, kt, vt in _kv_tiles(k, v, block_kv, 1, acc_t):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        m_t = s.amax(dim=-1)
        p = torch.exp(s - m_t[..., None])
        l_t = p.sum(dim=-1)
        m_new = torch.maximum(m, m_t)
        alpha = torch.exp(m - m_new)
        beta = torch.exp(m_t - m_new)
        l = alpha * l + beta * l_t
        m = m_new
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc_t),
                          vt.to(acc_t))
        acc = acc * alpha[..., None] + beta[..., None] * pv
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    o = (acc / l_safe[..., None]).to(q.dtype)
    return o, m.float(), l.float()


def _fa1_cuda(q, k, v, *, scale, tile):
    global fa1_launches, fa1_tile16_launches, study_f32_launches
    _check_cuda_inputs("B10a", q, k, v)
    batch, h, nq, d = q.shape
    nk = k.shape[2]
    o = torch.empty_like(q)
    m = torch.empty((batch, h, nq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if batch * h * nq == 0:
        return o, m, l
    code = _cuda.lib().fa_fa1_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        m.data_ptr(), l.data_ptr(), batch, h, nq, nk, d, tile[0], tile[1],
        scale, _cuda.DTYPE_CODES[q.dtype],
        _cuda.stream_handle(q.device))
    fa1_launches += 1
    # fa_fa1_fwd routes (fp16 / bf16, 16, 16) to the mma.sync body.
    fa1_tile16_launches += q.dtype.itemsize == 2 and tuple(tile) == (16, 16)
    study_f32_launches += q.dtype == torch.float32
    _cuda.check(code, "fa1_fwd")
    return o, m, l


def flash_attention_fa1(q, k, v, *, scale=None, block_sizes=None,
                        m_budget=None):
    """FA1-style non-causal forward (B10a). Returns (o, m, l) with m and
    l separate fp32 [B, H, Nq] stats (the reference's split-stat
    contract). MHA only (Hq != Hkv raises ValueError); ragged Nq and Nk
    are masked. `m_budget` (elements) picks the tile by the FA1 tile law
    (`fa1_kernel_tile`) instead of `block_sizes` or the default (the
    largest compiled tile)."""
    _check(q, k, v, True, "fa1")
    d = q.shape[-1]
    scale = _scale(scale, d)
    compiled = fa1_compiled_tiles(q.dtype, d)
    if m_budget is not None:
        tile = fa1_kernel_tile(m_budget, d, q.dtype)
    elif q.is_cuda:
        tile = _card_tile("fa1", q.dtype, d, block_sizes, compiled)
    else:
        tile = _cpu_tile(block_sizes, max(compiled,
                                          key=lambda t: t[0] * t[1]),
                         q.shape[2], k.shape[2])
    if q.is_cuda:
        return _fa1_cuda(q, k, v, scale=scale, tile=tile)
    if q.device.type == "cpu":
        return flash_attention_fa1_plain(q, k, v, scale=scale,
                                         block_kv=tile[1])
    raise ValueError(f"unsupported device {q.device}")


# ---------------------------------------------------------------------------
# B10b: FA2 in-loop normalization
# ---------------------------------------------------------------------------


def flash_attention_fa2_inloop_plain(q, k, v, *, causal, scale, block_kv):
    """B10b's function in plain PyTorch, K/V tiled by `block_kv`: per
    tile m_ij = max(m_i, rowmax S), P = exp(S - m_ij), l_ij = l_i
    e^{m_i - m_ij} + rowsum P, acc = acc * (l_i e^{m_i - m_ij} / l_ij) +
    (P V) / l_ij (l_ij == 0 read as 1), P rounded to v's dtype for the
    PV product; no final division. Causal hides col > row + Nk - Nq.
    GQA: q head h reads kv head h // (Hq // Hkv)."""
    acc_t = _acc_dtype(q)
    batch, hq, nq, d = q.shape
    group = hq // k.shape[1]
    offset = k.shape[2] - nq
    qf = q.to(acc_t)
    m = torch.full((batch, hq, nq), INIT_M, dtype=acc_t, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, hq, nq, d), dtype=acc_t, device=q.device)
    row = torch.arange(nq, device=q.device)[:, None]
    for j0, kt, vt in _kv_tiles(k, v, block_kv, group, acc_t):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        if causal:
            col = j0 + torch.arange(kt.shape[2], device=q.device)[None, :]
            s = s.masked_fill(col > row + offset, float("-inf"))
        m_ij = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_ij[..., None])
        carry = l * torch.exp(m - m_ij)
        l_ij = carry + p.sum(dim=-1)
        l_safe = torch.where(l_ij == 0, torch.ones_like(l_ij), l_ij)
        pv = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc_t),
                          vt.to(acc_t))
        acc = acc * (carry / l_safe)[..., None] + pv * (1.0 / l_safe)[..., None]
        m, l = m_ij, l_ij
    return acc.to(q.dtype)


def _fa2_cuda(q, k, v, *, causal, scale, tile):
    global fa2_inloop_launches, study_f32_launches
    _check_cuda_inputs("B10b", q, k, v)
    batch, hq, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if batch * hq * nq == 0:
        return o
    code = _cuda.lib().fa_fa2_inloop_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), batch, hq,
        hkv, nq, nk, d, tile[0], tile[1], int(causal), scale,
        _cuda.DTYPE_CODES[q.dtype], _cuda.stream_handle(q.device))
    fa2_inloop_launches += 1
    study_f32_launches += q.dtype == torch.float32
    _cuda.check(code, "fa2_inloop_fwd")
    return o


def flash_attention_fa2_inloop(q, k, v, *, causal=False, scale=None,
                               block_sizes=None):
    """FA2-paper in-loop-normalized forward (B10b). Causal visibility is
    col <= row + Nk - Nq; GQA. The tile must divide Nq and Nk (ValueError
    otherwise, as in the JAX kernel)."""
    _check(q, k, v, False, "fa2_inloop")
    nq, d = q.shape[2], q.shape[3]
    nk = k.shape[2]
    scale = _scale(scale, d)
    default = study_tile(q.dtype, d)
    if q.is_cuda:
        tile = _card_tile("fa2_inloop", q.dtype, d, block_sizes, [default])
    else:
        tile = _cpu_tile(block_sizes, default, nq, nk)
    if nq % tile[0] or nk % tile[1]:
        raise ValueError("fa2_inloop study kernel requires block-divisible "
                         f"shapes, got nq={nq} nk={nk} block_q={tile[0]} "
                         f"block_kv={tile[1]}")
    if q.is_cuda:
        return _fa2_cuda(q, k, v, causal=causal, scale=scale, tile=tile)
    if q.device.type == "cpu":
        return flash_attention_fa2_inloop_plain(q, k, v, causal=causal,
                                                scale=scale,
                                                block_kv=tile[1])
    raise ValueError(f"unsupported device {q.device}")


# ---------------------------------------------------------------------------
# B10c: naive two-pass softmax
# ---------------------------------------------------------------------------


def naive_attention_plain(q, k, v, *, scale, block_kv):
    """B10c's function in plain PyTorch, K/V tiled by `block_kv`: pass 1
    sweeps every K tile for the row max m, pass 2 sweeps K and V again
    for P = exp(S - m), l = rowsum P and acc += P V (P rounded to v's
    dtype); O = acc / l."""
    acc_t = _acc_dtype(q)
    batch, h, nq, d = q.shape
    qf = q.to(acc_t)
    m = torch.full((batch, h, nq), INIT_M, dtype=acc_t, device=q.device)
    for _, kt, _ in _kv_tiles(k, v, block_kv, 1, acc_t):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        m = torch.maximum(m, s.amax(dim=-1))
    l = torch.zeros_like(m)
    acc = torch.zeros((batch, h, nq, d), dtype=acc_t, device=q.device)
    for _, kt, vt in _kv_tiles(k, v, block_kv, 1, acc_t):
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) * scale
        p = torch.exp(s - m[..., None])
        l = l + p.sum(dim=-1)
        acc = acc + torch.einsum("bhqk,bhkd->bhqd",
                                 p.to(v.dtype).to(acc_t), vt.to(acc_t))
    return (acc / l[..., None]).to(q.dtype)


def _naive_cuda(q, k, v, *, scale, tile):
    global naive_launches, study_f32_launches
    _check_cuda_inputs("B10c", q, k, v)
    batch, h, nq, d = q.shape
    nk = k.shape[2]
    o = torch.empty_like(q)
    if batch * h * nq == 0:
        return o
    code = _cuda.lib().fa_naive_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), batch, h,
        nq, nk, d, tile[0], tile[1], scale, _cuda.DTYPE_CODES[q.dtype],
        _cuda.stream_handle(q.device))
    naive_launches += 1
    study_f32_launches += q.dtype == torch.float32
    _cuda.check(code, "naive_fwd")
    return o


def naive_attention_pallas(q, k, v, *, scale=None, block_sizes=None):
    """Exact two-pass attention as a kernel (B10c): sweep all K once for
    the row max, then K and V again for exp / sum / PV, reading every K
    tile twice. Non-causal, MHA only; the tile must divide Nq and Nk."""
    _check(q, k, v, True, "naive")
    nq, d = q.shape[2], q.shape[3]
    nk = k.shape[2]
    scale = _scale(scale, d)
    default = study_tile(q.dtype, d)
    if q.is_cuda:
        tile = _card_tile("naive", q.dtype, d, block_sizes, [default])
    else:
        tile = _cpu_tile(block_sizes, default, nq, nk)
    if nq % tile[0] or nk % tile[1]:
        raise ValueError("naive study kernel requires block-divisible "
                         "shapes")
    if q.is_cuda:
        return _naive_cuda(q, k, v, scale=scale, tile=tile)
    if q.device.type == "cpu":
        return naive_attention_plain(q, k, v, scale=scale, block_kv=tile[1])
    raise ValueError(f"unsupported device {q.device}")

