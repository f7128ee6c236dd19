"""B1 on fp32 inputs: the launch plan of its register-blocked FFMA body
(csrc/flash_fwd_f32.cuh over study_f32.cuh's F32Cfg), a twin of the
body's loop held to the JAX kernel, and the port's plain version held to
it at the same edges.

Plan: `_plan` mirrors F32Cfg<D, true> as B1 uses it (4 warps, 64 q rows
a block, 32 at D = 256; K / V slabs of 64 keys through two buffers, P at
a row stride of 68 floats) and `_kv_range` / `_needs_mask` the kernel's
kv range of a q tile and its test for the slabs that take element masks.

Twin: `_twin` runs the body's loop in fp32 on the CPU -- per 64-row q
tile the kv range in whole slabs, masks only on the slabs `_needs_mask`
names, m on raw scores, each slab's P V a partial sum joined as acc =
alpha acc + t, O = acc / l, LSE = m scale + log l -- so a range or mask
test that dropped a hidden column would part from the JAX kernel.

Parity: seeded N(0, 1) numpy inputs go through the JAX package's
`flash_attention_fwd` (Pallas in interpret mode on the CPU,
tests/conftest.py) in fp32, through the twin, and through the port's
`flash_attention_fwd` on CPU tensors (its plain version). Every case
crosses the body's 64-row blocks (32 at D = 256) and 64-key slabs.
Tolerance: max-abs <= 2e-5 on O and LSE (fp32 accumulation-order noise
~1e-6; no relative gate, which is meaningless near zero). A row that
sees nothing must give O = 0 exactly and LSE = INIT_M * scale (relative
1e-6: the scale's rounding).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_tpu.ops.flash import SegmentIds as JSegmentIds
from flash_attention_tpu.ops.flash import flash_attention_fwd as jax_fwd
from flash_attention_tpu_torch.config import b1_tile
from flash_attention_tpu_torch.ops import flash as tflash
from flash_attention_tpu_torch.ops import variants
from flash_attention_tpu_torch.utils.metrics import max_abs_error

ATOL = 2e-5
LOG2E = 1.4426950408889634
SMEM_PER_SM = 233472       # bytes of shared memory an SM holds
SMEM_RESERVED = 1024       # bytes the card reserves of it for each block
THREADS, TX, SLAB, STAGES, LDP = 128, 16, 64, 2, 64 + 4
SPLIT_BULK, SPLIT_BAND = tflash.SPLIT_BULK, tflash.SPLIT_BAND

# Shared bytes a block and blocks an SM by shared memory, as
# flash_fwd_f32.cuh's plan gives them: {D: (q rows, bytes, blocks)}.
PLAN = {32: (64, 41984, 5), 64: (64, 66560, 3), 128: (64, 115712, 2),
        256: (32, 172544, 1)}


def _plan(d):
    """F32Cfg<D, true>: 128 threads as 8 x 16, 8 rows a thread up to D =
    128 (4 at 256); Q [rows, D] and two K / V buffers [64, D] unpadded,
    P [rows, 68]."""
    rows = (THREADS // TX) * (8 if d <= 128 else 4)
    smem = 4 * (rows * d + STAGES * SLAB * d + rows * LDP)
    return dict(rows=rows, smem=smem,
                blocks_per_sm=min(SMEM_PER_SM // (smem + SMEM_RESERVED),
                                  2048 // THREADS))


def _kv_range(q0, rows, nq, nk, causal, offset, window=None, split=0,
              band=0):
    """The kernel's kv range [lo, hi) of the q tile at q0."""
    last = min(q0 + rows, nq) - 1
    lo, hi = 0, nk
    if causal:
        hi = min(nk, last + offset + 1)
    if window:
        lo = max(q0 + offset - window + 1, 0) // SLAB * SLAB
    if split:
        band0 = q0 // band * band
        if split == SPLIT_BULK:
            hi = min(hi, band0)
        else:
            lo, hi = band0, min(hi, band0 + band)
    return lo, hi


def _needs_mask(j0, q0, rows, nq, nk, causal, offset, window, segments):
    """Whether the kernel masks the slab at j0 of the q tile at q0."""
    last = min(q0 + rows, nq) - 1
    return (j0 + SLAB > nk or (causal and j0 + SLAB - 1 > q0 + offset)
            or segments
            or bool(window) and j0 <= last + offset - window)


def _twin(q, k, v, *, causal, offset, window=None, qseg=None, kvseg=None,
          split=0, band=0):
    """The body's loop in fp32 (torch, CPU): (o, lse)."""
    b, hq, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    rows = _plan(d)["rows"]
    scale = d ** -0.5
    c = scale * LOG2E
    kr = k.repeat_interleave(hq // hkv, dim=1)
    vr = v.repeat_interleave(hq // hkv, dim=1)
    o = torch.zeros_like(q)
    lse = torch.zeros(b, hq, nq)
    for q0 in range(0, nq, rows):
        r = torch.arange(q0, min(q0 + rows, nq))
        lo, hi = _kv_range(q0, rows, nq, nk, causal, offset, window, split,
                           band)
        m = torch.full((b, hq, len(r)), tflash.INIT_M)
        l = torch.zeros(b, hq, len(r))
        acc = torch.zeros(b, hq, len(r), d)
        for j0 in range(lo, hi, SLAB):
            col = torch.arange(j0, j0 + SLAB)
            live = col < nk
            kk = torch.zeros(b, hq, SLAB, d)
            vv = torch.zeros(b, hq, SLAB, d)
            kk[:, :, live] = kr[:, :, col[live]]
            vv[:, :, live] = vr[:, :, col[live]]
            s = q[:, :, r] @ kk.transpose(-1, -2)
            if _needs_mask(j0, q0, rows, nq, nk, causal, offset, window,
                           qseg is not None):
                bad = (col[None, :] >= nk).expand(len(r), SLAB)
                if causal:
                    bad = bad | (col[None, :] > r[:, None] + offset)
                if window:
                    bad = bad | (col[None, :] <= r[:, None] + offset - window)
                bad = bad[None, None].expand(b, 1, -1, -1)
                if qseg is not None:
                    kid = torch.full((b, SLAB), -1, dtype=torch.int32)
                    kid[:, live] = kvseg[:, col[live]]
                    bad = bad | (qseg[:, r][:, None, :, None]
                                 != kid[:, None, None, :])
                s = s.masked_fill(bad, -math.inf)
            mx = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2((m - mx) * c)
            p = torch.exp2(s * c - (mx * c)[..., None])
            l = alpha * l + p.sum(-1)
            m = mx
            acc = alpha[..., None] * acc + p @ vv
        seen = l > 0
        o[:, :, r] = torch.where(seen[..., None],
                                 acc / torch.where(seen, l, 1.0)[..., None],
                                 0.0)
        lse[:, :, r] = torch.where(seen, m * scale + torch.log(
            torch.where(seen, l, 1.0)), tflash.INIT_M * scale)
    return o, lse


# --- the plan ----------------------------------------------------------------


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_b1_f32_plan(d):
    """Rows a block, shared bytes and blocks an SM; two blocks an SM by
    shared memory up to D = 128 (at D = 128 exactly the SM's bytes, so
    no byte may be added); the rows are B1's fp32 tile (config.b1_tile,
    what select_block_sizes returns)."""
    plan = _plan(d)
    rows, smem, blocks = PLAN[d]
    assert (plan["rows"], plan["smem"], plan["blocks_per_sm"]) == \
        (rows, smem, blocks)
    assert plan["smem"] <= variants.SMEM_LIMIT
    assert b1_tile(torch.float32, d) == (rows, SLAB)
    if d <= 128:
        assert plan["blocks_per_sm"] >= 2
    if d == 128:
        assert 2 * (smem + SMEM_RESERVED) == SMEM_PER_SM


def test_b1_f32_kv_ranges():
    """Whole slabs from a slab-aligned start; causal to the last real
    row's diagonal at any offset; the window from the first row's oldest
    column rounded down; the split's bulk below the tile's band and band
    pass on it (a tile never straddles two bands); empty ranges."""
    assert _kv_range(0, 64, 2048, 2048, True, 0) == (0, 64)
    assert _kv_range(1984, 64, 2048, 2048, True, 0) == (0, 2048)
    assert _kv_range(64, 64, 77, 131, True, 54) == (0, 131)
    assert _kv_range(0, 64, 130, 200, True, 200) == (0, 200)   # offset Nk
    assert _kv_range(128, 64, 200, 333, True, 133, window=96) == (128, 325)
    assert _kv_range(0, 64, 200, 333, True, 133, window=96) == (0, 197)
    for q0 in range(0, 512, 64):
        lo, hi = _kv_range(q0, 64, 512, 512, False, 0, split=SPLIT_BULK,
                           band=128)
        assert (lo, hi) == (0, q0 // 128 * 128)
        lo, hi = _kv_range(q0, 64, 512, 512, True, 0, split=SPLIT_BAND,
                           band=128)
        assert (lo, hi) == (q0 // 128 * 128, q0 + 64)
        assert lo % SLAB == 0


# --- parity with the JAX kernel ----------------------------------------------

# name: (b, hq, hkv, nq, nk, d, keyword arguments); segment ids by name.
CASES = {
    "window": (1, 4, 2, 200, 333, 64, dict(causal=True, window=96)),
    "segments_dead_row": (2, 4, 2, 200, 200, 64, dict(causal=True)),
    "segments_window": (1, 2, 1, 200, 200, 32, dict(causal=True,
                                                    window=70)),
    "offset_past_nk_minus_nq": (1, 4, 2, 130, 200, 64,
                                dict(causal=True, offset=200,
                                     window=150)),
    "causal_offset_nk": (1, 2, 2, 77, 131, 128, dict(causal=True,
                                                     offset=131)),
    "strict_below": (1, 2, 1, 320, 320, 64, dict(strict_below=128)),
    "diag_band": (1, 2, 1, 256, 256, 64, dict(causal=True, diag_band=128)),
    "gqa_8_1": (1, 8, 1, 150, 150, 64, dict(causal=True)),
    "d256_32_rows": (1, 2, 1, 100, 170, 256, dict(causal=True)),
    "ragged_noncausal": (2, 2, 2, 77, 131, 128, dict()),
    "ragged_causal": (1, 3, 1, 200, 333, 128, dict(causal=True)),
}

# Packed documents: q ids with a document (3) no kv column shares, whose
# rows see nothing.
Q_DOCS = [0] * 70 + [1] * 60 + [3] * 40 + [2] * 30
KV_DOCS = [0] * 70 + [1] * 60 + [2] * 70


def _case(name):
    b, hq, hkv, nq, nk, d, kw = CASES[name]
    rng = np.random.default_rng(len(name))
    q = rng.normal(0, 1.0, (b, hq, nq, d)).astype(np.float32)
    k = rng.normal(0, 1.0, (b, hkv, nk, d)).astype(np.float32)
    v = rng.normal(0, 1.0, (b, hkv, nk, d)).astype(np.float32)
    qseg = kvseg = None
    if name.startswith("segments"):
        qseg = np.tile(np.asarray(Q_DOCS, np.int32), (b, 1))
        kvseg = np.tile(np.asarray(KV_DOCS, np.int32), (b, 1))
    return q, k, v, qseg, kvseg, kw


def _jax(name):
    q, k, v, qseg, kvseg, kw = _case(name)
    seg = None if qseg is None else JSegmentIds(jnp.asarray(qseg),
                                                jnp.asarray(kvseg))
    if "strict_below" in kw or "diag_band" in kw:
        # The split's passes want a tile that divides the band.
        kw = dict(kw, block_sizes=JaxBlockSizes(block_q=64, block_kv=64))
    o, lse = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), seg,
                     **kw)
    return np.asarray(o), np.asarray(lse)[..., 0]


def _assert_close(o, lse, o_j, lse_j, d):
    assert max_abs_error(o, o_j) <= ATOL
    assert max_abs_error(lse, lse_j) <= ATOL
    # Rows that see nothing: O = 0 and LSE = INIT_M * scale exactly.
    dead = lse_j <= tflash.INIT_M / math.sqrt(d) / 2
    if dead.any():
        assert float(np.abs(np.asarray(o)[dead]).max()) == 0.0
        np.testing.assert_allclose(np.asarray(lse)[dead],
                                   tflash.INIT_M / math.sqrt(d), rtol=1e-6)


@pytest.mark.parametrize("name", list(CASES))
def test_b1_f32_twin_matches_jax(name):
    q, k, v, qseg, kvseg, kw = _case(name)
    nq, nk = q.shape[2], k.shape[2]
    causal = kw.get("causal", False)
    split, band = 0, 0
    if "strict_below" in kw:
        split, band = SPLIT_BULK, kw["strict_below"]
    if "diag_band" in kw:
        split, band = SPLIT_BAND, kw["diag_band"]
    offset = kw.get("offset", 0 if split else nk - nq)
    o, lse = _twin(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
                   offset=offset, window=kw.get("window"),
                   qseg=None if qseg is None else torch.from_numpy(qseg),
                   kvseg=None if kvseg is None else torch.from_numpy(kvseg),
                   split=split, band=band)
    o_j, lse_j = _jax(name)
    _assert_close(o, lse, o_j, lse_j, q.shape[-1])
    if name == "segments_dead_row":
        assert (lse_j <= tflash.INIT_M / 8 / 2).sum() == 2 * 4 * 40


@pytest.mark.parametrize("name", list(CASES))
def test_b1_f32_plain_matches_jax(name):
    q, k, v, qseg, kvseg, kw = _case(name)
    seg = None if qseg is None else tflash.SegmentIds(
        torch.from_numpy(qseg), torch.from_numpy(kvseg))
    o, lse = tflash.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), seg, **kw)
    o_j, lse_j = _jax(name)
    _assert_close(o, lse, o_j, lse_j, q.shape[-1])
