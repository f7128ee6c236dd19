"""B2 / B3 on fp32 inputs: the plain backward against the JAX package at
shapes that cross the edges of the card's fp32 body
(csrc/flash_bwd_f32.cuh: 64 resident q rows in B2, 64 kv rows in B3,
32 of either at D = 256, streamed tiles of 16 rows), that body's launch
plan, and its loop ranges against the JAX grid's block predicates.

Parity: seeded numpy inputs (N(0, 0.02^2), cotangent N(0, 1)) go through
jax.grad of the JAX `flash_attention` (its custom_vjp, Pallas in
interpret mode on the CPU, 128 blocks) and through the port's
`flash_attention_fwd_plain` then `flash_attention_bwd_plain` on fp32 CPU
tensors. Tolerance: max-abs <= 2e-5 on dq, dk and dv (gradients of order
0.1; fp32 accumulation-order noise here is ~1e-7), as in
tests/test_torch_flash_bwd_masks.py.

Ranges: for each resident tile (64 rows, 32 at D = 256), the streamed
tiles the body visits (`_kv_range`, `_q_tiles` below, mirrored from
the kernels' loops) are exactly those for which
`_block_runs` (flash_attention_tpu/ops/flash.py:122), the predicate the
JAX backward's grids and its first_valid_iq / last_window_iq index maps
are built on, says the pair of blocks runs, at the body's block sizes;
where Nq or Nk is ragged they are a subset that still holds every
visible pair.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.config import BlockSizes
from flash_attention_tpu.ops.flash import SegmentIds as JaxSegmentIds
from flash_attention_tpu.ops.flash import _block_runs
from flash_attention_tpu.ops.flash import flash_attention as jax_flash
from flash_attention_tpu_torch.ops import flash as tflash
from flash_attention_tpu_torch.utils.metrics import max_abs_error

ATOL = 2e-5
BLOCKS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128,
                    block_kv_dq=128, block_q_dkv=128, block_kv_dkv=128)
# B2 / B3's fp32 body (csrc/flash_bwd_f32.cuh): 4 warps a block over
# resident rows, the other side streamed in tiles of 16 rows.
THREADS = 128
STREAM = 16
SMEM_PER_SM = 233472       # bytes of shared memory an SM holds
SMEM_RESERVED = 1024       # bytes the card reserves of it for each block


def _plan(d):
    """The fp32 body's launch plan at head dim d, mirroring DqCfg /
    DkvCfg / AccTile: resident rows (q rows in B2, kv rows in B3; 64, 32
    at D = 256), threads, the accumulator's micro-tile (rows x columns a
    thread), shared bytes a block, and the warps an SM holds (its shared
    memory, less 1 KB reserved a block, and the launch bound's blocks: 2
    below D = 256, 1 at D = 256)."""
    ld = d + 4
    min_blocks = 1 if d > 128 else 2
    rows = 32 if d > 128 else 64

    def kind(nv, fixed):
        tx = d // (4 * nv)
        smem = 4 * (2 * rows * ld + 2 * 2 * STREAM * ld) + fixed
        blocks = min(SMEM_PER_SM // (smem + SMEM_RESERVED), min_blocks)
        return dict(rows=rows, threads=THREADS, stream=STREAM,
                    micro_tile=(rows // (THREADS // tx), 4 * nv),
                    smem=smem, resident_warps=blocks * THREADS // 32)

    nv = 2 if d >= 128 else 1
    return dict(dq=kind(nv, 4 * rows * (STREAM + 4) + 4 * 2 * STREAM),
                dkv=kind(nv, 2 * 4 * rows * (STREAM + 4)
                         + 4 * 2 * 3 * STREAM))


def _kv_range(q0, rows, nq, nk, *, causal, offset, window=None):
    """B2's fp32 kv loop for the q tile of `rows` q rows at q0: [begin,
    end) in keys, run in tiles of 16 from begin (the first tile inside
    the first row's window) to the last real row's causal limit."""
    end = min(nk, min(q0 + rows, nq) - 1 + offset + 1) if causal else nk
    begin = (max(q0 + offset - window + 1, 0) // STREAM * STREAM
             if window else 0)
    return begin, end


def _q_tiles(j0, rows, nq, nk, *, causal, offset, window=None):
    """B3's fp32 q loop for the kv tile at j0 of `rows` kv rows: the q
    tiles of 16 [first, end), from the first that sees column j0 to the
    last whose window still reaches the tile's last column."""
    n_tiles = -(-nq // STREAM)
    first = max(j0 - offset, 0) // STREAM if causal else 0
    end = n_tiles
    if window:
        last_q = min(j0 + rows, nk) - 1 - offset + window - 1
        end = 0 if last_q < 0 else min(n_tiles, last_q // STREAM + 1)
    return first, end


def _inputs(seed, b, hq, hkv, nq, nk, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 0.02, (b, hq, nq, d)).astype(np.float32)
    k = rng.normal(0, 0.02, (b, hkv, nk, d)).astype(np.float32)
    v = rng.normal(0, 0.02, (b, hkv, nk, d)).astype(np.float32)
    ct = rng.normal(0, 1.0, (b, hq, nq, d)).astype(np.float32)
    return q, k, v, ct


def _segments(nq, nk, cuts_q, cuts_kv):
    q = np.searchsorted(np.array(cuts_q), np.arange(nq), side="right")
    kv = np.searchsorted(np.array(cuts_kv), np.arange(nk), side="right")
    return q[None].astype(np.int32), kv[None].astype(np.int32)


# (batch, hq, hkv, nq, nk, d, mask kwargs, segment cuts or None). Nq / Nk
# cut the 16-row streamed tiles and the 64 (32) row resident tiles.
CASES = {
    "dense_gqa_77x131": (1, 4, 2, 77, 131, 64, dict(causal=False), None),
    "causal_offset_54": (1, 2, 1, 77, 131, 64, dict(causal=True), None),
    "causal_d256_ragged": (1, 2, 2, 45, 45, 256, dict(causal=True), None),
    "window_40_d32": (1, 2, 2, 150, 150, 32, dict(causal=True, window=40),
                      None),
    "segments_window": (1, 2, 1, 100, 100, 128,
                        dict(causal=True, window=70), ((37, 70), (37, 70))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_fp32_bwd_plain_matches_jax(name):
    b, hq, hkv, nq, nk, d, kw, cuts = CASES[name]
    q, k, v, ct = _inputs(len(name), b, hq, hkv, nq, nk, d)
    segs = None if cuts is None else _segments(nq, nk, *cuts)
    jseg = None if segs is None else JaxSegmentIds(
        *(jnp.asarray(s) for s in segs))

    def jloss(q, k, v):
        return jnp.sum(jax_flash(q, k, v, jseg, block_sizes=BLOCKS, **kw)
                       * ct)

    gj = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    tseg = None if segs is None else tflash.SegmentIds(
        *(torch.from_numpy(s) for s in segs))
    qt, kt, vt, dot = (torch.from_numpy(x) for x in (q, k, v, ct))
    sc = d ** -0.5
    o, lse = tflash.flash_attention_fwd_plain(
        qt, kt, vt, scale=sc, offset=nk - nq, segment_ids=tseg, **kw)
    gt = tflash.flash_attention_bwd_plain(
        qt, kt, vt, o, lse, dot, scale=sc, offset=nk - nq,
        segment_ids=tseg, **kw)
    for gname, a, ref in zip(("dq", "dk", "dv"), gt, gj):
        ref = np.asarray(ref)
        assert a.dtype == torch.float32 and a.shape == ref.shape, gname
        assert max_abs_error(a, ref) <= ATOL, gname


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_fp32_bwd_plan(d):
    """Rows, threads, micro-tiles, shared bytes and resident warps of the
    fp32 body (DqCfg / DkvCfg / AccTile in csrc/flash_bwd_f32.cuh): 4
    warps a block over 64 rows (32 at D = 256), 16-row streamed tiles,
    within 232,448 bytes a block, and at least 8 warps resident an SM at
    D <= 128, 4 at D = 256."""
    plan = _plan(d)
    dq, dkv = plan["dq"], plan["dkv"]
    assert dq["threads"] == dkv["threads"] == 128
    assert dq["stream"] == dkv["stream"] == STREAM == 16
    assert dq["rows"] == dkv["rows"] == (32 if d == 256 else 64)
    for kind in (dq, dkv):
        assert kind["smem"] <= 232448
        assert kind["resident_warps"] >= (4 if d == 256 else 8)
        mr, nc = kind["micro_tile"]
        assert mr * nc * kind["threads"] == kind["rows"] * d
    # The accumulators' micro-tiles: 8 x 8 at D = 128 and 256 (dQ; dK
    # and dV, one pass: 32 resident rows at D = 256).
    want = {32: ((4, 4), (4, 4)), 64: ((8, 4), (8, 4)),
            128: ((8, 8), (8, 8)), 256: ((8, 8), (8, 8))}[d]
    assert (dq["micro_tile"], dkv["micro_tile"]) == want
    # The byte counts the source note gives.
    assert (dq["smem"], dkv["smem"]) == {
        32: (32896, 38272), 64: (57472, 62848), 128: (106624, 112000),
        256: (135808, 138624)}[d]


# (nq, nk, causal, offset, window)
RANGE_CASES = [
    (256, 256, False, 0, None),
    (256, 256, True, 0, None),
    (128, 320, True, 192, None),
    (256, 256, True, 0, 40),
    (192, 384, True, 192, 100),
    (77, 131, True, 54, None),
    (200, 200, True, 0, 33),
    (45, 45, True, 0, None),
]


def _runs(i, j, bq, bkv, causal, offset, window):
    return bool(_block_runs(i, j, block_q=bq, block_kv=bkv, causal=causal,
                            offset=offset, window=window))


def _visible(nq, nk, causal, offset, window):
    row = np.arange(nq)[:, None]
    col = np.arange(nk)[None, :]
    vis = np.ones((nq, nk), bool)
    if causal:
        vis &= col <= row + offset
    if window is not None:
        vis &= col > row + offset - window
    return vis


@pytest.mark.parametrize("case", RANGE_CASES,
                         ids=[f"{c[0]}x{c[1]}-{c[2]}-{c[3]}-{c[4]}"
                              for c in RANGE_CASES])
def test_fp32_bwd_ranges_match_jax_block_runs(case):
    nq, nk, causal, offset, window = case
    vis = _visible(nq, nk, causal, offset, window)
    n_kv_tiles = -(-nk // STREAM)
    # B2: q tiles of `rows` (64, or 32 at D = 256), kv tiles of 16.
    for rows in (64, 32):
        for i in range(-(-nq // rows)):
            q0 = rows * i
            begin, end = _kv_range(
                q0, rows, nq, nk, causal=causal, offset=offset,
                window=window)
            ours = set(range(begin // STREAM, -(-end // STREAM))) \
                if end > begin else set()
            jax_set = {j for j in range(n_kv_tiles)
                       if _runs(i, j, rows, STREAM, causal, offset, window)}
            if q0 + rows <= nq:
                assert ours == jax_set, (i, ours, jax_set)
            else:
                assert ours <= jax_set
            cols = np.nonzero(vis[q0:q0 + rows].any(axis=0))[0]
            assert all(begin <= c < end for c in cols)
    # B3: kv tiles of `rows` (64, or 32 at D = 256), q tiles of 16.
    for rows in (64, 32):
        for jk in range(-(-nk // rows)):
            j0 = rows * jk
            first, stop = _q_tiles(
                j0, rows, nq, nk, causal=causal, offset=offset,
                window=window)
            ours = set(range(first, stop))
            jax_set = {iq for iq in range(-(-nq // STREAM))
                       if _runs(iq, jk, STREAM, rows, causal, offset,
                                window)}
            if j0 + rows <= nk:
                assert ours == jax_set, (jk, ours, jax_set)
            else:
                assert ours <= jax_set
            qrows = np.nonzero(vis[:, j0:j0 + rows].any(axis=1))[0]
            assert all(first <= r // STREAM < stop for r in qrows)
