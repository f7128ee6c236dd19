"""B10a, B10b and B10c on fp32 inputs: the launch plan of their
register-blocked FFMA body (csrc/study_f32.cuh), and the plain versions
held to the JAX kernels at the edges of that body.

Plan: `_plan` and `_rows` mirror F32Cfg and launch_f32 (4 warps a block,
64 or 32 q rows by the grid, K / V slabs of 64 keys through two
buffers, P in shared memory at a row stride of 68 floats), and
`_stored` the swizzled layout of Q and K.

Parity: seeded N(0, 1) numpy inputs go through the JAX package's
`flash_attention_fa1` / `flash_attention_fa2_inloop` /
`naive_attention_pallas` (Pallas in interpret mode on the CPU,
tests/conftest.py) at the card's fp32 tiles, and through the port's
plain versions on fp32 CPU tensors at the same block_kv. Lengths cross
the body's 32- and 64-row blocks and its 64-key slabs. Tolerance:
max-abs <= 2e-5 on o and m (fp32 accumulation-order noise ~1e-6); l
sums up to Nk terms of at most 1, so it is compared relative to its
value, 2e-6, as in tests/test_torch_study_tile16.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_tpu.ops import variants as jvariants
from flash_attention_tpu_torch.config import BlockSizes
from flash_attention_tpu_torch.ops import variants
from flash_attention_tpu_torch.utils.metrics import max_abs_error

ATOL = 2e-5
L_RTOL = 2e-6
SMEM_PER_SM = 233472       # bytes of shared memory an SM holds
SMEM_RESERVED = 1024       # bytes the card reserves of it for each block
SMS = 132                  # the H100's SMs (launch_f32 asks the device)
THREADS, TX, SLAB, STAGES, LDP = 128, 16, 64, 2, 64 + 4

# Shared bytes a block and blocks an SM, as study_f32.cuh's note states
# them: {(D, q rows a block): (bytes, blocks)}.
NOTE = {(32, 64): (41984, 5), (64, 64): (66560, 3), (128, 64): (115712, 2),
        (32, 32): (29184, 7), (64, 32): (49664, 4), (128, 32): (90624, 2),
        (256, 32): (172544, 1)}


def _plan(d, wide):
    """F32Cfg<D, Wide>: 128 threads as 8 x 16, kMR rows a thread (8 in a
    wide block up to D = 128, else 4), Q [rows, D] and two K / V
    buffers [64, D] unpadded, P [rows, 68]; blocks an SM by shared
    memory (less 1 KB reserved a block), at most 2048 threads."""
    mr = 8 if wide and d <= 128 else 4
    rows = (THREADS // TX) * mr
    smem = 4 * (rows * d + STAGES * SLAB * d + rows * LDP)
    return dict(threads=THREADS, warps=THREADS // 32, rows=rows, slab=SLAB,
                stages=STAGES, smem=smem,
                blocks_per_sm=min(SMEM_PER_SM // (smem + SMEM_RESERVED),
                                  2048 // THREADS),
                o_tile=(mr, d // TX), s_tile=(mr, 4))


def _rows(b, h, nq, d, sms=SMS):
    """launch_f32's rows a block: 64 when such blocks give every other SM
    one at least (D <= 128), else 32."""
    return 64 if d <= 128 and 2 * b * h * -(-nq // 64) >= sms else 32


def _grid(b, h, nq, d):
    return b * h * -(-nq // _rows(b, h, nq, d))


def _stored(r, c, permute):
    """ffma::Swizzled<D, Permute>: (stored row, stored chunk) of chunk c
    of row r."""
    p = (r & 3) * 16 + (r >> 2) if permute else r
    return p, c ^ (p & 7)


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_study_f32_launch_plan_fits(d):
    for wide in (True, False):
        plan = _plan(d, wide)
        assert plan["warps"] == 4 and plan["slab"] == 64
        assert plan["stages"] == 2
        assert plan["rows"] == (64 if wide and d <= 128 else 32)
        assert plan["smem"] <= variants.SMEM_LIMIT
        assert (plan["smem"], plan["blocks_per_sm"]) == \
            NOTE[(d, plan["rows"])]
        # O's micro-tile: 8 x 8 a thread at D = 128, 4 x 16 at D = 256.
        assert plan["o_tile"][0] * plan["o_tile"][1] * THREADS == \
            plan["rows"] * d
    # Two blocks an SM at D = 128 with 64 rows: exactly the SM's bytes.
    assert 2 * (_plan(128, True)["smem"] + SMEM_RESERVED) == SMEM_PER_SM


def test_study_f32_row_choice_and_grid():
    """cli verify's (1, 8, 512, 64) takes 32-row blocks (64 of 64 rows
    would leave over half the SMs idle); the (1, 8, 2048, D) study rows
    take 64 up to D = 128; ragged grids round Nq up."""
    assert _rows(1, 8, 512, 64) == 32 and _grid(1, 8, 512, 64) == 128
    for d in (32, 64, 128):
        assert _rows(1, 8, 2048, d) == 64 and _grid(1, 8, 2048, d) == 256
    assert _rows(1, 8, 2048, 256) == 32 and _grid(1, 8, 2048, 256) == 512
    assert _grid(2, 3, 77, 128) == 2 * 3 * 3          # 32-row blocks
    assert _grid(2, 34, 200, 128) == 2 * 34 * 4       # 64-row blocks
    assert _grid(2, 34, 1, 64) == 68                  # 2 x 68 >= 132
    assert _grid(1, 1, 1, 32) == 1


def test_study_f32_layout_spreads_banks():
    """Q rows ty + 8 i of a warp's two ty, and K keys 4 tx + j of the 16
    tx at one j, read chunk c in different bank groups (a 16-byte chunk
    spans 4 of the 32 banks; unpadded rows of D floats start on bank
    0), and every layout is a bijection onto the tile."""
    for d in (32, 64, 128, 256):
        chunks = d // 4
        for permute, rows in ((False, 64), (True, 64)):
            cells = {_stored(r, c, permute) for r in range(rows)
                     for c in range(chunks)}
            assert len(cells) == rows * chunks
            assert all(p < rows and q < chunks for p, q in cells)
        for c in range(chunks):
            for j in range(4):
                groups = [_stored(4 * tx + j, c, True)[1] % 8
                          for tx in range(16)]
                assert sorted(groups) == sorted(list(range(8)) * 2)
            for w in range(4):
                a, b = (_stored(ty, c, False)[1] % 8
                        for ty in (2 * w, 2 * w + 1))
                assert a != b


def _inputs(seed, b, hq, hkv, nq, nk, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.0, shape).astype(np.float32)
            for shape in ((b, hq, nq, d), (b, hkv, nk, d), (b, hkv, nk, d))]


# (Nq, Nk): across 32- and 64-row blocks and 64-key slabs, by one and
# by many.
FA1_EDGES = [(33, 65), (65, 129), (130, 200)]


@pytest.mark.parametrize("tile", [16, 64], ids=["16x16", "64x64"])
@pytest.mark.parametrize("nq, nk", FA1_EDGES,
                         ids=[f"{a}x{b}" for a, b in FA1_EDGES])
def test_fa1_fp32_plain_matches_jax_at_body_edges(nq, nk, tile):
    b, h, d = 1, 2, 32
    q, k, v = _inputs(nq * 7 + nk + tile, b, h, h, nq, nk, d)
    o_j, m_j, l_j = jvariants.flash_attention_fa1(
        *(jnp.asarray(x) for x in (q, k, v)),
        block_sizes=JaxBlockSizes(block_q=tile, block_kv=tile))
    o_t, m_t, l_t = variants.flash_attention_fa1_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), scale=d ** -0.5,
        block_kv=tile)
    m_j, l_j = np.array(m_j)[..., 0], np.array(l_j)[..., 0]
    assert o_t.shape == (b, h, nq, d) and m_t.shape == l_t.shape == \
        (b, h, nq)
    assert max_abs_error(o_t, o_j) <= ATOL
    assert max_abs_error(m_t, m_j) <= ATOL
    assert float((torch.from_numpy(l_j) - l_t).abs().max()
                 / float(np.abs(l_j).max())) <= L_RTOL


@pytest.mark.parametrize("d, hq, hkv, nq, nk", [
    (64, 4, 2, 128, 320), (32, 6, 2, 64, 192), (256, 2, 1, 32, 128)],
    ids=["gqa4_2", "gqa6_2", "d256_tile32"])
def test_fa2_fp32_causal_offset_plain_matches_jax(d, hq, hkv, nq, nk):
    """B10b causal with Nq < Nk (offset Nk - Nq) and GQA, at the fp32
    tile (64 x 64; 32 x 64 at D = 256)."""
    bq, bk = variants.study_tile(torch.float32, d)
    q, k, v = _inputs(d + hq + nk, 1, hq, hkv, nq, nk, d)
    o_j = jvariants.flash_attention_fa2_inloop(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True,
        block_sizes=JaxBlockSizes(block_q=bq, block_kv=bk))
    o_t = variants.flash_attention_fa2_inloop_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=True,
        scale=d ** -0.5, block_kv=bk)
    assert max_abs_error(o_t, o_j) <= ATOL


@pytest.mark.parametrize("d, n", [(64, 192), (256, 128)],
                         ids=["three_slabs", "d256_tile32"])
def test_naive_fp32_plain_matches_jax_across_tiles(d, n):
    """B10c's two passes over several 64-key tiles."""
    bq, bk = variants.study_tile(torch.float32, d)
    q, k, v = _inputs(d + n, 1, 2, 2, n, n, d)
    o_j = jvariants.naive_attention_pallas(
        *(jnp.asarray(x) for x in (q, k, v)),
        block_sizes=JaxBlockSizes(block_q=bq, block_kv=bk))
    o_t = variants.naive_attention_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), scale=d ** -0.5,
        block_kv=bk)
    assert max_abs_error(o_t, o_j) <= ATOL


def test_fp32_wrappers_on_cpu_are_the_plain_versions():
    """On fp32 CPU tensors each wrapper is its plain version at its tile
    and counts no launch on any counter."""
    counters = ("fa1_launches", "fa1_tile16_launches", "fa2_inloop_launches",
                "naive_launches", "study_f32_launches")
    before = [getattr(variants, c) for c in counters]
    d, sc = 64, 64 ** -0.5
    q, k, v = (torch.from_numpy(x) for x in _inputs(5, 1, 2, 2, 128, 192, d))
    for tile in ((16, 16), (64, 64)):
        got = variants.flash_attention_fa1(q, k, v,
                                           block_sizes=BlockSizes(*tile))
        want = variants.flash_attention_fa1_plain(q, k, v, scale=sc,
                                                  block_kv=tile[1])
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got = variants.flash_attention_fa2_inloop(q, k, v, causal=True)
    assert torch.equal(got, variants.flash_attention_fa2_inloop_plain(
        q, k, v, causal=True, scale=sc, block_kv=64))
    q2 = q[:, :, :64]
    k2, v2 = k[:, :, :128], v[:, :, :128]
    got = variants.naive_attention_pallas(q2, k2, v2)
    assert torch.equal(got, variants.naive_attention_plain(
        q2, k2, v2, scale=sc, block_kv=64))
    assert [getattr(variants, c) for c in counters] == before
