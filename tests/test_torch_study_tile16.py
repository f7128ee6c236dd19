"""B10a's 16 x 16 tile: its contract against the JAX package, the launch
plan of its fp16 / bf16 body (csrc/study_sm80.cuh) and the FA1 tile
bookkeeping that picks it.

The contract of the 16 x 16 tile is what `flash_attention_fa1_plain(...,
block_kv=16)` computes: each 16-row q tile runs the FA1 recurrence over
the keys 16 columns at a time, the tile max m~, P~ and l~ per 16-column
step, acc = alpha acc + beta (P~ V) with P~ V fresh and P~ rounded to
the input dtype before the product. The JAX side is `_fa1_kernel` at
16 x 16 blocks through `flash_attention_fa1`, in interpret mode on the
CPU (tests/conftest.py), on the same seeded N(0, 1) numpy inputs.

Tolerances: fp32 max-abs <= 2e-5 on o, m and l (accumulation-order noise
~1e-6; l sums up to Nk terms of at most 1, so it is compared relative to
its value, 2e-6). bf16: both sides round P~ to bf16 and compute in fp32,
then round o to bf16, so o may differ by one bf16 ulp of its largest
value (2^-7 of max |o|); m and l are fp32 on both sides (2e-5, 2e-6
relative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_tpu.ops import variants as jvariants
from flash_attention_tpu_torch.ops import variants
from flash_attention_tpu_torch.utils.metrics import max_abs_error

ATOL = 2e-5
L_RTOL = 2e-6
TILE16 = JaxBlockSizes(block_q=16, block_kv=16)

# (Nq, Nk): ragged lengths that cut both the 16-row steps and the 64-row
# blocks and slabs of the card's body.
RAGGED = [(77, 131), (1, 40), (64, 80)]

SMEM_PER_SM = 233472       # bytes of shared memory an SM holds
SMEM_RESERVED = 1024       # bytes the card reserves of it for each block


def _tile16_plan(head_dim, nq=1, heads=1, batch=1):
    """The launch of B10a's 16 x 16 fp16 / bf16 body, mirroring
    csrc/study_sm80.cuh Tile16 and launch_tile16: 8 warps a block, one
    16-row q tile each; a ring of K / V slabs of 64 rows (32 at D = 256)
    with as many stages (up to 4) as fit two blocks an SM up to D = 64,
    one above; grid (q tiles of 128, heads, batch)."""
    warps, slab = 8, (32 if head_dim > 128 else 64)
    blocks = 1 if head_dim > 64 else 2
    row_bytes = 2 * (head_dim + 8)
    q_bytes = 16 * warps * row_bytes
    stage_bytes = 2 * slab * row_bytes
    budget = min(SMEM_PER_SM // blocks - SMEM_RESERVED, variants.SMEM_LIMIT)
    stages = min(4, (budget - q_bytes) // stage_bytes)
    return dict(warps=warps, threads=32 * warps, rows=16 * warps,
                slab=slab, stages=stages,
                smem=q_bytes + stages * stage_bytes, blocks_per_sm=blocks,
                grid=(-(-nq // (16 * warps)), heads, batch))


def _inputs(seed, b, h, nq, nk, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.0, shape).astype(np.float32)
            for shape in ((b, h, nq, d), (b, h, nk, d), (b, h, nk, d))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq, nk", RAGGED,
                         ids=[f"{a}x{b}" for a, b in RAGGED])
def test_tile16_plain_matches_jax_fa1_kernel(nq, nk, dtype):
    b, h, d = 1, 2, 64
    q, k, v = _inputs(nq * 1000 + nk, b, h, nq, nk, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    o_j, m_j, l_j = jvariants.flash_attention_fa1(
        *(jnp.asarray(x, dtype=jdt) for x in (q, k, v)), block_sizes=TILE16)
    qt, kt, vt = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    o_t, m_t, l_t = variants.flash_attention_fa1_plain(
        qt, kt, vt, scale=d ** -0.5, block_kv=16)
    o_j = np.asarray(o_j.astype(jnp.float32))
    m_j, l_j = np.array(m_j)[..., 0], np.array(l_j)[..., 0]
    assert o_t.dtype == tdt and o_t.shape == (b, h, nq, d)
    assert m_t.shape == l_t.shape == (b, h, nq)
    o_tol = ATOL if dtype == "float32" else 2.0 ** -7 * np.abs(o_j).max()
    assert max_abs_error(o_t.float(), o_j) <= o_tol
    assert max_abs_error(m_t, m_j) <= ATOL
    assert float((torch.from_numpy(l_j) - l_t).abs().max()
                 / float(np.abs(l_j).max())) <= L_RTOL


def test_tile16_wrapper_on_cpu_is_the_plain_version():
    """`flash_attention_fa1` at the 16 x 16 tile on CPU tensors is the
    plain version at block_kv = 16, and counts no launch."""
    from flash_attention_tpu_torch.config import BlockSizes

    q, k, v = (torch.from_numpy(x)
               for x in _inputs(3, 1, 2, 77, 131, 32))
    before = (variants.fa1_launches, variants.fa1_tile16_launches)
    got = variants.flash_attention_fa1(q, k, v,
                                       block_sizes=BlockSizes(16, 16))
    want = variants.flash_attention_fa1_plain(q, k, v, scale=32 ** -0.5,
                                              block_kv=16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (variants.fa1_launches, variants.fa1_tile16_launches) == before


@pytest.mark.parametrize("d", [32, 64, 128, 256])
def test_tile16_launch_plan_fits(d):
    """The body's launch (Tile16): 8 warps of 16 q rows a block, a ring
    of 2-4 K / V slabs (64 rows, 32 at D = 256), two blocks on an SM up
    to D = 64 (one above) within 228 KB an SM less 1 KB a block, within
    a block's 232,448 bytes; the same for fp16 and bf16 (both 2-byte
    types)."""
    plan = _tile16_plan(d, nq=2048, heads=8, batch=1)
    assert plan["warps"] == 8 and plan["threads"] == 256
    assert plan["rows"] == 128 and plan["grid"] == (16, 8, 1)
    assert plan["slab"] == (32 if d == 256 else 64)
    assert 2 <= plan["stages"] <= 4
    row_bytes = 2 * (d + 8)
    assert plan["smem"] == (128 + plan["stages"] * 2 * plan["slab"]) \
        * row_bytes
    assert plan["smem"] <= variants.SMEM_LIMIT
    blocks = plan["blocks_per_sm"]
    assert blocks == (2 if d <= 64 else 1)
    assert blocks * (plan["smem"] + SMEM_RESERVED) <= SMEM_PER_SM
    # One more stage would not fit (or passes 4).
    more = plan["smem"] + 2 * plan["slab"] * row_bytes
    assert plan["stages"] == 4 or more > variants.SMEM_LIMIT or \
        blocks * (more + SMEM_RESERVED) > SMEM_PER_SM
    for dt in (torch.float16, torch.bfloat16):
        assert variants.fa1_compiled_tiles(dt, d) == [(16, 16), (64, 64)]


def test_tile16_ragged_grid():
    assert _tile16_plan(128, nq=200, heads=3, batch=2)["grid"] == (2, 3, 2)
    assert _tile16_plan(128, nq=1)["grid"] == (1, 1, 1)


def test_fa1_tile_bookkeeping_unchanged():
    """The tile law's answers and the compiled tiles stay what they were:
    16 x 16 at cli verify's defaults (M = 4096, d = 64) in every dtype;
    both tiles everywhere but fp32 64 x 64 at D = 256."""
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        assert variants.fa1_kernel_tile(4096, 64, dt) == (16, 16)
        assert variants.fa1_kernel_tile(4096, 128, dt) == (16, 16)
        assert variants.fa1_kernel_tile(4096 * 64, 64, dt) == (64, 64)
        for d in (32, 64, 128, 256):
            want = ([(16, 16)] if (dt == torch.float32 and d == 256)
                    else [(16, 16), (64, 64)])
            assert variants.fa1_compiled_tiles(dt, d) == want
