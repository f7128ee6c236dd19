"""P2 v2 on the split-KV body (csrc/probe_paged_int8.cu over
decode_sm90.cuh): its launch plan from shapes alone, and the port's
`paged_int8_v2` (its plain version on CPU tensors) held to the JAX
probe's own v2 kernel.

Plan: `v2_splits` (scripts/probe_paged_int8.py) is the split count the
kernel is launched with; `_smem`
mirrors its Smem layout (a two-stage ring of one quant block's K and V
codes and scale rows, one widened bf16 tile, q, each warp's P^T, the
merge's stats) against decode_sm90.cuh's kSmemBudget, two blocks an SM.

Parity: the JAX probe (scripts/probe_paged_int8.py) runs its work when
imported, at full size, so its `_v2_kernel` and `v2_call` are taken
from its source (the AST of those two functions, nothing else of the
file run) and launched as Pallas in interpret mode on the CPU, as the
JAX package's own tests run its kernels (tests/conftest.py), on seeded
numpy pools in fp32 at small sizes: lengths 0, 1, 127, 128, 129 and ones
that cross pages. Tolerance: O max-abs <= 2e-5 of the largest |O| (the
port's paged-decode parity tolerance, tests/test_torch_probes.py); a
length-0 sequence gives O = 0 exactly on both.
"""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from flash_attention_tpu.config import LANES
from flash_attention_tpu.ops.flash import INIT_M, LOG2E, MASK_VALUE
from flash_attention_tpu.ops.quant import QUANT_BLOCK
from flash_attention_tpu_torch.ops.decode import MAX_SPLITS
from flash_attention_tpu_torch.scripts import probe_paged_int8 as p2

ATOL = 2e-5
ROOT = pathlib.Path(__file__).resolve().parent.parent
SMEM_BUDGET = 113 * 1024      # decode_sm90.cuh kSmemBudget
SMEM_BYTES = 110288           # probe_paged_int8.cu Smem::kBytes
SMEM_PER_SM, SMEM_RESERVED = 233472, 1024


def _smem(d=128, warps=8, rows=8, stages=2, block=128):
    """probe_paged_int8.cu's Smem: bytes of each region, in order."""
    ld, ldp = d + 8, 16 + 8
    stage = 2 * block * d + 2 * 4 * d
    regions = dict(ring=stages * stage, tile=2 * block * ld, q=2 * rows * ld,
                   p=2 * warps * rows * ldp, stats=4 * warps * rows * 2,
                   flag=16, merge=4 * rows * (MAX_SPLITS + 2))
    return regions, sum(regions.values())


def test_v2_shared_memory_keeps_two_blocks_an_sm():
    regions, total = _smem()
    assert total == SMEM_BYTES <= SMEM_BUDGET
    assert 2 * (total + SMEM_RESERVED) <= SMEM_PER_SM
    # The merge's [warp][row][D] fp32 sums reuse the ring.
    assert 4 * 8 * p2.V2_ROWS * 128 <= regions["ring"]
    # A tile each for K and V would not leave room for a second block.
    assert total + regions["tile"] > SMEM_BUDGET


@pytest.mark.parametrize("units, max_tokens, want", [
    (512, 4096, 1),     # the probe's shape: 512 blocks, ~1.94 waves
    (64, 4096, 4),      # B = 8: one wave of 256 of the 264 blocks
    (16, 4096, 8),      # 8 splits of 4 quant blocks at most
    (100, 4096, 5),     # two waves of 1 / 5 each beat one of 1 / 2
    (1, 1024, 2),       # 8 quant blocks: two splits of 4
    (1, 256, 1),        # two quant blocks: one split
    (1, 0, 1),
    (1, 1 << 20, MAX_SPLITS),
])
def test_v2_splits_from_shapes(units, max_tokens, want):
    assert p2.v2_splits(units, max_tokens) == want


def test_v2_splits_minimise_waves_per_work():
    """The count is the least ceil(units s / resident) / s over the
    allowed s (each split at least V2_MIN_BLOCKS quant blocks), the
    fewest splits on a tie."""
    for units in (1, 7, 64, 100, 132, 263, 264, 265, 512, 2000):
        for tokens in (128, 1000, 4096, 32768):
            s = p2.v2_splits(units, tokens)
            most = max(1, min(MAX_SPLITS, -(-tokens // QUANT_BLOCK)
                              // p2.V2_MIN_BLOCKS))
            assert 1 <= s <= most

            def cost(n):
                return -(-units * n // p2.V2_RESIDENT) / n
            assert all(cost(s) <= cost(n) for n in range(1, most + 1))
            assert all(cost(n) > cost(s) for n in range(1, s))


# --- parity with the JAX probe's v2 kernel ---------------------------------


class _Interpret:
    """`pl` with pallas_call in interpret mode (the probe hard-codes
    interpret=False: it was written for the chip)."""

    def __getattr__(self, name):
        return getattr(pl, name)

    @staticmethod
    def pallas_call(*args, **kwargs):
        return pl.pallas_call(*args, **dict(kwargs, interpret=True))


def _jax_v2_call(hkv):
    """The JAX probe's `v2_call` (and `_v2_kernel`), compiled from its
    source with the probe's names, HKV = hkv."""
    path = ROOT / "scripts" / "probe_paged_int8.py"
    tree = ast.parse(path.read_text())
    fns = [n for n in tree.body if isinstance(n, ast.FunctionDef)
           and n.name in ("_v2_kernel", "v2_call")]
    assert len(fns) == 2
    ns = dict(functools=functools, np=np, jax=jax, jnp=jnp, lax=lax,
              pl=_Interpret(), pltpu=pltpu, INIT_M=INIT_M, LOG2E=LOG2E,
              MASK_VALUE=MASK_VALUE, QUANT_BLOCK=QUANT_BLOCK, LANES=LANES,
              HKV=hkv)
    exec(compile(ast.Module(body=fns, type_ignores=[]), str(path), "exec"),
         ns)
    return ns["v2_call"]


# (lengths, page size, table width): 0, 1, 127, 128, 129 in pages of 128;
# lengths that cross pages of 256.
P2_CASES = {
    "block_edges": ([0, 1, 127, 128, 129, 300], 128, 3),
    "cross_pages": ([129, 300, 511, 600, 767], 256, 3),
}


@pytest.mark.parametrize("name", list(P2_CASES))
def test_v2_plain_matches_the_jax_probes_v2(name):
    lengths, ps, width = P2_CASES[name]
    b, hq, hkv, d = len(lengths), 8, 2, 128
    rng = np.random.default_rng(len(name))
    pages = b * width + 1
    kf = rng.normal(0, 1.0, (hkv, pages, ps, d)).astype(np.float32)
    vf = rng.normal(0, 1.0, (hkv, pages, ps, d)).astype(np.float32)
    # Blocks whose scales differ by orders of magnitude.
    kf *= 10.0 ** rng.integers(-2, 3, (hkv, pages, ps // 128, 1, 1)) \
        .repeat(128, axis=2).reshape(hkv, pages, ps, 1)
    q = rng.normal(0, 0.1, (b, hq, d)).astype(np.float32)
    table = rng.permutation(pages)[:b * width].reshape(b, width) \
        .astype(np.int32)
    lens = np.asarray(lengths, np.int32)
    kq, ks = p2.quantize_pool(torch.from_numpy(kf))
    vq, vs = p2.quantize_pool(torch.from_numpy(vf))

    o_j = np.asarray(_jax_v2_call(hkv)(
        jnp.asarray(q), jnp.asarray(kq.numpy()), jnp.asarray(vq.numpy()),
        jnp.asarray(ks.numpy()), jnp.asarray(vs.numpy()),
        jnp.asarray(table), jnp.asarray(lens), ps))
    o_t, lse_t = p2.paged_int8_v2(torch.from_numpy(q), kq, vq, ks, vs,
                                  torch.from_numpy(table),
                                  torch.from_numpy(lens))
    top = float(np.abs(o_j).max())
    assert float(np.abs(o_t.numpy() - o_j).max()) <= ATOL * top
    empty = lens == 0
    if empty.any():
        assert not np.abs(o_j[empty]).any()
        assert not o_t.numpy()[empty].any()
        np.testing.assert_allclose(lse_t.numpy()[empty],
                                   INIT_M / np.sqrt(d), rtol=1e-6)
