"""Port parity: the kernel-study variants (B10a-c), B1's causal split,
the exact baselines, the registry and the cross-check of
flash_attention_tpu_torch against the JAX package.

Seeded numpy inputs go through both packages in fp32. The JAX side runs
its Pallas kernels in interpret mode (tests/conftest.py keeps JAX on the
CPU), the port's side takes its plain PyTorch versions because the
tensors lie on the CPU. Kernel inputs are N(0, 1) so that the softmax is
far from uniform. Tolerance: max-abs <= 2e-5 on O, m, l and LSE (fp32
accumulation-order noise here is ~1e-6), plus the repo's 2% symmetric
relative gate where the JAX test applies it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_tpu.ops import dispatch as jdispatch
from flash_attention_tpu.ops import reference as jref
from flash_attention_tpu.ops import variants as jvariants
from flash_attention_tpu.ops.flash import flash_attention_fwd_split
from flash_attention_tpu.utils import metrics as jmetrics
from flash_attention_tpu_torch.config import BlockSizes
from flash_attention_tpu_torch.ops import dispatch, flash, reference, variants
from flash_attention_tpu_torch.utils.metrics import (
    cross_check,
    max_abs_error,
    verify,
)

ATOL = 2e-5
JAX_BLOCKS = JaxBlockSizes(block_q=128, block_kv=128)
BLOCKS = BlockSizes(block_q=128, block_kv=128)


def _inputs(seed, b, hq, hkv, nq, nk, d, std=1.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, std, shape).astype(np.float32)
            for shape in ((b, hq, nq, d), (b, hkv, nk, d), (b, hkv, nk, d))]


def _jax(*xs):
    return [jnp.asarray(x) for x in xs]


def _torch(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("m_budget, d", [
    (4096 * 64, 64), (4096, 128), (4096, 64), (4096, 32), (58112, 128),
    (1, 256)])
def test_fa1_tile_sizes_match_jax(m_budget, d):
    assert variants.fa1_tile_sizes(m_budget, d) == \
        jvariants.fa1_tile_sizes(m_budget, d)


def test_fa1_kernel_tile_law():
    """The Hopper tile: the smallest compiled pair covering the raw law,
    else the largest that fits shared memory at that D and dtype."""
    assert variants.fa1_law(4096, 64) == (16, 16)
    assert variants.fa1_kernel_tile(4096, 64, torch.float32) == (16, 16)
    assert variants.fa1_kernel_tile(4096, 128, torch.bfloat16) == (16, 16)
    assert variants.fa1_kernel_tile(4096 * 64, 64, torch.bfloat16) == \
        (64, 64)
    # fp32 64 x 64 tiles at D = 256 exceed 227 KB: only 16 x 16 there.
    assert variants.fa1_compiled_tiles(torch.float32, 256) == [(16, 16)]
    assert variants.fa1_kernel_tile(1 << 20, 256, torch.float32) == (16, 16)
    assert variants.study_tile(torch.float32, 256) == (32, 64)
    assert variants.study_tile(torch.bfloat16, 256) == (64, 64)


@pytest.mark.parametrize("shape, kw", [
    ((1, 2, 2, 256, 256, 64), dict(block_sizes=True)),
    ((1, 2, 2, 100, 333, 64), dict(block_sizes=True)),
    ((1, 1, 1, 256, 256, 64), dict(m_budget=4 * 64 * 128)),
], ids=["blocks128", "ragged", "m_budget"])
def test_fa1_matches_jax(shape, kw):
    q, k, v = _inputs(sum(shape), *shape)
    jkw = {k_: (JAX_BLOCKS if v_ is True else v_) for k_, v_ in kw.items()}
    tkw = {k_: (BLOCKS if v_ is True else v_) for k_, v_ in kw.items()}
    o_j, m_j, l_j = jvariants.flash_attention_fa1(*_jax(q, k, v), **jkw)
    o_t, m_t, l_t = variants.flash_attention_fa1(*_torch(q, k, v), **tkw)
    assert m_t.shape == l_t.shape == shape[:2] + (shape[3],)
    assert max_abs_error(o_t, o_j) <= ATOL
    assert max_abs_error(m_t, np.asarray(m_j)[..., 0]) <= ATOL
    assert max_abs_error(l_t, np.asarray(l_j)[..., 0]) <= ATOL
    _, lse_j = jref.attention_reference_with_lse(*_jax(q, k, v))
    assert max_abs_error(m_t + torch.log(l_t), lse_j) <= ATOL
    assert verify(o_t, o_j).passed


@pytest.mark.parametrize("hq, hkv, causal", [(2, 2, False), (2, 2, True),
                                             (4, 2, True)],
                         ids=["noncausal", "causal", "gqa_4_2_causal"])
def test_fa2_inloop_matches_jax(hq, hkv, causal):
    q, k, v = _inputs(hq + 3 * causal, 1, hq, hkv, 256, 256, 64)
    o_j = jvariants.flash_attention_fa2_inloop(
        *_jax(q, k, v), causal=causal, block_sizes=JAX_BLOCKS)
    o_t = variants.flash_attention_fa2_inloop(
        *_torch(q, k, v), causal=causal, block_sizes=BLOCKS)
    assert max_abs_error(o_t, o_j) <= ATOL
    assert verify(o_t, o_j).passed


def test_naive_matches_jax():
    q, k, v = _inputs(7, 1, 2, 2, 256, 256, 64)
    o_j = jvariants.naive_attention_pallas(*_jax(q, k, v),
                                           block_sizes=JAX_BLOCKS)
    o_t = variants.naive_attention_pallas(*_torch(q, k, v),
                                          block_sizes=BLOCKS)
    assert max_abs_error(o_t, o_j) <= ATOL
    assert verify(o_t, o_j).passed


def test_naive_d128_several_kv_tiles_matches_jax():
    """B10c at D = 128 over six kv tiles of the card's 64 columns (the
    JAX kernel takes three of 128): the two passes agree whatever the
    tiling."""
    q, k, v = _inputs(11, 1, 2, 2, 384, 384, 128)
    o_j = jvariants.naive_attention_pallas(*_jax(q, k, v),
                                           block_sizes=JAX_BLOCKS)
    o_t = variants.naive_attention_pallas(*_torch(q, k, v))
    assert max_abs_error(o_t, o_j) <= ATOL
    assert verify(o_t, o_j).passed


def test_variant_shape_errors():
    """The JAX kernels' refusals: MHA-only FA1 / naive, block-divisible
    FA2 / naive; and the card's compiled tiles (checked before any
    launch, so they raise here only for CUDA tensors)."""
    q = torch.zeros(1, 4, 256, 64)
    kv = torch.zeros(1, 2, 256, 64)
    with pytest.raises(ValueError, match="MHA-only"):
        variants.flash_attention_fa1(q, kv, kv)
    with pytest.raises(ValueError, match="MHA-only"):
        variants.naive_attention_pallas(q, kv, kv)
    odd = torch.zeros(1, 2, 200, 64)
    with pytest.raises(ValueError, match="block-divisible"):
        variants.flash_attention_fa2_inloop(odd, odd, odd)
    with pytest.raises(ValueError, match="block-divisible"):
        variants.naive_attention_pallas(odd, odd, odd)
    with pytest.raises(ValueError, match="compiled for"):
        variants._card_tile("fa1", torch.bfloat16, 64,
                            BlockSizes(128, 128),
                            variants.fa1_compiled_tiles(torch.bfloat16, 64))


@pytest.mark.parametrize("band, bq", [(128, 128), (256, 128)])
def test_fwd_split_matches_jax(band, bq):
    """The two-pass causal split (bulk + band passes, LSE merge) against
    the JAX package's, O and LSE; and against single-pass causal."""
    q, k, v = _inputs(band, 1, 2, 2, 512, 512, 64)
    o_j, lse_j = flash_attention_fwd_split(
        *_jax(q, k, v), band=band,
        block_sizes=JaxBlockSizes(block_q=bq, block_kv=bq),
        diag_block_sizes=JAX_BLOCKS, save_residuals=True)
    o_t, lse_t = flash.flash_attention_fwd_split(*_torch(q, k, v),
                                                 band=band,
                                                 save_residuals=True)
    assert lse_t.shape == (1, 2, 512)
    assert max_abs_error(o_t, o_j) <= ATOL
    assert max_abs_error(lse_t, np.asarray(lse_j)[..., 0]) <= ATOL
    o_1, lse_1 = flash.flash_attention_fwd(*_torch(q, k, v), causal=True)
    assert max_abs_error(o_t, o_1) <= ATOL
    assert max_abs_error(lse_t, lse_1) <= ATOL


def test_fwd_split_errors():
    x = torch.zeros(1, 1, 512, 64)
    with pytest.raises(ValueError, match="divisible by band"):
        flash.flash_attention_fwd_split(x, x, x, band=384)
    with pytest.raises(ValueError, match="divisible by band"):
        flash.flash_attention_fwd_split(x, torch.zeros(1, 1, 256, 64),
                                        torch.zeros(1, 1, 256, 64), band=256)
    with pytest.raises(ValueError, match="64-row q tile"):
        flash.flash_attention_fwd_split(x, x, x, band=32)
    assert flash.flash_attention_fwd_split(x, x, x, band=256)[1] is None


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fn", ["attention_baseline",
                                "attention_lowp_baseline"])
def test_baselines_match_jax(fn, causal):
    q, k, v = _inputs(11, 1, 4, 2, 64, 96, 64)
    want = getattr(jref, fn)(*_jax(q, k, v), causal=causal)
    got = getattr(reference, fn)(*_torch(q, k, v), causal=causal)
    assert max_abs_error(got, want) <= ATOL
    # bf16 inputs: the low-precision baseline rounds P to bf16 as JAX.
    qb, kb, vb = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = getattr(jref, fn)(qb, kb, vb, causal=causal)
    got = getattr(reference, fn)(
        *(torch.from_numpy(np.array(x.astype(jnp.float32))).to(
            torch.bfloat16) for x in (qb, kb, vb)), causal=causal)
    assert got.dtype == torch.bfloat16
    assert max_abs_error(got, np.asarray(want.astype(jnp.float32))) <= \
        float(np.max(np.abs(np.asarray(want.astype(jnp.float32))))) * 2 ** -7


def test_registry_matches_jax():
    assert list(dispatch.IMPLEMENTATIONS) == list(jdispatch.IMPLEMENTATIONS)
    assert dispatch.CAUSAL_CAPABLE == jdispatch.CAUSAL_CAPABLE
    assert set(dispatch.CAUSAL_CAPABLE) <= set(dispatch.IMPLEMENTATIONS)
    with pytest.raises(ValueError, match="unknown implementation"):
        dispatch.get_attention_impl("wmma")
    dispatch.validate_head_dim(128)
    with pytest.raises(ValueError, match="Unsupported head_dim"):
        dispatch.validate_head_dim(96)
    x = torch.zeros(1, 2, 64, 64)
    for name in ("fa1", "naive_pallas"):
        with pytest.raises(ValueError, match="non-causal study kernel"):
            dispatch.get_attention_impl(name)(x, x, x, causal=True)


def test_four_way_cross_check():
    """Every study implementation through the registry on one seeded
    input: all pairs within the 2% gate, and the exact baseline equal to
    the JAX package's."""
    q, k, v = _inputs(42, 1, 2, 2, 256, 256, 64, std=0.02)
    tq, tk, tv = _torch(q, k, v)
    outs = {}
    for name in ("baseline_xla", "naive_pallas", "fa1", "fa2_inloop",
                 "flash"):
        kw = {"block_sizes": BLOCKS} if name in (
            "naive_pallas", "fa1", "fa2_inloop") else {}
        outs[name] = dispatch.get_attention_impl(name)(tq, tk, tv, **kw)
    failed = {pair: str(r) for pair, r in cross_check(outs).items()
              if not r.passed}
    assert not failed, failed
    want = jdispatch.get_attention_impl("baseline_xla")(*_jax(q, k, v))
    assert max_abs_error(outs["baseline_xla"], want) <= ATOL


def test_fixed_tile_entries():
    """Head-dim gated, B1 underneath, causal-capable (the JAX test's
    cases)."""
    q, k, v = _torch(*_inputs(5, 1, 2, 2, 256, 256, 64, std=0.02))
    impl = dispatch.get_attention_impl("flash_fixed_d64")
    for causal in (False, True):
        r = verify(impl(q, k, v, causal=causal),
                   reference.attention_reference(q, k, v, causal=causal))
        assert r.passed, str(r)
    with pytest.raises(ValueError, match="fixed to head_dim 64"):
        impl(*_torch(*_inputs(6, 1, 2, 2, 128, 128, 32)))
    q32, k32, v32 = _torch(*_inputs(8, 1, 2, 2, 256, 256, 32, std=0.02))
    d32 = dispatch.get_attention_impl("flash_fixed_d32")
    r = verify(d32(q32, k32, v32),
               reference.attention_reference(q32, k32, v32))
    assert r.passed, str(r)
    with pytest.raises(ValueError, match="fixed to head_dim 32"):
        d32(q, k, v)


def test_cross_check_matches_jax():
    """The port's all-pairs cross-check gives JAX's verdicts and errors,
    a bf16 candidate (the ulp-floored gate) among them."""
    rng = np.random.default_rng(3)
    base = rng.normal(0, 0.02, (1, 2, 64, 64)).astype(np.float32)
    named = {"a": base,
             "b": base * (1 + rng.normal(0, 1e-4, base.shape))
             .astype(np.float32),
             "c": base * np.float32(1.05)}
    bf = jnp.asarray(base, jnp.bfloat16)
    want = jmetrics.cross_check({**{k: jnp.asarray(v)
                                    for k, v in named.items()}, "d": bf})
    got = cross_check({**{k: torch.from_numpy(v) for k, v in named.items()},
                       "d": torch.from_numpy(base).to(torch.bfloat16)})
    assert list(got) == list(want)
    for pair, r in want.items():
        assert got[pair].passed == r.passed, pair
        assert got[pair].num_offenders == r.num_offenders, pair
        assert abs(got[pair].max_rel_err - r.max_rel_err) <= 1e-6, pair
    assert not got[("a", "c")].passed and got[("a", "b")].passed
