"""Port parity: the grouped matmul B9 (flash_attention_tpu_torch/ops/
grouped.py) and the expert-stack quantizer against the JAX package.

Seeded numpy inputs go to both packages in fp32; the JAX side runs
`ops/grouped.py` in the Pallas interpreter (small blocks, so row tiles
straddle group boundaries), the port its plain versions (the CUDA kernel
is held to them on the card by chip_smoke.py). Tolerances: max-abs
<= 1e-5 on dense stacks (fp32 sums of 64-128 products of magnitude ~0.1,
in another order); rtol = atol = 2e-4 on quantized stacks (the
dequantized weights of both packages are the same fp32 numbers; outputs
reach ~2). The quantizer gives the JAX package's bytes exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import quantized as jq
from flash_attention_tpu.ops import grouped as jg
from flash_attention_tpu_torch.models import quantized as tq
from flash_attention_tpu_torch.ops import grouped as tg
from flash_attention_tpu_torch.utils.metrics import max_abs_error

BLOCKS = dict(block_m=128, block_f=128, block_k=128)
FP8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
       "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def _sizes(rng, e, total):
    """Random group sizes summing to total, some empty (as
    tests/test_grouped.py)."""
    cuts = np.sort(rng.integers(0, total + 1, e - 1))
    return np.diff(np.concatenate([[0], cuts, [total]])).astype(np.int32)


def _inputs(rng, total, e, k, f):
    x = rng.normal(0, 1, (total, k)).astype(np.float32)
    w = rng.normal(0, 0.1, (e, k, f)).astype(np.float32)
    return x, w, _sizes(rng, e, total)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _bytes(t):
    return t.view(torch.uint8) if t.element_size() == 1 else t


@pytest.mark.parametrize("total,e,k,f", [(96, 4, 64, 96), (300, 8, 128, 160)])
def test_grouped_matmul_matches_jax(rng, total, e, k, f):
    x, w, sizes = _inputs(rng, total, e, k, f)
    want = np.asarray(jg.grouped_matmul(jnp.asarray(x), jnp.asarray(sizes),
                                        jnp.asarray(w), **BLOCKS))
    got = tg.grouped_matmul(*_t(x, sizes, w))
    assert got.shape == (total, f) and got.dtype == torch.float32
    assert max_abs_error(got, want) <= 1e-5


def test_grouped_matmul_reference_matches_jax(rng):
    x, w, sizes = _inputs(rng, 150, 5, 64, 96)
    want = np.asarray(jg.grouped_matmul_reference(
        jnp.asarray(x), jnp.asarray(sizes), jnp.asarray(w)))
    got = tg.grouped_matmul_reference(*_t(x, sizes, w))
    assert max_abs_error(got, want) <= 1e-5
    assert max_abs_error(tg.grouped_matmul(*_t(x, sizes, w)), want) <= 1e-5


def test_rows_beyond_data_are_zero(rng):
    e, k, f = 3, 64, 128
    x = rng.normal(0, 1, (40, k)).astype(np.float32)
    sizes = np.asarray([10, 0, 15], np.int32)       # only 25 live rows
    w = rng.normal(0, 0.1, (e, k, f)).astype(np.float32)
    want = np.asarray(jg.grouped_matmul(jnp.asarray(x), jnp.asarray(sizes),
                                        jnp.asarray(w), block_m=8))
    got = tg.grouped_matmul(*_t(x, sizes, w))
    assert max_abs_error(got, want) <= 1e-5
    assert bool((got[25:] == 0).all())


@pytest.mark.parametrize("base", [17, "tensor"])
def test_base_offset(rng, base):
    """Group 0 starts at row `base` (an int or a 0-d tensor); rows before
    it and past the band come back zero."""
    e, k, f, total = 2, 64, 128, 64
    x = rng.normal(0, 1, (total, k)).astype(np.float32)
    w = rng.normal(0, 0.1, (e, k, f)).astype(np.float32)
    sizes = np.asarray([12, 20], np.int32)
    want = np.asarray(jg.grouped_matmul(jnp.asarray(x), jnp.asarray(sizes),
                                        jnp.asarray(w), base=17, block_m=8))
    tbase = 17 if base == 17 else torch.tensor(17, dtype=torch.int32)
    got = tg.grouped_matmul(*_t(x, sizes, w), base=tbase)
    assert max_abs_error(got, want) <= 1e-5
    assert bool((got[:17] == 0).all()) and bool((got[49:] == 0).all())


def test_empty_groups(rng):
    """Empty experts at the start, in the middle and at the end."""
    e, k, f, total = 6, 64, 96, 70
    x = rng.normal(0, 1, (total, k)).astype(np.float32)
    w = rng.normal(0, 0.1, (e, k, f)).astype(np.float32)
    sizes = np.asarray([0, 30, 0, 0, 40, 0], np.int32)
    want = np.asarray(jg.grouped_matmul(jnp.asarray(x), jnp.asarray(sizes),
                                        jnp.asarray(w), **BLOCKS))
    got = tg.grouped_matmul(*_t(x, sizes, w))
    assert max_abs_error(got, want) <= 1e-5


@pytest.mark.parametrize("kind", ["int8", "e4m3", "e5m2"])
def test_grouped_quant_matmul_matches_jax(rng, kind):
    jdt, tdt = (jnp.int8, torch.int8) if kind == "int8" else FP8[kind]
    e, k, f, total = 4, 128, 256, 120
    w = rng.normal(0, 0.1, (e, k, f)).astype(np.float32)
    stack = jq.quantize_expert_stack(w, dtype=jdt)
    x = rng.normal(0, 1, (total, k)).astype(np.float32)
    sizes = _sizes(rng, e, total)
    want = np.asarray(jg.grouped_quant_matmul(
        jnp.asarray(x), jnp.asarray(sizes), stack.q, stack.scale,
        block_m=64, block_f=128, block_k=128))
    mine = tq.quantize_expert_stack(torch.from_numpy(w), dtype=tdt)
    got = tg.grouped_quant_matmul(*_t(x, sizes), mine.q, mine.scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_grouped_int4_matmul_matches_jax(rng):
    e, k, f, total = 3, 256, 128, 100
    w = rng.normal(0, 0.1, (e, k, f)).astype(np.float32)
    stack = jq.quantize_expert_stack(w, dtype="int4")
    x = rng.normal(0, 1, (total, k)).astype(np.float32)
    sizes = _sizes(rng, e, total)
    want = np.asarray(jg.grouped_int4_matmul(
        jnp.asarray(x), jnp.asarray(sizes), stack.packed, stack.scales,
        block_m=64, block_f=128, block_k=64))
    mine = tq.quantize_expert_stack(torch.from_numpy(w), dtype="int4")
    got = tg.grouped_int4_matmul(*_t(x, sizes), mine.packed, mine.scales)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    # The int4 kernel on the card also takes a base band.
    got_b = tg.grouped_int4_matmul(*_t(x, sizes), mine.packed, mine.scales,
                                   base=5)
    want_b = np.asarray(jg.grouped_int4_matmul(
        jnp.asarray(x), jnp.asarray(sizes), stack.packed, stack.scales,
        base=5, block_m=64, block_f=128, block_k=64))
    np.testing.assert_allclose(got_b.numpy(), want_b, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kind", ["int8", "e4m3", "e5m2", "int4"])
def test_quantize_expert_stack_matches_jax_bytes(rng, kind):
    jdt, tdt = {"int8": (jnp.int8, torch.int8), "int4": ("int4", "int4"),
                **FP8}[kind]
    w = rng.normal(0, 0.05, (3, 256, 96)).astype(np.float32)
    w[1, :, 7] = 0.0                      # an all-zero channel
    want = jq.quantize_expert_stack(w, dtype=jdt)
    got = tq.quantize_expert_stack(torch.from_numpy(w), dtype=tdt)
    fields = ("packed", "scales") if kind == "int4" else ("q", "scale")
    for name in fields:
        mine = _bytes(getattr(got, name))
        ref = np.array(getattr(want, name))
        ref = torch.from_numpy(ref.view(np.uint8) if ref.itemsize == 1
                               else ref)
        assert mine.shape == ref.shape and torch.equal(mine, ref), name
    assert got.orig_shape == tuple(want.orig_shape) == (3, 256, 96)
    assert got.nbytes == want.nbytes


def test_grouped_cost():
    m, k, f, e = 16, 4096, 14336, 8
    flops, dense = tg.grouped_cost(m, k, f, e, "dense")
    assert flops == 2 * m * k * f
    assert dense == 2 * (m * k + m * f) + e * 2 * k * f
    _, q8 = tg.grouped_cost(m, k, f, e, "int8")
    assert q8 == 2 * (m * k + m * f) + e * (k * f + 4 * f)
    assert tg.grouped_cost(m, k, f, e, "fp8") == (flops, q8)
    _, q4 = tg.grouped_cost(m, k, f, e, "int4")
    assert q4 == 2 * (m * k + m * f) + e * (k * f // 2 + 4 * (k // 128) * f)
    # Only the experts that hold a row are read.
    assert tg.grouped_cost(m, k, f, 2, "int4")[1] < q4
    with pytest.raises(ValueError):
        tg.grouped_cost(m, k, f, e, "int2")


def test_wrapper_rejections():
    """The JAX wrappers' shape errors, and non-quantized storage."""
    x = torch.zeros(8, 64)
    sizes = torch.tensor([4, 4], dtype=torch.int32)
    with pytest.raises(ValueError, match="shape mismatch"):
        tg.grouped_matmul(x, sizes, torch.zeros(2, 32, 16))
    with pytest.raises(ValueError, match="shape mismatch"):
        tg.grouped_matmul(x, torch.tensor([8], dtype=torch.int32),
                          torch.zeros(2, 64, 16))
    with pytest.raises(ValueError, match="shape mismatch"):
        tg.grouped_quant_matmul(x, sizes, torch.zeros(2, 64, 16, dtype=torch.int8),
                                torch.ones(2, 8))
    with pytest.raises(TypeError, match="int8 or fp8"):
        tg.grouped_quant_matmul(x, sizes, torch.zeros(2, 64, 16),
                                torch.ones(2, 16))
    # int4: K must be a multiple of 128, the scales [E, K/128, F].
    with pytest.raises(ValueError, match="K % 128"):
        tg.grouped_int4_matmul(x, sizes, torch.zeros(2, 32, 16,
                                                     dtype=torch.int8),
                               torch.ones(2, 1, 16))
    x4 = torch.zeros(8, 256)
    with pytest.raises(ValueError, match="scales"):
        tg.grouped_int4_matmul(x4, sizes, torch.zeros(2, 128, 16,
                                                      dtype=torch.int8),
                               torch.ones(2, 1, 16))
    with pytest.raises(ValueError, match="multiple of 128"):
        tq.quantize_expert_stack(torch.zeros(2, 64, 16), dtype="int4")
