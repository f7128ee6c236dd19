"""Port parity: P1 (the int4 unpack variants) and P3 (the fused int4
lm_head + greedy argmax) as the split-K decode body of
flash_attention_tpu_torch/csrc/matmul_sm90.cuh computes them, against
the JAX package's int4_matmul (interpret-mode Pallas on the CPU, as
tests/test_torch_probes.py runs it).

The kernels run only on the card; their step-by-step plain twins run
here: `probe_lmhead_argmax.lmhead_argmax_tiled` (fp32 sums one 128-row K
step at a time, one winner per 64-column tile, tiles combined into chunk
slots and slots into a row by the kernels' 64-bit key order) and
`probe_int4_variants.int4_variant_split` (x in 64-row slices, K cut into
the decode body's splits, v1's correction grown a step at a time and
carried by each split's partial, partials summed in split order). Also
the routing rule that picks the decode body or the first body, and the
launch plans at the probes' shapes. All in fp32. Tolerances: values /
products rtol = atol = 2e-4 (the JAX tests' own for int4_matmul,
tests/test_quant_weights.py); ids identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops import quant_matmul as jqm
from flash_attention_tpu_torch.ops.quant_matmul import (
    SM_COUNT,
    decode_split_plan,
)
from flash_attention_tpu_torch.scripts import probe_int4_variants as p1
from flash_attention_tpu_torch.scripts import probe_lmhead_argmax as p3
from flash_attention_tpu_torch.scripts._common import int4_probe_body

TOL = dict(rtol=2e-4, atol=2e-4)


def _jax_logits(x, packed, scales) -> np.ndarray:
    return np.asarray(jqm.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                      jnp.asarray(scales)))


# --- P3: the per-tile twin -------------------------------------------------


def _p3_case(name):
    """(x, w) of one P3 case, K = 256."""
    rng = np.random.default_rng(7)
    k = 256
    if name == "tie across two tiles":
        # Columns 10 (tile 0) and 500 (tile 7) equal and the largest.
        w = rng.normal(0, 1e-3, (k, 1000)).astype(np.float32)
        w[:, 10] = w[:, 500] = 0.05
        return np.full((1, k), 0.5, np.float32), w
    if name == "ragged last tile":
        # V = 1000: the last 64-column tile holds 40 real columns.
        w = rng.normal(0, 0.02, (k, 1000)).astype(np.float32)
        return rng.normal(0, 0.5, (6, k)).astype(np.float32), w
    if name == "all-negative row":
        w = (np.abs(rng.normal(0, 0.02, (k, 1000))) + 1e-3).astype(
            np.float32)
        return -np.abs(rng.normal(0, 0.5, (1, k))).astype(np.float32), w
    # "-0 / +0 tie": x = 0, so every logit is a zero of either sign; the
    # lowest column wins whatever the signs.
    w = rng.normal(0, 0.02, (k, 1000)).astype(np.float32)
    w[:, :5] = -np.abs(w[:, :5])
    return np.zeros((2, k), np.float32), w


@pytest.mark.parametrize("chunk", p3.CHUNKS)
@pytest.mark.parametrize("name", ["tie across two tiles", "ragged last tile",
                                  "all-negative row", "-0 / +0 tie"])
def test_p3_tiled_twin_matches_jax_int4_matmul_argmax(name, chunk):
    x, w = _p3_case(name)
    packed, scales = p3.quantize_weight_int4(w)
    logits = _jax_logits(x, packed.numpy(), scales.numpy())
    ids, vals = p3.lmhead_argmax_tiled(torch.from_numpy(x), packed, scales,
                                       chunk=chunk)
    assert ids.dtype == torch.int32 and vals.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.argmax(logits, -1))
    np.testing.assert_allclose(vals.numpy(), logits.max(-1), **TOL)
    if name == "tie across two tiles":
        assert ids.tolist() == [10]
    if name == "all-negative row":
        assert float(vals[0]) < 0
    if name == "-0 / +0 tie":
        assert ids.tolist() == [0, 0] and vals.tolist() == [0.0, 0.0]


def test_p3_key_order_counts_minus_zero_as_plus_zero():
    """Tile winners combine by the kernels' key order: a -0 at column 5
    (tile 0) ties a +0 at column 300 (tile 4) and wins as the lower
    column, where bit order would rank -0 below +0; the value comes back
    as +0."""
    logits = torch.full((1, 1000), -1.0)
    logits[0, 5] = -0.0
    logits[0, 300] = 0.0
    ids, vals = p3.argmax_by_tiles(logits, 1024)
    assert ids.tolist() == [5] == np.argmax(logits.numpy(), -1).tolist()
    assert vals.tolist() == [0.0] and not torch.signbit(vals).any()
    keys = p3.argmax_key(np.array([-0.0, 0.0, -1.0, 1.0], np.float32),
                         np.array([5, 300, 2, 7]))
    assert keys[0] > keys[1] > keys[2] and keys[3] > keys[0]


def test_p3_tiled_twin_matches_the_plain_version():
    rng = np.random.default_rng(8)
    w = rng.normal(0, 0.02, (384, 777)).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 0.5, (70, 384)).astype(np.float32))
    packed, scales = p3.quantize_weight_int4(w)
    ids, vals = p3.lmhead_argmax_tiled(x, packed, scales)
    pids, pvals = p3.lmhead_argmax_plain(x, packed, scales)
    assert torch.equal(ids, pids)
    np.testing.assert_allclose(vals.numpy(), pvals.numpy(), **TOL)


# --- P1: the split twin ----------------------------------------------------


@pytest.mark.parametrize("variant", [1, 2])
@pytest.mark.parametrize("m, k, splits, k_chunk", [
    (8, 512, 1, 512),      # one split
    (8, 512, 2, 256),      # two splits of two 128-row steps
    (8, 640, 2, 384),      # a shorter last split
    (70, 512, 2, 256),     # x across two 64-row slices
])
def test_p1_split_twin_matches_jax_int4_matmul(variant, m, k, splits,
                                               k_chunk):
    rng = np.random.default_rng(9)
    f = 384
    w = rng.normal(0, 0.02, (k, f)).astype(np.float32)
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    want = np.asarray(jqm.int4_matmul(jnp.asarray(x),
                                      *jqm.quantize_weight_int4(w)))
    packed, scales = p1.pack_offset_binary(w)
    xt = torch.from_numpy(x)
    got = p1.int4_variant_split(xt, packed, scales, variant, splits=splits,
                                k_chunk=k_chunk)
    assert got.shape == (m, f) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = p1.int4_variant_plain(xt, packed, scales, variant)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_p1_split_twin_defaults_to_the_launch_plan():
    rng = np.random.default_rng(10)
    w = rng.normal(0, 0.02, (256, 128)).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 1.0, (3, 256)).astype(np.float32))
    packed, scales = p1.pack_offset_binary(w)
    splits, k_chunk, _ = p1.launch_plan(3, 256, 128)
    for variant in (1, 2):
        assert torch.equal(
            p1.int4_variant_split(x, packed, scales, variant),
            p1.int4_variant_split(x, packed, scales, variant, splits=splits,
                                  k_chunk=k_chunk))


# --- routing and launch plans ----------------------------------------------


def _operands(m, k, f, *, x_offset=0, w_offset=0):
    """x [m, k] bf16, packed [k/2, f] uint8 and scales [k/128, f] fp32 on
    the CPU, x's and the weight's base `offset` elements into a buffer."""
    x = torch.zeros(m * k + x_offset, dtype=torch.bfloat16)[x_offset:]
    w = torch.zeros(k // 2 * f + w_offset, dtype=torch.uint8)[w_offset:]
    scales = torch.zeros((k // 128, f))
    return x.view(m, k), w.view(k // 2, f), scales


@pytest.mark.parametrize("case, body", [
    (dict(m=32, k=4096, f=14336), "decode"),      # P1's shape
    (dict(m=32, k=4096, f=128256), "decode"),     # P3's shape
    (dict(m=200, k=256, f=5008), "decode"),       # any M; V % 16 == 0
    (dict(m=3, k=256, f=5000), "first"),          # rows of 5000 bytes
    (dict(m=3, k=256, f=5000 + 4), "first"),      # F % 16 == 4
    (dict(m=3, k=256, f=512, x_offset=1), "first"),   # x base 2 bytes off
    (dict(m=3, k=256, f=512, w_offset=8), "first"),   # weight base 8 off
])
def test_int4_probe_body_routes_by_alignment(case, body):
    assert int4_probe_body(*_operands(**case)) == body


def test_split_plans_at_the_probe_shapes():
    # P1 at (32, 4096, 14336): 2 splits of 3456 rows, 224 column tiles.
    assert decode_split_plan(4096, 14336) == (2, 3456)
    assert p1.launch_plan(32, 4096, 14336) == (2, 3456, 1)
    assert p1.launch_plan(200, 4096, 14336) == (2, 3456, 4)
    # P3's lm_head: the 2004 column tiles fill the card with one split.
    assert decode_split_plan(4096, 128256)[0] == 1


@pytest.mark.parametrize("chunk", p3.CHUNKS)
def test_p3_launch_plan_keeps_two_blocks_an_sm(chunk):
    """The chunk selects the key slots, not the grid: at every width the
    probe's shape runs 2004 blocks (over two an SM), one split."""
    plan = p3.launch_plan(32, 128256, chunk)
    assert plan["blocks"] == 2004 >= 2 * SM_COUNT and plan["splits"] == 1
    assert plan["slots"] == -(-128256 // chunk)
    assert plan["tiles_per_slot"] * 64 == chunk
    assert p3.launch_plan(200, 128256, chunk)["blocks"] == 4 * 2004
