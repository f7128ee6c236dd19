"""Port parity: the probes of flash_attention_tpu_torch/scripts (P1, the
int4 unpack variants; P2 v2, the blocked int8 paged-decode body; P3, the
fused int4 lm_head + greedy argmax) against the JAX package functions
each JAX probe checks itself against.

The JAX probes (scripts/probe_*.py) run their work when imported, at
full size, so they are not imported here. Seeded numpy inputs go to the
JAX package (interpret-mode Pallas on the CPU, as its own tests run it)
and to the port's wrappers, whose CPU tensors run the plain PyTorch
versions. All in fp32. Tolerances:
  * P1 packer: scales bit-identical to quantize_weight_int4's, nibbles
    equal to its codes + 8; v1 / v2 products rtol = atol = 2e-4 (the
    JAX tests' own for int4_matmul, tests/test_quant_weights.py);
  * P2 v2: O and LSE max-abs <= 2e-5 of the largest |O| (the port's
    paged-decode parity tolerance, tests/test_torch_paged.py);
  * P3: ids identical to jnp.argmax of JAX int4_matmul, values within
    2e-4 of its row max; ties to the lowest index; an all-negative row
    gets its real argmax where the JAX probe's zero-padded vocab gives
    a padded column.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops import quant_matmul as jqm
from flash_attention_tpu.ops.paged import (
    paged_decode_reference as jax_paged_reference,
)
from flash_attention_tpu.ops.paged import paged_flash_decode as jax_paged
from flash_attention_tpu_torch.scripts import probe_int4_variants as p1
from flash_attention_tpu_torch.scripts import probe_lmhead_argmax as p3
from flash_attention_tpu_torch.scripts import probe_paged_int8 as p2

TOL = dict(rtol=2e-4, atol=2e-4)
ATOL = 2e-5


def _jax_int4_codes(packed) -> np.ndarray:
    """quantize_weight_int4's two's-complement nibbles as int [K, F]."""
    b = np.asarray(packed).astype(np.int32) & 0xFF
    lo, hi = ((b & 0xF) ^ 8) - 8, (((b >> 4) & 0xF) ^ 8) - 8
    return np.stack([lo, hi], axis=1).reshape(2 * b.shape[0], b.shape[1])


# --- P1 -------------------------------------------------------------------


def test_offset_binary_packer_matches_quantize_weight_int4():
    w = np.random.default_rng(0).normal(0, 0.02, (256, 384)).astype(
        np.float32)
    w[:, 7] = 0.0                        # an all-zero column (scale floor)
    pj, sj = jqm.quantize_weight_int4(w)
    packed, scales = p1.pack_offset_binary(w)
    assert packed.dtype == torch.uint8 and packed.shape == (128, 384)
    np.testing.assert_array_equal(scales.numpy(), np.asarray(sj))
    nibbles = p1.unpack_offset_binary(packed).numpy()
    np.testing.assert_array_equal(nibbles, _jax_int4_codes(pj) + 8)
    assert nibbles.min() >= 1 and nibbles.max() <= 15


@pytest.mark.parametrize("variant", [1, 2])
def test_int4_variant_plain_matches_jax_int4_matmul(variant):
    rng = np.random.default_rng(1)
    m, k, f = 8, 256, 384
    w = rng.normal(0, 0.02, (k, f)).astype(np.float32)
    x = rng.normal(0, 1.0, (m, k)).astype(np.float32)
    want = np.asarray(jqm.int4_matmul(jnp.asarray(x),
                                      *jqm.quantize_weight_int4(w)))
    packed, scales = p1.pack_offset_binary(w)
    got = p1.int4_variant_matmul(torch.from_numpy(x), packed, scales,
                                 variant)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_int4_variant_rejects_bad_arguments():
    packed, scales = p1.pack_offset_binary(np.ones((256, 8), np.float32))
    x = torch.zeros(2, 256)
    with pytest.raises(ValueError, match="variant"):
        p1.int4_variant_matmul(x, packed, scales, 3)
    with pytest.raises(ValueError, match="shape"):
        p1.int4_variant_matmul(x[:, :128], packed, scales, 1)
    with pytest.raises(TypeError, match="bf16"):
        p1._variant_cuda(x, packed, scales, 1)


# --- P2 v2 ----------------------------------------------------------------

P2_LENGTHS = [100, 300, 640]       # one below a 128-token block


def _p2_setup(seed=3, b=3, hq=4, hkv=2, d=64, ps=256, pages=8, width=3):
    rng = np.random.default_rng(seed)
    kf = rng.normal(0, 1.0, (hkv, pages, ps, d)).astype(np.float32)
    vf = rng.normal(0, 1.0, (hkv, pages, ps, d)).astype(np.float32)
    # Blocks whose scales differ by orders of magnitude.
    kf *= 10.0 ** rng.integers(-2, 3, (hkv, pages, ps // 128, 1, 1)) \
        .repeat(128, axis=2).reshape(hkv, pages, ps, 1)
    q = rng.normal(0, 0.1, (b, hq, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, pages))
    table = np.zeros((b, width), np.int32)
    at = 0
    for i, n in enumerate(P2_LENGTHS):
        need = -(-n // ps)
        table[i, :need] = perm[at:at + need]
        at += need
    return q, kf, vf, table, np.asarray(P2_LENGTHS, np.int32)


def test_p2_quantize_pool_is_the_jax_probes():
    """quantize_pool gives the JAX probe's make_pools codes and scales
    (per 128-token block and channel, max |x| / 127, round, clip)."""
    _, kf, _, _, _ = _p2_setup()
    h, n, ps, d = kf.shape
    xr = kf.reshape(h, n, ps // 128, 128, d)
    sc = np.maximum(np.abs(xr).max(axis=3, keepdims=True) / 127.0, 1e-8)
    q = np.clip(np.round(xr / sc), -127, 127).astype(np.int8)
    codes, scales = p2.quantize_pool(torch.from_numpy(kf))
    np.testing.assert_array_equal(codes.numpy(), q.reshape(kf.shape))
    np.testing.assert_array_equal(scales.numpy(), sc[..., 0, :])


def test_p2_v2_plain_matches_jax_paged_decode_and_reference():
    q, kf, vf, table, lengths = _p2_setup()
    kq, ks = p2.quantize_pool(torch.from_numpy(kf))
    vq, vs = p2.quantize_pool(torch.from_numpy(vf))
    jargs = (jnp.asarray(q), jnp.asarray(kq.numpy()),
             jnp.asarray(vq.numpy()), jnp.asarray(table),
             jnp.asarray(lengths))
    jkw = dict(k_scales=jnp.asarray(ks.numpy()),
               v_scales=jnp.asarray(vs.numpy()))
    o_j, lse_j = jax_paged(*jargs, return_lse=True, **jkw)
    ref = np.asarray(jax_paged_reference(*jargs, **jkw))
    o_t, lse_t = p2.paged_int8_v2(torch.from_numpy(q), kq, vq, ks, vs,
                                  torch.from_numpy(table),
                                  torch.from_numpy(lengths))
    o_j = np.asarray(o_j)
    top = float(np.abs(o_j).max())
    assert float(np.abs(o_t.numpy() - o_j).max()) <= ATOL * top
    assert float(np.abs(o_t.numpy() - ref).max()) <= ATOL * top
    assert float(np.abs(lse_t.numpy() - np.asarray(lse_j)).max()) <= ATOL \
        * float(np.abs(np.asarray(lse_j)).max())


def test_p2_v2_rejects_what_the_kernel_does_not_take():
    q, kf, vf, table, lengths = _p2_setup(ps=256)
    kq, ks = p2.quantize_pool(torch.from_numpy(kf))
    with pytest.raises(ValueError, match="scales"):
        p2.paged_int8_v2(torch.from_numpy(q), kq, kq, ks[:, :1], ks,
                         torch.from_numpy(table), torch.from_numpy(lengths))
    with pytest.raises(TypeError, match="bf16"):
        p2._v2_cuda(torch.from_numpy(q), kq, kq, ks, ks,
                    torch.from_numpy(table), torch.from_numpy(lengths),
                    scale=0.125)


# --- P3 -------------------------------------------------------------------


def _p3_jax(x, packed, scales):
    logits = np.asarray(jqm.int4_matmul(jnp.asarray(x), jnp.asarray(packed),
                                        jnp.asarray(scales)))
    return np.argmax(logits, -1), logits.max(-1)


def test_p3_plain_matches_jax_int4_matmul_argmax():
    """V = 1000: the last chunk of every compiled width is ragged."""
    rng = np.random.default_rng(4)
    k, v = 256, 1000
    w = rng.normal(0, 0.02, (k, v)).astype(np.float32)
    x = rng.normal(0, 0.5, (4, k)).astype(np.float32)
    packed, scales = p3.quantize_weight_int4(w)
    ids_j, vals_j = _p3_jax(x, packed.numpy(), scales.numpy())
    ids, vals = p3.lmhead_argmax(torch.from_numpy(x), packed, scales)
    assert ids.dtype == torch.int32 and vals.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    np.testing.assert_allclose(vals.numpy(), vals_j, **TOL)


def test_p3_all_negative_row_gets_its_real_argmax():
    """Positive weights and a negative row: every real logit < 0. The
    port reduces over the V real columns; the JAX probe pads V to a
    multiple of its chunk with zero columns (probe_lmhead_argmax.py
    :98-108), whose logit 0 wins such a row."""
    rng = np.random.default_rng(5)
    k, v, chunk = 256, 1000, 1024
    w = (np.abs(rng.normal(0, 0.02, (k, v))) + 1e-3).astype(np.float32)
    x = -np.abs(rng.normal(0, 0.5, (1, k))).astype(np.float32)
    packed, scales = p3.quantize_weight_int4(w)
    ids, vals = p3.lmhead_argmax(torch.from_numpy(x), packed, scales)
    ids_j, vals_j = _p3_jax(x, packed.numpy(), scales.numpy())
    assert float(vals[0]) < 0 and int(ids[0]) == int(ids_j[0]) < v
    np.testing.assert_allclose(vals.numpy(), vals_j, **TOL)
    pad = ((0, 0), (0, chunk - v))
    ids_pad, vals_pad = _p3_jax(x, np.pad(packed.numpy(), pad),
                                np.pad(scales.numpy(), pad))
    assert int(ids_pad[0]) >= v and float(vals_pad[0]) == 0.0


def test_p3_exact_tie_goes_to_the_lowest_index():
    """Columns 10 and 500 are equal and the largest, so their logits tie
    exactly; a zero row ties every column. Both go to the lowest index,
    as jnp.argmax and the probe's strict > do."""
    rng = np.random.default_rng(6)
    k, v = 256, 1000
    w = rng.normal(0, 1e-3, (k, v)).astype(np.float32)
    w[:, 10] = w[:, 500] = 0.05
    x = np.stack([np.full(k, 0.5), np.zeros(k)]).astype(np.float32)
    packed, scales = p3.quantize_weight_int4(w)
    ids, vals = p3.lmhead_argmax(torch.from_numpy(x), packed, scales)
    ids_j, _ = _p3_jax(x, packed.numpy(), scales.numpy())
    assert ids.tolist() == [10, 0] == ids_j.tolist()
    assert float(vals[1]) == 0.0


# --- entry points ---------------------------------------------------------


@pytest.mark.parametrize("module, argv, lines", [
    (p1, ["--m", "8", "--k", "256", "--f", "384"], 7),
    (p2, ["--b", "2", "--hq", "4", "--hkv", "2", "--d", "64", "--ctx",
          "512"], 6),
    (p3, ["--m", "4", "--k", "256", "--v", "1000"], 5),
])
def test_probe_main_runs_on_the_cpu(module, argv, lines, capsys):
    assert module.main(["--device", "cpu", *argv]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0].startswith("device: cpu") and len(out) == lines
    assert all(" us " in line for line in out[1:]
               if not line.startswith("v3"))


@pytest.mark.parametrize("module", [p1, p2, p3])
def test_probe_run_returns_its_rows(module):
    sizes = {p1: dict(m=4, k=256, f=256),
             p2: dict(b=2, hq=4, hkv=2, d=64, ctx=512),
             p3: dict(m=2, k=256, v=300)}[module]
    rows = module.run(device="cpu", timer=lambda fn: (fn(), 1.0)[1],
                      out=lambda _: None, **sizes)
    assert rows and all({"name", "ms", "bound_ms", "bound_by",
                         "plain_ms"} <= set(r) for r in rows)
    assert all(r["ms"] == 1.0 for r in rows)


def test_probe_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    for module in (p1, p2, p3):
        with pytest.raises(RuntimeError, match="CUDA"):
            module.main([])


def test_p2_v2_reference_scale_default():
    """scale defaults to 1 / sqrt(D), as paged_flash_decode's."""
    q, kf, vf, table, lengths = _p2_setup()
    kq, ks = p2.quantize_pool(torch.from_numpy(kf))
    vq, vs = p2.quantize_pool(torch.from_numpy(vf))
    args = (torch.from_numpy(q), kq, vq, ks, vs, torch.from_numpy(table),
            torch.from_numpy(lengths))
    a = p2.paged_int8_v2(*args)
    b = p2.paged_int8_v2(*args, scale=1.0 / math.sqrt(q.shape[-1]))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
