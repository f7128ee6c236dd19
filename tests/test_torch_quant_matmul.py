"""Port parity: the weight quantizers, the fp8 widening and the plain
versions of B6 (quant_matmul), B7 (int4_matmul) and B8 (dense_matmul)
in flash_attention_tpu_torch against the JAX package.

Seeded numpy inputs go to both packages (JAX: interpret-mode Pallas on
the CPU; port: the plain PyTorch version, since the tensors lie on the
CPU). Tolerances:
  * quantizers: identical bytes and scales;
  * fp8 widening: bit-identical to the JAX bit-plant on every finite
    code of e4m3 and e5m2 (NaN / inf codes differ on purpose);
  * products: rtol = atol = 2e-4, the JAX tests' own
    (tests/test_quant_weights.py), in fp32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import quantized as jq
from flash_attention_tpu.ops import quant_matmul as jqm
from flash_attention_tpu.ops.quant import tile_to_bf16 as jax_to_bf16
from flash_attention_tpu.ops.quant import tile_to_f32 as jax_to_f32
from flash_attention_tpu_torch.models import quantized as tq
from flash_attention_tpu_torch.ops import quant as tquant
from flash_attention_tpu_torch.ops import quant_matmul as tqm
from flash_attention_tpu_torch.utils.convert import params_from_jax

TOL = dict(rtol=2e-4, atol=2e-4)
DTYPES = {"int8": (jnp.int8, torch.int8),
          "e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn),
          "e5m2": (jnp.float8_e5m2, torch.float8_e5m2)}


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


@pytest.mark.parametrize("name", DTYPES)
def test_quantize_weight_bytes_match_jax(name):
    jd, td = DTYPES[name]
    w = np.random.default_rng(0).normal(0, 0.05, (256, 384)).astype(
        np.float32)
    w[:, 5] = 0.0                       # an all-zero channel (scale floor)
    qj, sj = jqm.quantize_weight(w, dtype=jd)
    qt, st = tqm.quantize_weight(w, dtype=td)
    assert qt.dtype == td and st.dtype == torch.float32
    np.testing.assert_array_equal(_bytes(qt), _bytes(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_quantize_weight_int4_bytes_match_jax():
    w = np.random.default_rng(1).normal(0, 0.05, (512, 200)).astype(
        np.float32)
    pj, sj = jqm.quantize_weight_int4(w)
    pt, st = tqm.quantize_weight_int4(w)
    assert pt.dtype == torch.int8 and pt.shape == (256, 200)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    with pytest.raises(ValueError):
        tqm.quantize_weight_int4(w[:100])


@pytest.mark.parametrize("name", ["e4m3", "e5m2"])
def test_fp8_widening_is_bit_exact_on_finite_codes(name):
    jd, td = DTYPES[name]
    codes = np.arange(256, dtype=np.uint8)
    got = tquant.tile_to_f32(torch.from_numpy(codes).view(td)).numpy()
    want = np.asarray(jax_to_f32(jnp.asarray(
        codes.view(jnp.dtype(jd)))))
    finite = np.isfinite(got)
    assert finite.sum() == (254 if name == "e4m3" else 248)
    np.testing.assert_array_equal(got.view(np.uint32)[finite],
                                  want.view(np.uint32)[finite])
    got16 = tquant.tile_to_bf16(torch.from_numpy(codes).view(td))
    want16 = np.asarray(jax_to_bf16(jnp.asarray(
        codes.view(jnp.dtype(jd)))))
    np.testing.assert_array_equal(
        got16.view(torch.uint16).numpy()[finite],
        want16.view(np.uint16)[finite])


CASES = [("int8", 8, 256, 512), ("int8", 3, 130, 257),
         ("int8", 256, 512, 128), ("e4m3", 8, 256, 512),
         ("e5m2", 8, 256, 512)]


@pytest.mark.parametrize("name,m,k,f", CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}x{c[3]}" for c in CASES])
def test_quant_matmul_plain_matches_jax(name, m, k, f):
    jd, td = DTYPES[name]
    rng = np.random.default_rng(m + k + f)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.05, (k, f)).astype(np.float32)
    qj, sj = jqm.quantize_weight(w, dtype=jd)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), qj, sj))
    qt, st = tqm.quantize_weight(w, dtype=td)
    got = tqm.quant_matmul(torch.from_numpy(x), qt, st)
    assert tqm.int8_matmul is tqm.quant_matmul
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_int4_matmul_plain_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(0, 0.05, (512, 384)).astype(np.float32)
    x = rng.normal(0, 1, (8, 512)).astype(np.float32)
    pj, sj = jqm.quantize_weight_int4(w)
    want = np.asarray(jqm.int4_matmul(jnp.asarray(x), pj, sj))
    pt, st = tqm.quantize_weight_int4(w)
    got = tqm.int4_matmul(torch.from_numpy(x), pt, st)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # The full nibble range -8..7 (random packed bytes, as
    # init_quantized_params draws them) unpacks as the JAX classes do.
    raw = rng.integers(0, 256, (64, 96)).astype(np.uint8).view(np.int8)
    sc = rng.uniform(0.01, 0.1, (1, 96)).astype(np.float32)
    jw = jq.Int4Weight(packed=jnp.asarray(raw), scales=jnp.asarray(sc),
                       orig_shape=(128, 96), n_contract=1)
    np.testing.assert_array_equal(
        tqm.int4_dequant(torch.from_numpy(raw), torch.from_numpy(sc),
                         torch.float32).numpy(),
        np.asarray(jw.dequant(jnp.float32)))


def test_dense_matmul_plain_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (13, 200)).astype(np.float32)
    w = rng.normal(0, 1, (200, 300)).astype(np.float32)
    want = np.asarray(jqm.dense_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = tqm.dense_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_plain_versions_round_like_the_kernel():
    """bf16 activations: B6 scales the fp32 sum once and rounds once; B7
    rounds each weight times its scale to bf16 before the product."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0, 1, (4, 128)).astype(np.float32))
    w = rng.normal(0, 0.05, (128, 64)).astype(np.float32)
    xb = x.to(torch.bfloat16)
    q, s = tqm.quantize_weight(w)
    want = ((xb.float() @ q.float()) * s).to(torch.bfloat16)
    assert torch.equal(tqm.quant_matmul(xb, q, s), want)
    p, sc = tqm.quantize_weight_int4(w)
    wq = (tqm.int4_unpack(p).float() * sc.repeat_interleave(128, 0)).to(
        torch.bfloat16)
    want4 = (xb.float() @ wq.float()).to(torch.bfloat16)
    assert torch.equal(tqm.int4_matmul(xb, p, sc), want4)


# Shapes of tests/test_quant_weights.py:38-44 (int8); for int4 the
# contracted size must be a multiple of 128.
SPECS = [
    ("btd,dhk->bhtk", (2, 3, 64), (64, 4, 32), 1),
    ("bhtk,hkd->btd", (2, 4, 3, 32), (4, 32, 64), 2),
    ("btd,df->btf", (2, 3, 64), (64, 96), 1),
    ("btf,fd->btd", (2, 3, 96), (96, 64), 1),
    ("bd,dv->bv", (2, 64), (64, 100), 1),
]
SPECS4 = [
    ("btd,dhk->bhtk", (2, 3, 128), (128, 4, 32), 1),
    ("bhtk,hkd->btd", (2, 4, 3, 32), (4, 32, 64), 2),
    ("btd,df->btf", (2, 3, 128), (128, 96), 1),
    ("btf,fd->btd", (2, 3, 256), (256, 64), 1),
    ("bd,dv->bv", (2, 128), (128, 100), 1),
    # Over 1024 activation rows: the wide (dequantize + dense) path.
    ("btd,df->btf", (2, 520, 128), (128, 96), 1),
]


@pytest.mark.parametrize("quant", ["int8", "int4"])
def test_weight_einsum_matches_jax_classes(quant):
    """QuantizedWeight.einsum / Int4Weight.einsum on every spec the model
    uses, against the JAX classes on the same quantized bytes (carried
    across with params_from_jax), plus one product over 1024 rows."""
    rng = np.random.default_rng(6)
    specs = SPECS4 if quant == "int4" else SPECS + [SPECS4[-1]]
    for spec, xshape, wshape, ncon in specs:
        x = rng.normal(0, 1, xshape).astype(np.float32)
        w = rng.normal(0, 0.05, wshape).astype(np.float32)
        jw = jq.quantize_tensor(w, ncon, dtype="int4" if quant == "int4"
                                else jnp.int8)
        tw = params_from_jax(
            {"w": jax.tree.map(np.asarray, jw)}, device="cpu")["w"]
        assert isinstance(tw, tq.Int4Weight if quant == "int4"
                          else tq.QuantizedWeight)
        want = np.asarray(jw.einsum(spec, jnp.asarray(x)))
        got = tw.einsum(spec, torch.from_numpy(x))
        assert got.shape == want.shape, spec
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-4, atol=3e-4,
                                   err_msg=spec)
        np.testing.assert_allclose(
            tw.dequant(torch.float32).numpy(),
            np.asarray(jw.dequant(jnp.float32)), rtol=0, atol=0)


def test_costs_count_each_byte_once():
    m, k, f = 16, 4096, 14336
    assert tqm.quant_matmul_cost(m, k, f) == (
        2 * m * k * f, 2 * (m * k + m * f) + k * f + 4 * f)
    assert tqm.dense_matmul_cost(m, k, f) == (
        2 * m * k * f, 2 * (m * k + m * f) + 2 * k * f)
    assert tqm.int4_matmul_cost(m, k, f) == (
        2 * m * k * f, 2 * (m * k + m * f) + k * f // 2 + 4 * 32 * f)


def test_wrapper_checks():
    x = torch.zeros(4, 256)
    q, s = tqm.quantize_weight(np.ones((256, 8), np.float32))
    with pytest.raises(ValueError):
        tqm.quant_matmul(x[:, :200], q, s)
    with pytest.raises(ValueError):
        tqm.quant_matmul(x, q, s[:4])
    with pytest.raises(TypeError):
        tqm.quant_matmul(x, q.float(), s)
    p, sc = tqm.quantize_weight_int4(np.ones((256, 8), np.float32))
    with pytest.raises(ValueError):
        tqm.int4_matmul(x, p, sc[:1])
    with pytest.raises(ValueError):
        tqm.dense_matmul(x, torch.zeros(100, 8))


@pytest.mark.parametrize("case", ["fp32", "device", "contiguous",
                                  "dense-dtype"])
def test_cuda_wrappers_reject_what_the_kernel_does_not_take(case):
    """The kernel launchers check activations, devices and layouts before
    they touch the library, so these raise without a card."""
    x = torch.zeros(4, 256, dtype=torch.bfloat16)
    q, s = tqm.quantize_weight(np.ones((256, 8), np.float32))
    if case == "fp32":
        with pytest.raises(TypeError, match="fp16/bf16"):
            tqm._quant_matmul_cuda(x.float(), q, s)
    elif case == "device":
        with pytest.raises(ValueError, match="on"):
            tqm._int4_matmul_cuda(x, q.to("meta"), s)
    elif case == "contiguous":
        with pytest.raises(ValueError, match="contiguous"):
            tqm._quant_matmul_cuda(x, q.t().contiguous().t(), s)
    else:
        with pytest.raises(TypeError, match="dtype"):
            tqm._dense_matmul_cuda(x, torch.zeros(256, 8))
