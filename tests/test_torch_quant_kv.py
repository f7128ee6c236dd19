"""Port parity: the quantized KV cache of flash_attention_tpu_torch against
the JAX package.

The same seeded numpy inputs go through both packages on the CPU (JAX:
interpret-mode Pallas; port: the plain PyTorch versions, since the
tensors lie on the CPU), in fp32:

  * quantize_kv / dequantize_kv / quantization_error (tests/test_decode.py
    :25, :32, :40): codes bit-equal for int8, e4m3 and e5m2, scales
    equal;
  * B5 over QuantizedTensor caches, windowed too (test_decode.py :73,
    :85, :95, :113), B1's quantized branch (test_flash_fwd.py :113, :132,
    :148), B4 over quantized pools with window starts and the
    fold_scales body (test_paged.py :127, :145, :235, :259): max-abs <=
    2e-5; every input has 128-token blocks whose scales differ by orders
    of magnitude, so reading a wrong scale row fails;
  * PagedKVCache and the quantized LayeredPagedKVCache under the same
    writes and requantizing flushes (test_quant_serving.py :30, :136):
    codes and scales bit-equal, decode within 2e-5;
  * the perplexity-delta gate (test_quant_serving.py :110): teacher-forced
    NLLs within 1e-4 of the JAX package's (e5m2) and |delta ppl| <= 0.05
    max(ppl, 1) for int8, e4m3 and e5m2;
  * the engine (test_quant_serving.py :73, chunked prefill with the
    prefix cache, a windowed model): greedy transcripts and stats
    identical to the JAX engine's, one JAX engine per KV dtype and path
    (test_prefix_cache.py:187 is in test_torch_prefix_cache.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import llama as jllama
from flash_attention_tpu.ops import decode as jdec
from flash_attention_tpu.ops import flash as jflash
from flash_attention_tpu.ops import paged as jpaged
from flash_attention_tpu.ops import quant as jquant
from flash_attention_tpu.runtime import engine as jeng
from flash_attention_tpu.runtime import kv_cache as jkv
from flash_attention_tpu_torch.models import llama as tllama
from flash_attention_tpu_torch.ops import decode as tdec
from flash_attention_tpu_torch.ops import flash as tflash
from flash_attention_tpu_torch.ops import paged as tpaged
from flash_attention_tpu_torch.ops import quant as tquant
from flash_attention_tpu_torch.ops.reference import attention_reference
from flash_attention_tpu_torch.runtime import engine as teng
from flash_attention_tpu_torch.runtime import kv_cache as tkv
from flash_attention_tpu_torch.utils.convert import params_from_jax
from flash_attention_tpu_torch.utils.metrics import max_abs_error, verify

ATOL = 2e-5
PAGE = 128
KINDS = {"int8": (torch.int8, jnp.int8),
         "e4m3": (torch.float8_e4m3fn, jnp.float8_e4m3fn),
         "e5m2": (torch.float8_e5m2, jnp.float8_e5m2)}


def _spread(rng, shape, axis, std=0.1):
    """N(0, std^2) values whose 128-row blocks along `axis` are scaled by
    factors between e^-3 and e^3."""
    x = rng.normal(0, std, shape)
    fshape = list(shape)
    fshape[axis] //= 128
    f = np.repeat(np.exp(rng.uniform(-3, 3, fshape)), 128, axis=axis)
    return (x * f).astype(np.float32)


def _codes(t):
    """Port codes as uint8 bytes."""
    return t.view(torch.uint8).numpy()


def _jcodes(a):
    return np.asarray(a).view(np.uint8)


def _qt_pair(x, kind):
    """(JAX QuantizedTensor, port QuantizedTensor) of the same fp32
    input; their codes and scales must be equal."""
    tdt, jdt = KINDS[kind]
    jq = jquant.quantize_kv(jnp.asarray(x), dtype=jdt)
    tq = tquant.quantize_kv(torch.from_numpy(x), dtype=tdt)
    np.testing.assert_array_equal(_codes(tq.values), _jcodes(jq.values))
    np.testing.assert_array_equal(tq.scales.numpy(), np.asarray(jq.scales))
    return jq, tq


# --- quantize_kv ---------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
def test_quantize_kv_matches_jax(rng, kind):
    """:25 / :32 / :40 -- codes bit-equal, scales equal, the dequantized
    values and the round-trip error equal, the JAX bounds hold."""
    x = _spread(rng, (2, 4, 512, 128), 2)
    jq, tq = _qt_pair(x, kind)
    assert tq.shape == x.shape and tq.dtype == KINDS[kind][0]
    assert tuple(tq.scales.shape) == (2, 4, 512 // tquant.QUANT_BLOCK, 128)
    back = tquant.dequantize_kv(tq, torch.float32)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jquant.dequantize_kv(jq, jnp.float32)))
    plain = rng.normal(0, 0.02, (1, 2, 256, 64)).astype(np.float32)
    tdt, jdt = KINDS[kind]
    err = tquant.quantization_error(torch.from_numpy(plain), dtype=tdt)
    assert err == pytest.approx(
        jquant.quantization_error(jnp.asarray(plain), dtype=jdt), rel=1e-6)
    if kind == "int8":
        assert err < 0.02 / 127 * 4
    elif kind == "e4m3":
        assert err < 0.02 * 5 * 2 ** -3.5
    with pytest.raises(ValueError, match="multiple"):
        tquant.quantize_kv(torch.zeros(1, 1, 100, 64))


# --- B5 --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("window", [None, 200])
def test_flash_decode_quantized_matches_jax(rng, kind, window):
    """:73 / :85 -- B5 over quantized caches (and under a window)."""
    b, hq, hkv, s, d = 3, 8, 2, 512, 64
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    jk, tk = _qt_pair(_spread(rng, (b, hkv, s, d), 2), kind)
    jv, tv = _qt_pair(_spread(rng, (b, hkv, s, d), 2), kind)
    lengths = np.asarray([512, 300, 129], np.int32)
    want = np.asarray(jdec.flash_decode(
        jnp.asarray(q), jk, jv, jnp.asarray(lengths), block_kv=256,
        window=window))
    got = tdec.flash_decode(torch.from_numpy(q), tk, tv,
                            torch.from_numpy(lengths), window=window)
    assert max_abs_error(got, want) <= ATOL
    ref_j = np.asarray(jdec.decode_reference(
        jnp.asarray(q), jk, jv, jnp.asarray(lengths), window=window))
    ref_t = tdec.decode_reference(torch.from_numpy(q), tk, tv,
                                  torch.from_numpy(lengths), window=window)
    assert max_abs_error(ref_t, ref_j) <= ATOL
    assert max_abs_error(got, ref_t) <= ATOL


def test_decode_quantization_accuracy_end_to_end(rng):
    """:95 -- int8 decode against the exact reference on the original
    cache: max-abs within the V cache's int8 bound, small mean relative
    error."""
    q = torch.from_numpy(rng.normal(0, 0.02, (2, 4, 128)).astype(np.float32))
    k = torch.from_numpy(rng.normal(0, 0.02, (2, 2, 512, 128))
                         .astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 0.02, (2, 2, 512, 128))
                         .astype(np.float32))
    lengths = torch.tensor([512, 384], dtype=torch.int32)
    out = tdec.flash_decode(q, tquant.quantize_kv(k), tquant.quantize_kv(v),
                            lengths)
    report = verify(out, tdec.decode_reference(q, k, v, lengths),
                    pass_threshold=0.05)
    assert report.max_abs_err < float(v.abs().max()) / 127, str(report)
    assert report.mean_rel_err < 0.02, str(report)


def test_decode_rejects_mixed_quant(rng):
    """:113 -- one quantized and one dense cache."""
    k = torch.from_numpy(rng.normal(0, 0.02, (1, 2, 256, 64))
                         .astype(np.float32))
    q = torch.zeros(1, 2, 64)
    lengths = torch.tensor([256], dtype=torch.int32)
    with pytest.raises(ValueError, match="both be quantized"):
        tdec.flash_decode(q, tquant.quantize_kv(k), k, lengths)
    with pytest.raises(ValueError, match="both be quantized"):
        tdec.decode_reference(q, k, tquant.quantize_kv(k), lengths)


def test_decode_cost_counts_codes_and_scales():
    flops, nbytes = tdec.decode_cost([300, 0], 8, 2, 64, 2, kv_itemsize=1)
    assert flops == 4 * 8 * 300 * 64
    # 300 positions touch 3 scale blocks per kv head, K and V.
    assert nbytes == 2 * 2 * 64 * (300 + 4 * 3) + 2 * 2 * 8 * 64 * 2 + 4 * 2


# --- B1 --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("causal", [False, True])
def test_flash_fwd_quantized_matches_jax(rng, kind, causal):
    """:113 -- B1's quantized branch: O and LSE against the JAX kernel;
    flash_attention_quantized equals the dense forward on the K/V
    dequantized to q's dtype."""
    q = rng.normal(0, 1, (1, 4, 200, 64)).astype(np.float32)
    jk, tk = _qt_pair(_spread(rng, (1, 2, 256, 64), 2), kind)
    jv, tv = _qt_pair(_spread(rng, (1, 2, 256, 64), 2), kind)
    o_j, lse_j = jflash.flash_attention_fwd(jnp.asarray(q), jk, jv,
                                            causal=causal)
    tq = torch.from_numpy(q)
    o_t, lse_t = tflash.flash_attention_fwd(tq, tk, tv, causal=causal)
    assert max_abs_error(o_t, np.asarray(o_j)) <= ATOL
    assert max_abs_error(lse_t, np.asarray(lse_j)[..., 0]) <= ATOL
    got = tflash.flash_attention_quantized(tq, tk, tv, causal=causal)
    dense, _ = tflash.flash_attention_fwd(
        tq, tquant.dequantize_kv(tk, torch.float32),
        tquant.dequantize_kv(tv, torch.float32), causal=causal)
    assert torch.equal(got, dense)


def test_flash_fwd_quantized_accuracy_vs_fp32(rng):
    """:132 -- int8-KV attention in bf16 against the fp32 reference on
    the original K/V, quantization noise included."""
    q, k, v = (torch.from_numpy(rng.normal(0, 0.02, (1, h, 384, 64))
                                .astype(np.float32)).to(torch.bfloat16)
               for h in (4, 2, 2))
    out = tflash.flash_attention_quantized(q, tquant.quantize_kv(k),
                                           tquant.quantize_kv(v))
    ref = attention_reference(q.float(), k.float(), v.float())
    assert max_abs_error(out, ref) <= 5e-3


def test_flash_fwd_quantized_rejects_mixed_and_grad(rng):
    """:148 -- mixed quantized / dense K/V raise ValueError; quantized K/V
    have no gradient path."""
    k = torch.from_numpy(rng.normal(0, 0.02, (1, 2, 256, 64))
                         .astype(np.float32))
    q = torch.zeros(1, 2, 256, 64)
    kq = tquant.quantize_kv(k)
    with pytest.raises(ValueError, match="both"):
        tflash.flash_attention_fwd(q, kq, k)
    with pytest.raises(TypeError, match="forward only"):
        tflash.flash_attention(q, kq, kq)
    with pytest.raises(TypeError, match="QuantizedTensor"):
        tflash.flash_attention_quantized(q, k, k)


# --- B4 and the one-layer cache ----------------------------------------------------


def _pools(rng, hkv, pages, d, std=0.1):
    return (_spread(rng, (hkv, pages, PAGE, d), 2, std),
            _spread(rng, (hkv, pages, PAGE, d), 2, std))


def _table(rng, lengths, pages, width):
    table = np.zeros((len(lengths), width), np.int32)
    perm = rng.permutation(np.arange(1, pages))
    at = 0
    for i, n in enumerate(lengths):
        need = -(-n // PAGE)
        table[i, :need] = perm[at:at + need]
        at += need
    return table


def _quant_pool(x, kind):
    """JAX and port int8 / fp8 pools of an fp32 pool, through each
    package's PagedKVCache.quantize; codes and scales must be equal."""
    tdt, jdt = KINDS[kind]
    hkv, pages, _, d = x.shape
    jc = jkv.PagedKVCache(kv_heads=hkv, head_dim=d, num_pages=pages,
                          page_size=PAGE, max_seqs=2, dtype=jnp.float32)
    tc = tkv.PagedKVCache(kv_heads=hkv, head_dim=d, num_pages=pages,
                          page_size=PAGE, max_seqs=2, dtype=torch.float32,
                          device="cpu")
    jc.k_pool = jc.v_pool = jnp.asarray(x)
    tc.k_pool, tc.v_pool = torch.from_numpy(x), torch.from_numpy(x).clone()
    jc.quantize(jdt)
    tc.quantize(tdt)
    np.testing.assert_array_equal(_codes(tc.k_pool), _jcodes(jc.k_pool))
    np.testing.assert_array_equal(tc.k_scales.numpy(),
                                  np.asarray(jc.k_scales))
    assert tc.hbm_bytes == jc.hbm_bytes
    return (jc.k_pool, jc.k_scales), (tc.k_pool, tc.k_scales)


def _paged_both(q, jpools, tpools, table, lengths, **kw):
    (jk, jks), (jv, jvs) = jpools
    (tk, tks), (tv, tvs) = tpools
    o_j, lse_j = jpaged.paged_flash_decode(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(lengths),
        k_scales=jks, v_scales=jvs, return_lse=True, **kw)
    o_t, lse_t = tpaged.paged_flash_decode(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(lengths), k_scales=tks, v_scales=tvs,
        return_lse=True, **kw)
    assert max_abs_error(o_t, np.asarray(o_j)) <= ATOL
    live = lengths > 0
    assert max_abs_error(lse_t[live], np.asarray(lse_j)[live]) <= ATOL
    return o_t


@pytest.mark.parametrize("kind", list(KINDS))
def test_paged_quantized_decode_matches_jax(rng, kind):
    """:145 -- pools quantized by PagedKVCache.quantize, B4 and the
    reference over them."""
    hkv, pages, d = 2, 12, 64
    kp, vp = _pools(rng, hkv, pages, d)
    lengths = np.asarray([512, 300, 0], np.int32)
    table = _table(rng, lengths, pages, 5)
    q = rng.normal(0, 1, (3, 8, d)).astype(np.float32)
    jk, tk = _quant_pool(kp, kind)
    jv, tv = _quant_pool(vp, kind)
    got = _paged_both(q, (jk, jv), (tk, tv), table, lengths)
    args = [torch.from_numpy(x) for x in (q,)] + [tk[0], tv[0]] + [
        torch.from_numpy(x) for x in (table, lengths)]
    ref = tpaged.paged_decode_reference(*args, k_scales=tk[1],
                                        v_scales=tv[1])
    ref_j = jpaged.paged_decode_reference(
        jnp.asarray(q), jk[0], jv[0], jnp.asarray(table),
        jnp.asarray(lengths), k_scales=jk[1], v_scales=jv[1])
    live = lengths > 0
    assert max_abs_error(ref[live], np.asarray(ref_j)[live]) <= ATOL
    assert max_abs_error(got, ref) <= ATOL


@pytest.mark.parametrize("case", ["window", "starts_spread2"])
def test_paged_window_quantized_matches_jax(rng, case):
    """:235 -- window starts over int8 pools, also with two folded query
    positions."""
    hkv, pages, d = 2, 12, 64
    kp, vp = _pools(rng, hkv, pages, d)
    lengths = np.asarray([512, 300], np.int32)
    table = _table(rng, lengths, pages, 4)
    jk, tk = _quant_pool(kp, "int8")
    jv, tv = _quant_pool(vp, "int8")
    if case == "window":
        q = rng.normal(0, 1, (2, 4, d)).astype(np.float32)
        kw = dict(window=200)
    else:
        q = rng.normal(0, 1, (2, 8, d)).astype(np.float32)
        kw = dict(window_starts=np.asarray([250, -40], np.int32),
                  qpos_spread=2)
    jkw = dict(kw)
    if "window_starts" in kw:
        jkw["window_starts"] = jnp.asarray(kw["window_starts"])
        kw["window_starts"] = torch.from_numpy(kw["window_starts"])
    (jk_, jks), (jv_, jvs) = jk, jv
    o_j = jpaged.paged_flash_decode(
        jnp.asarray(q), jk_, jv_, jnp.asarray(table), jnp.asarray(lengths),
        k_scales=jks, v_scales=jvs, **jkw)
    o_t = tpaged.paged_flash_decode(
        torch.from_numpy(q), tk[0], tv[0], torch.from_numpy(table),
        torch.from_numpy(lengths), k_scales=tk[1], v_scales=tv[1], **kw)
    assert max_abs_error(o_t, np.asarray(o_j)) <= ATOL


def test_fold_scales_matches_jax(rng):
    """:259 -- the int8 fold_scales body against the JAX body in fp32
    (2e-5) and against the default body in bf16 (5e-5, rounding
    association only); fp8 pools reject it."""
    hkv, pages, d = 4, 12, 64
    kp, vp = _pools(rng, hkv, pages, d)
    lengths = np.asarray([300, 130, 512], np.int32)
    table = _table(rng, lengths, pages, 4)
    q = rng.normal(0, 1, (3, 8, d)).astype(np.float32)
    jk, tk = _quant_pool(kp, "int8")
    jv, tv = _quant_pool(vp, "int8")
    _paged_both(q, (jk, jv), (tk, tv), table, lengths, fold_scales=True)
    # The JAX test's inputs: N(0, 0.02^2) pools without spread.
    flat = rng.normal(0, 0.02, (2, hkv, pages, PAGE, d)).astype(np.float32)
    _, tk = _quant_pool(flat[0], "int8")
    _, tv = _quant_pool(flat[1], "int8")
    qb = torch.from_numpy(rng.normal(0, 0.02, (3, 8, d))
                          .astype(np.float32)).to(torch.bfloat16)
    args = (qb, tk[0], tv[0], torch.from_numpy(table),
            torch.from_numpy(lengths))
    sc = dict(k_scales=tk[1], v_scales=tv[1])
    std = tpaged.paged_flash_decode(*args, **sc)
    fold = tpaged.paged_flash_decode(*args, fold_scales=True, **sc)
    assert max_abs_error(std, fold) <= 5e-5
    _, tf = _quant_pool(kp, "e4m3")
    with pytest.raises(ValueError, match="int8"):
        tpaged.paged_flash_decode(qb, tf[0], tf[0], *args[3:],
                                  k_scales=tf[1], v_scales=tf[1],
                                  fold_scales=True)
    with pytest.raises(ValueError, match="together"):
        tpaged.paged_flash_decode(*args, k_scales=tk[1])


def test_paged_cache_end_to_end_matches_jax(rng):
    """:127 -- PagedKVCache: admit two sequences, decode, append a token
    per sequence, three times; the port's attention equals the JAX
    cache's at every step; appends to a quantized cache raise."""
    hkv, d = 2, 64
    kw = dict(kv_heads=hkv, head_dim=d, num_pages=32, page_size=PAGE,
              max_seqs=4)
    jc = jkv.PagedKVCache(dtype=jnp.float32, **kw)
    tc = tkv.PagedKVCache(dtype=torch.float32, device="cpu", **kw)
    jsids, tsids = [], []
    for n in (200, 57):
        k = rng.normal(0, 0.02, (hkv, n, d)).astype(np.float32)
        v = rng.normal(0, 0.02, (hkv, n, d)).astype(np.float32)
        jsids.append(jc.add_sequence(jnp.asarray(k), jnp.asarray(v)))
        tsids.append(tc.add_sequence(torch.from_numpy(k),
                                     torch.from_numpy(v)))
    assert jsids == tsids
    for _ in range(3):
        q = rng.normal(0, 0.02, (2, 4, d)).astype(np.float32)
        want = np.asarray(jc.decode(jnp.asarray(q), jsids))
        got = tc.decode(torch.from_numpy(q), tsids)
        assert max_abs_error(got, want) <= ATOL
        for sid in tsids:
            kn = rng.normal(0, 0.02, (hkv, d)).astype(np.float32)
            vn = rng.normal(0, 0.02, (hkv, d)).astype(np.float32)
            jc.append_token(sid, jnp.asarray(kn), jnp.asarray(vn))
            tc.append_token(sid, torch.from_numpy(kn), torch.from_numpy(vn))
    assert tc.hbm_bytes == jc.hbm_bytes
    tc.free_sequence(tsids[0])
    jc.free_sequence(jsids[0])
    assert tc.allocator.free_pages == jc.allocator.free_pages > 0
    tc.quantize(torch.int8)
    jc.quantize(jnp.int8)
    q = rng.normal(0, 0.02, (1, 4, d)).astype(np.float32)
    got = tc.decode(torch.from_numpy(q), tsids[1:])
    assert max_abs_error(got, np.asarray(
        jc.decode(jnp.asarray(q), jsids[1:]))) <= ATOL
    assert tc.hbm_bytes == jc.hbm_bytes
    with pytest.raises(NotImplementedError, match="LayeredPagedKVCache"):
        tc.append_token(tsids[1], torch.zeros(hkv, d), torch.zeros(hkv, d))


# --- the layered cache -----------------------------------------------------------------


def _layered_pair(kind, **kw):
    tdt, jdt = KINDS[kind]
    kw = dict(dict(n_layers=2, kv_heads=2, head_dim=64, num_pages=8,
                   page_size=PAGE, max_seqs=2, tail_size=16), **kw)
    return (jkv.LayeredPagedKVCache(quant_dtype=jdt, dtype=jnp.float32, **kw),
            tkv.LayeredPagedKVCache(quant_dtype=tdt, dtype=torch.float32,
                                    device="cpu", **kw))


def _assert_same_pools(jc, tc):
    for pj, pt in zip(jc.k_pools + jc.v_pools, tc.k_pools + tc.v_pools):
        np.testing.assert_array_equal(_codes(pt), _jcodes(pj))
    for sj, st in zip(jc.k_scale_pools + jc.v_scale_pools,
                      tc.k_scale_pools + tc.v_scale_pools):
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def _set_tail(jc, tc, slot, li, k, v):
    n = k.shape[1]
    jc.k_tails[li] = jc.k_tails[li].at[slot, :, :n, :].set(jnp.asarray(k))
    jc.v_tails[li] = jc.v_tails[li].at[slot, :, :n, :].set(jnp.asarray(v))
    tc.k_tails[li][slot, :, :n] = torch.from_numpy(k)
    tc.v_tails[li][slot, :, :n] = torch.from_numpy(v)


@pytest.mark.parametrize("kind", list(KINDS))
def test_quant_cache_roundtrip_matches_jax(rng, kind):
    """:30 -- a block-aligned prefill write and three unaligned tail
    flushes (crossing a block boundary): codes and scales bit-equal to
    the JAX cache after every step; attention over the pools within 2e-5
    of JAX's and within the quantization tolerance of the dense truth."""
    L, hkv, d, t0 = 2, 2, 64, 150
    jc, tc = _layered_pair(kind)
    tk = rng.normal(0, 0.02, (L, hkv, t0 + 40, d)).astype(np.float32)
    tv = rng.normal(0, 0.02, (L, hkv, t0 + 40, d)).astype(np.float32)
    sid = jc.add_sequence(jnp.asarray(tk[:, :, :t0]),
                          jnp.asarray(tv[:, :, :t0]))
    assert tc.add_sequence(torch.from_numpy(tk[:, :, :t0]),
                           torch.from_numpy(tv[:, :, :t0])) == sid
    _assert_same_pools(jc, tc)
    written = t0
    for cnt in (7, 16, 11):
        for li in range(L):
            _set_tail(jc, tc, 0, li, tk[li, :, written:written + cnt],
                      tv[li, :, written:written + cnt])
        jc.flush_tails([sid, -1], [cnt, 0])
        tc.flush_tails([sid, -1], [cnt, 0])
        written += cnt
        _assert_same_pools(jc, tc)
    assert tc.length(sid) == written
    assert tc.hbm_bytes == jc.hbm_bytes
    tables, lengths = tc.batch_state([sid], 3)
    q = rng.normal(0, 0.02, (1, hkv * 2, d)).astype(np.float32)
    tol = 6e-3 if kind == "int8" else 1.5e-2
    for li in range(L):
        got = tpaged.paged_flash_decode(
            torch.from_numpy(q), tc.k_pools[li], tc.v_pools[li], tables,
            lengths, k_scales=tc.k_scale_pools[li],
            v_scales=tc.v_scale_pools[li])
        want = jpaged.paged_flash_decode(
            jnp.asarray(q), jc.k_pools[li], jc.v_pools[li],
            jnp.asarray(tables.numpy()), jnp.asarray(lengths.numpy()),
            k_scales=jc.k_scale_pools[li], v_scales=jc.v_scale_pools[li])
        assert max_abs_error(got, np.asarray(want)) <= ATOL
        truth = tdec.decode_reference(
            torch.from_numpy(q), torch.from_numpy(tk[li, None, :, :written]),
            torch.from_numpy(tv[li, None, :, :written]), lengths)
        assert max_abs_error(got, truth) <= tol


def test_quant_flush_crossing_block_boundary_matches_jax(rng):
    """:136 -- tail 8 < 128: two live slots whose flush of 121..128
    crosses a block boundary requantize both blocks, bit-equal to JAX;
    unaligned bulk writes raise; a shared boundary page is copied with
    its scale rows before a flush (copy-on-write)."""
    L, hkv, d = 1, 2, 64
    jc, tc = _layered_pair("int8", n_layers=L, tail_size=8)
    tk = rng.normal(0, 0.02, (L, hkv, 129, d)).astype(np.float32)
    tv = rng.normal(0, 0.02, (L, hkv, 129, d)).astype(np.float32)
    sids = []
    for _ in range(2):
        sids.append(jc.add_sequence(jnp.asarray(tk[:, :, :121]),
                                    jnp.asarray(tv[:, :, :121])))
        assert tc.add_sequence(torch.from_numpy(tk[:, :, :121]),
                               torch.from_numpy(tv[:, :, :121])) == sids[-1]
    for slot in range(2):
        _set_tail(jc, tc, slot, 0, tk[0, :, 121:129], tv[0, :, 121:129])
    jc.flush_tails(sids, [8, 8])
    tc.flush_tails(sids, [8, 8])
    _assert_same_pools(jc, tc)
    tables, lengths = tc.batch_state(sids, 2)
    q = rng.normal(0, 0.02, (2, hkv * 2, d)).astype(np.float32)
    got = tpaged.paged_flash_decode(
        torch.from_numpy(q), tc.k_pools[0], tc.v_pools[0], tables, lengths,
        k_scales=tc.k_scale_pools[0], v_scales=tc.v_scale_pools[0])
    truth = tdec.decode_reference(
        torch.from_numpy(q), torch.from_numpy(np.repeat(tk[0, None], 2, 0)),
        torch.from_numpy(np.repeat(tv[0, None], 2, 0)), lengths)
    assert max_abs_error(got, truth) <= 6e-3
    with pytest.raises(ValueError, match="aligned"):
        tc.write(sids[0], 130, torch.zeros(L, hkv, 4, d),
                 torch.zeros(L, hkv, 4, d))
    # Fork, then flush into the shared (partial) last page.
    for c in (jc, tc):
        c.free_sequence(sids[0])
    forks = [c.fork_sequence(sids[1]) for c in (jc, tc)]
    assert forks[0] == forks[1]
    _set_tail(jc, tc, 0, 0, tk[0, :, :5], tv[0, :, :5])
    jc.flush_tails([forks[0], -1], [5, 0])
    tc.flush_tails([forks[1], -1], [5, 0])
    _assert_same_pools(jc, tc)


@pytest.mark.parametrize("kind", list(KINDS))
def test_gather_pages_dequantizes_like_jax(rng, kind):
    """The prefix-cache buffer of quantized pages: codes times scales,
    rounded once to the cache dtype, zero past the pages; evict_below on
    a quantized cache frees the same pages as JAX's."""
    L, hkv, d = 2, 2, 64
    jc, tc = _layered_pair(kind)
    kv = rng.normal(0, 0.02, (2, L, hkv, 3 * PAGE, d)).astype(np.float32)
    sid = jc.add_sequence(jnp.asarray(kv[0]), jnp.asarray(kv[1]))
    tc.add_sequence(torch.from_numpy(kv[0]), torch.from_numpy(kv[1]))
    pages = [int(x) for x in tc.allocator.page_table(sid, 3)[0][:2]]
    kg_j, vg_j = jc.gather_pages(pages, 4 * PAGE)
    kg_t, vg_t = tc.gather_pages(pages, 4 * PAGE)
    np.testing.assert_array_equal(kg_t.numpy(), np.asarray(kg_j))
    np.testing.assert_array_equal(vg_t.numpy(), np.asarray(vg_j))
    assert jc.evict_below(sid, PAGE + 5) == tc.evict_below(sid, PAGE + 5) == 1
    assert tc.free_pages == jc.free_pages


# --- the perplexity-delta gate ------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jcfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


TCFG = tllama.LlamaConfig.tiny(dtype=torch.float32)
JCFG = jllama.LlamaConfig.tiny(dtype=jnp.float32)


def _nll(mod, cfg, p, tokens, steps, kv_dtype, t0=140):
    """Teacher-forced NLL of the true next tokens under paged decode after
    a t0-token prefill, through a (quantized) layered cache flushed every
    8 tokens (test_quant_serving.py _teacher_forced_nll)."""
    port = mod is tllama
    kw = dict(n_layers=cfg.n_layers, kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim, num_pages=8, page_size=PAGE,
              max_seqs=1, tail_size=8, quant_dtype=kv_dtype)
    if port:
        cache = tkv.LayeredPagedKVCache(dtype=torch.float32, device="cpu",
                                        **kw)
        _, ks, vs = tllama.prefill_kv(p, torch.from_numpy(tokens[None, :t0]),
                                      cfg)
        sid = cache.add_sequence(ks[:, 0], vs[:, 0])
    else:
        cache = jkv.LayeredPagedKVCache(dtype=jnp.float32, **kw)
        _, ks, vs = jllama.prefill_kv(p, jnp.asarray(tokens[None, :t0]), cfg)
        sid = cache.add_sequence(ks[:, 0], vs[:, 0])
    nll, tail = [], 0
    for i in range(steps):
        tables, lens = cache.batch_state([sid], cache.pages_for(
            len(tokens)) + 1)
        tok = tokens[t0 + i:t0 + i + 1]
        if port:
            logits, _, _ = tllama.decode_step_paged(
                p, torch.from_numpy(tok), cfg, cache.k_pools, cache.v_pools,
                cache.k_tails, cache.v_tails, tables, lens,
                torch.tensor([tail], dtype=torch.int32),
                k_scales=cache.k_scale_pools, v_scales=cache.v_scale_pools)
            logp = torch.log_softmax(logits.float(), dim=-1).numpy()
        else:
            logits, cache.k_tails, cache.v_tails = jllama.decode_step_paged(
                p, jnp.asarray(tok), cfg, cache.k_pools, cache.v_pools,
                cache.k_tails, cache.v_tails, tables, lens,
                jnp.asarray([tail], jnp.int32),
                k_scales=cache.k_scale_pools, v_scales=cache.v_scale_pools)
            logp = np.asarray(jax.nn.log_softmax(logits.astype(jnp.float32)))
        nll.append(-float(logp[0, tokens[t0 + i + 1]]))
        tail += 1
        if tail >= cache.tail_size:
            cache.flush_tails([sid], [tail])
            tail = 0
    return float(np.mean(nll))


@pytest.mark.parametrize("kind", list(KINDS))
def test_quant_ppl_delta_gate(params, rng, kind):
    """:110 -- |ppl(quantized KV) - ppl(dense KV)| <= 0.05 max(ppl, 1)
    over 12 teacher-forced steps; for e5m2 (the JAX package's default
    case) both NLLs within 1e-4 of the JAX package's."""
    jp, tp = params
    steps = 12
    tokens = rng.integers(0, TCFG.vocab_size, 140 + steps + 1).astype(
        np.int32)
    tdt, jdt = KINDS[kind]
    dense = _nll(tllama, TCFG, tp, tokens, steps, None)
    quant = _nll(tllama, TCFG, tp, tokens, steps, tdt)
    ppl_d, ppl_q = np.exp(dense), np.exp(quant)
    assert abs(ppl_q - ppl_d) <= 0.05 * max(ppl_d, 1.0), (ppl_d, ppl_q)
    if kind == "e5m2":
        assert abs(dense - _nll(jllama, JCFG, jp, tokens, steps, None)) \
            <= 1e-4
        assert abs(quant - _nll(jllama, JCFG, jp, tokens, steps, jdt)) \
            <= 1e-4


# --- the engine ------------------------------------------------------------------------------


def _serve_pair(params, waves, kind, cfgs=(JCFG, TCFG), conv=None, **kw):
    """Each wave (a list of (prompt, max_new_tokens)) runs to completion on
    one JAX and one port engine with `kind` KV before the next; the
    transcripts and stats must be identical. Returns the port's
    transcripts and engine."""
    jp, tp = params if conv is None else conv
    tdt, jdt = KINDS[kind]
    kw = dict(dict(max_batch=2, num_pages=32, page_size=PAGE), **kw)
    out = []
    for mod, p, cfg, extra in ((jeng, jp, cfgs[0], {"kv_quant_dtype": jdt}),
                               (teng, tp, cfgs[1], {"kv_quant_dtype": tdt,
                                                    "device": "cpu"})):
        eng = mod.Engine(p, cfg, **kw, **extra)
        got = []
        for wave in waves:
            reqs = [mod.Request(prompt=list(pr), max_new_tokens=n)
                    for pr, n in wave]
            by_id = {c.request_id: c for c in eng.run(reqs)}
            got += [by_id[r.request_id].tokens for r in reqs]
        out.append((got, eng))
    (got_j, eng_j), (got_t, eng_t) = out
    assert got_t == got_j
    for key in ("prefill_tokens", "prefix_cached_tokens", "decode_tokens",
                "rejected"):
        assert getattr(eng_t.stats, key) == getattr(eng_j.stats, key), key
    assert eng_t.cache.free_pages == eng_t.cache.num_pages - 1
    return got_t, eng_t


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, JCFG.vocab_size, n)]
            for n in lens]


def test_quant_engine_matches_jax(params):
    """test_quant_serving.py:73 -- int8 KV, monolithic prefill, tail 8
    (flushes every 8 tokens): the transcript equals the JAX engine's;
    EngineStats.book_s counts host batch assembly."""
    (prompt,) = _prompts(10, (140,))
    (got,), eng = _serve_pair(params, [[(prompt, 10)]], "int8",
                              num_pages=16, tail_size=8)
    assert len(got) == 10 and all(0 <= t < TCFG.vocab_size for t in got)
    assert eng.cache.k_pools[0].dtype == torch.int8
    assert eng.stats.book_s > 0.0


def test_quant_engine_chunked_prefix_matches_jax(params):
    """e4m3 KV through chunked prefill and the prefix cache: a prompt
    served again after the first finishes hits its cached (quantized)
    pages through the chunked machinery."""
    (prompt,) = _prompts(12, (2 * PAGE + 9,))
    _, eng = _serve_pair(params, [[(prompt, 5)], [(prompt, 5)]], "e4m3",
                         prefix_cache=True, prefill_chunk=64,
                         decode_chunk=2)
    assert eng.stats.prefix_cached_tokens == 2 * PAGE


WINDOW = 96


@pytest.fixture(scope="module")
def windowed_params():
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32, window=WINDOW)
    jp = jllama.init_params(cfg, jax.random.PRNGKey(1))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_quant_engine_windowed_matches_jax(windowed_params):
    """e5m2 KV on a windowed model (window 96, tail 16): rolling-buffer
    chunked prefill, window starts over quantized pools, requantizing
    flushes and eviction below the window; transcripts equal the JAX
    engine's and a sequence holds O(window) pages."""
    cfgs = (jllama.LlamaConfig.tiny(dtype=jnp.float32, window=WINDOW),
            tllama.LlamaConfig.tiny(dtype=torch.float32, window=WINDOW))
    (prompt,) = _prompts(13, (200,))
    _, eng = _serve_pair(None, [[(prompt, 60)]], "e5m2", cfgs=cfgs,
                         conv=windowed_params, max_batch=1, tail_size=16,
                         prefill_chunk=32)
    assert eng.cache.k_scale_pools[0].dtype == torch.float32
