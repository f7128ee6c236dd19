"""Port parity: the Llama model on quantized weights, the contiguous-cache
decode path and `generate` in flash_attention_tpu_torch, against the JAX
package on LlamaConfig.tiny in fp32.

JAX trees (dense, and quantized by the JAX package's quantize_params to
int8, fp8 e4m3 and int4) are carried into the port with params_from_jax;
seeded numpy tokens go to both packages. The JAX side runs its Pallas
kernels (B5, B6, B7, B8) in interpret mode on the CPU, the port their
plain versions. Tolerances: max-abs <= 1e-4 on logits and caches (fp32
through a 2-layer model with logits of magnitude ~4); greedy `Engine`
and `generate` transcripts identical, token for token; byte counts and
logical parameter counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.models import quantized as jq
from flash_attention_tpu.models import sampling as js
from flash_attention_tpu.runtime import engine as jeng
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.models import quantized as tq
from flash_attention_tpu_torch.models import sampling as ts
from flash_attention_tpu_torch.runtime import engine as teng
from flash_attention_tpu_torch.utils.convert import params_from_jax
from flash_attention_tpu_torch.utils.metrics import max_abs_error

ATOL = 1e-4
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
QUANTS = {"dense": None, "int8": jnp.int8, "e4m3": jnp.float8_e4m3fn,
          "int4": "int4"}


@pytest.fixture(scope="module")
def trees():
    """name -> (JAX tree, the port's copy of it)."""
    dense = jl.init_params(JCFG, jax.random.PRNGKey(0))
    out = {}
    for name, dtype in QUANTS.items():
        jp = dense if dtype is None else jq.quantize_params(dense,
                                                            dtype=dtype)
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    return out


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, shape).astype(np.int32)


def test_converted_trees_keep_the_weight_classes(trees):
    _, t8 = trees["int8"]
    _, t4 = trees["int4"]
    w8, w4 = t8["layers"][0]["wo"], t4["lm_head"]
    assert isinstance(w8, tq.QuantizedWeight) and w8.q.dtype == torch.int8
    assert w8.orig_shape == (JCFG.n_heads, JCFG.head_dim, JCFG.dim)
    assert w8.n_contract == 2
    assert isinstance(w4, tq.Int4Weight) and w4.packed.dtype == torch.int8
    _, te = trees["e4m3"]
    assert te["layers"][1]["w_up"].q.dtype == torch.float8_e4m3fn
    assert te["embed"].dtype == torch.float32


@pytest.mark.parametrize("name", ["int8", "e4m3", "int4"])
def test_forward_logits_match_jax(trees, name):
    jp, tp = trees[name]
    tokens = _tokens(2, (2, 24))
    lj = np.asarray(jl.forward(jp, jnp.asarray(tokens), JCFG))
    lt = tl.forward(tp, torch.from_numpy(tokens), TCFG)
    assert lt.shape == lj.shape
    assert max_abs_error(lt, lj) <= ATOL


@pytest.mark.parametrize("name", ["int8", "e4m3", "int4"])
def test_quantize_params_matches_jax(trees, name):
    """The port's quantize_params on the dense tree gives the JAX
    package's bytes and scales."""
    _, td = trees["dense"]
    _, tp = trees[name]
    dtype = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn,
             "int4": "int4"}[name]
    mine = tq.quantize_params(td, dtype=dtype)
    for a, b in ((mine["lm_head"], tp["lm_head"]),
                 (mine["layers"][1]["wo"], tp["layers"][1]["wo"])):
        assert type(a) is type(b) and a.orig_shape == b.orig_shape
        for f in ("q", "scale") if name != "int4" else ("packed", "scales"):
            x, y = getattr(a, f), getattr(b, f)
            assert torch.equal(x.view(torch.uint8) if x.element_size() == 1
                               else x, y.view(torch.uint8)
                               if y.element_size() == 1 else y)


def test_prefill_and_decode_step_match_jax(trees):
    """The contiguous-cache path on int8 weights: prefill fills the cache
    in place, decode_step writes position lengths[b] in place and attends
    with B5 (use_flash) or plain torch; both match the JAX steps."""
    jp, tp = trees["int8"]
    tokens = _tokens(3, (2, 11))
    jcache = jl.init_kv_cache(JCFG, 2, 128)
    lj, jcache, lenj = jl.prefill(jp, jnp.asarray(tokens), JCFG, jcache)
    tcache = tl.init_kv_cache(TCFG, 2, 128, device="cpu")
    lt, tcache2, lent = tl.prefill(tp, torch.from_numpy(tokens), TCFG,
                                   tcache)
    assert tcache2 is tcache
    assert max_abs_error(lt, np.asarray(lj)) <= ATOL
    np.testing.assert_array_equal(lent.numpy(), np.asarray(lenj))
    for (a, b), (c, d) in zip(tcache, jcache):
        assert max_abs_error(a, np.asarray(c)) <= ATOL
        assert max_abs_error(b, np.asarray(d)) <= ATOL
    nxt = np.asarray([5, 77], np.int32)
    for use_flash in (True, False):
        lj2, jc2, lenj2 = jl.decode_step(jp, jnp.asarray(nxt), JCFG,
                                         jcache, lenj, use_flash=use_flash)
        tc = [(k.clone(), v.clone()) for k, v in tcache]
        lt2, tc2, lent2 = tl.decode_step(tp, torch.from_numpy(nxt), TCFG,
                                         tc, lent, use_flash=use_flash)
        assert max_abs_error(lt2, np.asarray(lj2)) <= ATOL
        np.testing.assert_array_equal(lent2.numpy(), np.asarray(lenj2))
        assert tc2[0][0] is tc[0][0]
        for (a, b), (c, d) in zip(tc2, jc2):
            assert max_abs_error(a, np.asarray(c)) <= ATOL
            assert max_abs_error(b, np.asarray(d)) <= ATOL


@pytest.mark.parametrize("name", ["dense", "int4"])
def test_generate_matches_jax(trees, name):
    jp, tp = trees[name]
    prompts = _tokens(4, (2, 9))
    want = np.asarray(js.generate(jp, jnp.asarray(prompts), JCFG,
                                  max_new_tokens=6))
    got = ts.generate(tp, torch.from_numpy(prompts), TCFG,
                      max_new_tokens=6)
    assert got.dtype == torch.int32 and got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), want)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, JCFG.vocab_size, n)]
            for n in lens]


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_engine_transcripts_match_jax(trees, name):
    """Greedy requests through both engines on the same quantized tree,
    with tail flushes (tail_size 4) and a prompt over a page."""
    jp, tp = trees[name]
    specs = [dict(prompt=p, max_new_tokens=7)
             for p in _prompts(5, (9, 140, 20))]
    out = []
    for mod, p, cfg, extra in ((jeng, jp, JCFG, {}),
                               (teng, tp, TCFG, {"device": "cpu"})):
        eng = mod.Engine(p, cfg, max_batch=4, num_pages=16, page_size=128,
                         tail_size=4, **extra)
        reqs = [mod.Request(**s) for s in specs]
        order = {r.request_id: i for i, r in enumerate(reqs)}
        out.append(sorted((order[c.request_id], tuple(c.tokens),
                           c.finish_reason) for c in eng.run(reqs)))
    assert len(out[1]) == 3 and all(c[2] == "length" for c in out[1])
    assert out[1] == out[0]


def test_engine_equals_generate_on_int4(trees):
    """The port's two serving entry points agree on int4 weights (the
    JAX package's tests/test_quant_weights.py:237)."""
    _, tp = trees["int4"]
    prompt = _prompts(6, (17,))[0]
    eng = teng.Engine(tp, TCFG, max_batch=2, num_pages=16, page_size=128,
                      device="cpu")
    got = eng.run([teng.Request(prompt=prompt, max_new_tokens=5)])[0]
    want = ts.generate(tp, torch.tensor([prompt]), TCFG, max_new_tokens=5)
    assert got.tokens == want[0].tolist()


@pytest.mark.parametrize("name", list(QUANTS))
def test_param_counts_match_jax(trees, name):
    jp, tp = trees[name]
    assert tq.params_nbytes(tp) == jq.params_nbytes(jp)
    assert tq.logical_param_count(tp) == jq.logical_param_count(jp)


@pytest.mark.parametrize("dtype,tol", [
    (torch.int8, 0.1), (torch.float8_e4m3fn, 0.1),
    (torch.float8_e5m2, 0.1), ("int4", 0.15)])
def test_init_quantized_params_stats(dtype, tol):
    """Dequantized std ~ 1/sqrt(fan_in), as tests/test_quant_weights.py
    :156 and :224 hold the JAX init to; the whole tree has the dense
    tree's logical size."""
    p = tq.init_quantized_params(TCFG, seed=0, dtype=dtype, device="cpu")
    w = p["layers"][0]["w_gate"]
    if dtype == "int4":
        assert isinstance(w, tq.Int4Weight)
    else:
        assert isinstance(w, tq.QuantizedWeight) and w.q.dtype == dtype
    deq = w.dequant(torch.float32)
    assert abs(float(deq.std()) * np.sqrt(TCFG.dim) - 1.0) < tol
    dense = tl.init_params(TCFG, seed=0, device="cpu")
    assert tq.logical_param_count(p) == tq.logical_param_count(dense)
    again = tq.init_quantized_params(TCFG, seed=0, dtype=dtype,
                                     device="cpu")["layers"][0]["w_gate"]
    assert torch.equal(again.dequant(torch.float32), deq)


def test_dense_pallas_route_matches_jax(trees, monkeypatch):
    """FA_TPU_DENSE_PALLAS_MM=1 sends dense products of at most 1024 rows
    through B8 in both packages (read per call); logits still match."""
    jp, tp = trees["dense"]
    tokens = _tokens(7, (1, 20))
    monkeypatch.setenv("FA_TPU_DENSE_PALLAS_MM", "1")
    lj = np.asarray(jl.forward(jp, jnp.asarray(tokens), JCFG))
    lt = tl.forward(tp, torch.from_numpy(tokens), TCFG)
    assert max_abs_error(lt, lj) <= ATOL
    monkeypatch.delenv("FA_TPU_DENSE_PALLAS_MM")
    assert max_abs_error(tl.forward(tp, torch.from_numpy(tokens), TCFG),
                         lj) <= ATOL
