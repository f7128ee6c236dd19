"""Port parity: the MoE model family (flash_attention_tpu_torch/models/
moe.py) against the JAX package on MoEConfig.tiny_moe in fp32.

JAX trees (dense, and quantized by the JAX package's quantize_moe_params
to int8 and int4) are carried into the port with params_from_jax; seeded
numpy inputs go to both packages. The JAX side runs its grouped kernel
(ops/grouped.py) in the Pallas interpreter, the port its plain versions.
Tolerances: routing dispatch equal, combine and aux within 1e-6 (fp32
softmax probabilities; aux relative to its magnitude, up to ~4, where
fp32 means summed in another order differ by a few ulps); the expert
MLPs max-abs <= 1e-5 (outputs of magnitude ~0.1); forward logits max-abs <= 1e-4 (logits ~4 through two
layers); greedy transcripts identical, token for token, with the default
dispatch threshold and with FA_TPU_GROUPED_MIN_TOKENS=1 (the grouped
path at every dispatch, decode included, on both sides; the variable is
set before either side runs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.models import moe as jm
from flash_attention_tpu.models import quantized as jq
from flash_attention_tpu.models import sampling as js
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.models import moe as tm
from flash_attention_tpu_torch.models import quantized as tq
from flash_attention_tpu_torch.models import sampling as ts
from flash_attention_tpu_torch.runtime import engine as teng
from flash_attention_tpu_torch.utils.convert import params_from_jax
from flash_attention_tpu_torch.utils.metrics import max_abs_error

JCFG = jm.MoEConfig.tiny_moe(dtype=jnp.float32)
TCFG = tm.MoEConfig.tiny_moe(dtype=torch.float32)
QUANTS = {"dense": None, "int8": jnp.int8, "int4": "int4"}


@pytest.fixture(scope="module")
def trees():
    """name -> (JAX tree, the port's copy of it)."""
    dense = jm.init_moe_params(JCFG, jax.random.PRNGKey(0))
    out = {}
    for name, dtype in QUANTS.items():
        jp = dense if dtype is None else jq.quantize_moe_params(dense,
                                                                dtype=dtype)
        out[name] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                         device="cpu"))
    return out


def _x(seed, shape, std=0.5):
    return np.random.default_rng(seed).normal(0, std, shape).astype(
        np.float32)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, shape).astype(np.int32)


def _route_both(logits, top_k, cap):
    jd, jc, ja = jm.route_tokens(jnp.asarray(logits), top_k, cap)
    td, tc, ta = tm.route_tokens(torch.from_numpy(logits), top_k, cap)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert max_abs_error(tc, np.asarray(jc)) <= 1e-6
    for key in ja:
        want = float(ja[key])
        assert abs(float(ta[key]) - want) <= 1e-6 * max(1.0, abs(want)), key
    return td, tc, ta


def test_route_tokens_matches_jax():
    _route_both(_x(1, (64, 8), std=1.0), 2, 16)


def test_route_tokens_capacity_drops():
    """All tokens prefer expert 0: only `cap` survive (test_moe.py:53)."""
    logits = np.tile(np.float32([10.0, 5.0, 0.0, -5.0]), (32, 1))
    d, _, aux = _route_both(logits, 1, 8)
    assert float(d.sum()) == 8
    assert float(aux["dropped_frac"]) == pytest.approx(1 - 8 / 32)
    _route_both(logits, 2, 8)


def test_tied_logits_choose_the_lowest_expert():
    """Tied router logits: route_tokens (argmax) and route_topk (top_k)
    take the lowest expert index first, as jnp.argmax and lax.top_k."""
    logits = np.zeros((6, 8), np.float32)
    logits[1, [2, 5]] = 1.0
    logits[2, [7, 3, 6]] = 2.0
    logits[3] = np.float32([0, 1, 1, 1, 0, 0, 1, 0])
    _route_both(logits, 2, 8)
    jg, je = jm.route_topk(jnp.asarray(logits), 2)
    tg, te = tm.route_topk(torch.from_numpy(logits), 2)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    assert te[0].tolist() == [0, 1] and te[2].tolist() == [3, 6]
    assert max_abs_error(tg, np.asarray(jg)) <= 1e-6


def test_expert_capacity_matches_jax():
    for n in (1, 7, 64, 100, 4096):
        for cf in (1.0, 1.25, 8.0):
            jc = dataclasses.replace(JCFG, capacity_factor=cf)
            tc = dataclasses.replace(TCFG, capacity_factor=cf)
            assert tm.expert_capacity(n, tc) == jm.expert_capacity(n, jc)
    assert tm.expert_capacity(1, TCFG) == 8
    assert tm.expert_capacity(64, TCFG) % 8 == 0


def test_dropless_dispatch_path_thresholds(monkeypatch):
    """Decode-shaped dispatches take the one-hot path, prefill-shaped the
    grouped kernel; the variable moves the crossover, read per call
    (test_moe.py:225)."""
    assert tm.GROUPED_MIN_TOKENS == jm.GROUPED_MIN_TOKENS == 4096
    for n in (32, 4095, 4096, 8192):
        assert tm.dropless_dispatch_path(n) == jm.dropless_dispatch_path(n)
    assert tm.dropless_dispatch_path(32) == "onehot"
    assert tm.dropless_dispatch_path(4096) == "grouped"
    monkeypatch.setenv("FA_TPU_GROUPED_MIN_TOKENS", "16")
    assert tm.dropless_dispatch_path(32) == "grouped"
    assert tm.dropless_dispatch_path(15) == "onehot"


@pytest.mark.parametrize("mode", ["capacity", "capacity_n", "grouped"])
def test_moe_mlp_matches_jax(trees, mode):
    jp, tp = trees["dense"]
    x = _x(2, (2, 24, JCFG.dim))
    jlay, tlay = jp["layers"][0], tp["layers"][0]
    if mode == "grouped":
        jy, ja = jm.moe_mlp_grouped(jlay, jnp.asarray(x), JCFG)
        ty, ta = tm.moe_mlp_grouped(tlay, torch.from_numpy(x), TCFG)
    else:
        cap = None if mode == "capacity" else 48
        jy, ja = jm.moe_mlp(jlay, jnp.asarray(x), JCFG, capacity=cap)
        ty, ta = tm.moe_mlp(tlay, torch.from_numpy(x), TCFG, capacity=cap)
    assert ty.shape == (2, 24, JCFG.dim)
    assert max_abs_error(ty, np.asarray(jy)) <= 1e-5
    for key in ja:
        assert abs(float(ta[key]) - float(ja[key])) <= 1e-5, key


@pytest.mark.parametrize("routing", ["capacity", "dropless"])
def test_moe_forward_matches_jax(trees, routing):
    jp, tp = trees["dense"]
    tokens = _tokens(3, (2, 20))
    jlg, jaux = jm.moe_forward(jp, jnp.asarray(tokens),
                               dataclasses.replace(JCFG, routing=routing))
    tlg, taux = tm.moe_forward(tp, torch.from_numpy(tokens),
                               dataclasses.replace(TCFG, routing=routing))
    assert max_abs_error(tlg, np.asarray(jlg)) <= 1e-4
    for key in jaux:
        assert abs(float(taux[key]) - float(jaux[key])) <= 1e-5, key


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quantized_moe_forward_matches_jax(trees, name):
    """JAX-quantized trees carried across: expert stacks become the
    port's stack classes; both routings' forwards match."""
    jp, tp = trees[name]
    stack = tp["layers"][1]["w_down"]
    cls = tq.Int4ExpertStack if name == "int4" else tq.QuantizedExpertStack
    assert isinstance(stack, cls)
    assert stack.orig_shape == (JCFG.n_experts, JCFG.ffn_dim, JCFG.dim)
    assert tp["layers"][0]["router"].dtype == torch.float32
    tokens = _tokens(4, (2, 16))
    for routing in ("capacity", "dropless"):
        jlg, _ = jm.moe_forward(jp, jnp.asarray(tokens),
                                dataclasses.replace(JCFG, routing=routing))
        tlg, _ = tm.moe_forward(tp, torch.from_numpy(tokens),
                                dataclasses.replace(TCFG, routing=routing))
        assert max_abs_error(tlg, np.asarray(jlg)) <= 1e-4, routing


@pytest.mark.parametrize("name", ["int8", "int4"])
def test_quantize_moe_params_matches_jax(trees, name):
    """The port's quantize_moe_params on the dense tree gives the JAX
    package's bytes; attention weights and the router too."""
    _, td = trees["dense"]
    _, tp = trees[name]
    mine = tq.quantize_moe_params(td, dtype="int4" if name == "int4"
                                  else torch.int8)
    for key in ("w_gate", "wo", "router"):
        a, b = mine["layers"][1][key], tp["layers"][1][key]
        assert type(a) is type(b)
        pairs = ([(a, b)] if isinstance(a, torch.Tensor) else
                 [(getattr(a, f.name), getattr(b, f.name))
                  for f in dataclasses.fields(a)
                  if isinstance(getattr(a, f.name), torch.Tensor)])
        for x, y in pairs:
            assert torch.equal(x, y), key


def test_prefill_and_decode_step_match_jax(trees):
    """Teacher-forced decode through the contiguous cache reproduces the
    JAX logits on a dropless int4 tree (test_moe.py:173)."""
    jp, tp = trees["int4"]
    jcfg = dataclasses.replace(JCFG, routing="dropless")
    tcfg = dataclasses.replace(TCFG, routing="dropless")
    toks = _tokens(5, (2, 12))
    jcache = jl.init_kv_cache(jcfg, 2, 128)
    lj, jcache, lenj = jl.prefill(jp, jnp.asarray(toks[:, :8]), jcfg, jcache)
    tcache = tl.init_kv_cache(tcfg, 2, 128, device="cpu")
    lt, tcache, lent = tl.prefill(tp, torch.from_numpy(toks[:, :8]), tcfg,
                                  tcache)
    assert max_abs_error(lt, np.asarray(lj)) <= 1e-4
    for i in range(8, 12):
        lj, jcache, lenj = jl.decode_step(jp, jnp.asarray(toks[:, i]), jcfg,
                                          jcache, lenj)
        lt, tcache, lent = tl.decode_step(tp, torch.from_numpy(toks[:, i]),
                                          tcfg, tcache, lent)
        assert max_abs_error(lt, np.asarray(lj)) <= 1e-4, i
    np.testing.assert_array_equal(lent.numpy(), np.asarray(lenj))


@pytest.mark.parametrize("forced", [False, True], ids=["default", "forced"])
@pytest.mark.parametrize("name", ["dense", "int4"])
def test_greedy_transcripts_match_jax_generate(trees, name, forced,
                                               monkeypatch):
    """Dropless serving end to end: the port's Engine (tail flushes, a
    prompt over a page) and the port's generate give JAX generate's
    greedy tokens. forced: FA_TPU_GROUPED_MIN_TOKENS=1, so prefill and
    every decode step run the grouped path in both packages."""
    if forced:
        monkeypatch.setenv("FA_TPU_GROUPED_MIN_TOKENS", "1")
    jp, tp = trees[name]
    jcfg = dataclasses.replace(JCFG, routing="dropless")
    tcfg = dataclasses.replace(TCFG, routing="dropless")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, JCFG.vocab_size, n).astype(np.int32)
               for n in (9, 140)]
    new = 6
    want = [np.asarray(js.generate(jp, jnp.asarray(p[None]), jcfg,
                                   max_new_tokens=new))[0].tolist()
            for p in prompts]
    got = [ts.generate(tp, torch.from_numpy(p[None]), tcfg,
                       max_new_tokens=new)[0].tolist() for p in prompts]
    assert got == want
    eng = teng.Engine(tp, tcfg, max_batch=2, num_pages=16, page_size=128,
                      tail_size=4, device="cpu")
    reqs = [teng.Request(prompt=p.tolist(), max_new_tokens=new)
            for p in prompts]
    by_id = {c.request_id: c.tokens for c in eng.run(reqs)}
    assert [by_id[r.request_id] for r in reqs] == want


@pytest.mark.parametrize("name", list(QUANTS))
def test_param_counts_match_jax(trees, name):
    jp, tp = trees[name]
    assert tq.params_nbytes(tp) == jq.params_nbytes(jp)
    assert tq.logical_param_count(tp) == jq.logical_param_count(jp)


@pytest.mark.parametrize("dtype,tol", [
    ("int4", 0.15), (torch.int8, 0.1), (torch.float8_e4m3fn, 0.1)])
def test_init_quantized_moe_params_stats(dtype, tol):
    """Dequantized std ~ 1/sqrt(fan_in) for every stack; the tree has the
    dense MoE tree's logical size; the draw is seeded."""
    p = tq.init_quantized_moe_params(TCFG, seed=0, dtype=dtype,
                                     device="cpu")
    layer = p["layers"][0]
    cls = tq.Int4ExpertStack if dtype == "int4" else tq.QuantizedExpertStack
    for key, fan_in in (("w_gate", TCFG.dim), ("w_down", TCFG.ffn_dim)):
        w = layer[key]
        assert isinstance(w, cls)
        if dtype != "int4":
            assert w.q.dtype == dtype
        deq = w.dequant(torch.float32)
        assert abs(float(deq.std()) * np.sqrt(fan_in) - 1.0) < tol, key
    assert layer["router"].dtype == torch.float32
    dense = tm.init_moe_params(TCFG, seed=0, device="cpu")
    assert tq.logical_param_count(p) == tq.logical_param_count(dense)
    again = tq.init_quantized_moe_params(TCFG, seed=0, dtype=dtype,
                                         device="cpu")
    assert torch.equal(again["layers"][0]["w_up"].dequant(torch.float32),
                       layer["w_up"].dequant(torch.float32))


def test_mixtral_preset_counts():
    """The Mixtral-8x7B preset's logical size from the shapes alone
    (46.7 B parameters, 45.1 B in the experts), as for an int4 tree."""
    cfg = tm.MoEConfig.mixtral_8x7b()
    jcfg = jm.MoEConfig.mixtral_8x7b()
    for f in dataclasses.fields(jcfg):
        if f.name != "dtype":
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    d, f, e = cfg.dim, cfg.ffn_dim, cfg.n_experts
    experts = cfg.n_layers * 3 * e * d * f
    attn = cfg.n_layers * (2 * d * d + 2 * d * cfg.n_kv_heads * cfg.head_dim)
    total = (experts + attn + cfg.n_layers * (2 * d + d * e)
             + 2 * cfg.vocab_size * d + d)
    assert round(experts / 1e9, 1) == 45.1 and round(total / 1e9, 1) == 46.7
