"""Port parity: speculative decoding (flash_attention_tpu_torch
runtime/engine.py speculative_k / speculative_rounds / draft_*, and
models/sampling.py speculative_sample) against the JAX package.

  * propose_ngram_draft is bit-identical to JAX's over seeded histories.
  * speculative_sample's greedy rows give JAX's tokens and accept counts
    on the same logits; its sampled rows keep the sampling law (the
    first emitted token's TV distance to direct sampling from the
    filtered target is under 0.05 over 4000 draws, for a draft the
    target likes and one it does not). The draws come from a
    torch.Generator, so sampled tokens are not JAX's.
  * The engine, on LlamaConfig.tiny fp32 (a windowed tree, and
    MoEConfig.tiny_moe with capacity factor 8), with trees carried from
    JAX by params_from_jax: greedy transcripts, finish reasons,
    spec_proposed / spec_accepted and the token counts are IDENTICAL to
    the JAX speculative engine's in the cases of tests/test_speculative.py
    (n-gram drafts, prefix cache + int8 KV, MoE, self-draft, rounds,
    a wrong draft model with a cold draft cache and forks, tail flushes),
    tests/test_window_serving.py:112 and tests/test_engine.py:376; they
    also equal the port's engine without speculation, and every page
    comes back.
  * The options' guards raise as the JAX engine's do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.models import moe as jm
from flash_attention_tpu.models import sampling as js
from flash_attention_tpu.runtime import engine as jeng
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.models import moe as tm
from flash_attention_tpu_torch.models import sampling as ts
from flash_attention_tpu_torch.runtime import engine as teng
from flash_attention_tpu_torch.utils.convert import params_from_jax

PAGE = 128
WINDOW = 96
CFGS = {
    "dense": (jl.LlamaConfig.tiny(dtype=jnp.float32),
              tl.LlamaConfig.tiny(dtype=torch.float32)),
    "window": (jl.LlamaConfig.tiny(dtype=jnp.float32, window=WINDOW),
               tl.LlamaConfig.tiny(dtype=torch.float32, window=WINDOW)),
    "moe": (jm.MoEConfig.tiny_moe(dtype=jnp.float32, capacity_factor=8.0),
            tm.MoEConfig.tiny_moe(dtype=torch.float32, capacity_factor=8.0)),
}
VOCAB = 512


@pytest.fixture(scope="module")
def trees():
    """name -> (JAX tree, the port's copy): the dense tree, a second dense
    tree (the wrong draft model), the windowed tree, the MoE tree."""
    def both(init, cfg, seed):
        jp = init(cfg, jax.random.PRNGKey(seed))
        return jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                   device="cpu")

    return {"dense": both(jl.init_params, CFGS["dense"][0], 0),
            "wrong": both(jl.init_params, CFGS["dense"][0], 99),
            "window": both(jl.init_params, CFGS["window"][0], 0),
            "moe": both(jm.init_moe_params, CFGS["moe"][0], 1)}


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, VOCAB, n)] for n in lens]


REPETITIVE = [int(x) for x in np.tile([3, 1, 4, 1, 5], 8)]


# --- propose_ngram_draft ----------------------------------------------------


def _ngram_cases():
    cases = [([5, 6, 7, 8, 9, 5, 6], 3, 2), ([1, 2, 9, 1, 2], 4, 2),
             ([1, 2, 3, 4], 2, 2), ([3], 2, 2), ([], 3, 2)]
    rng = np.random.default_rng(7)
    for _ in range(60):
        n = int(rng.integers(0, 40))
        hist = rng.integers(0, int(rng.integers(2, 9)), n).tolist()
        cases.append((hist, int(rng.integers(1, 6)), int(rng.integers(1, 4))))
    return cases


def test_ngram_draft_is_bit_identical_to_jax():
    """tests/test_speculative.py:79's cases and 60 seeded histories over
    small vocabularies (so matches, short continuations and misses all
    occur), k 1-5, n-grams 1-3: same values and dtype."""
    for hist, k, ngram in _ngram_cases():
        want = jeng.propose_ngram_draft(np.asarray(hist, np.int32), k, ngram)
        got = teng.propose_ngram_draft(hist, k, ngram)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want, err_msg=str((hist, k)))


# --- speculative_sample -----------------------------------------------------


@pytest.mark.parametrize("mixed", [False, True], ids=["all_greedy", "mixed"])
def test_speculative_sample_greedy_rows_match_jax(mixed):
    """:155 -- greedy rows (temps <= 0) give JAX's tokens and accept
    counts on the same logits: drafts that follow the argmax for 0..k
    positions, and random ones. In the mixed batch every other row
    samples (its own law, not compared) and the greedy rows must still
    match; the all-greedy batch takes the fast path."""
    b, k, v = 16, 3, 9
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 1.0, (b, k + 1, v)).astype(np.float32)
    greedy = logits.argmax(-1)
    toks = rng.integers(0, v, (b, k + 1)).astype(np.int32)
    for i in range(b):
        run = i % (k + 1)                  # drafts following the argmax
        toks[i, 1:1 + run] = greedy[i, :run]
        if run < k and toks[i, 1 + run] == greedy[i, run]:
            toks[i, 1 + run] = (greedy[i, run] + 1) % v
    temps = np.zeros(b, np.float32)
    if mixed:
        temps[1::2] = 0.7
    top_ps = np.full(b, 0.9, np.float32)
    out_j, acc_j = js.speculative_sample(
        jnp.asarray(logits), jnp.asarray(toks), jnp.asarray(temps),
        jnp.asarray(top_ps), jax.random.PRNGKey(0))
    gen = torch.Generator().manual_seed(0)
    out_t, acc_t = ts.speculative_sample(
        torch.from_numpy(logits), torch.from_numpy(toks),
        torch.from_numpy(temps), torch.from_numpy(top_ps), gen,
        all_greedy=None if mixed else True)
    rows = temps <= 0
    assert out_t.dtype == acc_t.dtype == torch.int32
    np.testing.assert_array_equal(acc_t.numpy()[rows], np.asarray(acc_j)[rows])
    np.testing.assert_array_equal(out_t.numpy()[rows], np.asarray(out_j)[rows])
    if not mixed:
        assert sorted(set(acc_t.tolist())) == list(range(k + 1))
    acc = acc_t.numpy()
    assert ((acc >= 0) & (acc <= k)).all()
    # Each row emits its accepted drafts, then the correction.
    for i in range(b):
        np.testing.assert_array_equal(out_t.numpy()[i, :acc[i]],
                                      toks[i, 1:1 + acc[i]])


def test_speculative_sample_preserves_distribution():
    """:125 -- the first emitted token of the rejection scheme is drawn
    from the (temperature + top-p) target for a draft the target likes
    and one it does not: TV distance < 0.05 over 4000 draws (one batched
    call of 4000 identical rows)."""
    v, k, trials = 12, 3, 4000
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 1.5, (1, k + 1, v)).astype(np.float32)
    temp, top_p = 0.8, 0.9
    target = np.asarray(jax.nn.softmax(js.apply_top_p(
        jnp.asarray(logits[:, 0]) / temp, jnp.asarray([top_p])), axis=-1))[0]
    gen = torch.Generator().manual_seed(7)
    for draft in (int(logits[0, 0].argmax()), int(logits[0, 0].argmin())):
        toks = torch.tensor([[0] + [draft] * k] * trials, dtype=torch.int32)
        out, _ = ts.speculative_sample(
            torch.from_numpy(logits).expand(trials, -1, -1), toks,
            torch.full((trials,), temp), torch.full((trials,), top_p), gen)
        emp = np.bincount(out[:, 0].numpy(), minlength=v) / trials
        tv = 0.5 * float(np.abs(emp - target).sum())
        assert tv < 0.05, (draft, tv)


# --- the engine -------------------------------------------------------------


def _fuzz_waves():
    """tests/test_engine.py:336's mixed workload: prompt lengths 3-140,
    forks, live EOS stops (a token the model emits early)."""
    rng = np.random.default_rng(42)
    lens = [3, 17, 60, 129, 140]
    specs = []
    for i in range(8):
        specs.append(dict(
            prompt=[int(x) for x in rng.integers(0, VOCAB, lens[i % 5])],
            max_new_tokens=int(rng.integers(1, 14)),
            eos_id=-1 if i % 3 == 0 else None, n=2 if i % 4 == 2 else 1))
    return [specs]


def _spec(prompt, new, **kw):
    return dict(prompt=prompt, max_new_tokens=new, **kw)


CASES = {
    # :97 -- random prompts (low acceptance) and a repetitive one.
    "ngram_k3": dict(
        tree="dense", engine=dict(max_batch=2, speculative_k=3),
        waves=[[_spec(p, 8) for p in _prompts(1, (21, 45))]
               + [_spec(REPETITIVE, 10)]]),
    # :199 -- prefix cache + int8 KV pages; the second wave hits.
    "prefix_int8": dict(
        tree="dense", engine=dict(max_batch=2, speculative_k=3,
                                  prefix_cache=True, kv_quant="int8"),
        waves=[[_spec(_prompts(2, (2 * PAGE + 15,))[0], 6)]] * 2),
    # tests/test_window_serving.py:112 -- window starts per folded query,
    # generating across the window boundary.
    "windowed": dict(
        tree="window", engine=dict(max_batch=4, speculative_k=3),
        waves=[[_spec(_prompts(3, (90,))[0], 12),
                _spec([int(x) for x in np.tile([3, 1, 4, 1, 5], 24)], 12)]]),
    # :225 -- an MoE model, drop-free capacity.
    "moe_capacity8": dict(
        tree="moe", engine=dict(max_batch=2, num_pages=16, speculative_k=3),
        waves=[[_spec(_prompts(4, (19,))[0], 6)]]),
    # :245 -- self-draft: acceptance >= 0.9.
    "self_draft": dict(
        tree="dense", draft="dense",
        engine=dict(max_batch=2, speculative_k=3),
        waves=[[_spec(p, 10) for p in _prompts(5, (17, 31))]]),
    # :274 -- three rounds a step: few dispatches.
    "rounds3": dict(
        tree="dense", draft="dense",
        engine=dict(max_batch=2, tail_size=32, speculative_k=3,
                    speculative_rounds=3),
        waves=[[_spec(p, 12) for p in _prompts(6, (13, 29))]]),
    # :314 -- a wrong draft model; n = 2 forks share its prompt K/V ...
    "wrong_draft_forks": dict(
        tree="dense", draft="wrong",
        engine=dict(max_batch=3, speculative_k=2),
        waves=[[_spec(_prompts(7, (25,))[0], 7, n=2)]]),
    # ... and a prompt beyond draft_max_seq leaves the slots cold.
    "wrong_draft_cold": dict(
        tree="dense", draft="wrong",
        engine=dict(max_batch=3, speculative_k=2, draft_max_seq=16),
        waves=[[_spec(_prompts(7, (25,))[0], 7, n=2)]]),
    # :340 -- tail flushes every 8 tokens over a longer generation.
    "tail_flush_long": dict(
        tree="dense", draft="dense",
        engine=dict(max_batch=2, tail_size=8, speculative_k=3),
        waves=[[_spec(_prompts(8, (PAGE - 5,))[0], 21)]]),
    # tests/test_engine.py:376 -- speculation + prefix cache + forks + EOS.
    "fuzz_prefix_forks": dict(
        tree="dense", engine=dict(max_batch=3, num_pages=64,
                                  speculative_k=2, prefix_cache=True),
        waves=_fuzz_waves()),
}
SPEC_KEYS = ("speculative_k", "speculative_rounds", "draft_max_seq")


def _serve(mod, params, cfg, waves, draft=None, draft_cfg=None, **kw):
    kw = dict(dict(num_pages=32, page_size=PAGE, tail_size=16), **kw)
    kv = kw.pop("kv_quant", None)
    if kv is not None:
        kw["kv_quant_dtype"] = jnp.int8 if mod is jeng else torch.int8
    if mod is teng:
        kw["device"] = "cpu"
    if draft is not None:
        kw.update(draft_params=draft, draft_cfg=draft_cfg)
    eng = mod.Engine(params, cfg, **kw)
    free0 = eng.cache.free_pages
    got = []
    for wave in waves:
        reqs = [mod.Request(**s) for s in wave]
        by_id = {}
        for c in eng.run(reqs):
            by_id.setdefault(c.request_id, []).append(
                (c.branch, tuple(c.tokens), c.finish_reason))
        got += [sorted(by_id[r.request_id]) for r in reqs]
    assert eng.cache.free_pages == free0
    return got, eng.stats


def _eos_token(trees):
    """A token the dense model emits third after [7, 11, 13] (the EOS of
    tests/test_engine.py:344)."""
    _, tp = trees["dense"]
    eng = teng.Engine(tp, CFGS["dense"][1], num_pages=8, page_size=PAGE,
                      device="cpu")
    return eng.run([teng.Request(prompt=[7, 11, 13],
                                 max_new_tokens=6)])[0].tokens[2]


@pytest.mark.parametrize("case", list(CASES))
def test_speculative_engine_matches_jax(trees, case):
    c = CASES[case]
    waves = c["waves"]
    if case == "fuzz_prefix_forks":
        eos = _eos_token(trees)
        waves = [[dict(s, eos_id=eos if s["eos_id"] is not None else None)
                  for s in w] for w in waves]
    (jp, tp), (jcfg, tcfg) = trees[c["tree"]], CFGS[c["tree"]]
    jd = td = None
    if "draft" in c:
        jd, td = trees[c["draft"]]
    got_j, st_j = _serve(jeng, jp, jcfg, waves, jd, jcfg, **c["engine"])
    got_t, st_t = _serve(teng, tp, tcfg, waves, td, tcfg, **c["engine"])
    assert got_t == got_j
    for key in ("spec_proposed", "spec_accepted", "decode_tokens",
                "prefill_tokens", "prefix_cached_tokens", "rejected"):
        assert getattr(st_t, key) == getattr(st_j, key), key
    # Speculation changes no greedy transcript.
    plain = {k: v for k, v in c["engine"].items() if k not in SPEC_KEYS}
    assert _serve(teng, tp, tcfg, waves, **plain)[0] == got_t
    assert st_t.spec_proposed > 0
    assert st_t.spec_accepted <= st_t.spec_proposed
    assert st_t.decode_tokens == sum(
        len(toks) - 1 for reqs in got_t for _, toks, _ in reqs)
    rate = st_t.spec_accepted / st_t.spec_proposed
    if case == "ngram_k3":
        assert st_t.spec_accepted > 0, "the repetitive prompt must accept"
    if case in ("self_draft", "rounds3", "tail_flush_long"):
        assert rate >= 0.9, (st_t.spec_accepted, st_t.spec_proposed)
    if case == "rounds3":
        # 24 tokens at up to R (k + 1) = 12 a step: at most 4 steps.
        assert st_t.spec_proposed // (3 * 3) <= 4
        # decode_steps counts verify dispatches: R a speculative step.
        assert st_t.decode_steps % 3 == 0 and st_t.decode_steps // 3 <= 4
    if case == "prefix_int8":
        assert st_t.prefix_cached_tokens == 2 * PAGE


@pytest.mark.parametrize("draft", [None, "dense"], ids=["ngram", "rounds2"])
def test_speculative_sampled_requests(trees, draft):
    """:179 -- temperature > 0 requests speculate too (rejection
    sampling): lengths and token ranges hold, drafts are proposed; with
    a self-draft over two rounds the greedy request beside them keeps the
    plain engine's transcript."""
    _, tp = trees["dense"]
    cfg = CFGS["dense"][1]
    kw = dict(max_batch=2, num_pages=32, page_size=PAGE, tail_size=16,
              device="cpu", seed=3)
    spec_kw = dict(speculative_k=3)
    if draft is not None:
        spec_kw.update(speculative_rounds=2, draft_params=tp, draft_cfg=cfg)
    greedy = _prompts(9, (17,))[0]
    reqs = [teng.Request(prompt=[int(x) for x in np.tile([3, 1, 4, 1, 5], 6)],
                         max_new_tokens=8, temperature=0.7, top_p=0.9),
            teng.Request(prompt=greedy, max_new_tokens=8)]
    eng = teng.Engine(tp, cfg, **kw, **spec_kw)
    out = {c.request_id: c for c in eng.run(reqs)}
    for r in reqs:
        toks = out[r.request_id].tokens
        assert len(toks) == 8 and all(0 <= t < VOCAB for t in toks)
    assert eng.stats.spec_proposed > 0
    want = teng.Engine(tp, cfg, **kw).run(
        [teng.Request(prompt=greedy, max_new_tokens=8)])[0].tokens
    assert out[reqs[1].request_id].tokens == want


def test_draft_fn_request_id_protocol(trees):
    """A host draft_fn taking request_id is called with it (JAX :355): an
    oracle that proposes each request's own plain transcript accepts
    nearly every draft, and the transcripts stay the plain engine's."""
    _, tp = trees["dense"]
    cfg = CFGS["dense"][1]
    kw = dict(max_batch=2, num_pages=32, page_size=PAGE, tail_size=16,
              device="cpu")
    prompts = _prompts(10, (23, 40))
    plain = teng.Engine(tp, cfg, **kw)
    reqs = [teng.Request(prompt=p, max_new_tokens=12) for p in prompts]
    want = {r.request_id: c.tokens for r, c in zip(reqs, plain.run(reqs))}
    seen = set()

    def oracle(history, k, request_id):
        seen.add(request_id)
        full = list(want[request_id])
        done = len(history) - len(prompts[list(want).index(request_id)])
        nxt = full[done:done + k]
        return np.asarray(nxt + [0] * (k - len(nxt)), np.int32)

    eng = teng.Engine(tp, cfg, speculative_k=3, draft_fn=oracle, **kw)
    reqs2 = [teng.Request(prompt=p, max_new_tokens=12, request_id=r.request_id)
             for p, r in zip(prompts, reqs)]
    got = {c.request_id: c.tokens for c in eng.run(reqs2)}
    assert got == want and seen == set(want)
    st = eng.stats
    assert st.spec_accepted >= 0.75 * st.spec_proposed > 0


@pytest.mark.parametrize("kw, exc, match", [
    (dict(speculative_k=2, decode_chunk=2), ValueError, "mutually exclusive"),
    (dict(speculative_k=3, speculative_rounds=2, tail_size=8, draft=True),
     ValueError, "tail_size"),
    (dict(speculative_k=3, speculative_rounds=2), ValueError, "draft model"),
    (dict(draft=True), ValueError, "requires speculative_k"),
    (dict(speculative_k=3, draft_params_only=True), ValueError,
     "requires draft_cfg"),
], ids=["decode_chunk", "tail_size", "rounds_without_draft",
        "draft_without_k", "draft_without_cfg"])
def test_speculative_guards_match_jax(trees, kw, exc, match):
    """The guards of the JAX engine (:366-406), same types and messages,
    on both engines."""
    for mod, p, cfg, extra in ((jeng, trees["dense"][0], CFGS["dense"][0], {}),
                               (teng, trees["dense"][1], CFGS["dense"][1],
                                {"device": "cpu"})):
        args = dict(kw)
        if args.pop("draft", False):
            args.update(draft_params=p, draft_cfg=cfg)
        if args.pop("draft_params_only", False):
            args.update(draft_params=p)
        args.setdefault("tail_size", 16)
        with pytest.raises(exc, match=match):
            mod.Engine(p, cfg, num_pages=8, page_size=PAGE, **args, **extra)
