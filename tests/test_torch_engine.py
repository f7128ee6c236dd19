"""Port parity: the continuous-batching Engine of flash_attention_tpu_torch
against the JAX Engine, plus the paged KV cache and the page allocators.

Both engines serve the same requests on one parameter tree
(LlamaConfig.tiny, fp32; the JAX one with interpret-mode Pallas on the
CPU). Greedy transcripts must be IDENTICAL, token for token, with the
same finish reasons -- the cases of tests/test_engine.py (mixed
prompts, eos, rejection, tail flushes across a page) plus n=2 forks and
decode_chunk=4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models.llama import (
    LlamaConfig as JConfig,
    init_params as jax_init_params,
)
from flash_attention_tpu.runtime import engine as jeng
from flash_attention_tpu.runtime.kv_cache import (
    LayeredPagedKVCache as JCache,
)
from flash_attention_tpu_torch.models.llama import LlamaConfig
from flash_attention_tpu_torch.runtime import engine as teng
from flash_attention_tpu_torch.runtime.allocator import (
    NativeAllocator,
    PyAllocator,
    native_lib,
)
from flash_attention_tpu_torch.runtime.kv_cache import LayeredPagedKVCache
from flash_attention_tpu_torch.utils.convert import params_from_jax

JCFG = JConfig.tiny(dtype=jnp.float32)
TCFG = LlamaConfig.tiny(dtype=torch.float32)
PAGE = 128


@pytest.fixture(scope="module")
def params():
    jp = jax_init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, JCFG.vocab_size, n)]
            for n in lens]


def _serve_both(params, specs, **engine_kw):
    """Run the same request specs through both engines; returns the two
    completion lists as comparable tuples, in submission order."""
    jp, tp = params
    engine_kw.setdefault("max_batch", 4)
    engine_kw.setdefault("num_pages", 32)
    engine_kw.setdefault("page_size", PAGE)
    decode_chunk = engine_kw.pop("decode_chunk", 1)
    out = []
    for mod, p, cfg, extra in ((jeng, jp, JCFG, {}),
                               (teng, tp, TCFG, {"device": "cpu"})):
        eng = mod.Engine(p, cfg, **engine_kw, **extra)
        eng.decode_chunk = decode_chunk
        reqs = [mod.Request(**s) for s in specs]
        order = {r.request_id: i for i, r in enumerate(reqs)}
        comps = eng.run(reqs)
        out.append(sorted(
            (order[c.request_id], c.branch, tuple(c.tokens),
             c.finish_reason, c.prompt_len) for c in comps))
    return out


def test_engine_mixed_prompts_match_jax(params):
    specs = [dict(prompt=p, max_new_tokens=6)
             for p in _prompts(1, (7, 20, 13))]
    got_j, got_t = _serve_both(params, specs)
    assert len(got_t) == 3 and all(c[3] == "length" for c in got_t)
    assert got_t == got_j


def test_engine_eos_matches_jax(params):
    (prompt,) = _prompts(2, (9,))
    (probe,), _ = _serve_both(params, [dict(prompt=prompt,
                                            max_new_tokens=8)])
    eos = probe[2][2]
    got_j, got_t = _serve_both(
        params, [dict(prompt=prompt, max_new_tokens=8, eos_id=eos)])
    assert got_t == got_j
    assert got_t[0][3] == "stop" and got_t[0][2][-1] == eos


def test_engine_rejection_matches_jax(params):
    """Infeasible requests (too long; n > max_batch) come back rejected
    while feasible ones beside them complete."""
    specs = [dict(prompt=[1, 2, 3], max_new_tokens=2),
             dict(prompt=[2] * 10, max_new_tokens=10_000),
             dict(prompt=[4, 5], max_new_tokens=2),
             dict(prompt=[1] * 4, max_new_tokens=2, n=5)]
    got_j, got_t = _serve_both(params, specs, num_pages=4)
    assert got_t == got_j
    assert [c[3] for c in got_t] == ["length", "rejected", "length",
                                     "rejected"]


def test_engine_tail_flush_across_page_matches_jax(params):
    """tail_size 4 forces a flush every 4 tokens; the prompt ends 3
    tokens short of a page, so generation crosses a page boundary."""
    specs = [dict(prompt=p, max_new_tokens=13)
             for p in _prompts(3, (PAGE - 3,))]
    got_j, got_t = _serve_both(params, specs, num_pages=8, tail_size=4)
    assert got_t == got_j


def test_engine_forks_match_jax(params):
    """n=2: one prefill, one fork sharing the prompt pages; copy-on-write
    at the first shared-page flush. Greedy branches are identical."""
    specs = [dict(prompt=p, max_new_tokens=9, n=2)
             for p in _prompts(4, (PAGE + 20,))]
    got_j, got_t = _serve_both(params, specs, num_pages=16, tail_size=4)
    assert got_t == got_j
    assert [c[1] for c in got_t] == [0, 1] and got_t[0][2] == got_t[1][2]


def test_engine_decode_chunk_matches_jax(params):
    specs = [dict(prompt=p, max_new_tokens=11)
             for p in _prompts(5, (7, 130, 13))]
    got_j, got_t = _serve_both(params, specs, tail_size=8, decode_chunk=4)
    assert got_t == got_j


def test_engine_frees_pages_and_counts(params):
    _, tp = params
    eng = teng.Engine(tp, TCFG, max_batch=2, num_pages=16, page_size=PAGE,
                      tail_size=4, device="cpu")
    free0 = eng.cache.free_pages
    comps = eng.run([teng.Request(prompt=p, max_new_tokens=5)
                     for p in _prompts(6, (5, 9, 140))])
    assert len(comps) == 3 and eng.cache.free_pages == free0
    assert eng.stats.decode_tokens == 3 * 4
    assert eng.stats.prefill_tokens == 5 + 9 + 140


def test_engine_sampling_is_seeded(params):
    """Temperature + nucleus sampling (first token and decode steps, one
    and four steps per dispatch) draws from the engine's seeded
    torch.Generator: a seed reproduces its transcript. torch's random
    stream differs from jax.random's, so only the port is compared."""
    _, tp = params

    def serve(seed, chunk):
        eng = teng.Engine(tp, TCFG, max_batch=2, num_pages=8,
                          page_size=PAGE, tail_size=8, decode_chunk=chunk,
                          seed=seed, device="cpu")
        comps = eng.run([
            teng.Request(prompt=[1, 2, 3, 4], max_new_tokens=6,
                         temperature=0.8, top_p=0.9),
            teng.Request(prompt=[5, 6], max_new_tokens=5)])
        return [c.tokens for c in comps]

    a = serve(7, 1)
    assert a == serve(7, 1) and serve(7, 4)[1] == a[1]
    assert [len(t) for t in a] == [6, 5]
    assert all(0 <= t < TCFG.vocab_size for t in a[0])


def _cache_pair(**kw):
    kw = dict(n_layers=2, kv_heads=2, head_dim=64, num_pages=8,
              page_size=PAGE, max_seqs=3, tail_size=8, **kw)
    return (JCache(dtype=jnp.float32, **kw),
            LayeredPagedKVCache(dtype=torch.float32, device="cpu", **kw))


def test_cache_batch_state_and_flush_match_jax():
    """Same admissions, fork and tail contents into both caches; the page
    tables, lengths and pools after a flush (with copy-on-write of the
    shared boundary page) must agree exactly."""
    rng = np.random.default_rng(7)
    jc, tc = _cache_pair()
    kv = rng.normal(0, 1, (2, 2, 2, 100, 64)).astype(np.float32)
    kv2 = rng.normal(0, 1, (2, 2, 2, 130, 64)).astype(np.float32)
    ids = []
    for c, conv in ((jc, jnp.asarray), (tc, torch.from_numpy)):
        a = c.add_sequence(conv(kv[0]), conv(kv[1]))
        b = c.fork_sequence(a)
        d = c.add_sequence(conv(kv2[0]), conv(kv2[1]))
        ids.append([a, b, d])
    assert ids[0] == ids[1]
    slots = ids[0]
    for width in (2, 4):
        tj, lj = jc.batch_state(slots + [-1], width)
        tt, lt = tc.batch_state(slots + [-1], width)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert tc.live_pages(slots) == jc.live_pages(slots)
    assert np.array_equal(tc.bases(slots).numpy(), np.asarray(jc.bases(slots)))

    tails = rng.normal(0, 1, (2, 2, 3, 2, 8, 64)).astype(np.float32)
    jc.k_tails = [jnp.asarray(t) for t in tails[0]]
    jc.v_tails = [jnp.asarray(t) for t in tails[1]]
    tc.k_tails = [torch.from_numpy(t.copy()) for t in tails[0]]
    tc.v_tails = [torch.from_numpy(t.copy()) for t in tails[1]]
    counts = [5, 5, 3]
    jc.flush_tails(slots, counts)
    tc.flush_tails(slots, counts)
    assert tc.free_pages == jc.free_pages
    tj, lj = jc.batch_state(slots, 4)
    tt, lt = tc.batch_state(slots, 4)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    live = sorted({int(p) for p in np.asarray(tj)[lj > 0].ravel()}
                  - {jc.scratch_page})
    for pj, pt in zip(jc.k_pools + jc.v_pools, tc.k_pools + tc.v_pools):
        np.testing.assert_array_equal(pt.numpy()[:, live],
                                      np.asarray(pj)[:, live])


@pytest.mark.parametrize("kind", ["native", "python"])
def test_allocator_contract(kind):
    """The allocator contract of tests/test_paged.py, on the port's
    native (g++-built copy of the C++ source) and Python allocators."""
    if kind == "native":
        assert native_lib() is not None, "native allocator did not build"
        a = NativeAllocator(16, 128, 4)
    else:
        a = PyAllocator(16, 128, 4)
    s0 = a.alloc(300)
    assert a.free_pages == 13
    assert a.extend(s0, 400)
    table, n = a.page_table(s0, 8)
    assert n == 4 and len(set(table[:4])) == 4
    f = a.fork(s0)
    assert a.free_pages == 12
    page, copied = a.cow_last_page(f)
    assert copied == table[3] and page != table[3]
    a.free(s0)
    a.free(f)
    assert a.free_pages == 16
    b = PyAllocator(2, 128, 2) if kind == "python" else \
        NativeAllocator(2, 128, 2)
    s = b.alloc(256)
    assert s >= 0 and b.alloc(1) == -1
    assert not b.extend(s, 300)
    b.free(s)
    assert b.alloc(1) >= 0
