"""Port parity: the prefix cache and the cache's sliding-window state
against the JAX package.

  * `page_chain_hashes` gives the JAX function's uint64 values.
  * The same registrations, matches, gathers, evictions and writes drive
    a JAX and a port LayeredPagedKVCache (fp32, on the CPU): acquired
    pages, gathered buffers, free counts, bases, page tables, lengths
    and live pool contents agree exactly (tests/test_prefix_cache.py:31-90,
    tests/test_window_eviction.py:82-140).
  * The engine cases of tests/test_prefix_cache.py:103-175 and :187
    (int8 pools; LlamaConfig.tiny fp32, one tree converted from JAX):
    greedy transcripts, prefix_cached_tokens and prefill_tokens
    IDENTICAL to the JAX engine's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import llama as jllama
from flash_attention_tpu.runtime import engine as jeng
from flash_attention_tpu.runtime.kv_cache import (
    LayeredPagedKVCache as JCache,
    page_chain_hashes as jax_hashes,
)
from flash_attention_tpu_torch.models import llama as tllama
from flash_attention_tpu_torch.runtime import engine as teng
from flash_attention_tpu_torch.runtime.kv_cache import (
    LayeredPagedKVCache,
    page_chain_hashes,
)
from flash_attention_tpu_torch.utils.convert import params_from_jax

JCFG = jllama.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tllama.LlamaConfig.tiny(dtype=torch.float32)
PAGE = 128


def test_page_chain_hashes_match_jax():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 1 << 20, 5 * 16 + 7).astype(np.int32)
    for page in (16, 32, 128):
        got, want = page_chain_hashes(toks, page), jax_hashes(toks, page)
        assert got.dtype == np.uint64 and len(got) == len(toks) // page
        np.testing.assert_array_equal(got, want)
    # Same page content under another prefix gives another chain hash.
    other = toks.copy()
    other[0] += 1
    assert (page_chain_hashes(other, 16) != page_chain_hashes(toks, 16)).all()


def _pair(**kw):
    kw = dict(dict(n_layers=2, kv_heads=2, head_dim=64, num_pages=8,
                   page_size=PAGE, max_seqs=3, tail_size=16), **kw)
    return (JCache(dtype=jnp.float32, **kw),
            LayeredPagedKVCache(dtype=torch.float32, device="cpu", **kw))


def _assert_same_state(jc, tc, sids, width):
    tj, lj = jc.batch_state(sids, width)
    tt, lt = tc.batch_state(sids, width)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(tc.bases(sids).numpy(),
                                  np.asarray(jc.bases(sids)))
    assert tc.free_pages == jc.free_pages
    assert [tc.length(s) for s in sids] == [jc.length(s) for s in sids]
    assert [tc.base_tokens(s) for s in sids] == \
        [jc.base_tokens(s) for s in sids]
    live = sorted({int(p) for p in np.asarray(tj)[lj > 0].ravel()}
                  - {jc.scratch_page})
    for pj, pt in zip(jc.k_pools + jc.v_pools, tc.k_pools + tc.v_pools):
        np.testing.assert_array_equal(pt.numpy()[:, live],
                                      np.asarray(pj)[:, live])


def test_prefix_cache_state_matches_jax():
    """Register a 3-page prompt, free it, match a prompt sharing two
    pages, gather them into a prefill buffer, admit on them."""
    rng = np.random.default_rng(1)
    jc, tc = _pair()
    prompt = rng.integers(0, 512, 3 * PAGE + 5).astype(np.int32)
    kv = rng.normal(0, 1, (2, 2, 2, len(prompt), 64)).astype(np.float32)
    suffix = rng.normal(0, 1, (2, 2, 2, 40, 64)).astype(np.float32)
    other = np.concatenate([prompt[:2 * PAGE], prompt[:40]])
    out = []
    for c, conv in ((jc, jnp.asarray), (tc, torch.from_numpy)):
        sid = c.add_sequence(conv(kv[0]), conv(kv[1]))
        added = c.register_prefix(sid, prompt)
        c.free_sequence(sid)
        pages, hashes = c.match_prefix(other)
        kg, vg = c.gather_pages(pages, 4 * PAGE)
        sid2 = c.add_sequence_prefixed(pages, conv(suffix[0]),
                                       conv(suffix[1]), 2 * PAGE + 40)
        again, _ = c.match_prefix(prompt)
        c.release_pages(again)
        out.append((added, list(pages), np.asarray(hashes), np.asarray(kg),
                    np.asarray(vg), sid2, list(again)))
    (aj, pj, hj, kgj, vgj, sj, gj), (at, pt, ht, kgt, vgt, st, gt) = out
    assert (at, pt, st, gt) == (aj, pj, sj, gj) and at == 3 and len(pt) == 2
    np.testing.assert_array_equal(ht, hj)
    np.testing.assert_array_equal(kgt, kgj)
    np.testing.assert_array_equal(vgt, vgj)
    assert kgt.shape == (2, 1, 2, 4 * PAGE, 64)
    assert not kgt[:, :, :, 2 * PAGE:].any()
    _assert_same_state(jc, tc, [st], 4)


def test_evict_below_and_base_state_match_jax():
    """tests/test_window_eviction.py:82-140: front-pop eviction, stored
    coordinates, reuse of freed pages, a flush into an evicted sequence
    and the write-below-base rejection, on both caches."""
    rng = np.random.default_rng(2)
    jc, tc = _pair(max_seqs=2)
    t = 3 * PAGE + 40
    kv = rng.normal(0, 1, (2, 2, 2, t, 64)).astype(np.float32)
    tails = rng.normal(0, 1, (2, 2, 2, 2, 16, 64)).astype(np.float32)
    ids = []
    for c, conv in ((jc, jnp.asarray), (tc, torch.from_numpy)):
        sid = c.add_sequence(conv(kv[0]), conv(kv[1]))
        assert c.evict_below(sid, 300) == 2 and c.evict_below(sid, 10) == 0
        sid2 = c.add_sequence(conv(kv[0][:, :, :2 * PAGE]),
                              conv(kv[1][:, :, :2 * PAGE]))
        c.k_tails = [conv(x.copy()) for x in tails[0]]
        c.v_tails = [conv(x.copy()) for x in tails[1]]
        c.flush_tails([sid, -1], [8, 0])
        with pytest.raises(ValueError, match="below evicted base"):
            c.write(sid, 0, conv(kv[0][:, :, :8]), conv(kv[1][:, :, :8]))
        ids.append((sid, sid2))
    assert ids[0] == ids[1]
    _assert_same_state(jc, tc, list(ids[0]), 4)
    assert tc.length(ids[0][0]) == t + 8
    assert tc.base_tokens(ids[0][0]) == 2 * PAGE


def test_windowed_admission_with_base_matches_jax():
    """add_sequence(base_tokens=) admits a sequence whose front is
    already evicted (the windowed install)."""
    rng = np.random.default_rng(3)
    jc, tc = _pair()
    kv = rng.normal(0, 1, (2, 2, 2, 150, 64)).astype(np.float32)
    sids = [c.add_sequence(conv(kv[0]), conv(kv[1]), base_tokens=2 * PAGE)
            for c, conv in ((jc, jnp.asarray), (tc, torch.from_numpy))]
    assert sids[0] == sids[1]
    _assert_same_state(jc, tc, [sids[1]], 4)
    assert tc.length(sids[1]) == 2 * PAGE + 150
    with pytest.raises(ValueError, match="page-aligned"):
        tc.add_sequence(torch.from_numpy(kv[0]), torch.from_numpy(kv[1]),
                        base_tokens=5)


# --- engine ---------------------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, JCFG.vocab_size, n)]
            for n in lens]


def _serve_both(params, waves, **kw):
    """Each wave (a list of (prompt, max_new_tokens)) runs to completion
    on one engine per package before the next; returns the port's
    transcripts and stats after checking both against the JAX engine."""
    jp, tp = params
    kw = dict(dict(max_batch=2, num_pages=32, page_size=PAGE), **kw)
    out = []
    for mod, p, cfg, extra in ((jeng, jp, JCFG, {}),
                               (teng, tp, TCFG, {"device": "cpu"})):
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
    for key in ("prefill_tokens", "prefix_cached_tokens", "decode_tokens"):
        assert getattr(eng_t.stats, key) == getattr(eng_j.stats, key), key
    assert eng_t.cache.free_pages == eng_t.cache.num_pages - 1
    return got_t, eng_t.stats


def test_engine_prefix_cache_hit_matches_jax(params):
    """:103 -- a repeated prompt reuses both full pages; the transcripts
    equal the uncached port engine's."""
    (prompt,) = _prompts(1, (2 * PAGE + 17,))
    wave = [(prompt, 6), (prompt, 6)]
    got, stats = _serve_both(params, [wave], prefix_cache=True)
    base, base_stats = _serve_both(params, [wave])
    assert got == base and stats.prefix_cached_tokens == 2 * PAGE
    assert stats.prefill_tokens == base_stats.prefill_tokens - 2 * PAGE


def test_engine_prefix_cache_partial_overlap_matches_jax(params):
    """:117 -- prompts sharing one full page reuse it."""
    common, a, b = _prompts(2, (PAGE, 40, 55))
    _, stats = _serve_both(params, [[(common + a, 5), (common + b, 5)]],
                           prefix_cache=True)
    assert stats.prefix_cached_tokens == PAGE


def test_engine_prefix_cache_with_chunked_prefill_matches_jax(params):
    """:129 -- pages registered at install hit through the chunked
    machinery when the prompt is served again after the first
    finishes."""
    (prompt,) = _prompts(3, (2 * PAGE + 9,))
    _, stats = _serve_both(params, [[(prompt, 5)], [(prompt, 5)]],
                           prefix_cache=True, prefill_chunk=64,
                           decode_chunk=2)
    assert stats.prefix_cached_tokens == 2 * PAGE


def test_engine_prefix_cache_multi_turn_matches_jax(params):
    """:145 -- turn 2's prompt extends turn 1's transcript; the page
    registered at finish (prompt + fed tokens) is reused."""
    (p1,) = _prompts(4, (PAGE - 8,))
    (out1,), _ = _serve_both(params, [[(p1, 24)]])
    _, stats = _serve_both(params, [[(p1, 24)], [(p1 + out1, 4)]],
                           prefix_cache=True)
    assert stats.prefix_cached_tokens >= PAGE


def test_engine_prefix_cache_under_eviction_pressure_matches_jax(params):
    """:165 -- a small pool: cached pages are evicted and re-registered
    while four prompts are revisited."""
    prompts = _prompts(5, [PAGE + 11] * 4)
    _serve_both(params, [[(p, 4) for p in prompts + prompts]],
                prefix_cache=True, num_pages=8)


def test_probe_prefix_changes_nothing(params):
    _, tp = params
    (prompt,) = _prompts(6, (2 * PAGE + 3,))
    eng = teng.Engine(tp, TCFG, max_batch=2, num_pages=16, page_size=PAGE,
                      prefix_cache=True, device="cpu")
    assert eng.probe_prefix(prompt) == 0
    eng.run([teng.Request(prompt=prompt, max_new_tokens=2)])
    free = eng.cache.free_pages
    assert eng.probe_prefix(prompt) == 2 * PAGE == eng.probe_prefix(prompt)
    assert eng.cache.free_pages == free


def test_engine_prefix_cache_quantized_pools_matches_jax(params):
    """:187 -- int8 pools: cached pages hold quantized KV, the gather
    dequantizes them for the prefix buffer, and the transcripts equal the
    JAX engine's and the uncached port engine's."""
    jp, tp = params
    (prompt,) = _prompts(7, (2 * PAGE + 13,))
    kw = dict(max_batch=2, num_pages=32, page_size=PAGE)
    out = []
    for mod, p, cfg, extra in (
            (jeng, jp, JCFG, dict(kv_quant_dtype=jnp.int8,
                                  prefix_cache=True)),
            (teng, tp, TCFG, dict(kv_quant_dtype=torch.int8,
                                  prefix_cache=True, device="cpu")),
            (teng, tp, TCFG, dict(kv_quant_dtype=torch.int8,
                                  device="cpu"))):
        eng = mod.Engine(p, cfg, **kw, **extra)
        reqs = [mod.Request(prompt=prompt, max_new_tokens=5)
                for _ in range(2)]
        by_id = {c.request_id: c for c in eng.run(reqs)}
        out.append(([by_id[r.request_id].tokens for r in reqs], eng.stats))
    (got_j, st_j), (got_t, st_t), (base, _) = out
    assert got_t == got_j == base
    assert st_t.prefix_cached_tokens == st_j.prefix_cached_tokens == 2 * PAGE
    assert st_t.prefill_tokens == st_j.prefill_tokens
