"""Port parity: chunked prefill -- the two chunk steps of models/llama.py
and the Engine's chunked-prefill path -- against the JAX package.

The chunk steps run on one parameter tree (LlamaConfig.tiny fp32,
converted from JAX) with seeded numpy tokens and prompt buffers, rows of
one dispatch at different prefix depths: logits and updated buffers
agree to max-abs 1e-4. The engine cases are those of
tests/test_engine.py (chunked prefill, decode interleaved with a long
prompt's chunks, a chunk that does not divide the bucket) and the
prefill lease of `max_decode_stall`: greedy transcripts and prefill
statistics must be IDENTICAL to the JAX engine's, and the per-step
progress of live slots too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import llama as jllama
from flash_attention_tpu.runtime import engine as jeng
from flash_attention_tpu_torch.models import llama as tllama
from flash_attention_tpu_torch.runtime import engine as teng
from flash_attention_tpu_torch.utils.convert import params_from_jax
from flash_attention_tpu_torch.utils.metrics import max_abs_error

JCFG = jllama.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tllama.LlamaConfig.tiny(dtype=torch.float32)
WCFG = (jllama.LlamaConfig.tiny(dtype=jnp.float32, window=96),
        tllama.LlamaConfig.tiny(dtype=torch.float32, window=96))
PAGE = 128
ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _buffers(rng, length, b=2):
    shape = (JCFG.n_layers, b, JCFG.n_kv_heads, length, JCFG.head_dim)
    return [rng.normal(0, 1, shape).astype(np.float32) for _ in range(2)]


def _step_both(params, jfn, tfn, jcfg, tcfg, tokens, bufs, prefix, counts):
    jp, tp = params
    lj, kj, vj = jfn(jp, jnp.asarray(tokens), jcfg,
                     *(jnp.asarray(x) for x in bufs), jnp.asarray(prefix),
                     jnp.asarray(counts))
    lt, kt, vt = tfn(tp, torch.from_numpy(tokens).long(), tcfg,
                     *(torch.from_numpy(x.copy()) for x in bufs),
                     torch.from_numpy(prefix), torch.from_numpy(counts))
    assert max_abs_error(lt, np.asarray(lj)) <= ATOL
    assert max_abs_error(kt, np.asarray(kj)) <= ATOL
    assert max_abs_error(vt, np.asarray(vj)) <= ATOL


def test_prefill_chunk_step_matches_jax(params, rng):
    """Two rows of one dispatch: one at prefix 0 (its prefix attention
    sees nothing), one at prefix 64 with a short final chunk."""
    tokens = rng.integers(0, JCFG.vocab_size, (2, 32)).astype(np.int32)
    _step_both(params, jllama.prefill_chunk_step,
               tllama.prefill_chunk_step, JCFG, TCFG, tokens,
               _buffers(rng, 128), np.array([0, 64], np.int32),
               np.array([32, 19], np.int32))


def test_prefill_window_chunk_step_matches_jax(params, rng):
    """The rolling-buffer step of a windowed model: one row whose buffer
    is empty (prefix 0), one deeper than the window (prefix 200)."""
    tokens = rng.integers(0, JCFG.vocab_size, (2, 32)).astype(np.int32)
    _step_both(params, jllama.prefill_window_chunk_step,
               tllama.prefill_window_chunk_step, *WCFG, tokens,
               _buffers(rng, 160), np.array([0, 200], np.int32),
               np.array([32, 7], np.int32))


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, JCFG.vocab_size, n)]
            for n in lens]


def _engines(params, **kw):
    jp, tp = params
    kw = dict(dict(max_batch=4, num_pages=32, page_size=PAGE), **kw)
    return (jeng.Engine(jp, JCFG, **kw),
            teng.Engine(tp, TCFG, device="cpu", **kw))


def _run_both(params, specs, **kw):
    out = []
    for eng in _engines(params, **kw):
        mod = jeng if isinstance(eng, jeng.Engine) else teng
        reqs = [mod.Request(**s) for s in specs]
        by_id = {c.request_id: c for c in eng.run(reqs)}
        out.append(([(tuple(by_id[r.request_id].tokens),
                      by_id[r.request_id].finish_reason) for r in reqs],
                     eng.stats))
    (got_j, st_j), (got_t, st_t) = out
    assert got_t == got_j
    assert (st_t.prefill_tokens, st_t.decode_tokens) == \
        (st_j.prefill_tokens, st_j.decode_tokens)
    return got_t, st_t


def test_engine_chunked_prefill_matches_jax(params):
    """tests/test_engine.py:279 -- 4 chunks of 32 and a single short
    chunk; TTFT recorded per request."""
    specs = [dict(prompt=p, max_new_tokens=5) for p in _prompts(1, (100, 17))]
    _, stats = _run_both(params, specs, prefill_chunk=32)
    assert len(stats.ttft_s) == 2 and min(stats.ttft_s) > 0


def test_engine_chunked_prefill_interleaves_decode_matches_jax(params):
    """:301 -- a long prompt admitted mid-stream does not stall live
    decode: the live slots' progress after every step equals the JAX
    engine's, and so do the transcripts."""
    shorts = _prompts(2, (7, 9, 11))
    (long_prompt,) = _prompts(3, (120,))
    trace, finals = [], []
    for eng in _engines(params, prefill_chunk=32):
        mod = jeng if isinstance(eng, jeng.Engine) else teng
        reqs = [mod.Request(prompt=p, max_new_tokens=24) for p in shorts]
        for r in reqs:
            eng.submit(r)
        done = eng.step()
        steps = [(len(eng.prefilling), tuple(
            len(s.generated) if s else 0 for s in eng.slots))]
        reqs.append(mod.Request(prompt=long_prompt, max_new_tokens=4))
        eng.submit(reqs[-1])
        for _ in range(3):
            done += eng.step()
            steps.append((len(eng.prefilling), tuple(
                len(s.generated) if s else 0 for s in eng.slots)))
        trace.append(steps)
        by_id = {c.request_id: c for c in done + eng.run()}
        finals.append([by_id[r.request_id].tokens for r in reqs])
    assert trace[1] == trace[0] and finals[1] == finals[0]
    (_, before), (prefilling, after) = trace[1][0], trace[1][-1]
    assert sum(n > 0 for n in before) == 3 and prefilling == 1
    assert max(after) > max(before)             # decode kept going


@pytest.mark.parametrize("stall", [0, 2])
def test_engine_decode_stall_lease_matches_jax(params, stall):
    """The prefill lease: with one live slot (under the near-full mark)
    and a long prompt mid-prefill, at most `max_decode_stall`
    prefill-only steps run before a decode step. Which steps decode,
    and the transcripts, equal the JAX engine's."""
    (short,) = _prompts(7, (9,))
    (long_prompt,) = _prompts(8, (200,))
    trace, finals = [], []
    for eng in _engines(params, prefill_chunk=32, max_decode_stall=stall):
        mod = jeng if isinstance(eng, jeng.Engine) else teng
        reqs = [mod.Request(prompt=short, max_new_tokens=16),
                mod.Request(prompt=long_prompt, max_new_tokens=3)]
        eng.submit(reqs[0])
        done = eng.step()
        eng.submit(reqs[1])
        steps = []
        for _ in range(6):
            done += eng.step()
            steps.append((len(eng.prefilling), eng.stats.decode_tokens))
        trace.append(steps)
        by_id = {c.request_id: c for c in done + eng.run()}
        finals.append([by_id[r.request_id].tokens for r in reqs])
    assert trace[1] == trace[0] and finals[1] == finals[0]
    decoded = [b - a for (_, a), (_, b) in zip(trace[1], trace[1][1:])]
    assert all(decoded) if stall == 0 else 0 < sum(decoded) < len(decoded)


def test_engine_non_pow2_prefill_chunk_matches_jax(params):
    """:384 -- a chunk of 100 snaps to a power of two dividing the
    bucket; decode_chunk 2."""
    (prompt,) = _prompts(4, (300,))
    _run_both(params, [dict(prompt=prompt, max_new_tokens=5)],
              prefill_chunk=100, decode_chunk=2)


def test_chunked_prefill_equals_monolithic(params):
    """The port's chunked and monolithic prefill give the same greedy
    transcripts (prompts of 1 to 3 chunks, n = 2 forks)."""
    _, tp = params
    specs = [dict(prompt=p, max_new_tokens=6) for p in _prompts(5, (40, 70))]
    specs.append(dict(prompt=_prompts(6, (33,))[0], max_new_tokens=4, n=2))
    outs = []
    for kw in ({}, dict(prefill_chunk=32)):
        eng = teng.Engine(tp, TCFG, max_batch=4, num_pages=32,
                          page_size=PAGE, tail_size=8, device="cpu", **kw)
        reqs = [teng.Request(**s) for s in specs]
        outs.append([c.tokens for c in eng.run(reqs)])
        assert eng.cache.free_pages == eng.cache.num_pages - 1
    assert outs[0] == outs[1]
