"""Port parity: sliding windows and segment ids in the attention kernels'
plain versions (B1, B4, B5), the windowed model paths, and the Engine
serving a windowed model, against the JAX package.

Kernels: seeded numpy inputs go through the JAX function (interpret-mode
Pallas on the CPU) and the port's plain version (the tensors lie on the
CPU) in fp32; O and the LSE of rows that see something agree to max-abs
2e-5, and a row that sees nothing gives O = 0 and LSE = INIT_M * scale in
both. Engine: LlamaConfig.tiny fp32 with window 96 and tail_size 16 (as
tests/test_window_serving.py), one parameter tree converted from JAX;
greedy transcripts and the prefill statistics must be IDENTICAL.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import llama as jllama
from flash_attention_tpu.models.sampling import generate as jax_generate
from flash_attention_tpu.ops.decode import flash_decode as jax_decode
from flash_attention_tpu.ops.flash import (
    SegmentIds as JSegmentIds,
    flash_attention_fwd as jax_fwd,
)
from flash_attention_tpu.ops.paged import paged_flash_decode as jax_paged
from flash_attention_tpu.runtime import engine as jeng
from flash_attention_tpu_torch.models import llama as tllama
from flash_attention_tpu_torch.models.sampling import generate
from flash_attention_tpu_torch.ops import decode as tdec
from flash_attention_tpu_torch.ops import flash as tflash
from flash_attention_tpu_torch.ops import paged as tpaged
from flash_attention_tpu_torch.ops.flash import INIT_M
from flash_attention_tpu_torch.runtime import engine as teng
from flash_attention_tpu_torch.utils.convert import params_from_jax
from flash_attention_tpu_torch.utils.metrics import max_abs_error

ATOL = 2e-5
WINDOW = 96
JCFG = jllama.LlamaConfig.tiny(dtype=jnp.float32, window=WINDOW)
TCFG = tllama.LlamaConfig.tiny(dtype=torch.float32, window=WINDOW)
PAGE = 128


# --- B1 -------------------------------------------------------------------


def _b1_both(rng, b, hq, hkv, nq, nk, d=64, qseg=None, kvseg=None, **kw):
    q = rng.normal(0, 1, (b, hq, nq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, nk, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, nk, d)).astype(np.float32)
    jseg = tseg = None
    if qseg is not None:
        qseg, kvseg = (np.asarray(x, np.int32) for x in (qseg, kvseg))
        jseg = JSegmentIds(jnp.asarray(qseg), jnp.asarray(kvseg))
        tseg = tflash.SegmentIds(torch.from_numpy(qseg),
                                 torch.from_numpy(kvseg))
    o_j, lse_j = jax_fwd(*(jnp.asarray(x) for x in (q, k, v)), jseg, **kw)
    o_t, lse_t = tflash.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), tseg, **kw)
    return np.asarray(o_j), np.asarray(lse_j)[..., 0], o_t, lse_t


def _assert_b1(o_j, lse_j, o_t, lse_t, d=64):
    dead = lse_j <= INIT_M / math.sqrt(d) / 2
    assert max_abs_error(o_t, o_j) <= ATOL
    assert max_abs_error(lse_t[~dead], lse_j[~dead]) <= ATOL
    np.testing.assert_array_equal(dead, lse_t.numpy() <= INIT_M / 16)
    if dead.any():
        assert bool((o_t.numpy()[dead] == 0).all())
        np.testing.assert_allclose(lse_t.numpy()[dead],
                                   INIT_M / math.sqrt(d), rtol=1e-6)
    return int(dead.sum())


def test_b1_packed_segments_match_jax(rng):
    """Packed documents (sorted segment ids, one document per batch row
    at a different cut), causal and not."""
    nq = nk = 150
    cuts = np.array([[40, 90], [1, 149]])
    seg = np.stack([np.searchsorted(c, np.arange(nq), side="right")
                    for c in cuts])
    for causal in (True, False):
        got = _b1_both(rng, 2, 4, 2, nq, nk, qseg=seg, kvseg=seg,
                       causal=causal)
        _assert_b1(*got)


def test_b1_window_matches_jax(rng):
    """Causal self-attention under windows narrower than a tile and
    wider than the sequence, and a window with offset > Nk - Nq."""
    for nq, nk, window, offset in ((200, 200, 37, None),
                                   (200, 200, 300, None),
                                   (64, 160, 96, 160)):
        got = _b1_both(rng, 1, 4, 2, nq, nk, causal=True, window=window,
                       offset=offset)
        _assert_b1(*got)


@pytest.mark.parametrize("prefix_len", [(0, 70), (150, 9)],
                         ids=["empty-prefix", "partial"])
def test_b1_chunk_prefix_mask_matches_jax(rng, prefix_len):
    """prefill_chunk_step's prefix attention: non-causal over a padded
    buffer with columns >= prefix_len[b] hidden by segment ids. A
    prefix_len of 0 leaves whole rows that see nothing."""
    nq, nk = 32, 192
    kvseg = (np.arange(nk)[None, :]
             >= np.asarray(prefix_len)[:, None]).astype(np.int32)
    got = _b1_both(rng, 2, 4, 2, nq, nk, qseg=np.zeros((2, nq)),
                   kvseg=kvseg, causal=False)
    dead = _assert_b1(*got)
    assert dead == (4 * nq if 0 in prefix_len else 0)


def test_b1_roll_buffer_matches_jax(rng):
    """prefill_window_chunk_step's roll-buffer attention: causal,
    offset = W_b, the model window, segment ids masking the unfilled
    front (prefix 0: every row dead; prefix 50: the front 110 columns)."""
    c, w_b = 32, 160
    prefix = np.array([0, 50])
    kvseg = (np.arange(w_b)[None, :] < w_b - prefix[:, None]).astype(
        np.int32)
    got = _b1_both(rng, 2, 4, 2, c, w_b, qseg=np.zeros((2, c)),
                   kvseg=kvseg, causal=True, offset=w_b, window=WINDOW)
    assert _assert_b1(*got) == 4 * c


def test_b1_backward_of_window_or_segments_raises():
    """The backward of a windowed or segmented forward (once a raise,
    now B2/B3's window and segment-id branches): gradients through the
    port's flash_attention equal jax.grad through the JAX package's,
    max-abs 2e-5, at the model's window over T = 256 and with two
    packed documents."""
    from flash_attention_tpu.config import BlockSizes
    from flash_attention_tpu.ops.flash import flash_attention as jax_flash

    blocks = BlockSizes(block_q=128, block_kv=128, block_q_dq=128,
                        block_kv_dq=128, block_q_dkv=128, block_kv_dkv=128)
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(0, 0.02, (1, 2, 256, 64)).astype(np.float32)
               for _ in range(3))
    ct = rng.normal(0, 1, (1, 2, 256, 64)).astype(np.float32)
    seg = (np.arange(256)[None] >= 100).astype(np.int32)
    for kw, jkw in ((dict(window=WINDOW), dict(window=WINDOW)),
                    (dict(segment_ids=tflash.SegmentIds(
                        torch.from_numpy(seg), torch.from_numpy(seg))),
                     dict(segment_ids=JSegmentIds(jnp.asarray(seg),
                                                  jnp.asarray(seg))))):
        qkv = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = tflash.flash_attention(*qkv, causal=True, **kw)
        got = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), qkv)
        want = jax.grad(lambda q, k, v: jnp.sum(jax_flash(
            q, k, v, causal=True, block_sizes=blocks, **jkw) * ct),
            argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
        for a, ref in zip(got, want):
            assert max_abs_error(a, np.asarray(ref)) <= ATOL


def test_b1_cost_counts_visible_pairs_only():
    full = tflash.fwd_cost(1, 2, 1, 8, 8, 64, True, 2)
    win = tflash.fwd_cost(1, 2, 1, 8, 8, 64, True, 2, window=2)
    assert full[0] == 4 * 2 * 36 * 64 and win[0] == 4 * 2 * 15 * 64
    assert win[1] == full[1]                 # every column seen once
    seg = tflash.SegmentIds(torch.zeros(1, 4, dtype=torch.int32),
                            torch.tensor([[1] * 6 + [0] * 2],
                                         dtype=torch.int32))
    f, nbytes = tflash.fwd_cost(1, 2, 1, 4, 8, 64, True, 2, offset=8,
                                window=4, segment_ids=seg)
    assert f == 4 * 2 * 5 * 64                # pairs (0,6) (0,7) (1,6) (1,7) (2,7)
    assert nbytes == 2 * 64 * (2 * 2 * 4 + 2 * 1 * 2) + 4 * 2 * 4 + 4 * 12


# --- B4, B5 ---------------------------------------------------------------


def _pools(rng, hkv, pages, d, b, hq):
    kp = rng.normal(0, 1, (hkv, pages, PAGE, d)).astype(np.float32)
    vp = rng.normal(0, 1, (hkv, pages, PAGE, d)).astype(np.float32)
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    tbl = rng.permutation(pages)[:b * 3].reshape(b, 3).astype(np.int32)
    return q, kp, vp, tbl


@pytest.mark.parametrize("spread", [1, 4])
def test_b4_window_starts_match_jax(rng, spread):
    """Explicit window starts, some negative (window not yet full), with
    1 and 4 folded query positions (tests/test_window_eviction.py)."""
    b, hkv, group, d = 3, 2, 2, 64
    q, kp, vp, tbl = _pools(rng, hkv, 10, d, b, hkv * group * spread)
    lens = np.array([300, 215, 90], np.int32)
    starts = np.array([110, -50, 40], np.int32)
    o_j, lse_j = jax_paged(
        *(jnp.asarray(x) for x in (q, kp, vp, tbl, lens)),
        window_starts=jnp.asarray(starts), qpos_spread=spread,
        return_lse=True)
    o_t, lse_t = tpaged.paged_flash_decode(
        *(torch.from_numpy(x) for x in (q, kp, vp, tbl, lens)),
        window_starts=torch.from_numpy(starts), qpos_spread=spread,
        return_lse=True)
    assert max_abs_error(o_t, np.asarray(o_j)) <= ATOL
    assert max_abs_error(lse_t, np.asarray(lse_j)) <= ATOL
    ref = tpaged.paged_decode_reference(
        *(torch.from_numpy(x) for x in (q, kp, vp, tbl, lens)),
        window_starts=torch.from_numpy(starts), qpos_spread=spread)
    assert max_abs_error(o_t, ref) <= ATOL


def test_b4_window_and_negative_starts(rng):
    """`window=` gives starts = lengths - window; negative starts mask
    nothing; a start past the length leaves the row dead."""
    b, hkv, d = 3, 2, 64
    q, kp, vp, tbl = _pools(rng, hkv, 10, d, b, 4)
    lens = np.array([300, 60, 200], np.int32)
    args = [torch.from_numpy(x) for x in (q, kp, vp, tbl, lens)]
    o_j = jax_paged(*(jnp.asarray(x) for x in (q, kp, vp, tbl, lens)),
                    window=WINDOW)
    o_t = tpaged.paged_flash_decode(*args, window=WINDOW)
    assert max_abs_error(o_t, np.asarray(o_j)) <= ATOL
    plain = tpaged.paged_flash_decode(*args)
    neg = tpaged.paged_flash_decode(
        *args, window_starts=torch.tensor([-5, -1, -200],
                                          dtype=torch.int32))
    assert max_abs_error(neg, plain) == 0.0
    o, lse = tpaged.paged_flash_decode(
        *args, window_starts=torch.tensor([300, 0, 0], dtype=torch.int32),
        return_lse=True)
    assert bool((o[0] == 0).all())
    np.testing.assert_allclose(lse[0].numpy(), INIT_M / math.sqrt(d),
                               rtol=1e-6)


def test_b4_cost_reads_only_window_pages():
    f, nbytes = tpaged.paged_decode_cost([300], 4, 2, 64, 2, PAGE,
                                         starts=[200], qpos_spread=2)
    assert f == 4 * 2 * 64 * (100 + 99)       # q rows t = 0, 1 per kv head
    assert nbytes == (2 * 2 * 100 * 64 * 2 + 2 * 4 * 64 * 2 + 4 * 4
                      + 4 * (2 + 1) + 4)


def test_b5_window_matches_jax(rng):
    b, hq, hkv, s, d = 4, 8, 2, 256, 64
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    lens = np.array([0, 50, 200, 256], np.int32)
    want = np.asarray(jax_decode(*(jnp.asarray(x) for x in (q, k, v, lens)),
                                 window=WINDOW))
    args = [torch.from_numpy(x) for x in (q, k, v, lens)]
    got = tdec.flash_decode(*args, window=WINDOW)
    assert max_abs_error(got, want) <= ATOL
    assert max_abs_error(got, tdec.decode_reference(*args, window=WINDOW)) \
        <= ATOL
    assert bool((got[0] == 0).all())
    flops, _ = tdec.decode_cost(lens, hq, hkv, d, 2, window=WINDOW)
    assert flops == 4 * hq * d * (0 + 50 + 96 + 96)


# --- model and engine -----------------------------------------------------


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(JCFG, jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def test_windowed_forward_prefill_decode_match_jax(params, rng):
    """The windowed forward, the contiguous prefill and decode_step (B5
    with a window) across the window boundary, against the JAX model:
    logits max-abs <= 1e-4."""
    jp, tp = params
    toks = rng.integers(0, JCFG.vocab_size, (2, 128)).astype(np.int32)
    want = np.asarray(jllama.forward(jp, jnp.asarray(toks), JCFG))
    got = tllama.forward(tp, torch.from_numpy(toks).long(), TCFG)
    assert max_abs_error(got.detach(), want) <= 1e-4
    cache = tllama.init_kv_cache(TCFG, 2, 256, device="cpu")
    logits, cache, lens = tllama.prefill(
        tp, torch.from_numpy(toks[:, :100]).long(), TCFG, cache)
    assert max_abs_error(logits, want[:, 99]) <= 1e-4
    for i in range(100, 104):
        logits, cache, lens = tllama.decode_step(
            tp, torch.from_numpy(toks[:, i]).long(), TCFG, cache, lens)
        assert max_abs_error(logits, want[:, i]) <= 1e-4


def test_windowed_generate_matches_jax(params, rng):
    """A converted windowed tree generates the JAX transcript (B5's
    window branch on the generate path)."""
    jp, tp = params
    prompt = rng.integers(0, JCFG.vocab_size, (2, 90)).astype(np.int32)
    want = np.asarray(jax_generate(jp, jnp.asarray(prompt), JCFG,
                                   max_new_tokens=12))
    got = generate(tp, torch.from_numpy(prompt), TCFG, max_new_tokens=12)
    np.testing.assert_array_equal(got.numpy(), want)


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, JCFG.vocab_size, n)]
            for n in lens]


def _serve_both(params, waves, poll=None, **engine_kw):
    """Serve `waves` (lists of request specs, each wave run to completion
    before the next) on one JAX and one port engine; returns per engine
    (transcripts in submission order, stats). `poll(engine)` runs after
    every step of the port engine."""
    jp, tp = params
    engine_kw = dict(dict(max_batch=4, num_pages=32, page_size=PAGE,
                          tail_size=16), **engine_kw)
    out = []
    for mod, p, cfg, extra in ((jeng, jp, JCFG, {}),
                               (teng, tp, TCFG, {"device": "cpu"})):
        eng = mod.Engine(p, cfg, **engine_kw, **extra)
        got = []
        for wave in waves:
            reqs = [mod.Request(**s) for s in wave]
            for r in reqs:
                eng.submit(r)
            done = []
            while eng.pending or eng.prefilling or eng.num_active:
                done += eng.step()
                if poll is not None and mod is teng:
                    poll(eng)
            by_id = {c.request_id: c for c in done}
            got += [(tuple(by_id[r.request_id].tokens),
                     by_id[r.request_id].finish_reason) for r in reqs]
        out.append((got, eng))
    (got_j, eng_j), (got_t, eng_t) = out
    assert got_t == got_j
    for key in ("prefill_tokens", "prefix_cached_tokens", "decode_tokens",
                "rejected"):
        assert getattr(eng_t.stats, key) == getattr(eng_j.stats, key), key
    return got_t, eng_t


def test_windowed_engine_matches_jax(params):
    """tests/test_window_serving.py:67 -- monolithic windowed prefill,
    decode_chunk 4, generation across the window boundary; the
    transcript is also the port's own windowed generate."""
    (prompt,) = _prompts(1, (90,))
    got, _ = _serve_both(params, [[dict(prompt=prompt,
                                        max_new_tokens=20)]],
                         max_batch=2, decode_chunk=4)
    want = generate(params[1], torch.tensor([prompt]), TCFG,
                    max_new_tokens=20)
    assert list(got[0][0]) == want[0].tolist()


def test_windowed_chunked_prefill_matches_jax(params):
    """:99 -- the rolling-buffer chunked prefill, prompts deeper than the
    window and two lengths (batched rows at different offsets)."""
    specs = [dict(prompt=p, max_new_tokens=8) for p in _prompts(2, (150, 41))]
    _serve_both(params, [specs], prefill_chunk=32)


def test_windowed_prefix_cache_seeds_prefill_matches_jax(params):
    """:125 -- a repeated long prompt's second serve seeds the rolling
    buffer from cached pages (prefix_cached_tokens > 0)."""
    (prompt,) = _prompts(3, (150,))
    spec = dict(prompt=prompt, max_new_tokens=6)
    _, eng = _serve_both(params, [[spec], [spec]], max_batch=2,
                         prefill_chunk=32, prefix_cache=True)
    assert eng.stats.prefix_cached_tokens == PAGE


def test_windowed_eviction_bounds_pages_matches_jax(params):
    """:146 -- a 200-token prompt generating 80 holds O(window) pages
    (polled after every step), all pages return, and the transcript
    equals JAX's."""
    (prompt,) = _prompts(4, (200,))
    peak = []

    def poll(eng):
        for s in eng.slots:
            if s is not None:
                peak.append(eng.cache.pages_for(
                    max(eng.cache.length(s.seq_id), 1))
                    - eng.cache.allocator.base(s.seq_id))

    _, eng = _serve_both(params, [[dict(prompt=prompt, max_new_tokens=80)]],
                         poll=poll, max_batch=1, prefill_chunk=32)
    assert eng.cache.free_pages == eng.cache.num_pages - 1
    bound = eng.cache.pages_for(WINDOW + PAGE + eng.cache.tail_size)
    assert peak and max(peak) <= bound


def test_windowed_hbm_budget_matches_jax(params):
    """:186 -- a budget of one task's rolling buffers keeps at most one
    windowed prefill in flight; transcripts equal JAX's."""
    specs = [dict(prompt=p, max_new_tokens=8)
             for p in _prompts(5, (150, 150, 150))]
    inflight = []

    def poll(eng):
        inflight.append(sum(1 for p in eng.prefilling if p.windowed))

    _, eng = _serve_both(params, [specs], poll=poll, prefill_chunk=32,
                         prefill_hbm_budget=1)
    assert eng._wbuf_task_bytes > 1 and max(inflight) <= 1


def test_windowed_engine_guards(params):
    _, tp = params
    with pytest.raises(ValueError, match="tail_size"):
        teng.Engine(tp, TCFG, num_pages=16, page_size=PAGE, tail_size=128,
                    device="cpu")
    nowin = dataclasses.replace(TCFG, window=None)
    for kw in (dict(prefill_hbm_budget=1 << 20),
               dict(prefill_hbm_budget=1 << 20, prefill_chunk=32)):
        with pytest.raises(ValueError, match="prefill_hbm_budget"):
            teng.Engine(tp, nowin, num_pages=16, page_size=PAGE,
                        device="cpu", **kw)
    with pytest.raises(ValueError, match="prefill_hbm_budget"):
        teng.Engine(tp, TCFG, num_pages=16, page_size=PAGE, tail_size=16,
                    prefill_hbm_budget=1 << 20, device="cpu")
