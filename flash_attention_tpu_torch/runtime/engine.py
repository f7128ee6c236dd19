"""Continuous-batching serving engine over the paged KV cache (port of
`flash_attention_tpu/runtime/engine.py`).

Design (as in the JAX engine):

  * A fixed-width slot array: `max_batch` decode slots, each holding one
    live sequence or a dead marker. One decode step advances every slot;
    dead slots carry length 0 and point their page tables at the
    reserved scratch page.
  * Monolithic prefill runs per admitted request, right-padded to a
    power-of-two bucket (>= 64) so the kernels see the same shapes as
    the JAX engine; only the real prompt's KV is paged in. The first
    token samples from the prefill logits. A request with n > 1
    prefills once and forks n - 1 branches that share its pages
    (copy-on-write at flush).
  * Chunked prefill (`prefill_chunk`): admitted prompts become
    _PrefillTasks that advance one chunk per engine step, interleaved
    with decode under a bounded decode-stall lease; queued tasks of one
    shape advance in one batched dispatch (models/llama.py
    `prefill_chunk_step`).
  * Prefix cache (`prefix_cache`): full prompt pages are registered by
    token chain hash at install and at finish; a prompt sharing a cached
    page-aligned prefix reuses those pages and prefills only the suffix
    through the chunked machinery.
  * Sliding-window models (`cfg.window`) run the same stack: chunked
    prefill keeps a fixed-width rolling KV buffer
    (`prefill_window_chunk_step`, O(window) reads; cached pages seed the
    buffer), decode passes per-sequence window starts to the paged
    kernel, and pages below every window are evicted after each flush,
    so a long sequence holds O(window) pages.
  * Admission reserves worst-case pages (prompt + max_new_tokens; under
    a window with the chunked stack, the windowed peak) for every live
    sequence and task, so a mid-flight extend can never fail; infeasible
    requests come back as "rejected" completions.
  * New tokens' KV goes to dense per-slot tails, flushed into pages in
    bulk before any tail would overflow. The page-table width of a
    decode step is bucketed to 8, 64 or max_pages.

  * Quantized KV (`kv_quant_dtype` int8 / fp8): pages hold codes with
    per-(page, 128-token block, channel) scales, the tails stay dense;
    prompts page in block-aligned, each tail flush requantizes the blocks
    it touches, and the decode step hands the scale pools to the paged
    kernel. `cache_dtype` sets the dense pool / tail dtype (default the
    model's); the CUDA decode kernel takes dense pools only in the
    model's dtype, so another dense one raises on the card.

  * Speculative decoding (`speculative_k`): each engine step feeds
    [next_token, k drafts] per slot through one decode_step_paged_multi
    (the paged kernel sees the k + 1 positions folded into each kv
    head's group) and accepts on the device by rejection sampling
    (models/sampling.py speculative_sample); greedy transcripts are
    unchanged. Drafts come from `draft_fn(history, k)` on the host (the
    n-gram prompt lookup by default) or from a small draft model
    (`draft_params` / `draft_cfg`) with its own contiguous per-slot
    cache, whose k + 1 greedy steps run on the device; with a draft
    model `speculative_rounds` R rounds of (draft, verify, accept) run
    back to back, tail positions and draft lengths advanced on the
    device. Either way a step reads back once. The step is eager (no
    CUDA graph).

  * Tensor-parallel serving (`mesh`): Megatron's layout
    (models/llama.py `serving_param_shardings`): each rank holds its
    shard of the weights (parallel/mesh.py `shard_params`) and the KV
    pools, tails, scale pools and prefill buffers of its n_kv_heads / tp
    heads, and every model dispatch runs with the mesh's "tp" group as
    `tp_axis` (one all-reduce a block, the logits all-gathered). The
    engine is SPMD where JAX's is one controller over sharded arrays:
    every rank of the group builds the Engine with the same arguments
    and serves the same requests. Host scheduling never reads device
    data, and every admission, page and budget decision is taken in
    global numbers, so the ranks take the single-device engine's
    decisions; the all-gathered logits are the same on every rank, and
    each rank samples them with its own generator, seeded alike. No
    token is broadcast: the engine issues no collective beyond the
    model's. dp replicas in the mesh compute the same thing, as
    shard_map replicates over the axes its specs do not name. Per-rank
    figures differ from JAX's global ones: `cache.hbm_bytes` and the
    KV byte counts are one rank's. Model drafts (`draft_params`) raise
    under a mesh. An MoE tree shards by the same function's expert
    layout (the router replicated, each rank a band of n_experts / tp
    experts; tp must divide n_experts): every route of the FFN computes
    the band and one all-reduce sums it. A quantized expert stack under a
    mesh raises ValueError, as in JAX (its `expand_param_shardings`
    cannot map a spec onto one).

MoE models serve through the same path as dense ones (models/llama.py
`_mlp_block`). The XLA warm-up helpers (precompile_*) have no
counterpart: PyTorch compiles nothing.
One departure from the JAX engine: an explicit `prefill_hbm_budget`
outside the windowed chunked configuration raises ValueError (the JAX
engine ignores it).
"""

from __future__ import annotations

import collections
import dataclasses
import inspect
import itertools
import time
from typing import Any

import numpy as np
import torch

from flash_attention_tpu_torch.config import cdiv, resolve_device
from flash_attention_tpu_torch.models.llama import (
    LlamaConfig,
    decode_step,
    decode_step_paged,
    decode_step_paged_multi,
    init_kv_cache,
    prefill_chunk_step,
    prefill_kv,
    prefill_window_chunk_step,
    serving_param_shardings,
)
from flash_attention_tpu_torch.models.quantized import expand_param_shardings
from flash_attention_tpu_torch.models.sampling import (
    apply_top_p,
    sample,
    speculative_sample,
)
from flash_attention_tpu_torch.ops.paged import DEFAULT_PAGE_SIZE
from flash_attention_tpu_torch.parallel.mesh import shard_params
from flash_attention_tpu_torch.runtime.kv_cache import LayeredPagedKVCache

_req_counter = itertools.count()


@dataclasses.dataclass
class Request:
    prompt: Any                       # [T] int array-like of token ids
    max_new_tokens: int = 32
    temperature: float = 0.0          # 0 = greedy
    top_p: float = 0.0                # nucleus mass (0/1 = off)
    eos_id: int | None = None
    n: int = 1                        # parallel completions (one prefill)
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_req_counter))
    submit_ts: float | None = None    # set by Engine.submit (TTFT clock)


@dataclasses.dataclass
class Completion:
    request_id: int
    prompt_len: int
    tokens: list                      # generated token ids
    finish_reason: str                # "stop" | "length" | "rejected"
    error: str | None = None          # reason text when rejected
    branch: int = 0                   # which of the request's n samples
    ttft_s: float | None = None       # submit -> first token


@dataclasses.dataclass
class _Slot:
    request: Request
    seq_id: int
    prompt_len: int
    length: int                       # tokens whose KV is in the cache
    tail: int                         # of which, in the hot-tail buffer
    next_token: int                   # fed into the next decode step
    generated: list
    worst_pages: int                  # admission reservation
    branch: int = 0
    ttft_s: float | None = None


@dataclasses.dataclass
class _PrefillTask:
    """In-flight chunked prefill: the prompt advances `chunk` tokens per
    engine step while live decode slots keep decoding between chunks."""
    request: Request
    prompt: Any                       # np.int32 [T]
    bucket: int                       # KV-buffer length
    chunk: int                        # tokens per dispatch
    done: int                         # tokens processed so far
    k_bufs: Any                       # [L, 1, Hkv, bucket, D]
    v_bufs: Any
    logits: Any                       # last chunk's logits [1, vocab]
    need_pages: int                   # admission reservation (all forks)
    worst: int                        # branch-0 reservation
    branch_worst: int
    prefix_pages: tuple = ()          # cached pages reused (prefix cache)
    windowed: bool = False            # k/v_bufs are a rolling window
                                      # buffer (prefill_window_chunk_step):
                                      # its content shifts by `chunk` per
                                      # dispatch (padded_done tracks that)
    padded_done: int = 0
    first_token: int | None = None    # sampled with its finishing group


@dataclasses.dataclass
class EngineStats:
    prefill_tokens: int = 0
    prefix_cached_tokens: int = 0     # prompt tokens served from cache
    decode_tokens: int = 0
    spec_proposed: int = 0            # draft tokens offered
    spec_accepted: int = 0            # draft tokens confirmed
    decode_steps: int = 0             # decode_step_paged(_multi) calls
    prefill_chunks: int = 0           # chunked-prefill dispatches
    engine_steps: int = 0
    rejected: int = 0
    peak_pages: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0             # incl. draft steps and the verify
    admit_s: float = 0.0              # _try_admit (incl. prefix probes)
    flush_s: float = 0.0              # tail flush + window eviction
    book_s: float = 0.0               # host-side batch assembly
    ttft_s: list = dataclasses.field(default_factory=list)

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_tokens / self.decode_s if self.decode_s else 0.0

    def ttft_percentiles(self) -> dict:
        if not self.ttft_s:
            return {}
        v = np.sort(np.asarray(self.ttft_s))
        pick = lambda p: float(v[min(len(v) - 1, int(p * len(v)))])  # noqa: E731
        return {"p50": pick(0.50), "p90": pick(0.90), "p99": pick(0.99)}


def propose_ngram_draft(history, k: int, ngram: int = 2):
    """Prompt-lookup draft: find the most recent earlier occurrence of the
    history's trailing `ngram` and propose the k tokens that followed it
    (padded with the continuation's last token when it runs short). No
    match, or a history too short, proposes the last token repeated.
    Host numpy; the verify is the only authority, so a draft never
    changes a greedy transcript."""
    h = np.asarray(history, np.int32)
    n = len(h)
    if n == 0:
        return np.zeros(k, np.int32)
    if n >= ngram + 1:
        pat = h[-ngram:]
        w = np.lib.stride_tricks.sliding_window_view(h[:-1], ngram)
        starts = np.nonzero((w == pat).all(axis=1))[0]
        if len(starts):
            st = int(starts[-1])
            cont = h[st + ngram: st + ngram + k]
            out = np.empty(k, np.int32)
            out[: len(cont)] = cont
            out[len(cont):] = cont[-1]
            return out
    return np.full(k, h[-1], np.int32)


def _bucket(n: int, lo: int = 64) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Engine:
    """Continuous-batching engine for a Llama-class model."""

    def __init__(self, params, cfg: LlamaConfig, *, max_batch: int = 8,
                 num_pages: int = 128, page_size: int = DEFAULT_PAGE_SIZE,
                 max_seq_len: int | None = None, cache_dtype=None,
                 tail_size: int | None = None, kv_quant_dtype=None,
                 decode_chunk: int = 1, prefill_chunk: int | None = None,
                 prefix_cache: bool = False, speculative_k: int = 0,
                 speculative_rounds: int = 1, max_decode_stall: int = 4,
                 draft_fn=None, draft_params=None, draft_cfg=None,
                 draft_max_seq=None, prefill_hbm_budget: int | None = None,
                 mesh=None, seed: int = 0, device="cuda"):
        self.device = resolve_device(device)
        cache_dtype = cache_dtype or cfg.dtype
        if (self.device.type == "cuda" and kv_quant_dtype is None
                and cache_dtype != cfg.dtype):
            raise ValueError(
                f"cache_dtype={cache_dtype}: the paged decode kernel (B4) "
                f"takes dense pools only in the model's dtype {cfg.dtype}")
        self.params = params
        self.cfg = cfg
        self._init_mesh(mesh, draft_params)
        self.max_batch = max_batch
        if max_seq_len is None:
            max_seq_len = num_pages * page_size
        self.max_seq_len = max_seq_len
        self.max_pages = cdiv(max_seq_len, page_size)
        self.cache = LayeredPagedKVCache(
            n_layers=cfg.n_layers, kv_heads=self._kv_heads,
            head_dim=cfg.head_dim, num_pages=num_pages,
            page_size=page_size, max_seqs=max_batch, tail_size=tail_size,
            dtype=cache_dtype, quant_dtype=kv_quant_dtype,
            device=self.device)
        self.slots: list[_Slot | None] = [None] * max_batch
        self.pending: collections.deque[Request] = collections.deque()
        self.prefilling: collections.deque[_PrefillTask] = \
            collections.deque()
        self.stats = EngineStats()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        # Decode-stall lease (see step()): consecutive prefill-only steps
        # allowed while live decode slots wait.
        self.max_decode_stall = max(0, int(max_decode_stall))
        self._decode_stalled = 0
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.prefill_chunk = prefill_chunk
        self.prefix_cache = prefix_cache
        # Prefix buffers are gathered in whole pages into power-of-two
        # buckets: a non-power-of-two page could leave them short.
        if prefix_cache and (page_size & (page_size - 1)):
            raise ValueError(
                f"prefix_cache requires a power-of-two page_size "
                f"(got {page_size})")
        self.decode_chunk = max(1, decode_chunk)
        if self.decode_chunk >= self.cache.tail_size:
            raise ValueError("decode_chunk must be < tail_size")

        # Sliding-window models: chunked prefill (and the prefix cache)
        # use a rolling buffer of the window, rounded out for the
        # page-aligned eviction base (stored KV at install may reach
        # window + page_size - 1) and the final chunk's padding shift.
        self._wbuf = None
        if cfg.window is not None:
            if cfg.window <= self.cache.tail_size:
                raise ValueError(
                    f"window={cfg.window} must exceed tail_size "
                    f"({self.cache.tail_size})")
            if prefill_chunk is not None or prefix_cache:
                c = 1 << ((prefill_chunk or cfg.window).bit_length() - 1)
                self._wchunk = min(c, cfg.window)
                self._wbuf = (cdiv(cfg.window, page_size) * page_size
                              + page_size + self._wchunk)
                # Each in-flight windowed task holds two [L, 1, Hkv,
                # wbuf, D] buffers until it installs; admission budgets
                # their bytes (default 4 GiB; at least one task always
                # admits). Global heads under a mesh: every rank takes
                # the single-device engine's admission decisions.
                itemsize = torch.empty((), dtype=cfg.dtype).element_size()
                self._wbuf_task_bytes = (
                    2 * cfg.n_layers * cfg.n_kv_heads * self._wbuf
                    * cfg.head_dim * itemsize)
                if prefill_hbm_budget is None:
                    prefill_hbm_budget = 4 << 30
            peak = self.cache.pages_for(
                cfg.window + page_size + self.cache.tail_size)
            if peak > self.max_pages:
                raise ValueError(
                    f"max_seq_len {max_seq_len} gives a {self.max_pages}"
                    f"-page table, smaller than the windowed live peak "
                    f"({peak} pages); raise max_seq_len/num_pages")
        if prefill_hbm_budget is not None and self._wbuf is None:
            raise ValueError(
                "prefill_hbm_budget bounds the rolling buffers of windowed "
                "chunked prefill; it needs cfg.window and prefill_chunk "
                "or prefix_cache")
        self._prefill_hbm_budget = prefill_hbm_budget
        self._init_speculative(speculative_k, speculative_rounds, draft_fn,
                               draft_params, draft_cfg, draft_max_seq)

    def _init_mesh(self, mesh, draft_params) -> None:
        """Tensor-parallel state: the "tp" group (`_tp`, None without a
        mesh), this rank's shard of the params and its kv-head count
        (JAX `runtime/engine.py:469-481`). Raises where the JAX engine
        does: tp not dividing n_kv_heads or n_experts (through
        serving_param_shardings), quantized expert stacks (through
        expand_param_shardings), model drafts."""
        self._tp = None
        self._kv_heads = self.cfg.n_kv_heads
        if mesh is None:
            return
        if draft_params is not None:
            raise NotImplementedError(
                "model-based drafts under TP serving: run the draft "
                "replicated outside the mesh (future work)")
        tp = mesh["tp"].size()
        specs = expand_param_shardings(
            self.params, serving_param_shardings(self.cfg, tp))
        self.params = shard_params(self.params, specs, mesh,
                                   device=self.device)
        self._tp = mesh.get_group("tp")
        self._kv_heads = self.cfg.n_kv_heads // tp

    def _init_speculative(self, speculative_k, speculative_rounds, draft_fn,
                          draft_params, draft_cfg, draft_max_seq) -> None:
        """Speculative decoding's options, their guards (as the JAX
        engine's) and the draft model's state: a contiguous cache of
        draft_max_seq (default min(max_seq_len, 8192)) positions per slot
        and, on the host, each slot's draft length. Between steps rows
        [0, _draft_len[b]) hold the draft K/V of every transcript token
        but the pending next token; a step that accepts a drafts
        advances it by a + 1 (rejected rows above are rewritten by the
        next draft scan before they are read)."""
        self.speculative_k = max(0, int(speculative_k))
        self.speculative_rounds = max(1, int(speculative_rounds))
        self.draft_fn = draft_fn or propose_ngram_draft
        # draft_fn(history, k, request_id=...) is the richer protocol.
        try:
            self._draft_takes_id = "request_id" in \
                inspect.signature(self.draft_fn).parameters
        except (TypeError, ValueError):
            self._draft_takes_id = False
        if self.speculative_k:
            if self.decode_chunk > 1:
                raise ValueError(
                    "speculative_k and decode_chunk>1 are mutually "
                    "exclusive decode strategies (speculative_rounds "
                    "is the stacking mechanism)")
            span = (self.speculative_k + 1) * self.speculative_rounds
            if span >= self.cache.tail_size:
                raise ValueError(
                    f"(speculative_k + 1) * speculative_rounds ({span}) "
                    f"must be < tail_size ({self.cache.tail_size})")
        if self.speculative_rounds > 1 and draft_params is None:
            raise ValueError(
                "speculative_rounds > 1 requires a draft model "
                "(draft_params/draft_cfg): a host draft_fn cannot run "
                "between the rounds of one step")
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        if draft_params is None:
            return
        if not self.speculative_k:
            raise ValueError("draft_params requires speculative_k")
        if draft_cfg is None:
            raise ValueError("draft_params requires draft_cfg")
        self._draft_S = int(draft_max_seq or min(self.max_seq_len, 8192))
        self._draft_caches = init_kv_cache(draft_cfg, self.max_batch,
                                           self._draft_S, device=self.device)
        self._draft_len = np.zeros(self.max_batch, np.int32)

    # --- scheduling -------------------------------------------------------

    def submit(self, request: Request) -> int:
        if request.submit_ts is None:
            request.submit_ts = time.perf_counter()
        self.pending.append(request)
        return request.request_id

    def probe_prefix(self, prompt) -> int:
        """How many prompt tokens the prefix cache would serve for this
        prompt right now (pages are matched, then released at once)."""
        if not self.prefix_cache:
            return 0
        pages, _ = self.cache.match_prefix(np.asarray(prompt, np.int32))
        if pages:
            self.cache.release_pages(pages)
        return len(pages) * self.cache.page_size

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _reserved_pages(self) -> int:
        """Pages still owed to live sequences under worst-case growth:
        each slot's growth budget (forked branches exclude the shared
        prompt pages) minus the growth it has already materialized.
        In-flight chunked prefills hold their full reservation;
        sliding-window slots account live pages (eviction bounds them
        at worst_pages)."""
        owed = sum(t.need_pages for t in self.prefilling)
        for s in self.slots:
            if s is None:
                continue
            if self.cfg.window is not None:
                live = (self.cache.pages_for(
                    max(self.cache.length(s.seq_id), 1))
                    - self.cache.allocator.base(s.seq_id))
                owed += max(0, s.worst_pages - live)
                continue
            grown = (self.cache.pages_for(
                max(self.cache.length(s.seq_id), 1))
                - self.cache.pages_for(max(s.prompt_len, 1)))
            budget = s.worst_pages - (
                self.cache.pages_for(max(s.prompt_len, 1))
                if s.branch == 0 else 0)
            owed += max(0, budget - grown)
        return owed

    def _promised_slots(self) -> int:
        """Decode slots owed to in-flight chunked prefills."""
        return sum(max(1, t.request.n) for t in self.prefilling)

    def _zero_bufs(self, length: int):
        shape = (self.cfg.n_layers, 1, self._kv_heads, length,
                 self.cfg.head_dim)
        return (torch.zeros(shape, dtype=self.cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=self.cfg.dtype, device=self.device))

    def _try_admit(self) -> list[Completion]:
        """FIFO admission into free slots, reserving worst-case pages.
        A request with n > 1 prefills ONCE and forks n - 1 times."""
        done = []
        total_usable = self.cache.num_pages - 1   # scratch page reserved
        ps = self.cache.page_size
        win = self.cfg.window
        windowed_stack = win is not None and self._wbuf is not None
        while self.pending:
            req = self.pending[0]
            n = max(1, req.n)
            prompt = np.asarray(req.prompt, np.int32)
            t = len(prompt)
            if windowed_stack:
                # The windowed install pages in ~window tokens and
                # eviction bounds live pages, so the context length
                # drops out of feasibility (O(window) admission).
                peak = min(t + req.max_new_tokens,
                           win + ps + self.cache.tail_size)
                worst = self.cache.pages_for(peak)
                branch_worst = worst + 1
                too_long = False
            else:
                worst = self.cache.pages_for(t + req.max_new_tokens)
                branch_worst = (worst - self.cache.pages_for(max(t, 1))) + 1
                too_long = t + req.max_new_tokens > self.max_seq_len
            need = worst + (n - 1) * branch_worst
            if too_long or n > self.max_batch or need > total_usable:
                self.pending.popleft()
                reason = (
                    f"infeasible for this engine: prompt {t} + max_new "
                    f"{req.max_new_tokens} (max_seq_len "
                    f"{self.max_seq_len}), n={n} (max_batch "
                    f"{self.max_batch}), worst-case pages {need} "
                    f"(usable {total_usable})")
                self.stats.rejected += 1
                done.append(Completion(
                    request_id=req.request_id, prompt_len=t, tokens=[],
                    finish_reason="rejected", error=reason))
                continue
            # Prefix-cache probe (pages acquired; released on any
            # admission failure below). Feasibility above ignored the
            # discount: a request must fit a cold cache.
            cached = []
            if self.prefix_cache:
                cached, _ = self.cache.match_prefix(prompt)
                if windowed_stack:
                    # Cached pages only seed the rolling buffer: cap them
                    # at its page capacity.
                    mcap = min(len(cached), self._wbuf // ps)
                    if mcap < len(cached):
                        self.cache.release_pages(cached[mcap:])
                        cached = cached[:mcap]
            m = len(cached)
            if not windowed_stack:
                need -= m
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            wbuf_over = False
            if (windowed_stack and self._prefill_hbm_budget is not None
                    and (self.prefill_chunk is not None or m)):
                inflight = sum(1 for p in self.prefilling if p.windowed)
                wbuf_over = (inflight > 0 and
                             (inflight + 1) * self._wbuf_task_bytes
                             > self._prefill_hbm_budget)
            if (len(free_slots) - self._promised_slots() < n
                    or self.cache.free_pages - self._reserved_pages()
                    < need or wbuf_over):
                if cached:
                    self.cache.release_pages(cached)
                break                       # wait for slots/pages/memory
            self.pending.popleft()
            task = dict(request=req, prompt=prompt, done=m * ps,
                        logits=None, need_pages=need, worst=worst,
                        branch_worst=branch_worst,
                        prefix_pages=tuple(cached))
            if windowed_stack and (self.prefill_chunk is not None or m):
                wb = self._wbuf
                if m:
                    kg, vg = self.cache.gather_pages(cached, m * ps)
                    kz, vz = self._zero_bufs(wb - m * ps)
                    kb, vb = torch.cat([kz, kg], 3), torch.cat([vz, vg], 3)
                    self.stats.prefix_cached_tokens += m * ps
                else:
                    kb, vb = self._zero_bufs(wb)
                self.prefilling.append(_PrefillTask(
                    bucket=wb, chunk=self._wchunk, k_bufs=kb, v_bufs=vb,
                    windowed=True, padded_done=m * ps, **task))
                continue
            if self.prefill_chunk is not None or m:
                tb = _bucket(t)
                if m:
                    kb, vb = self.cache.gather_pages(cached, tb)
                    self.stats.prefix_cached_tokens += m * ps
                else:
                    kb, vb = self._zero_bufs(tb)
                # A power-of-two chunk dividing the suffix span keeps
                # every chunk's rows inside the bucket.
                span = tb - m * ps
                chunk = min(self.prefill_chunk or span, span)
                chunk = 1 << (chunk.bit_length() - 1)
                while span % chunk:
                    chunk //= 2
                self.prefilling.append(_PrefillTask(
                    bucket=tb, chunk=chunk, k_bufs=kb, v_bufs=vb, **task))
                continue

            tb = _bucket(t)
            padded = np.zeros((1, tb), np.int32)
            padded[0, :t] = prompt
            t0 = time.perf_counter()
            logits, ks, vs = prefill_kv(
                self.params, torch.from_numpy(padded).to(self.device),
                self.cfg, true_len=t, tp_axis=self._tp)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats.prefill_s += time.perf_counter() - t0
            done.extend(self._install_sequences(
                req, logits, ks[:, 0, :, :t], vs[:, 0, :, :t], t, worst,
                branch_worst, prompt=prompt))
        return done

    def _install_sequences(self, req, logits, ks, vs, t, worst,
                           branch_worst, prefix_pages=(), prompt=None,
                           base_tokens=0, first_token=None
                           ) -> list[Completion]:
        """Prompt KV is ready: page it in (only the suffix past any
        cached prefix pages), register its full pages with the prefix
        cache, fork n - 1 branches, fill decode slots, sample and
        timestamp the first token. `base_tokens` admits a sliding-window
        sequence whose below-window front is already evicted (ks/vs then
        hold positions [base_tokens, t))."""
        done = []
        n = max(1, req.n)
        ps = self.cache.page_size
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if prefix_pages:
            start = len(prefix_pages) * ps
            sid = self.cache.add_sequence_prefixed(
                prefix_pages, ks[:, :, start:], vs[:, :, start:], t)
        else:
            sid = self.cache.add_sequence(ks, vs, base_tokens=base_tokens)
        if self.prefix_cache and prompt is not None and not base_tokens:
            self.cache.register_prefix(sid, np.asarray(prompt)[:t])
        sids = [sid] + [self.cache.fork_sequence(sid) for _ in range(n - 1)]
        self.stats.prefill_tokens += t - len(prefix_pages) * ps
        ttft = (time.perf_counter() - req.submit_ts
                if req.submit_ts is not None else None)
        if ttft is not None:
            self.stats.ttft_s.append(ttft)
        installed = []
        for branch, (slot_idx, bsid) in enumerate(zip(free_slots, sids)):
            if branch == 0 and first_token is not None:
                first = first_token
            else:
                first = int(sample(logits[:1], self._gen,
                                   temperature=req.temperature,
                                   top_p=req.top_p)[0])
            slot = _Slot(request=req, seq_id=bsid, prompt_len=t, length=t,
                         tail=0, next_token=first, generated=[first],
                         branch=branch,
                         worst_pages=worst if branch == 0 else branch_worst,
                         ttft_s=ttft)
            fin = self._maybe_finish(slot)
            if fin is not None:
                done.append(fin)
            else:
                self.slots[slot_idx] = slot
                installed.append(slot_idx)
        if self.draft_params is not None:
            self._draft_install_prompt(prompt, t, installed)
        return done

    def _draft_install_prompt(self, prompt, t, slot_idxs) -> None:
        """Prefill the draft model's cache for freshly installed slots (one
        prefill_kv; forks copy its K/V into every slot). A prompt beyond
        the draft cache leaves the slot cold (_draft_len 0): its drafts
        are then garbage and rarely accepted, its transcript unchanged."""
        k = self.speculative_k
        if prompt is None or t > self._draft_S - (k + 2):
            for i in slot_idxs:
                self._draft_len[i] = 0
            return
        if not slot_idxs:
            return
        tb = min(_bucket(t), self._draft_S)
        padded = np.zeros((1, tb), np.int32)
        padded[0, :t] = np.asarray(prompt, np.int32)[:t]
        _, ks, vs = prefill_kv(self.draft_params,
                               torch.from_numpy(padded).to(self.device),
                               self.draft_cfg, true_len=t)
        for i in slot_idxs:
            # Rows past t are pad garbage, hidden by _draft_len until the
            # draft scan rewrites them in order.
            for (ck, cv), k_l, v_l in zip(self._draft_caches, ks, vs):
                ck[i, :, :tb] = k_l[0].to(ck.dtype)
                cv[i, :, :tb] = v_l[0].to(cv.dtype)
            self._draft_len[i] = t

    def _step_prefill(self) -> list[Completion]:
        """Advance chunked prefill by up to `prefill_chunk` real tokens of
        dispatch this engine step; sequences whose final chunk lands
        install into decode slots at once. Queued tasks sharing a
        (windowed, bucket, chunk) shape advance as ONE batched dispatch
        (the largest power-of-two FIFO group, each row at its own prefix
        offset): a dispatch reads every weight once whatever its rows."""
        done = []
        # With chunked prefill off, tasks exist only through the prefix
        # cache (one dispatch each, chunk = suffix span): drain them all.
        budget = self.prefill_chunk or float("inf")
        while self.prefilling and budget > 0:
            head = self.prefilling[0]
            key = (head.windowed, head.bucket, head.chunk)
            group = [t for t in self.prefilling
                     if (t.windowed, t.bucket, t.chunk) == key]
            g = 1 << (len(group).bit_length() - 1)
            group = group[:g]
            c = head.chunk
            chunk = np.zeros((g, c), np.int32)
            starts = np.zeros(g, np.int32)
            reals = np.zeros(g, np.int32)
            for i, task in enumerate(group):
                starts[i] = task.done
                reals[i] = min(c, len(task.prompt) - task.done)
                chunk[i, :reals[i]] = task.prompt[
                    task.done:task.done + reals[i]]
            if g == 1:
                kb, vb = head.k_bufs, head.v_bufs
            else:
                kb = torch.cat([t.k_bufs for t in group], dim=1)
                vb = torch.cat([t.v_bufs for t in group], dim=1)
            fn = (prefill_window_chunk_step if head.windowed
                  else prefill_chunk_step)
            t0 = time.perf_counter()
            # No per-chunk sync: chunk dispatches queue on the device;
            # the first-token sample at install waits for them.
            logits, kb, vb = fn(
                self.params, torch.from_numpy(chunk).to(self.device),
                self.cfg, kb, vb, torch.from_numpy(starts).to(self.device),
                torch.from_numpy(reals).to(self.device), tp_axis=self._tp)
            self.stats.prefill_s += time.perf_counter() - t0
            self.stats.prefill_chunks += 1
            budget -= int(reals.max())
            fin = []
            for i, task in enumerate(group):
                task.logits = logits[i:i + 1]
                task.k_bufs = kb if g == 1 else kb[:, i:i + 1]
                task.v_bufs = vb if g == 1 else vb[:, i:i + 1]
                task.done = int(starts[i] + reals[i])
                task.padded_done = int(starts[i]) + c
                if task.done >= len(task.prompt):
                    self.prefilling.remove(task)
                    fin.append(task)
            single = [t_ for t_ in fin if max(1, t_.request.n) == 1]
            if len(single) > 1:
                # One batched first-token sample and one readback for the
                # whole finishing group.
                temps = np.array([t_.request.temperature for t_ in single],
                                 np.float32)
                tps = np.array([t_.request.top_p for t_ in single],
                               np.float32)
                toks = self._sample_batch(
                    torch.cat([t_.logits for t_ in single]), temps,
                    tps).tolist()
                for t_, tok in zip(single, toks):
                    t_.first_token = int(tok)
            for task in fin:
                if task.windowed:
                    done.extend(self._install_windowed(task))
                    continue
                t = len(task.prompt)
                done.extend(self._install_sequences(
                    task.request, task.logits, task.k_bufs[:, 0, :, :t],
                    task.v_bufs[:, 0, :, :t], t, task.worst,
                    task.branch_worst, prefix_pages=task.prefix_pages,
                    prompt=task.prompt, first_token=task.first_token))
        return done

    def _install_windowed(self, task: _PrefillTask) -> list[Completion]:
        """Windowed-prefill install: page in only positions >= the
        page-aligned eviction base (older ones can never be attended
        again) and admit the sequence with that base. Cached seed pages
        were compute-only; release them."""
        t = len(task.prompt)
        ps = self.cache.page_size
        base = max(0, ((t - self.cfg.window) // ps) * ps)
        # Buffer column of absolute position p: p - padded_done + bucket.
        off = task.bucket - task.padded_done
        ks = task.k_bufs[:, 0, :, base + off: t + off]
        vs = task.v_bufs[:, 0, :, base + off: t + off]
        if task.prefix_pages:
            self.cache.release_pages(task.prefix_pages)
        out = self._install_sequences(
            task.request, task.logits, ks, vs, t, task.worst,
            task.branch_worst, prompt=task.prompt, base_tokens=base,
            first_token=task.first_token)
        # Cached seed tokens were never prefilled.
        self.stats.prefill_tokens -= min(len(task.prefix_pages) * ps, t)
        return out

    def _maybe_finish(self, slot: _Slot,
                      slot_idx: int | None = None) -> Completion | None:
        req = slot.request
        last = slot.generated[-1]
        if req.eos_id is not None and last == req.eos_id:
            reason = "stop"
        elif len(slot.generated) >= req.max_new_tokens:
            reason = "length"
        else:
            return None
        if self.prefix_cache:
            # Register the full pages of prompt + fed generated tokens
            # (the last sampled token never was fed), so a multi-turn
            # prompt extending this transcript hits. Unflushed tail
            # tokens that complete a new page are flushed first.
            fed = np.concatenate([
                np.asarray(req.prompt, np.int32),
                np.asarray(slot.generated[:-1], np.int32)])
            paged = max(self.cache.length(slot.seq_id), 0)
            ps = self.cache.page_size
            if (slot_idx is not None and slot.tail
                    and (paged + slot.tail) // ps > paged // ps):
                counts = [0] * self.max_batch
                counts[slot_idx] = slot.tail
                self.cache.flush_tails(
                    [s.seq_id if s else -1 for s in self.slots], counts)
                slot.tail = 0
                paged = max(self.cache.length(slot.seq_id), 0)
            n_full = min(len(fed), paged) // ps
            if n_full:
                self.cache.register_prefix(slot.seq_id, fed[:n_full * ps])
        self.cache.free_sequence(slot.seq_id)
        return Completion(
            request_id=req.request_id, prompt_len=slot.prompt_len,
            tokens=list(slot.generated), finish_reason=reason,
            branch=slot.branch, ttft_s=slot.ttft_s)

    # --- sampling ---------------------------------------------------------

    def _sample_batch(self, logits, temps: np.ndarray,
                      top_ps: np.ndarray) -> torch.Tensor:
        """Per-slot temperature + nucleus on the device: greedy where
        temp <= 0; all-greedy batches skip the sort and the draw."""
        greedy = torch.argmax(logits, dim=-1).to(torch.int32)
        if (temps <= 0.0).all():
            return greedy
        t = torch.from_numpy(np.maximum(temps, 1e-6)).to(self.device)
        scaled = apply_top_p(logits.float() / t[:, None],
                             torch.from_numpy(top_ps).to(self.device))
        probs = torch.softmax(scaled, dim=-1)
        cat = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        is_greedy = torch.from_numpy(temps <= 0.0).to(self.device)
        return torch.where(is_greedy, greedy, cat.to(torch.int32))

    # --- engine step ------------------------------------------------------

    def step(self) -> list[Completion]:
        """One engine iteration: admit, advance chunked prefill, then
        `decode_chunk` decode steps (sampled tokens feed the next step on
        the device; one host sync per chunk) or, with speculative_k, one
        speculative step (_step_speculative), collect finished
        sequences."""
        t_step = time.perf_counter()
        done = self._try_admit()
        self.stats.admit_s += time.perf_counter() - t_step
        used = self.cache.num_pages - self.cache.free_pages
        self.stats.peak_pages = max(self.stats.peak_pages, used)
        done.extend(self._step_prefill())
        live = [i for i, s in enumerate(self.slots) if s is not None]
        self.stats.engine_steps += 1
        # Prefill-priority batching under a bounded decode stall: while
        # prompts are mid-prefill and the batch is not nearly full,
        # prefer prefilling -- but after `max_decode_stall` consecutive
        # prefill-only steps a decode step runs regardless.
        near_full = self.max_batch - max(1, self.max_batch // 8)
        if (self.prefilling and len(live) < near_full
                and self._decode_stalled < self.max_decode_stall):
            self._decode_stalled += 1
            return done
        self._decode_stalled = 0
        if not live:
            return done

        chunk = self.decode_chunk
        step_tokens = ((self.speculative_k + 1) * self.speculative_rounds
                       if self.speculative_k else chunk)
        t_flush = time.perf_counter()
        # Flush BEFORE the step if any live tail could overflow.
        if any(self.slots[i].tail + step_tokens > self.cache.tail_size
               for i in live):
            self.cache.flush_tails(
                [s.seq_id if s else -1 for s in self.slots],
                [s.tail if s else 0 for s in self.slots])
            for s in self.slots:
                if s is not None:
                    s.tail = 0
            if self.cfg.window is not None:
                # Pages entirely below the next query's window start
                # can never be read again.
                for i in live:
                    sid = self.slots[i].seq_id
                    self.cache.evict_below(
                        sid, self.cache.length(sid) + 1 - self.cfg.window)
        self.stats.flush_s += time.perf_counter() - t_flush

        t_book = time.perf_counter()
        tokens = np.zeros(self.max_batch, np.int32)
        tail_pos = np.zeros(self.max_batch, np.int32)
        temps = np.zeros(self.max_batch, np.float32)
        top_ps = np.zeros(self.max_batch, np.float32)
        for i in live:
            tokens[i] = self.slots[i].next_token
            tail_pos[i] = self.slots[i].tail
            temps[i] = self.slots[i].request.temperature
            top_ps[i] = self.slots[i].request.top_p
        slot_sids = [s.seq_id if s else -1 for s in self.slots]
        # Bucketed page-table width: the kernel reads only live pages,
        # the buckets keep the table shapes to a handful.
        need = self.cache.live_pages(slot_sids)
        width = self.max_pages
        for b_ in (8, 64):
            if need <= b_ <= self.max_pages:
                width = b_
                break
        tables, paged_lens = self.cache.batch_state(slot_sids, width)
        bases = self.cache.bases(slot_sids)
        self.stats.book_s += time.perf_counter() - t_book

        if self.speculative_k:
            return self._step_speculative(done, live, tail_pos, temps,
                                          top_ps, tables, paged_lens, bases)
        t0 = time.perf_counter()
        tok = torch.from_numpy(tokens).to(self.device)
        tpos = torch.from_numpy(tail_pos).to(self.device)
        out = []
        for i in range(chunk):
            logits, _, _ = decode_step_paged(
                self.params, tok, self.cfg, self.cache.k_pools,
                self.cache.v_pools, self.cache.k_tails,
                self.cache.v_tails, tables, paged_lens, tpos + i,
                k_scales=self.cache.k_scale_pools,
                v_scales=self.cache.v_scale_pools, paged_bases=bases,
                tp_axis=self._tp)
            self.stats.decode_steps += 1
            tok = self._sample_batch(logits, temps, top_ps)
            out.append(tok)
        toks = torch.stack(out).cpu().numpy()         # [chunk, B], one sync
        self.stats.decode_s += time.perf_counter() - t0

        accepted = 0
        for i in live:
            s = self.slots[i]
            # All chunk tokens are in the cache (tail); accept into the
            # transcript until eos/max_new -- the rest is dead compute.
            s.length += toks.shape[0]
            s.tail += toks.shape[0]
            for step_row in toks:
                if s is None:
                    break
                tok_i = int(step_row[i])
                s.next_token = tok_i
                s.generated.append(tok_i)
                accepted += 1
                fin = self._maybe_finish(s, slot_idx=i)
                if fin is not None:
                    done.append(fin)
                    self.slots[i] = None
                    s = None
        self.stats.decode_tokens += accepted
        return done

    def _step_speculative(self, done, live, tail_pos, temps, top_ps,
                          tables, paged_lens, bases) -> list[Completion]:
        """One speculative engine step: the rounds run on the device
        (_spec_rounds), then one readback of every round's tokens and
        accept counts, then per round and slot the accepted tokens join
        the transcript (a slot that finishes ignores later rounds)."""
        k, rounds = self.speculative_k, self.speculative_rounds
        tokens = np.zeros((self.max_batch, k + 1), np.int32)
        for i in live:
            s = self.slots[i]
            tokens[i, 0] = s.next_token
            if self.draft_params is None:
                hist = np.concatenate([
                    np.asarray(s.request.prompt, np.int32),
                    np.asarray(s.generated, np.int32)])
                tokens[i, 1:] = (
                    self.draft_fn(hist, k, request_id=s.request.request_id)
                    if self._draft_takes_id else self.draft_fn(hist, k))
        t0 = time.perf_counter()
        dev = self.device
        all_greedy = bool((temps <= 0.0).all())
        res = self._spec_rounds(
            torch.from_numpy(tokens).to(dev),
            torch.from_numpy(tail_pos).to(dev),
            (torch.from_numpy(self._draft_len).to(dev)
             if self.draft_params is not None else None),
            tables, paged_lens, bases,
            None if all_greedy else torch.from_numpy(temps).to(dev),
            None if all_greedy else torch.from_numpy(top_ps).to(dev),
            all_greedy)
        res = res.cpu().numpy()                      # [R, B, k+2], one sync
        self.stats.decode_s += time.perf_counter() - t0
        out, acc = res[..., :k + 1], res[..., k + 1]

        accepted_total = 0
        for r in range(rounds):
            for i in live:
                s = self.slots[i]
                if s is None:
                    continue                        # finished at round < r
                a = int(acc[r, i])
                # K/V of positions 0..k went into the tail; 0..a are real.
                self.stats.spec_proposed += k
                self.stats.spec_accepted += a
                if self.draft_params is not None:
                    self._draft_len[i] = min(int(self._draft_len[i]) + a + 1,
                                             self._draft_S - 1)
                s.length += a + 1
                s.tail += a + 1
                for tok in out[r, i, :a + 1]:
                    s.next_token = int(tok)
                    s.generated.append(int(tok))
                    accepted_total += 1
                    fin = self._maybe_finish(s, slot_idx=i)
                    if fin is not None:
                        done.append(fin)
                        self.slots[i] = None
                        s = None
                        break
        self.stats.decode_tokens += accepted_total
        return done

    def _spec_rounds(self, tokens, tail_pos, draft_lens, tables, paged_lens,
                     bases, temps, top_ps, all_greedy) -> torch.Tensor:
        """speculative_rounds rounds of (draft scan with a draft model,)
        verify and accept, all on the device: a round's tail positions
        and draft lengths advance by its accept counts + 1 as tensors, so
        nothing here reads back or waits for the card. The verify writes
        K/V of all k + 1 positions into the tails in place; rejected rows
        stay stale behind tail_pos and the next round overwrites them.
        tokens [B, k+1] ([next_token, host drafts]; only column 0 is read
        with a draft model). Returns [R, B, k+2] int32: each round's
        emitted tokens, then its accept count."""
        cache = self.cache
        tok = tokens[:, 0]
        rows = []
        for r in range(self.speculative_rounds):
            if self.draft_params is not None:
                tokens = torch.cat(
                    [tok[:, None], self._draft_scan(tok, draft_lens)], dim=1)
            logits, _, _ = decode_step_paged_multi(
                self.params, tokens, self.cfg, cache.k_pools, cache.v_pools,
                cache.k_tails, cache.v_tails, tables, paged_lens, tail_pos,
                k_scales=cache.k_scale_pools, v_scales=cache.v_scale_pools,
                paged_bases=bases, tp_axis=self._tp)
            self.stats.decode_steps += 1
            out, acc = speculative_sample(logits, tokens, temps, top_ps,
                                          self._gen, all_greedy=all_greedy)
            rows.append(torch.cat([out, acc[:, None]], dim=1))
            if r + 1 < self.speculative_rounds:
                tok = out.gather(1, acc.long()[:, None])[:, 0]
                tail_pos = tail_pos + acc + 1
                if draft_lens is not None:
                    draft_lens = draft_lens + acc + 1
        return torch.stack(rows)

    def _draft_scan(self, tok, draft_lens) -> torch.Tensor:
        """k + 1 greedy draft-model steps on the contiguous draft cache
        (decode_step with plain attention, as the JAX engine drafts),
        lengths clamped so the k + 1 writes stay inside the cache. The
        last step only ingests the k-th draft, so an all-accepted round
        leaves no hole. Returns the k drafts [B, k] int32."""
        k = self.speculative_k
        lens = draft_lens.clamp(max=self._draft_S - (k + 2))
        drafts = []
        for _ in range(k + 1):
            logits, _, lens = decode_step(
                self.draft_params, tok, self.draft_cfg, self._draft_caches,
                lens, use_flash=False)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            drafts.append(tok)
        return torch.stack(drafts[:k], dim=1)

    def run(self, requests=None) -> list[Completion]:
        """Serve until every pending/submitted request completes."""
        for r in requests or []:
            self.submit(r)
        out = []
        while self.pending or self.prefilling or self.num_active:
            out.extend(self.step())
        return sorted(out, key=lambda c: (c.request_id, c.branch))
