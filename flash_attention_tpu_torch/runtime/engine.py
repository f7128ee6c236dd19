"""Continuous-batching serving engine over the paged KV cache (port of
`flash_attention_tpu/runtime/engine.py`, monolithic-prefill path).

Design (as in the JAX engine):

  * A fixed-width slot array: `max_batch` decode slots, each holding one
    live sequence or a dead marker. One decode step advances every slot;
    dead slots carry length 0 and point their page tables at the
    reserved scratch page.
  * Prefill runs per admitted request, right-padded to a power-of-two
    bucket (>= 64) so the kernels see the same shapes as the JAX engine;
    only the real prompt's KV is paged in. The first token samples from
    the prefill logits. A request with n > 1 prefills once and forks
    n - 1 branches that share its pages (copy-on-write at flush).
  * Admission reserves worst-case pages (prompt + max_new_tokens) for
    every live sequence, so a mid-flight extend can never fail;
    infeasible requests come back as "rejected" completions.
  * New tokens' KV goes to dense per-slot tails, flushed into pages in
    bulk before any tail would overflow. The page-table width of a
    decode step is bucketed to 8, 64 or max_pages.

Features of the JAX engine that later slices port raise
NotImplementedError here: chunked prefill, the prefix cache,
speculative decoding and draft models, tensor-parallel serving (mesh),
quantized KV pools and sliding-window models. MoE models serve through
the same path (models/llama.py `_mlp_block`). The XLA warm-up
helpers (precompile_*) have no counterpart: PyTorch compiles nothing.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Any

import numpy as np
import torch

from flash_attention_tpu_torch.config import cdiv, resolve_device
from flash_attention_tpu_torch.models.llama import (
    LlamaConfig,
    decode_step_paged,
    prefill_kv,
)
from flash_attention_tpu_torch.models.sampling import apply_top_p, sample
from flash_attention_tpu_torch.ops.paged import DEFAULT_PAGE_SIZE
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
class EngineStats:
    prefill_tokens: int = 0
    decode_tokens: int = 0
    decode_steps: int = 0             # decode_step_paged calls
    engine_steps: int = 0
    rejected: int = 0
    peak_pages: int = 0
    prefill_s: float = 0.0
    decode_s: float = 0.0
    flush_s: float = 0.0
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


def _bucket(n: int, lo: int = 64) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class Engine:
    """Continuous-batching engine for a Llama-class model."""

    def __init__(self, params, cfg: LlamaConfig, *, max_batch: int = 8,
                 num_pages: int = 128, page_size: int = DEFAULT_PAGE_SIZE,
                 max_seq_len: int | None = None,
                 tail_size: int | None = None, kv_quant_dtype=None,
                 decode_chunk: int = 1, prefill_chunk: int | None = None,
                 prefix_cache: bool = False, speculative_k: int = 0,
                 draft_fn=None, draft_params=None, draft_cfg=None,
                 mesh=None, seed: int = 0, device="cuda"):
        unported = [
            (prefill_chunk is not None, "prefill_chunk",
             "the chunked-prefill slice"),
            (prefix_cache, "prefix_cache", "the prefix-cache slice"),
            (speculative_k or draft_fn is not None
             or draft_params is not None or draft_cfg is not None,
             "speculative_k / draft_*", "the speculative-decoding slice"),
            (mesh is not None, "mesh", "the multi-device slice"),
            (kv_quant_dtype is not None, "kv_quant_dtype",
             "the quantized-KV slice"),
            (cfg.window is not None, "cfg.window", "the window slice"),
        ]
        for bad, what, slice_name in unported:
            if bad:
                raise NotImplementedError(
                    f"Engine: {what} is not ported yet; it arrives with "
                    f"{slice_name}")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        if max_seq_len is None:
            max_seq_len = num_pages * page_size
        self.max_seq_len = max_seq_len
        self.max_pages = cdiv(max_seq_len, page_size)
        self.cache = LayeredPagedKVCache(
            n_layers=cfg.n_layers, kv_heads=cfg.n_kv_heads,
            head_dim=cfg.head_dim, num_pages=num_pages,
            page_size=page_size, max_seqs=max_batch, tail_size=tail_size,
            dtype=cfg.dtype, device=self.device)
        self.slots: list[_Slot | None] = [None] * max_batch
        self.pending: collections.deque[Request] = collections.deque()
        self.stats = EngineStats()
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.decode_chunk = max(1, decode_chunk)
        if self.decode_chunk >= self.cache.tail_size:
            raise ValueError("decode_chunk must be < tail_size")

    # --- scheduling -------------------------------------------------------

    def submit(self, request: Request) -> int:
        if request.submit_ts is None:
            request.submit_ts = time.perf_counter()
        self.pending.append(request)
        return request.request_id

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _reserved_pages(self) -> int:
        """Pages still owed to live sequences under worst-case growth:
        each slot's growth budget (forked branches exclude the shared
        prompt pages) minus the growth it has already materialized."""
        owed = 0
        for s in self.slots:
            if s is None:
                continue
            grown = (self.cache.pages_for(
                max(self.cache.length(s.seq_id), 1))
                - self.cache.pages_for(max(s.prompt_len, 1)))
            budget = s.worst_pages - (
                self.cache.pages_for(max(s.prompt_len, 1))
                if s.branch == 0 else 0)
            owed += max(0, budget - grown)
        return owed

    def _try_admit(self) -> list[Completion]:
        """FIFO admission into free slots, reserving worst-case pages.
        A request with n > 1 prefills ONCE and forks n - 1 times."""
        done = []
        total_usable = self.cache.num_pages - 1   # scratch page reserved
        while self.pending:
            req = self.pending[0]
            n = max(1, req.n)
            prompt = np.asarray(req.prompt, np.int32)
            t = len(prompt)
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
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if (len(free_slots) < n or self.cache.free_pages
                    - self._reserved_pages() < need):
                break                       # wait for slots/pages
            self.pending.popleft()

            tb = _bucket(t)
            padded = np.zeros((1, tb), np.int32)
            padded[0, :t] = prompt
            t0 = time.perf_counter()
            logits, ks, vs = prefill_kv(
                self.params, torch.from_numpy(padded).to(self.device),
                self.cfg, true_len=t)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stats.prefill_s += time.perf_counter() - t0
            done.extend(self._install_sequences(
                req, logits, ks[:, 0, :, :t], vs[:, 0, :, :t], t, worst,
                branch_worst))
        return done

    def _install_sequences(self, req, logits, ks, vs, t, worst,
                           branch_worst) -> list[Completion]:
        """Prompt KV is ready: page it in, fork n - 1 branches, fill
        decode slots, sample + timestamp the first token."""
        done = []
        n = max(1, req.n)
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        sid = self.cache.add_sequence(ks, vs)
        sids = [sid] + [self.cache.fork_sequence(sid) for _ in range(n - 1)]
        self.stats.prefill_tokens += t
        ttft = (time.perf_counter() - req.submit_ts
                if req.submit_ts is not None else None)
        if ttft is not None:
            self.stats.ttft_s.append(ttft)
        for branch, (slot_idx, bsid) in enumerate(zip(free_slots, sids)):
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
        return done

    def _maybe_finish(self, slot: _Slot) -> Completion | None:
        req = slot.request
        last = slot.generated[-1]
        if req.eos_id is not None and last == req.eos_id:
            reason = "stop"
        elif len(slot.generated) >= req.max_new_tokens:
            reason = "length"
        else:
            return None
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
        """One engine iteration: admit, then `decode_chunk` decode steps
        (sampled tokens feed the next step on the device; one host sync
        per chunk), collect finished sequences."""
        done = self._try_admit()
        used = self.cache.num_pages - self.cache.free_pages
        self.stats.peak_pages = max(self.stats.peak_pages, used)
        live = [i for i, s in enumerate(self.slots) if s is not None]
        self.stats.engine_steps += 1
        if not live:
            return done

        chunk = self.decode_chunk
        t_flush = time.perf_counter()
        # Flush BEFORE the chunk if any live tail could overflow.
        if any(self.slots[i].tail + chunk > self.cache.tail_size
               for i in live):
            self.cache.flush_tails(
                [s.seq_id if s else -1 for s in self.slots],
                [s.tail if s else 0 for s in self.slots])
            for s in self.slots:
                if s is not None:
                    s.tail = 0
        self.stats.flush_s += time.perf_counter() - t_flush

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

        t0 = time.perf_counter()
        tok = torch.from_numpy(tokens).to(self.device)
        tpos = torch.from_numpy(tail_pos).to(self.device)
        out = []
        for i in range(chunk):
            logits, _, _ = decode_step_paged(
                self.params, tok, self.cfg, self.cache.k_pools,
                self.cache.v_pools, self.cache.k_tails,
                self.cache.v_tails, tables, paged_lens, tpos + i,
                paged_bases=bases)
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
                fin = self._maybe_finish(s)
                if fin is not None:
                    done.append(fin)
                    self.slots[i] = None
                    s = None
        self.stats.decode_tokens += accepted
        return done

    def run(self, requests=None) -> list[Completion]:
        """Serve until every pending/submitted request completes."""
        for r in requests or []:
            self.submit(r)
        out = []
        while self.pending or self.num_active:
            out.extend(self.step())
        return sorted(out, key=lambda c: (c.request_id, c.branch))
