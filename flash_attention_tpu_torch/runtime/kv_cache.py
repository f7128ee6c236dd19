"""Paged KV cache: per-layer device pools + the native page allocator
(port of `LayeredPagedKVCache`, `flash_attention_tpu/runtime/kv_cache.py`).

Pools are lists of per-layer [Hkv, num_pages, page_size, D] tensors that
share one page allocator: a page id addresses the same slot in every
layer's and head's pool. Page 0 of the allocator is a reserved scratch
page: dead decode slots point their whole table at it, so their masked
writes land harmlessly. New decode tokens go to dense per-slot tails
([max_seqs, Hkv, tail_size, D] per layer, written in place by the decode
step) and move into pages in bulk (`flush_tails`). Torch updates the
pools in place where the JAX version donates buffers.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attention_tpu_torch.config import cdiv, resolve_device
from flash_attention_tpu_torch.ops.paged import DEFAULT_PAGE_SIZE
from flash_attention_tpu_torch.runtime.allocator import make_allocator


class LayeredPagedKVCache:
    """Per-layer paged K/V pools sharing one page allocator (dense pools;
    quantized pools arrive with a later slice)."""

    def __init__(self, *, n_layers: int, kv_heads: int, head_dim: int,
                 num_pages: int, page_size: int = DEFAULT_PAGE_SIZE,
                 max_seqs: int = 64, tail_size: int | None = None,
                 dtype=torch.bfloat16, quant_dtype=None, device="cuda"):
        if quant_dtype is not None:
            raise NotImplementedError(
                "quantized KV pools arrive with the quantized-KV slice")
        self.device = resolve_device(device)
        self.n_layers = n_layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_seqs = max_seqs
        self.tail_size = tail_size or page_size
        self.dtype = dtype
        # +1 slot / +1 page for the reserved scratch sequence.
        self.allocator = make_allocator(num_pages, page_size, max_seqs + 1)
        self._scratch_sid = self.allocator.alloc(1)
        self.scratch_page = int(
            self.allocator.page_table(self._scratch_sid, 1)[0][0])
        shape = (kv_heads, num_pages, page_size, head_dim)
        self.k_pools = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(n_layers)]
        self.v_pools = [torch.zeros(shape, dtype=dtype, device=self.device)
                        for _ in range(n_layers)]
        tshape = (max_seqs, kv_heads, self.tail_size, head_dim)
        self.k_tails = [torch.zeros(tshape, dtype=dtype, device=self.device)
                        for _ in range(n_layers)]
        self.v_tails = [torch.zeros(tshape, dtype=dtype, device=self.device)
                        for _ in range(n_layers)]

    @property
    def free_pages(self) -> int:
        return self.allocator.free_pages

    def pages_for(self, tokens: int) -> int:
        return cdiv(tokens, self.page_size)

    def _idx(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=torch.long).to(
            self.device, non_blocking=True)

    def add_sequence(self, ks, vs) -> int:
        """Admit a sequence with prefill K/V [L, Hkv, T, D]. Returns
        seq_id; raises MemoryError when the pool/slots are exhausted."""
        t = ks.shape[2]
        sid = self.allocator.alloc(max(t, 1))
        if sid < 0:
            raise MemoryError("KV pool exhausted")
        if t:
            self.write(sid, 0, ks, vs)
        return sid

    def fork_sequence(self, seq_id: int) -> int:
        """Fork: the new sequence shares every page (refcounted); page
        DATA diverges lazily -- flush_tails copies a shared boundary page
        (copy-on-write) before writing into it."""
        sid = self.allocator.fork(seq_id)
        if sid < 0:
            raise MemoryError("no sequence slot for fork")
        return sid

    def _cow_boundary(self, sid: int, start: int):
        """Before a flush writes into the page containing `start`, give
        the sequence an exclusive copy if that page is shared. Returns
        (dst, src) page ids to copy, or None."""
        if start == 0 or start % self.page_size == 0:
            return None
        page, copied_from = self.allocator.cow_last_page(sid)
        if copied_from < 0:
            return None
        return page, copied_from

    def free_sequence(self, seq_id: int) -> None:
        self.allocator.free(seq_id)

    def length(self, seq_id: int) -> int:
        return self.allocator.length(seq_id)

    def extend(self, seq_id: int, new_len: int) -> bool:
        return self.allocator.extend(seq_id, new_len)

    @torch.no_grad()
    def write(self, seq_id: int, start: int, ks, vs) -> None:
        """Write ks/vs [L, Hkv, T, D] at token offset `start`, extending
        the allocation to cover it."""
        t = ks.shape[2]
        if self.allocator.length(seq_id) < start + t:
            if not self.allocator.extend(seq_id, start + t):
                raise MemoryError("KV pool exhausted during write")
        table = self._abs_table(seq_id, start + t)
        pos = np.arange(start, start + t)
        page_ids = self._idx(table[pos // self.page_size])
        offsets = self._idx(pos % self.page_size)
        for li in range(self.n_layers):
            self.k_pools[li][:, page_ids, offsets, :] = ks[li].to(self.dtype)
            self.v_pools[li][:, page_ids, offsets, :] = vs[li].to(self.dtype)

    def _abs_table(self, sid: int, end_tokens: int):
        """Page table indexable by ABSOLUTE page number (front-evicted
        entries poisoned with -1; callers only index >= base)."""
        base = self.allocator.base(sid)
        live = self.pages_for(end_tokens) - base
        tbl, _ = self.allocator.page_table(sid, live)
        if not base:
            return tbl
        out = np.full(base + live, -1, np.int32)
        out[base:] = tbl
        return out

    def batch_state(self, seq_ids, max_pages: int):
        """(page_tables [B, max_pages] int32, lengths [B] int32) on the
        cache's device. Dead slots (seq_id < 0) get length 0 and a
        scratch-page table. Both are in STORED coordinates (a
        front-evicted sequence's table starts at its first live page)."""
        tables = np.full((len(seq_ids), max_pages), self.scratch_page,
                         np.int32)
        lengths = np.zeros(len(seq_ids), np.int32)
        for i, sid in enumerate(seq_ids):
            if sid is None or sid < 0:
                continue
            lengths[i] = (self.allocator.length(sid)
                          - self.allocator.base(sid) * self.page_size)
            tables[i], _ = self.allocator.page_table(
                sid, max_pages, fill=self.scratch_page)
        return (torch.from_numpy(tables).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def bases(self, seq_ids) -> torch.Tensor:
        """[B] int32 front-evicted TOKENS per slot (0 for dead)."""
        return torch.tensor([
            0 if (sid is None or sid < 0)
            else self.allocator.base(sid) * self.page_size
            for sid in seq_ids], dtype=torch.int32, device=self.device)

    def live_pages(self, seq_ids) -> int:
        """Max STORED pages over the batch (>= 1): the page-table width a
        decode dispatch needs."""
        need = 1
        for sid in seq_ids:
            if sid is None or sid < 0:
                continue
            ln = (self.allocator.length(sid)
                  - self.allocator.base(sid) * self.page_size)
            need = max(need, cdiv(ln, self.page_size))
        return need

    @torch.no_grad()
    def flush_tails(self, slot_sids, counts) -> None:
        """Move each slot's first counts[i] tail tokens into its pages,
        all layers at once, extending allocations. The caller resets its
        tail counters afterwards; tail rows become stale and are masked
        by tail_pos in the decode step."""
        b = self.max_seqs
        t = self.tail_size
        pids = np.full((b * t,), self.scratch_page, np.int32)
        offs = np.zeros((b * t,), np.int32)
        b_idx = np.repeat(np.arange(b), t)
        t_idx = np.tile(np.arange(t), b)
        cows = []
        for i, (sid, cnt) in enumerate(zip(slot_sids, counts)):
            if sid is None or sid < 0 or cnt == 0:
                continue
            start = self.allocator.length(sid)
            cow = self._cow_boundary(sid, start)
            if cow is not None:
                cows.append(cow)
            if not self.allocator.extend(sid, start + int(cnt)):
                raise MemoryError("KV pool exhausted during tail flush")
            table = self._abs_table(sid, start + int(cnt))
            pos = np.arange(start, start + int(cnt))
            pids[i * t: i * t + int(cnt)] = table[pos // self.page_size]
            offs[i * t: i * t + int(cnt)] = pos % self.page_size
        self._apply_cows(cows)
        bi, ti = self._idx(b_idx), self._idx(t_idx)
        pi, oi = self._idx(pids), self._idx(offs)
        for kp, vp, kt, vt in zip(self.k_pools, self.v_pools, self.k_tails,
                                  self.v_tails):
            # Dead entries all target (scratch page, row 0).
            kp[:, pi, oi, :] = kt[bi, :, ti, :].transpose(0, 1).to(kp.dtype)
            vp[:, pi, oi, :] = vt[bi, :, ti, :].transpose(0, 1).to(vp.dtype)

    @torch.no_grad()
    def _apply_cows(self, cows) -> None:
        """Copy page data dst <- src in every layer (copy-on-write after
        an allocator fork)."""
        if not cows:
            return
        dst = self._idx([c[0] for c in cows])
        src = self._idx([c[1] for c in cows])
        for pools in (self.k_pools, self.v_pools):
            for p in pools:
                p[:, dst] = p[:, src]
