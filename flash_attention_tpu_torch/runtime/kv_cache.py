"""Paged KV caches: device pools + the native page allocator (port of
`flash_attention_tpu/runtime/kv_cache.py`: `LayeredPagedKVCache`, the
serving engine's cache, and `PagedKVCache`, a one-layer cache).

Pools are lists of per-layer [Hkv, num_pages, page_size, D] tensors that
share one page allocator: a page id addresses the same slot in every
layer's and head's pool. Page 0 of the allocator is a reserved scratch
page: dead decode slots point their whole table at it, so their masked
writes land harmlessly. New decode tokens go to dense per-slot tails
([max_seqs, Hkv, tail_size, D] per layer, written in place by the decode
step) and move into pages in bulk (`flush_tails`). Torch updates the
pools in place where the JAX version donates buffers.

Prefix cache: full prompt pages are content-addressed by token chain
hashes (`page_chain_hashes`, the JAX function's values) in the page
allocator; `match_prefix` acquires the longest cached prefix,
`gather_pages` turns cached pages into a dense prefill buffer and
`add_sequence_prefixed` admits a sequence on them. Sliding-window
serving evicts whole front pages (`evict_below`); such a sequence keeps
its absolute length and a page-aligned base (`base_tokens`), and the
kernel-facing state is in stored coordinates.

Quantized pools (`quant_dtype` int8 / fp8; page_size a multiple of 128):
pages hold codes with fp32 scales per (page, 128-token block, channel)
in `k_scale_pools` / `v_scale_pools`; the tails stay dense. Bulk writes
are block-aligned and quantize whole blocks; a tail flush requantizes
every block it touches (the rows already there dequantized, the tail
rows overlaid, the rows past them zeroed, a fresh scale per channel), so
stored codes depend on the flush history exactly as in the JAX cache.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from flash_attention_tpu_torch.config import cdiv, resolve_device
from flash_attention_tpu_torch.ops.paged import (
    DEFAULT_PAGE_SIZE,
    paged_flash_decode,
)
from flash_attention_tpu_torch.ops.quant import (
    QUANT_BLOCK, dequantize_blocks, quantize_blocks,
)
from flash_attention_tpu_torch.runtime.allocator import make_allocator


def page_chain_hashes(tokens, page_size: int):
    """Chain hashes identifying each FULL page of a token sequence for
    the allocator's prefix cache: hash(page_i) mixes page i's tokens
    with hash(page_{i-1}), so equal hash <=> equal token PREFIX through
    page i (not merely an equal page). uint64, 0 reserved as "none"."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
    out = []
    prev = b""
    for i in range(len(tokens) // page_size):
        d = hashlib.blake2b(
            prev + tokens[i * page_size:(i + 1) * page_size].tobytes(),
            digest_size=8).digest()
        prev = d
        out.append(int.from_bytes(d, "little") or 1)
    return np.asarray(out, np.uint64)


class PagedKVCache:
    """One layer's paged K/V pools [Hkv, num_pages, page_size, D] over
    the page allocator (no scratch page, no tails): admit a prefix,
    append tokens one at a time, attend with B4. `quantize()` converts a
    populated cache to int8 / fp8 pools with per-(page, 128-token block,
    channel) scales for read-mostly use; appending to it then raises."""

    def __init__(self, *, kv_heads: int, head_dim: int, num_pages: int,
                 page_size: int = DEFAULT_PAGE_SIZE, max_seqs: int = 64,
                 dtype=torch.bfloat16, device="cuda"):
        if page_size % QUANT_BLOCK:
            raise ValueError(
                f"page_size must be a multiple of {QUANT_BLOCK}")
        self.device = resolve_device(device)
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_seqs = max_seqs
        self.dtype = dtype
        self.allocator = make_allocator(num_pages, page_size, max_seqs)
        shape = (kv_heads, num_pages, page_size, head_dim)
        self.k_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.v_pool = torch.zeros(shape, dtype=dtype, device=self.device)
        self.k_scales = None
        self.v_scales = None

    def add_sequence(self, k_prefix, v_prefix) -> int:
        """Admit a sequence with prefill K/V [Hkv, T, D]. Returns seq_id
        or raises MemoryError when the pool is exhausted."""
        t = k_prefix.shape[1]
        sid = self.allocator.alloc(max(t, 1))
        if sid < 0:
            raise MemoryError("KV pool exhausted")
        if t:
            self._write(sid, 0, k_prefix, v_prefix)
        return sid

    @torch.no_grad()
    def append_token(self, seq_id: int, k_new, v_new) -> None:
        """Append one token ([Hkv, D]) to a sequence. A last page shared
        with a fork is copied first (copy-on-write)."""
        if self.k_scales is not None:
            raise NotImplementedError(
                "appending to a quantized PagedKVCache requires "
                "requantizing the touched page; use LayeredPagedKVCache "
                "(quant_dtype=...) for a read/write quantized cache")
        cur = self.allocator.length(seq_id)
        if cur < 0:
            raise ValueError(f"dead sequence {seq_id}")
        if cur % self.page_size:
            page, copied_from = self.allocator.cow_last_page(seq_id)
            if copied_from >= 0:
                self.k_pool[:, page] = self.k_pool[:, copied_from]
                self.v_pool[:, page] = self.v_pool[:, copied_from]
        if not self.allocator.extend(seq_id, cur + 1):
            raise MemoryError("KV pool exhausted")
        self._write(seq_id, cur, k_new[:, None, :], v_new[:, None, :])

    def free_sequence(self, seq_id: int) -> None:
        self.allocator.free(seq_id)

    def fork_sequence(self, seq_id: int) -> int:
        sid = self.allocator.fork(seq_id)
        if sid < 0:
            raise MemoryError("no sequence slot / pages for fork")
        return sid

    @torch.no_grad()
    def _write(self, seq_id: int, start: int, k_new, v_new) -> None:
        t = k_new.shape[1]
        table, _ = self.allocator.page_table(
            seq_id, cdiv(start + t, self.page_size))
        pos = np.arange(start, start + t)
        page_ids = _index(table[pos // self.page_size], self.device)
        offsets = _index(pos % self.page_size, self.device)
        self.k_pool[:, page_ids, offsets, :] = k_new.to(self.dtype)
        self.v_pool[:, page_ids, offsets, :] = v_new.to(self.dtype)

    def batch_state(self, seq_ids, max_pages: int | None = None):
        """(page_table [B, max_pages] int32, lengths [B] int32) for a
        batch, on the cache's device."""
        lengths = np.array([self.allocator.length(s) for s in seq_ids],
                           np.int32)
        if max_pages is None:
            max_pages = max(1, cdiv(int(lengths.max()), self.page_size))
        tables = np.stack([self.allocator.page_table(s, max_pages)[0]
                           for s in seq_ids]).astype(np.int32)
        return (torch.from_numpy(tables).to(self.device),
                torch.from_numpy(lengths).to(self.device))

    def decode(self, q, seq_ids, **kw):
        """Attention of q [B, Hq, D] against the cached prefixes."""
        table, lengths = self.batch_state(seq_ids)
        return paged_flash_decode(q, self.k_pool, self.v_pool, table,
                                  lengths, k_scales=self.k_scales,
                                  v_scales=self.v_scales, **kw)

    @torch.no_grad()
    def quantize(self, dtype=torch.int8) -> None:
        """Convert the pools to int8 / fp8 with per-(page, 128-token
        block, channel) scales (the JAX version's eager arithmetic,
        which divides by qmax)."""
        def quant(pool):
            h, p, ps, d = pool.shape
            xf = pool.float().reshape(h, p, ps // QUANT_BLOCK, QUANT_BLOCK,
                                      d)
            codes, sc = quantize_blocks(xf, dtype, 3, divide=True)
            return codes.reshape(h, p, ps, d), sc[..., 0, :]

        self.k_pool, self.k_scales = quant(self.k_pool)
        self.v_pool, self.v_scales = quant(self.v_pool)
        self.dtype = dtype

    @property
    def hbm_bytes(self) -> int:
        """K and V pool bytes, scales included (as the JAX version
        counts them)."""
        n = 2 * self.k_pool.numel() * self.k_pool.element_size()
        if self.k_scales is not None:
            n += 2 * self.k_scales.numel() * 4
        return n


def _index(arr, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(arr), dtype=torch.long).to(
        device, non_blocking=True)


class LayeredPagedKVCache:
    """Per-layer paged K/V pools sharing one page allocator; int8 / fp8
    pools with `quant_dtype`."""

    def __init__(self, *, n_layers: int, kv_heads: int, head_dim: int,
                 num_pages: int, page_size: int = DEFAULT_PAGE_SIZE,
                 max_seqs: int = 64, tail_size: int | None = None,
                 dtype=torch.bfloat16, quant_dtype=None, device="cuda"):
        if quant_dtype is not None and page_size % QUANT_BLOCK:
            raise ValueError(
                f"page_size must be a multiple of {QUANT_BLOCK} for "
                f"quantized pools")
        self.device = resolve_device(device)
        self.n_layers = n_layers
        self.kv_heads = kv_heads
        self.head_dim = head_dim
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_seqs = max_seqs
        self.tail_size = tail_size or page_size
        self.dtype = dtype
        self.quant_dtype = quant_dtype
        # +1 slot / +1 page for the reserved scratch sequence.
        self.allocator = make_allocator(num_pages, page_size, max_seqs + 1)
        self._scratch_sid = self.allocator.alloc(1)
        self.scratch_page = int(
            self.allocator.page_table(self._scratch_sid, 1)[0][0])
        shape = (kv_heads, num_pages, page_size, head_dim)
        pool_dtype = quant_dtype or dtype
        self.k_pools = [torch.zeros(shape, dtype=pool_dtype,
                                    device=self.device)
                        for _ in range(n_layers)]
        self.v_pools = [torch.zeros(shape, dtype=pool_dtype,
                                    device=self.device)
                        for _ in range(n_layers)]
        self.k_scale_pools = self.v_scale_pools = None
        if quant_dtype is not None:
            sshape = (kv_heads, num_pages, page_size // QUANT_BLOCK,
                      head_dim)
            self.k_scale_pools, self.v_scale_pools = (
                [torch.full(sshape, 1e-8, dtype=torch.float32,
                            device=self.device) for _ in range(n_layers)]
                for _ in range(2))
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
        return _index(arr, self.device)

    def add_sequence(self, ks, vs, base_tokens: int = 0) -> int:
        """Admit a sequence with prefill K/V [L, Hkv, T, D]. With
        `base_tokens` (page-aligned) its first base_tokens positions are
        treated as already evicted (sliding-window admission: ks/vs hold
        only positions [base_tokens, base_tokens + T)); length() stays
        absolute. Returns seq_id; raises MemoryError when the pool/slots
        are exhausted."""
        if base_tokens % self.page_size:
            raise ValueError("base_tokens must be page-aligned")
        t = ks.shape[2]
        sid = self.allocator.alloc(max(base_tokens + t, 1),
                                   base_pages=base_tokens // self.page_size)
        if sid < 0:
            raise MemoryError("KV pool exhausted")
        if t:
            self.write(sid, base_tokens, ks, vs)
        return sid

    # --- sliding-window eviction ---------------------------------------

    def base_tokens(self, seq_id: int) -> int:
        """Front-evicted tokens of seq (absolute positions below this
        have no pages)."""
        return self.allocator.base(seq_id) * self.page_size

    def evict_below(self, seq_id: int, keep_from: int) -> int:
        """Free whole front pages entirely below absolute position
        `keep_from` (positions below the attention window can never be
        read again), never past the paged length. Returns pages freed."""
        target = max(keep_from, 0) // self.page_size
        cur = self.allocator.base(seq_id)
        limit = self.allocator.length(seq_id) // self.page_size
        n = min(target, limit) - cur
        if n > 0:
            self.allocator.pop_front(seq_id, n)
            return n
        return 0

    # --- prefix cache -------------------------------------------------

    def add_sequence_prefixed(self, prefix_pages, ks, vs,
                              total_len: int) -> int:
        """Admit a sequence whose first len(prefix_pages) * page_size
        tokens are already resident in cached pages (acquired with
        match_prefix); ks/vs [L, Hkv, T_suffix, D] hold ONLY the suffix
        KV, written after the prefix. Raises MemoryError and releases
        the acquired pages on failure."""
        sid = self.allocator.alloc_prefixed(max(total_len, 1),
                                            list(prefix_pages))
        if sid < 0:
            self.allocator.cache_release(list(prefix_pages))
            raise MemoryError("KV pool exhausted")
        if ks is not None and ks.shape[2]:
            self.write(sid, len(prefix_pages) * self.page_size, ks, vs)
        return sid

    def register_prefix(self, seq_id: int, tokens) -> int:
        """Register the sequence's full pages under the token chain
        hashes so later prompts sharing the prefix reuse their KV."""
        hashes = page_chain_hashes(tokens, self.page_size)
        if not len(hashes):
            return 0
        return self.allocator.cache_put(seq_id, hashes)

    def match_prefix(self, tokens):
        """(acquired_pages, hashes) for the longest cached prefix of
        `tokens`, capped one page short of covering everything (at least
        one suffix token must be prefilled to produce the first
        logits)."""
        hashes = page_chain_hashes(tokens, self.page_size)
        cap = max((len(tokens) - 1) // self.page_size, 0)
        if not cap:
            return [], hashes
        return list(self.allocator.cache_match(hashes[:cap])), hashes

    @torch.no_grad()
    def gather_pages(self, pages, out_len: int):
        """Dense [L, 1, Hkv, out_len, D] K/V buffers holding the given
        pages' tokens first (dequantized, codes times scales in fp32,
        when the pools are quantized), zero past them: the chunked-prefill
        prefix buffer of a cached prompt (out_len >= len(pages) *
        page_size)."""
        n = len(pages) * self.page_size
        hkv, d = self.kv_heads, self.head_dim
        shape = (self.n_layers, 1, hkv, out_len, d)
        ks = torch.zeros(shape, dtype=self.dtype, device=self.device)
        vs = torch.zeros(shape, dtype=self.dtype, device=self.device)
        if not pages:
            return ks, vs
        idx = self._idx(list(pages))
        scales = (self.k_scale_pools, self.v_scale_pools)
        for li in range(self.n_layers):
            for pools, sc, out in ((self.k_pools, scales[0], ks),
                                   (self.v_pools, scales[1], vs)):
                g = pools[li][:, idx]               # [Hkv, m, ps, D]
                if sc is not None:
                    g = dequantize_blocks(
                        g.reshape(hkv, len(pages), -1, QUANT_BLOCK, d),
                        sc[li][:, idx], self.dtype)
                out[li, 0, :, :n] = g.reshape(hkv, n, d)
        return ks, vs

    def release_pages(self, pages) -> None:
        self.allocator.cache_release(list(pages))

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
        if start // self.page_size < self.allocator.base(seq_id):
            raise ValueError(
                f"write at {start} below evicted base "
                f"({self.base_tokens(seq_id)})")
        table = self._abs_table(seq_id, start + t)
        if self.quant_dtype is not None:
            self._write_quant(table, start, ks, vs)
            return
        pos = np.arange(start, start + t)
        page_ids = self._idx(table[pos // self.page_size])
        offsets = self._idx(pos % self.page_size)
        for li in range(self.n_layers):
            self.k_pools[li][:, page_ids, offsets, :] = ks[li].to(self.dtype)
            self.v_pools[li][:, page_ids, offsets, :] = vs[li].to(self.dtype)

    def _block_index(self, table, gblk):
        """(page ids [N, 1], row offsets [N, 128], scale rows [N]) of the
        absolute 128-token blocks `gblk` through an absolute table."""
        gs = np.asarray(gblk) * QUANT_BLOCK
        pages = self._idx(table[gs // self.page_size])
        brow = (gs % self.page_size) // QUANT_BLOCK
        offs = brow[:, None] * QUANT_BLOCK + np.arange(QUANT_BLOCK)[None]
        return pages[:, None], self._idx(offs), self._idx(brow)

    def _store_blocks(self, li, blocks, index):
        """Quantize fp32 K and V blocks [Hkv, N, 128, D] of layer li with
        a fresh scale per (block, channel) and store codes and scales."""
        pages, offs, brow = index
        for pools, scales, x in ((self.k_pools, self.k_scale_pools,
                                  blocks[0]),
                                 (self.v_pools, self.v_scale_pools,
                                  blocks[1])):
            codes, sc = quantize_blocks(x, self.quant_dtype, 2)
            pools[li][:, pages, offs, :] = codes
            scales[li][:, pages[:, 0], brow, :] = sc[:, :, 0]

    def _write_quant(self, table, start, ks, vs):
        """Block-aligned bulk write into quantized pools: the tokens,
        zero-padded to whole 128-token blocks, quantize block by block."""
        if start % QUANT_BLOCK:
            raise ValueError("quantized bulk writes must be token-block "
                             "aligned")
        t = ks.shape[2]
        nb = cdiv(t, QUANT_BLOCK)
        index = self._block_index(table, start // QUANT_BLOCK
                                  + np.arange(nb))
        pad = nb * QUANT_BLOCK - t
        for li in range(self.n_layers):
            blocks = []
            for x in (ks[li], vs[li]):
                x = torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
                blocks.append(x.reshape(self.kv_heads, nb, QUANT_BLOCK,
                                        self.head_dim))
            self._store_blocks(li, blocks, index)

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
        by tail_pos in the decode step. Quantized pools requantize every
        block the tokens touch (_flush_tails_quant)."""
        if self.quant_dtype is not None:
            return self._flush_tails_quant(slot_sids, counts)
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
    def _flush_tails_quant(self, slot_sids, counts) -> None:
        """Quantized flush: every 128-token block the tail tokens touch is
        requantized -- rows before the flush start keep their (dequantized)
        content, rows [start, end) take the tail tokens, rows past the end
        are zeroed, and the block takes a fresh scale per channel. Only
        live blocks are touched (the JAX version pads to a fixed count
        with entries on the scratch page)."""
        gblk, b_idx, s_rel, e_rel, t_base, cows = [], [], [], [], [], []
        tables = []
        for i, (sid, cnt) in enumerate(zip(slot_sids, counts)):
            if sid is None or sid < 0 or cnt == 0:
                continue
            start = self.allocator.length(sid)
            cow = self._cow_boundary(sid, start)
            if cow is not None:
                cows.append(cow)
            end = start + int(cnt)
            if not self.allocator.extend(sid, end):
                raise MemoryError("KV pool exhausted during tail flush")
            table = self._abs_table(sid, end)
            for g in range(start // QUANT_BLOCK,
                           (end - 1) // QUANT_BLOCK + 1):
                gs = g * QUANT_BLOCK
                tables.append(table[gs // self.page_size])
                gblk.append((gs % self.page_size) // QUANT_BLOCK)
                b_idx.append(i)
                s_rel.append(max(start - gs, 0))
                e_rel.append(min(end - gs, QUANT_BLOCK))
                t_base.append(gs - start)
        self._apply_cows(cows)
        if not gblk:
            return
        brow = np.asarray(gblk)
        r = np.arange(QUANT_BLOCK)
        pages = self._idx(tables)[:, None]
        offs = self._idx(brow[:, None] * QUANT_BLOCK + r[None])
        index = (pages, offs, self._idx(brow))
        trow = self._idx(np.clip(np.asarray(t_base)[:, None] + r[None], 0,
                                 self.tail_size - 1))
        rows = torch.from_numpy(r).to(self.device)[None]
        s_t, e_t = (torch.as_tensor(x, device=self.device)[:, None]
                    for x in (s_rel, e_rel))
        use_new = ((rows >= s_t) & (rows < e_t))[None, :, :, None]
        zero = (rows >= e_t)[None, :, :, None]
        bi = self._idx(b_idx)[:, None]
        for li in range(self.n_layers):
            blocks = []
            for pools, scales, tails in (
                    (self.k_pools, self.k_scale_pools, self.k_tails),
                    (self.v_pools, self.v_scale_pools, self.v_tails)):
                cur = dequantize_blocks(pools[li][:, pages, offs, :],
                                        scales[li][:, pages[:, 0], index[2]],
                                        torch.float32)
                new = tails[li][bi, :, trow, :].permute(2, 0, 1, 3).float()
                blk = torch.where(use_new, new, cur)
                blocks.append(torch.where(zero, torch.zeros_like(blk), blk))
            self._store_blocks(li, blocks, index)

    @torch.no_grad()
    def _apply_cows(self, cows) -> None:
        """Copy page data dst <- src in every layer, scales included
        (copy-on-write after an allocator fork)."""
        if not cows:
            return
        dst = self._idx([c[0] for c in cows])
        src = self._idx([c[1] for c in cows])
        groups = [self.k_pools, self.v_pools]
        if self.quant_dtype is not None:
            groups += [self.k_scale_pools, self.v_scale_pools]
        for pools in groups:
            for p in pools:
                p[:, dst] = p[:, src]

    @property
    def hbm_bytes(self) -> int:
        """K/V page and tail bytes. The scale pools are left out, as the
        JAX version's layered hbm_bytes leaves them out
        (PagedKVCache.hbm_bytes counts them)."""
        n = 2 * sum(p.numel() * p.element_size() for p in self.k_pools)
        n += 2 * sum(p.numel() * p.element_size() for p in self.k_tails)
        return n
