"""ctypes binding for the native paged allocator, plus the pure-Python
allocator with the identical contract (port of
`flash_attention_tpu/runtime/allocator.py`).

Host code, not a device fallback: the allocator only tracks which pool
pages belong to which sequence. The C++ source (native/, a copy of the
JAX package's) builds with g++ at first use; where no toolchain is
available `make_allocator` returns the PyAllocator, and the tests hold
both to one contract.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading

_NATIVE_DIR = pathlib.Path(__file__).parent / "native"
_SRC = _NATIVE_DIR / "paged_allocator.cc"
_SO = _NATIVE_DIR / "libpaged_allocator.so"
_BUILD_LOCK = threading.Lock()


def _build_native() -> None:
    """Compile the allocator when the .so is missing or older than its
    source (the flags of native/Makefile). Writes to a temporary name and
    renames, so concurrent build processes never load a half-written file."""
    if _SO.exists() and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_NATIVE_DIR)
    os.close(fd)
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O2", "-std=c++17", "-fPIC",
             "-shared", "-o", tmp, str(_SRC)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load_native():
    with _BUILD_LOCK:
        try:
            _build_native()
        except (OSError, subprocess.SubprocessError):
            if not _SO.exists():
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None
    lib.pa_create.restype = ctypes.c_void_p
    lib.pa_create.argtypes = [ctypes.c_int32] * 3
    lib.pa_destroy.argtypes = [ctypes.c_void_p]
    lib.pa_num_free_pages.restype = ctypes.c_int32
    lib.pa_num_free_pages.argtypes = [ctypes.c_void_p]
    lib.pa_page_size.restype = ctypes.c_int32
    lib.pa_page_size.argtypes = [ctypes.c_void_p]
    lib.pa_alloc_seq.restype = ctypes.c_int32
    lib.pa_alloc_seq.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pa_extend.restype = ctypes.c_int32
    lib.pa_extend.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                              ctypes.c_int32]
    lib.pa_fork.restype = ctypes.c_int32
    lib.pa_fork.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pa_cow_last_page.restype = ctypes.c_int32
    lib.pa_cow_last_page.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.POINTER(ctypes.c_int32)
    ]
    lib.pa_free_seq.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pa_seq_length.restype = ctypes.c_int32
    lib.pa_seq_length.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.pa_page_table.restype = ctypes.c_int32
    lib.pa_page_table.argtypes = [
        ctypes.c_void_p, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
    ]
    u64p = ctypes.POINTER(ctypes.c_uint64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.pa_cache_put.restype = ctypes.c_int32
    lib.pa_cache_put.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32, u64p]
    lib.pa_cache_match.restype = ctypes.c_int32
    lib.pa_cache_match.argtypes = [
        ctypes.c_void_p, u64p, ctypes.c_int32, i32p]
    lib.pa_cache_release.argtypes = [ctypes.c_void_p, i32p, ctypes.c_int32]
    lib.pa_alloc_seq_prefixed.restype = ctypes.c_int32
    lib.pa_alloc_seq_prefixed.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, i32p, ctypes.c_int32]
    lib.pa_cache_stats.argtypes = [ctypes.c_void_p, i32p, i32p]
    lib.pa_alloc_seq_based.restype = ctypes.c_int32
    lib.pa_alloc_seq_based.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_int32]
    lib.pa_pop_front.restype = ctypes.c_int32
    lib.pa_pop_front.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                 ctypes.c_int32]
    lib.pa_seq_base.restype = ctypes.c_int32
    lib.pa_seq_base.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    return lib


_native_lib = None
_native_tried = False


def native_lib():
    global _native_lib, _native_tried
    if not _native_tried:
        _native_lib = _load_native()
        _native_tried = True
    return _native_lib


class NativeAllocator:
    """Thin OO wrapper over the C++ allocator."""

    def __init__(self, num_pages: int, page_size: int, max_seqs: int):
        lib = native_lib()
        if lib is None:
            raise RuntimeError("native allocator unavailable")
        self._lib = lib
        self._pa = lib.pa_create(num_pages, page_size, max_seqs)
        if not self._pa:
            raise ValueError("bad allocator parameters")
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_seqs = max_seqs

    def __del__(self):
        if getattr(self, "_pa", None):
            self._lib.pa_destroy(self._pa)
            self._pa = None

    @property
    def free_pages(self) -> int:
        return self._lib.pa_num_free_pages(self._pa)

    def alloc(self, tokens: int, base_pages: int = 0) -> int:
        if base_pages:
            return self._lib.pa_alloc_seq_based(self._pa, tokens,
                                                base_pages)
        return self._lib.pa_alloc_seq(self._pa, tokens)

    def pop_front(self, seq_id: int, n: int) -> int:
        """Sliding-window eviction: free the first n live pages.
        Returns the new base (pages) or raises on a bad call."""
        r = self._lib.pa_pop_front(self._pa, seq_id, n)
        if r < 0:
            raise ValueError(f"pop_front({seq_id}, {n}) failed")
        return r

    def base(self, seq_id: int) -> int:
        """Evicted front pages of seq (0 when never evicted)."""
        return max(self._lib.pa_seq_base(self._pa, seq_id), 0)

    def extend(self, seq_id: int, new_len: int) -> bool:
        return self._lib.pa_extend(self._pa, seq_id, new_len) == 0

    def fork(self, src_id: int) -> int:
        return self._lib.pa_fork(self._pa, src_id)

    def cow_last_page(self, seq_id: int) -> tuple[int, int]:
        """Returns (page_id, copied_from) — copied_from == -1 when no
        copy was needed. Raises on OOM."""
        src = ctypes.c_int32(-1)
        page = self._lib.pa_cow_last_page(self._pa, seq_id,
                                          ctypes.byref(src))
        if page == -2:
            raise ValueError(f"bad seq {seq_id}")
        if page == -1:
            raise MemoryError("no free pages for copy-on-write")
        return page, src.value

    def free(self, seq_id: int) -> None:
        self._lib.pa_free_seq(self._pa, seq_id)

    def length(self, seq_id: int) -> int:
        return self._lib.pa_seq_length(self._pa, seq_id)

    def page_table(self, seq_id: int, max_pages: int, fill: int = 0):
        import numpy as np
        out = np.empty(max_pages, np.int32)
        n = self._lib.pa_page_table(
            self._pa, seq_id,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            max_pages, fill,
        )
        if n < 0:
            raise ValueError(f"bad seq {seq_id} or table too small")
        return out, n

    # --- prefix cache (see paged_allocator.cc) ------------------------

    def cache_put(self, seq_id: int, hashes) -> int:
        import numpy as np
        h = np.ascontiguousarray(np.asarray(hashes, np.uint64))
        return self._lib.pa_cache_put(
            self._pa, seq_id, len(h),
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))

    def cache_match(self, hashes):
        """Longest cached prefix; returns ACQUIRED page ids (caller owns
        the refs until alloc_prefixed / cache_release)."""
        import numpy as np
        h = np.ascontiguousarray(np.asarray(hashes, np.uint64))
        out = np.empty(max(len(h), 1), np.int32)
        m = self._lib.pa_cache_match(
            self._pa,
            h.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), len(h),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return [int(p) for p in out[:m]]

    def cache_release(self, pages) -> None:
        import numpy as np
        p = np.ascontiguousarray(np.asarray(pages, np.int32))
        self._lib.pa_cache_release(
            self._pa,
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(p))

    def alloc_prefixed(self, tokens: int, prefix_pages) -> int:
        import numpy as np
        p = np.ascontiguousarray(np.asarray(prefix_pages, np.int32))
        return self._lib.pa_alloc_seq_prefixed(
            self._pa, tokens,
            p.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(p))

    def cache_stats(self) -> dict:
        c = ctypes.c_int32(0)
        e = ctypes.c_int32(0)
        self._lib.pa_cache_stats(self._pa, ctypes.byref(c),
                                 ctypes.byref(e))
        return {"cached_pages": c.value, "evictable_pages": e.value}


class PyAllocator:
    """Pure-Python fallback with the identical contract."""

    def __init__(self, num_pages: int, page_size: int, max_seqs: int):
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_seqs = max_seqs
        self._free = list(range(num_pages - 1, -1, -1))
        self._ref = [0] * num_pages
        # None or [pages list, ABSOLUTE length, base_pages] — pages[i]
        # holds tokens of absolute page base_pages + i (front pages
        # evicted by pop_front under sliding-window serving).
        self._seqs = [None] * max_seqs
        # Prefix cache: chain hash -> page; LRU of evictable pages.
        import collections
        self._cache = {}
        self._page_hash = [0] * num_pages
        self._lru = collections.OrderedDict()   # page -> None, FIFO

    @property
    def free_pages(self) -> int:
        return len(self._free) + len(self._lru)

    def _take_page(self) -> int:
        if self._free:
            return self._free.pop()
        if not self._lru:
            return -1
        p, _ = self._lru.popitem(last=False)    # evict oldest
        del self._cache[self._page_hash[p]]
        self._page_hash[p] = 0
        return p

    def _retire_page(self, p: int) -> None:
        if self._page_hash[p]:
            self._lru[p] = None
        else:
            self._free.append(p)

    def _find_slot(self):
        for i, s in enumerate(self._seqs):
            if s is None:
                return i
        return -1

    def _pages_needed(self, tokens):
        return -(-tokens // self.page_size)

    def alloc(self, tokens: int, base_pages: int = 0) -> int:
        sid = self._find_slot()
        need = self._pages_needed(tokens) - base_pages
        if sid < 0 or base_pages < 0 or need < 0 \
                or self.free_pages < need:
            return -1
        pages = []
        for _ in range(need):
            p = self._take_page()
            self._ref[p] = 1
            pages.append(p)
        self._seqs[sid] = [pages, tokens, base_pages]
        return sid

    def pop_front(self, seq_id: int, n: int) -> int:
        """Sliding-window eviction: free the first n live pages."""
        if not self._valid(seq_id):
            raise ValueError(f"bad seq {seq_id}")
        pages, _, base = self._seqs[seq_id]
        if n < 0 or n > len(pages):
            raise ValueError(f"pop_front({seq_id}, {n}) out of range")
        for p in pages[:n]:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._retire_page(p)
        del pages[:n]
        self._seqs[seq_id][2] = base + n
        return base + n

    def base(self, seq_id: int) -> int:
        s = self._seqs[seq_id] if self._valid(seq_id) else None
        return s[2] if s else 0

    def extend(self, seq_id: int, new_len: int) -> bool:
        if not (0 <= seq_id < self.max_seqs) or self._seqs[seq_id] is None:
            return False
        pages, _, base = self._seqs[seq_id]
        need = self._pages_needed(new_len) - base
        if need > len(pages):
            if self.free_pages < need - len(pages):
                return False
            for _ in range(need - len(pages)):
                p = self._take_page()
                self._ref[p] = 1
                pages.append(p)
        self._seqs[seq_id][1] = new_len
        return True

    def _valid(self, seq_id: int) -> bool:
        return 0 <= seq_id < self.max_seqs and self._seqs[seq_id] is not None

    def fork(self, src_id: int) -> int:
        if not self._valid(src_id):
            return -1
        sid = self._find_slot()
        if sid < 0:
            return -1
        pages, length, base = self._seqs[src_id]
        for p in pages:
            self._ref[p] += 1
        self._seqs[sid] = [list(pages), length, base]
        return sid

    def cow_last_page(self, seq_id: int):
        s = self._seqs[seq_id] if self._valid(seq_id) else None
        if s is None or not s[0]:
            raise ValueError(f"bad seq {seq_id}")
        pages = s[0]
        last = pages[-1]
        # A hash-registered page is content-addressed; never mutate it
        # in place even when exclusively owned (defensive — only FULL
        # pages register, and full pages are never mutation targets).
        if self._ref[last] == 1 and not self._page_hash[last]:
            return last, -1
        fresh = self._take_page()
        if fresh < 0:
            raise MemoryError("no free pages for copy-on-write")
        self._ref[fresh] = 1
        self._ref[last] -= 1
        if self._ref[last] == 0:
            self._retire_page(last)
        pages[-1] = fresh
        return fresh, last

    def free(self, seq_id: int) -> None:
        if not (0 <= seq_id < self.max_seqs) or self._seqs[seq_id] is None:
            return
        pages = self._seqs[seq_id][0]
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._retire_page(p)
        self._seqs[seq_id] = None

    def length(self, seq_id: int) -> int:
        s = self._seqs[seq_id] if 0 <= seq_id < self.max_seqs else None
        return s[1] if s else -1

    def page_table(self, seq_id: int, max_pages: int, fill: int = 0):
        import numpy as np
        s = self._seqs[seq_id] if self._valid(seq_id) else None
        if s is None or len(s[0]) > max_pages:
            raise ValueError(f"bad seq {seq_id} or table too small")
        out = np.full(max_pages, fill, np.int32)
        out[: len(s[0])] = s[0]
        return out, len(s[0])

    # --- prefix cache (mirrors the native contract) -------------------

    def cache_put(self, seq_id: int, hashes) -> int:
        if not self._valid(seq_id):
            return -1
        pages, _, base = self._seqs[seq_id]
        # Front-evicted: page i no longer holds prompt page i.
        if len(hashes) > len(pages) or base != 0:
            return -1
        added = 0
        for h, p in zip(hashes, pages):
            h = int(h)
            if h == 0 or self._page_hash[p] or h in self._cache:
                continue
            self._cache[h] = p
            self._page_hash[p] = h
            added += 1
        return added

    def cache_match(self, hashes):
        out = []
        for h in hashes:
            p = self._cache.get(int(h))
            if p is None:
                break
            if self._ref[p] == 0:
                del self._lru[p]
            self._ref[p] += 1
            out.append(p)
        return out

    def cache_release(self, pages) -> None:
        for p in pages:
            self._ref[p] -= 1
            if self._ref[p] == 0:
                self._retire_page(p)

    def alloc_prefixed(self, tokens: int, prefix_pages) -> int:
        sid = self._find_slot()
        need = self._pages_needed(tokens)
        if (sid < 0 or len(prefix_pages) > need
                or self.free_pages < need - len(prefix_pages)):
            return -1
        pages = list(prefix_pages)
        for _ in range(need - len(pages)):
            p = self._take_page()
            self._ref[p] = 1
            pages.append(p)
        self._seqs[sid] = [pages, tokens, 0]
        return sid

    def cache_stats(self) -> dict:
        return {"cached_pages": len(self._cache),
                "evictable_pages": len(self._lru)}


def make_allocator(num_pages: int, page_size: int, max_seqs: int):
    """Native if buildable, else Python fallback."""
    if native_lib() is not None:
        return NativeAllocator(num_pages, page_size, max_seqs)
    return PyAllocator(num_pages, page_size, max_seqs)
