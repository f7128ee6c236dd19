// Paged KV-cache block allocator.
//
// Native runtime component (role: the memory-management layer a serving
// framework keeps out of Python — the reference has no runtime at all, so
// this is north-star infrastructure; SURVEY.md §7.1 "paged KV-cache
// blocks feed a continuous-batching decode loop").
//
// Host-side only: tracks which device pool pages belong to which
// sequence. The device never sees this structure — Python reads the page
// tables out and ships them to the paged decode kernel as int32
// tensors.
//
// Design: O(1) page alloc/free via a free-list stack; per-sequence page
// vectors; copy-on-write sharing (prefix sharing for beam/parallel
// sampling) via per-page refcounts.

// Prefix cache (RadixAttention-style, at page granularity): full pages
// whose token content is identified by a CHAIN hash (hash of this
// page's tokens mixed with the previous page's hash, computed by the
// Python layer) stay resident after their sequence frees. A later
// sequence whose prompt starts with the same token pages re-acquires
// them (refcount bump) and skips recomputing their KV. Evictable pages
// (refcount 0, hash registered) sit on an intrusive O(1) LRU list;
// page allocation falls back to evicting the oldest when the free
// stack empties, so caching never reduces usable capacity. Full pages
// are immutable once written (appends touch only the partial last
// page, with copy-on-write at flush boundaries), which is what makes
// content-addressed reuse sound.

#include <cstdint>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

struct Sequence {
  std::vector<int32_t> pages;  // live pages: absolute page index
                               // base_pages + i holds tokens
                               // [(base_pages+i)*ps, ...)
  int32_t length = 0;          // ABSOLUTE tokens (incl. evicted)
  int32_t base_pages = 0;      // front pages evicted (sliding window)
  bool live = false;
};

struct PagedAllocator {
  int32_t num_pages;
  int32_t page_size;
  std::vector<int32_t> free_stack;      // available page ids
  std::vector<int32_t> refcount;        // per page
  std::vector<Sequence> seqs;
  // Prefix-cache state.
  std::unordered_map<uint64_t, int32_t> cache;  // chain hash -> page
  std::vector<uint64_t> page_hash;              // 0 = unregistered
  std::vector<int32_t> lru_prev, lru_next;      // intrusive LRU of
  int32_t lru_head = -1, lru_tail = -1;         // evictable pages
  int32_t n_evictable = 0;
  std::mutex mu;

  PagedAllocator(int32_t pages, int32_t psize, int32_t max_seqs)
      : num_pages(pages), page_size(psize), refcount(pages, 0),
        seqs(max_seqs), page_hash(pages, 0),
        lru_prev(pages, -1), lru_next(pages, -1) {
    free_stack.reserve(pages);
    for (int32_t i = pages - 1; i >= 0; --i) free_stack.push_back(i);
  }

  int32_t pages_needed(int32_t tokens) const {
    return (tokens + page_size - 1) / page_size;
  }

  // --- LRU of evictable (refcount-0, hash-registered) pages ----------

  void lru_push_back(int32_t p) {       // most recently freed at tail
    lru_prev[p] = lru_tail;
    lru_next[p] = -1;
    if (lru_tail >= 0) lru_next[lru_tail] = p;
    lru_tail = p;
    if (lru_head < 0) lru_head = p;
    ++n_evictable;
  }

  void lru_remove(int32_t p) {
    if (lru_prev[p] >= 0) lru_next[lru_prev[p]] = lru_next[p];
    else lru_head = lru_next[p];
    if (lru_next[p] >= 0) lru_prev[lru_next[p]] = lru_prev[p];
    else lru_tail = lru_prev[p];
    lru_prev[p] = lru_next[p] = -1;
    --n_evictable;
  }

  int32_t available() const {
    return static_cast<int32_t>(free_stack.size()) + n_evictable;
  }

  // Take one allocatable page: free stack first, else evict the
  // least-recently-freed cached page. Returns -1 when exhausted.
  int32_t take_page() {
    if (!free_stack.empty()) {
      int32_t p = free_stack.back();
      free_stack.pop_back();
      return p;
    }
    if (lru_head < 0) return -1;
    int32_t p = lru_head;
    lru_remove(p);
    cache.erase(page_hash[p]);
    page_hash[p] = 0;
    return p;
  }

  // A page's refcount dropped to zero: cached pages become evictable,
  // unregistered pages return to the free stack.
  void retire_page(int32_t p) {
    if (page_hash[p] != 0) lru_push_back(p);
    else free_stack.push_back(p);
  }
};

}  // namespace

extern "C" {

PagedAllocator* pa_create(int32_t num_pages, int32_t page_size,
                          int32_t max_seqs) {
  if (num_pages <= 0 || page_size <= 0 || max_seqs <= 0) return nullptr;
  return new PagedAllocator(num_pages, page_size, max_seqs);
}

void pa_destroy(PagedAllocator* pa) { delete pa; }

// Allocatable pages: the free stack PLUS evictable cached pages (the
// prefix cache never reduces usable capacity).
int32_t pa_num_free_pages(PagedAllocator* pa) {
  std::lock_guard<std::mutex> l(pa->mu);
  return pa->available();
}

int32_t pa_page_size(PagedAllocator* pa) { return pa->page_size; }

// Allocate a sequence slot with capacity for `tokens`, the first
// `base_pages` pages of which are ALREADY EVICTED (sliding-window
// admission: only tokens [base_pages*page_size, tokens) get pages).
// Returns seq_id or -1 (no slot / not enough pages / bad base).
int32_t pa_alloc_seq_based(PagedAllocator* pa, int32_t tokens,
                           int32_t base_pages) {
  std::lock_guard<std::mutex> l(pa->mu);
  int32_t sid = -1;
  for (size_t i = 0; i < pa->seqs.size(); ++i) {
    if (!pa->seqs[i].live) { sid = static_cast<int32_t>(i); break; }
  }
  if (sid < 0) return -1;
  int32_t need = pa->pages_needed(tokens) - base_pages;
  if (base_pages < 0 || need < 0) return -1;
  if (pa->available() < need) return -1;
  Sequence& s = pa->seqs[sid];
  s.pages.clear();
  for (int32_t i = 0; i < need; ++i) {
    int32_t p = pa->take_page();
    pa->refcount[p] = 1;
    s.pages.push_back(p);
  }
  s.length = tokens;
  s.base_pages = base_pages;
  s.live = true;
  return sid;
}

// Allocate a sequence slot with capacity for `tokens`. Returns seq_id or
// -1 (no slot / not enough pages).
int32_t pa_alloc_seq(PagedAllocator* pa, int32_t tokens) {
  return pa_alloc_seq_based(pa, tokens, 0);
}

// Sliding-window eviction: release the FIRST n live pages of seq
// (their tokens fell below the attention window and can never be read
// again). Shared (forked/cached) pages just drop a ref. Returns the
// new base_pages, or -1 on a bad seq / n out of range.
int32_t pa_pop_front(PagedAllocator* pa, int32_t seq_id, int32_t n) {
  std::lock_guard<std::mutex> l(pa->mu);
  if (seq_id < 0 || seq_id >= static_cast<int32_t>(pa->seqs.size()))
    return -1;
  Sequence& s = pa->seqs[seq_id];
  if (!s.live || n < 0 || n > static_cast<int32_t>(s.pages.size()))
    return -1;
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = s.pages[i];
    if (--pa->refcount[p] == 0) pa->retire_page(p);
  }
  s.pages.erase(s.pages.begin(), s.pages.begin() + n);
  s.base_pages += n;
  return s.base_pages;
}

// Evicted-front size of seq, in PAGES. -1 on a bad seq.
int32_t pa_seq_base(PagedAllocator* pa, int32_t seq_id) {
  std::lock_guard<std::mutex> l(pa->mu);
  if (seq_id < 0 || seq_id >= static_cast<int32_t>(pa->seqs.size()))
    return -1;
  return pa->seqs[seq_id].live ? pa->seqs[seq_id].base_pages : -1;
}

// Grow (or shrink bookkeeping of) a sequence to new_len tokens,
// allocating pages as needed. Returns 0, or -1 on OOM / bad seq.
int32_t pa_extend(PagedAllocator* pa, int32_t seq_id, int32_t new_len) {
  std::lock_guard<std::mutex> l(pa->mu);
  if (seq_id < 0 || seq_id >= static_cast<int32_t>(pa->seqs.size()))
    return -1;
  Sequence& s = pa->seqs[seq_id];
  if (!s.live) return -1;
  int32_t need = pa->pages_needed(new_len) - s.base_pages;
  int32_t have = static_cast<int32_t>(s.pages.size());
  if (need > have) {
    if (pa->available() < need - have) return -1;
    for (int32_t i = have; i < need; ++i) {
      int32_t p = pa->take_page();
      pa->refcount[p] = 1;
      s.pages.push_back(p);
    }
  }
  s.length = new_len;
  return 0;
}

// Fork: new sequence sharing all pages of `src` (refcounted, for prefix
// sharing). The forked sequence must copy-on-write before mutating a
// shared page — pa_cow below reports whether a page needs copying.
int32_t pa_fork(PagedAllocator* pa, int32_t src_id) {
  std::lock_guard<std::mutex> l(pa->mu);
  if (src_id < 0 || src_id >= static_cast<int32_t>(pa->seqs.size()))
    return -1;
  Sequence& src = pa->seqs[src_id];
  if (!src.live) return -1;
  int32_t sid = -1;
  for (size_t i = 0; i < pa->seqs.size(); ++i) {
    if (!pa->seqs[i].live) { sid = static_cast<int32_t>(i); break; }
  }
  if (sid < 0) return -1;
  Sequence& dst = pa->seqs[sid];
  dst.pages = src.pages;
  dst.length = src.length;
  dst.base_pages = src.base_pages;
  dst.live = true;
  for (int32_t p : dst.pages) pa->refcount[p]++;
  return sid;
}

// Ensure the last page of seq is exclusively owned (copy-on-write).
// Returns: -2 bad seq; -1 OOM; otherwise the (possibly new) page id of
// the last page. If a copy is required, *copied_from is set to the old
// page id so the caller can issue the device copy; else -1.
int32_t pa_cow_last_page(PagedAllocator* pa, int32_t seq_id,
                         int32_t* copied_from) {
  std::lock_guard<std::mutex> l(pa->mu);
  *copied_from = -1;
  if (seq_id < 0 || seq_id >= static_cast<int32_t>(pa->seqs.size()))
    return -2;
  Sequence& s = pa->seqs[seq_id];
  if (!s.live || s.pages.empty()) return -2;
  int32_t last = s.pages.back();
  // A hash-registered last page is content-addressed by the prefix
  // cache and must not be mutated even when exclusively owned (only
  // FULL pages are registered, and full pages are never the mutation
  // target — this is a defensive invariant, not a hot path).
  if (pa->refcount[last] == 1 && pa->page_hash[last] == 0) return last;
  int32_t fresh = pa->take_page();
  if (fresh < 0) return -1;
  pa->refcount[fresh] = 1;
  if (--pa->refcount[last] == 0) pa->retire_page(last);
  s.pages.back() = fresh;
  *copied_from = last;
  return fresh;
}

void pa_free_seq(PagedAllocator* pa, int32_t seq_id) {
  std::lock_guard<std::mutex> l(pa->mu);
  if (seq_id < 0 || seq_id >= static_cast<int32_t>(pa->seqs.size())) return;
  Sequence& s = pa->seqs[seq_id];
  if (!s.live) return;
  for (int32_t p : s.pages) {
    if (--pa->refcount[p] == 0) pa->retire_page(p);
  }
  s.pages.clear();
  s.length = 0;
  s.base_pages = 0;
  s.live = false;
}

int32_t pa_seq_length(PagedAllocator* pa, int32_t seq_id) {
  std::lock_guard<std::mutex> l(pa->mu);
  if (seq_id < 0 || seq_id >= static_cast<int32_t>(pa->seqs.size()))
    return -1;
  return pa->seqs[seq_id].live ? pa->seqs[seq_id].length : -1;
}

// --- Prefix cache -----------------------------------------------------

// Register chain hashes for the first n_pages pages of seq (FULL pages
// only — the caller guarantees page i holds page_size tokens whose
// chain hash is hashes[i]). A hash already mapping to another page
// keeps its existing mapping (that page's KV is identical by
// construction). hashes[i] == 0 entries are skipped. Returns the
// number newly registered, or -1 on a bad sequence.
int32_t pa_cache_put(PagedAllocator* pa, int32_t seq_id, int32_t n_pages,
                     const uint64_t* hashes) {
  std::lock_guard<std::mutex> l(pa->mu);
  if (seq_id < 0 || seq_id >= static_cast<int32_t>(pa->seqs.size()))
    return -1;
  Sequence& s = pa->seqs[seq_id];
  if (!s.live || n_pages > static_cast<int32_t>(s.pages.size()))
    return -1;
  // A front-evicted sequence's page i no longer holds prompt page i —
  // content-addressed registration would be wrong.
  if (s.base_pages != 0) return -1;
  int32_t added = 0;
  for (int32_t i = 0; i < n_pages; ++i) {
    uint64_t h = hashes[i];
    int32_t p = s.pages[i];
    if (h == 0 || pa->page_hash[p] != 0) continue;
    if (pa->cache.count(h)) continue;       // content already cached
    pa->cache[h] = p;
    pa->page_hash[p] = h;
    ++added;
  }
  return added;
}

// Longest-prefix match of a chain-hash sequence against the cache.
// Every matched page is ACQUIRED (refcount bumped; an evictable page
// leaves the LRU), so the caller owns the pages until it transfers
// them into a sequence (pa_alloc_seq_prefixed) or releases them
// (pa_cache_release). Returns the match length in pages.
int32_t pa_cache_match(PagedAllocator* pa, const uint64_t* hashes,
                       int32_t n, int32_t* out_pages) {
  std::lock_guard<std::mutex> l(pa->mu);
  int32_t m = 0;
  for (; m < n; ++m) {
    auto it = pa->cache.find(hashes[m]);
    if (it == pa->cache.end()) break;
    int32_t p = it->second;
    if (pa->refcount[p]++ == 0) pa->lru_remove(p);
    out_pages[m] = p;
  }
  return m;
}

// Undo pa_cache_match acquisitions (admission failed downstream).
void pa_cache_release(PagedAllocator* pa, const int32_t* pages,
                      int32_t n) {
  std::lock_guard<std::mutex> l(pa->mu);
  for (int32_t i = 0; i < n; ++i) {
    int32_t p = pages[i];
    if (p < 0 || p >= pa->num_pages) continue;
    if (--pa->refcount[p] == 0) pa->retire_page(p);
  }
}

// Allocate a sequence whose first n_prefix pages are the given
// (already-acquired via pa_cache_match) shared pages; fresh pages
// cover the rest of `tokens`. Ref ownership of the prefix pages
// transfers to the sequence. Returns seq_id or -1 (the prefix refs are
// NOT released on failure — the caller still owns them).
int32_t pa_alloc_seq_prefixed(PagedAllocator* pa, int32_t tokens,
                              const int32_t* prefix_pages,
                              int32_t n_prefix) {
  std::lock_guard<std::mutex> l(pa->mu);
  int32_t sid = -1;
  for (size_t i = 0; i < pa->seqs.size(); ++i) {
    if (!pa->seqs[i].live) { sid = static_cast<int32_t>(i); break; }
  }
  if (sid < 0) return -1;
  int32_t need = pa->pages_needed(tokens);
  if (n_prefix > need) return -1;
  if (pa->available() < need - n_prefix) return -1;
  Sequence& s = pa->seqs[sid];
  s.pages.assign(prefix_pages, prefix_pages + n_prefix);
  for (int32_t i = n_prefix; i < need; ++i) {
    int32_t p = pa->take_page();
    pa->refcount[p] = 1;
    s.pages.push_back(p);
  }
  s.length = tokens;
  s.base_pages = 0;
  s.live = true;
  return sid;
}

// Cache observability: *cached = registered pages, *evictable = those
// currently unreferenced (reclaimable).
void pa_cache_stats(PagedAllocator* pa, int32_t* cached,
                    int32_t* evictable) {
  std::lock_guard<std::mutex> l(pa->mu);
  *cached = static_cast<int32_t>(pa->cache.size());
  *evictable = pa->n_evictable;
}

// Copy the page table of seq into out[0..max). Unused slots get fill.
// Returns number of live pages, or -1.
int32_t pa_page_table(PagedAllocator* pa, int32_t seq_id, int32_t* out,
                      int32_t max, int32_t fill) {
  std::lock_guard<std::mutex> l(pa->mu);
  if (seq_id < 0 || seq_id >= static_cast<int32_t>(pa->seqs.size()))
    return -1;
  Sequence& s = pa->seqs[seq_id];
  if (!s.live) return -1;
  int32_t n = static_cast<int32_t>(s.pages.size());
  if (n > max) return -1;
  for (int32_t i = 0; i < n; ++i) out[i] = s.pages[i];
  for (int32_t i = n; i < max; ++i) out[i] = fill;
  return n;
}

}  // extern "C"
