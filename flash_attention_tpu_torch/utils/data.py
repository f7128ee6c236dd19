"""Token data loading for training: memory-mapped shards, deterministic
shuffled batching, background prefetch, checkpointable position.

A copy of `flash_attention_tpu/utils/data.py` (numpy only), kept in the
port so that it imports nothing of the JAX package. The shard format,
the window numbering and the `np.random.default_rng((seed, epoch))`
permutation are the same, so both packages yield identical batches
from the same shards and seed.

  * **Zero-copy IO**: shards are flat int32 token files read through
    `np.memmap` -- the OS page cache is the buffer pool, nothing is
    deserialized, and a 100 GB corpus costs no resident memory.
  * **Determinism == checkpointability**: batch `s` is a pure function
    of (seed, s). Resuming a run needs only the trainer's step counter
    (already checkpointed) -- no loader state file, no replay log. Each
    epoch draws a fresh permutation of window indices from a counter
    -derived PRNG.
  * **Background prefetch**: a daemon thread stages the next batches
    into a bounded queue so host-side gather overlaps device compute.
"""

from __future__ import annotations

import pathlib
import queue
import threading

import numpy as np

_MAGIC = np.uint32(0x544F4B31)          # "TOK1"


def write_token_shard(path, tokens) -> None:
    """Write a flat int32 token shard with a tiny header."""
    tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
    with open(path, "wb") as f:
        np.array([_MAGIC, len(tokens)], np.uint32).tofile(f)
        tokens.tofile(f)


class TokenShardDataset:
    """A set of token shards presented as numbered fixed-length windows.

    Window w of length L is tokens [off, off + L) of one shard (windows
    never straddle shards; the tail remainder of each shard is
    dropped, standard practice)."""

    def __init__(self, paths, seq_len: int):
        if isinstance(paths, (str, pathlib.Path)):
            paths = sorted(pathlib.Path(paths).glob("*.tok"))
        if not paths:
            raise ValueError("no token shards found")
        self.seq_len = seq_len
        self._maps = []
        self._windows = []                  # per shard
        for p in paths:
            head = np.fromfile(p, np.uint32, 2)
            if len(head) != 2 or head[0] != _MAGIC:
                raise ValueError(f"{p}: not a token shard")
            n = int(head[1])
            m = np.memmap(p, np.int32, mode="r", offset=8, shape=(n,))
            self._maps.append(m)
            self._windows.append(n // seq_len)
        self._cum = np.cumsum([0] + self._windows)

    @property
    def num_windows(self) -> int:
        return int(self._cum[-1])

    def window(self, w: int) -> np.ndarray:
        s = int(np.searchsorted(self._cum, w, side="right")) - 1
        off = (w - self._cum[s]) * self.seq_len
        return np.asarray(self._maps[s][off: off + self.seq_len])


class BatchLoader:
    """Deterministic, prefetching batch iterator over a dataset.

    Yields int32 [batch, seq_len] arrays. Batch `s` is reproducible
    from (seed, s) alone: pass `start_step` to resume exactly where a
    checkpointed trainer left off.
    """

    def __init__(self, dataset: TokenShardDataset, batch: int, *,
                 seed: int = 0, start_step: int = 0, prefetch: int = 2):
        if dataset.num_windows < batch:
            raise ValueError(
                f"dataset has {dataset.num_windows} windows < batch "
                f"{batch}")
        self.ds = dataset
        self.batch = batch
        self.seed = seed
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._producer, args=(start_step,), daemon=True)
        self._thread.start()

    def _indices_for(self, step: int) -> np.ndarray:
        n = self.ds.num_windows
        per_epoch = n // self.batch
        epoch, within = divmod(step, per_epoch)
        perm = np.random.default_rng(
            (self.seed, epoch)).permutation(n)
        return perm[within * self.batch:(within + 1) * self.batch]

    def _producer(self, start: int) -> None:
        s = start
        while not self._stop.is_set():
            try:
                idx = self._indices_for(s)
                out = np.stack([self.ds.window(int(w)) for w in idx])
            except Exception as e:  # surface in __next__, don't hang
                out = e
            # Bounded put that stays responsive to close().
            while not self._stop.is_set():
                try:
                    self._q.put((s, out), timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(out, Exception):
                return
            s += 1

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        # Timeout + liveness check: a producer that died BEFORE queueing
        # its exception (e.g. killed) must not hang training forever.
        while True:
            try:
                s, out = self._q.get(timeout=5.0)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise RuntimeError(
                        "BatchLoader producer thread died") from None
        if isinstance(out, Exception):
            raise RuntimeError("BatchLoader producer failed") from out
        assert s == self.step, (s, self.step)
        self.step += 1
        return out

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def __del__(self):  # pragma: no cover
        try:
            self._stop.set()
        except Exception:
            pass


def microbatched(batches, n_microbatches: int):
    """Adapt a [B, T] batch iterator to the pipeline trainer's
    [n_microbatches, B/n_microbatches, T] layout (Trainer
    family="pipeline" consumes microbatched tokens; GPipe/1F1B scan
    over dim 0). Deterministic-resume composes: the reshape is a pure
    function of each yielded batch."""
    for tokens in batches:
        b = tokens.shape[0]
        if b % n_microbatches:
            raise ValueError(
                f"batch {b} not divisible by n_microbatches "
                f"{n_microbatches}")
        yield tokens.reshape(n_microbatches, b // n_microbatches,
                             *tokens.shape[1:])
