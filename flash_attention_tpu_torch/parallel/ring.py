"""Ring attention: sequence-parallel flash attention over a process group
(port of `flash_attention_tpu/parallel/ring.py`).

Each rank holds a sequence chunk of Q, K, V. K/V chunks rotate around
the ring (point-to-point sends to the next rank of the group) while
every rank accumulates attention of its local Q chunk against each
visiting K/V chunk; the partials merge by their log-sum-exp in fp32:

    lse' = logaddexp(lse_a, lse_b)
    o'   = o_a * e^{lse_a - lse'} + o_b * e^{lse_b - lse'}

The function is differentiable (a `torch.autograd.Function`): the
backward is a second ring in which fp32 dK/dV accumulators travel WITH
their K/V chunks and arrive home after the n-th rotation; dQ stays
local. Each step is one call of the port's `flash_attention_fwd` (B1)
or `flash_attention_bwd` (B2 then B3) with the step's causal flag,
offset, window and segment ids, as the JAX step calls the Pallas
kernels; the backward passes them the merged O and LSE.

Causality across chunks (contiguous layout): rank d owns global q chunk
d; the kv chunk visiting at step t is src = (d - t) mod n: src > d is
fully masked and launches nothing, src == d is the causal diagonal,
src < d is fully visible. `layout="zigzag"` balances the work: the
sequence splits into 2n chunks and rank d owns chunks (d, 2n-1-d)
(`zigzag_order` / `zigzag_inverse` permute global arrays). A windowed
ring (contiguous, causal) runs step t at causal offset t * C with the
window in global positions, and launches nothing for a chunk wholly
behind the window.

The JAX loops are `fori_loop` / `lax.cond` / `lax.switch` programs
whose masked-out branches compute skip partials. Here the loop is eager
Python: a masked-out branch is simply not launched, so each rank's
launch counts follow from its place in the ring. Every rank posts the
same sends and receives in the same order, whether it computes at a
step or not; the next step's K/V are in flight during a step's compute.
The rotation after the last forward step is skipped (nobody reads it),
and a group of one rank never sends (NCCL is never asked to send to
itself). A gloo group holding card tensors stages each transfer through
host memory (gloo sends host tensors); an NCCL group never does.

The SPMD difference from the JAX package: JAX's `make_ring_attention`
wraps the ring in `shard_map`, taking global arrays and sharding them
by its specs. Here each rank runs its own program, so the function that
`make_ring_attention` returns takes this rank's local chunks and
returns its local output chunk; the specs only name the ring's axis
(the sequence dim's) and say what else is split.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from flash_attention_tpu_torch.ops.flash import (
    SegmentIds,
    _check_block_sizes,
    acc_dtype,
    flash_attention_bwd,
    flash_attention_fwd,
)

# --- zigzag layout helpers -------------------------------------------------


def zigzag_order(n_seq: int, n_dev: int) -> np.ndarray:
    """Permutation p such that x[..., p, :] is in zigzag layout: the
    sequence splits into 2n chunks and device d's shard is chunks
    (d, 2n-1-d). Apply before sharding over the ring axis."""
    if n_seq % (2 * n_dev):
        raise ValueError(
            f"seq {n_seq} must be divisible by 2*n_dev={2 * n_dev}")
    c = n_seq // (2 * n_dev)
    chunks = np.arange(n_seq).reshape(2 * n_dev, c)
    order = []
    for d in range(n_dev):
        order.append(chunks[d])
        order.append(chunks[2 * n_dev - 1 - d])
    return np.concatenate(order)


def zigzag_inverse(n_seq: int, n_dev: int) -> np.ndarray:
    """Inverse permutation: x_zigzag[..., zigzag_inverse(...), :] is in
    natural order."""
    return np.argsort(zigzag_order(n_seq, n_dev))


# --- the ring's point-to-point rotation --------------------------------------


class _Ring:
    """This rank's place in a ring group: its rank `my` of `n`, and the
    global ranks it sends to and receives from. `group` None is a ring
    of one (no process group needed)."""

    def __init__(self, group):
        self.group = group
        if group is None:
            self.n, self.my = 1, 0
            return
        self.n = dist.get_world_size(group)
        self.my = dist.get_rank(group)
        self.next = dist.get_global_rank(group, (self.my + 1) % self.n)
        self.prev = dist.get_global_rank(group, (self.my - 1) % self.n)
        self.backend = str(dist.get_backend(group))

    def start(self, tensors, tag0=0):
        """Post the send of each tensor to the next rank and a receive of
        its like from the previous one; returns what `finish` takes."""
        if self.n == 1:
            return None, tensors
        staged = self.backend == "gloo" and tensors[0].is_cuda
        if self.backend == "nccl" and not tensors[0].is_cuda:
            raise ValueError("an NCCL ring group takes card tensors")
        ops, bufs = [], []
        for i, t in enumerate(tensors):
            send = t.detach().cpu() if staged else t.detach().contiguous()
            buf = torch.empty_like(send)
            ops.append(dist.P2POp(dist.isend, send, self.next, self.group,
                                  tag0 + i))
            ops.append(dist.P2POp(dist.irecv, buf, self.prev, self.group,
                                  tag0 + i))
            bufs.append(buf)
        reqs = dist.batch_isend_irecv(ops)
        return (reqs, staged, tensors[0].device), bufs

    @staticmethod
    def finish(handle):
        """Wait for `start`'s receives; returns the received tensors (on
        the device of the sent ones)."""
        pending, bufs = handle
        if pending is None:
            return list(bufs)
        reqs, staged, device = pending
        for r in reqs:
            r.wait()
        return [b.to(device) for b in bufs] if staged else bufs


# --- forward ----------------------------------------------------------------


def _wide(x):
    """x in the accumulation dtype: fp32 (fp64 for fp64 inputs, whose
    plain versions compute in fp64)."""
    return x.to(acc_dtype(x.dtype))


def _merge(acc, part):
    """LSE-merge a partial (o in the input dtype, lse fp32 [B, H, N]) into
    the accumulator, which is fp32 from the first merge on; None starts
    it from the partial as it is, so a ring of one returns B1's own bits
    and no extra pass over O. A part whose rows saw nothing carries a
    finite LSE of INIT_M * scale, which weighs exactly 0."""
    if acc is None:
        return part
    (o_acc, lse_acc), (o_new, lse_new) = acc, part
    lse = torch.logaddexp(lse_acc, lse_new)
    w_old = torch.exp(lse_acc - lse)[..., None]
    w_new = torch.exp(lse_new - lse)[..., None]
    return _wide(o_acc) * w_old + _wide(o_new) * w_new, lse


def _halves(x, c, dim=2):
    """(x[..., :c, ...], x[..., c:, ...]) along `dim`, each contiguous (the
    kernels take contiguous tensors)."""
    return (x.narrow(dim, 0, c).contiguous(),
            x.narrow(dim, c, x.shape[dim] - c).contiguous())


def _seg(qs, ks):
    return None if qs is None else SegmentIds(qs, ks)


def _window_reaches(t, c_len, window):
    """Whether a row of the local chunk sees a column of the chunk t
    chunks back under the window (col > row + t C - window)."""
    return t == 0 or window > (t - 1) * c_len + 1


def _steps(ring, causal, layout, window, c_len):
    """Per step t, what this rank computes: 'full', 'diag', 'window',
    'skip' (contiguous), or the zigzag case 'lt' / 'eq' / 'gt'."""
    out = []
    for t in range(ring.n):
        src = (ring.my - t) % ring.n
        if not causal:
            out.append("full")
        elif layout == "zigzag":
            out.append("lt" if src < ring.my else
                       "eq" if src == ring.my else "gt")
        elif window is not None:
            out.append("window" if ring.my >= t
                       and _window_reaches(t, c_len, window) else "skip")
        else:
            out.append("skip" if src > ring.my else
                       "diag" if src == ring.my else "full")
    return out


def _ring_fwd_loop(q, k, v, seg, ring, *, causal, layout, window, scale,
                   block_sizes):
    """Returns (o [B, Hq, N, D], lse fp32 [B, Hq, N]); o is fp32 where
    partials merged, else the one partial's own. seg: SegmentIds with
    LOCAL q ids and local kv ids (the kv ids rotate with their
    chunks)."""
    kw = dict(scale=scale, block_sizes=block_sizes)
    qseg = seg.q if seg is not None else None
    kv = [k, v] + ([seg.kv] if seg is not None else [])
    plan = _steps(ring, causal, layout, window, k.shape[2])

    if layout != "zigzag" or not causal:
        acc = None
        for t, what in enumerate(plan):
            nxt = ring.start(kv) if t < ring.n - 1 else None
            k_cur, v_cur = kv[:2]
            ks = kv[2] if seg is not None else None
            if what == "full":
                acc = _merge(acc, flash_attention_fwd(
                    q, k_cur, v_cur, _seg(qseg, ks), causal=False, **kw))
            elif what == "diag":
                acc = _merge(acc, flash_attention_fwd(
                    q, k_cur, v_cur, _seg(qseg, ks), causal=True, offset=0,
                    **kw))
            elif what == "window":
                acc = _merge(acc, flash_attention_fwd(
                    q, k_cur, v_cur, _seg(qseg, ks), causal=True,
                    offset=t * k.shape[2], window=window, **kw))
            if nxt is not None:
                kv = ring.finish(nxt)
        return acc

    # zigzag: local shard = [chunk a1 = my, chunk a2 = 2n-1-my]
    c = q.shape[2] // 2
    qa1, qa2 = _halves(q, c)
    qs1, qs2 = _halves(qseg, c, 1) if qseg is not None else (None, None)
    acc1 = acc2 = None
    for t, what in enumerate(plan):
        nxt = ring.start(kv) if t < ring.n - 1 else None
        kb1, kb2 = _halves(kv[0], c)
        vb1, vb2 = _halves(kv[1], c)
        ks1, ks2 = _halves(kv[2], c, 1) if seg is not None else (None, None)
        # a2 = 2n-1-my always sees b1 = src fully (src < n <= a2).
        acc2 = _merge(acc2, flash_attention_fwd(
            qa2, kb1, vb1, _seg(qs2, ks1), causal=False, **kw))
        # (a1, b1): full if src < my, diag if ==, nothing if >.
        # (a2, b2): nothing if src < my, diag if ==, full if > (mirror).
        if what in ("lt", "eq"):
            acc1 = _merge(acc1, flash_attention_fwd(
                qa1, kb1, vb1, _seg(qs1, ks1), causal=what == "eq",
                offset=0 if what == "eq" else None, **kw))
        if what in ("eq", "gt"):
            acc2 = _merge(acc2, flash_attention_fwd(
                qa2, kb2, vb2, _seg(qs2, ks2), causal=what == "eq",
                offset=0 if what == "eq" else None, **kw))
        if nxt is not None:
            kv = ring.finish(nxt)
    return (torch.cat([acc1[0], acc2[0]], dim=2),
            torch.cat([acc1[1], acc2[1]], dim=2))


# --- backward ---------------------------------------------------------------


def _add(acc, x):
    """acc + x in fp32 (fp64 for fp64 inputs); None starts from x as it
    is (a ring of one returns B2 / B3's own bits)."""
    return x if acc is None else _wide(acc) + _wide(x)


def _ring_bwd_loop(q, k, v, o, lse, do, seg, ring, *, causal, layout,
                   window, scale, block_sizes):
    """(dq, dk, dv) in the inputs' dtypes. dK/dV accumulators (fp32 on
    the wire) rotate with their K/V chunks and arrive home after the
    n-th rotation; dQ stays local. The kv segment ids rotate alongside, so
    each pair masks as its forward counterpart did."""
    del block_sizes                   # B2 / B3 have fixed tiles
    qseg = seg.q if seg is not None else None
    kv = [k, v] + ([seg.kv] if seg is not None else [])
    plan = _steps(ring, causal, layout, window, k.shape[2])
    # Tags of the dK / dV messages, apart from the K / V ones.
    dtag = len(kv)

    def pair(q_, k_, v_, o_, lse_, do_, qs, ks, causal_, offset_=None,
             window_=None):
        return flash_attention_bwd(
            q_, k_, v_, o_, lse_, do_, _seg(qs, ks), causal=causal_,
            scale=scale,
            offset=(offset_ if offset_ is not None
                    else (0 if causal_ else None)),
            window=window_)

    def rotate_grads(dk_cur, dv_cur):
        """Post the rotation of the visiting chunk's dK / dV (zeros where
        this rank has added nothing to them yet)."""
        if dk_cur is None:
            dk_cur = torch.zeros(k.shape, dtype=acc_dtype(k.dtype),
                                 device=k.device)
            dv_cur = torch.zeros_like(dk_cur)
        if ring.n > 1:        # every rank sends and receives one dtype
            dk_cur, dv_cur = _wide(dk_cur), _wide(dv_cur)
        return ring.start([dk_cur, dv_cur], dtag)

    if layout != "zigzag" or not causal:
        dq = dk_cur = dv_cur = None
        for t, what in enumerate(plan):
            nxt = ring.start(kv) if t < ring.n - 1 else None
            k_cur, v_cur = kv[:2]
            ks = kv[2] if seg is not None else None
            got = None
            if what == "full":
                got = pair(q, k_cur, v_cur, o, lse, do, qseg, ks, False)
            elif what == "diag":
                got = pair(q, k_cur, v_cur, o, lse, do, qseg, ks, True)
            elif what == "window":
                got = pair(q, k_cur, v_cur, o, lse, do, qseg, ks, True,
                           t * k.shape[2], window)
            if got is not None:
                dq = _add(dq, got[0])
                dk_cur = _add(dk_cur, got[1])
                dv_cur = _add(dv_cur, got[2])
            # dK / dV rotate every step (the last rotation delivers them
            # home); the K / V payloads are dead after the final compute.
            grads = rotate_grads(dk_cur, dv_cur)
            if nxt is not None:
                kv = ring.finish(nxt)
            dk_cur, dv_cur = ring.finish(grads)
        return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)

    # --- zigzag causal backward -----------------------------------------
    c = q.shape[2] // 2
    qa1, qa2 = _halves(q, c)
    oa1, oa2 = _halves(o, c)
    la1, la2 = _halves(lse, c)
    da1, da2 = _halves(do, c)
    qs1, qs2 = _halves(qseg, c, 1) if qseg is not None else (None, None)
    dq1 = dq2 = dk_cur = dv_cur = None
    for t, what in enumerate(plan):
        nxt = ring.start(kv) if t < ring.n - 1 else None
        kb1, kb2 = _halves(kv[0], c)
        vb1, vb2 = _halves(kv[1], c)
        ks1, ks2 = _halves(kv[2], c, 1) if seg is not None else (None, None)
        dk1 = dk2 = dv1 = dv2 = None
        # Always: (a2, b1) full.
        g = pair(qa2, kb1, vb1, oa2, la2, da2, qs2, ks1, False)
        dq2, dk1, dv1 = _add(dq2, g[0]), _add(dk1, g[1]), _add(dv1, g[2])
        # The conditional pairs, mirroring the forward.
        if what in ("lt", "eq"):
            g = pair(qa1, kb1, vb1, oa1, la1, da1, qs1, ks1, what == "eq")
            dq1, dk1, dv1 = _add(dq1, g[0]), _add(dk1, g[1]), \
                _add(dv1, g[2])
        if what in ("eq", "gt"):
            g = pair(qa2, kb2, vb2, oa2, la2, da2, qs2, ks2, what == "eq")
            dq2, dk2, dv2 = _add(dq2, g[0]), _add(dk2, g[1]), \
                _add(dv2, g[2])
        dk2 = torch.zeros_like(dk1) if dk2 is None else dk2
        dv2 = torch.zeros_like(dv1) if dv2 is None else dv2
        step_dk = torch.cat([dk1, dk2], dim=2)
        step_dv = torch.cat([dv1, dv2], dim=2)
        dk_cur = _add(dk_cur, step_dk)
        dv_cur = _add(dv_cur, step_dv)
        grads = rotate_grads(dk_cur, dv_cur)
        if nxt is not None:
            kv = ring.finish(nxt)
        dk_cur, dv_cur = ring.finish(grads)
    if dq1 is None:
        dq1 = torch.zeros_like(dq2)
    dq = torch.cat([dq1, dq2], dim=2)
    return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


# --- autograd binding ---------------------------------------------------------


class _RingAttention(torch.autograd.Function):
    """The port of the JAX `custom_vjp`: the forward runs the ring
    forward and saves q, k, v, the merged O and the merged LSE; the
    backward runs the ring backward on them."""

    @staticmethod
    def forward(ctx, q, k, v, seg, ring, opts):
        o, lse = _ring_fwd_loop(q, k, v, seg, ring, **opts)
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.seg, ctx.ring, ctx.opts = seg, ring, opts
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _ring_bwd_loop(q, k, v, o, lse, do.contiguous(),
                                    ctx.seg, ctx.ring, **ctx.opts)
        return dq, dk, dv, None, None, None


def _default_group():
    """The world's group, or None (a ring of one) without a world."""
    return dist.group.WORLD if dist.is_initialized() else None


def ring_attention(q, k, v, segment_ids: SegmentIds | None = None, *,
                   axis_name: str, mesh=None,
                   causal: bool = False, layout: str = "contiguous",
                   window: int | None = None, scale=None,
                   block_sizes=None):
    """Differentiable flash attention with q / k / v sequence-sharded over
    a ring of ranks. Takes this rank's local chunks [B, H, N_local, D]
    and returns its local output chunk [B, Hq, N_local, D] in the same
    layout.

    The ring is `mesh.get_group(axis_name)`, else (no mesh) the world's
    group, else (no world) a ring of one. With
    `layout="contiguous"` the global sequence is the concatenation of the
    chunks in rank order; with `layout="zigzag"` (causal only) each rank
    holds chunks (d, 2n-1-d) of a 2n-way split (permute global arrays
    with `zigzag_order` first) and per-step causal work is balanced.

    segment_ids: SegmentIds with the LOCAL q / kv id chunks; kv ids
    rotate around the ring with their K/V chunks.
    window: sliding window in GLOBAL positions (causal, contiguous
    layout only): step t runs at causal offset t * C_local, and a chunk
    wholly behind the window launches nothing.
    `block_sizes` must be B1's compiled tile on the card.
    """
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown layout {layout!r}")
    if layout == "zigzag" and q.shape[2] % 2:
        raise ValueError(
            f"zigzag layout needs an even local sequence length (each "
            f"shard is a chunk pair); got {q.shape[2]}")
    if window is not None:
        if not causal:
            raise ValueError("ring window requires causal=True")
        if layout != "contiguous":
            raise NotImplementedError(
                "window requires layout='contiguous' — and that is not "
                "a missing feature: zigzag exists to rebalance the "
                "causal triangle (contiguous per-shard work varies "
                "from C^2/2 to N*C), but a sliding window already "
                "caps every shard's work at ~window*C_local; the "
                "bottleneck shard does irreducible work, so zigzag "
                "cannot improve the windowed ring (only shards whose "
                "global positions < window do less). Contiguous + "
                "window IS the balanced layout here.")
    _check_block_sizes(q, block_sizes)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = (mesh.get_group(axis_name) if mesh is not None
             else _default_group())
    ring = _Ring(group)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    opts = dict(causal=causal, layout=layout, window=window, scale=scale,
                block_sizes=block_sizes)
    return _RingAttention.apply(q, k, v, segment_ids, ring, opts)


def make_ring_attention(mesh, *, axis_name: str = "sp", causal: bool = False,
                        layout: str = "contiguous",
                        window: int | None = None, segmented: bool = False,
                        qkv_spec=None, **kw):
    """Ring attention over `mesh`'s `axis_name` group, as a function of
    this rank's LOCAL chunks: fn(q, k, v), or fn(q, k, v, segment_ids)
    with `segmented=True` (SegmentIds of the local [B, N_local] id
    chunks). It returns the local output chunk.

    qkv_spec names a mesh axis (or None) per dim of q / k / v, default
    (None, None, axis_name, None); the sequence dim's axis is the ring's
    and must be `axis_name`. Other axes only say that a dim is split
    across ranks (("dp", None, "sp", None): each dp rank holds its own
    batch rows, which the ring leaves alone). This is the SPMD
    counterpart of the JAX function's `shard_map` specs, which shard
    global arrays. `mesh` None rings over the world's group (a ring of
    one without a world). kw: scale, block_sizes.
    """
    if qkv_spec is None:
        qkv_spec = (None, None, axis_name, None)
    qkv_spec = tuple(qkv_spec)
    names = set(mesh.mesh_dim_names) if mesh is not None else set()
    seq_axis = qkv_spec[2] if len(qkv_spec) > 2 else None
    if seq_axis != axis_name:
        raise ValueError(f"qkv_spec {qkv_spec} must split the sequence "
                         f"dim (2) over the ring axis {axis_name!r}")
    unknown = [a for a in qkv_spec if a is not None and mesh is not None
               and a not in names]
    if unknown:
        raise ValueError(f"qkv_spec names {unknown}, not axes of the mesh "
                         f"{tuple(names)}")
    opts = dict(axis_name=axis_name, mesh=mesh, causal=causal,
                layout=layout, window=window, **kw)

    if segmented:
        def fn(q, k, v, seg):
            return ring_attention(q, k, v, seg, **opts)

        return fn

    def fn(q, k, v):
        return ring_attention(q, k, v, **opts)

    return fn
