"""Port parity: the backward's window and segment-id branches (B2/B3's
function), head dims 32 and 256 through B1-B3, and B4 / B5 at more than
16 query rows per kv head, against the JAX package.

Seeded numpy inputs and cotangent go through both packages in fp32. The
JAX side is jax.grad through `flash_attention` (its custom_vjp, Pallas in
interpret mode on the CPU, the 128 blocks of tests/test_window.py and
tests/test_segments.py) and the interpret-mode decode kernels; the
port's side is torch.autograd through `flash_attention` and the decode
wrappers, whose CPU tensors take the plain versions. Tolerance: max-abs
<= 2e-5 on every gradient, output and live LSE (inputs ~N(0, 0.02^2),
cotangent N(0, 1), gradients of order 0.1; fp32 accumulation-order noise
here is ~1e-7); rows that see nothing are exactly 0 in both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.config import BlockSizes
from flash_attention_tpu.ops.decode import flash_decode as jax_decode
from flash_attention_tpu.ops.flash import SegmentIds as JaxSegmentIds
from flash_attention_tpu.ops.flash import flash_attention as jax_flash
from flash_attention_tpu.ops.paged import paged_flash_decode as jax_paged
from flash_attention_tpu_torch.ops import decode as tdec
from flash_attention_tpu_torch.ops import flash as tflash
from flash_attention_tpu_torch.ops import paged as tpaged
from flash_attention_tpu_torch.utils.metrics import max_abs_error

ATOL = 2e-5
SMALL = BlockSizes(block_q=128, block_kv=128, block_q_dq=128,
                   block_kv_dq=128, block_q_dkv=128, block_kv_dkv=128)


def _inputs(seed, b, hq, hkv, nq, nk, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 0.02, (b, hq, nq, d)).astype(np.float32)
    k = rng.normal(0, 0.02, (b, hkv, nk, d)).astype(np.float32)
    v = rng.normal(0, 0.02, (b, hkv, nk, d)).astype(np.float32)
    ct = rng.normal(0, 1.0, (b, hq, nq, d)).astype(np.float32)
    return q, k, v, ct


def make_segments(rng, batch, n, max_docs=4):
    """Monotone segment ids, n split into <= max_docs documents (the
    generator of tests/test_segments.py)."""
    ids = np.zeros((batch, n), np.int32)
    for b in range(batch):
        cuts = np.sort(rng.choice(
            np.arange(1, n), size=rng.integers(1, max_docs), replace=False))
        ids[b] = np.searchsorted(cuts, np.arange(n), side="right")
    return ids


def _both(q, k, v, ct, seg_q=None, seg_kv=None, **kw):
    """(out, grads) of the JAX package and of the port."""
    jseg = None if seg_q is None else JaxSegmentIds(jnp.asarray(seg_q),
                                                    jnp.asarray(seg_kv))

    def jloss(q, k, v):
        o = jax_flash(q, k, v, jseg, block_sizes=SMALL, **kw)
        return jnp.sum(o * ct), o

    (_, oj), gj = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(
        *(jnp.asarray(x) for x in (q, k, v)))
    tseg = None if seg_q is None else tflash.SegmentIds(
        torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    ot = tflash.flash_attention(qt, kt, vt, tseg, **kw)
    gt = torch.autograd.grad((ot * torch.from_numpy(ct)).sum(),
                             (qt, kt, vt))
    return (np.asarray(oj), [np.asarray(g) for g in gj]), (ot.detach(), gt)


def _assert_match(jax_side, port_side):
    (oj, gj), (ot, gt) = jax_side, port_side
    assert max_abs_error(ot, oj) <= ATOL
    for name, a, ref in zip(("dq", "dk", "dv"), gt, gj):
        assert a.shape == ref.shape, name
        assert max_abs_error(a, ref) <= ATOL, name


@pytest.mark.parametrize("window, d", [
    pytest.param(96, 64, id="96"), pytest.param(256, 64, id="256"),
    pytest.param(96, 128, id="96-d128")])
def test_window_gradients_match_jax(window, d):
    """tests/test_window.py:38: causal, window 96 / 256, T = 384; window
    96 also at the training head dim 128."""
    q, k, v, ct = _inputs(window, 1, 2, 2, 384, 384, d)
    _assert_match(*_both(q, k, v, ct, causal=True, window=window))


def test_window_gradients_gqa_offset_match_jax():
    """A window over Nq < Nk (offset Nk - Nq) with GQA 4/2."""
    q, k, v, ct = _inputs(7, 1, 4, 2, 128, 384, 64)
    _assert_match(*_both(q, k, v, ct, causal=True, window=200))


def test_segment_gradients_match_jax():
    """tests/test_segments.py:72: packed documents, causal."""
    q, k, v, ct = _inputs(3, 1, 2, 2, 256, 256, 64)
    seg = make_segments(np.random.default_rng(42), 1, 256)
    _assert_match(*_both(q, k, v, ct, seg, seg, causal=True))


@pytest.mark.parametrize("causal", [False, True])
def test_segment_gradients_batched_match_jax(causal):
    """Two rows of different packings, with and without causal."""
    q, k, v, ct = _inputs(4, 2, 2, 1, 256, 256, 64)
    seg = make_segments(np.random.default_rng(5), 2, 256)
    _assert_match(*_both(q, k, v, ct, seg, seg, causal=causal))


def test_segments_compose_with_window_match_jax():
    """tests/test_segments.py:91: segment ids and window 100, forward
    and gradients."""
    q, k, v, ct = _inputs(5, 1, 2, 2, 384, 384, 64)
    seg = make_segments(np.random.default_rng(9), 1, 384)
    _assert_match(*_both(q, k, v, ct, seg, seg, causal=True, window=100))


def test_fully_masked_segment_rows_zero_output_and_grads():
    """tests/test_segments.py:117: a q document absent from kv gives O = 0
    and zero gradients, in both packages; one row of live documents
    beside it matches JAX."""
    q, k, v, ct = _inputs(6, 2, 2, 2, 128, 128, 64)
    seg_q = np.stack([np.full(128, 7, np.int32),
                      (np.arange(128) >= 50).astype(np.int32)])
    seg_kv = np.stack([np.zeros(128, np.int32),
                       (np.arange(128) >= 50).astype(np.int32)])
    (oj, gj), (ot, gt) = _both(q, k, v, ct, seg_q, seg_kv)
    _assert_match((oj, gj), (ot, gt))
    assert bool((ot[0] == 0).all()) and np.all(oj[0] == 0)
    assert bool((gt[0][0] == 0).all()) and np.all(gj[0][0] == 0)
    for g, ref in zip(gt[1:], gj[1:]):           # dk, dv of row 0
        assert bool((g[0] == 0).all()) and np.all(ref[0] == 0)


@pytest.mark.parametrize("d", [32, 256])
@pytest.mark.parametrize("mask", ["causal", "window_segments"])
def test_head_dims_32_256_match_jax(d, mask):
    """B1-B3's plain versions at the head dims the card now builds."""
    q, k, v, ct = _inputs(d, 1, 2, 1, 256, 256, d)
    if mask == "causal":
        _assert_match(*_both(q, k, v, ct, causal=True))
    else:
        seg = make_segments(np.random.default_rng(d), 1, 256)
        _assert_match(*_both(q, k, v, ct, seg, seg, causal=True, window=90))


def test_bwd_plain_masks_match_autograd_of_masked_reference():
    """The plain backward under window + segment ids equals
    torch.autograd through an exact masked softmax (no JAX)."""
    q, k, v, ct = (torch.from_numpy(x)
                   for x in _inputs(8, 1, 4, 2, 150, 150, 64))
    seg = torch.from_numpy(make_segments(np.random.default_rng(1), 1, 150))
    scale, window = 0.125, 40
    visible = tflash._visible_mask(150, 150, True, 0, "cpu", window,
                                   tflash.SegmentIds(seg, seg))

    def reference(q, k, v):
        kk, vv = (x.repeat_interleave(2, dim=1) for x in (k, v))
        s = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale
        p = torch.softmax(s.masked_fill(~visible, float("-inf")), dim=-1)
        return torch.einsum("bhqk,bhkd->bhqd", p, vv)

    def grads(fn):
        qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
        return torch.autograd.grad((fn(qt, kt, vt) * ct).sum(),
                                   (qt, kt, vt))

    got = grads(lambda q, k, v: tflash.flash_attention(
        q, k, v, tflash.SegmentIds(seg, seg), causal=True, scale=scale,
        window=window))
    for a, ref in zip(got, grads(reference)):
        assert max_abs_error(a, ref) <= ATOL


def test_bwd_cost_counts_window_and_segment_pairs():
    (f2, b2), (f3, b3) = tflash.bwd_cost(1, 2, 1, 8, 8, 64, True, 2,
                                         window=2)
    pairs = 2 * 15                               # 1 + 2 * 7 per head
    assert f2 == 6 * 64 * pairs and f3 == 8 * 64 * pairs
    assert b2 == 2 * 64 * (3 * 2 * 8 + 2 * 8) + 8 * 2 * 8
    assert b3 == 2 * 64 * (2 * 2 * 8 + 2 * 8 + 2 * 8) + 8 * 2 * 8
    seg = tflash.SegmentIds(torch.tensor([[0, 0, 1, 1]], dtype=torch.int32),
                            torch.tensor([[0, 0, 1, 1]], dtype=torch.int32))
    (f2, _), _ = tflash.bwd_cost(1, 1, 1, 4, 4, 64, True, 2,
                                 segment_ids=seg)
    assert f2 == 6 * 64 * 6                      # (0,0) (1,0) (1,1) x 2


# --- B4 / B5 at more than 16 rows per kv head ------------------------------


@pytest.mark.parametrize("hq, spread", [(32, 1), (16, 4)],
                         ids=["group32", "group16x4"])
def test_paged_more_than_16_rows_match_jax(hq, spread):
    """B4's plain version at 32 and 64 rows per kv head (a group of 32,
    a group of 16 with 4 folded positions) with window starts, against
    interpret-mode `paged_flash_decode`."""
    rng = np.random.default_rng(hq + spread)
    page, pages, width, hkv, d = 16, 24, 4, 1, 64
    lengths = np.array([0, 5, 40, 61], np.int32)
    kp = rng.normal(0, 1, (hkv, pages, page, d)).astype(np.float32)
    vp = rng.normal(0, 1, (hkv, pages, page, d)).astype(np.float32)
    q = rng.normal(0, 1, (len(lengths), hq, d)).astype(np.float32)
    table = np.zeros((len(lengths), width), np.int32)
    perm, at = rng.permutation(np.arange(1, pages)), 0
    for i, n in enumerate(lengths):
        need = -(-int(n) // page)
        table[i, :need] = perm[at:at + need]
        at += need
    starts = np.array([0, -3, 20, 50], np.int32)
    args = (q, kp, vp, table, lengths)
    oj, lj = jax_paged(*(jnp.asarray(x) for x in args),
                       window_starts=jnp.asarray(starts),
                       qpos_spread=spread, return_lse=True)
    ot, lt = tpaged.paged_flash_decode(
        *(torch.from_numpy(x) for x in args),
        window_starts=torch.from_numpy(starts), qpos_spread=spread,
        return_lse=True)
    assert ot.shape == (len(lengths), hq, d)
    assert max_abs_error(ot, np.asarray(oj)) <= ATOL
    live = lengths > 0
    assert max_abs_error(lt[live], np.asarray(lj)[live]) <= ATOL
    assert bool((ot[0] == 0).all()) and np.all(np.asarray(oj)[0] == 0)


@pytest.mark.parametrize("hq, hkv", [(32, 1), (64, 2)],
                         ids=["group32", "group32_2heads"])
def test_decode_more_than_16_rows_match_jax(hq, hkv):
    """B5's plain version at a GQA group of 32 (llama3_70b's 8 x 4
    folded), with and without a window, against `flash_decode`."""
    rng = np.random.default_rng(hq * hkv)
    s, d = 128, 64
    lengths = np.array([0, 1, 77, s], np.int32)
    q = rng.normal(0, 1, (len(lengths), hq, d)).astype(np.float32)
    k = rng.normal(0, 1, (len(lengths), hkv, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (len(lengths), hkv, s, d)).astype(np.float32)
    args = (q, k, v, lengths)
    for window in (None, 30):
        want = np.asarray(jax_decode(*(jnp.asarray(x) for x in args),
                                     window=window))
        got = tdec.flash_decode(*(torch.from_numpy(x) for x in args),
                                window=window)
        assert max_abs_error(got, want) <= ATOL
        assert bool((got[0] == 0).all()) and np.all(want[0] == 0)
