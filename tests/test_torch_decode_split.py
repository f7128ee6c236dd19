"""The split body of B4 and B5 (csrc/decode_sm90.cuh) on the CPU: its
split plan and share arithmetic, its algorithm as a plain twin, and the
wrappers' choice of body.

(a) `split_share` / `split_plan` as pure functions: the visible range is
    covered exactly once in whole 16-token slabs, no slab starts at or
    past the length (so no page-table entry at or beyond ceil(len / ps)
    is read) or lies wholly below the window, shares differ by at most a
    slab, and the engine's shapes put at least 2 x 132 blocks on the card.
(b) The twin (`flash_decode_split_plain`, `paged_flash_decode_split_plain`:
    per-split partials merged in split order) against the JAX
    `flash_decode` / `paged_flash_decode` (interpret-mode Pallas on the
    CPU) in fp32 at max-abs 2e-5 on O and on the LSE of live rows; a row
    that sees nothing gives O = 0 and exactly LSE = INIT_M * scale.
(c) Body routing through the real wrappers with the C library replaced
    by a recorder (no card here): the body code, the split count, the
    argument count of the C signature, and the first-body counters.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops.decode import flash_decode as jax_decode
from flash_attention_tpu.ops.paged import paged_flash_decode as jax_paged
from flash_attention_tpu.ops.quant import QuantizedTensor as JQuantized
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops import decode as tdec
from flash_attention_tpu_torch.ops import paged as tpaged
from flash_attention_tpu_torch.ops.flash import INIT_M
from flash_attention_tpu_torch.ops.quant import (
    QUANT_BLOCK,
    QuantizedTensor,
    dequantize_kv,
    quantize_blocks,
)
from flash_attention_tpu_torch.utils.metrics import max_abs_error

ATOL = 2e-5
SLAB = tdec.SPLIT_SLAB


# --- (a) the split plan -----------------------------------------------------


SHARE_CASES = [
    # length, window start (None: no window), splits
    (0, None, 3), (1, None, 9), (15, None, 2), (543, None, 9),
    (640, None, 9), (1132, None, 3), (300, -3780, 5), (4400, 300, 5),
    (4600, 520, 5), (1, 5, 5), (2000, 1999, 4), (12000, 7904, 5),
    (37, 20, 64),
]


@pytest.mark.parametrize("length,start,splits", SHARE_CASES)
def test_split_shares_cover_the_visible_range_once(length, start, splits):
    lo_vis = max(start or 0, 0)
    lo_al = lo_vis // SLAB * SLAB
    shares = [tdec.split_share(length, start, sp, splits)
              for sp in range(splits)]
    covered = np.zeros(max(length, 1), np.int32)
    sizes = []
    for lo, hi in shares:
        assert lo <= hi
        covered[lo:hi] += 1
        slabs = -(-(hi - lo) // SLAB)
        sizes.append(slabs)
        if hi > lo:
            assert (lo - lo_al) % SLAB == 0
            # Every slab a block reads starts below the length (its page
            # is live) and reaches the window (none lies wholly below it).
            for pos0 in range(lo, hi, SLAB):
                assert pos0 < length and pos0 + SLAB > lo_vis
    want = np.zeros_like(covered)
    want[lo_al:length] = 1
    assert (covered == want).all()
    assert max(sizes) - min(sizes) <= 1
    # Consecutive, in split order.
    live = [s for s in shares if s[1] > s[0]]
    assert all(a[1] == b[0] for a, b in zip(live, live[1:]))


ENGINE_SHAPES = {
    # name: (batch, kv heads, rows per kv head, max positions a unit
    # sees, head dim)
    "mistral_chunked_decode": (8, 8, 4, 4096, 128),        # window 4096
    "mistral_monolithic_decode": (8, 8, 4, 47 * 256, 128),  # 47 pages
    "8b_decode": (16, 8, 4, 8 * 256, 128),
    "generate": (4, 8, 4, 640, 128),
    "generate_windowed": (4, 8, 4, 4096, 128),
    "window_starts_spread4": (8, 8, 16, 24 * 256, 128),
    "head_dim_256": (8, 8, 4, 8 * 256, 256),
}


@pytest.mark.parametrize("name", list(ENGINE_SHAPES))
def test_split_plan_fills_the_card_at_the_engine_shapes(name):
    """The engine's shapes put at least 2 x 132 blocks (1 x 132 at D =
    256, where one block holds an SM's shared memory) within 8 of the
    card's resident blocks, and never more: one wave."""
    b, hkv, rows, tokens, d = ENGINE_SHAPES[name]
    units = b * hkv * -(-rows // tdec.SPLIT_ROWS)
    splits = tdec.split_plan(units, tokens, d)
    assert 1 <= splits <= tdec.MAX_SPLITS
    resident = tdec.resident_blocks(d)
    assert resident == (132 if d == 256 else 2 * 132)
    assert resident - 8 <= units * splits <= resident


@pytest.mark.parametrize("units,tokens", [(1, 0), (1, 16), (4, 100),
                                          (512, 4096), (2, 10 ** 6)])
@pytest.mark.parametrize("d", [32, 256])
def test_split_plan_bounds(units, tokens, d):
    """At most MAX_SPLITS, never more splits than a slab per warp of the
    tokens allows, one where the units alone fill the card."""
    splits = tdec.split_plan(units, tokens, d)
    assert 1 <= splits <= tdec.MAX_SPLITS
    slabs = -(-tokens // SLAB) + 1
    assert splits == 1 or splits * tdec.SPLIT_WARPS <= slabs
    if units >= tdec.resident_blocks(d):
        assert splits == 1
    assert splits == 1 or units * splits <= tdec.resident_blocks(d)


# --- (b) the twin against the JAX kernels ----------------------------------


PAGE = 128


def _pools(rng, hkv, pages, d, lengths, width):
    """fp32 pools whose 128-token blocks differ in scale, and a shuffled
    table (entries past a sequence's live pages point at page 0)."""
    f = np.repeat(np.exp(rng.uniform(-2, 2, (2, hkv, pages, PAGE // 128,
                                             1, d))), 128, axis=4)
    x = (rng.normal(0, 0.5, (2, hkv, pages, PAGE // 128, 128, d)) * f)
    kp, vp = x.reshape(2, hkv, pages, PAGE, d).astype(np.float32)
    table = np.zeros((len(lengths), width), np.int32)
    perm = rng.permutation(np.arange(1, pages))
    at = 0
    for i, n in enumerate(lengths):
        need = -(-n // PAGE)
        table[i, :need] = perm[at:at + need]
        at += need
    return kp, vp, table


def _quant(pool, dtype):
    """Codes and scales [Hkv, P, ps / 128, D] of an fp32 pool (the port's
    quantizer), and the same bytes as JAX arrays."""
    h, n, ps, d = pool.shape
    codes, sc = quantize_blocks(
        torch.from_numpy(pool).reshape(h, n, ps // QUANT_BLOCK,
                                       QUANT_BLOCK, d), dtype, 3)
    codes = codes.reshape(h, n, ps, d)
    sc = sc[..., 0, :].contiguous()
    jdt = {torch.int8: jnp.int8, torch.float8_e4m3fn: jnp.float8_e4m3fn,
           torch.float8_e5m2: jnp.float8_e5m2}[dtype]
    jcodes = jnp.asarray(codes.view(torch.uint8).numpy()).view(jdt)
    return (codes, sc), (jcodes, jnp.asarray(sc.numpy()))


PAGED_CASES = {
    # name: (lengths, storage, window kwargs, splits, rows per kv head)
    "dense": ([300, 0, 1, 512], None, {}, 3, 2),
    "int8": ([512, 300, 0], torch.int8, {}, 4, 2),
    "fold": ([300, 130, 512], "fold", {}, 5, 2),
    "e4m3": ([257, 1, 512], torch.float8_e4m3fn, {}, 3, 2),
    "window_starts_spread4": ([500, 300, 130, 0], None,
                              dict(window_starts=[250, -40, 129, -3],
                                   qpos_spread=4), 3, 8),
    "more_splits_than_slabs": ([17, 1, 0, 40], None, {}, 9, 2),
}


@pytest.mark.parametrize("name", list(PAGED_CASES))
def test_paged_split_twin_matches_jax(name):
    lengths, store, kw, splits, rows = PAGED_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    hkv, d, pages, width = 2, 64, 14, 4
    b = len(lengths)
    kp, vp, table = _pools(rng, hkv, pages, d, lengths, width)
    q = rng.normal(0, 1, (b, hkv * rows, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    scale = 1.0 / math.sqrt(d)
    jkw, tkw = dict(kw), dict(kw)
    starts = None
    if "window_starts" in kw:
        starts = np.asarray(kw["window_starts"], np.int32)
        jkw["window_starts"] = jnp.asarray(starts)
        tkw["window_starts"] = torch.from_numpy(starts)
    fold = store == "fold"
    if store is None:
        jk, jv = jnp.asarray(kp), jnp.asarray(vp)
        tk, tv = torch.from_numpy(kp), torch.from_numpy(vp)
        jsc, tsc = {}, {}
    else:
        dt = torch.int8 if fold else store
        (tk, tks), (jk, jks) = _quant(kp, dt)
        (tv, tvs), (jv, jvs) = _quant(vp, dt)
        jsc = dict(k_scales=jks, v_scales=jvs, fold_scales=fold)
        tsc = dict(k_scales=tks, v_scales=tvs, fold_scales=fold)
    o_j, lse_j = jax_paged(jnp.asarray(q), jk, jv, jnp.asarray(table),
                           jnp.asarray(lens), return_lse=True, **jkw, **jsc)
    o_t, lse_t = tpaged.paged_flash_decode_split_plain(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(lens), scale=scale, splits=splits,
        starts=None if starts is None else torch.from_numpy(starts),
        qpos_spread=kw.get("qpos_spread", 1), **tsc)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    assert max_abs_error(o_t, o_j) <= ATOL
    live = lse_j > INIT_M * scale / 2
    assert max_abs_error(lse_t[torch.from_numpy(live)], lse_j[live]) <= ATOL
    dead = ~live
    assert bool((o_t[torch.from_numpy(dead)] == 0).all())
    assert bool((lse_t[torch.from_numpy(dead)] ==
                 torch.tensor(INIT_M * scale, dtype=torch.float32)).all())
    if name in ("dense", "window_starts_spread4", "more_splits_than_slabs"):
        assert dead.any()   # the length-0 row (and, windowed, empty rows)


CONTIG_CASES = {
    # name: (lengths, storage, window, splits)
    "dense": ([200, 0, 1, 256], None, None, 4),
    "window": ([256, 100, 30, 0], None, 64, 3),
    "int8_window": ([256, 200], torch.int8, 100, 5),
}


@pytest.mark.parametrize("name", list(CONTIG_CASES))
def test_contiguous_split_twin_matches_jax(name):
    lengths, store, window, splits = CONTIG_CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    b, hq, hkv, s, d = len(lengths), 8, 2, 256, 64
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, s, d)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    scale = 1.0 / math.sqrt(d)
    if store is None:
        jk, jv = jnp.asarray(k), jnp.asarray(v)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    else:
        # The caches as [B * Hkv, 1, S, D] pools of one page of S tokens.
        (tkc, tks), (jkc, jks) = _quant(k.reshape(b * hkv, 1, s, d), store)
        (tvc, tvs), (jvc, jvs) = _quant(v.reshape(b * hkv, 1, s, d), store)
        shp, sshp = (b, hkv, s, d), (b, hkv, s // QUANT_BLOCK, d)
        jk = JQuantized(values=jkc.reshape(shp), scales=jks.reshape(sshp))
        jv = JQuantized(values=jvc.reshape(shp), scales=jvs.reshape(sshp))
        tk = dequantize_kv(QuantizedTensor(
            tkc.reshape(shp), tks.reshape(sshp)), torch.float32)
        tv = dequantize_kv(QuantizedTensor(
            tvc.reshape(shp), tvs.reshape(sshp)), torch.float32)
    o_j = np.asarray(jax_decode(jnp.asarray(q), jk, jv, jnp.asarray(lens),
                                window=window))
    lt = torch.from_numpy(lens)
    o_t, lse_t = tdec.flash_decode_split_plain(
        torch.from_numpy(q), tk, tv, lt, scale=scale, splits=splits,
        return_lse=True, starts=None if window is None else lt - window)
    live = lens > 0
    assert max_abs_error(o_t[torch.from_numpy(live)], o_j[live]) <= ATOL
    assert bool((o_t[torch.from_numpy(~live)] == 0).all())
    assert bool((lse_t[torch.from_numpy(~live)] ==
                 torch.tensor(INIT_M * scale, dtype=torch.float32)).all())
    # The one-split twin is the plain version's arithmetic.
    o_1 = tdec.flash_decode_split_plain(
        torch.from_numpy(q), tk, tv, lt, scale=scale, splits=1,
        starts=None if window is None else lt - window)
    o_p = tdec.flash_decode_plain(
        torch.from_numpy(q), tk, tv, lt, scale=scale,
        starts=None if window is None else lt - window)
    assert max_abs_error(o_1, o_p) <= 1e-6


# --- (c) body routing through the wrappers ----------------------------------


class _Recorder:
    """Stands in for the C library: records each entry point's arguments
    and returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(_cuda, "lib", lambda: rec)
    monkeypatch.setattr(_cuda, "stream_handle", lambda device: 7)
    monkeypatch.setattr(
        _cuda, "scratch",
        lambda device, stream, n, c: (torch.zeros(n), torch.zeros(
            c, dtype=torch.int32)))
    tdec._plans.clear()   # plans hold the scratch these stand-ins give
    yield rec
    tdec._plans.clear()


ROUTES = [
    # q dtype, storage, D, rows per kv head, page size, body
    (torch.bfloat16, "dense", 128, 4, 256, "split"),
    (torch.float16, "dense", 64, 2, 128, "split"),
    (torch.bfloat16, "dense", 32, 64, 16, "split"),
    (torch.bfloat16, "dense", 256, 16, 48, "split"),
    (torch.bfloat16, "int8", 128, 4, 256, "split"),
    (torch.float16, "e4m3", 256, 32, 128, "split"),
    (torch.bfloat16, "e5m2", 32, 1, 384, "split"),
    (torch.bfloat16, "dense", 128, 4, 40, "first"),
    (torch.float16, "dense", 64, 8, 8, "first"),
    (torch.float32, "dense", 128, 4, 256, "first"),
    (torch.float32, "int8", 64, 16, 128, "first"),
]
STORES = {"int8": torch.int8, "e4m3": torch.float8_e4m3fn,
          "e5m2": torch.float8_e5m2}


@pytest.mark.parametrize("dt,store,d,rows,ps,body", ROUTES)
def test_paged_body_routing(recorder, dt, store, d, rows, ps, body):
    b, hkv, width = 3, 2, 4
    q = torch.zeros(b, hkv * rows, d, dtype=dt)
    kw = {}
    pool_dt = dt if store == "dense" else STORES[store]
    pools = [torch.zeros(hkv, 6, ps, d, dtype=pool_dt) for _ in "kv"]
    if store != "dense":
        kw = dict(k_scales=torch.ones(hkv, 6, ps // 128, d),
                  v_scales=torch.ones(hkv, 6, ps // 128, d))
    table = torch.zeros(b, width, dtype=torch.int32)
    lengths = torch.tensor([5, 0, 3], dtype=torch.int32)
    first = tpaged.paged_decode_first_body_launches
    fp32 = tpaged.paged_decode_fp32_launches
    tpaged._paged_decode_cuda(q, *pools, table, lengths, scale=0.1, **kw)
    (name, args), = recorder.calls
    assert name == "fa_paged_decode"
    assert len(args) == len(_cuda._SIGNATURES[name])
    body_code, splits, ws, counters = args[-5:-1]
    assert body_code == tdec.BODY_CODES[body]
    assert tdec.decode_body(dt, ps) == body
    units = b * hkv * -(-rows // tdec.SPLIT_ROWS)
    if body == "split":
        assert splits == tdec.split_plan(units, width * ps, d)
        assert (ws is None) == (counters is None) == (splits == 1)
    else:
        assert splits == 1 and ws is None and counters is None
    assert tpaged.paged_decode_first_body_launches - first == (
        body == "first" and dt != torch.float32)
    assert tpaged.paged_decode_fp32_launches - fp32 == (dt == torch.float32)


@pytest.mark.parametrize("dt,store,window,body", [
    (torch.bfloat16, "dense", None, "split"),
    (torch.float16, "int8", 100, "split"),
    (torch.bfloat16, "e4m3", None, "split"),
    (torch.float32, "dense", 64, "first"),
    (torch.float32, "e5m2", None, "first"),
])
def test_decode_body_routing(recorder, dt, store, window, body):
    b, hkv, rows, s, d = 4, 2, 4, 640, 64
    q = torch.zeros(b, hkv * rows, d, dtype=dt)
    cache_dt = dt if store == "dense" else STORES[store]
    k = torch.zeros(b, hkv, s, d, dtype=cache_dt)
    kw = {}
    if store != "dense":
        kw = dict(k_scales=torch.ones(b, hkv, s // 128, d),
                  v_scales=torch.ones(b, hkv, s // 128, d))
    lengths = torch.tensor([5, 0, 3, 640], dtype=torch.int32)
    first = tdec.decode_first_body_launches
    tdec._flash_decode_cuda(q, k, k, lengths, scale=0.1, window=window,
                            **kw)
    (name, args), = recorder.calls
    assert name == "fa_decode"
    assert len(args) == len(_cuda._SIGNATURES[name])
    body_code, splits, ws, counters = args[-5:-1]
    assert body_code == tdec.BODY_CODES[body]
    if body == "split":
        units = b * hkv
        assert splits == tdec.split_plan(units, min(s, window or s), d) > 1
        assert ws is not None and counters is not None
    else:
        assert splits == 1 and ws is None
    assert tdec.decode_first_body_launches == first


def test_paged_integer_window_bounds_the_split_plan(recorder):
    """An integer window bounds the positions a unit sees (the table's
    width does without one), as paged_flash_decode passes it to the
    launch; window starts alone do not."""
    b, hkv, rows, d, ps, width = 2, 2, 4, 64, 256, 40
    q = torch.zeros(b, hkv * rows, d, dtype=torch.bfloat16)
    pools = [torch.zeros(hkv, 80, ps, d, dtype=torch.bfloat16)
             for _ in "kv"]
    table = torch.zeros(b, width, dtype=torch.int32)
    lengths = torch.tensor([9000, 100], dtype=torch.int32)
    for window in (64, None):
        tpaged._paged_decode_cuda(q, *pools, table, lengths, scale=0.1,
                                  starts=lengths - 64, window=window)
    (_, with_window), (_, with_starts) = recorder.calls
    units = b * hkv
    assert with_window[-4] == tdec.split_plan(units, 64, d)
    assert with_starts[-4] == tdec.split_plan(units, width * ps, d)
