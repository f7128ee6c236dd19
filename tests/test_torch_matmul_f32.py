"""B6, B7, B8 and B9 on fp32 activations: the launch plan of their
register-blocked FFMA body (csrc/matmul_f32.cuh), the arguments each
wrapper hands the kernel, and a plain twin of the body's summation
order held to the JAX kernels.

Plan: `quant_matmul.ffma_plan` gives the rows a block owns, the K
splits and the K chunk. The splits cover [0, K) once in multiples of 128
(an int4 group lies in one split), none empty, and put at least two
blocks on each SM at chip_smoke.py's fp32 shapes wherever K has the
128-row groups for it.

Twin: `_twin` sums as the body does -- per split and slice (the tile
rows fix the K step and the slices, `_cfg` mirrors the body's Cfg) each
step's fp32 products over the slice's K rows, added to the slice's sums
in step order; the slices added in slice order, the splits in split
order, B6's channel scale on the sum. Seeded numpy inputs go
through the JAX kernels (Pallas in interpret mode on the CPU,
tests/conftest.py) on fp32 activations and through the twin at ragged
shapes (M 1 / 13 / 70, K 256 / 384, F 130 / 200) with a plan for two
SMs, so every case has more than one split. Tolerance: the repo's fp32
gate (utils/metrics.py `verify`, 2% symmetric relative error) and the
JAX tests' rtol = atol = 2e-4 (tests/test_quant_weights.py); the twin
also within 2e-4 of the port's plain version.

Launch: a stand-in for the kernel library records what each wrapper's
launch path passes to fa_quant_matmul / fa_grouped_matmul on fp32
tensors: the FFMA body's code, its plan, the scratch when there is more
than one split, and one count in matmul_ffma_launches a launch.
"""

import importlib.util
import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import quantized as jq
from flash_attention_tpu.ops import grouped as jg
from flash_attention_tpu.ops import quant_matmul as jqm
from flash_attention_tpu_torch.models import quantized as tq
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops import grouped as tg
from flash_attention_tpu_torch.ops import quant_matmul as tqm
from flash_attention_tpu_torch.ops.quant import widen_scaled
from flash_attention_tpu_torch.utils.metrics import verify

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-4)
SMS = 2                      # a plan for two SMs: splits > 1 at small K
FP8 = {"e4m3": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}
BLOCKS = dict(block_m=128, block_f=128, block_k=128)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP = _chip_smoke()
CARD_SHAPES = sorted(set(CHIP.FP32_MATMUL_SHAPES + CHIP.FP32_GROUPED_SHAPES
                         + ((16, 4096, 4096),)))   # + fp32_api's
RAGGED = [(1, 256, 130), (13, 384, 200), (70, 256, 200), (70, 384, 130)]


def _ranges(k, splits, k_chunk):
    return [(s * k_chunk, min(k, (s + 1) * k_chunk)) for s in range(splits)]


# --- the plan ----------------------------------------------------------------


@pytest.mark.parametrize("sms", [tqm.SM_COUNT, SMS])
@pytest.mark.parametrize("m,k,f", CARD_SHAPES + RAGGED + [(200, 1000, 64),
                                                          (64, 128, 8)])
def test_ffma_plan_covers_k_once(m, k, f, sms):
    """The splits cover [0, K) exactly once in ranges of k_chunk rows, a
    multiple of 128, none empty; the tile rows are the fewest of 16 /
    32 / 64 / 128 that hold M."""
    rows, splits, k_chunk = tqm.ffma_plan(m, k, f, sms=sms)
    assert rows in tqm.FFMA_TILE_ROWS
    assert rows >= m or rows == 128
    assert rows == 16 or rows // 2 < m
    assert k_chunk > 0 and k_chunk % tqm.SPLIT_ROWS == 0
    covered = np.zeros(k, np.int32)
    for lo, hi in _ranges(k, splits, k_chunk):
        assert lo < hi and lo % tqm.INT4_GROUP == 0
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("m,k,f", CARD_SHAPES)
def test_ffma_plan_fills_the_card_at_the_fp32_shapes(m, k, f):
    """At chip_smoke.py's fp32 shapes the grid puts at least two blocks
    on each of the 132 SMs, or K is split into every 128-row group."""
    rows, splits, _ = tqm.ffma_plan(m, k, f)
    tiles = -(-m // rows) * -(-f // tqm.FFMA_TILE_F)
    assert (tiles * splits >= 2 * tqm.SM_COUNT
            or splits == -(-k // tqm.SPLIT_ROWS))


def test_ffma_plan_at_the_fp32_shapes():
    """The plans the card runs: 16-row tiles split K at decode rows, the
    1024-row w_gate product needs no split, its w_down takes two."""
    assert tqm.ffma_plan(16, 4096, 14336) == (16, 3, 1664)
    assert tqm.ffma_plan(16, 14336, 4096) == (16, 9, 1664)
    assert tqm.ffma_plan(1024, 4096, 14336)[:2] == (128, 1)
    assert tqm.ffma_plan(1024, 14336, 4096)[:2] == (128, 2)
    assert tqm.ffma_plan(0, 0, 5)[1] == 1


# The rings of csrc/matmul_f32.cuh's Cfg: {(tile rows, storage): stages}.
STAGES = {(16, "dense"): 3, (16, "byte"): 3, (16, "int4"): 5,
          (32, "dense"): 5, (32, "byte"): 6, (32, "int4"): 6,
          (64, "dense"): 4, (64, "byte"): 6, (64, "int4"): 6,
          (128, "dense"): 3, (128, "byte"): 3, (128, "int4"): 4}
SMEM_BUDGET = 232448 - 1024    # a block's 227 KB, less 1 KB


def _cfg(rows, storage):
    """Cfg<BM, W>: 256 threads in slices of 16 x rows / 8, K steps of 64
    rows (128 at 16 rows), x [rows][step + 4] fp32, the weight at its
    storage width ([step][128] fp32, bytes, or packed int4) and a scale
    row, two fp32 operand tiles for a one-byte or int4 weight; the
    deepest ring of 3-6 stages the budget holds; the slices' sums
    [slices][rows][128] fp32 reuse the ring."""
    slices = 256 // (16 * (rows // 8))
    step = 128 if rows == 16 else 64
    stage = 4 * rows * (step + 4)
    if storage == "dense":
        stage += 4 * step * 128
        operand = 0
    else:
        stage += (step // 2 if storage == "int4" else step) * 128 + 4 * 128
        operand = 2 * 4 * step * 128
    stages = next(n for n in (6, 5, 4, 3)
                  if n * stage + operand <= SMEM_BUDGET or n == 3)
    return dict(slices=slices, step=step, per_slice=step // slices,
                stages=stages, smem=stages * stage + operand,
                red=4 * slices * rows * 128)


@pytest.mark.parametrize("storage", ["dense", "byte", "int4"])
@pytest.mark.parametrize("rows", tqm.FFMA_TILE_ROWS)
def test_ffma_tile_config_fits_one_block_an_sm(rows, storage):
    """Every tile's ring fits the shared memory of one block an SM, its
    steps split evenly over the slices in whole float4s of K, an int4
    group (128 rows) holds whole steps, and the slices' sums fit in
    shared memory for the epilogue."""
    c = _cfg(rows, storage)
    assert c["stages"] == STAGES[rows, storage]
    assert c["smem"] <= SMEM_BUDGET
    assert c["per_slice"] % 4 == 0 and 128 % c["step"] == 0
    assert c["red"] <= SMEM_BUDGET and c["slices"] * rows == 128


# --- the twin of the body's summation order ----------------------------------


def _twin(x, w, m, k, f):
    """x [m, k] @ w [k, f] in fp32 as the FFMA body sums it under
    ffma_plan(m, k, f, sms=SMS): per split and slice, each step's
    products summed from zero and added to the slice's sums in step
    order; the slices added in slice order, the splits in split
    order."""
    rows, splits, k_chunk = tqm.ffma_plan(m, k, f, sms=SMS)
    c = _cfg(rows, "dense")
    step, per_slice = c["step"], c["per_slice"]
    out = torch.zeros(x.shape[0], f)
    for lo, hi in _ranges(k, splits, k_chunk):
        block = torch.zeros(x.shape[0], f)
        for g in range(c["slices"]):
            sums = torch.zeros(x.shape[0], f)
            for k0 in range(lo, hi, step):
                sel = slice(k0 + g * per_slice, min(hi, k0 + (g + 1)
                                                    * per_slice))
                sums = sums + x[:, sel] @ w[sel]
            block = block + sums
        out = out + block
    return out


def _gate(twin, want, plain):
    rep = verify(twin, want)
    assert rep.passed, str(rep)
    np.testing.assert_allclose(twin.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(twin.numpy(), plain.numpy(), **TOL)


def _case(seed, m, k, f):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.05, (k, f)).astype(np.float32)
    assert tqm.ffma_plan(m, k, f, sms=SMS)[1] > 1
    return x, w


@pytest.mark.parametrize("name", ["int8", "e4m3"])
@pytest.mark.parametrize("m,k,f", RAGGED)
def test_b6_twin_matches_jax(m, k, f, name):
    jd, td = FP8.get(name, (jnp.int8, torch.int8))
    x, w = _case(m + k + f, m, k, f)
    qj, sj = jqm.quantize_weight(w, dtype=jd)
    want = np.asarray(jqm.quant_matmul(jnp.asarray(x), qj, sj))
    qt, st = tqm.quantize_weight(w, dtype=td)
    xt = torch.from_numpy(x)
    twin = _twin(xt, widen_scaled(qt, torch.ones(()), torch.float32),
                 m, k, f) * st
    _gate(twin, want, tqm.quant_matmul(xt, qt, st))


@pytest.mark.parametrize("m,k,f", RAGGED)
def test_b7_twin_matches_jax(m, k, f):
    x, w = _case(2 * m + k + f, m, k, f)
    pj, sj = jqm.quantize_weight_int4(w)
    want = np.asarray(jqm.int4_matmul(jnp.asarray(x), pj, sj))
    pt, st = tqm.quantize_weight_int4(w)
    xt = torch.from_numpy(x)
    twin = _twin(xt, tqm.int4_dequant(pt, st, torch.float32), m, k, f)
    _gate(twin, want, tqm.int4_matmul(xt, pt, st))


@pytest.mark.parametrize("m,k,f", RAGGED)
def test_b8_twin_matches_jax(m, k, f):
    x, w = _case(3 * m + k + f, m, k, f)
    want = np.asarray(jqm.dense_matmul(jnp.asarray(x), jnp.asarray(w)))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    _gate(_twin(xt, wt, m, k, f), want, tqm.dense_matmul(xt, wt))


def _grouped_twin(x, sizes, weight_of, f):
    """B9's twin: each expert's rows against its weight (the other
    experts add exact zeros to those rows in the body), rows outside
    every expert zero."""
    m, k = x.shape
    offs = np.concatenate([[0], np.cumsum(sizes)])
    out = torch.zeros(m, f)
    for g in range(len(sizes)):
        lo, hi = int(offs[g]), int(min(offs[g + 1], m))
        if lo < hi:
            out[lo:hi] = _twin(x[lo:hi], weight_of(g), m, k, f)
    return out


@pytest.mark.parametrize("storage", ["dense", "int4"])
@pytest.mark.parametrize("m,k,f", RAGGED[1:])
def test_b9_twin_matches_jax(m, k, f, storage):
    rng = np.random.default_rng(4 * m + k + f)
    e = 4
    x = rng.normal(0, 1, (m, k)).astype(np.float32)
    w = rng.normal(0, 0.05, (e, k, f)).astype(np.float32)
    cuts = np.sort(rng.integers(0, m + 1, e - 1))
    sizes = np.diff(np.concatenate([[0], cuts, [m]])).astype(np.int32)
    xt, st = torch.from_numpy(x), torch.from_numpy(sizes)
    if storage == "dense":
        want = np.asarray(jg.grouped_matmul(
            jnp.asarray(x), jnp.asarray(sizes), jnp.asarray(w), **BLOCKS))
        wt = torch.from_numpy(w)
        twin = _grouped_twin(xt, sizes, lambda g: wt[g], f)
        plain = tg.grouped_matmul(xt, st, wt)
    else:
        stack = jq.quantize_expert_stack(w, dtype="int4")
        want = np.asarray(jg.grouped_int4_matmul(
            jnp.asarray(x), jnp.asarray(sizes), stack.packed, stack.scales,
            **BLOCKS))
        mine = tq.quantize_expert_stack(torch.from_numpy(w), dtype="int4")
        twin = _grouped_twin(
            xt, sizes, lambda g: tqm.int4_dequant(
                mine.packed[g], mine.scales[g], torch.float32), f)
        plain = tg.grouped_int4_matmul(xt, st, mine.packed, mine.scales)
    _gate(twin, want, plain)


# --- routing and launch arguments --------------------------------------------


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
    return rec


def _launched(rec, name, m, k, f):
    (got, args), = rec.calls
    assert got == name
    assert len(args) == len(_cuda._SIGNATURES[name])
    body, rows, splits, k_chunk, ws, counters = args[-7:-1]
    assert body == tqm.BODY_CODES["ffma"] == 3
    assert (rows, splits, k_chunk) == tqm.ffma_plan(m, k, f)
    assert (ws is None) == (counters is None) == (splits == 1)
    return splits


@pytest.mark.parametrize("kind", ["int8", "int4", "dense"])
@pytest.mark.parametrize("m,k,f", [(16, 4096, 512), (1024, 256, 4096),
                                   (13, 130, 97)])
def test_fp32_launch_takes_the_ffma_body(recorder, kind, m, k, f):
    """Every fp32 launch of B6-B8 passes the FFMA body's code and plan,
    aligned or not, and counts once in matmul_ffma_launches and never in
    matmul_first_body_launches."""
    if kind == "int4" and k % 128:
        k = 256
    x = torch.zeros(m, k)
    if kind == "int8":
        fn, args = tqm._quant_matmul_cuda, (torch.zeros(k, f, dtype=torch.int8),
                                           torch.ones(f))
    elif kind == "int4":
        fn, args = tqm._int4_matmul_cuda, (
            torch.zeros(k // 2, f, dtype=torch.int8), torch.ones(k // 128, f))
    else:
        fn, args = tqm._dense_matmul_cuda, (torch.zeros(k, f),)
    ffma, first = tqm.matmul_ffma_launches, tqm.matmul_first_body_launches
    fn(x, *args)
    _launched(recorder, "fa_quant_matmul", m, k, f)
    assert tqm.matmul_ffma_launches == ffma + 1
    assert tqm.matmul_first_body_launches == first


@pytest.mark.parametrize("m,k,f", [(16, 4096, 14336), (16, 14336, 4096),
                                   (300, 384, 200)])
def test_fp32_grouped_launch_takes_the_ffma_body(recorder, m, k, f):
    x = torch.zeros(m, k)
    sizes = torch.tensor([m // 2, 0, m - m // 2], dtype=torch.int32)
    ffma = tqm.matmul_ffma_launches
    tg._grouped_cuda(x, sizes, torch.zeros(3, k // 2, f, dtype=torch.int8),
                     torch.ones(3, k // 128, f), None, "int4")
    splits = _launched(recorder, "fa_grouped_matmul", m, k, f)
    assert splits > 1 or m == 300
    assert tqm.matmul_ffma_launches == ffma + 1


def test_check_fp32_matmul_takes_the_common_signature():
    """kernel_pairs.py calls every check as (rng, flush, results)."""
    for name in ("fp32_matmul", "fp32"):
        params = list(inspect.signature(
            getattr(CHIP, f"check_{name}")).parameters)
        assert params == ["rng", "flush", "results"], name
    assert (1024, 14336, 4096) in CHIP.FP32_MATMUL_SHAPES
