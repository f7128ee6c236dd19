"""Port parity: ring attention (flash_attention_tpu_torch.parallel.ring)
against the JAX package's `make_ring_attention`.

The port's ring runs at 4 gloo ranks on the CPU: one spawn per file
(`scripts/launch_multihost --simulate 4 --device cpu` running
`scripts/ring_worker`) takes every case of the file, each rank holding
its sequence chunk and running B1 / B2 / B3's plain versions. The JAX
ring runs on `make_mesh(sp=4, devices=jax.devices()[:4])` (Pallas
interpreter, BlockSizes(128, 128)) on the same seeded N(0, 0.02) numpy
inputs, (B, H, N_local, D) = (1, 2, 128, 64), with the same output
cotangent. Gate: `utils/metrics.py` `verify` (2% symmetric relative
error) of the port's O / dQ / dK / dV against the JAX ring's and against
an exact fp64 reference (masked softmax attention and its autograd
gradients). Measured max-abs gaps to the JAX ring: O <= 5.6e-9, dQ / dK
<= 5.5e-12, dV <= 1.9e-8 (non-causal, contiguous causal, zigzag); the
JAX ring's own gaps to the exact result are of the same size.

Also here: bf16 rings (contiguous and zigzag causal, GQA 4 / 2) within
the low-precision gate (3x the single-process bf16 flash_attention's
error against the exact result); a ring of one (no process group) is
bit-identical to the
port's `flash_attention` in O and gradients (zigzag within the gate);
`ring_attention`'s guards raise what the JAX function raises before any
group is touched; `zigzag_order` / `zigzag_inverse` equal JAX's; and
`forward(..., attn_impl=ring)` of `LlamaConfig.tiny` (fp32) at 4 ranks x
128 tokens gives the port's single-process loss (rtol 1e-5) and
gradients (rtol 5e-4, atol 5e-6: the JAX test's bounds).

The window, segment-id and GQA-with-dp cases are in
test_torch_ring_masks.py and test_torch_ring_window.py (a spawn each
keeps each file near 40 s on one worker).
"""

import functools
import os
import signal
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flash_attention_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_tpu.parallel import ring as jring
from flash_attention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flash_attention_tpu.parallel.ring import make_ring_attention as jax_ring
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.ops.flash import SegmentIds, flash_attention
from flash_attention_tpu_torch.parallel import ring as pring
from flash_attention_tpu_torch.utils.metrics import (
    max_abs_error,
    verify,
    verify_low_precision,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SP = 4
N_LOCAL, H, D = 128, 2, 64
JAX_BLOCKS = JaxBlockSizes(block_q=128, block_kv=128)
OUTS = ("o", "dq", "dk", "dv")
SPAWN_TIMEOUT_S = 300


def _normal(seed, shape):
    return np.random.default_rng(seed).normal(0, 0.02, shape).astype(
        np.float32)


def attn_inputs(seed, b=1, hq=H, hkv=H, n=SP * N_LOCAL):
    """Seeded q, k, v, do (natural order) as fp32 numpy arrays."""
    return tuple(_normal(seed + i, (b, h, n, D))
                 for i, h in enumerate((hq, hkv, hkv, hq)))


def exact(q, k, v, do, *, causal, window=None, seg=None):
    """fp64 masked softmax attention and its autograd gradients, as
    numpy arrays (o, dq, dk, dv)."""
    qt, kt, vt = (torch.from_numpy(x).double().requires_grad_()
                  for x in (q, k, v))
    g = q.shape[1] // k.shape[1]
    kk, vv = (torch.repeat_interleave(x, g, dim=1) for x in (kt, vt))
    s = torch.einsum("bhqd,bhkd->bhqk", qt, kk) / np.sqrt(q.shape[-1])
    n = q.shape[2]
    row, col = np.arange(n)[:, None], np.arange(n)[None, :]
    vis = np.ones((n, n), bool)
    if causal:
        vis &= col <= row
    if window is not None:
        vis &= col > row - window
    vis = torch.from_numpy(vis)
    if seg is not None:
        ids = torch.from_numpy(np.asarray(seg))
        vis = vis & (ids[:, None, :, None] == ids[:, None, None, :])
    p = torch.softmax(s.masked_fill(~vis, float("-inf")), dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p, vv)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(do).double())
    return tuple(x.detach().numpy() for x in (o, *grads))


def jax_ring_run(q, k, v, do, *, seg=None, dp=1, sp=SP, spec=None, **kw):
    """The JAX ring's (o, dq, dk, dv) on a dp x sp mesh of the first
    dp * sp virtual CPU devices (o only when do is None)."""
    mesh = jax_make_mesh(dp=dp, sp=sp, devices=jax.devices()[:dp * sp])
    fn = jax_ring(mesh, segmented=seg is not None,
                  qkv_spec=None if spec is None else PartitionSpec(*spec),
                  block_sizes=JAX_BLOCKS, **kw)
    args = [jnp.asarray(x) for x in (q, k, v)]
    if seg is not None:
        from flash_attention_tpu.ops.flash import SegmentIds as JaxSeg
        ids = jnp.asarray(seg)
        f = functools.partial(lambda s, *a: fn(*a, s), JaxSeg(ids, ids))
    else:
        f = fn
    if do is None:
        return (np.asarray(f(*args)),)
    o, vjp = jax.vjp(f, *args)
    return (np.asarray(o), *(np.asarray(g) for g in vjp(jnp.asarray(do))))


class PortRing:
    """The port's ring at `world` gloo ranks over `cases` (the
    ring_worker's format): one spawn, started when the object is made,
    so it runs while the test process computes the JAX side; `get()`
    waits for it and returns the worker's results."""

    def __init__(self, cases, world=SP):
        self.tmp = tempfile.TemporaryDirectory(prefix="fa_ring_test_")
        d = self.tmp.name
        self.out = os.path.join(d, "out.pt")
        torch.save({"cases": cases}, os.path.join(d, "cases.pt"))
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "flash_attention_tpu_torch.scripts.launch_multihost",
             "--simulate", str(world), "--device", "cpu",
             "--rendezvous-dir", d, "--timeout", str(SPAWN_TIMEOUT_S),
             "--", "-m", "flash_attention_tpu_torch.scripts.ring_worker",
             os.path.join(d, "cases.pt"), self.out],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True)
        self._results = None

    def get(self):
        if self._results is None:
            try:
                log, _ = self.proc.communicate(timeout=SPAWN_TIMEOUT_S + 30)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)   # and its ranks
                log, _ = self.proc.communicate()
                raise AssertionError(f"the ring spawn timed out:\n{log}")
            assert self.proc.returncode == 0, \
                f"the ring spawn failed ({self.proc.returncode}):\n{log}"
            got = torch.load(self.out, weights_only=True)
            assert got["world"] == SP and got["backend"] == "gloo"
            self._results = got["cases"]
            self.tmp.cleanup()
        return self._results


def check_outputs(name, port, jax_out, exact_out, which):
    """The port's output `which` against the JAX ring's and the exact
    result (verify, both); returns the max-abs gap to the JAX ring."""
    i = OUTS.index(which)
    got = port[which].numpy()
    rep = verify(got, jax_out[i])
    assert rep.passed, f"{name} {which} vs the JAX ring: {rep}"
    rep = verify(got, exact_out[i])
    assert rep.passed, f"{name} {which} vs the exact result: {rep}"
    return max_abs_error(got, jax_out[i])


# --- a file's ring cases -------------------------------------------------------


class RingCases:
    """A file's ring cases, name -> dict(causal, seed, and optionally
    layout, window, seg_seed (make_segments, up to 5 documents), b, hq,
    hkv, n (global length), grads (compare dQ / dK / dV too), dp, sp):
    the inputs in the ring's layout, the exact result, the ring worker's
    cases and the JAX ring's outputs, each made once."""

    def __init__(self, cases):
        self.cases = cases
        self._inputs, self._jax = {}, {}

    def inputs(self, name):
        """((q, k, v, do or None, seg or None), exact outputs), both in
        the ring's layout (zigzag-ordered for layout "zigzag")."""
        if name not in self._inputs:
            self._inputs[name] = self._make_inputs(self.cases[name])
        return self._inputs[name]

    @staticmethod
    def _make_inputs(c):
        q, k, v, do = attn_inputs(c["seed"], b=c.get("b", 1),
                                  hq=c.get("hq", H), hkv=c.get("hkv", H),
                                  n=c.get("n", SP * N_LOCAL))
        seg = None
        if "seg_seed" in c:
            from tests.test_segments import make_segments
            seg = np.array(make_segments(
                np.random.default_rng(c["seg_seed"]), q.shape[0],
                q.shape[2], max_docs=5))
        ex = exact(q, k, v, do, causal=c["causal"], window=c.get("window"),
                   seg=seg)
        if c.get("layout") == "zigzag":
            perm = jring.zigzag_order(q.shape[2], c.get("sp", SP))
            q, k, v, do = (x[:, :, perm] for x in (q, k, v, do))
            seg = None if seg is None else seg[:, perm]
            ex = tuple(x[:, :, perm] for x in ex)
        return (q, k, v, do if c.get("grads") else None, seg), ex

    def worker_cases(self):
        out = []
        for name, c in self.cases.items():
            (q, k, v, do, seg), _ = self.inputs(name)
            case = dict(name=name, q=torch.from_numpy(q),
                        k=torch.from_numpy(k), v=torch.from_numpy(v),
                        causal=c["causal"],
                        layout=c.get("layout", "contiguous"),
                        window=c.get("window"), dp=c.get("dp", 1),
                        sp=c.get("sp", SP))
            if do is not None:
                case["do"] = torch.from_numpy(do)
            if seg is not None:
                case["seg"] = torch.from_numpy(seg)
            out.append(case)
        return out

    def jax(self, name):
        """The JAX ring's outputs of a case."""
        if name not in self._jax:
            c = self.cases[name]
            (q, k, v, do, seg), _ = self.inputs(name)
            self._jax[name] = jax_ring_run(
                q, k, v, do, seg=seg, dp=c.get("dp", 1), sp=c.get("sp", SP),
                spec=("dp", None, "sp", None) if "dp" in c else None,
                causal=c["causal"], layout=c.get("layout", "contiguous"),
                window=c.get("window"))
        return self._jax[name]

    def items(self):
        """(name, output) pairs to compare: O, and the gradients where
        the case has them."""
        return [(name, which) for name, c in self.cases.items()
                for which in (OUTS if c.get("grads") else ("o",))]

    def check(self, port, name, which):
        gap = check_outputs(name, port.get()[name], self.jax(name),
                            self.inputs(name)[1], which)
        assert gap <= 1e-6


RING = RingCases({
    "noncausal": dict(causal=False, seed=10, grads=True),
    "causal": dict(causal=True, seed=20, grads=True),
    # zigzag: a chunk pair of 128 per rank
    "zigzag": dict(causal=True, layout="zigzag", seed=30,
                   n=2 * SP * N_LOCAL, grads=True),
})
LLAMA_CFG = dict(vocab_size=512, dim=256, n_layers=2, n_heads=4,
                 n_kv_heads=2, ffn_dim=512)
LLAMA_TOKENS = np.random.default_rng(5).integers(
    0, LLAMA_CFG["vocab_size"], (1, SP * 128 + 1))


BF16_LAYOUTS = ("contiguous", "zigzag")


def bf16_inputs():
    """q, k, v, do of the bf16 cases (GQA 4 / 2, natural order)."""
    return tuple(torch.from_numpy(x).to(torch.bfloat16)
                 for x in attn_inputs(110, hq=4, hkv=2))


@pytest.fixture(scope="module")
def port():
    cases = RING.worker_cases()
    cases.append(dict(name="llama", kind="llama",
                      cfg=dict(LLAMA_CFG, dtype="float32"), seed=0,
                      tokens=torch.from_numpy(LLAMA_TOKENS), sp=SP))
    xs = bf16_inputs()
    perm = torch.from_numpy(jring.zigzag_order(xs[0].shape[2], SP))
    for layout in BF16_LAYOUTS:
        ys = xs if layout == "contiguous" else [x[:, :, perm] for x in xs]
        cases.append(dict(name=f"bf16_{layout}", q=ys[0], k=ys[1], v=ys[2],
                          do=ys[3], causal=True, layout=layout, sp=SP))
    return PortRing(cases)


@pytest.mark.parametrize("name, which", RING.items(),
                         ids=[f"{n}-{w}" for n, w in RING.items()])
def test_ring_matches_jax(port, name, which):
    """The port's 4-rank ring against the JAX ring and the exact result:
    O and the gradients, non-causal, contiguous causal and zigzag."""
    RING.check(port, name, which)


def test_ring_launch_plan_per_rank(port):
    """Each rank ran its own chunks (4 ranks); on the CPU no kernel is
    launched: every step takes the plain versions."""
    for name in RING.cases:
        got = port.get()[name]
        assert len(got["launches"]) == SP
        assert all(v == 0 for c in got["launches"] for v in c.values())


@pytest.mark.parametrize("layout", BF16_LAYOUTS)
def test_bf16_ring_within_the_low_precision_gate(port, layout):
    """bf16 at 4 ranks (fp32 dK / dV accumulators rotating between ranks
    that add to them and ranks that only pass them on): O and the
    gradients come back in bf16, each within 3x the error of the port's
    single-process bf16 flash_attention against the exact fp64 result."""
    q, k, v, do = bf16_inputs()
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o = flash_attention(*xs, causal=True)
    base = [o, *torch.autograd.grad(o, xs, do)]
    ex = exact(*(x.float().numpy() for x in (q, k, v, do)), causal=True)
    got = port.get()[f"bf16_{layout}"]
    inv = (torch.from_numpy(jring.zigzag_inverse(q.shape[2], SP))
           if layout == "zigzag" else slice(None))
    for which, b, e in zip(OUTS, base, ex):
        g = got[which][:, :, inv]
        assert g.dtype == torch.bfloat16
        ok, err, base_err = verify_low_precision(g, e, b)
        assert ok, f"{which}: ring {err:.3e}, flash_attention {base_err:.3e}"


# --- a ring of one ---------------------------------------------------------------

ONE = {"noncausal": dict(causal=False), "causal": dict(causal=True),
       "window": dict(causal=True, window=100),
       "segments": dict(causal=True, seg=True)}


@pytest.mark.parametrize("name", list(ONE))
def test_ring_of_one_is_flash_attention(name):
    """No process group: the ring is one step of B1 / B2 + B3's plain
    versions, and its O and gradients are the bits of flash_attention
    (the LSE merge starts from the first partial)."""
    kw = dict(ONE[name])
    q, k, v, do = (torch.from_numpy(x) for x in
                   attn_inputs(40, hq=4, hkv=2, n=256))
    seg = None
    if kw.pop("seg", False):
        ids = torch.from_numpy(np.repeat([0, 1, 2], [90, 110, 56])[None]
                               .astype(np.int32))
        seg = SegmentIds(ids, ids)
    outs = []
    for fn in (lambda *a: pring.ring_attention(*a, axis_name="sp", **kw),
               lambda *a: flash_attention(*a, **kw)):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*xs, seg)
        outs.append([o, *torch.autograd.grad(o, xs, do)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_zigzag_ring_of_one_within_gate():
    """Zigzag at one rank is causal attention over chunks (0, 1): the
    halves merge by their LSEs, so it is held by the gate, not bits."""
    q, k, v, do = (torch.from_numpy(x) for x in attn_inputs(50, n=256))
    outs = []
    for fn in (lambda *a: pring.ring_attention(
            *a, axis_name="sp", causal=True, layout="zigzag"),
               lambda *a: flash_attention(*a, causal=True)):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*xs)
        outs.append([o, *torch.autograd.grad(o, xs, do)])
    for a, b in zip(*outs):
        rep = verify(a, b)
        assert rep.passed, str(rep)


# --- guards and the zigzag permutation -----------------------------------------

GUARDS = {
    "unknown_layout": dict(layout="striped", causal=True),
    "odd_zigzag": dict(layout="zigzag", causal=True, n=127),
    "window_without_causal": dict(window=64),
    "window_zigzag": dict(layout="zigzag", causal=True, window=64),
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_ring_guards_match_jax(name):
    """The JAX function's exceptions and messages, raised before any
    group is looked up (an unusable mesh is never touched)."""
    kw = dict(GUARDS[name])
    n = kw.pop("n", 128)
    with pytest.raises(Exception) as jexc:
        q = jnp.zeros((1, 1, n, 64), jnp.float32)
        jring.ring_attention(q, q, q, axis_name="sp", **kw)
    q = torch.zeros(1, 1, n, 64)
    with pytest.raises(jexc.type) as texc:
        pring.ring_attention(q, q, q, axis_name="sp", mesh=object(), **kw)
    assert str(texc.value) == str(jexc.value)


@pytest.mark.parametrize("n_seq, n_dev", [(16, 4), (1024, 4), (24, 3),
                                          (8, 1)])
def test_zigzag_permutation_matches_jax(n_seq, n_dev):
    p = pring.zigzag_order(n_seq, n_dev)
    np.testing.assert_array_equal(p, jring.zigzag_order(n_seq, n_dev))
    np.testing.assert_array_equal(pring.zigzag_inverse(n_seq, n_dev),
                                  jring.zigzag_inverse(n_seq, n_dev))
    np.testing.assert_array_equal(
        p[pring.zigzag_inverse(n_seq, n_dev)], np.arange(n_seq))
    with pytest.raises(ValueError):
        pring.zigzag_order(n_seq + 1, n_dev)


# --- the ring inside the model -------------------------------------------------


def test_ring_in_the_model_matches_one_process(port):
    """Sequence-parallel training: LlamaConfig.tiny (fp32) at 4 ranks x
    128 tokens with the ring as attn_impl; the ranks' mean loss and
    gradients against the port's single-process loss_fn and gradients
    (flash_attention)."""
    cfg = tl.LlamaConfig(**LLAMA_CFG, dtype=torch.float32)
    params = tl.init_params(cfg, seed=0, device="cpu")
    leaves = tl.param_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tokens = torch.from_numpy(LLAMA_TOKENS)
    logits = tl.forward(params, tokens[:, :-1], cfg).float()
    loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                           tokens[:, 1:].reshape(-1))
    grads = torch.autograd.grad(loss, leaves)
    got = port.get()["llama"]
    np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=1e-5)
    assert len(got["grads"]) == len(grads)
    for a, b in zip(got["grads"], grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-4,
                                   atol=5e-6)
