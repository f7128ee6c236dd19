"""Port parity: expert-parallel MoE training (models/moe.py `moe_mlp(
ep_axis=)`, `moe_param_shardings`, `make_moe_train_step`;
parallel/collectives.py `all_to_all_tiled`; `Trainer(family="moe")`)
against the JAX package's `models/moe.py`.

The config is tests/test_moe.py's (`MoEConfig.tiny_moe`, fp32, capacity
routing), the weights the JAX package's `init_moe_params(PRNGKey(0))`
carried across by `params_from_jax`. One spawn per file
(`launch_multihost --simulate 4 --device cpu` running `pp_worker`) runs
every multi-rank case on 4 gloo ranks, while the test process computes
the JAX side:

  * `moe_mlp(ep_axis=)` at ep = 4 and at dp = 2 x ep = 2: each rank's
    output equals the port's single-device `moe_mlp` on its token rows,
    with 2 all-to-alls of [E, C, d] a call.
  * One SGD step (`torch.optim.SGD(lr=1e-2)` against `optax.sgd(1e-2)`)
    of `make_moe_train_step` at dp = 2 x ep = 2 (with and without remat)
    and at ep = 4 on [8, 32] tokens: JAX's `make_moe_train_step` on the
    same mesh shape over 4 of its 8 host devices, and the mean over the
    4 token shards of JAX's single-device gradients (tests/test_moe.py:108),
    rtol 1e-5 on the loss and on every updated parameter. The ranks
    agree; all-to-all and all-reduce calls and bytes are exact.
  * `Trainer(family="moe")` at dp = 2 x ep = 2 on tests/test_trainer.py:
    147's setup: the loss falls, `dropped_frac` is in `last_metrics`, a
    second Trainer from another seed resumes at step 2 with step 3's loss
    bit-exact, and the checkpoint holds the global tree (E = 8) in the
    JAX package's structure.

In the test process: a gloo world of one gives the plain `moe_loss_fn`
gradient step bit for bit and calls no collective; the guards raise
ValueError (ep not dividing n_experts, both placements at once, a
Trainer without an ep axis); `moe_param_shardings` equals JAX's.
"""

import dataclasses
import functools
import os
import signal
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.distributed as dist

from flash_attention_tpu.models import moe as jm
from flash_attention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.models import moe as tm
from flash_attention_tpu_torch.models.trainer import Trainer
from flash_attention_tpu_torch.parallel import collectives
from flash_attention_tpu_torch.parallel import mesh as pmesh
from flash_attention_tpu_torch.parallel.scaling import collective_bytes
from flash_attention_tpu_torch.utils.checkpoint import restore_checkpoint
from flash_attention_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jm.MoEConfig.tiny_moe(dtype=jnp.float32)
TCFG = tm.MoEConfig.tiny_moe(dtype=torch.float32)
CFG_SPEC = dict(preset="tiny_moe", dtype="float32")
B, T = 8, 32
LR = 1e-2
TOKENS = np.random.default_rng(42).integers(0, JCFG.vocab_size, (B, T))
X = np.random.default_rng(43).normal(0, 0.5, (8, 9, JCFG.dim)).astype(
    np.float32)
WORLD = 4
SPAWN_TIMEOUT_S = 300
# The trainer case: tests/test_trainer.py:147 at dp = 2 x ep = 2.
TRAIN_STEPS, CKPT_EVERY = 3, 2

MLP_CASES = {"mlp_ep4": dict(ep=4), "mlp_dp2_ep2": dict(dp=2, ep=2)}
# Step cases: name -> (mesh, remat).
STEP_CASES = {
    "step_dp2_ep2": (dict(dp=2, ep=2), False),
    "step_dp2_ep2_remat": (dict(dp=2, ep=2), True),
    "step_ep4": (dict(ep=4), False),
}


def _train_batches():
    r = np.random.default_rng(13)
    tok = torch.from_numpy(r.integers(0, JCFG.vocab_size, (16, 32)))
    return torch.stack([tok] * TRAIN_STEPS)


class EpSpawn:
    """Every multi-rank case at WORLD gloo ranks (pp_worker), one spawn
    started when the object is made, so it runs while the test process
    computes the JAX side; `get()` waits and returns the results. The
    trainer's checkpoints stay under `ckpt` until `kill()`."""

    def __init__(self, port_tree):
        self.tmp = tempfile.TemporaryDirectory(prefix="fa_ep_test_")
        d = self.tmp.name
        self.out = os.path.join(d, "out.pt")
        self.ckpt = os.path.join(d, "ckpt")
        cases = [dict(name=name, kind="moe_mlp", cfg=CFG_SPEC, mesh=mesh,
                      params="jax", x=torch.from_numpy(X))
                 for name, mesh in MLP_CASES.items()]
        cases += [dict(name=name, kind="moe_step", cfg=CFG_SPEC, mesh=mesh,
                       remat=remat, params="jax",
                       optimizer=dict(kind="sgd", lr=LR),
                       tokens=torch.from_numpy(TOKENS))
                  for name, (mesh, remat) in STEP_CASES.items()]
        cases.append(dict(name="trainer", kind="trainer", family="moe",
                          cfg=CFG_SPEC, mesh=dict(dp=2, ep=2),
                          optimizer=dict(kind="adamw", lr=3e-3,
                                         weight_decay=1e-4),
                          seed=0, resume_seed=99, steps=TRAIN_STEPS,
                          ckpt_every=CKPT_EVERY, ckpt_dir=self.ckpt,
                          batches=_train_batches()))
        torch.save({"cases": cases, "params": {"jax": port_tree}},
                   os.path.join(d, "cases.pt"))
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "flash_attention_tpu_torch.scripts.launch_multihost",
             "--simulate", str(WORLD), "--device", "cpu",
             "--rendezvous-dir", d, "--timeout", str(SPAWN_TIMEOUT_S), "--",
             "-m", "flash_attention_tpu_torch.scripts.pp_worker",
             os.path.join(d, "cases.pt"), self.out],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO,
                               OMP_NUM_THREADS="1"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True)
        self._results = None

    def get(self):
        if self._results is None:
            try:
                log, _ = self.proc.communicate(timeout=SPAWN_TIMEOUT_S + 30)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)   # and its ranks
                log, _ = self.proc.communicate()
                raise AssertionError(f"the ep spawn timed out:\n{log}")
            assert self.proc.returncode == 0, \
                f"the ep spawn failed ({self.proc.returncode}):\n{log}"
            got = torch.load(self.out, weights_only=True)
            assert (got["world"], got["backend"]) == (WORLD, "gloo")
            self._results = got["cases"]
        return self._results

    def kill(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()
        self.tmp.cleanup()


@pytest.fixture(scope="module")
def jax_params():
    return jm.init_moe_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params),
                           device="cpu")


@pytest.fixture(scope="module")
def spawn(port_params):
    sp = EpSpawn(port_params)
    yield sp
    sp.kill()


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy_tree(v) for v in tree]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def jax_side(spawn, jax_params):
    """The JAX package's results, computed while the spawn runs: its
    make_moe_train_step on a dp 2 x ep 2 and an ep 4 mesh of 4 devices,
    and the mean over the 4 token shards (2 rows each) of their
    single-device gradients (test_moe.py:108's expectation: routing,
    capacity and drops are per shard), each as (loss, updated params in
    numpy, metrics)."""
    tokens = jnp.asarray(TOKENS, jnp.int32)
    p = jax_params
    opt = optax.sgd(LR)
    out = {}
    for name, mesh in (("dp2_ep2", dict(dp=2, ep=2)), ("ep4", dict(ep=4))):
        step = jm.make_moe_train_step(
            jax_make_mesh(**mesh, devices=jax.devices()[:WORLD]), JCFG, opt)
        p2, _, loss, metrics = step(p, opt.init(p), tokens)
        out[name] = (float(loss), _numpy_tree(p2),
                     {k: float(v) for k, v in metrics.items()})
    grad = jax.jit(jax.value_and_grad(
        functools.partial(jm.moe_loss_fn, cfg=JCFG), has_aux=True))
    losses, grads = [], []
    c = B // WORLD
    for i in range(WORLD):
        (li, _), gi = grad(p, tokens[i * c:(i + 1) * c])
        losses.append(float(li))
        grads.append(gi)
    mean_g = jax.tree.map(lambda *g: sum(g) / WORLD, *grads)
    out["per_shard"] = (float(np.mean(losses)), _numpy_tree(
        jax.tree.map(lambda a, g: a - LR * g, p, mean_g)), None)
    return out


def _assert_tree_close(got, want, rtol=1e-5, atol=1e-7):
    for i, (a, b) in enumerate(zip(got["layers"], want["layers"],
                                   strict=True)):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_allclose(a[k].numpy(), b[k], rtol=rtol,
                                       atol=atol, err_msg=f"layers.{i}.{k}")
    for k in ("embed", "final_norm", "lm_head"):
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=rtol,
                                   atol=atol, err_msg=k)


def _capacity(rows):
    return tm.expert_capacity(rows * (T - 1), TCFG)


def _expected_collectives(case):
    """A rank's calls and bytes in one step (fp32): 2 all-to-alls of [E,
    C, d] a layer forward, 2 backward and, under remat, 2 recomputed;
    one all-reduce of the loss and the four metrics over (dp, ep), one a
    gradient: the expert stacks' over dp (none at dp = 1), every other
    leaf's over (dp, ep)."""
    mesh, remat = STEP_CASES[case]
    dp, ep = mesh.get("dp", 1), mesh["ep"]
    rows = B // (dp * ep)
    cube = TCFG.n_experts * _capacity(rows) * TCFG.dim * 4
    a2a = (6 if remat else 4) * TCFG.n_layers
    d, hd, f, e = TCFG.dim, TCFG.head_dim, TCFG.ffn_dim, TCFG.n_experts
    dense = (2 * d + d * (TCFG.n_heads + 2 * TCFG.n_kv_heads) * hd
             + TCFG.n_heads * hd * d + d * e) * TCFG.n_layers \
        + 2 * TCFG.vocab_size * d + d
    experts = 3 * (e // ep) * d * f * TCFG.n_layers
    calls = 1 + 7 * TCFG.n_layers + 3 + (3 * TCFG.n_layers if dp > 1 else 0)
    nbytes = 5 * 4 + dense * 4 + (experts * 4 if dp > 1 else 0)
    return {"all-reduce": dict(calls=calls, bytes=nbytes),
            "all-gather": dict(calls=0, bytes=0),
            "collective-permute": dict(calls=0, bytes=0),
            "all-to-all": dict(calls=a2a, bytes=a2a * cube)}


# --- the spawn's cases (first, so the spawn overlaps the JAX side) ----------


@pytest.mark.parametrize("case", list(MLP_CASES))
def test_moe_mlp_ep_matches_the_dense_mlp_on_each_shard(spawn, port_params,
                                                        case):
    """moe_mlp(ep_axis=) on each rank: the port's single-device moe_mlp on
    that rank's rows (routing, capacity and drops are per shard), with 2
    all-to-alls of the [E, C, d] cube."""
    mesh = MLP_CASES[case]
    dp, ep = mesh.get("dp", 1), mesh["ep"]
    c = X.shape[0] // (dp * ep)
    layer = port_params["layers"][0]
    cube = TCFG.n_experts * tm.expert_capacity(c * X.shape[1], TCFG) \
        * TCFG.dim * 4
    for r, got in enumerate(spawn.get()[case]):
        with torch.no_grad():
            want, aux = tm.moe_mlp(layer, torch.from_numpy(X[r * c:(r + 1) * c]),
                                   TCFG)
        np.testing.assert_allclose(got["y"].numpy(), want.numpy(),
                                   rtol=1e-5, atol=1e-6)
        assert got["aux"] == pytest.approx(
            {k: float(v) for k, v in aux.items()}, rel=1e-6)
        assert got["collectives"]["all-to-all"] == dict(calls=2,
                                                        bytes=2 * cube)
        assert got["collectives"]["all-reduce"]["calls"] == 0


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ep_step_matches_jax(spawn, jax_side, case):
    """One SGD step: JAX's make_moe_train_step on the same mesh shape
    (loss, metrics and every updated parameter, rtol 1e-5), and the mean
    of the per-row single-device gradients (test_moe.py:108)."""
    mesh, _ = STEP_CASES[case]
    key = "dp2_ep2" if mesh.get("dp", 1) == 2 else "ep4"
    results = spawn.get()[case]
    for want_key in (key, "per_shard"):
        want_loss, want, want_metrics = jax_side[want_key]
        for r in results:
            np.testing.assert_allclose(r["losses"][0], want_loss, rtol=1e-5)
            if want_metrics is not None:
                for k, v in want_metrics.items():
                    np.testing.assert_allclose(r["metrics"][0][k], v,
                                               rtol=1e-5, atol=1e-7,
                                               err_msg=k)
        _assert_tree_close(results[0]["params"], want)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ep_ranks_agree(spawn, case):
    """Every rank reports the same loss and metrics, gathers the same
    global tree, and holds the same replicated leaves."""
    results = spawn.get()[case]
    first = results[0]
    for r in results[1:]:
        assert r["losses"] == first["losses"]
        assert r["metrics"] == first["metrics"]
        assert r["replicated"] == first["replicated"]
        for a, b in zip(tl.param_leaves(r["params"]),
                        tl.param_leaves(first["params"]), strict=True):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_ep_collectives_exact(spawn, case):
    for rank, r in enumerate(spawn.get()[case]):
        assert r["collectives"][0] == _expected_collectives(case), rank


def test_trainer_moe_trains_and_resumes(spawn):
    """tests/test_trainer.py:147 at dp = 2 x ep = 2: 3 AdamW steps with
    falling loss and the router metrics in last_metrics; a Trainer from
    another seed resumes at step 2 with step 3's loss bit-exact."""
    for r in spawn.get()["trainer"]:
        assert len(r["losses"]) == TRAIN_STEPS
        assert np.isfinite(r["losses"]).all()
        assert r["losses"][-1] < r["losses"][0], r["losses"]
        assert set(r["last_metrics"]) == {"ce", "load_balance", "router_z",
                                          "dropped_frac"}
        assert r["resumed_step"] == CKPT_EVERY
        assert r["resumed_losses"] == r["losses"][CKPT_EVERY:]


def test_trainer_moe_checkpoint_is_the_global_tree(spawn, jax_params):
    """The step-2 checkpoint holds the JAX package's tree structure with
    global shapes (the expert stacks' E = 8 gathered over ep), and its
    optimizer state names every parameter with moments of global
    shape."""
    spawn.get()
    step, state = restore_checkpoint(spawn.ckpt)
    assert step == state["step"] == CKPT_EVERY
    params = state["params"]
    assert set(params) == set(jax_params)
    assert len(params["layers"]) == len(jax_params["layers"])
    for got, want in zip(params["layers"], jax_params["layers"]):
        assert {k: tuple(v.shape) for k, v in got.items()} == \
            {k: tuple(v.shape) for k, v in want.items()}
    assert params["layers"][0]["w_gate"].shape[0] == TCFG.n_experts
    leaves = tl.param_leaves(params)
    opt = state["opt_state"]
    assert len(opt["param_groups"][0]["params"]) == len(leaves)
    for pid, entry in opt["state"].items():
        assert entry["exp_avg"].shape == leaves[pid].shape


# --- a world of one ------------------------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    pmesh.initialize_distributed(f"file://{tmp_path}/store", 1, 0,
                                 device="cpu")
    try:
        yield pmesh.make_mesh(ep=1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _cloned(tree):
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cloned(v) for v in tree]
    return tree.detach().clone().requires_grad_(True)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_world_of_one_equals_the_plain_step(world_of_one, port_params,
                                            remat):
    """make_mesh(ep=1): loss, metrics and every updated parameter bit for
    bit those of moe_loss_fn, torch.autograd.grad and an SGD update on a
    copy; no collective is called (a reduction over one rank is the
    identity)."""
    tokens = torch.from_numpy(TOKENS[:2])
    a, b = _cloned(port_params), _cloned(port_params)
    step = tm.make_moe_train_step(world_of_one, TCFG, remat=remat)
    collectives.reset_collective_counts()
    loss, metrics = step(a, torch.optim.SGD(tl.param_leaves(a), lr=LR),
                         tokens)
    counts = collectives.collective_counts()
    want, want_m = tm.moe_loss_fn(b, tokens, TCFG, remat=remat)
    leaves = tl.param_leaves(b)
    for p, g in zip(leaves, torch.autograd.grad(want, leaves)):
        p.grad = g
    torch.optim.SGD(leaves, lr=LR).step()
    assert torch.equal(loss, want.detach())
    for k, v in want_m.items():
        assert torch.equal(metrics[k], v.detach()), k
    for x, y in zip(tl.param_leaves(a), leaves, strict=True):
        assert torch.equal(x, y)
    assert all(v == dict(calls=0, bytes=0) for v in counts.values())


def test_all_to_all_tiled_matches_jax_on_a_world_of_one(world_of_one):
    """A group of one sends x to itself: JAX's tiled all_to_all over one
    device, a new tensor, counted (parallel/scaling.py collective_bytes
    reads its output bytes); its gradient is the cotangent."""
    x = torch.randn(4, 3, 5, requires_grad=True)
    group = world_of_one.get_group("ep")
    collectives.reset_collective_counts()
    y = collectives.all_to_all_tiled(x, group, split_axis=0, concat_axis=1)
    want = jax.vmap(lambda v: jax.lax.all_to_all(
        v, "i", 0, 1, tiled=True), axis_name="i")(
            jnp.asarray(x.detach().numpy())[None])[0]
    assert np.array_equal(y.detach().numpy(), np.asarray(want))
    assert y.data_ptr() != x.data_ptr()
    y.backward(torch.ones_like(y))
    assert torch.equal(x.grad, torch.ones_like(x))
    assert collectives.collective_counts()["all-to-all"] == dict(
        calls=2, bytes=2 * x.numel() * 4)
    assert collective_bytes(collectives.all_to_all_tiled, x.detach(),
                            group, 2, 0) == {"all-to-all": x.numel() * 4}


# --- guards and specs ---------------------------------------------------------


class _FakeAxis:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


class _FakeMesh:
    def __init__(self, **shape):
        self.shape = shape

    def __getitem__(self, axis):
        return _FakeAxis(self.shape.get(axis, 1))


def test_ep_must_divide_experts():
    """tests/test_moe.py:157: ep = 4 does not divide 6 experts."""
    cfg6 = dataclasses.replace(TCFG, n_experts=6)
    with pytest.raises(ValueError, match="must divide n_experts"):
        tm.make_moe_train_step(_FakeMesh(dp=2, ep=4), cfg6)


def test_both_placements_raise(world_of_one, port_params):
    group = world_of_one.get_group("ep")
    x = torch.zeros(1, 4, TCFG.dim)
    with pytest.raises(ValueError, match="exclusive"):
        tm.moe_mlp(port_params["layers"][0], x, TCFG, ep_axis=group,
                   expert_shard_axis=group)


def test_trainer_moe_needs_an_ep_axis(world_of_one):
    """No mesh, or a mesh without an 'ep' axis: ValueError (JAX
    trainer.py:162-164)."""
    from torch.distributed.device_mesh import init_device_mesh

    with pytest.raises(ValueError, match="'ep'"):
        Trainer(TCFG, torch.optim.SGD, family="moe", device="cpu")
    no_ep = init_device_mesh("cpu", (1,), mesh_dim_names=("dp",))
    with pytest.raises(ValueError, match="'ep'"):
        Trainer(TCFG, torch.optim.SGD, mesh=no_ep, family="moe",
                device="cpu")


def test_moe_param_shardings_match_jax():
    want = jax.tree.map(lambda s: tuple(s), jm.moe_param_shardings(JCFG),
                        is_leaf=lambda x: isinstance(
                            x, jax.sharding.PartitionSpec))
    assert tm.moe_param_shardings(TCFG) == want
