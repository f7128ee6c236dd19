"""Port parity: pipeline training (flash_attention_tpu_torch.parallel.
pipeline: split / merge, `pipeline_shardings`, GPipe, 1F1B, pp x tp with
the vocab-parallel loss, `make_pp_loss`; `Trainer(family="pipeline")`)
against the JAX package's `parallel/pipeline.py`.

The config is tests/test_pipeline.py's (`LlamaConfig.tiny`, fp32, 4
layers; M, B, T = 4, 4, 32 from `default_rng(42)`), the weights the JAX
package's `init_params(PRNGKey(0))` carried across by `params_from_jax`.
One spawn per file (`launch_multihost --simulate 4 --device cpu`
running `scripts/pp_worker`) runs every multi-rank case on 4 gloo
ranks, while the test process computes the JAX side once:

  * `make_pp_loss` at pp = 2, dp = 2 against JAX's on its test's mesh
    (pp = 4, dp = 2), rtol 1e-5.
  * One SGD step (`torch.optim.SGD(lr=1e-2)` against `optax.sgd(1e-2)`)
    at the JAX tests' tolerances (loss rtol 1e-5; merged params rtol
    2e-4, atol 1e-6): GPipe at pp = 2, dp = 2 against JAX's
    `make_pp_train_step` at pp = 4, dp = 2; 1F1B at pp = 2, dp = 2
    against `make_pp_train_step_1f1b` there; 1F1B at pp = 2, tp = 2
    against JAX's pp = 2, tp = 2, dp = 2 step (the vocab-parallel
    cross-entropy); each also against JAX's single-device
    `make_train_step`, as are GPipe with remat and GPipe at pp x tp.
    The ranks' gathered trees are identical, and each rank's counted
    collectives (permutes, all-reduces) are exact by call and byte.
  * `Trainer(family="pipeline")` on tests/test_trainer.py:114's setup
    (tiny, 2 layers, SGD 5e-2, batches of [4, 4, 32] from
    `default_rng(11)`, a checkpoint every 2 steps) at pp = 2, dp = 2,
    GPipe and 1F1B: 3 steps with falling loss, and a second Trainer from
    another seed resumes from the step-2 checkpoint with step 3's loss
    bit-exact; `merge_pipeline_params` reads that checkpoint into a
    plain tree that `forward` runs.

In the test process, a gloo world of one: pp = 1 and M = 1 give the
port's dense step bit for bit (GPipe with and without remat, 1F1B), with
17 all-reduces and no permute; the Trainer's argument checks;
`pipeline_shardings`' specs equal JAX's, and its optimizer-state rule is
structural (an embed moment whose dim 0 equals n_layers stays
replicated).
"""

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

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.parallel import pipeline as jpp
from flash_attention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.models.trainer import Trainer
from flash_attention_tpu_torch.parallel import collectives
from flash_attention_tpu_torch.parallel import mesh as pmesh
from flash_attention_tpu_torch.parallel import pipeline as tpp
from flash_attention_tpu_torch.utils.checkpoint import restore_checkpoint
from flash_attention_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jl.LlamaConfig(**{**jl.LlamaConfig.tiny(dtype=jnp.float32).__dict__,
                         "n_layers": 4})
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32, n_layers=4)
M, B, T = 4, 4, 32
LR = 1e-2
TOKENS = np.random.default_rng(42).integers(0, JCFG.vocab_size, (M, B, T))
WORLD = 4
SPAWN_TIMEOUT_S = 300
CFG_SPEC = dict(dtype="float32", n_layers=4)
SGD = dict(kind="sgd", lr=LR)
# The trainer cases: tests/test_trainer.py:114 (tiny's 2 layers).
TRAIN_STEPS, CKPT_EVERY, TRAIN_LR = 3, 2, 5e-2

# Step cases: name -> (schedule, mesh, remat, JAX pipeline to match).
STEP_CASES = {
    "gpipe": ("gpipe", dict(pp=2, dp=2), False, "gpipe"),
    "1f1b": ("1f1b", dict(pp=2, dp=2), False, "1f1b"),
    "1f1b_tp": ("1f1b", dict(pp=2, tp=2), False, "1f1b_tp"),
    "gpipe_remat": ("gpipe", dict(pp=2, dp=2), True, None),
    "gpipe_tp": ("gpipe", dict(pp=2, tp=2), False, None),
}


def _train_batches():
    r = np.random.default_rng(11)
    return torch.from_numpy(np.stack(
        [r.integers(0, 512, (4, 4, 32)) for _ in range(TRAIN_STEPS)]))


class PpSpawn:
    """Every multi-rank case at WORLD gloo ranks (pp_worker), one spawn
    started when the object is made, so it runs while the test process
    computes the JAX side; `get()` waits and returns the results. The
    trainer cases' checkpoints stay under `ckpt(name)` until `kill()`."""

    def __init__(self, port_tree):
        self.tmp = tempfile.TemporaryDirectory(prefix="fa_pp_test_")
        d = self.tmp.name
        self.out = os.path.join(d, "out.pt")
        tokens = torch.from_numpy(TOKENS)
        cases = [dict(name=name, kind="step", cfg=CFG_SPEC, mesh=mesh,
                      schedule=schedule, remat=remat, params="jax",
                      optimizer=SGD, tokens=tokens)
                 for name, (schedule, mesh, remat, _) in STEP_CASES.items()]
        cases.append(dict(name="loss", kind="loss", cfg=CFG_SPEC,
                          mesh=dict(pp=2, dp=2), params="jax",
                          tokens=tokens))
        cases += [dict(name=f"trainer_{s}", kind="trainer",
                       cfg=dict(dtype="float32"), mesh=dict(pp=2, dp=2),
                       schedule=s, optimizer=dict(kind="sgd", lr=TRAIN_LR),
                       seed=0, resume_seed=99, steps=TRAIN_STEPS,
                       ckpt_every=CKPT_EVERY, ckpt_dir=self.ckpt(f"trainer_{s}"),
                       batches=_train_batches())
                  for s in ("gpipe", "1f1b")]
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

    def ckpt(self, name):
        return os.path.join(self.tmp.name, "ckpt", name)

    def get(self):
        if self._results is None:
            try:
                log, _ = self.proc.communicate(timeout=SPAWN_TIMEOUT_S + 30)
            except subprocess.TimeoutExpired:
                os.killpg(self.proc.pid, signal.SIGKILL)   # and its ranks
                log, _ = self.proc.communicate()
                raise AssertionError(f"the pp spawn timed out:\n{log}")
            assert self.proc.returncode == 0, \
                f"the pp spawn failed ({self.proc.returncode}):\n{log}"
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
    return jl.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def port_params(jax_params):
    return params_from_jax(jax.tree.map(np.asarray, jax_params),
                           device="cpu")


@pytest.fixture(scope="module")
def spawn(port_params):
    sp = PpSpawn(port_params)
    yield sp
    sp.kill()


def _jax_step(make, mesh, params, tokens, tp_axis=None):
    """One optax.sgd step of a JAX pipeline schedule: (loss, merged
    params as numpy)."""
    pp = mesh.shape["pp"]
    stages, shared = jpp.split_pipeline_params(params, pp)
    opt = optax.sgd(LR)
    opt_state = opt.init((stages, shared))
    if tp_axis is not None:
        st_sh, sh_sh, opt_sh = jpp.pipeline_shardings(
            mesh, stages, shared, opt_state, optimizer=opt, tp_axis=tp_axis)
        stages = jax.tree.map(jax.device_put, stages, st_sh)
        shared = jax.tree.map(jax.device_put, shared, sh_sh)
        opt_state = jax.tree.map(jax.device_put, opt_state, opt_sh)
    s2, sh2, _, loss = make(mesh, JCFG, opt)(stages, shared, opt_state,
                                             tokens)
    merged = jpp.merge_pipeline_params(s2, sh2)
    return float(loss), jax.tree.map(np.asarray, merged)


@pytest.fixture(scope="module")
def jax_side(spawn, jax_params):
    """The JAX package's results, computed while the spawn runs: its
    pipelined loss, its three pipeline steps and its single-device
    step."""
    tokens = jnp.asarray(TOKENS, jnp.int32)
    p = jax_params
    mesh42 = jax_make_mesh(pp=4, dp=2)
    stages, shared = jpp.split_pipeline_params(p, 4)
    out = {"loss": float(jpp.make_pp_loss(mesh42, JCFG)(stages, shared,
                                                         tokens))}
    out["gpipe"] = _jax_step(jpp.make_pp_train_step, mesh42, p, tokens)
    out["1f1b"] = _jax_step(jpp.make_pp_train_step_1f1b, mesh42, p, tokens)
    out["1f1b_tp"] = _jax_step(jpp.make_pp_train_step_1f1b,
                               jax_make_mesh(pp=2, tp=2, dp=2), p, tokens,
                               tp_axis="tp")
    opt = optax.sgd(LR)
    p2, _, loss = jax.jit(jl.make_train_step(JCFG, opt))(
        p, opt.init(p), tokens.reshape(M * B, T))
    out["single"] = (float(loss), jax.tree.map(np.asarray, p2))
    out["single_loss_fn"] = float(jl.loss_fn(p, tokens.reshape(M * B, T),
                                             JCFG))
    return out


def _merged(result):
    """A rank's gathered (stages, shared) as a plain numpy tree."""
    tree = tpp.merge_pipeline_params(*result["params"])
    return {"layers": [{k: v.numpy() for k, v in layer.items()}
                       for layer in tree["layers"]],
            **{k: tree[k].numpy() for k in tpp.SHARED_KEYS}}


def _assert_params_close(got, want):
    for i, (a, b) in enumerate(zip(got["layers"], want["layers"],
                                   strict=True)):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-6,
                                       err_msg=f"layers.{i}.{k}")
    for k in tpp.SHARED_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)


# --- the spawn's cases (first, so the spawn overlaps the JAX side) ----------


def test_pp_loss_matches_jax(spawn, jax_side):
    """make_pp_loss at pp = 2, dp = 2: JAX's make_pp_loss at pp = 4, dp =
    2 and the single-device loss_fn, rtol 1e-5, on every rank."""
    for r in spawn.get()["loss"]:
        np.testing.assert_allclose(r["loss"], jax_side["loss"], rtol=1e-5)
        np.testing.assert_allclose(r["loss"], jax_side["single_loss_fn"],
                                   rtol=1e-5)


@pytest.mark.parametrize("case", ["gpipe", "1f1b", "1f1b_tp"])
def test_pp_step_matches_jax_pipeline(spawn, jax_side, case):
    """One SGD step: the JAX pipeline step's loss (rtol 1e-5) and merged
    parameters (rtol 2e-4, atol 1e-6)."""
    want_loss, want = jax_side[STEP_CASES[case][3]]
    results = spawn.get()[case]
    for r in results:
        np.testing.assert_allclose(r["losses"][0], want_loss, rtol=1e-5)
    _assert_params_close(_merged(results[0]), want)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pp_step_matches_single_device(spawn, jax_side, case):
    """One SGD step: JAX's single-device make_train_step on the
    microbatches as one batch."""
    want_loss, want = jax_side["single"]
    results = spawn.get()[case]
    np.testing.assert_allclose(results[0]["losses"][0], want_loss, rtol=1e-5)
    _assert_params_close(_merged(results[0]), want)


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pp_ranks_agree(spawn, case):
    """Every rank reports the same loss and gathers the same global tree;
    the shared params of every rank are the same after the step."""
    results = spawn.get()[case]
    first = results[0]
    for r in results[1:]:
        assert r["losses"] == first["losses"]
        for part_a, part_b in zip(r["params"], first["params"]):
            for k in part_b:
                assert torch.equal(part_a[k], part_b[k]), k
    tp = STEP_CASES[case][1].get("tp", 1)
    for r in results:   # lm_head is a vocab shard under tp
        same = [k for k in tpp.SHARED_KEYS
                if tp == 1 or k != "lm_head"]
        assert {k: r["shared"][k] for k in same} == \
            {k: first["shared"][k] for k in same}


def _tick_hops(schedule, m, s):
    """The permutes of one step in each direction, from the timetable
    (independent of the module's code): GPipe one after every tick but
    the last of each phase; 1F1B after every half-tick at which some
    rank that has a neighbour that way ran its slot."""
    if s == 1:
        return 0, 0
    if schedule == "gpipe":
        return m + s - 2, m + s - 2
    fwd = {2 * j + q for j in range(m) for q in range(s - 1)}
    bwd = {2 * j + 2 * s - 1 - q for j in range(m) for q in range(1, s)}
    return len(fwd), len(bwd)


def _expected_collectives(case, rank):
    """The calls and bytes a rank of `case` counts in one step (fp32):
    permutes of [B / dp, T - 1, dim] activations; all-reduces of the
    loss (pp, dp), the shared gradients (pp), every gradient (dp) and,
    under tp, 2 a layer for each forward a stage runs (1F1B: the
    no-grad forward of a rank with a successor, and the recompute) and 2
    a layer for each backward, plus the tail's max, sumexp, gold and its
    norm's backward a microbatch on the last rank."""
    schedule, mesh, _, _ = STEP_CASES[case]
    s, dp, tp = mesh["pp"], mesh.get("dp", 1), mesh.get("tp", 1)
    r = rank // tp % s      # AXES order: dp, pp, ..., tp innermost
    last = r == s - 1
    b = B // dp
    act = b * (T - 1) * TCFG.dim * 4
    fwd, bwd = _tick_hops(schedule, M, s)
    sends = (fwd if r < s - 1 else 0) + (bwd if r > 0 else 0)
    d, hd, f, v = TCFG.dim, TCFG.head_dim, TCFG.ffn_dim, TCFG.vocab_size
    layer = (2 * d + d * (TCFG.n_heads + 2 * TCFG.n_kv_heads) * hd // tp
             + TCFG.n_heads * hd * d // tp + 3 * d * f // tp)
    stage = layer * TCFG.n_layers // s * 4
    shared = (v * d + d + d * v // tp) * 4
    calls = 2 + 3 + 9 + 3
    nbytes = 8 + shared + stage + shared
    if tp > 1:
        n = TCFG.n_layers // s
        # Forwards a microbatch (1F1B: the no-grad one and the
        # recompute), then one backward.
        runs = 2 if schedule == "1f1b" and not last else 1
        calls += M * (runs + 1) * 2 * n
        nbytes += (calls - 17) * act
        if last:
            calls += 4 * M
            nbytes += M * (3 * b * (T - 1) * 4 + act)
    return {"all-reduce": dict(calls=calls, bytes=nbytes),
            "all-gather": dict(calls=0, bytes=0),
            "collective-permute": dict(calls=fwd + bwd, bytes=sends * act),
            "all-to-all": dict(calls=0, bytes=0)}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_pp_collectives_exact(spawn, case):
    """Each rank's counted collectives of the step: permutes by call and
    by the bytes it sends, all-reduces by call and byte."""
    for rank, r in enumerate(spawn.get()[case]):
        assert r["collectives"][0] == _expected_collectives(case, rank), rank


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_trainer_pipeline_trains_and_resumes(spawn, schedule):
    """tests/test_trainer.py:114 at pp = 2, dp = 2: 3 steps with falling
    loss; a Trainer from another seed resumes at step 2 from the
    checkpoint and gives step 3's loss bit-exact, on every rank."""
    for r in spawn.get()[f"trainer_{schedule}"]:
        assert len(r["losses"]) == TRAIN_STEPS
        assert np.isfinite(r["losses"]).all()
        assert r["losses"][-1] < r["losses"][0], r["losses"]
        assert r["resumed_step"] == CKPT_EVERY
        assert r["resumed_losses"] == r["losses"][CKPT_EVERY:]


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_merge_reads_a_pipeline_checkpoint(spawn, schedule):
    """The step-2 checkpoint holds the global layout: its (stages, shared)
    merge into a plain tree that the dense forward runs, and its
    optimizer state names every parameter."""
    spawn.get()
    step, state = restore_checkpoint(spawn.ckpt(f"trainer_{schedule}"))
    assert step == state["step"] == CKPT_EVERY
    cfg = tl.LlamaConfig.tiny(dtype=torch.float32)
    stages, shared = state["params"]
    assert stages["wq"].shape == (cfg.n_layers, cfg.dim, cfg.n_heads,
                                  cfg.head_dim)
    tree = tpp.merge_pipeline_params(stages, shared)
    assert len(tree["layers"]) == cfg.n_layers
    logits = tl.forward(tree, torch.from_numpy(TOKENS[0]), cfg)
    assert logits.shape == (B, T, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert len(state["opt_state"]["param_groups"][0]["params"]) == \
        len(tl.param_leaves((stages, shared)))


# --- a world of one ------------------------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    pmesh.initialize_distributed(f"file://{tmp_path}/store", 1, 0,
                                 device="cpu")
    try:
        yield pmesh.make_mesh(pp=1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def _dense_step(tree, tokens):
    params = _cloned(tree)
    opt = torch.optim.AdamW(tl.param_leaves(params), lr=1e-3,
                            weight_decay=1e-4)
    loss = tl.make_train_step(TCFG, remat=True)(params, opt, tokens)
    return loss, params


def _cloned(tree):
    if isinstance(tree, dict):
        return {k: _cloned(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cloned(v) for v in tree]
    return tree.detach().clone().requires_grad_(True)


@pytest.mark.parametrize("schedule,remat", [
    ("gpipe", True), ("gpipe", False), ("1f1b", False)],
    ids=["gpipe_remat", "gpipe", "1f1b"])
def test_world_of_one_equals_the_dense_step(world_of_one, port_params,
                                            schedule, remat):
    """pp = 1 and one microbatch: the dense make_train_step's loss and
    updated parameters bit for bit (AdamW), with the collectives of any
    world size but the permutes: 17 all-reduces."""
    tokens = TOKENS[:1]
    want_loss, want = _dense_step(port_params, tokens[0])
    stages, shared = tpp.split_pipeline_params(_cloned(port_params), 1)
    for leaf in tl.param_leaves((stages, shared)):
        leaf.requires_grad_(True)
    opt = torch.optim.AdamW(tl.param_leaves((stages, shared)), lr=1e-3,
                            weight_decay=1e-4)
    step = (tpp.make_pp_train_step(world_of_one, TCFG, remat=remat)
            if schedule == "gpipe" else
            tpp.make_pp_train_step_1f1b(world_of_one, TCFG))
    collectives.reset_collective_counts()
    loss = step(stages, shared, opt, tokens)
    counts = collectives.collective_counts()
    assert torch.equal(loss, want_loss.detach())
    got = tpp.merge_pipeline_params(stages, shared)
    for a, b in zip(tl.param_leaves(got), tl.param_leaves(want),
                    strict=True):
        assert torch.equal(a, b.detach())
    assert counts["collective-permute"] == dict(calls=0, bytes=0)
    assert counts["all-reduce"]["calls"] == 17
    nbytes = sum(t.numel() * 4 for t in tl.param_leaves(port_params))
    shared_bytes = sum(port_params[k].numel() * 4 for k in tpp.SHARED_KEYS)
    assert counts["all-reduce"]["bytes"] == 8 + nbytes + shared_bytes


def test_trainer_pipeline_needs_pp_mesh():
    """tests/test_trainer.py:108: no mesh with a pp axis, ValueError."""
    with pytest.raises(ValueError, match="pp"):
        Trainer(TCFG, torch.optim.SGD, family="pipeline")


def test_trainer_unknown_pp_schedule_raises(world_of_one):
    with pytest.raises(ValueError, match="pp_schedule"):
        Trainer(TCFG, torch.optim.SGD, mesh=world_of_one, family="pipeline",
                pp_schedule="interleaved", device="cpu")


# --- specs, split / merge ------------------------------------------------------


def test_split_merge_matches_jax(jax_params, port_params):
    """split_pipeline_params stacks the leaves as JAX's does; merge gives
    the tree back; pp = 3 does not divide 4 layers and raises."""
    jst, jsh = jpp.split_pipeline_params(jax_params, 4)
    st, sh = tpp.split_pipeline_params(port_params, 4)
    for k, v in jst.items():
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(v))
    for k, v in jsh.items():
        np.testing.assert_array_equal(sh[k].numpy(), np.asarray(v))
    merged = tpp.merge_pipeline_params(st, sh)
    for a, b in zip(tl.param_leaves(merged), tl.param_leaves(port_params),
                    strict=True):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="not divisible"):
        tpp.split_pipeline_params(port_params, 3)


@pytest.mark.parametrize("tp_axis", [None, "tp"])
def test_pipeline_shardings_match_jax(jax_params, port_params, tp_axis):
    mesh = jax_make_mesh(pp=2, tp=2 if tp_axis else 1, dp=-1)
    jst, jsh = jax.tree.map(
        lambda s: tuple(s.spec),
        jpp.pipeline_shardings(mesh, *jpp.split_pipeline_params(
            jax_params, 2), tp_axis=tp_axis),
        is_leaf=lambda x: hasattr(x, "spec"))
    st, sh = tpp.pipeline_shardings(
        None, *tpp.split_pipeline_params(port_params, 2), tp_axis=tp_axis)
    assert st == jst
    assert sh == jsh


def test_pipeline_shardings_structural_opt_state(port_params):
    """JAX test_pipeline_shardings_structural_opt_state: with embed cut
    to n_layers rows (its moments' dim 0 equals n_layers), every embed
    moment stays replicated; stage moments follow their stage's spec and
    the step counts are replicated."""
    stages, shared = tpp.split_pipeline_params(port_params, 2)
    shared = dict(shared, embed=shared["embed"][:TCFG.n_layers])
    leaves = tl.param_leaves((stages, shared))
    for leaf in leaves:
        leaf.requires_grad_(True)
        leaf.grad = torch.zeros_like(leaf)
    opt = torch.optim.Adam(leaves, lr=1e-3)
    opt.step()
    _, _, opt_specs = tpp.pipeline_shardings(
        None, stages, shared, opt.state_dict(), optimizer=opt)
    names = [*sorted(stages), *sorted(shared)]
    for pid, entry in opt_specs["state"].items():
        name = names[pid]
        assert entry["step"] == ()
        want = ("pp",) if name in stages else ()
        assert entry["exp_avg"] == entry["exp_avg_sq"] == want, name
    assert opt_specs["state"][names.index("embed")]["exp_avg"] == ()
