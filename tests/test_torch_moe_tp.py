"""Port parity: MoE under tensor-parallel serving (models/moe.py
`expert_shard_axis=`, models/llama.py `_mlp_block(tp_axis=)` on an MoE
layer, `Engine(mesh=)` on an MoE tree) against the JAX package's.

The config is tests/test_moe.py's (`MoEConfig.tiny_moe`, fp32), the
weights the JAX package's `init_moe_params(PRNGKey(0))` carried across by
`params_from_jax`. One spawn per file (`launch_multihost --simulate 2
--device cpu` running `tp_worker`) runs every case on 2 gloo ranks, each
holding 4 of the 8 experts, while the test process computes the JAX
side:

  * `moe_mlp_grouped(expert_shard_axis=)` (the grouped kernel's plain
    version on the rank's band, `base` its first sorted row) and one-hot
    `moe_mlp(expert_shard_axis=, capacity=n)`: the unsharded port block
    and JAX's `shard_map` over a tp = 2 mesh (tests/test_moe.py:254),
    rtol 1e-6 / atol 1e-7, with one all-reduce of [n, d].
  * `Engine(mesh=make_mesh(tp=2))` on capacity routing (test_moe.py:330)
    and on dropless routing with FA_TPU_GROUPED_MIN_TOKENS=1
    (test_moe.py:304), prefill_chunk 16 and decode_chunk 2: transcripts
    identical on both ranks, to the JAX engine under `make_mesh(tp=2,
    dp=-1)` and to the port's single-device engine; 2 all-reduces a
    layer and one logits all-gather a dispatch, nothing else. The
    dropless run's grouped products carry rank 1's band offset.

In the test process: a quantized MoE tree under a mesh raises ValueError
in both packages (JAX's `expand_param_shardings` cannot map a spec onto
an expert stack), and so does tp not dividing n_experts.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.models import moe as jm
from flash_attention_tpu.models import quantized as jq
from flash_attention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flash_attention_tpu.runtime import engine as jeng
from flash_attention_tpu_torch.models import moe as tm
from flash_attention_tpu_torch.models import quantized as tq
from flash_attention_tpu_torch.parallel import mesh as pmesh
from flash_attention_tpu_torch.runtime import engine as teng
from flash_attention_tpu_torch.utils.convert import params_from_jax
from flash_attention_tpu_torch.utils.metrics import max_abs_error

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jm.MoEConfig.tiny_moe(dtype=jnp.float32)
TP = 2
SPAWN_TIMEOUT_S = 240
ENGINE = dict(max_batch=2, num_pages=16, page_size=128, prefill_chunk=16,
              decode_chunk=2)
X = np.random.default_rng(42).normal(0, 0.02, (2, 13, JCFG.dim)).astype(
    np.float32)
_rng = np.random.default_rng(7)
PROMPTS = [[int(t) for t in _rng.integers(0, JCFG.vocab_size, n)]
           for n in (9, 21)]
NEW = 4
FORCED = {"FA_TPU_GROUPED_MIN_TOKENS": "1"}
# Engine cases: name -> (routing, environment).
ENGINE_CASES = {"capacity": ("capacity", {}),
                "dropless_forced": ("dropless", FORCED)}
BLOCK_ROUTES = ("grouped", "onehot")


def _tcfg(routing="capacity"):
    return tm.MoEConfig.tiny_moe(dtype=torch.float32, routing=routing)


def _jcfg(routing="capacity"):
    return jm.MoEConfig(**{**JCFG.__dict__, "routing": routing})


class MoeTpSpawn:
    """The block and engine cases at 2 gloo ranks (tp_worker), one spawn
    started when the object is made; `get()` waits for the results."""

    def __init__(self, port_tree):
        self.tmp = tempfile.TemporaryDirectory(prefix="fa_moe_tp_test_")
        d = self.tmp.name
        self.out = os.path.join(d, "out.pt")
        cfg = dict(preset="tiny_moe", dtype="float32")
        cases = [dict(name=f"block_{route}", kind="moe_block",
                      cfg=dict(cfg, routing="dropless"), route=route,
                      params="jax", mesh=dict(tp=TP),
                      x=torch.from_numpy(X))
                 for route in BLOCK_ROUTES]
        cases += [dict(name=name, params="jax", mesh=dict(tp=TP, dp=-1),
                       cfg=dict(cfg, routing=routing), engine=ENGINE,
                       env=env, record_bases=True,
                       requests=[dict(prompt=p, max_new_tokens=NEW)
                                 for p in PROMPTS])
                  for name, (routing, env) in ENGINE_CASES.items()]
        torch.save({"cases": cases, "params": {"jax": port_tree}},
                   os.path.join(d, "cases.pt"))
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "flash_attention_tpu_torch.scripts.launch_multihost",
             "--simulate", str(TP), "--device", "cpu", "--rendezvous-dir",
             d, "--timeout", str(SPAWN_TIMEOUT_S), "--", "-m",
             "flash_attention_tpu_torch.scripts.tp_worker",
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
                raise AssertionError(f"the MoE tp spawn timed out:\n{log}")
            assert self.proc.returncode == 0, \
                f"the MoE tp spawn failed ({self.proc.returncode}):\n{log}"
            got = torch.load(self.out, weights_only=True)
            assert (got["world"], got["backend"]) == (TP, "gloo")
            self._results = got["cases"]
            self.tmp.cleanup()
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
    sp = MoeTpSpawn(port_params)
    yield sp
    sp.kill()


def _jax_block(layer, route):
    """JAX's MoE block under shard_map over a tp = 2 mesh, the expert
    stacks sharded, x replicated (tests/test_moe.py:254)."""
    from jax.sharding import PartitionSpec as P

    cfg = _jcfg("dropless")
    n = X.shape[0] * X.shape[1]
    specs = {k: (P("tp") if k in tm.EXPERT_KEYS else P()) for k in layer}

    def block(lay, xx):
        if route == "grouped":
            return jm.moe_mlp_grouped(lay, xx, cfg, expert_shard_axis="tp")[0]
        return jm.moe_mlp(lay, xx, cfg, expert_shard_axis="tp",
                          capacity=n)[0]

    return np.asarray(jax.shard_map(
        block, mesh=jax_make_mesh(tp=TP, dp=-1), in_specs=(specs, P()),
        out_specs=P(), check_vma=False)(layer, jnp.asarray(X)))


def _jax_engine(params, routing, mesh=None):
    eng = jeng.Engine(params, _jcfg(routing), mesh=mesh, **ENGINE)
    reqs = [jeng.Request(prompt=list(p), max_new_tokens=NEW)
            for p in PROMPTS]
    by_id = {c.request_id: c.tokens for c in eng.run(reqs)}
    return [by_id[r.request_id] for r in reqs]


def _port_engine(params, routing):
    eng = teng.Engine(params, _tcfg(routing), device="cpu", **ENGINE)
    reqs = [teng.Request(prompt=list(p), max_new_tokens=NEW)
            for p in PROMPTS]
    by_id = {c.request_id: c.tokens for c in eng.run(reqs)}
    return [by_id[r.request_id] for r in reqs], eng


def _ranks_agree(results):
    r0, r1 = (r["transcripts"] for r in results)
    assert r0 == r1
    assert all(t[3] == "length" for t in r0)
    return [t[2] for t in r0]


# --- the spawn's cases (first, so the spawn overlaps the JAX side) ----------


@pytest.mark.parametrize("route", BLOCK_ROUTES)
def test_sharded_block_matches_unsharded_and_jax(spawn, jax_params,
                                                 port_params, route):
    """Each rank's block output: the unsharded port block at
    test_moe.py:254's rtol 1e-6 / atol 1e-7, and JAX's shard_map result
    within the port's MoE-block parity (max-abs 1e-5, test_torch_moe.py:
    fp32 sums in another order move outputs of ~1 by ~2e-6); one
    all-reduce of [n, d] fp32 and nothing else."""
    cfg = _tcfg("dropless")
    layer = port_params["layers"][0]
    x = torch.from_numpy(X)
    n = X.shape[0] * X.shape[1]
    with torch.no_grad():
        want = (tm.moe_mlp_grouped(layer, x, cfg)[0] if route == "grouped"
                else tm.moe_mlp(layer, x, cfg, capacity=n)[0])
    want_jax = _jax_block(jax_params["layers"][0], route)
    for r in spawn.get()[f"block_{route}"]:
        got = r["y"].numpy()
        np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=1e-7)
        assert max_abs_error(got, want_jax) <= 1e-5
        assert r["collectives"] == {
            "all-reduce": dict(calls=1, bytes=n * cfg.dim * 4),
            **{k: dict(calls=0, bytes=0) for k in
               ("all-gather", "collective-permute", "all-to-all")}}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_moe_engine_under_tp_matches_jax(spawn, jax_params, port_params,
                                         monkeypatch, case):
    """test_moe.py:330 (capacity) and :304 (dropless, grouped products at
    every dispatch): both ranks' transcripts equal the JAX engine's under
    make_mesh(tp=2, dp=-1) and the port's single-device engine's."""
    routing, env = ENGINE_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want_jax = _jax_engine(jax_params, routing,
                           mesh=jax_make_mesh(tp=TP, dp=-1))
    want, eng = _port_engine(port_params, routing)
    assert want == want_jax
    results = spawn.get()[case]
    assert _ranks_agree(results) == want
    for r in results:
        assert r["stats"]["decode_steps"] == eng.stats.decode_steps
        assert r["stats"]["prefill_chunks"] == eng.stats.prefill_chunks


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_moe_engine_under_tp_collectives_exact(spawn, port_params, case):
    """Every rank issues 2 all-reduces a layer (attention, MoE block) and
    one logits all-gather a model dispatch, no permute or all-to-all;
    the counts are the same on both ranks."""
    results = spawn.get()[case]
    cfg = _tcfg(ENGINE_CASES[case][0])
    for r in results:
        st, c = r["stats"], r["collectives"]
        dispatches = c["all-gather"]["calls"]
        assert dispatches >= st["decode_steps"] + st["prefill_chunks"]
        assert c["all-reduce"]["calls"] == 2 * cfg.n_layers * dispatches
        assert c["collective-permute"] == c["all-to-all"] == \
            dict(calls=0, bytes=0)
    assert results[0]["collectives"] == results[1]["collectives"]


def test_grouped_products_carry_the_band_offset(spawn):
    """Forced dropless: 3 grouped products a layer a dispatch on each
    rank; rank 0's band starts at row 0, rank 1's after the rows of
    experts 0-3 (a decode step's few rows may all fall in rank 1's band,
    so some of its offsets may be 0; most are not)."""
    results = spawn.get()["dropless_forced"]
    cfg = _tcfg("dropless")
    for r in results:
        assert len(r["bases"]) == 3 * cfg.n_layers * \
            r["collectives"]["all-gather"]["calls"]
    b0, b1 = results[0]["bases"], results[1]["bases"]
    assert set(b0) == {0}
    assert min(b1) >= 0 and sum(b > 0 for b in b1) > len(b1) // 2, b1


# --- a world of one and the guards ------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    pmesh.initialize_distributed(f"file://{tmp_path}/store", 1, 0,
                                 device="cpu")
    try:
        yield pmesh.make_mesh(tp=1, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", ["int4", "int8"])
def test_quantized_moe_tree_under_a_mesh_raises(world_of_one, jax_params,
                                                dtype):
    """Quantized expert stacks under a mesh: ValueError in the port (the
    engine) and in the JAX package (its expand_param_shardings)."""
    cfg = _tcfg("dropless")
    with pytest.raises(ValueError):
        jq.expand_param_shardings(
            jq.quantize_moe_params(jax_params,
                                   dtype="int4" if dtype == "int4"
                                   else jnp.int8),
            jl.serving_param_shardings(JCFG, TP))
    params = tq.init_quantized_moe_params(
        cfg, 0, "int4" if dtype == "int4" else torch.int8, device="cpu")
    with pytest.raises(ValueError, match="expert stack"):
        teng.Engine(params, cfg, mesh=world_of_one, device="cpu",
                    num_pages=4, page_size=128)


class _FakeAxis:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


class _FakeMesh:
    def __getitem__(self, axis):
        return _FakeAxis(TP if axis == "tp" else 1)


def test_tp_must_divide_n_experts():
    """3 experts over tp = 2 (which divides the 2 kv heads): ValueError
    from the engine, as from JAX's serving_param_shardings."""
    cfg = dataclasses.replace(_tcfg(), n_experts=3)
    params = tm.init_moe_params(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="n_experts"):
        teng.Engine(params, cfg, mesh=_FakeMesh(), device="cpu",
                    num_pages=4, page_size=128)
    with pytest.raises(ValueError, match="n_experts"):
        jl.serving_param_shardings(
            jm.MoEConfig(**{**JCFG.__dict__, "n_experts": 3}), TP)
