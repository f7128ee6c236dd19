"""Port parity: tensor-parallel serving (models/llama.py
`serving_param_shardings` / `param_shardings` / `tp_axis=`,
models/quantized.py `expand_param_shardings`, parallel/mesh.py
`shard_params`, `Engine(mesh=)`) against the JAX package's.

  * The specs equal JAX's leaf for leaf (`tuple(PartitionSpec)`) for
    `tiny`, `llama3_8b` and `llama3_70b` at tp 1, 2, 4 and 8, on dense,
    int8 and int4 trees, with param_shardings' replicated-KV fallback
    and an MoE config's expert layout, and raise where JAX's raise.
  * `shard_params`' shards, concatenated along their named dims, give
    back every leaf; quantized shards dequantize to exact slices of the
    whole; an int4 row shard off a 128-row scale group raises.
  * One spawn per file (`launch_multihost --simulate 2 --device cpu`
    running `tp_worker`) serves every engine case on 2 gloo ranks of
    `LlamaConfig.tiny` (fp32, page 128) with the JAX package's
    parameters (`params_from_jax`). The transcripts of both ranks must
    be identical to each other and:
      - to the JAX engine under `make_mesh(tp=2, dp=-1)` in the two
        cases of tests/test_engine_sharded.py that are not slow (dense
        and int4 weights);
      - to the JAX single-device engine in the configurations of its
        slow cases (prefill_chunk 16 with decode_chunk 4, int8 KV, int8
        weights);
      - to the port's one-process engine for a windowed config with
        chunked prefill and the prefix cache, an n-gram speculative
        engine (k = 2) and sampled rows (temperature > 0).
    Each rank counts exactly 2 all-reduces a layer and one all-gather a
    dispatch, of the activations' and the logits' bytes.
  * `tp_decode_collective_bytes(tiny, 2, 4)` gives exactly 2 L B dim 4
    all-reduce bytes and B vocab 4 all-gather bytes, within the JAX
    test's bounds (tests/test_scaling.py:52-70).
  * In a gloo world of one, the engine under `make_mesh(tp=1)` gives the
    engine without a mesh's transcripts with the same counts, and raises
    with draft params and with quantized MoE params.
"""

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
from flash_attention_tpu.models import quantized as jq
from flash_attention_tpu.parallel.mesh import make_mesh as jax_make_mesh
from flash_attention_tpu.runtime import engine as jeng
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.models import quantized as tq
from flash_attention_tpu_torch.models.moe import MoEConfig
from flash_attention_tpu_torch.parallel import collectives
from flash_attention_tpu_torch.parallel import mesh as pmesh
from flash_attention_tpu_torch.runtime import engine as teng
from flash_attention_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)
WINDOW = 96
PAGE = 128
ENGINE = dict(max_batch=4, num_pages=32, page_size=PAGE)
SPAWN_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def trees():
    """The JAX package's tiny fp32 tree and its int4 / int8 trees, each
    also as the port's."""
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    jax_trees = {"dense": jp,
                 "int4": jq.quantize_params(jp, dtype="int4"),
                 "int8": jq.quantize_params(jp, dtype=jnp.int8)}
    port = {k: params_from_jax(jax.tree.map(np.asarray, v), device="cpu")
            for k, v in jax_trees.items()}
    return jax_trees, port


def _sharded_prompts():
    """tests/test_engine_sharded.py's prompts (its `rng` fixture)."""
    rng = np.random.default_rng(42)
    return [[int(x) for x in rng.integers(0, JCFG.vocab_size, n)]
            for n in (9, 21)]


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [[int(x) for x in rng.integers(0, JCFG.vocab_size, n)]
            for n in lens]


def _reqs(prompts, n_new, **kw):
    return [dict(prompt=p, max_new_tokens=n_new, **kw) for p in prompts]


# The spawn's engine cases: name -> (tree, engine keywords, waves, config
# keywords beyond tiny fp32).
SPEC_PROMPTS = [[5, 6, 7, 8] * 6, _prompts(11, (30,))[0]]
SAMPLED = [dict(prompt=p, max_new_tokens=8, temperature=t, top_p=tp)
           for p, t, tp in zip(_prompts(12, (12, 25, 7)), (0.8, 0.0, 1.3),
                               (0.9, 0.0, 0.0))]
CASES = {
    "dense": ("dense", ENGINE, [_reqs(_sharded_prompts(), 6)], {}),
    "int4": ("int4", ENGINE, [_reqs(_sharded_prompts(), 6)], {}),
    "chunked": ("dense", dict(ENGINE, prefill_chunk=16, decode_chunk=4),
                [_reqs(_sharded_prompts(), 8)], {}),
    "int8_kv": ("dense", dict(ENGINE, kv_quant_dtype="int8"),
                [_reqs(_sharded_prompts(), 6)], {}),
    "int8_weights": ("int8", ENGINE, [_reqs(_sharded_prompts(), 6)], {}),
    "window_prefix": ("dense", dict(ENGINE, max_batch=2, tail_size=16,
                                    prefill_chunk=32, prefix_cache=True),
                      [_reqs(_prompts(3, (150,)), 6)] * 2,
                      {"window": WINDOW}),
    "ngram_spec": ("dense", dict(ENGINE, max_batch=3, speculative_k=2),
                   [_reqs(SPEC_PROMPTS, 10)], {}),
    "sampled": ("dense", dict(ENGINE, seed=7), [SAMPLED], {}),
}


class TpSpawn:
    """The port's engine cases at 2 gloo ranks (tp_worker), one spawn
    started when the object is made, so it runs while the test process
    computes the JAX side; `get()` waits and returns the results."""

    def __init__(self, port_trees):
        self.tmp = tempfile.TemporaryDirectory(prefix="fa_tp_test_")
        d = self.tmp.name
        self.out = os.path.join(d, "out.pt")
        cases = [dict(name=name, params=tree, engine=kw, waves=waves,
                      mesh=dict(tp=2, dp=-1),
                      cfg=dict(dtype="float32", **cfg_kw))
                 for name, (tree, kw, waves, cfg_kw) in CASES.items()]
        cases.append(dict(name="collective_bytes", kind="collective_bytes",
                          cfg=dict(dtype="float32"), tp=2, batch=4))
        torch.save({"cases": cases, "params": port_trees},
                   os.path.join(d, "cases.pt"))
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "flash_attention_tpu_torch.scripts.launch_multihost",
             "--simulate", "2", "--device", "cpu", "--rendezvous-dir", d,
             "--timeout", str(SPAWN_TIMEOUT_S), "--", "-m",
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
                raise AssertionError(f"the tp spawn timed out:\n{log}")
            assert self.proc.returncode == 0, \
                f"the tp spawn failed ({self.proc.returncode}):\n{log}"
            got = torch.load(self.out, weights_only=True)
            assert (got["world"], got["backend"]) == (2, "gloo")
            self._results = got["cases"]
            self.tmp.cleanup()
        return self._results

    def kill(self):
        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.communicate()
        self.tmp.cleanup()


@pytest.fixture(scope="module")
def spawn(trees):
    sp = TpSpawn(trees[1])
    yield sp
    sp.kill()


def _tokens(transcripts):
    return [t[2] for t in transcripts]


def _ranks_agree(results):
    """Both ranks' transcripts, identical to each other; returns rank
    0's token lists."""
    r0, r1 = (r["transcripts"] for r in results)
    assert r0 == r1
    assert all(t[3] == "length" for t in r0)
    return _tokens(r0)


def _jax_engine(tree, waves, mesh=None, cfg=JCFG, **kw):
    eng = jeng.Engine(tree, cfg, mesh=mesh, **kw)
    out = []
    for wave in waves:
        reqs = [jeng.Request(**r) for r in wave]
        by_id = {c.request_id: c.tokens for c in eng.run(reqs)}
        out += [by_id[r.request_id] for r in reqs]
    return out


def _port_engine(tree, waves, cfg=TCFG, **kw):
    kw = dict(kw)
    if kw.get("kv_quant_dtype") is not None:
        kw["kv_quant_dtype"] = getattr(torch, kw["kv_quant_dtype"])
    eng = teng.Engine(tree, cfg, device="cpu", **kw)
    out = []
    for wave in waves:
        reqs = [teng.Request(**r) for r in wave]
        by_id = {c.request_id: c.tokens for c in eng.run(reqs)}
        out += [by_id[r.request_id] for r in reqs]
    return out, eng


def _expected_collectives(results, case):
    """Each rank's counts against 2 all-reduces a layer and one logits
    all-gather a model dispatch: bytes from the dispatch shapes."""
    _, kw, waves, _ = CASES[case]
    for r in results:
        st = r["stats"]
        dispatches = r["collectives"]["all-gather"]["calls"]
        assert r["collectives"]["all-reduce"]["calls"] == \
            2 * TCFG.n_layers * dispatches
        assert dispatches >= st["decode_steps"] + st["prefill_chunks"]


# --- the spawn's cases (first, so the spawn overlaps the JAX side) ----------


@pytest.mark.parametrize("case", ["dense", "int4"])
def test_sharded_engine_matches_jax_sharded_engine(spawn, trees, case):
    """tests/test_engine_sharded.py:43 and :80 (int4): 2 gloo ranks give
    the JAX engine's transcripts under make_mesh(tp=2, dp=-1)."""
    tree, kw, waves, _ = CASES[case]
    want = _jax_engine(trees[0][tree], waves, mesh=jax_make_mesh(tp=2, dp=-1),
                       **kw)
    got = _ranks_agree(spawn.get()[case])
    assert got == want


@pytest.mark.parametrize("case", ["chunked", "int8_kv", "int8_weights"])
def test_sharded_engine_matches_jax_in_the_slow_configurations(
        spawn, trees, case):
    """The configurations of tests/test_engine_sharded.py:52, :64 and
    :80 (int8): the transcripts of the JAX single-device engine."""
    tree, kw, waves, _ = CASES[case]
    kw = dict(kw)
    if kw.get("kv_quant_dtype") is not None:
        kw["kv_quant_dtype"] = jnp.int8
    want = _jax_engine(trees[0][tree], waves, **kw)
    assert _ranks_agree(spawn.get()[case]) == want


@pytest.mark.parametrize("case", ["window_prefix", "ngram_spec", "sampled"])
def test_sharded_engine_matches_one_process(spawn, trees, case):
    """A windowed config with chunked prefill and the prefix cache (the
    second wave seeded from cached pages), n-gram speculative decoding
    (k = 2) and sampled rows: the port's one-process engine's
    transcripts, on both ranks."""
    tree, kw, waves, cfg_kw = CASES[case]
    want, eng = _port_engine(trees[1][tree], waves,
                             cfg=tl.LlamaConfig.tiny(dtype=torch.float32,
                                                     **cfg_kw), **kw)
    results = spawn.get()[case]
    assert _ranks_agree(results) == want
    for r in results:
        for key in ("decode_steps", "prefill_chunks", "spec_accepted",
                    "prefix_cached_tokens"):
            assert r["stats"][key] == getattr(eng.stats, key), key
    if case == "window_prefix":
        assert eng.stats.prefix_cached_tokens == PAGE


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_engine_collective_counts(spawn, case):
    """Every rank issues 2 all-reduces a layer and one all-gather a model
    dispatch, nothing else; their bytes are the same on both ranks."""
    results = spawn.get()[case]
    _expected_collectives(results, case)
    assert results[0]["collectives"] == results[1]["collectives"]


def test_tp_decode_collective_bytes_is_megatron(spawn):
    """tp_decode_collective_bytes(tiny, 2, 4): exactly 2 L B dim 4
    all-reduce bytes and B vocab 4 all-gather bytes (an output of the
    whole vocab), within tests/test_scaling.py:52-70's bounds."""
    tp, batch, cfg = 2, 4, TCFG
    expect_ar = 2 * cfg.n_layers * batch * cfg.dim * 4
    expect_ag = batch * cfg.vocab_size * 4
    for got in spawn.get()["collective_bytes"]:
        assert got == {"all-reduce": expect_ar, "all-gather": expect_ag}
        ar = got.get("all-reduce", 0)
        assert expect_ar <= ar <= 2 * expect_ar
        assert sum(got.values()) >= \
            expect_ar + batch * cfg.vocab_size * 4 // tp


# --- a world of one ------------------------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    pmesh.initialize_distributed(f"file://{tmp_path}/store", 1, 0,
                                 device="cpu")
    try:
        yield pmesh.make_mesh(tp=1, device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_world_of_one_engine_equals_the_engine_without_a_mesh(
        world_of_one, trees):
    """make_mesh(tp=1): the no-mesh engine's transcripts, and the
    collectives issued and counted as at any world size (a group of one
    still calls)."""
    tree = trees[1]["int4"]
    waves = [_reqs(_sharded_prompts(), 5)]
    want, _ = _port_engine(tree, waves, **ENGINE)
    collectives.reset_collective_counts()
    eng = teng.Engine(tree, TCFG, mesh=world_of_one, device="cpu", **ENGINE)
    got = [c.tokens for c in eng.run([teng.Request(**r) for r in waves[0]])]
    assert got == want
    counts = collectives.collective_counts()
    dispatches = eng.stats.decode_steps + len(waves[0])
    assert counts["all-gather"]["calls"] == dispatches
    assert counts["all-reduce"]["calls"] == 2 * TCFG.n_layers * dispatches
    # Two 64-row prefill buckets and decode steps of max_batch rows.
    rows = 2 * 64 + ENGINE["max_batch"] * eng.stats.decode_steps
    assert counts["all-reduce"]["bytes"] == \
        2 * TCFG.n_layers * rows * TCFG.dim * 4
    assert counts["all-gather"]["bytes"] == \
        (2 + ENGINE["max_batch"] * eng.stats.decode_steps) \
        * TCFG.vocab_size * 4


def test_engine_under_a_mesh_raises_for_draft_and_moe(world_of_one, trees):
    """Model drafts under a mesh raise NotImplementedError, as in JAX
    (runtime/engine.py:407-410); an MoE tree with quantized expert stacks
    raises ValueError (JAX's expand_param_shardings cannot map a spec
    onto an expert stack; dense MoE trees serve, tests/test_torch_moe_tp.py)."""
    from flash_attention_tpu_torch.models.quantized import (
        init_quantized_moe_params,
    )

    with pytest.raises(NotImplementedError, match="drafts under TP"):
        teng.Engine(trees[1]["dense"], TCFG, mesh=world_of_one,
                    device="cpu", speculative_k=2,
                    draft_params=trees[1]["dense"], draft_cfg=TCFG)
    mcfg = MoEConfig.tiny_moe(dtype=torch.float32)
    with pytest.raises(ValueError, match="expert stack"):
        teng.Engine(init_quantized_moe_params(mcfg, 0, "int4", device="cpu"),
                    mcfg, mesh=world_of_one, device="cpu")


# --- specs -----------------------------------------------------------------


SPEC_CONFIGS = ("tiny", "llama3_8b", "llama3_70b")
TP_SIZES = (1, 2, 4, 8)
NC = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
      "w_down": 1}


def _shapes(cfg):
    d, hd = cfg.dim, cfg.head_dim
    layer = {"attn_norm": (d,), "wq": (d, cfg.n_heads, hd),
             "wk": (d, cfg.n_kv_heads, hd), "wv": (d, cfg.n_kv_heads, hd),
             "wo": (cfg.n_heads, hd, d), "mlp_norm": (d,),
             "w_gate": (d, cfg.ffn_dim), "w_up": (d, cfg.ffn_dim),
             "w_down": (cfg.ffn_dim, d)}
    return layer, {"embed": (cfg.vocab_size, d), "final_norm": (d,),
                   "lm_head": (d, cfg.vocab_size)}


def _skeleton(cfg, kind, pkg):
    """A tree of the model's structure with placeholder leaves (shape only)
    for the JAX ("jax") or the port's ("torch") expand_param_shardings:
    `kind` "dense", "int8" or "int4"."""
    layer, top = _shapes(cfg)

    def leaf(name, shape):
        if kind == "dense" or name not in {*NC, "lm_head"}:
            return (jax.ShapeDtypeStruct(shape, jnp.float32) if pkg == "jax"
                    else torch.empty(shape, device="meta"))
        mod = jq if pkg == "jax" else tq
        cls = mod.Int4Weight if kind == "int4" else mod.QuantizedWeight
        return cls(None, None, orig_shape=shape, n_contract=NC.get(name, 1))

    out = {k: leaf(k, s) for k, s in top.items()}
    out["layers"] = [{k: leaf(k, s) for k, s in layer.items()}
                     for _ in range(cfg.n_layers)]
    return out


def _plain(tree):
    """A spec tree (either package's) as nested dicts / lists of tuples;
    a quantized node as (class name, its field specs, orig_shape,
    n_contract)."""
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain(v) for v in tree]
    if isinstance(tree, (jq.QuantizedWeight, tq.QuantizedWeight)):
        return ("QuantizedWeight", tuple(tree.q), tuple(tree.scale),
                tuple(tree.orig_shape), tree.n_contract)
    if isinstance(tree, (jq.Int4Weight, tq.Int4Weight)):
        return ("Int4Weight", tuple(tree.packed), tuple(tree.scales),
                tuple(tree.orig_shape), tree.n_contract)
    return tuple(tree)


def _cfgs(name):
    # Two layers are enough: every layer has the same specs.
    return (getattr(jl.LlamaConfig, name)(n_layers=2),
            getattr(tl.LlamaConfig, name)(n_layers=2))


@pytest.mark.parametrize("name", SPEC_CONFIGS)
@pytest.mark.parametrize("tp", TP_SIZES)
def test_serving_param_shardings_match_jax(name, tp):
    jcfg, tcfg = _cfgs(name)
    if jcfg.n_kv_heads % tp:
        with pytest.raises(ValueError, match="must divide n_kv_heads"):
            jl.serving_param_shardings(jcfg, tp)
        with pytest.raises(ValueError, match="must divide n_kv_heads"):
            tl.serving_param_shardings(tcfg, tp)
        return
    assert _plain(tl.serving_param_shardings(tcfg, tp)) == \
        _plain(jl.serving_param_shardings(jcfg, tp))


@pytest.mark.parametrize("tp,experts", [(1, 8), (2, 8), (2, 6), (4, 6)])
def test_moe_serving_param_shardings_match_jax(tp, experts):
    """An MoE config's serving specs (the expert stacks over tp, the router
    replicated) equal JAX's; tp not dividing n_experts (or n_kv_heads)
    raises in both."""
    from flash_attention_tpu.models.moe import MoEConfig as JMoEConfig

    kw = dict(n_kv_heads=4, n_experts=experts)
    jcfg, tcfg = JMoEConfig(**{**_moe_base(), **kw}), \
        MoEConfig(**{**_moe_base(), **kw})
    if experts % tp:
        for mod, cfg in ((jl, jcfg), (tl, tcfg)):
            with pytest.raises(ValueError, match="n_experts"):
                mod.serving_param_shardings(cfg, tp)
        return
    assert _plain(tl.serving_param_shardings(tcfg, tp)) == \
        _plain(jl.serving_param_shardings(jcfg, tp))


def _moe_base():
    return dict(vocab_size=512, dim=256, n_layers=2, n_heads=4, ffn_dim=512,
                top_k=2)


@pytest.mark.parametrize("name", SPEC_CONFIGS)
@pytest.mark.parametrize("tp", (None, *TP_SIZES))
def test_param_shardings_match_jax(name, tp):
    """Training specs, with the KV replication where tp does not divide
    n_kv_heads (tiny at tp 4 and 8)."""
    jcfg, tcfg = _cfgs(name)
    got = _plain(tl.param_shardings(tcfg, tp))
    assert got == _plain(jl.param_shardings(jcfg, tp))
    if tp is not None and tcfg.n_kv_heads % tp:
        assert got["layers"][0]["wk"] == ("fsdp", None, None)


# tiny has 2 kv heads, the 8B and 70B 8: the tp sizes that divide them.
EXPAND_CASES = [(name, tp) for name in SPEC_CONFIGS for tp in TP_SIZES
                if _cfgs(name)[0].n_kv_heads % tp == 0]


@pytest.mark.parametrize("name,tp", EXPAND_CASES)
@pytest.mark.parametrize("kind", ("dense", "int8", "int4"))
def test_expand_param_shardings_match_jax(name, tp, kind):
    jcfg, tcfg = _cfgs(name)
    want = jq.expand_param_shardings(_skeleton(jcfg, kind, "jax"),
                                     jl.serving_param_shardings(jcfg, tp))
    got = tq.expand_param_shardings(_skeleton(tcfg, kind, "torch"),
                                    tl.serving_param_shardings(tcfg, tp))
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("kind", ("int8", "int4"))
@pytest.mark.parametrize("bad", ("wo", "wq"))
def test_expand_param_shardings_raises_off_a_leading_dim(kind, bad):
    """An axis on a group's second dim raises in both packages (wo's
    contracted (heads, head_dim) group, wq's output (heads, head_dim)
    group)."""
    jcfg, tcfg = _cfgs("tiny")
    spec = ((None, "tp", None) if bad == "wo" else (None, None, "tp"))
    for pkg, mod, lmod, cfg in (("jax", jq, jl, jcfg),
                                ("torch", tq, tl, tcfg)):
        specs = lmod.serving_param_shardings(cfg, 2)
        specs["layers"] = [dict(specs["layers"][0],
                                **{bad: (jax.sharding.PartitionSpec(*spec)
                                         if pkg == "jax" else spec)})] * 2
        with pytest.raises(ValueError, match="leading dim"):
            mod.expand_param_shardings(_skeleton(cfg, kind, pkg), specs)


# --- shard_params ----------------------------------------------------------


class _FakeAxis:
    def __init__(self, n):
        self.n = n

    def size(self):
        return self.n


class _FakeMesh:
    """A mesh of one rank's coordinates (shard_params reads each axis's
    size and this rank's place on it)."""

    def __init__(self, tp, rank):
        self.tp, self.rank = tp, rank

    def __getitem__(self, axis):
        return _FakeAxis(self.tp if axis == "tp" else 1)

    def get_local_rank(self, axis):
        return self.rank if axis == "tp" else 0


def _shards(tree, specs, tp):
    return [pmesh.shard_params(tree, specs, _FakeMesh(tp, r), device="cpu")
            for r in range(tp)]


def _named_dim(spec):
    named = [i for i, a in enumerate(spec) if a is not None]
    return named[0] if named else None


@pytest.mark.parametrize("tp", (1, 2))
def test_shard_params_concatenates_back_dense(trees, tp):
    tree = trees[1]["dense"]
    specs = tl.serving_param_shardings(TCFG, tp)
    shards = _shards(tree, specs, tp)
    pairs = [("embed",), ("final_norm",), ("lm_head",)] + [
        ("layers", i, k) for i in range(TCFG.n_layers) for k in NC]

    def get(t, path):
        for p in path:
            t = t[p]
        return t

    for path in pairs:
        whole, spec = get(tree, path), get(specs, path)
        parts = [get(s, path) for s in shards]
        dim = _named_dim(spec)
        if dim is None:
            assert all(torch.equal(p, whole) for p in parts)
        else:
            assert all(p.shape[dim] == whole.shape[dim] // tp for p in parts)
            assert torch.equal(torch.cat(parts, dim), whole), path


@pytest.mark.parametrize("kind", ("int8", "int4"))
def test_shard_params_quantized_shards_dequantize_to_slices(trees, kind):
    """Each quantized shard dequantizes to exactly its slice of the whole
    weight's dequantization (int4 row shards of wo and w_down included),
    and carries the slice's logical shape."""
    tp, tree = 2, trees[1][kind]
    specs = tl.serving_param_shardings(TCFG, tp)
    expanded = tq.expand_param_shardings(tree, specs)
    shards = _shards(tree, expanded, tp)
    for name in NC:
        w = tree["layers"][0][name]
        dim = _named_dim(specs["layers"][0][name])
        parts = [s["layers"][0][name] for s in shards]
        for p in parts:
            want = list(w.orig_shape)
            want[dim] //= tp
            assert tuple(p.orig_shape) == tuple(want)
        whole = w.dequant(torch.float32)
        assert torch.equal(
            torch.cat([p.dequant(torch.float32) for p in parts], dim), whole)
    head = [s["lm_head"].dequant(torch.float32) for s in shards]
    assert torch.equal(torch.cat(head, 1),
                       tree["lm_head"].dequant(torch.float32))


def test_shard_params_int4_row_shard_must_cut_on_a_scale_group(trees):
    """tiny's w_down has 512 rows: 8 ranks would leave 64, half a
    128-row scale group."""
    w = trees[1]["int4"]["layers"][0]["w_down"]
    spec = tq.expand_param_shardings({"w": w}, {"w": ("tp", None)})
    with pytest.raises(ValueError, match="scale group"):
        pmesh.shard_params({"w": w}, spec, _FakeMesh(8, 0), device="cpu")
