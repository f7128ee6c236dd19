"""Package rules of the PyTorch/CUDA port (flash_attention_tpu_torch).

  * Nothing in the port, nor chip_smoke.py, imports jax or the JAX
    package (AST walk over every .py file).
  * Entry points default to device="cuda"; on a host without a card that
    default raises instead of dropping to the CPU (the mesh and the
    process group too).
  * Features that later slices port (the engine's mesh, the backward of
    windowed or segmented attention, trainer families, expert-parallel
    MoE placements) raise NotImplementedError instead of being accepted
    and ignored; options the port rejects by design raise ValueError.
  * Quantized KV constructs (int8 / fp8 engines, cache_dtype, book_s).
"""

import ast
import pathlib

import pytest
import torch

import flash_attention_tpu_torch
from flash_attention_tpu_torch.models.llama import LlamaConfig, init_params
from flash_attention_tpu_torch.models.trainer import Trainer
from flash_attention_tpu_torch.ops.flash import (
    flash_attention,
    flash_attention_fwd,
)
from flash_attention_tpu_torch.runtime.engine import Engine, Request
from flash_attention_tpu_torch.runtime.kv_cache import LayeredPagedKVCache
from flash_attention_tpu_torch.utils.convert import params_from_jax

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = pathlib.Path(flash_attention_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "flash_attention_tpu", "jaxlib")
CFG = LlamaConfig.tiny(dtype=torch.float32)


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def _sources():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10 and all(f.exists() for f in files)
    return files


def test_ast_rule_covers_the_study_harness():
    """The import rule walks the kernel-study harness's modules too."""
    names = {str(p.relative_to(PKG)) for p in _sources()
             if PKG in p.parents}
    assert {"cli.py", "ops/variants.py", "ops/dispatch.py",
            "utils/bench.py"} <= names


def test_ast_rule_covers_the_probe_scripts():
    """The import rule walks the port's probes (scripts/) too: they
    keep their own copies of what the JAX probes take from the JAX
    package."""
    names = {str(p.relative_to(PKG)) for p in _sources()
             if PKG in p.parents}
    assert {"scripts/__init__.py", "scripts/_common.py",
            "scripts/probe_int4_variants.py", "scripts/probe_paged_int8.py",
            "scripts/probe_lmhead_argmax.py"} <= names


def test_ast_rule_covers_the_parallel_package():
    """The import rule walks the multi-device modules (the process
    group, mesh and ring attention) and their scripts too."""
    names = {str(p.relative_to(PKG)) for p in _sources()
             if PKG in p.parents}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/ring.py",
            "scripts/launch_multihost.py", "scripts/ring_worker.py",
            "scripts/multihost_worker.py"} <= names


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    for mod in _imported_roots(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path} imports {mod}"


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(CFG, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        LayeredPagedKVCache(n_layers=1, kv_heads=1, head_dim=64,
                            num_pages=2, page_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({"w": [[1.0]]})
    params = init_params(CFG, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(params, CFG, num_pages=4, page_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(CFG, torch.optim.SGD)


def test_multi_device_defaults_raise_without_a_card():
    """make_mesh() and initialize_distributed() default to the card
    (NCCL) and raise on a host without one, before any group exists."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    from flash_attention_tpu_torch.parallel.mesh import (
        initialize_distributed, make_mesh,
    )

    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_distributed()
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize_distributed("127.0.0.1:1", 2, 0)


@pytest.mark.parametrize("kw, exc, match", [
    (dict(speculative_k=2, decode_chunk=2), ValueError, "mutually exclusive"),
    (dict(draft_fn=lambda h, k: h[:k], speculative_k=2,
          speculative_rounds=2), ValueError, "draft model"),
    (dict(draft_params={}), ValueError, "requires speculative_k"),
    (dict(mesh=object(), speculative_k=2, draft_params={},
          draft_cfg=CFG), NotImplementedError, "drafts under TP"),
    (dict(prefill_hbm_budget=1 << 30, prefill_chunk=32), ValueError,
     "prefill_hbm_budget"),
], ids=["speculative_k", "draft_fn", "draft_params", "mesh",
        "prefill_hbm_budget"])
def test_engine_unported_features_raise(kw, exc, match):
    """Chunked prefill, the prefix cache, quantized KV and speculative
    decoding (n-gram and draft-model drafts, rounds) are ported, with the
    JAX engine's guards: speculation beside decode_chunk > 1, rounds over
    a host draft_fn, and a draft model without speculative_k raise
    ValueError. A mesh with a draft model raises NotImplementedError, as
    in the JAX engine (tensor-parallel serving is tests/test_torch_tp.py's);
    a rolling-buffer budget on a model without a window is refused (the
    JAX engine ignores it)."""
    params = init_params(CFG, seed=0, device="cpu")
    with pytest.raises(exc, match=match):
        Engine(params, CFG, num_pages=4, page_size=16, device="cpu", **kw)
    Engine(params, CFG, num_pages=4, page_size=16, device="cpu",
           prefill_chunk=32, prefix_cache=True, speculative_k=2)


@pytest.mark.parametrize("dt", [torch.int8, torch.float8_e4m3fn],
                         ids=["kv_quant_dtype", "kv_quant_dtype_fp8"])
def test_engine_quantized_kv_constructs(dt):
    """Quantized KV is ported: the engine builds int8 / fp8 pages with
    fp32 scale pools of [Hkv, P, page/128, D] and dense tails, and a
    page size that is not a multiple of 128 is refused."""
    params = init_params(CFG, seed=0, device="cpu")
    eng = Engine(params, CFG, num_pages=4, page_size=128, device="cpu",
                 kv_quant_dtype=dt)
    cache = eng.cache
    assert cache.k_pools[0].dtype == dt and cache.quant_dtype == dt
    assert tuple(cache.k_scale_pools[0].shape) == (
        CFG.n_kv_heads, 4, 1, CFG.head_dim)
    assert cache.k_tails[0].dtype == CFG.dtype
    with pytest.raises(ValueError, match="multiple of 128"):
        Engine(params, CFG, num_pages=4, page_size=64, device="cpu",
               kv_quant_dtype=dt)


def test_engine_cache_dtype():
    """cache_dtype sets the dense pool and tail dtype on the CPU; on the
    card a dense pool dtype B4 does not take raises, naming it."""
    params = init_params(CFG, seed=0, device="cpu")
    eng = Engine(params, CFG, num_pages=4, page_size=16, device="cpu",
                 cache_dtype=torch.bfloat16)
    assert eng.cache.k_pools[0].dtype == torch.bfloat16
    assert eng.cache.k_tails[0].dtype == torch.bfloat16
    (c,) = eng.run([Request(prompt=[1, 2, 3], max_new_tokens=3)])
    assert len(c.tokens) == 3
    if not torch.cuda.is_available():
        return
    with pytest.raises(ValueError, match="cache_dtype"):
        Engine(params, CFG, num_pages=4, page_size=16, device="cuda",
               cache_dtype=torch.float16)


def test_engine_stats_book_s():
    """EngineStats.book_s (host-side batch assembly) starts at 0 and
    grows with decode steps."""
    from flash_attention_tpu_torch.runtime.engine import EngineStats

    assert EngineStats().book_s == 0.0
    params = init_params(CFG, seed=0, device="cpu")
    eng = Engine(params, CFG, num_pages=4, page_size=16, device="cpu")
    eng.run([Request(prompt=[1, 2, 3], max_new_tokens=3)])
    assert eng.stats.book_s > 0.0


def test_unported_model_features_raise():
    """Windowed models serve (the window slice) unless the window does
    not exceed the tail (ValueError, as the JAX engine); MoE models serve
    (the MoE slice): Engines over both construct on the CPU."""
    from flash_attention_tpu_torch.models.moe import (
        MoEConfig, init_moe_params,
    )

    windowed = LlamaConfig.tiny(dtype=torch.float32, window=64)
    params = init_params(windowed, seed=0, device="cpu")
    with pytest.raises(ValueError, match="window"):
        Engine(params, windowed, num_pages=4, page_size=16, device="cpu")
    eng = Engine(params, windowed, num_pages=16, page_size=16,
                 tail_size=8, prefill_chunk=16, prefix_cache=True,
                 device="cpu")
    assert eng._wbuf == 64 + 16 + 16
    moe = MoEConfig.tiny_moe(dtype=torch.float32, routing="dropless")
    eng = Engine(init_moe_params(moe, seed=0, device="cpu"), moe,
                 num_pages=4, page_size=16, device="cpu")
    assert eng.cfg is moe and "router" in eng.params["layers"][0]


def test_unported_attention_options_raise():
    """Bare int8 codes (without scales) are refused; windows and segment
    ids run forward and backward (with their argument checks: the
    backward of a windowed or segmented forward, once a raise, gives the
    plain backward's gradients); inputs that require grad get finite
    gradients."""
    from flash_attention_tpu_torch.ops.flash import (
        SegmentIds, flash_attention_bwd,
    )

    q = torch.zeros(1, 2, 8, 64)
    seg = SegmentIds(torch.zeros(1, 8, dtype=torch.int32),
                     torch.zeros(1, 8, dtype=torch.int32))
    o, lse = flash_attention_fwd(q, q, q, seg, causal=True, window=4)
    assert o.shape == q.shape and bool(torch.isfinite(lse).all())
    with pytest.raises(ValueError, match="causal"):
        flash_attention_fwd(q, q, q, window=4)
    with pytest.raises(ValueError, match="segment id shapes"):
        flash_attention_fwd(q, q, q, SegmentIds(seg.q[:, :4], seg.kv))
    from flash_attention_tpu_torch.ops.flash import (
        flash_attention_bwd_plain,
    )

    for kw in (dict(causal=True, window=4), dict(segment_ids=seg)):
        o, lse = flash_attention_fwd(q, q, q, **kw)
        got = flash_attention_bwd(q, q, q, o, lse, q, **kw)
        want = flash_attention_bwd_plain(q, q, q, o, lse, q, scale=0.125,
                                         offset=0, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="causal"):
        flash_attention_bwd(q, q, q, o, lse, q, window=4)
    with pytest.raises(TypeError, match="QuantizedTensor"):
        flash_attention_fwd(q, q.to(torch.int8), q.to(torch.int8))
    gen = torch.Generator().manual_seed(0)
    qkv = [torch.randn(1, 2, 8, 64, generator=gen, requires_grad=True)
           for _ in range(3)]
    flash_attention(*qkv, causal=True).square().sum().backward()
    for t in qkv:
        assert t.grad is not None and t.grad.shape == t.shape
        assert bool(torch.isfinite(t.grad).all()) and t.grad.abs().sum() > 0


@pytest.mark.parametrize("kw, slice_name", [
    (dict(mesh=object()), "multi-device"),
], ids=["mesh"])
def test_trainer_unported_families_raise(kw, slice_name):
    with pytest.raises(NotImplementedError, match=f"{slice_name} slice"):
        Trainer(CFG, torch.optim.SGD, device="cpu", **kw)


def test_unported_decode_options_raise():
    """B5's quantized-cache and window branches are ported: flash_decode
    takes QuantizedTensor caches (bare int8 / fp8 codes raise TypeError),
    and the generate path's decode_step runs on a windowed model."""
    from flash_attention_tpu_torch.models.llama import (
        decode_step, init_kv_cache,
    )
    from flash_attention_tpu_torch.ops.decode import flash_decode

    windowed = LlamaConfig.tiny(dtype=torch.float32, window=64)
    params = init_params(windowed, seed=0, device="cpu")
    cache = init_kv_cache(windowed, 1, 128, device="cpu")
    lengths = torch.tensor([100], dtype=torch.int32)
    logits, _, lengths = decode_step(params, torch.tensor([1]), windowed,
                                     cache, lengths)
    assert logits.shape == (1, windowed.vocab_size) and int(lengths) == 101
    assert bool(torch.isfinite(logits).all())
    from flash_attention_tpu_torch.ops.quant import quantize_kv

    q = torch.zeros(1, 4, 64)
    for dt in (torch.int8, torch.float8_e5m2):
        kv = quantize_kv(torch.ones(1, 2, 128, 64), dtype=dt)
        out = flash_decode(q, kv, kv, lengths)
        assert torch.allclose(out, torch.ones_like(out))
        with pytest.raises(TypeError, match="QuantizedTensor"):
            flash_decode(q, kv.values, kv.values, lengths)


def test_expert_stack_weights_raise():
    """MoE expert stacks (a JAX QuantizedExpertStack / Int4ExpertStack
    after jax.tree.map(np.asarray, ...)) convert to the port's stack
    classes by their fields; the dense weight product `_mm` still raises
    on them (they run through models/moe.py _expert_stack_mm)."""
    import dataclasses

    import numpy as np

    from flash_attention_tpu_torch.models.llama import _mm
    from flash_attention_tpu_torch.models.quantized import (
        Int4ExpertStack as PortInt4Stack,
        QuantizedExpertStack as PortQuantStack,
    )

    @dataclasses.dataclass
    class QuantizedExpertStack:
        q: object
        scale: object

        @property
        def orig_shape(self):
            return tuple(self.q.shape)

    @dataclasses.dataclass
    class Int4ExpertStack:
        packed: object
        scales: object
        logical_k: int

    stacks = [QuantizedExpertStack(np.zeros((2, 8, 4), np.int8),
                                   np.ones((2, 4), np.float32)),
              Int4ExpertStack(np.zeros((2, 64, 4), np.int8),
                              np.ones((2, 1, 4), np.float32), 128)]
    for stack, cls, shape in zip(stacks, (PortQuantStack, PortInt4Stack),
                                 ((2, 8, 4), (2, 128, 4))):
        got = params_from_jax({"layers": [{"w_up": stack}]},
                              device="cpu")["layers"][0]["w_up"]
        assert isinstance(got, cls) and got.orig_shape == shape
        assert got.dequant(torch.float32).shape == shape
        with pytest.raises(NotImplementedError, match="_expert_stack_mm"):
            _mm("etd,edf->etf", torch.zeros(2, 3, 8), got)


@pytest.mark.parametrize("cmd", ["decode-bench", "moe-bench", "train-bench",
                                 "serve-bench"])
def test_cli_unported_subcommands_raise(cmd):
    """The JAX CLI's model benchmarks are registered and refuse to run
    until the tooling slice ports them."""
    from flash_attention_tpu_torch import cli

    with pytest.raises(NotImplementedError, match="§A item 6"):
        cli.main([cmd, "--device", "cpu"])


@pytest.mark.parametrize("argv", [["verify"], ["compare"], ["perf"],
                                  ["profile"], ["max-batch"]],
                         ids=lambda a: a[0])
def test_cli_device_cuda_raises_without_a_card(argv):
    """The CLI defaults to the card; without one it raises instead of
    running the plain versions on the CPU."""
    from flash_attention_tpu_torch import cli

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv + ["--device", "cuda"])


def test_kernel_pairs_flattens_nested_results():
    """kernel_pairs.py times checks whose results nest one entry per
    kernel under a key (check_bwd_branches' {"dq": ..., "dkv": ...})
    as "<key>.<kernel>", beside flat entries."""
    import sys

    sys.path.insert(0, str(ROOT))
    try:
        import kernel_pairs
    finally:
        sys.path.remove(str(ROOT))
    results = {"bwd_dq": {"ms": 0.5, "bound_ms": 0.1},
               ("bwd", "window"): {"dq": {"ms": 2.0}, "dkv": {"ms": 3.0}}}
    assert kernel_pairs.flat_ms(results) == {
        "bwd_dq": 0.5, "('bwd', 'window').dq": 2.0,
        "('bwd', 'window').dkv": 3.0}


def test_kernel_pairs_flattens_rows_of_shapes_and_calls_every_check():
    """check_quant_matmul and check_grouped store one row per timed shape
    (a list); kernel_pairs.py keys each "<label>.<shape>". Every check
    it can name takes (rng, flush, results), the matmul checks too."""
    import inspect
    import sys

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
        import kernel_pairs
    finally:
        sys.path.remove(str(ROOT))
    results = {"B7 int4": [{"shape": "x(16,14336) w(14336,4096)", "ms": 0.04},
                           {"shape": "x(1024,4096) w(4096,14336)",
                            "ms": 0.3}],
               "host B7 int4": {"ms": 0.02}, "paged": {"ms": 0.07}}
    assert kernel_pairs.flat_ms(results) == {
        "B7 int4.x(16,14336) w(14336,4096)": 0.04,
        "B7 int4.x(1024,4096) w(4096,14336)": 0.3,
        "host B7 int4": 0.02, "paged": 0.07}
    for name in ("quant_matmul", "grouped", "paged", "decode", "flash_bwd"):
        params = list(inspect.signature(
            getattr(chip_smoke, f"check_{name}")).parameters)
        assert params == ["rng", "flush", "results"], name
    # The summary pairs the i-th parent turn with the i-th change turn.
    lines = ['PAIR parent {"package": "p", "ms": {"k": 2.0}}',
             'PAIR change {"package": "c", "ms": {"k": 1.0}}',
             'PAIR change {"package": "c", "ms": {"k": 3.0}}',
             'PAIR parent {"package": "p", "ms": {"k": 2.5}}']
    assert kernel_pairs.summarize(lines) == [
        "k: parent 2.2500 change 2.0000 ms (0.889x), change faster in 1/2"]
