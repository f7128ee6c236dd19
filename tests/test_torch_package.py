"""Package rules of the PyTorch/CUDA port (flash_attention_tpu_torch).

  * Nothing in the port, nor chip_smoke.py, imports jax or the JAX
    package (AST walk over every .py file).
  * Entry points default to device="cuda"; on a host without a card that
    default raises instead of dropping to the CPU.
  * Features that later slices port (engine options, attention options,
    trainer families, expert-parallel MoE placements) raise
    NotImplementedError instead of being accepted and ignored.
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
from flash_attention_tpu_torch.runtime.engine import Engine
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


@pytest.mark.parametrize("kw", [
    dict(prefill_chunk=32), dict(prefix_cache=True),
    dict(speculative_k=2), dict(draft_fn=lambda h, k: h[:k]),
    dict(mesh=object()), dict(kv_quant_dtype=torch.int8),
], ids=lambda kw: next(iter(kw)))
def test_engine_unported_features_raise(kw):
    params = init_params(CFG, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="slice"):
        Engine(params, CFG, num_pages=4, page_size=16, device="cpu", **kw)


def test_unported_model_features_raise():
    """Windowed models raise; MoE models serve (the MoE slice): an
    Engine over a tiny_moe tree constructs on the CPU."""
    from flash_attention_tpu_torch.models.moe import (
        MoEConfig, init_moe_params,
    )

    windowed = LlamaConfig.tiny(dtype=torch.float32, window=64)
    params = init_params(windowed, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="window"):
        Engine(params, windowed, num_pages=4, page_size=16, device="cpu")
    moe = MoEConfig.tiny_moe(dtype=torch.float32, routing="dropless")
    eng = Engine(init_moe_params(moe, seed=0, device="cpu"), moe,
                 num_pages=4, page_size=16, device="cpu")
    assert eng.cfg is moe and "router" in eng.params["layers"][0]


@pytest.mark.parametrize("kw", [dict(ep_axis="ep"),
                                dict(expert_shard_axis="tp")],
                         ids=["ep_axis", "expert_shard_axis"])
def test_moe_placements_raise(kw):
    """Expert-parallel placements arrive with the multi-device slice."""
    from flash_attention_tpu_torch.models import moe

    cfg = moe.MoEConfig.tiny_moe(dtype=torch.float32)
    layer = moe.init_moe_params(cfg, seed=0, device="cpu")["layers"][0]
    x = torch.zeros(1, 4, cfg.dim)
    with pytest.raises(NotImplementedError, match="multi-device slice"):
        moe.moe_mlp(layer, x, cfg, **kw)
    if "expert_shard_axis" in kw:
        with pytest.raises(NotImplementedError, match="multi-device slice"):
            moe.moe_mlp_grouped(layer, x, cfg, **kw)


def test_unported_attention_options_raise():
    """Window, segment ids and quantized KV raise; the backward is ported
    (B2/B3), so inputs that require grad get finite gradients."""
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(NotImplementedError):
        flash_attention_fwd(q, q, q, causal=True, window=4)
    with pytest.raises(NotImplementedError):
        flash_attention_fwd(q, q, q, segment_ids=(0, 0))
    with pytest.raises(NotImplementedError):
        flash_attention_fwd(q, q.to(torch.int8), q.to(torch.int8))
    gen = torch.Generator().manual_seed(0)
    qkv = [torch.randn(1, 2, 8, 64, generator=gen, requires_grad=True)
           for _ in range(3)]
    flash_attention(*qkv, causal=True).square().sum().backward()
    for t in qkv:
        assert t.grad is not None and t.grad.shape == t.shape
        assert bool(torch.isfinite(t.grad).all()) and t.grad.abs().sum() > 0


@pytest.mark.parametrize("kw, slice_name", [
    (dict(family="pipeline"), "multi-device"),
    (dict(family="moe"), "multi-device"),
    (dict(mesh=object()), "multi-device"),
], ids=["pipeline", "moe", "mesh"])
def test_trainer_unported_families_raise(kw, slice_name):
    with pytest.raises(NotImplementedError, match=f"{slice_name} slice"):
        Trainer(CFG, torch.optim.SGD, device="cpu", **kw)


def test_unported_decode_options_raise():
    """B5's windowed and quantized-cache branches arrive with their
    slices: the generate path raises on a windowed model, flash_decode
    on an int8 / fp8 cache."""
    from flash_attention_tpu_torch.models.llama import (
        decode_step, init_kv_cache,
    )
    from flash_attention_tpu_torch.ops.decode import flash_decode

    windowed = LlamaConfig.tiny(dtype=torch.float32, window=64)
    params = init_params(windowed, seed=0, device="cpu")
    cache = init_kv_cache(windowed, 1, 128, device="cpu")
    lengths = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="window slice"):
        decode_step(params, torch.tensor([1]), windowed, cache, lengths)
    q = torch.zeros(1, 4, 64)
    for dt in (torch.int8, torch.float8_e5m2):
        kv = torch.zeros(1, 2, 128, 64, dtype=dt)
        with pytest.raises(NotImplementedError, match="quantized-KV slice"):
            flash_decode(q, kv, kv, lengths)


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
