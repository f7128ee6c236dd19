"""Port parity: the benchmark harness (utils/bench.py) and the CLI of
flash_attention_tpu_torch against the JAX package's.

The analytic models must give the JAX package's numbers exactly, the
OOM search its answers on the same fake runners, and `_make_inputs` the
same bits from the same seed (fp32, bf16, fp16). The CLI's `verify`,
`compare` and `perf` run end to end with `--device cpu` (the plain
PyTorch versions) at (1, 2, 256, 64) and exit 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu import cli as jcli
from flash_attention_tpu.utils import bench as jbench
from flash_attention_tpu_torch import cli
from flash_attention_tpu_torch.utils import bench


@pytest.mark.parametrize("args", [
    (1, 32, 8192, 8192, 128, False), (2, 4, 128, 256, 64, True),
    (1, 8, 512, 512, 64, False), (3, 5, 77, 131, 32, True)])
def test_flops_model_matches_jax(args):
    assert bench.attention_flops(*args) == jbench.attention_flops(*args)


@pytest.mark.parametrize("args, itemsize", [
    ((1, 8, 2, 1024, 1024, 128), 2), ((2, 32, 8, 8192, 8192, 128), 2),
    ((1, 4, 4, 77, 131, 64), 4)])
def test_hbm_bytes_model_matches_jax(args, itemsize):
    assert bench.attention_hbm_bytes(*args, itemsize=itemsize) == \
        jbench.attention_hbm_bytes(*args, itemsize=itemsize)


def test_find_max_batch_matches_jax():
    """An OOM above batch 11: both searches answer 11; an OOM at the
    first batch: 0. The port catches torch.cuda.OutOfMemoryError where
    JAX matches "resource exhausted"; any other error is raised."""
    def port_run(b):
        if b > 11:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    def jax_run(b):
        if b > 11:
            raise RuntimeError("RESOURCE EXHAUSTED: out of memory")

    assert bench.find_max_batch(port_run) == \
        jbench.find_max_batch(jax_run) == 11
    assert bench.find_max_batch(port_run, limit=20) == \
        jbench.find_max_batch(jax_run, limit=20) == 11

    def always(b):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    assert bench.find_max_batch(always) == 0

    def broken(b):
        raise RuntimeError("not an out-of-memory error")

    with pytest.raises(RuntimeError, match="not an out-of-memory"):
        bench.find_max_batch(broken)


def test_measure_on_cpu_tensors():
    x = torch.ones(64, 64)
    t = bench.measure(lambda a: a * 2.0, x, warmup=1, iters=3, inner=2)
    assert t.iters == 3 and t.min_s >= 0 and t.mean_s >= t.min_s
    with pytest.raises(ValueError, match="tensor argument"):
        bench.measure(lambda: None, warmup=0, iters=1, inner=1)


def test_bench_attention_report():
    from flash_attention_tpu_torch.ops.reference import attention_reference

    q, k, v = cli._make_inputs(1, 2, 128, 64, "float32")
    r = bench.bench_attention("ref", attention_reference, q, k, v,
                              warmup=1, iters=2, inner=2)
    assert r.tflops_per_s > 0 and "ref" in r.line()
    assert r.config["q_len"] == 128 and r.config["dtype"] == "torch.float32"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_make_inputs_match_jax(dtype):
    """The same seed gives the same bits in both CLIs."""
    want = jcli._make_inputs(1, 4, 64, 32, dtype, kv_heads=2)
    got = cli._make_inputs(1, 4, 64, 32, dtype, kv_heads=2)
    for w, g in zip(want, got):
        assert g.dtype == getattr(torch, dtype)
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(w.astype(jnp.float32)))


@pytest.mark.parametrize("argv", [
    ["verify", "1", "2", "256", "64"],
    ["compare", "--configs", "1,2,256,64", "--warmup", "1", "--iters", "1"],
    ["compare", "--configs", "1,2,256,64", "--causal", "--warmup", "1",
     "--iters", "1"],
    ["perf", "--configs", "1,2,256,64", "--causal", "--bwd", "--warmup",
     "1", "--iters", "1"],
    ["profile", "--config", "1,2,256,64", "--iters", "1"],
], ids=["verify", "compare", "compare_causal", "perf_bwd", "profile"])
def test_cli_runs_on_cpu(argv, capsys):
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    if argv[0] == "compare":
        assert "accuracy verdict: ALL PASS" in out


def test_compare_config_records_failures():
    """compare keeps going past a failing implementation and records it:
    the fixed-tile entries refuse a foreign head dim."""
    res = cli.compare_config((1, 2, 256, 64), dtype="float32", causal=False,
                             warmup=1, iters=1, device=torch.device("cpu"))
    assert set(res["failures"]) == {"flash_fixed_d32"}
    kind, exc, msg = res["failures"]["flash_fixed_d32"]
    assert (kind, exc) == ("ERROR", "ValueError")
    assert "fixed to head_dim 32" in msg
    names = {r.name for r in res["reports"]}
    assert names == {"baseline_xla", "naive_pallas", "fa1", "fa2_inloop",
                     "flash_fixed_d64", "flash"}
    assert len(res["checks"]) == 15
    assert all(r.passed for r in res["checks"].values())


def test_peak_memory_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench.peak_memory_bytes() is None
