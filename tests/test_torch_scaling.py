"""Port parity: the analytic scaling model (parallel/scaling.py) and the
collective counters it reads (parallel/collectives.py) against the JAX
package's `parallel/scaling.py`.

  * `ring_all_reduce_time`, `ring_all_gather_time`, `predict_tp_decode`
    and `predict_dp_decode` equal JAX's on the same inputs (exactly:
    the same float arithmetic), including the recorded efficiencies of
    tests/test_scaling.py's `test_predicted_efficiencies_are_defensible`
    and the basics of its ring model.
  * No TPU figure comes across: `Fabric` and `DecodeStepCosts.hbm_bw`
    have no defaults, and the v5e constants have no counterpart.
  * `collective_bytes` counts what the port's collectives issue: in a
    gloo world of one, an all-reduce its buffer's bytes, a tiled
    all-gather its output's, each once a call; `all_gather_tiled` is
    JAX's `all_gather(tiled=True)` on every dim; and
    `tp_decode_collective_bytes(tiny, 1, 4)` counts 2 all-reduces a
    layer and one logits gather, as at any tp.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from flash_attention_tpu.parallel import scaling as js
from flash_attention_tpu_torch.models.llama import LlamaConfig
from flash_attention_tpu_torch.parallel import collectives
from flash_attention_tpu_torch.parallel import mesh as pmesh
from flash_attention_tpu_torch.parallel import scaling as ts

FABRICS = [(100e9, 1e-6), (25e9, 100e-6), (450e9, 2.5e-6)]
SIZES = [1, 2, 4, 8, 16]


@pytest.mark.parametrize("bw,lat", FABRICS)
@pytest.mark.parametrize("n", SIZES)
def test_ring_times_match_jax(bw, lat, n):
    jf, tf = js.Fabric(bandwidth=bw, latency=lat), \
        ts.Fabric(bandwidth=bw, latency=lat)
    for nbytes in (0, 1000, 8_000_000, 1 << 30):
        assert ts.ring_all_reduce_time(nbytes, n, tf) == \
            js.ring_all_reduce_time(nbytes, n, jf)
        assert ts.ring_all_gather_time(nbytes, n, tf) == \
            js.ring_all_gather_time(nbytes, n, jf)


def test_ring_all_reduce_model_basics():
    """tests/test_scaling.py:34."""
    f = ts.Fabric(bandwidth=100e9, latency=1e-6)
    assert ts.ring_all_reduce_time(1000, 1, f) == 0.0
    t8 = ts.ring_all_reduce_time(8_000_000, 8, f)
    assert t8 > 2 * (7 / 8) * 8e6 / 100e9
    assert t8 < 2 * (7 / 8) * 8e6 / 100e9 + 20e-6


def _costs(mod, weight, kv, layers, dim, tp, b=32, hbm=600e9):
    return mod.DecodeStepCosts(
        weight_bytes=weight, kv_bytes=kv,
        all_reduce_bytes=layers * 2 * b * dim * 2,
        all_gather_bytes=b * 128256 // tp * 2, tp_measured=tp, hbm_bw=hbm)


COSTS = {"70b": (70_000_000_000, 2_000_000_000, 80, 8192),
         "8b": (8_000_000_000, 1_000_000_000, 32, 4096)}


@pytest.mark.parametrize("model", list(COSTS))
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("bw,lat", FABRICS)
def test_predict_tp_decode_matches_jax(model, n, bw, lat):
    got = ts.predict_tp_decode(_costs(ts, *COSTS[model], 8), n,
                               ts.Fabric(bandwidth=bw, latency=lat))
    want = js.predict_tp_decode(_costs(js, *COSTS[model], 8), n,
                                js.Fabric(bandwidth=bw, latency=lat))
    assert got == want


@pytest.mark.parametrize("n", SIZES)
def test_predict_dp_decode_matches_jax(n):
    assert ts.predict_dp_decode(n) == js.predict_dp_decode(n)
    assert ts.predict_dp_decode(n, dispatch_overhead=0.1) == \
        js.predict_dp_decode(n, dispatch_overhead=0.1)


def test_predicted_efficiencies_are_defensible():
    """tests/test_scaling.py:73, on the port's functions with the JAX
    test's inputs (its v5e-class fabric and 600 GB/s, passed here, not
    defaults): 70B TP-8 near 0.9, 8B TP-8 below it, DP ~1.0."""
    ici = ts.Fabric(bandwidth=100e9, latency=1e-6)
    eff70 = ts.predict_tp_decode(_costs(ts, *COSTS["70b"], 8), 8,
                                 ici)["efficiency"]
    assert 0.85 < eff70 <= 1.0, eff70
    eff8 = ts.predict_tp_decode(_costs(ts, *COSTS["8b"], 8), 8,
                                ici)["efficiency"]
    assert eff8 < eff70, (eff8, eff70)
    assert ts.predict_dp_decode(4)["efficiency"] >= 0.95


def test_no_tpu_figure_comes_across():
    """Fabric and hbm_bw are required; the v5e constants and the HLO
    parser have no counterpart."""
    with pytest.raises(TypeError):
        ts.Fabric()
    fields = {f.name: f for f in dataclasses.fields(ts.DecodeStepCosts)}
    assert fields["hbm_bw"].default is dataclasses.MISSING
    for name in ("V5E_ICI", "V5E_DCN", "hlo_collective_bytes"):
        assert not hasattr(ts, name)


# --- the counters, in a world of one -------------------------------------------


@pytest.fixture
def group(tmp_path):
    pmesh.initialize_distributed(f"file://{tmp_path}/store", 1, 0,
                                 device="cpu")
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_collective_bytes_counts_buffers_and_outputs(group):
    x = torch.randn(4, 2048, dtype=torch.bfloat16)
    y = torch.randn(8, 16)
    collectives.reset_collective_counts()

    def step():
        collectives.all_reduce_sum(x, group)
        collectives.all_reduce_sum(x[:2], group)
        collectives.all_gather_tiled(y, group, dim=1)

    got = ts.collective_bytes(step)
    assert got == {"all-reduce": 4 * 2048 * 2 + 2 * 2048 * 2,
                   "all-gather": 8 * 16 * 4}
    assert collectives.collective_counts() == {
        "all-reduce": {"calls": 2, "bytes": 6 * 2048 * 2},
        "all-gather": {"calls": 1, "bytes": 8 * 16 * 4},
        "collective-permute": {"calls": 0, "bytes": 0},
        "all-to-all": {"calls": 0, "bytes": 0}}
    assert ts.collective_bytes(lambda: None) == {}
    collectives.reset_collective_counts()
    assert all(v == {"calls": 0, "bytes": 0}
               for v in collectives.collective_counts().values())


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_all_gather_tiled_matches_jax_on_a_world_of_one(group, dim):
    """A world of one gathers x itself, as JAX's tiled all_gather over
    one device does; the result is a new tensor."""
    x = torch.randn(3, 4, 5)
    got = collectives.all_gather_tiled(x, group, dim)
    want = jax.vmap(lambda v: jax.lax.all_gather(v, "i", axis=dim,
                                                 tiled=True),
                    axis_name="i")(jnp.asarray(x.numpy())[None])[0]
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.data_ptr() != x.data_ptr()
    s = collectives.all_reduce_sum(x, group)
    assert torch.equal(s, x) and s.data_ptr() != x.data_ptr()


def test_tp_decode_collective_bytes_on_a_world_of_one(group):
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    got = ts.tp_decode_collective_bytes(cfg, 1, 4, device="cpu")
    assert got == {"all-reduce": 2 * cfg.n_layers * 4 * cfg.dim * 4,
                   "all-gather": 4 * cfg.vocab_size * 4}
