"""Port parity: the process group, the mesh and the multi-host launcher
(flash_attention_tpu_torch.parallel.mesh, scripts/launch_multihost,
scripts/multihost_worker) against the JAX package's.

  * Two-process decode parity (the JAX `tests/test_multihost.py` rig):
    `launch_multihost --simulate N --device cpu` runs
    `multihost_worker` at 1 and at 2 gloo ranks, each rank decoding 4
    sequences of `LlamaConfig.tiny` (fp32, prompt 32, 16 greedy steps)
    with dense caches, on the JAX package's parameters carried across
    with `params_from_jax(device="cpu")`. The 2-process transcript's
    first rows equal the 1-process transcript, and both equal JAX's
    greedy transcript (`prefill` / `decode_step` in the test process,
    the same seeded prompts), token for token. The weak-scaling
    efficiency is printed, not gated.
  * `mesh_shape_for` gives JAX's answers and raises where JAX raises.
  * `make_mesh(device_type="cpu")` in a gloo world of one has the six
    named axes; `initialize_distributed` is a no-op without a rendezvous
    and once a group exists.
  * The launcher: each simulated rank gets the rendezvous (a file store
    under the caller's directory) and the device in its environment; a
    failing rank stops the others; `--devices-per-proc` other than 1 is
    refused.
"""

import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.parallel.mesh import mesh_shape_for as jax_shape
from flash_attention_tpu_torch.ops.flash import flash_attention
from flash_attention_tpu_torch.parallel import mesh as pmesh
from flash_attention_tpu_torch.parallel.ring import make_ring_attention
from flash_attention_tpu_torch.scripts import launch_multihost
from flash_attention_tpu_torch.scripts import multihost_worker as worker
from flash_attention_tpu_torch.utils.convert import params_from_jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
SPAWN_TIMEOUT_S = 240


def _launch(nproc, tmp, *cmd, device="cpu"):
    """Start `launch_multihost --simulate nproc` on `cmd` (a Popen)."""
    return subprocess.Popen(
        [sys.executable, "-m",
         "flash_attention_tpu_torch.scripts.launch_multihost",
         "--simulate", str(nproc), "--device", device,
         "--rendezvous-dir", str(tmp), "--timeout", str(SPAWN_TIMEOUT_S),
         "--", *cmd],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


def _finish(proc):
    try:
        log, _ = proc.communicate(timeout=SPAWN_TIMEOUT_S + 30)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)        # and its ranks
        log, _ = proc.communicate()
    assert proc.returncode == 0, f"rc {proc.returncode}:\n{log}"
    return log


def jax_transcript(jp, batch):
    """JAX's greedy transcript [batch, 1 + DECODE_STEPS] on the worker's
    seeded prompts, as the JAX worker decodes (prefill, then a scan of
    decode_step)."""
    tokens = np.random.default_rng(7).integers(
        0, JCFG.vocab_size, (batch, worker.PROMPT)).astype(np.int32)
    cache = jl.init_kv_cache(JCFG, batch,
                             worker.PROMPT + worker.DECODE_STEPS,
                             dtype=jnp.float32)
    logits, cache, lengths = jax.jit(
        lambda p, t, c: jl.prefill(p, t, JCFG, c))(jp, jnp.asarray(tokens),
                                                  cache)

    @jax.jit
    def run(params, tok0, cache, lengths):
        def body(carry, _):
            tok, cache, lengths = carry
            logits, cache, lengths = jl.decode_step(params, tok, JCFG,
                                                    cache, lengths)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            return (tok, cache, lengths), tok

        _, toks = jax.lax.scan(body, (tok0, cache, lengths),
                               length=worker.DECODE_STEPS)
        return toks

    tok0 = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    toks = run(jp, tok0, cache, lengths)
    return np.concatenate([np.asarray(tok0)[:, None], np.asarray(toks).T],
                          axis=1)


@pytest.fixture(scope="module")
def decode_runs(tmp_path_factory):
    """The 1- and 2-process worker runs (both spawns at once, while the
    JAX transcript is computed here) and JAX's transcript at batch 8."""
    tmp = tmp_path_factory.mktemp("multihost")
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    torch.save(params, tmp / "params.pt")
    procs = {n: _launch(n, tmp, "-m",
                        "flash_attention_tpu_torch.scripts.multihost_worker",
                        str(tmp / f"p{n}.json"), "--params",
                        str(tmp / "params.pt"))
             for n in (1, 2)}
    want = jax_transcript(jp, 2 * worker.PER_HOST_BATCH)
    runs = {}
    for n, proc in procs.items():
        _finish(proc)
        with open(tmp / f"p{n}.json") as f:
            runs[n] = json.load(f)
    return runs, want


def test_decode_runs_report_the_jax_keys(decode_runs):
    runs, _ = decode_runs
    for n, run in runs.items():
        assert set(run) == {"num_processes", "global_devices", "batch",
                            "decode_steps", "tokens_per_s", "psum_us",
                            "transcript"}
        assert run["num_processes"] == run["global_devices"] == n
        assert run["batch"] == worker.PER_HOST_BATCH * n
        assert np.asarray(run["transcript"]).shape == (
            run["batch"], 1 + worker.DECODE_STEPS)
        assert run["tokens_per_s"] > 0 and run["psum_us"] > 0
    eff = runs[2]["tokens_per_s"] / (2.0 * runs[1]["tokens_per_s"])
    print(f"2-process weak-scaling decode efficiency: {eff:.2f} "
          f"({runs[2]['tokens_per_s']:.1f} vs {runs[1]['tokens_per_s']:.1f}"
          f" tok/s; 8-float all-reduce {runs[2]['psum_us']:.1f} us)")


def test_one_process_transcript_equals_jax(decode_runs):
    runs, want = decode_runs
    np.testing.assert_array_equal(np.asarray(runs[1]["transcript"]),
                                  want[:worker.PER_HOST_BATCH])


def test_two_process_transcript_equals_one_process(decode_runs):
    runs, _ = decode_runs
    t1 = np.asarray(runs[1]["transcript"])
    t2 = np.asarray(runs[2]["transcript"])
    assert t2.shape[0] == 2 * t1.shape[0]
    np.testing.assert_array_equal(t2[:t1.shape[0]], t1)


def test_two_process_transcript_equals_jax(decode_runs):
    runs, want = decode_runs
    np.testing.assert_array_equal(np.asarray(runs[2]["transcript"]), want)


# --- mesh_shape_for ---------------------------------------------------------------

SHAPES = [(8, dict(sp=-1)), (8, dict(dp=2, tp=-1)), (8, dict(pp=2, ep=-1)),
          (8, dict(dp=3)), (8, dict(dp=-1, tp=-1)), (1, {}),
          (4, dict(dp=2, sp=2)), (12, dict(fsdp=3, tp=-1)),
          (6, dict(dp=4, tp=-1)), (16, dict(dp=2, pp=2, fsdp=2, sp=2)),
          (7, dict(ep=-1)), (4, dict(sp=2))]


@pytest.mark.parametrize("n, kw", SHAPES,
                         ids=[f"{n}-{kw}" for n, kw in SHAPES])
def test_mesh_shape_for_matches_jax(n, kw):
    try:
        want = jax_shape(n, **kw)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            pmesh.mesh_shape_for(n, **kw)
        assert str(got.value) == str(exc)
        return
    assert pmesh.mesh_shape_for(n, **kw) == want
    assert tuple(want) == pmesh.AXES


# --- the process group and the mesh ----------------------------------------------

RENDEZVOUS_ENV = ("FA_TPU_COORDINATOR", "FA_TPU_NUM_PROCESSES",
                  "FA_TPU_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
                  "WORLD_SIZE", "RANK")


def test_world_of_one_mesh_has_the_six_axes(tmp_path, monkeypatch):
    """initialize_distributed is a no-op without a rendezvous, joins a
    gloo world of one with a file store, and is a no-op again once the
    group exists; make_mesh(device_type="cpu") then has the six named
    axes of size 1, and a ring over its sp group gives flash_attention's
    bits."""
    for var in RENDEZVOUS_ENV:
        monkeypatch.delenv(var, raising=False)
    assert not dist.is_initialized()
    pmesh.initialize_distributed(device="cpu")
    assert not dist.is_initialized()
    try:
        pmesh.initialize_distributed(f"file://{tmp_path}/store", 1, 0,
                                     device="cpu")
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        pmesh.initialize_distributed(f"file://{tmp_path}/other", 2, 1,
                                     device="cpu")
        assert dist.get_world_size() == 1
        mesh = pmesh.make_mesh(device_type="cpu")
        assert mesh.mesh_dim_names == pmesh.AXES
        assert tuple(mesh.shape) == (1,) * 6
        assert tuple(pmesh.make_mesh(sp=-1, device_type="cpu").shape) == \
            (1,) * 6
        with pytest.raises(ValueError):
            pmesh.make_mesh(dp=2, device_type="cpu")
        listed = pmesh.make_mesh(sp=-1, devices=[0], device_type="cpu")
        assert listed.mesh_dim_names == pmesh.AXES
        assert listed.mesh.flatten().tolist() == [0]
        q = torch.from_numpy(np.random.default_rng(3).normal(
            0, 0.02, (1, 2, 128, 64)).astype(np.float32))
        ring = make_ring_attention(mesh, causal=True)
        assert torch.equal(ring(q, q, q), flash_attention(q, q, q,
                                                          causal=True))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_distributed_needs_a_coordinator_for_many(monkeypatch):
    for var in RENDEZVOUS_ENV:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="coordinator"):
        pmesh.initialize_distributed(num_processes=2, process_id=0,
                                     device="cpu")
    assert not dist.is_initialized()


# --- the launcher ---------------------------------------------------------------

SHOW_ENV = ("import json, os, sys; json.dump({k: os.environ.get(k) for k "
            "in ('FA_TPU_COORDINATOR', 'FA_TPU_NUM_PROCESSES', "
            "'FA_TPU_PROCESS_ID', 'LOCAL_RANK', 'FA_TPU_DEVICE')}, "
            "open(sys.argv[1] + os.environ['FA_TPU_PROCESS_ID'], 'w'))")


def test_launcher_passes_the_rendezvous(tmp_path):
    proc = _launch(3, tmp_path, "-c", SHOW_ENV, str(tmp_path / "env"))
    _finish(proc)
    envs = [json.load(open(tmp_path / f"env{r}")) for r in range(3)]
    coords = {e["FA_TPU_COORDINATOR"] for e in envs}
    assert len(coords) == 1
    (coord,) = coords
    assert coord.startswith(f"file://{tmp_path}/store-")
    for r, e in enumerate(envs):
        assert e["FA_TPU_NUM_PROCESSES"] == "3"
        assert e["FA_TPU_PROCESS_ID"] == e["LOCAL_RANK"] == str(r)
        assert e["FA_TPU_DEVICE"] == "cpu"


def test_launcher_stops_the_ranks_when_one_fails(tmp_path):
    """Rank 1 exits 3 at once; rank 0 would sleep a minute: the launcher
    returns 3 well before that and leaves no rank running."""
    cmd = ("import os, sys, time; r = os.environ['FA_TPU_PROCESS_ID']; "
           "time.sleep(60) if r == '0' else sys.exit(3)")
    t0 = time.monotonic()
    proc = _launch(2, tmp_path, "-c", cmd)
    proc.communicate(timeout=SPAWN_TIMEOUT_S)
    assert proc.returncode == 3
    assert time.monotonic() - t0 < 30


def test_launcher_takes_one_device_per_process(capsys):
    with pytest.raises(SystemExit) as exc:
        launch_multihost.main(["--simulate", "2", "--devices-per-proc",
                               "4", "--", "prog.py"])
    assert exc.value.code == 2
    assert "one rank drives one device" in capsys.readouterr().err
