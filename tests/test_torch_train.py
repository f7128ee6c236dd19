"""Port parity: the dense training path of flash_attention_tpu_torch
(loss, train step, data loader, checkpoints, Trainer) against the JAX
package on LlamaConfig.tiny in fp32.

One JAX parameter tree is carried into the port with params_from_jax and
seeded numpy tokens go to both packages; the JAX side runs its Pallas
kernels in interpret mode on the CPU, the port's side its plain
versions. Tolerances: loss rtol 1e-5 (fp32 through a 2-layer model,
observed ~1e-7), SGD params max-abs 1e-5 after two steps, AdamW losses
rtol 1e-4 over three steps (Adam divides by sqrt(v), which magnifies
fp32 gradient noise in near-zero gradient entries), batches and resumed
losses exact.
"""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.utils import data as jdata
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.models.trainer import Trainer, TrainerConfig
from flash_attention_tpu_torch.utils import data as tdata
from flash_attention_tpu_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from flash_attention_tpu_torch.utils.convert import params_from_jax
from flash_attention_tpu_torch.utils.metrics import max_abs_error

JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


def _params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def _tokens(seed, b=2, t=33):
    return np.random.default_rng(seed).integers(
        0, JCFG.vocab_size, (b, t)).astype(np.int32)


def _trainable(tp):
    for leaf in tl.param_leaves(tp):
        leaf.requires_grad_(True)
    return tp


def test_loss_matches_jax():
    jp, tp = _params()
    tokens = _tokens(1)
    lj = float(jl.loss_fn(jp, jnp.asarray(tokens), JCFG))
    with torch.no_grad():
        lt = float(tl.loss_fn(tp, tokens, TCFG))
    np.testing.assert_allclose(lt, lj, rtol=1e-5)


def test_remat_equals_no_remat():
    _, tp = _params()
    tp = _trainable(tp)
    tokens = _tokens(2)
    out = []
    for remat in (False, True):
        loss = tl.loss_fn(tp, tokens, TCFG, remat=remat)
        out.append((loss, torch.autograd.grad(loss, tl.param_leaves(tp))))
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1, strict=True):
        assert torch.equal(a, b)


def _jax_steps(jp, optimizer, batches):
    step = jax.jit(jl.make_train_step(JCFG, optimizer))
    opt_state = optimizer.init(jp)
    losses = []
    for tokens in batches:
        jp, opt_state, loss = step(jp, opt_state, jnp.asarray(tokens))
        losses.append(float(loss))
    return jp, losses


def _torch_steps(tp, opt_factory, batches, remat=False):
    tp = _trainable(tp)
    optimizer = opt_factory(tl.param_leaves(tp))
    step = tl.make_train_step(TCFG, remat=remat)
    return tp, [float(step(tp, optimizer, tokens)) for tokens in batches]


def test_sgd_steps_match_jax():
    jp, tp = _params()
    batches = [_tokens(3), _tokens(4)]
    jp, lj = _jax_steps(jp, optax.sgd(0.5), batches)
    tp, lt = _torch_steps(tp, functools.partial(torch.optim.SGD, lr=0.5),
                          batches)
    np.testing.assert_allclose(lt, lj, rtol=1e-5)
    leaves_j = jax.tree.leaves(jp)
    leaves_t = tl.param_leaves(tp)
    assert len(leaves_j) == len(leaves_t)
    for a, b in zip(leaves_t, leaves_j):
        assert a.shape == b.shape
        assert max_abs_error(a, np.asarray(b)) <= 1e-5


def test_adamw_steps_match_jax():
    """optax.adamw and torch.optim.AdamW with weight_decay passed to both
    (their defaults differ: 1e-4 and 1e-2)."""
    jp, tp = _params()
    batches = [_tokens(5), _tokens(6), _tokens(5)]
    _, lj = _jax_steps(jp, optax.adamw(1e-3, weight_decay=1e-4), batches)
    _, lt = _torch_steps(
        tp, functools.partial(torch.optim.AdamW, lr=1e-3,
                              weight_decay=1e-4), batches, remat=True)
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(lt, lj, rtol=1e-4)


@pytest.fixture
def shard_dir(tmp_path):
    rng = np.random.default_rng(9)
    for i, n in enumerate((1000, 700, 1300)):
        tdata.write_token_shard(tmp_path / f"{i:03d}.tok",
                                rng.integers(0, 512, n))
    return tmp_path


@pytest.mark.parametrize("start_step", [0, 7])
def test_batch_loader_matches_jax(shard_dir, start_step):
    """The port's loader and the JAX package's yield identical batches
    from the same shards and seed, across an epoch boundary (45 windows,
    11 batches of 4 per epoch)."""
    loaders = [
        mod.BatchLoader(mod.TokenShardDataset(shard_dir, seq_len=64),
                        batch=4, seed=3, start_step=start_step)
        for mod in (tdata, jdata)]
    try:
        for _ in range(14):
            a, b = (next(x) for x in loaders)
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    finally:
        for x in loaders:
            x.close()


def test_checkpoint_roundtrip(tmp_path):
    state = {"a": torch.arange(6.0).reshape(2, 3),
             "b": {"c": 7, "d": [torch.ones(2, dtype=torch.bfloat16)]}}
    save_checkpoint(tmp_path / "ck", 5, state)
    assert latest_step(tmp_path / "ck") == 5
    step, got = restore_checkpoint(tmp_path / "ck", template=state)
    assert step == 5
    assert torch.equal(got["a"], state["a"])
    assert got["b"]["c"] == 7
    assert got["b"]["d"][0].dtype == torch.bfloat16
    assert [p.name for p in (tmp_path / "ck").iterdir()] == ["5"]


def test_checkpoint_retention(tmp_path):
    state = {"x": torch.zeros(3)}
    for s in (1, 2, 3, 4):
        save_checkpoint(tmp_path / "ck", s, state, max_to_keep=2)
    assert latest_step(tmp_path / "ck") == 4
    assert restore_checkpoint(tmp_path / "ck", step=3)[0] == 3
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "ck", step=1, template=state)
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "empty")


def test_trainer_resume_is_exact(tmp_path, shard_dir):
    """Train 4 steps with a checkpoint every 2; a fresh Trainer (another
    init seed) must resume from step 4 and reproduce the next 2 steps
    bit for bit, reading its batches from a loader resumed at its
    step (mirrors tests/test_trainer.py)."""
    opt = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)
    tc = TrainerConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                       log_every=1000)
    ds = tdata.TokenShardDataset(shard_dir, seq_len=32)

    def loader(start):
        return tdata.BatchLoader(ds, batch=2, seed=1, start_step=start)

    t1 = Trainer(TCFG, opt, trainer_cfg=tc, seed=0, device="cpu")
    first = loader(0)
    losses1 = t1.fit(first, steps=4, log=lambda s: None)
    first.close()
    assert t1.step_num == 4 and len(losses1) == 4
    assert latest_step(tc.ckpt_dir) == 4

    t2 = Trainer(TCFG, opt, trainer_cfg=tc, seed=123, device="cpu")
    assert t2.step_num == 4
    assert torch.equal(t1.params["embed"], t2.params["embed"])
    l1, l2 = [], []
    for trainer, out in ((t1, l1), (t2, l2)):
        batches = loader(trainer.step_num)
        out += trainer.fit(batches, steps=2, log=lambda s: None)
        batches.close()
    assert l1 == l2
    for a, b in zip(tl.param_leaves(t1.params), tl.param_leaves(t2.params),
                    strict=True):
        assert torch.equal(a, b)


def test_trainer_rejects_unknown_family():
    with pytest.raises(ValueError, match="unknown family"):
        Trainer(TCFG, torch.optim.SGD, family="tensor-train", device="cpu")


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A save that fails mid-write leaves neither a step directory nor
    its temporary: the newest complete checkpoint stays the latest."""
    save_checkpoint(tmp_path / "ck", 1, {"x": torch.zeros(3)})

    def broken_save(obj, path):
        pathlib.Path(path).write_bytes(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    with pytest.raises(OSError):
        save_checkpoint(tmp_path / "ck", 2, {"x": torch.ones(3)})
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["1"]
    assert latest_step(tmp_path / "ck") == 1
