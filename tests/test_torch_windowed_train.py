"""Port parity: windowed training (a sliding-window Llama through B1's
and B2/B3's window branches) and `moe_loss_fn` on one device, against
the JAX package in fp32.

JAX trees are carried into the port with params_from_jax and seeded
numpy tokens go to both packages; the JAX side runs its Pallas kernels
in interpret mode on the CPU, the port's side its plain versions. The
window model is LlamaConfig.tiny(window=24) at T = 64 > window, so
every row past the 24th has columns the window hides. Tolerances (the
model tolerance): loss rtol 1e-5; every gradient leaf max-abs <= 1e-4
(gradients up to ~0.5); AdamW losses rtol 1e-4 over three steps (as
tests/test_torch_train.py); moe_loss_fn's loss and aux metrics rtol
1e-5, its gradients max-abs <= 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu.models import moe as jm
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.models import moe as tm
from flash_attention_tpu_torch.models.trainer import Trainer, TrainerConfig
from flash_attention_tpu_torch.utils import data as tdata
from flash_attention_tpu_torch.utils.checkpoint import latest_step
from flash_attention_tpu_torch.utils.convert import params_from_jax
from flash_attention_tpu_torch.utils.metrics import max_abs_error

WINDOW = 24
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32, window=WINDOW)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32, window=WINDOW)
JMOE = jm.MoEConfig.tiny_moe(dtype=jnp.float32)
TMOE = tm.MoEConfig.tiny_moe(dtype=torch.float32)
GRAD_ATOL = 1e-4


def _tokens(seed, vocab, b=2, t=65):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


def _carry(jp):
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for leaf in tl.param_leaves(tp):
        leaf.requires_grad_(True)
    return tp


def _assert_grads(grads_t, grads_j):
    leaves_j = jax.tree.leaves(grads_j)
    assert len(leaves_j) == len(grads_t)
    for a, b in zip(grads_t, leaves_j):
        assert a.shape == b.shape
        assert max_abs_error(a, np.asarray(b)) <= GRAD_ATOL


@pytest.fixture(scope="module")
def windowed_jax():
    """(JAX tree, tokens, loss, grads) of the windowed model."""
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tokens = _tokens(1, JCFG.vocab_size)
    lj, gj = jax.value_and_grad(jl.loss_fn)(jp, jnp.asarray(tokens), JCFG)
    return jp, tokens, lj, gj


@pytest.mark.parametrize("remat", [False, True])
def test_windowed_loss_and_grads_match_jax(windowed_jax, remat):
    jp, tokens, lj, gj = windowed_jax
    tp = _carry(jp)
    lt = tl.loss_fn(tp, tokens, TCFG, remat=remat)
    gt = torch.autograd.grad(lt, tl.param_leaves(tp))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    _assert_grads(gt, gj)


def test_window_changes_the_loss(windowed_jax):
    """The window is live at this shape: the unwindowed model on the
    same weights and tokens gives another loss."""
    jp, tokens, _, _ = windowed_jax
    tp = _carry(jp)
    with torch.no_grad():
        windowed = float(tl.loss_fn(tp, tokens, TCFG))
        full = float(tl.loss_fn(tp, tokens, tl.LlamaConfig.tiny(
            dtype=torch.float32)))
    assert abs(windowed - full) > 1e-4


def test_windowed_adamw_steps_match_jax():
    """Three AdamW steps (weight_decay passed to both) through the
    windowed train step with remat."""
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tp = _carry(jp)
    batches = [_tokens(s, JCFG.vocab_size) for s in (5, 6, 5)]
    optimizer = optax.adamw(1e-3, weight_decay=1e-4)
    step = jax.jit(jl.make_train_step(JCFG, optimizer))
    opt_state = optimizer.init(jp)
    lj = []
    for tokens in batches:
        jp, opt_state, loss = step(jp, opt_state, jnp.asarray(tokens))
        lj.append(float(loss))
    topt = torch.optim.AdamW(tl.param_leaves(tp), lr=1e-3, weight_decay=1e-4)
    tstep = tl.make_train_step(TCFG, remat=True)
    lt = [float(tstep(tp, topt, tokens)) for tokens in batches]
    assert lt[-1] < lt[0]
    np.testing.assert_allclose(lt, lj, rtol=1e-4)


def test_windowed_trainer_resume_is_exact(tmp_path):
    """The Trainer on the windowed config with remat, batches through
    BatchLoader: a checkpoint at step 2 resumed into a fresh Trainer
    reproduces the next 2 steps bit for bit."""
    rng = np.random.default_rng(9)
    (tmp_path / "data").mkdir()
    tdata.write_token_shard(tmp_path / "data" / "000.tok",
                            rng.integers(0, TCFG.vocab_size, 2000))
    ds = tdata.TokenShardDataset(tmp_path / "data", seq_len=65)
    opt = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)
    tc = TrainerConfig(ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                       log_every=1000, remat=True)
    t1 = Trainer(TCFG, opt, trainer_cfg=tc, seed=0, device="cpu")
    loader = tdata.BatchLoader(ds, batch=2, seed=1)
    t1.fit(loader, steps=2, log=lambda s: None)
    loader.close()
    assert latest_step(tc.ckpt_dir) == 2
    t2 = Trainer(TCFG, opt, trainer_cfg=tc, seed=5, device="cpu")
    assert t2.step_num == 2
    out = []
    for trainer in (t1, t2):
        loader = tdata.BatchLoader(ds, batch=2, seed=1, start_step=2)
        out.append(trainer.fit(loader, steps=2, log=lambda s: None))
        loader.close()
    assert out[0] == out[1]
    for a, b in zip(tl.param_leaves(t1.params), tl.param_leaves(t2.params),
                    strict=True):
        assert torch.equal(a, b)


# --- moe_loss_fn on one device ---------------------------------------------


@pytest.fixture(scope="module")
def moe_jax():
    """(JAX tree, tokens, loss, metrics, grads) of tiny_moe."""
    jp = jm.init_moe_params(JMOE, jax.random.PRNGKey(0))
    tokens = _tokens(3, JMOE.vocab_size, b=2, t=33)
    (lj, mj), gj = jax.value_and_grad(jm.moe_loss_fn, has_aux=True)(
        jp, jnp.asarray(tokens), JMOE)
    return jp, tokens, lj, mj, gj


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_fn_matches_jax(moe_jax, remat):
    """Loss, the ce / load_balance / router_z / dropped_frac metrics and
    every gradient leaf through capacity routing (the MoEConfig
    default), against jax.value_and_grad of the JAX moe_loss_fn."""
    assert TMOE.routing == "capacity"
    jp, tokens, lj, mj, gj = moe_jax
    tp = _carry(jp)
    lt, mt = tm.moe_loss_fn(tp, tokens, TMOE, remat=remat)
    gt = torch.autograd.grad(lt, tl.param_leaves(tp))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert set(mt) == set(mj) == {"ce", "load_balance", "router_z",
                                  "dropped_frac"}
    for key in mj:
        np.testing.assert_allclose(float(mt[key]), float(mj[key]),
                                   rtol=1e-5, atol=1e-7, err_msg=key)
    assert float(mt["dropped_frac"]) > 0       # capacity drops some
    _assert_grads(gt, gj)
