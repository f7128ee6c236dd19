"""Port parity: the Llama serving path of flash_attention_tpu_torch
against the JAX package on LlamaConfig.tiny in fp32.

One JAX parameter tree is carried into the port with params_from_jax;
seeded numpy tokens, pools, tails and tables go to both packages. The
JAX side runs its Pallas kernels in interpret mode on the CPU.
Tolerance: max-abs <= 1e-4 on logits and on the K/V and tails the steps
produce (fp32 through a 2-layer model with logits of magnitude ~4;
observed gaps are below 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.models import llama as jl
from flash_attention_tpu_torch.models import llama as tl
from flash_attention_tpu_torch.utils.convert import params_from_jax
from flash_attention_tpu_torch.utils.metrics import max_abs_error

ATOL = 1e-4
JCFG = jl.LlamaConfig.tiny(dtype=jnp.float32)
TCFG = tl.LlamaConfig.tiny(dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    jp = jl.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def test_config_presets_match_jax():
    for name in ("tiny", "llama3_1b", "llama3_8b", "mistral_7b",
                 "llama3_70b"):
        j, t = getattr(jl.LlamaConfig, name)(), getattr(tl.LlamaConfig,
                                                         name)()
        for field in ("vocab_size", "dim", "n_layers", "n_heads",
                      "n_kv_heads", "ffn_dim", "rope_theta", "norm_eps",
                      "window", "head_dim"):
            assert getattr(j, field) == getattr(t, field), (name, field)


def test_rope_and_rmsnorm_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 3, 9, 64)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    rj = np.asarray(jl.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0))
    rt = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    assert max_abs_error(rt, rj) <= 1e-5
    w = rng.normal(1, 0.1, (64,)).astype(np.float32)
    nj = np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    nt = tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    assert max_abs_error(nt, nj) <= 1e-6


def test_forward_logits_match_jax(params):
    jp, tp = params
    tokens = np.random.default_rng(2).integers(
        0, JCFG.vocab_size, (2, 24)).astype(np.int32)
    lj = np.asarray(jl.forward(jp, jnp.asarray(tokens), JCFG))
    lt = tl.forward(tp, torch.from_numpy(tokens), TCFG)
    assert lt.shape == lj.shape
    assert max_abs_error(lt, lj) <= ATOL


def test_prefill_kv_matches_jax(params):
    """Right-padded prompt (bucket 64, true length 37), as the engine
    prefills it: logits at the last real token and every layer's K/V."""
    jp, tp = params
    tokens = np.zeros((1, 64), np.int32)
    tokens[0, :37] = np.random.default_rng(3).integers(
        0, JCFG.vocab_size, 37)
    lj, ksj, vsj = jl.prefill_kv(jp, jnp.asarray(tokens), JCFG,
                                 true_len=37)
    lt, kst, vst = tl.prefill_kv(tp, torch.from_numpy(tokens), TCFG,
                                 true_len=37)
    assert kst.shape == ksj.shape == (JCFG.n_layers, 1, JCFG.n_kv_heads,
                                      64, JCFG.head_dim)
    assert max_abs_error(lt, np.asarray(lj)) <= ATOL
    assert max_abs_error(kst, np.asarray(ksj)) <= ATOL
    assert max_abs_error(vst, np.asarray(vsj)) <= ATOL


def _decode_state(seed, batch=4, t_new=1, page=16, num_pages=12,
                  tail=8):
    """Pools, tails, shuffled tables and per-slot lengths, with slot 2
    dead (paged_lens 0, tail_pos 0, table all scratch page 0)."""
    rng = np.random.default_rng(seed)
    L, hkv, d = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim
    pools = rng.normal(0, 1, (2, L, hkv, num_pages, page, d)).astype(
        np.float32)
    tails = rng.normal(0, 1, (2, L, batch, hkv, tail, d)).astype(
        np.float32)
    paged_lens = np.array([page + 5, 7, 0, 2 * page][:batch], np.int32)
    tail_pos = np.array([3, 0, 0, tail - t_new][:batch], np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    tables = np.zeros((batch, 4), np.int32)
    at = 0
    for i, n in enumerate(paged_lens):
        need = -(-int(n) // page)
        tables[i, :need] = perm[at:at + need]
        at += need
    tokens = rng.integers(0, JCFG.vocab_size, (batch, t_new)).astype(
        np.int32)
    return tokens, pools, tails, tables, paged_lens, tail_pos


@pytest.mark.parametrize("t_new", [1, 3])
def test_decode_step_paged_multi_matches_jax(params, t_new):
    jp, tp = params
    tokens, pools, tails, tables, paged_lens, tail_pos = _decode_state(
        10 + t_new, t_new=t_new)
    J = jnp.asarray
    lj, ktj, vtj = jl.decode_step_paged_multi(
        jp, J(tokens), JCFG, [J(p) for p in pools[0]],
        [J(p) for p in pools[1]], [J(t) for t in tails[0]],
        [J(t) for t in tails[1]], J(tables), J(paged_lens), J(tail_pos))
    T = torch.from_numpy
    kt = [T(t.copy()) for t in tails[0]]
    vt = [T(t.copy()) for t in tails[1]]
    lt, ktt, vtt = tl.decode_step_paged_multi(
        tp, T(tokens), TCFG, [T(p) for p in pools[0]],
        [T(p) for p in pools[1]], kt, vt, T(tables), T(paged_lens),
        T(tail_pos))
    assert lt.shape == (tokens.shape[0], t_new, JCFG.vocab_size)
    assert max_abs_error(lt, np.asarray(lj)) <= ATOL
    for a, b in zip(ktt + vtt, list(ktj) + list(vtj)):
        assert max_abs_error(a, np.asarray(b)) <= ATOL
    # The tails were updated in place (rows tail_pos + t written).
    assert ktt[0] is kt[0]
    assert not np.array_equal(kt[0].numpy(), tails[0][0])


def test_decode_step_paged_matches_prefill_continuation(params):
    """Within the port: prefill a prompt into pages, then one decode step
    for the next token equals the full forward's logits at that
    position (the tail scatter, paged kernel and LSE merge together)."""
    _, tp = params
    page = 16
    tokens = np.random.default_rng(4).integers(
        0, TCFG.vocab_size, (1, 21)).astype(np.int32)
    full = tl.forward(tp, torch.from_numpy(tokens), TCFG)[0, -1]
    _, ks, vs = tl.prefill_kv(tp, torch.from_numpy(tokens[:, :20]), TCFG)
    hkv, d = TCFG.n_kv_heads, TCFG.head_dim
    k_pools = [torch.zeros(hkv, 4, page, d) for _ in range(TCFG.n_layers)]
    v_pools = [torch.zeros(hkv, 4, page, d) for _ in range(TCFG.n_layers)]
    table = torch.tensor([[2, 1]], dtype=torch.int32)
    for li in range(TCFG.n_layers):
        for pos in range(20):
            pg, off = table[0, pos // page], pos % page
            k_pools[li][:, pg, off] = ks[li, 0, :, pos]
            v_pools[li][:, pg, off] = vs[li, 0, :, pos]
    k_tails = [torch.zeros(1, hkv, 4, d) for _ in range(TCFG.n_layers)]
    v_tails = [torch.zeros(1, hkv, 4, d) for _ in range(TCFG.n_layers)]
    logits, _, _ = tl.decode_step_paged(
        tp, torch.from_numpy(tokens[:, 20]), TCFG, k_pools, v_pools,
        k_tails, v_tails, table, torch.tensor([20], dtype=torch.int32),
        torch.tensor([0], dtype=torch.int32))
    assert max_abs_error(logits[0], full) <= ATOL
