"""Port parity: paged_flash_decode (B4's function) in
flash_attention_tpu_torch against the JAX package's Pallas kernel.

Seeded numpy pools, shuffled page tables and ragged lengths go through
both packages in fp32 (JAX: interpret-mode Pallas on the CPU; port: the
plain PyTorch version, since the tensors lie on the CPU). Tolerance:
max-abs <= 2e-5 on O and on the LSE of live rows. A length-0 row (a dead
engine slot) must give O = 0 and the finite LSE INIT_M * scale in both
packages (equal to fp32 rounding: the value is -1.25e36).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops.paged import (
    paged_flash_decode as jax_paged,
)
from flash_attention_tpu_torch.ops import paged as tpaged
from flash_attention_tpu_torch.ops.flash import INIT_M
from flash_attention_tpu_torch.utils.metrics import max_abs_error, verify

ATOL = 2e-5
PAGE = 16
# lengths: empty (dead slot), 5 tokens, under one page, over two pages
LENGTHS = [0, 5, PAGE - 3, 2 * PAGE + 7]


def _setup(seed, hq, hkv, d, lengths, num_pages=24, width=4):
    rng = np.random.default_rng(seed)
    kp = rng.normal(0, 1.0, (hkv, num_pages, PAGE, d)).astype(np.float32)
    vp = rng.normal(0, 1.0, (hkv, num_pages, PAGE, d)).astype(np.float32)
    q = rng.normal(0, 1.0, (len(lengths), hq, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))
    # Entries past the live pages point at page 0, like the engine's
    # scratch page: the kernel must not read them.
    table = np.zeros((len(lengths), width), np.int32)
    at = 0
    for i, n in enumerate(lengths):
        need = -(-n // PAGE)
        table[i, :need] = perm[at:at + need]
        at += need
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _both(q, kp, vp, table, lengths, qpos_spread):
    o_j, lse_j = jax_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths), qpos_spread=qpos_spread,
        return_lse=True)
    o_t, lse_t = tpaged.paged_flash_decode(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(table), torch.from_numpy(lengths),
        qpos_spread=qpos_spread, return_lse=True)
    return np.asarray(o_j), np.asarray(lse_j), o_t, lse_t


@pytest.mark.parametrize("qpos_spread", [1, 3])
def test_paged_decode_matches_jax(qpos_spread):
    hkv, group, d = 2, 2, 64
    hq = hkv * group * qpos_spread
    q, kp, vp, table, lengths = _setup(qpos_spread, hq, hkv, d, LENGTHS)
    o_j, lse_j, o_t, lse_t = _both(q, kp, vp, table, lengths, qpos_spread)
    assert o_t.shape == (len(LENGTHS), hq, d) and lse_t.shape == lse_j.shape
    assert max_abs_error(o_t, o_j) <= ATOL
    live = lengths > 0
    assert max_abs_error(lse_t[live], lse_j[live]) <= ATOL
    report = verify(o_t[live], o_j[live])
    assert report.passed, str(report)


def test_paged_decode_empty_row_has_finite_lse():
    hq, hkv, d = 4, 2, 64
    q, kp, vp, table, lengths = _setup(11, hq, hkv, d, LENGTHS)
    o_j, lse_j, o_t, lse_t = _both(q, kp, vp, table, lengths, 1)
    dead = int(np.argmin(lengths))
    assert lengths[dead] == 0
    want = INIT_M / math.sqrt(d)
    assert torch.isfinite(lse_t).all()
    assert bool((o_t[dead] == 0).all()) and np.all(o_j[dead] == 0)
    np.testing.assert_allclose(lse_t[dead].numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(lse_j[dead], want, rtol=1e-6)


def test_paged_decode_table_width_does_not_change_result():
    """A wider table whose extra entries hold the scratch page gives the
    same output: the table width does not decide what is read."""
    hq, hkv, d = 4, 2, 64
    q, kp, vp, table, lengths = _setup(5, hq, hkv, d, LENGTHS)
    wide = np.zeros((table.shape[0], 8), np.int32)
    wide[:, :table.shape[1]] = table
    args = [torch.from_numpy(x) for x in (q, kp, vp)]
    o1 = tpaged.paged_flash_decode(*args, torch.from_numpy(table),
                                   torch.from_numpy(lengths))
    o2 = tpaged.paged_flash_decode(*args, torch.from_numpy(wide),
                                   torch.from_numpy(lengths))
    assert torch.equal(o1, o2)


def test_paged_decode_reference_and_unported_options():
    hq, hkv, d = 4, 2, 64
    q, kp, vp, table, lengths = _setup(9, hq, hkv, d, [PAGE + 1, 3])
    args = [torch.from_numpy(x) for x in (q, kp, vp, table, lengths)]
    out = tpaged.paged_flash_decode(*args)
    ref = tpaged.paged_decode_reference(*args)
    assert max_abs_error(out, ref) <= ATOL
    with pytest.raises(NotImplementedError):
        tpaged.paged_flash_decode(*args, window=4)
    with pytest.raises(NotImplementedError):
        tpaged.paged_flash_decode(*args, k_scales=args[1],
                                  v_scales=args[2])
    with pytest.raises(ValueError):
        tpaged.paged_flash_decode(*args, qpos_spread=3)   # 3 does not | 4
