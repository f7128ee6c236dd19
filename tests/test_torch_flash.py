"""Port parity: flash_attention_fwd (B1's function) in
flash_attention_tpu_torch against the JAX package's Pallas kernel.

Seeded numpy inputs go through both packages in fp32: the JAX side runs
the Pallas kernel in interpret mode (tests/conftest.py keeps JAX on the
CPU), the port's side takes its plain PyTorch version because the
tensors lie on the CPU. Tolerance: max-abs <= 2e-5 on O and on the LSE
(fp32 accumulation-order noise at these sizes is ~1e-7) and the repo's
2% symmetric relative gate.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops.flash import flash_attention_fwd as jax_fwd
from flash_attention_tpu_torch.ops import flash as tflash
from flash_attention_tpu_torch.ops.reference import (
    attention_reference_with_lse,
)
from flash_attention_tpu_torch.utils.metrics import max_abs_error, verify

ATOL = 2e-5

# (batch, hq, hkv, nq, nk, d, causal)
CASES = {
    "noncausal": (1, 4, 4, 128, 128, 64, False),
    "causal": (1, 4, 4, 128, 128, 64, True),
    "causal_offset_nq_lt_nk": (1, 4, 4, 64, 192, 64, True),
    "gqa_4_2_causal": (2, 4, 2, 100, 100, 64, True),
    "odd_lengths_causal": (1, 4, 4, 77, 131, 64, True),
    "odd_lengths_noncausal": (1, 4, 4, 77, 131, 64, False),
    # Across the card's tile edges (64-row consumer warpgroups, 128-row
    # blocks and kv tiles; 64-row kv tiles at D = 256).
    "d128_ragged_200_333_causal": (1, 2, 2, 200, 333, 128, True),
    "d128_ragged_200_333_noncausal": (1, 2, 1, 200, 333, 128, False),
    "d256_ragged_200_333_causal": (1, 1, 1, 200, 333, 256, True),
    "gqa_8_1_causal": (1, 8, 1, 130, 130, 64, True),
}


def _inputs(seed, b, hq, hkv, nq, nk, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 1.0, (b, hq, nq, d)).astype(np.float32)
    k = rng.normal(0, 1.0, (b, hkv, nk, d)).astype(np.float32)
    v = rng.normal(0, 1.0, (b, hkv, nk, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("name", list(CASES))
def test_flash_fwd_matches_jax(name):
    b, hq, hkv, nq, nk, d, causal = CASES[name]
    q, k, v = _inputs(len(name), b, hq, hkv, nq, nk, d)
    o_j, lse_j = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal)
    o_t, lse_t = tflash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal)
    assert o_t.shape == (b, hq, nq, d) and lse_t.shape == (b, hq, nq)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)[..., 0]
    assert max_abs_error(o_t, o_j) <= ATOL
    assert max_abs_error(lse_t, lse_j) <= ATOL
    report = verify(o_t, o_j)
    assert report.passed, str(report)


def test_flash_fwd_plain_matches_exact_reference():
    """The plain version against the port's exact fp32 reference (the
    ground truth the kernel is held to on the card)."""
    q, k, v = map(torch.from_numpy, _inputs(7, 1, 4, 2, 77, 131, 64))
    o, lse = tflash.flash_attention_fwd(q, k, v, causal=True)
    o_ref, lse_ref = attention_reference_with_lse(q, k, v, causal=True)
    assert max_abs_error(o, o_ref) <= ATOL
    assert max_abs_error(lse, lse_ref) <= ATOL


def test_flash_fwd_explicit_offset_and_errors():
    """An explicit offset shifts the causal diagonal like the JAX API;
    invalid shapes and offsets raise ValueError."""
    q, k, v = _inputs(3, 1, 2, 2, 32, 48, 64)
    o_j, lse_j = jax_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, offset=5)
    o_t, lse_t = tflash.flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, offset=5)
    assert max_abs_error(o_t, np.asarray(o_j)) <= ATOL
    assert max_abs_error(lse_t, np.asarray(lse_j)[..., 0]) <= ATOL
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    with pytest.raises(ValueError):
        tflash.flash_attention_fwd(kt, qt[:, :, :16], qt[:, :, :16],
                                   causal=True)          # Nq > Nk
    with pytest.raises(ValueError):
        tflash.flash_attention_fwd(qt[:, :1], kt, vt)    # Hq % Hkv
