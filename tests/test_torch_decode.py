"""Port parity: flash_decode (B5's function) in flash_attention_tpu_torch
against the JAX package's Pallas kernel.

Seeded numpy queries and contiguous caches [B, Hkv, S, D] with ragged
lengths (0, S and values between) go through both packages in fp32
(JAX: interpret-mode Pallas on the CPU; port: the plain PyTorch version,
since the tensors lie on the CPU), for GQA groups 1, 2 and 4 and head
dims 64 and 128. Tolerance: max-abs <= 2e-5 on O. A length-0 row gives
O = 0 in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.ops.decode import flash_decode as jax_decode
from flash_attention_tpu_torch.ops import decode as tdec
from flash_attention_tpu_torch.utils.metrics import max_abs_error, verify

ATOL = 2e-5
S = 256
LENGTHS = [0, 1, 100, S]


def _setup(seed, hq, hkv, d, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    q = rng.normal(0, 1, (b, hq, d)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, S, d)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, S, d)).astype(np.float32)
    return q, k, v, np.asarray(lengths, np.int32)


CASES = [(4, 4, 64), (8, 4, 64), (8, 2, 128), (4, 1, 128)]


@pytest.mark.parametrize("hq,hkv,d", CASES,
                         ids=[f"group{h // k}-d{d}" for h, k, d in CASES])
def test_flash_decode_matches_jax(hq, hkv, d):
    q, k, v, lengths = _setup(hq + d, hq, hkv, d)
    want = np.asarray(jax_decode(*(jnp.asarray(x)
                                   for x in (q, k, v, lengths))))
    got = tdec.flash_decode(*(torch.from_numpy(x)
                              for x in (q, k, v, lengths)))
    assert got.shape == (len(LENGTHS), hq, d)
    assert max_abs_error(got, want) <= ATOL
    live = lengths > 0
    report = verify(got[live], want[live])
    assert report.passed, str(report)
    assert bool((got[0] == 0).all()) and np.all(want[0] == 0)


def test_flash_decode_reads_only_live_positions():
    """Garbage past lengths[b] (huge finite values) changes nothing."""
    q, k, v, lengths = _setup(1, 8, 2, 64, [5, 0, 200])
    args = [torch.from_numpy(x) for x in (q, k, v, lengths)]
    clean = tdec.flash_decode(*args)
    for i, n in enumerate(lengths):
        args[1][i, :, n:] = 1e30
        args[2][i, :, n:] = -1e30
    assert torch.equal(tdec.flash_decode(*args), clean)


def test_flash_decode_reference_and_cost():
    q, k, v, lengths = _setup(2, 8, 2, 64)
    args = [torch.from_numpy(x) for x in (q, k, v, lengths)]
    got = tdec.flash_decode(*args)
    ref = tdec.decode_reference(*args)
    assert max_abs_error(got, ref) <= ATOL
    o, lse = tdec.flash_decode_plain(*args, scale=0.125, return_lse=True)
    assert torch.equal(o, got)
    assert np.isfinite(lse.numpy()).all()
    flops, nbytes = tdec.decode_cost(lengths, 8, 2, 64, 2)
    tokens = int(lengths.sum())
    assert flops == 4 * 8 * tokens * 64
    assert nbytes == 2 * 2 * tokens * 64 * 2 + 2 * 4 * 8 * 64 * 2 + 4 * 4


def test_unported_options_raise():
    q, k, v, lengths = _setup(4, 4, 2, 64)
    args = [torch.from_numpy(x) for x in (q, k, v, lengths)]
    with pytest.raises(NotImplementedError, match="window"):
        tdec.flash_decode(*args, window=16)
    i8 = args[1].to(torch.int8)
    with pytest.raises(NotImplementedError, match="quantized"):
        tdec.flash_decode(args[0], i8, i8, args[3])
    fp8 = args[1].to(torch.float8_e4m3fn)
    with pytest.raises(NotImplementedError, match="quantized"):
        tdec.flash_decode(args[0], fp8, fp8, args[3])
    with pytest.raises(ValueError):
        tdec.flash_decode(args[0][:, :3], *args[1:])


@pytest.mark.parametrize("case", ["fp32", "lengths", "contiguous"])
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v, lengths = _setup(5, 4, 2, 64)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    lengths = torch.from_numpy(lengths)
    if case == "fp32":
        with pytest.raises(TypeError, match="fp16/bf16"):
            tdec._flash_decode_cuda(q.float(), k, v, lengths, scale=0.1)
    elif case == "lengths":
        with pytest.raises(TypeError, match="int32"):
            tdec._flash_decode_cuda(q, k, v, lengths.long(), scale=0.1)
    else:
        with pytest.raises(ValueError, match="contiguous"):
            tdec._flash_decode_cuda(q, k.transpose(2, 3).contiguous()
                                    .transpose(2, 3), v, lengths,
                                    scale=0.1)
