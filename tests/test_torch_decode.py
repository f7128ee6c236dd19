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
from flash_attention_tpu.ops.quant import quantize_kv as jax_quantize_kv
from flash_attention_tpu_torch.ops import decode as tdec
from flash_attention_tpu_torch.ops.quant import quantize_kv
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
    with pytest.raises(ValueError, match="window"):
        tdec.flash_decode(*args, window=0)
    windowed = tdec.flash_decode(*args, window=16)
    assert max_abs_error(windowed, tdec.decode_reference(
        *args, window=16)) <= ATOL
    # int8 / fp8 caches come as QuantizedTensor (codes with scales);
    # bare codes carry no scales and raise.
    for dt in (torch.int8, torch.float8_e4m3fn):
        qk, qv = (quantize_kv(t, dtype=dt) for t in args[1:3])
        got = tdec.flash_decode(args[0], qk, qv, args[3])
        assert max_abs_error(got, tdec.decode_reference(
            args[0], qk, qv, args[3])) <= ATOL
        with pytest.raises(TypeError, match="QuantizedTensor"):
            tdec.flash_decode(args[0], qk.values, qv.values, args[3])
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


@pytest.mark.parametrize("dt", ["int8", "float8_e5m2"])
def test_flash_decode_quantized_scale_rows_matches_jax(dt):
    """B5 over QuantizedTensor caches whose 128-position blocks differ in
    scale by six orders of magnitude, lengths ending inside, at and past
    a 256-position chunk: a wrong scale row (block pos // 128 of its
    own sequence and head) cannot pass. fp32, max-abs <= 2e-5."""
    rng = np.random.default_rng(7)
    b, hq, hkv, s, d = 4, 8, 2, 640, 64
    f = 10.0 ** rng.integers(-3, 4, (b, hkv, s // 128, 1))
    k, v = (rng.normal(0, 1, (b, hkv, s, d)) * np.repeat(f, 128, axis=2)
            for _ in range(2))
    k, v = k.astype(np.float32), v.astype(np.float32)
    q = rng.normal(0, 0.01, (b, hq, d)).astype(np.float32)
    lengths = np.asarray([640, 256, 300, 129], np.int32)
    jk, jv = (jax_quantize_kv(jnp.asarray(x), dtype=getattr(jnp, dt))
              for x in (k, v))
    tk, tv = (quantize_kv(torch.from_numpy(x), dtype=getattr(torch, dt))
              for x in (k, v))
    want = np.asarray(jax_decode(jnp.asarray(q), jk, jv,
                                 jnp.asarray(lengths)))
    got = tdec.flash_decode(torch.from_numpy(q), tk, tv,
                            torch.from_numpy(lengths))
    assert max_abs_error(got, want) <= ATOL * float(np.abs(want).max())
