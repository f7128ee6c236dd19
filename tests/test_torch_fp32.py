"""fp32 on B2-B9: the CUDA input checks of the port's kernels accept
fp32 tensors (the kernels' FFMA instantiations) and still reject fp64,
integer activations and mixed dtypes. The checks run on CPU tensors and
launch nothing (no card, no nvcc here); the kernels themselves are held
to their plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops import decode as tdec
from flash_attention_tpu_torch.ops import flash as tflash
from flash_attention_tpu_torch.ops import grouped as tgr
from flash_attention_tpu_torch.ops import paged as tpaged
from flash_attention_tpu_torch.ops import quant_matmul as tqm
from flash_attention_tpu_torch.ops.quant import quantize_kv


def test_every_kernel_dtype_code_includes_fp32():
    assert _cuda.DTYPE_CODES == {torch.float16: 0, torch.bfloat16: 1,
                                 torch.float32: 2}


# --- B2 / B3 --------------------------------------------------------------


def _bwd_inputs(dt, d=64):
    q = torch.zeros(1, 4, 32, d, dtype=dt)
    k = torch.zeros(1, 2, 32, d, dtype=dt)
    return dict(q=q, k=k, v=k, o=q, lse=torch.zeros(1, 4, 32), do=q)


def test_b2_b3_check_accepts_fp32():
    a = _bwd_inputs(torch.float32)
    tflash._check_cuda_inputs("B2/B3", a["q"], a["k"], a["v"], o=a["o"],
                              do=a["do"])


@pytest.mark.parametrize("case", ["fp64", "mixed", "int"])
def test_b2_b3_reject_fp64_integers_and_mixed_dtypes(case):
    a = _bwd_inputs(torch.float64 if case == "fp64" else torch.float32)
    if case == "mixed":
        a["do"] = a["do"].to(torch.bfloat16)
    elif case == "int":
        a.update(q=a["q"].int(), o=a["o"].int(), do=a["do"].int(),
                 k=a["k"].int(), v=a["v"].int())
    with pytest.raises(TypeError, match="one dtype"):
        tflash._flash_bwd_cuda(**a, causal=True, scale=0.125, offset=0)


# --- B4 / B5 --------------------------------------------------------------


def _paged(dt, kv_dt=None, quant=None):
    q = torch.zeros(2, 8, 64, dtype=dt)
    pools = [torch.zeros(2, 4, 128, 64, dtype=kv_dt or dt) for _ in "kv"]
    scales = {}
    if quant is not None:
        pools = [p.float().to(quant) for p in pools]
        scales = dict(k_scales=torch.ones(2, 4, 1, 64),
                      v_scales=torch.ones(2, 4, 1, 64))
    table = torch.zeros(2, 2, dtype=torch.int32)
    lengths = torch.tensor([5, 200], dtype=torch.int32)
    return (q, *pools, table, lengths), dict(
        starts=None, qpos_spread=1, **{"k_scales": None, "v_scales": None,
                                       **scales})


@pytest.mark.parametrize("quant", [None, torch.int8, torch.float8_e4m3fn,
                                   torch.float8_e5m2])
def test_b4_check_accepts_an_fp32_q(quant):
    args, kw = _paged(torch.float32, quant=quant)
    store = tpaged._check_paged_cuda(*args, **kw)
    assert store == (0 if quant is None else _cuda.STORE_CODES[quant])


@pytest.mark.parametrize("case", ["fp64", "mixed", "fp64_q_quant"])
def test_b4_rejects_fp64_and_mixed_dtypes(case):
    if case == "fp64":
        args, kw = _paged(torch.float64)
    elif case == "mixed":
        args, kw = _paged(torch.float32, kv_dt=torch.bfloat16)
    else:
        args, kw = _paged(torch.float64, quant=torch.int8)
    with pytest.raises(TypeError, match="fp16/bf16/fp32"):
        tpaged._check_paged_cuda(*args, **kw)


def _decode(dt, kv_dt=None):
    q = torch.zeros(2, 8, 64, dtype=dt)
    k = torch.zeros(2, 2, 256, 64, dtype=kv_dt or dt)
    return q, k, k.clone(), torch.tensor([3, 256], dtype=torch.int32)


@pytest.mark.parametrize("quant", [None, torch.int8, torch.float8_e5m2])
def test_b5_check_accepts_an_fp32_q(quant):
    q, k, v, lengths = _decode(torch.float32)
    scales = dict(k_scales=None, v_scales=None)
    if quant is not None:
        qk, qv = quantize_kv(k, dtype=quant), quantize_kv(v, dtype=quant)
        k, v = qk.values, qv.values
        scales = dict(k_scales=qk.scales, v_scales=qv.scales)
    store = tdec._check_decode_cuda(q, k, v, lengths, **scales)
    assert store == (0 if quant is None else _cuda.STORE_CODES[quant])


@pytest.mark.parametrize("case", ["fp64", "mixed"])
def test_b5_rejects_fp64_and_mixed_dtypes(case):
    q, k, v, lengths = (_decode(torch.float64) if case == "fp64" else
                        _decode(torch.float32, kv_dt=torch.float16))
    with pytest.raises(TypeError, match="fp16/bf16/fp32"):
        tdec._flash_decode_cuda(q, k, v, lengths, scale=0.125)


# --- B6-B9 ----------------------------------------------------------------

W = np.random.default_rng(0).normal(0, 0.02, (256, 64)).astype(np.float32)


def test_b6_b7_b8_b9_check_accepts_fp32_activations():
    x = torch.zeros(4, 256)
    q8, s8 = tqm.quantize_weight(W)
    p4, s4 = tqm.quantize_weight_int4(W)
    for kernel, tensors in (("B6", dict(w_q=q8, w_scale=s8)),
                            ("B7", dict(w_packed=p4, w_scales=s4)),
                            ("B8", dict(w=torch.zeros(256, 64))),
                            ("B9", dict(group_sizes=torch.tensor([4]),
                                        w=torch.zeros(1, 256, 64)))):
        tqm._check_cuda(kernel, x, **tensors)


@pytest.mark.parametrize("kernel", ["B6", "B7", "B8", "B9 dense",
                                    "B9 int4"])
@pytest.mark.parametrize("dt", [torch.float64, torch.int32])
def test_b6_b9_reject_fp64_and_integer_activations(kernel, dt):
    x = torch.zeros(4, 256, dtype=dt)
    q8, s8 = tqm.quantize_weight(W)
    p4, s4 = tqm.quantize_weight_int4(W)
    sizes = torch.tensor([4], dtype=torch.int32)
    with pytest.raises(TypeError, match="fp16/bf16/fp32"):
        if kernel == "B6":
            tqm._quant_matmul_cuda(x, q8, s8)
        elif kernel == "B7":
            tqm._int4_matmul_cuda(x, p4, s4)
        elif kernel == "B8":
            tqm._dense_matmul_cuda(x, torch.zeros(256, 64, dtype=dt))
        elif kernel == "B9 dense":
            tgr._dense_cuda(x, sizes, torch.zeros(1, 256, 64, dtype=dt))
        else:
            tgr._int4_cuda(x, sizes, p4[None], s4[None])


@pytest.mark.parametrize("kernel", ["B8", "B9"])
def test_b8_b9_dense_reject_a_weight_of_another_dtype(kernel):
    x = torch.zeros(4, 256)
    with pytest.raises(TypeError, match="dtype"):
        if kernel == "B8":
            tqm._dense_matmul_cuda(x, torch.zeros(256, 64,
                                                  dtype=torch.bfloat16))
        else:
            tgr._dense_cuda(x, torch.tensor([4], dtype=torch.int32),
                            torch.zeros(1, 256, 64, dtype=torch.float64))


def test_b1_quantized_keeps_rejecting_an_fp32_q():
    """B1 over int8 / fp8 K/V has no fp32 instantiation (not on this
    slice's path): an fp32 q raises before anything is built."""
    q = torch.zeros(1, 2, 128, 64)
    kq = quantize_kv(torch.zeros(1, 2, 128, 64))
    with pytest.raises(TypeError, match="fp16/bf16 q"):
        tflash._flash_fwd_cuda(q, kq.values, kq.values, causal=False,
                               scale=0.125, offset=0, k_scales=kq.scales,
                               v_scales=kq.scales)
