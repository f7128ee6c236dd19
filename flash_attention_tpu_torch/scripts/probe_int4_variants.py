"""P1: int4 nibble-unpack variants of B7 on the card (port of
`scripts/probe_int4_variants.py`).

    python -m flash_attention_tpu_torch.scripts.probe_int4_variants
    python -m flash_attention_tpu_torch.scripts.probe_int4_variants \\
        --device cpu --m 8 --k 256 --f 384

At the 8B MLP decode shape (M = 32, K = 4096, F = 14336, bf16 x) it
times, each beside torch.matmul on the bf16 weight (the library
yardstick), its plain version and its bound:

  B8  dense bf16 (`dense_matmul`), B6 int8 (`quant_matmul`);
  v0  B7, the shipped int4 kernel (two's-complement nibbles);
  v1  offset-binary nibbles (q + 8), float domain: the exponent-bias
      conversion (prmt / lop3 put a nibble in a bf16 mantissa under the
      exponent of 128, one packed fma removes the bias and scales), the
      -8 folded into a per-group correction (sum_group x) * 8 s;
  v2  offset-binary nibbles, int domain: (u & 0xF) - 8, then a convert;
  v3  the JAX probe re-tiles the shipped kernel; B7's decode tile (64
      columns a block, 128-row K steps, csrc/matmul_sm90.cuh) is fixed
      at compile time, so v0 is B7 as built.

v1 and v2 are `int4_variant_matmul`: B7's split-K decode body of
csrc/matmul_sm90.cuh with the variant's converter (probe_int4_v1_sm90.cu,
probe_int4_v2_sm90.cu; v0, v1 and v2 share one pipeline, so their times
compare the converters), or the first body of
csrc/probe_int4_variants.cu where TMA cannot address the operands
(`int4_probe_body`); each prints its error relative to the fp32 dequant
reference, as the JAX probe does. Weights and activations are the JAX
probe's draws from np.random.default_rng(0). With `--device cpu` every
row runs its plain PyTorch version.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from flash_attention_tpu_torch.config import resolve_device
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.quant_matmul import (
    BODY_CODES,
    DECODE_MAX_ROWS,
    DECODE_TILE_F,
    INT4_GROUP,
    dense_matmul,
    dense_matmul_cost,
    dense_matmul_plain,
    decode_split_plan,
    int4_matmul,
    int4_matmul_cost,
    int4_matmul_plain,
    quant_matmul,
    quant_matmul_cost,
    quant_matmul_plain,
    quantize_weight,
    quantize_weight_int4,
)
from flash_attention_tpu_torch.scripts._common import (
    default_timer,
    device_line,
    int4_probe_body,
    row,
)

M, K, F = 32, 4096, 14336

# Launches of the v1 and v2 kernels (each incremented only where its
# kernel is launched), and those of either on the first body (operands
# TMA cannot address; also counted above).
v1_launches = 0
v2_launches = 0
first_body_launches = 0


def pack_offset_binary(w: np.ndarray):
    """The JAX probe's offset-binary packing (probe_int4_variants.py
    :46-53) of a [K, F] weight: the scales of quantize_weight_int4, codes
    q + 8 in [1, 15], byte j of a column = rows 2j (low nibble) and 2j +
    1 (high nibble). Returns (packed uint8 [K/2, F], scales fp32
    [K/128, F]) as CPU tensors."""
    wf = np.asarray(w, np.float32)
    k, f = wf.shape
    if k % INT4_GROUP:
        raise ValueError(f"K={k} must be a multiple of {INT4_GROUP}")
    g = wf.reshape(k // INT4_GROUP, INT4_GROUP, f)
    sc = np.maximum(np.abs(g).max(axis=1) / 7.0, 1e-12)
    qv = np.clip(np.round(g / sc[:, None, :]), -7, 7).astype(np.int32)
    qv = (qv + 8).reshape(k, f)
    packed = ((qv[1::2] << 4) | qv[0::2]).astype(np.uint8)
    return torch.from_numpy(packed), torch.from_numpy(sc.astype(np.float32))


def unpack_offset_binary(packed: torch.Tensor) -> torch.Tensor:
    """Packed [K/2, F] bytes -> the nibbles b in [0, 15] as int32 [K, F]."""
    b = packed.view(torch.uint8).to(torch.int32)
    kp2, f = b.shape
    return torch.stack([b & 0xF, b >> 4], dim=1).reshape(2 * kp2, f)


def _variant_weight(packed, scales, variant: int, dtype):
    """The [K, F] weight a variant multiplies, rounded as its kernel
    rounds it, in fp32: v2 (b - 8) s, v1 b s_b (s_b = s rounded to
    `dtype`; the - 8 s_b is the correction's)."""
    if variant not in (1, 2):
        raise ValueError(f"variant must be 1 or 2, got {variant}")
    b = unpack_offset_binary(packed).float()
    k, f = b.shape
    groups = (k // INT4_GROUP, INT4_GROUP, f)
    if variant == 2:
        w = (b - 8.0).reshape(groups) * scales.float()[:, None, :]
    else:
        w = b.reshape(groups) * scales.to(dtype).float()[:, None, :]
    return w.to(dtype).float().reshape(k, f)


def int4_variant_plain(x, packed, scales, variant: int):
    """The function of variant 1 or 2 in plain PyTorch, with its kernel's
    roundings. v2: w = (b - 8) s in fp32, rounded to x's type; y = x @ w
    (fp32 sum). v1: s_b = s rounded to x's type, w' = b s_b rounded to
    x's type, y = x @ w' - 8 (sum over each 128-row group of x) @ s_b in
    fp32. Both round y once to x's type."""
    w = _variant_weight(packed, scales, variant, x.dtype)
    xf = x.float()
    if variant == 2:
        return (xf @ w).to(x.dtype)
    k = w.shape[0]
    sb = scales.to(x.dtype).float()
    xs = xf.reshape(x.shape[0], k // INT4_GROUP, INT4_GROUP).sum(-1)
    return (xf @ w - 8.0 * (xs @ sb)).to(x.dtype)


def launch_plan(m: int, k: int, f: int) -> tuple[int, int, int]:
    """(splits, k_chunk, slices) of a decode-body launch: K cut by
    decode_split_plan (2 splits of 3456 rows at the probe's shape), x in
    DECODE_MAX_ROWS-row slices."""
    splits, k_chunk = decode_split_plan(k, f)
    return splits, k_chunk, -(-m // DECODE_MAX_ROWS)


def int4_variant_split(x, packed, scales, variant: int, *, splits=None,
                       k_chunk=None):
    """Variant 1 or 2 as the decode body computes it, in plain PyTorch:
    x in DECODE_MAX_ROWS-row slices; K cut into `splits` ranges of
    k_chunk rows (launch_plan's by default); each split's fp32 partial
    summed one 128-row step (one scale group) at a time in K order, v1's
    less 8 times its own correction, grown a step at a time from the
    step's x row sums and bf16 scale row; the partials summed in split
    order and rounded once to x's type."""
    m, k = x.shape
    f = packed.shape[1]
    if splits is None:
        splits, k_chunk, _ = launch_plan(m, k, f)
    w = _variant_weight(packed, scales, variant, x.dtype)
    sb = scales.to(x.dtype).float()
    y = torch.empty((m, f), dtype=x.dtype, device=x.device)
    for m0 in range(0, m, DECODE_MAX_ROWS):
        xs = x[m0:m0 + DECODE_MAX_ROWS].float()
        total = torch.zeros((xs.shape[0], f), device=x.device)
        for sp in range(splits):
            part = torch.zeros_like(total)
            corr = torch.zeros_like(total)
            for k0 in range(sp * k_chunk, min(k, (sp + 1) * k_chunk),
                            INT4_GROUP):
                xk = xs[:, k0:k0 + INT4_GROUP]
                part += xk @ w[k0:k0 + INT4_GROUP]
                if variant == 1:
                    corr += xk.sum(-1, keepdim=True) * sb[k0 // INT4_GROUP]
            total += part - 8.0 * corr
        y[m0:m0 + DECODE_MAX_ROWS] = total.to(x.dtype)
    return y


def _variant_cuda(x, packed, scales, variant):
    global v1_launches, v2_launches, first_body_launches
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the P1 kernels take bf16 activations, got "
                        f"{x.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError("the P1 kernels take fp32 scales")
    for name, t in (("x", x), ("packed", packed), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = x.shape
    f = packed.shape[1]
    y = torch.empty((m, f), dtype=x.dtype, device=x.device)
    body = int4_probe_body(x, packed, scales)
    stream = _cuda.stream_handle(x.device)
    splits, k_chunk, ws, counters = 1, 0, None, None
    if body == "decode":
        splits, k_chunk, slices = launch_plan(m, k, f)
        if splits > 1:
            ws, counters = _cuda.scratch(
                x.device, stream, splits * m * f,
                slices * -(-f // DECODE_TILE_F))
    code = _cuda.lib().fa_probe_int4_matmul(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), y.data_ptr(),
        m, k, f, variant, BODY_CODES[body], splits, k_chunk,
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), stream)
    if variant == 1:
        v1_launches += 1
    else:
        v2_launches += 1
    first_body_launches += body == "first"
    _cuda.check(code, f"probe int4 v{variant}")
    return y


def int4_variant_matmul(x, packed, scales, variant: int):
    """y = x @ ((b - 8) s) for offset-binary int4 (pack_offset_binary):
    variant 1 (float domain) or 2 (int domain). A CUDA tensor launches
    the variant's kernel or raises; a CPU tensor runs
    int4_variant_plain."""
    m, k = x.shape
    kp2, f = packed.shape
    if variant not in (1, 2):
        raise ValueError(f"variant must be 1 or 2, got {variant}")
    if k != 2 * kp2 or k % INT4_GROUP \
            or tuple(scales.shape) != (k // INT4_GROUP, f):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} packed"
                         f"{tuple(packed.shape)} scales"
                         f"{tuple(scales.shape)}")
    if x.is_cuda:
        return _variant_cuda(x, packed, scales, variant)
    if x.device.type == "cpu":
        return int4_variant_plain(x, packed, scales, variant)
    raise ValueError(f"unsupported device {x.device}")


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, the JAX probe's measure (:185)."""
    ref = ref.float()
    return float((got.float() - ref).abs().max()
                 / (ref.abs().max() + 1e-9))


def run(m: int = M, k: int = K, f: int = F, *, device="cuda",
        seed: int = 0, timer=None, keep_outputs: bool = False,
        out=print) -> list:
    """The probe's rows (dicts, times in ms); with keep_outputs, each
    variant row also holds its output, its plain version's, the fp32
    reference and its inputs (x, packed, scales) under "outputs"."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out(f"{device_line(dev)}  shape: [{m},{k}]@[{k},{f}]")
    w = rng.normal(0, 0.02, (k, f)).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 0.02, (m, k))).to(dev, torch.bfloat16)
    packed_tc, scales4 = (t.to(dev) for t in quantize_weight_int4(w))
    q8, s8 = (t.to(dev) for t in quantize_weight(w))
    wbf = torch.from_numpy(w).to(dev, torch.bfloat16)
    packed_ob, sc_ob = (t.to(dev) for t in pack_offset_binary(w))
    del w
    timer = timer or default_timer(dev)
    lib_ms = timer(lambda: torch.matmul(x, wbf))
    nbytes4 = packed_tc.numel() + scales4.numel() * 4
    rows = []
    for name, fn, plain, args, gb, cost in (
            ("bf16 dense_matmul (B8)", dense_matmul, dense_matmul_plain,
             (wbf,), wbf.numel() * 2, dense_matmul_cost(m, k, f)),
            ("int8 quant_matmul (B6)", quant_matmul, quant_matmul_plain,
             (q8, s8), q8.numel() + s8.numel() * 4,
             quant_matmul_cost(m, k, f)),
            ("v0 shipped int4_matmul (B7)", int4_matmul, int4_matmul_plain,
             (packed_tc, scales4), nbytes4, int4_matmul_cost(m, k, f))):
        rows.append(row(name, timer(lambda: fn(x, *args)), gb, cost,
                        plain_ms=timer(lambda: plain(x, *args)),
                        library_ms=lib_ms, out=out))

    # The fp32 dequant reference of the offset-binary weight (:174-177).
    b = unpack_offset_binary(packed_ob).float() - 8.0
    w_ref = (b.reshape(k // INT4_GROUP, INT4_GROUP, f)
             * sc_ob[:, None, :]).reshape(k, f)
    ref = x.float() @ w_ref
    del b, w_ref
    for variant, name in ((1, "v1 offset-binary float-domain"),
                          (2, "v2 offset-binary int-domain")):
        got = int4_variant_matmul(x, packed_ob, sc_ob, variant)
        plain = int4_variant_plain(x, packed_ob, sc_ob, variant)
        err, plain_err = rel_err(got, ref), rel_err(plain, ref)
        extra = dict(variant=variant, rel_err=err, plain_rel_err=plain_err,
                     max_abs_err=float((got.float() - plain.float())
                                       .abs().max()))
        if keep_outputs:
            extra["outputs"] = dict(kernel=got, plain=plain, reference=ref,
                                    inputs=(x, packed_ob, sc_ob))
        rows.append(row(
            f"{name} (rel {err:.1e})",
            timer(lambda: int4_variant_matmul(x, packed_ob, sc_ob, variant)),
            nbytes4, int4_matmul_cost(m, k, f),
            plain_ms=timer(lambda: int4_variant_plain(x, packed_ob, sc_ob,
                                                      variant)),
            library_ms=lib_ms, out=out, **extra))
    out("v3 (the JAX probe's re-tiled shipped kernel): B7's decode tile "
        "(64 columns a block, 128-row K steps, csrc/matmul_sm90.cuh) is "
        "fixed at compile time, so the v0 row is B7 as built; other tiles "
        "belong to B7's speed work")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--f", type=int, default=F)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    run(a.m, a.k, a.f, device=a.device, seed=a.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
