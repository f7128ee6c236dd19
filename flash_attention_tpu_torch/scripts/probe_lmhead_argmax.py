"""P3: the 8B decode's int4 lm_head fused with its greedy argmax, on the
card (port of `scripts/probe_lmhead_argmax.py`).

    python -m flash_attention_tpu_torch.scripts.probe_lmhead_argmax
    python -m flash_attention_tpu_torch.scripts.probe_lmhead_argmax \\
        --device cpu --m 4 --k 256 --v 1000

At Llama-3-8B's head (M = 32 rows, K = 4096, V = 128256, x ~ N(0, 0.5^2)
in bf16, the lm_head ~ N(0, 0.02^2) packed by quantize_weight_int4) it
times the baseline, B7 (`int4_matmul`) followed by `torch.argmax` (the
JAX probe's `int4_matmul` + `jnp.argmax`), against `lmhead_argmax`, a
hand-written kernel on B7's own split-K decode body (csrc/matmul_sm90.cuh,
probe_lmhead_sm90.cu: the same converter and pipeline, with an epilogue
that keeps each row's (max, argmax) of the fp32 sums instead of storing
the logits), so the two rows compare one body with and without the
fusion; at chunk widths 2048 (with the agreement of its ids with the
baseline's), 1024 and 4096 -- the column span whose tiles combine into
one key slot a row (the grid does not depend on it); each beside its
bound, its plain version and torch.matmul on the bf16 dequantized
lm_head + torch.argmax (the library yardstick). Operands TMA cannot
address (e.g. V = 5000) take the first body of
csrc/probe_lmhead_argmax.cu (`int4_probe_body`).

The port reduces over the V real columns. The JAX probe pads V to a
multiple of the chunk with zero columns, so a padded logit 0 wins any
row whose real logits are all negative; the port gives such a row its
real argmax. With `--device cpu` every row runs its plain version.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from flash_attention_tpu_torch.config import resolve_device
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.quant_matmul import (
    BODY_CODES,
    DECODE_MAX_ROWS,
    DECODE_TILE_F,
    INT4_GROUP,
    int4_dequant,
    int4_matmul,
    int4_matmul_cost,
    int4_matmul_plain,
    quantize_weight_int4,
)
from flash_attention_tpu_torch.scripts._common import (
    default_timer,
    device_line,
    int4_probe_body,
    row,
)

M, K, V = 32, 4096, 128256
CHUNKS = (1024, 2048, 4096)      # the vocab chunk widths compiled
DEFAULT_CHUNK = 2048

# Launches of the fused kernel (incremented only where it is launched),
# and those on the first body (operands TMA cannot address; also counted
# above).
lmhead_argmax_launches = 0
first_body_launches = 0


def lmhead_logits_plain(x, packed, scales):
    """The fp32 logits the fused kernel reduces: x @ dequant(W), each
    int4 value times its group scale in fp32 rounded to x's type (B7's
    numerics), fp32 sums, not rounded."""
    return x.float() @ int4_dequant(packed, scales, x.dtype).float()


def lmhead_argmax_plain(x, packed, scales):
    """The fused kernel's function in plain PyTorch: (ids int32 [M],
    values fp32 [M]) of the largest fp32 logit of each row over the V
    real columns, the lowest index among equal values."""
    vals, ids = lmhead_logits_plain(x, packed, scales).max(dim=-1)
    return ids.to(torch.int32), vals


def launch_plan(m: int, v: int, chunk: int) -> dict:
    """The decode body's grid and key slots for x [m, K] through a [K/2,
    v] lm_head: one block per (64-column tile, 64-row slice of x), one
    split (an argmax needs whole sums), ceil(v / chunk) key slots a row
    that the second kernel reduces."""
    tiles = -(-v // DECODE_TILE_F)
    slices = -(-m // DECODE_MAX_ROWS)
    return dict(blocks=tiles * slices, splits=1,
                slots=-(-v // chunk), tiles_per_slot=chunk // DECODE_TILE_F)


def lmhead_logits_steps(x, packed, scales):
    """The fp32 logits as the decode body sums them: one 128-row K step
    (one scale group) at a time, in K order, over B7's dequantized
    weights."""
    w = int4_dequant(packed, scales, x.dtype).float()
    xf = x.float()
    logits = xf[:, :INT4_GROUP] @ w[:INT4_GROUP]
    for k0 in range(INT4_GROUP, x.shape[1], INT4_GROUP):
        logits = logits + xf[:, k0:k0 + INT4_GROUP] @ w[k0:k0 + INT4_GROUP]
    return logits


def argmax_key(values: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """The kernels' 64-bit keys (csrc/matmul_sm90.cuh argmax_key):
    order-preserving float bits over (0xFFFFFFFF - column), so their max
    is the largest value, then the lowest column; -0 counts as +0."""
    v = np.where(values == 0, np.float32(0), values).astype(np.float32)
    u = v.view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                   - cols.astype(np.uint64))


def argmax_by_tiles(logits, chunk: int = DEFAULT_CHUNK):
    """The decode body's reduction of fp32 logits [M, V]: one winner per
    64-column tile (the largest value, the lowest column among equal
    ones) over the V real columns, its key max-combined into the slot of
    its chunk of `chunk` columns, then each row's slot keys by max;
    returns the decoded (ids int32 [M], values fp32 [M])."""
    m, v = logits.shape
    tiles = -(-v // DECODE_TILE_F)
    pad = torch.full((m, tiles * DECODE_TILE_F), -math.inf)
    pad[:, :v] = logits.float().cpu()
    t = pad.view(m, tiles, DECODE_TILE_F)
    best = t.max(-1).values
    first = (t == best[..., None]).int().argmax(-1)
    cols = np.arange(tiles)[None, :] * DECODE_TILE_F + first.numpy()
    keys = argmax_key(best.numpy(), cols)
    per = chunk // DECODE_TILE_F
    slots = -(-tiles // per)
    keys = np.pad(keys, ((0, 0), (0, slots * per - tiles)))
    key = keys.reshape(m, slots, per).max(-1).max(-1)
    u = (key >> np.uint64(32)).astype(np.uint32)
    bits = np.where(u & 0x80000000, u & 0x7FFFFFFF, ~u)
    ids = (0xFFFFFFFF - (key & np.uint64(0xFFFFFFFF))).astype(np.int32)
    return (torch.from_numpy(ids),
            torch.from_numpy(bits.astype(np.uint32).view(np.float32)))


def lmhead_argmax_tiled(x, packed, scales, *, chunk: int = DEFAULT_CHUNK):
    """The decode body's P3 step by step in plain PyTorch:
    lmhead_logits_steps, then argmax_by_tiles."""
    return argmax_by_tiles(lmhead_logits_steps(x, packed, scales), chunk)


def _argmax_cuda(x, packed, scales, chunk):
    global lmhead_argmax_launches, first_body_launches
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the P3 kernel takes bf16 activations, got "
                        f"{x.dtype}")
    if scales.dtype != torch.float32:
        raise TypeError("the P3 kernel takes fp32 scales")
    if chunk not in CHUNKS:
        raise ValueError(f"chunk must be one of {CHUNKS}, got {chunk}")
    for name, t in (("x", x), ("packed", packed), ("scales", scales)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m, k = x.shape
    v = packed.shape[1]
    body = int4_probe_body(x, packed, scales)
    slots = launch_plan(m, v, chunk)["slots"] if body == "decode" else 1
    keys = torch.empty(slots * m, dtype=torch.int64, device=x.device)
    ids = torch.empty(m, dtype=torch.int32, device=x.device)
    vals = torch.empty(m, dtype=torch.float32, device=x.device)
    code = _cuda.lib().fa_probe_lmhead_argmax(
        x.data_ptr(), packed.data_ptr(), scales.data_ptr(), keys.data_ptr(),
        ids.data_ptr(), vals.data_ptr(), m, k, v, chunk, BODY_CODES[body],
        _cuda.stream_handle(x.device))
    lmhead_argmax_launches += 1
    first_body_launches += body == "first"
    _cuda.check(code, "probe lmhead_argmax")
    return ids, vals


def lmhead_argmax(x, packed, scales, *, chunk: int = DEFAULT_CHUNK):
    """Greedy ids (int32 [M]) and their logits (fp32 [M]) of x [M, K]
    through a packed int4 lm_head ([K/2, V], scales [K/128, V]) without
    the [M, V] logits. A CUDA tensor launches the fused kernel or
    raises; a CPU tensor runs lmhead_argmax_plain."""
    m, k = x.shape
    kp2, v = packed.shape
    if k != 2 * kp2 or k % INT4_GROUP \
            or tuple(scales.shape) != (k // INT4_GROUP, v):
        raise ValueError(f"shape mismatch: x{tuple(x.shape)} packed"
                         f"{tuple(packed.shape)} scales"
                         f"{tuple(scales.shape)}")
    if x.is_cuda:
        return _argmax_cuda(x, packed, scales, chunk)
    if x.device.type == "cpu":
        return lmhead_argmax_plain(x, packed, scales)
    raise ValueError(f"unsupported device {x.device}")


def argmax_cost(m, k, v):
    """(flops, bytes) of the fused kernel: B7's over the lm_head, but the
    output is ids and values (8 bytes a row), not the logits."""
    flops, nbytes = int4_matmul_cost(m, k, v)
    return flops, nbytes - 2 * m * v + 8 * m


def run(m: int = M, k: int = K, v: int = V, *, device="cuda",
        seed: int = 0, timer=None, keep_outputs: bool = False,
        out=print) -> list:
    """The probe's rows (dicts, times in ms). The fused rows hold the ids'
    agreement with the baseline's and with the plain version's, and the
    values' max-abs difference from the plain version's; with
    keep_outputs the row at the default chunk also holds the kernel's
    ids and values, the plain version's, the fp32 logits and the inputs
    (x, packed, scales) under "outputs"."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out(f"{device_line(dev)}  lm_head [{m},{k}]@[{k},{v}]")
    w = rng.normal(0, 0.02, (k, v)).astype(np.float32)
    x = torch.from_numpy(rng.normal(0, 0.5, (m, k))).to(dev, torch.bfloat16)
    packed, scales = (t.to(dev) for t in quantize_weight_int4(w))
    del w
    timer = timer or default_timer(dev)
    nbytes = packed.numel() + scales.numel() * 4
    wbf = int4_dequant(packed, scales, torch.bfloat16)
    lib_ms = timer(lambda: torch.argmax(torch.matmul(x, wbf), -1))
    del wbf
    plain_ms = timer(lambda: lmhead_argmax_plain(x, packed, scales))

    ids_base = torch.argmax(int4_matmul(x, packed, scales), -1)
    rows = [row("int4_matmul + argmax (B7, shipped)",
                timer(lambda: torch.argmax(int4_matmul(x, packed, scales),
                                           -1)),
                nbytes, int4_matmul_cost(m, k, v),
                plain_ms=timer(lambda: torch.argmax(
                    int4_matmul_plain(x, packed, scales), -1)),
                library_ms=lib_ms, out=out)]
    pids, pvals = lmhead_argmax_plain(x, packed, scales)
    for chunk in (DEFAULT_CHUNK,) + tuple(c for c in CHUNKS
                                          if c != DEFAULT_CHUNK):
        ids, vals = lmhead_argmax(x, packed, scales, chunk=chunk)
        agree = float((ids.long() == ids_base).float().mean())
        extra = dict(chunk=chunk, agree=agree,
                     max_abs_err=float((vals - pvals).abs().max()),
                     plain_agree=float((ids == pids).float().mean()))
        if keep_outputs and chunk == DEFAULT_CHUNK:
            extra["outputs"] = dict(
                ids=ids, values=vals, plain_ids=pids, plain_values=pvals,
                logits=lmhead_logits_plain(x, packed, scales), x=x,
                packed=packed, scales=scales)
        name = (f"fused matmul+argmax (agree {agree:.3f})"
                if chunk == DEFAULT_CHUNK else f"fused bf={chunk}")
        rows.append(row(
            name, timer(lambda: lmhead_argmax(x, packed, scales,
                                              chunk=chunk)),
            nbytes, argmax_cost(m, k, v), plain_ms=plain_ms,
            library_ms=lib_ms, out=out, **extra))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--m", type=int, default=M)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--v", type=int, default=V)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    run(a.m, a.k, a.v, device=a.device, seed=a.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
