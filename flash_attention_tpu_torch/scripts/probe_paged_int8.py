"""P2: int8 paged-decode bodies at the bench shape, on the card (port of
`scripts/probe_paged_int8.py`).

    python -m flash_attention_tpu_torch.scripts.probe_paged_int8
    python -m flash_attention_tpu_torch.scripts.probe_paged_int8 \\
        --device cpu --b 2 --hq 4 --hkv 2 --d 64 --ctx 512

At batch 64, 32 q / 8 kv heads of 128, every sequence 4088 tokens, over
int8 pools with fp32 scales per (128-token block, channel), it times:

  bf16  B4 on the bf16 pools the int8 ones were quantized from;
  v0    B4's default int8 body (each code times its scale, rounded to
        bf16 before the product), pages of 256;
  v1    B4's `fold_scales` body, pages of 256;
  v2    `paged_int8_v2`, the JAX probe's blocked body as a hand-written
        kernel (csrc/probe_paged_int8.cu, on the split-KV pieces of
        csrc/decode_sm90.cuh): each 128-token block of K and V
        dequantized once to a bf16 tile the block's 8 warps share, codes
        and scale rows in a cp.async ring, both products on the tensor
        cores (mma.sync), fp32 online softmax, P rounded to bf16, split
        across blocks by `v2_splits` and merged in split order; pages of
        256;
  v3    v0 at pages of 512;

each beside its bound and its plain version (no single library call
attends over a page table), GB/s over the JAX probe's count of live K/V
code bytes, v2 with its max-abs error against the fp32 reference as the
JAX probe prints it. Pools and queries are the JAX probe's draws from
np.random.default_rng(0). `paged_flash_decode` gains no option: v2 is
this module's own function, as in JAX. With `--device cpu` every row
runs its plain version.
"""

from __future__ import annotations

import argparse
import math
from fractions import Fraction

import numpy as np
import torch

from flash_attention_tpu_torch.config import (
    CUDA_HEAD_DIMS,
    cdiv,
    resolve_device,
)
from flash_attention_tpu_torch.ops import _cuda
from flash_attention_tpu_torch.ops.decode import MAX_SPLITS, SM_COUNT
from flash_attention_tpu_torch.ops.paged import (
    paged_decode_cost,
    paged_flash_decode,
    paged_flash_decode_plain,
)
from flash_attention_tpu_torch.ops.quant import QUANT_BLOCK
from flash_attention_tpu_torch.scripts._common import (
    default_timer,
    device_line,
    row,
)

B, HQ, HKV, D, CTX = 64, 32, 8, 128, 4096
PAGES = (256, 512)

# Launches of the v2 kernel (incremented only where it is launched).
paged_int8_v2_launches = 0

# The v2 body's launch (csrc/probe_paged_int8.cu): a block of 8 warps
# takes one (sequence, kv head) -- V2_ROWS q rows at most -- and an even
# share of its 128-token quant blocks; its shared memory keeps two blocks
# on an SM (V2_RESIDENT at once); a split takes V2_MIN_BLOCKS quant
# blocks at least.
V2_ROWS = 8
V2_RESIDENT = 2 * SM_COUNT
V2_MIN_BLOCKS = 4


def v2_splits(units, max_tokens) -> int:
    """Blocks per unit (one (sequence, kv head)) of the v2 body when a
    sequence holds at most `max_tokens` tokens. Of 1 up to the most
    that leave each split V2_MIN_BLOCKS quant blocks (and MAX_SPLITS),
    the count s whose grid of units x s blocks takes the fewest waves of
    V2_RESIDENT blocks per unit of work, ceil(units s / V2_RESIDENT) / s
    (a launch's time in one unit's work, blocks of a wave running side
    by side); the fewest splits on a tie. From shapes alone: no value on
    the card is read."""
    units = max(int(units), 1)
    blocks = cdiv(max(int(max_tokens), 0), QUANT_BLOCK)
    most = max(1, min(MAX_SPLITS, blocks // V2_MIN_BLOCKS))
    return min(range(1, most + 1),
               key=lambda s: (Fraction(cdiv(units * s, V2_RESIDENT), s), s))


def quantize_pool(x: torch.Tensor):
    """The JAX probe's int8 quantization of a pool [Hkv, P, ps, D]
    (make_pools :45-55): per (128-token block, channel) scale max |x| /
    127 (at least 1e-8), codes round(x / scale) clipped to +-127.
    Returns (codes int8 [Hkv, P, ps, D], scales fp32 [Hkv, P, ps / 128,
    D])."""
    h, n, ps, d = x.shape
    xr = x.float().reshape(h, n, ps // QUANT_BLOCK, QUANT_BLOCK, d)
    sc = (xr.abs().amax(dim=3, keepdim=True) / 127.0).clamp(min=1e-8)
    q = torch.clamp(torch.round(xr / sc), -127, 127).to(torch.int8)
    return q.reshape(h, n, ps, d), sc[..., 0, :].contiguous()


def make_pools(rng, ps, *, b=B, hkv=HKV, d=D, ctx=CTX, device="cpu"):
    """The JAX probe's make_pools(ps): fp32 K/V pools [Hkv, B * ctx / ps,
    ps, D] ~ N(0, 0.02^2), their int8 codes and scales, a page table of
    shuffled pages and lengths ctx - 8. Returns (kf, vf, kq, vq, ks, vs,
    table, lengths) on `device` (kf, vf fp32)."""
    mp = ctx // ps
    npages = b * mp
    shape = (hkv, npages, ps, d)
    kf = torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32))
    kf = kf.to(device)
    vf = torch.from_numpy(rng.normal(0, 0.02, shape).astype(np.float32))
    vf = vf.to(device)
    kq, ks = quantize_pool(kf)
    vq, vs = quantize_pool(vf)
    table = torch.from_numpy(rng.permutation(npages)[: b * mp]
                             .reshape(b, mp).astype(np.int32)).to(device)
    lengths = torch.full((b,), ctx - 8, dtype=torch.int32, device=device)
    return kf, vf, kq, vq, ks, vs, table, lengths


def paged_int8_v2_plain(q, k_pool, v_pool, k_scales, v_scales, page_table,
                        lengths, *, scale):
    """v2's function in plain PyTorch: B4's int8 plain version, whose
    roundings are v2's (each code times its block's scale in fp32 rounded
    to q's dtype, fp32 scores and softmax, probabilities rounded to q's
    dtype before the PV product). Returns (o, lse)."""
    return paged_flash_decode_plain(
        q, k_pool, v_pool, page_table, lengths, scale=scale,
        k_scales=k_scales, v_scales=v_scales)


def _v2_cuda(q, k_pool, v_pool, k_scales, v_scales, page_table, lengths,
             *, scale):
    global paged_int8_v2_launches
    b, hq, d = q.shape
    hkv, num_pages, page_size, _ = k_pool.shape
    if q.dtype != torch.bfloat16 or k_pool.dtype != torch.int8 \
            or v_pool.dtype != torch.int8:
        raise TypeError(f"the P2 v2 kernel takes a bf16 q and int8 pools "
                        f"(got {q.dtype}, {k_pool.dtype}, {v_pool.dtype})")
    if d != 128 or hq // hkv > 8 or page_size % QUANT_BLOCK:
        raise NotImplementedError(
            f"the P2 v2 kernel is built for D = 128, at most 8 q rows per "
            f"kv head and pages of a multiple of {QUANT_BLOCK} (got D = "
            f"{d}, {hq // hkv} rows, pages of {page_size})")
    tensors = dict(q=q, k_pool=k_pool, v_pool=v_pool, k_scales=k_scales,
                   v_scales=v_scales, page_table=page_table,
                   lengths=lengths)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if k_scales.dtype != torch.float32 or v_scales.dtype != torch.float32 \
            or page_table.dtype != torch.int32 \
            or lengths.dtype != torch.int32:
        raise TypeError("scales must be fp32, page_table and lengths int32")
    o = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device)
    if b == 0:
        return o, lse
    width = page_table.shape[1]
    units = b * hkv
    splits = v2_splits(units, width * page_size)
    stream = _cuda.stream_handle(q.device)
    ws = counters = None
    if splits > 1:
        ws, counters = _cuda.scratch(q.device, stream,
                                     units * splits * V2_ROWS * (d + 2),
                                     units)
    code = _cuda.lib().fa_probe_paged_int8_v2(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scales.data_ptr(), v_scales.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), o.data_ptr(), lse.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), b, hq, hkv,
        num_pages, page_size, width, d, splits, scale, stream)
    paged_int8_v2_launches += 1
    _cuda.check(code, "probe paged_int8 v2")
    return o, lse


def paged_int8_v2(q, k_pool, v_pool, k_scales, v_scales, page_table,
                  lengths, *, scale=None):
    """Paged decode over int8 pools [Hkv, P, ps, D] with fp32 scales [Hkv,
    P, ps / 128, D] by the JAX probe's v2 body: (o [B, Hq, D] in q's
    dtype, lse [B, Hq] fp32). A CUDA tensor launches the v2 kernel or
    raises; a CPU tensor runs paged_int8_v2_plain."""
    b, hq, d = q.shape
    hkv, num_pages, page_size = k_pool.shape[:3]
    want = (hkv, num_pages, page_size // QUANT_BLOCK, d)
    if page_size % QUANT_BLOCK or tuple(k_scales.shape) != want \
            or tuple(v_scales.shape) != want or hq % hkv:
        raise ValueError(f"pools {tuple(k_pool.shape)}, scales "
                         f"{tuple(k_scales.shape)} / "
                         f"{tuple(v_scales.shape)}, Hq = {hq}: pages must "
                         f"hold whole {QUANT_BLOCK}-token blocks, scales "
                         f"{want}, Hkv | Hq")
    scale = float(1.0 / math.sqrt(d) if scale is None else scale)
    args = (q, k_pool, v_pool, k_scales, v_scales, page_table, lengths)
    if q.is_cuda:
        return _v2_cuda(*args, scale=scale)
    if q.device.type == "cpu":
        return paged_int8_v2_plain(*args, scale=scale)
    raise ValueError(f"unsupported device {q.device}")


def run(b: int = B, hq: int = HQ, hkv: int = HKV, d: int = D,
        ctx: int = CTX, *, pages=PAGES, device="cuda", seed: int = 0,
        timer=None, keep_outputs: bool = False, out=print) -> list:
    """The probe's rows (dicts with "page", times in ms); with
    keep_outputs the v2 row also holds its (o, lse), its plain
    version's and the fp32 reference's under "outputs"."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out(f"{device_line(dev)}  B={b} {hq}q/{hkv}kv D={d} ctx={ctx}")
    q = torch.from_numpy(rng.normal(0, 0.02, (b, hq, d))).to(
        dev, torch.bfloat16)
    scale = float(1.0 / math.sqrt(d))
    kv_bytes = 2 * b * hkv * (ctx - 8) * d
    timer = timer or default_timer(dev)
    rows = []
    for ps in pages:
        kf, vf, kq, vq, ks, vs, table, lens = make_pools(
            rng, ps, b=b, hkv=hkv, d=d, ctx=ctx, device=dev)
        lengths = lens.tolist()
        qkw = dict(k_scales=ks, v_scales=vs)
        cases = [(f"v0 shipped int8 (page {ps})", kq, vq, qkw, 1)]
        if ps == PAGES[0]:
            kb, vb = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
            cases = [(f"bf16 pools (page {ps})", kb, vb, {}, None)] + cases
            cases.append((f"v1 fold_scales (page {ps})", kq, vq,
                          dict(fold_scales=True, **qkw), 1))
        else:
            cases[0] = (f"v3 shipped int8 (page {ps})",) + cases[0][1:]
        del kf, vf
        for name, k_, v_, kw, kvi in cases:
            cost = paged_decode_cost(lengths, hq, hkv, d, 2, ps,
                                     kv_itemsize=kvi)
            rows.append(row(
                name, timer(lambda: paged_flash_decode(
                    q, k_, v_, table, lens, **kw)),
                kv_bytes, cost,
                plain_ms=timer(lambda: paged_flash_decode_plain(
                    q, k_, v_, table, lens, scale=scale, **kw)),
                out=out, page=ps))
        if ps == PAGES[0]:
            rows.append(_v2_row(q, kq, vq, ks, vs, table, lens, scale, ps,
                                kv_bytes, timer, keep_outputs, out))
        del cases, kq, vq
    return rows


def _v2_row(q, kq, vq, ks, vs, table, lens, scale, ps, kv_bytes, timer,
            keep_outputs, out):
    args = (q, kq, vq, ks, vs, table, lens)
    o, lse = paged_int8_v2(*args, scale=scale)
    po, plse = paged_int8_v2_plain(*args, scale=scale)
    # The fp32 reference over the dequantized pools (the JAX probe's
    # paged_decode_reference), with its LSE.
    ro, rlse = paged_flash_decode_plain(q.float(), kq, vq, table, lens,
                                        scale=scale, k_scales=ks,
                                        v_scales=vs)
    err = float((o.float() - ro).abs().max())
    extra = dict(page=ps, max_abs_err=float((o.float() - po.float())
                                            .abs().max()),
                 ref_max_abs_err=err)
    if keep_outputs:
        extra["outputs"] = dict(o=o, lse=lse, plain_o=po, plain_lse=plse,
                                ref_o=ro, ref_lse=rlse)
    hq, hkv, d = q.shape[1], kq.shape[0], q.shape[2]
    return row(f"v2 blocked convert+dot (maxabs {err:.1e})",
               timer(lambda: paged_int8_v2(*args, scale=scale)), kv_bytes,
               paged_decode_cost(lens.tolist(), hq, hkv, d, 2, ps,
                                 kv_itemsize=1),
               plain_ms=timer(lambda: paged_int8_v2_plain(*args,
                                                          scale=scale)),
               out=out, **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain versions)")
    ap.add_argument("--b", type=int, default=B)
    ap.add_argument("--hq", type=int, default=HQ)
    ap.add_argument("--hkv", type=int, default=HKV)
    ap.add_argument("--d", type=int, default=D, choices=CUDA_HEAD_DIMS)
    ap.add_argument("--ctx", type=int, default=CTX)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args(argv)
    run(a.b, a.hq, a.hkv, a.d, a.ctx, device=a.device, seed=a.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
