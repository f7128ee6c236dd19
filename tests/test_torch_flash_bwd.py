"""Port parity: the differentiable flash_attention of
flash_attention_tpu_torch (B1 forward, B2/B3 backward) against the JAX
package's custom_vjp.

Seeded numpy inputs and cotangent go through both packages in fp32. The
JAX side is jax.grad through `flash_attention` with its Pallas kernels in
interpret mode (tests/conftest.py keeps JAX on the CPU), with the 128
blocks of tests/test_flash_bwd.py; the port's side is torch.autograd
through `flash_attention`, whose CPU tensors take the plain forward and
backward. Tolerance: the repo's 2% symmetric relative gate and max-abs
<= 5e-5 on dq, dk and dv (fp32 accumulation-order noise at these sizes
and magnitudes is ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attention_tpu.config import BlockSizes
from flash_attention_tpu.ops.flash import flash_attention as jax_flash
from flash_attention_tpu_torch.ops import flash as tflash
from flash_attention_tpu_torch.ops.reference import attention_reference
from flash_attention_tpu_torch.utils.metrics import max_abs_error, verify

ATOL = 5e-5
BLOCKS = BlockSizes(block_q=128, block_kv=128, block_q_dq=128,
                    block_kv_dq=128, block_q_dkv=128, block_kv_dkv=128)

# (batch, hq, hkv, nq, nk, d, causal): the cases of tests/test_flash_bwd.py
CASES = {
    "noncausal": (1, 2, 2, 256, 256, 64, False),
    "causal": (1, 2, 2, 256, 256, 64, True),
    "gqa_4_2": (1, 4, 2, 128, 128, 64, True),
    "unpadded_200": (1, 2, 2, 200, 200, 64, True),
    "offset_nq_lt_nk": (1, 2, 2, 128, 256, 64, True),
    "multi_kv_block_384": (1, 1, 1, 384, 384, 64, False),
}


def _inputs(seed, b, hq, hkv, nq, nk, d, std=0.02):
    """q, k, v ~ N(0, std^2) (the repo's test inputs, tests/conftest.py
    make_qkv) and a N(0, 1) cotangent."""
    rng = np.random.default_rng(seed)
    q = rng.normal(0, std, (b, hq, nq, d)).astype(np.float32)
    k = rng.normal(0, std, (b, hkv, nk, d)).astype(np.float32)
    v = rng.normal(0, std, (b, hkv, nk, d)).astype(np.float32)
    ct = rng.normal(0, 1.0, (b, hq, nq, d)).astype(np.float32)
    return q, k, v, ct


def _torch_grads(fn, q, k, v, ct):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    loss = (fn(qt, kt, vt).float() * torch.from_numpy(ct)).sum()
    return torch.autograd.grad(loss, (qt, kt, vt))


@pytest.mark.parametrize("name", list(CASES))
def test_flash_grads_match_jax(name):
    b, hq, hkv, nq, nk, d, causal = CASES[name]
    q, k, v, ct = _inputs(len(name), b, hq, hkv, nq, nk, d)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_sizes=BLOCKS)
        return jnp.sum(o.astype(jnp.float32) * ct)

    gj = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    gt = _torch_grads(
        lambda q, k, v: tflash.flash_attention(q, k, v, causal=causal),
        q, k, v, ct)
    for gname, a, ref in zip(("dq", "dk", "dv"), gt, gj):
        ref = np.asarray(ref)
        assert a.shape == ref.shape, gname
        assert max_abs_error(a, ref) <= ATOL, gname
        report = verify(a, ref)
        assert report.passed, f"{gname}: {report}"


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_plain_matches_autograd_of_reference(causal):
    """The plain backward (with its explicit delta and select masking)
    against torch.autograd through the exact fp32 reference, GQA 4/2
    with ragged lengths."""
    q, k, v, ct = _inputs(11, 2, 4, 2, 77, 131, 64, std=1.0)
    got = _torch_grads(
        lambda q, k, v: tflash.flash_attention(q, k, v, causal=causal),
        q, k, v, ct)
    want = _torch_grads(
        lambda q, k, v: attention_reference(q, k, v, causal=causal),
        q, k, v, ct)
    for gname, a, ref in zip(("dq", "dk", "dv"), got, want):
        assert max_abs_error(a, ref) <= ATOL, gname


def test_flash_bwd_plain_dead_rows_give_zero_gradients():
    """Rows that see no key (causal with a negative offset: rows 0..4
    here) export O = 0 and LSE = INIT_M * scale from the forward; the
    backward must give them zero dq and no contribution to dk/dv -- no
    inf or NaN -- and the live rows must match autograd through a masked
    exact reference."""
    q, k, v, ct = map(torch.from_numpy,
                      _inputs(5, 1, 2, 1, 40, 40, 64, std=1.0))
    scale, offset = 0.125, -5
    o, lse = tflash.flash_attention_fwd_plain(q, k, v, causal=True,
                                              scale=scale, offset=offset)
    assert torch.all(o[:, :, :5] == 0)
    assert torch.all(lse[:, :, :5] == np.float32(tflash.INIT_M * scale))
    dq, dk, dv = tflash.flash_attention_bwd_plain(
        q, k, v, o, lse, ct, causal=True, scale=scale, offset=offset)
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))
    assert torch.all(dq[:, :, :5] == 0)

    live = torch.arange(40)[:, None] >= 5
    visible = torch.arange(40)[None, :] <= torch.arange(40)[:, None] \
        + offset

    def masked_reference(q, k, v):
        kk = k.repeat_interleave(2, dim=1)
        vv = v.repeat_interleave(2, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", q, kk) * scale
        s = s.masked_fill(~visible | ~live, float("-inf"))
        s = torch.where(live, s, torch.zeros_like(s))
        p = torch.softmax(s, dim=-1) * live
        return torch.einsum("bhqk,bhkd->bhqd", p, vv)

    want = _torch_grads(masked_reference, *(x.numpy() for x in
                                           (q, k, v, ct)))
    for gname, a, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert max_abs_error(a, ref) <= ATOL, gname


def test_flash_bwd_plain_rounds_like_the_kernels():
    """In bf16 the plain backward rounds dS and P to bf16 before their
    products and sums in fp32: equal to the same recompute written out
    with explicit casts, and close to the fp32 gradients."""
    q, k, v, ct = map(torch.from_numpy,
                      _inputs(3, 1, 2, 2, 64, 64, 64, std=1.0))
    qb, kb, vb, db = (x.to(torch.bfloat16) for x in (q, k, v, ct))
    scale = 0.125
    o, lse = tflash.flash_attention_fwd_plain(qb, kb, vb, causal=True,
                                              scale=scale, offset=0)
    dq, dk, dv = tflash.flash_attention_bwd_plain(
        qb, kb, vb, o, lse, db, causal=True, scale=scale, offset=0)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16

    s = torch.einsum("bhqd,bhkd->bhqk", qb.float(), kb.float())
    p = torch.exp(s * scale - lse[..., None]).tril()
    dp = torch.einsum("bhqd,bhkd->bhqk", db.float(), vb.float())
    delta = (db.float() * o.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(torch.bfloat16).float()
    want_dq = torch.einsum("bhqk,bhkd->bhqd", ds, kb.float())
    want_dv = torch.einsum("bhqk,bhqd->bhkd",
                           p.to(torch.bfloat16).float(), db.float())
    assert torch.equal(dq, want_dq.to(torch.bfloat16))
    assert torch.equal(dv, want_dv.to(torch.bfloat16))

    g32 = _torch_grads(
        lambda q, k, v: attention_reference(q, k, v, causal=True),
        *(x.numpy() for x in (q, k, v, ct)))
    for a, ref in zip((dq, dk, dv), g32):
        assert max_abs_error(a, ref) <= 0.05 * float(ref.abs().max())


def test_bwd_cost_counts_visible_pairs():
    (f2, b2), (f3, b3) = tflash.bwd_cost(1, 2, 1, 4, 4, 64, True, 2)
    pairs = 2 * (1 + 2 + 3 + 4)
    assert f2 == 6 * 64 * pairs and f3 == 8 * 64 * pairs
    assert b2 == 2 * 64 * (2 * 2 * 4 + 2 * 1 * 4 + 2 * 4) + 8 * 2 * 4
    assert b3 == 2 * 64 * (2 * 2 * 4 + 4 * 1 * 4) + 8 * 2 * 4
    (f2n, _), _ = tflash.bwd_cost(1, 2, 1, 4, 4, 64, False, 2)
    assert f2n == 6 * 64 * 2 * 16


def test_flash_bwd_unported_options_raise():
    q = torch.zeros(1, 2, 8, 64)
    with pytest.raises(NotImplementedError, match="slice"):
        tflash.flash_attention_bwd(q, q, q, q, q[..., 0], q,
                                   segment_ids=(0, 0))
    with pytest.raises(NotImplementedError, match="window"):
        tflash.flash_attention_bwd(q, q, q, q, q[..., 0], q, causal=True,
                                   window=4)


def _bf16(*shape):
    return torch.zeros(*shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("case, exc", [
    ("fp32", TypeError), ("mixed_dtype", TypeError),
    ("head_dim_32", NotImplementedError), ("non_contiguous", ValueError),
    ("lse_dtype", ValueError), ("lse_shape", ValueError),
])
def test_bwd_cuda_wrapper_rejects_what_the_kernels_do_not_take(case, exc):
    """B2/B3's wrapper raises on inputs the kernels are not built for,
    before it builds or launches anything (so this runs without a
    card)."""
    q, k = _bf16(1, 4, 64, 64), _bf16(1, 2, 64, 64)
    lse = torch.zeros(1, 4, 64)
    args = dict(q=q, k=k, v=k, o=q, lse=lse, do=q)
    if case == "fp32":
        args.update(q=q.float(), k=k.float(), v=k.float(), o=q.float(),
                    do=q.float())
    elif case == "mixed_dtype":
        args["do"] = q.half()
    elif case == "head_dim_32":
        q, k = _bf16(1, 4, 64, 32), _bf16(1, 2, 64, 32)
        args.update(q=q, k=k, v=k, o=q, do=q)
    elif case == "non_contiguous":
        args["do"] = _bf16(1, 4, 64, 64).transpose(2, 3)
    elif case == "lse_dtype":
        args["lse"] = lse.half()
    else:
        args["lse"] = torch.zeros(1, 4, 63)
    with pytest.raises(exc):
        tflash._flash_bwd_cuda(**args, causal=True, scale=0.125, offset=0)
