"""Port parity: the public names and keywords of the JAX package, and
the paged-decode input guard.

  * `validate_paged_inputs` raises, for the cases of the JAX package's
    `tests/test_paged.py:test_validate_paged_inputs_checkify` and a
    negative page id, a ValueError whose message is the JAX checkify
    guard's (run as that test runs it, under jit).
  * `flash_attention_fwd(strict_below=w)` and `(causal=True,
    diag_band=w)`, the two passes of the causal split on their own,
    against the JAX kernels at the same keywords (interpret mode) on
    seeded N(0, 1) fp32 inputs: O and LSE max-abs <= 2e-5 (fp32
    accumulation order; rows no column is visible to give O = 0 and LSE
    = INIT_M * scale in both). Their guards raise ValueError in both
    packages.
  * `block_sizes=` is accepted on the CPU and changes nothing;
    `select_block_sizes` has the JAX signature and returns B1's tile.
  * Every name the JAX package exports from its top level, `models`,
    `utils`, `ops`, `runtime` and `parallel` is importable from the port
    under that name, except the sharding and pipeline names of later
    multi-device slices.
  * `save_checkpoint` takes the JAX package's keywords (`blocking=`).
"""

import inspect
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

import flash_attention_tpu
import flash_attention_tpu.models
import flash_attention_tpu.ops
import flash_attention_tpu.parallel
import flash_attention_tpu.runtime
import flash_attention_tpu.utils
import flash_attention_tpu_torch
import flash_attention_tpu_torch.models
import flash_attention_tpu_torch.ops
import flash_attention_tpu_torch.parallel
import flash_attention_tpu_torch.runtime
import flash_attention_tpu_torch.utils
from flash_attention_tpu import config as jconfig
from flash_attention_tpu.config import BlockSizes as JaxBlockSizes
from flash_attention_tpu.ops.flash import flash_attention_fwd as jax_fwd
from flash_attention_tpu.ops.paged import (
    validate_paged_inputs as jax_validate,
)
from flash_attention_tpu.utils import checkpoint as jcheckpoint
from flash_attention_tpu_torch import config
from flash_attention_tpu_torch.config import BlockSizes
from flash_attention_tpu_torch.ops import flash
from flash_attention_tpu_torch.ops.paged import validate_paged_inputs
from flash_attention_tpu_torch.utils import checkpoint
from flash_attention_tpu_torch.utils.metrics import max_abs_error

ATOL = 2e-5
JAX_BLOCKS = JaxBlockSizes(block_q=128, block_kv=128)
# Names the JAX package exports that the port does not have yet: none.
SHARDING_NAMES = set()

HKV, PAGES, PS, D = 2, 8, 128, 64
GOOD_TABLE = [[0, 1], [2, 3]]
GOOD_LENGTHS = [100, 256]
PAGED_CASES = {
    "good": (GOOD_TABLE, GOOD_LENGTHS, None),
    "page_past_pool": ([[0, 99], [2, 3]], GOOD_LENGTHS,
                       "out-of-range page ids"),
    "negative_page": ([[0, -1], [2, 3]], GOOD_LENGTHS,
                      "out-of-range page ids"),
    "length_over_capacity": (GOOD_TABLE, [100, 2 * PS + 1],
                             "exceed page-table capacity"),
    "negative_length": (GOOD_TABLE, [-1, 256],
                        "exceed page-table capacity"),
}


def _jax_guard(table, lengths):
    """The JAX guard's error as tests/test_paged.py runs it (checkify
    under jit): None, or the message of the exception it throws."""
    kp = jnp.zeros((HKV, PAGES, PS, D), jnp.float32)

    @jax.jit
    def run(tbl, lens):
        err, _ = checkify.checkify(
            jax_validate, errors=checkify.user_checks)(kp, tbl, lens)
        return err

    err = run(jnp.asarray(table, jnp.int32), jnp.asarray(lengths, jnp.int32))
    try:
        err.throw()
    except Exception as exc:   # checkify's JaxRuntimeError
        return str(exc)
    return None


@pytest.mark.parametrize("case", list(PAGED_CASES))
def test_validate_paged_inputs_matches_jax(case):
    table, lengths, match = PAGED_CASES[case]
    jax_msg = _jax_guard(table, lengths)
    kp = torch.zeros(HKV, PAGES, PS, D)
    args = (kp, torch.tensor(table, dtype=torch.int32),
            torch.tensor(lengths, dtype=torch.int32))
    if match is None:
        assert jax_msg is None
        validate_paged_inputs(*args)
        return
    with pytest.raises(ValueError, match=match) as info:
        validate_paged_inputs(*args)
    assert jax_msg is not None and str(info.value) in jax_msg


def test_validate_paged_inputs_takes_quantized_pools_and_page_size():
    """int8 codes as the pool (shape [Hkv, P, page, D], as JAX reads
    it) and an explicit page_size: capacity W * page_size."""
    codes = torch.zeros(HKV, PAGES, PS, D, dtype=torch.int8)
    table = torch.tensor(GOOD_TABLE, dtype=torch.int32)
    validate_paged_inputs(codes, table, torch.tensor([0, 256]))
    with pytest.raises(ValueError, match=r"capacity \(128 tokens\)"):
        validate_paged_inputs(codes, table, torch.tensor([0, 129]),
                              page_size=64)
    with pytest.raises(ValueError, match=r"pool has 8 pages"):
        validate_paged_inputs(codes, torch.tensor([[8, 0]]),
                              torch.tensor([1]))


def _inputs(seed, nq=512, nk=512, d=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1.0, shape).astype(np.float32)
            for shape in ((1, 2, nq, d), (1, 2, nk, d), (1, 2, nk, d))]


@pytest.mark.parametrize("kind, w", [("strict_below", 128),
                                     ("strict_below", 256),
                                     ("diag_band", 128),
                                     ("diag_band", 256)])
def test_split_pass_matches_jax(kind, w):
    q, k, v = _inputs(w + len(kind))
    causal = kind == "diag_band"
    o_j, lse_j = jax_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                         causal=causal, block_sizes=JAX_BLOCKS, **{kind: w})
    o_t, lse_t = flash.flash_attention_fwd(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        **{kind: w})
    assert lse_t.shape == (1, 2, 512)
    assert max_abs_error(o_t, o_j) <= ATOL
    assert max_abs_error(lse_t, np.asarray(lse_j)[..., 0]) <= ATOL
    if kind == "strict_below":   # the first band sees no column
        assert bool((o_t[:, :, :w] == 0).all())


@pytest.mark.parametrize("kw, nk", [
    (dict(causal=True, strict_below=128), 512),
    (dict(causal=False, diag_band=128), 512),
    (dict(causal=True, diag_band=128), 640)])
def test_split_pass_guards_match_jax(kw, nk):
    q, k, v = _inputs(7, nk=nk)
    with pytest.raises(ValueError):
        jax_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                block_sizes=JAX_BLOCKS, **kw)
    with pytest.raises(ValueError):
        flash.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)),
                                  **kw)


def test_split_pass_band_must_be_a_multiple_of_the_q_tile():
    x = torch.zeros(1, 1, 512, 64)
    with pytest.raises(ValueError, match="64-row q tile"):
        flash.flash_attention_fwd(x, x, x, strict_below=96)
    with pytest.raises(ValueError, match="64-row q tile"):
        flash.flash_attention_fwd(x, x, x, causal=True, diag_band=96)


@pytest.mark.parametrize("causal", [False, True])
def test_block_sizes_accepted_on_cpu(causal):
    """block_sizes= on the CPU: the JAX result at the same tile, and the
    port's result without it, bit for bit (B1's plain version is
    untiled); the gradients of flash_attention likewise."""
    q, k, v = _inputs(11, nq=256, nk=256)
    o_j, lse_j = jax_fwd(*(jnp.asarray(x) for x in (q, k, v)),
                         causal=causal, block_sizes=JAX_BLOCKS)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o_t, lse_t = flash.flash_attention_fwd(
        tq, tk, tv, causal=causal, block_sizes=BlockSizes(128, 128))
    assert max_abs_error(o_t, o_j) <= ATOL
    assert max_abs_error(lse_t, np.asarray(lse_j)[..., 0]) <= ATOL
    o_0, lse_0 = flash.flash_attention_fwd(tq, tk, tv, causal=causal)
    assert torch.equal(o_t, o_0) and torch.equal(lse_t, lse_0)

    grads = []
    for bs in (None, BlockSizes(16, 32)):
        xs = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
        flash_attention_tpu_torch.flash_attention(
            *xs, causal=causal, block_sizes=bs).sum().backward()
        grads.append([x.grad for x in xs])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_block_sizes_checked_against_b1_tile_on_the_card():
    """On a CUDA tensor B1 takes only its compiled tile (the tensor is a
    stand-in: the check reads only is_cuda, dtype and the head dim)."""
    q = types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16,
                              shape=(1, 1, 1, 128))
    flash._check_block_sizes(q, BlockSizes(128, 128))
    flash._check_block_sizes(q, None)
    with pytest.raises(ValueError, match=r"compiled for .* \(128, 128\)"):
        flash._check_block_sizes(q, BlockSizes(64, 64))


@pytest.mark.parametrize("dtype, d, tile", [
    (torch.bfloat16, 128, (128, 128)), (torch.float16, 64, (128, 128)),
    (torch.bfloat16, 256, (64, 64)), (torch.float32, 128, (64, 64)),
    (torch.float32, 256, (32, 64))])
def test_select_block_sizes_gives_b1_tile(dtype, d, tile):
    bs = flash_attention_tpu_torch.select_block_sizes(
        8192, 8192, d, dtype=dtype, causal=True)
    assert isinstance(bs, BlockSizes)
    assert (bs.block_q, bs.block_kv) == tile == config.b1_tile(dtype, d)


def test_select_block_sizes_has_the_jax_signature():
    ours = inspect.signature(config.select_block_sizes).parameters
    theirs = inspect.signature(jconfig.select_block_sizes).parameters
    assert list(ours) == list(theirs)
    assert [p.kind for p in ours.values()] == \
        [p.kind for p in theirs.values()]


def test_save_checkpoint_has_the_jax_signature(tmp_path):
    """The JAX keywords, `blocking=` among them, in the JAX order; a
    non-blocking save has finished when it returns (torch.save is
    synchronous) and restores."""
    ours = inspect.signature(checkpoint.save_checkpoint).parameters
    theirs = inspect.signature(jcheckpoint.save_checkpoint).parameters
    assert list(ours) == list(theirs)
    assert [p.kind for p in ours.values()] == \
        [p.kind for p in theirs.values()]
    assert [p.default for p in ours.values()] == \
        [p.default for p in theirs.values()]
    state = {"w": torch.arange(6.0).reshape(2, 3), "step": 7}
    checkpoint.save_checkpoint(tmp_path, 7, state, blocking=False)
    step, got = checkpoint.restore_checkpoint(tmp_path)
    assert step == 7 and got["step"] == 7 and torch.equal(got["w"],
                                                          state["w"])


def _jax_exports():
    return [(mod, name)
            for mod in ("", "models", "utils", "ops", "runtime", "parallel")
            for name in getattr(
                flash_attention_tpu if not mod else
                getattr(flash_attention_tpu, mod), "__all__")
            if name not in SHARDING_NAMES
            and name != "__version__"]


@pytest.mark.parametrize("mod, name", _jax_exports(),
                         ids=lambda x: x or "top")
def test_jax_public_name_is_exported(mod, name):
    port = flash_attention_tpu_torch if not mod else \
        getattr(flash_attention_tpu_torch, mod)
    assert name in port.__all__
    obj = getattr(port, name)
    assert obj.__module__.startswith("flash_attention_tpu_torch.")
