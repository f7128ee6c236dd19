"""Port parity: ring attention under its masks, against the JAX
package's `make_ring_attention` (the setup of test_torch_ring.py: the
port's ring at 4 gloo ranks from one spawn for the file, the JAX ring on
4 virtual CPU devices in the Pallas interpreter, seeded N(0, 0.02)
inputs, `verify` against the JAX ring and an exact fp64 result).

  * window 100 (under one 128-row chunk), contiguous causal, O and
    dQ / dK / dV;
  * packed segment ids (`tests/test_segments.py:make_segments`, up to 5
    documents), contiguous causal, O;
  * GQA 4 / 2 on a dp = 2 x sp = 2 mesh (qkv_spec ("dp", None, "sp",
    None): each dp rank holds its own batch row), O.

The window across chunks (300) and zigzag segment ids are in
test_torch_ring_window.py. Measured max-abs gaps
to the JAX ring: O <= 7.5e-9, dQ / dK <= 5.5e-12, dV <= 1.2e-8.
"""

import numpy as np
import pytest

from tests.test_torch_ring import SP, N_LOCAL, PortRing, RingCases

RING = RingCases({
    "window100": dict(causal=True, window=100, seed=60, grads=True),
    "segments": dict(causal=True, seed=80, seg_seed=11),
    "gqa_dp": dict(causal=True, seed=100, b=2, hq=4, hkv=2, n=2 * N_LOCAL,
                   dp=2, sp=2),
})


@pytest.fixture(scope="module")
def port():
    return PortRing(RING.worker_cases())


@pytest.mark.parametrize("name, which", RING.items(),
                         ids=[f"{n}-{w}" for n, w in RING.items()])
def test_ring_masks_match_jax(port, name, which):
    RING.check(port, name, which)


def test_gqa_rows_stay_on_their_dp_rank(port):
    """The GQA case ran as 2 dp rows x 2 sp chunks on 4 ranks: each batch
    row's O is its own row's exact result (the rows never mix)."""
    got = port.get()
    assert all(len(got[n]["launches"]) == SP for n in RING.cases)
    (q, _, _, _, _), ex = RING.inputs("gqa_dp")
    assert got["gqa_dp"]["o"].shape == q.shape
    for row in range(q.shape[0]):
        assert np.abs(got["gqa_dp"]["o"][row].numpy()
                      - ex[0][row]).max() <= 1e-6
