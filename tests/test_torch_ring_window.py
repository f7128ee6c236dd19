"""Port parity: ring attention with a window across chunks and with
segment ids in the zigzag layout, against the JAX package's
`make_ring_attention` (the setup of test_torch_ring.py: the port's ring
at 4 gloo ranks from one spawn for the file, the JAX ring on 4 virtual
CPU devices in the Pallas interpreter, seeded N(0, 0.02) inputs,
`verify` against the JAX ring and an exact fp64 result).

  * window 300 (across chunks of 128), contiguous causal, O and
    dQ / dK / dV;
  * packed segment ids (up to 5 documents) in the zigzag layout, O.

A file of its own, beside test_torch_ring_masks.py, for the time the
JAX package's windowed ring takes in the interpreter. Measured max-abs
gaps to the JAX ring: O <= 7.5e-9, dQ / dK <= 5.5e-12, dV <= 1.2e-8.
"""

import pytest

from tests.test_torch_ring import SP, N_LOCAL, PortRing, RingCases

RING = RingCases({
    "window300": dict(causal=True, window=300, seed=70, grads=True),
    "segments_zigzag": dict(causal=True, layout="zigzag", seed=90,
                            seg_seed=11, n=2 * SP * N_LOCAL),
})


@pytest.fixture(scope="module")
def port():
    return PortRing(RING.worker_cases())


@pytest.mark.parametrize("name, which", RING.items(),
                         ids=[f"{n}-{w}" for n, w in RING.items()])
def test_ring_window_matches_jax(port, name, which):
    RING.check(port, name, which)
