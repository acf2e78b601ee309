"""The traffic generator: deterministic by seed, the same batches for
every seed in another order."""

import pytest

from speedbench import traffic


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_closed_batches_deterministic_and_same_pool(seed):
    closed = traffic.load_mix("offline_b16")
    a = traffic.closed_batches(closed, seed)
    assert a == traffic.closed_batches(closed, seed)
    assert all(len(b) == closed["batch"] for b in a)
    assert len(a) == closed["pool"] // closed["batch"]
    other = traffic.closed_batches(closed, seed + 1)
    assert a != other
    # the same batches, in another order
    assert sorted(map(tuple, a)) == sorted(map(tuple, other))
