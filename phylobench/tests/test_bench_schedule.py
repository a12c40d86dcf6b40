"""The window's operator draws: the same work on every seed, in another
order."""

import collections
import itertools

import pytest

from phylobench import harness

MAKONA = [3, 3, 1, 1, 3, 10, 15, 15, 3, 3, 3, 30]


@pytest.mark.parametrize("seed", [1, 2147483901, 2101000001])
def test_each_block_holds_the_weights(seed):
    steps = list(itertools.islice(harness.schedule(MAKONA, [], seed),
                                  3 * sum(MAKONA)))
    for k in range(3):
        block = steps[k * 90:(k + 1) * 90]
        assert collections.Counter(block) == dict(enumerate(MAKONA))


def test_added_operator_once_a_block_and_seeds_differ_in_order():
    a = list(itertools.islice(harness.schedule(MAKONA, [8], 5), 720))
    b = list(itertools.islice(harness.schedule(MAKONA, [8], 6), 720))
    assert all(a[i:i + 8].count(12) == 1 for i in range(0, 720, 8))
    assert collections.Counter(a) == collections.Counter(b)
    assert a != b
    again = list(itertools.islice(harness.schedule(MAKONA, [8], 5), 720))
    assert a == again


def test_weights_not_whole_refused():
    with pytest.raises(ValueError):
        next(harness.schedule([0.5, 1.5], [], 1))
