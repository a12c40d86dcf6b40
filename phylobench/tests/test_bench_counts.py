"""The frozen counts against values worked by hand at the bring-up's kernel
shapes (PERF.md's kernel table: Makona 1,610 x 4 x 4 x 2,048 and the
GY94+G4 codon tree 1,441 x 4 x 61 x 593, one chain and four)."""

import pytest

from phylobench import peaks
from phylobench.counts import peel, peel_stream, peel_stream_ring, step

MAKONA = {"taxa": 1610, "nodes": 3219, "categories": 4, "states": 4,
          "patterns": 2048}
CODON = {"taxa": 1441, "nodes": 2881, "categories": 4, "states": 61,
         "patterns": 593}


def test_peel_operations_by_hand():
    # 1,609 internal nodes x 4 categories x 2,048 patterns x (64 + 12),
    # plus 2 x 4 x 4 x 2,048 at the root
    assert peel.count(MAKONA, 1)[0] == 1609 * 4 * 2048 * 76 + 65536
    assert peel.count(MAKONA, 1)[0] == 1_001_816_064
    # 1,440 x 4 x 593 x (4 x 3,721 + 183) + 2 x 4 x 61 x 593
    assert peel.count(CODON, 1)[0] == 51_464_339_944
    assert peel.count(CODON, 4)[0] == 4 * 51_464_339_944


def test_peel_bytes_by_hand():
    # tips 1,610 x 4 x 2,048 doubles, matrices 3,219 x 4 x 16, weighted
    # frequencies 16, site log-likelihoods 2,048, two int32 rows of 1,609 x 2
    want = 8 * (1610 * 4 * 2048 + 3219 * 64 + 16 + 2048) + 4 * 1609 * 4
    assert peel.count(MAKONA, 1)[1] == want == 107_203_344
    post = peel.count(MAKONA, 1, partials=True)[1]
    assert post - want == 8 * 1609 * 4 * 4 * 2048


@pytest.mark.parametrize("shape,chains,ms", [
    (CODON, 1, 0.768124), (CODON, 4, 3.072498), (MAKONA, 1, 0.032001)])
def test_bounds_match_the_kernel_table(shape, chains, ms):
    got = 1e3 * peel.bound_s(shape, chains, False, peaks.PEAK_FLOPS[
        "float64"], peaks.HBM_BYTES_PER_S)
    assert got == pytest.approx(ms, abs=5e-6)


def test_step_counts_and_the_gradient_convention():
    # P(t): 2 S^3 + S^2 + S a matrix, one a node and category
    assert step.transition_ops(MAKONA, 1) == 3219 * 4 * (128 + 16 + 4)
    one = step.evaluation_ops(CODON, 4)
    assert one == (4 * 51_464_339_944
                   + 4 * 2881 * 4 * (2 * 61 ** 3 + 61 ** 2 + 61))
    # a gradient is three evaluations: 10 launches of which 4 gradients
    assert step.window_ops(CODON, 4, 10, 4) == 18 * one


def test_kernel_modules_name_their_trace_kernels():
    assert peel_stream.TRACE_NAMES == ("peel_levels_kernel",)
    assert "ring_teams_kernel" in peel_stream_ring.TRACE_NAMES
