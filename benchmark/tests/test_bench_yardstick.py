"""The frozen yardstick reproduces the bound column of PERF.md's kernel
table, at the shapes each row names."""

import pytest

from benchmark.frozen import Sweep, bound_ms, point_flops

# (kernel, sweep, bound ms as PERF.md's kernel table gives it)
ROWS = [
    ("coarse_sigma_t", Sweep("sigma", 16384, 64, 2, 64, -1, 4), 0.0125),
    ("coarse_sigma_t", Sweep("sigma", 16384, 32, 2, 64, -1, 4), 0.0062),
    ("coarse_sigma_t", Sweep("sigma", 16384, 64, 8, 128, 4, 10), 0.2777),
    ("fine_raw_t", Sweep("fine", 16384, 128, 8, 128, 4, 10), 0.6791),
    ("fine_raw_t", Sweep("fine", 16384, 128, 8, 256, 4, 10), 2.5742),
    ("fine_raw_t", Sweep("fine", 1536, 128, 8, 128, 4, 10), 0.0637),
    ("fine_raw_t", Sweep("static", 1536, 64, 8, 128, 4, 10), 0.0277),
    ("fine_raw_t", Sweep("fine", 1536, 32, 8, 128, 4, 10), 0.0159),
    ("fine_raw_t", Sweep("fine", 1536, 12, 8, 128, 4, 10), 0.0060),
    ("fine_composite_t", Sweep("fine", 16384, 24, 8, 128, 4, 10), 0.1273),
    ("fine_composite_t", Sweep("fine", 16384, 128, 8, 128, 4, 10), 0.6791),
    ("raw_bwd_t", Sweep("fine", 1536, 128, 8, 128, 4, 10), 0.1846),
    ("raw_bwd_t", Sweep("static", 1536, 64, 8, 128, 4, 10), 0.0799),
    ("raw_bwd_t", Sweep("fine", 1536, 128, 8, 256, 4, 10), 0.7112),
    ("raw_bwd_t", Sweep("static", 1536, 64, 8, 256, 4, 10), 0.3063),
    ("raw_bwd_t", Sweep("fine", 1536, 32, 8, 128, 4, 10), 0.0461),
    ("raw_bwd_t", Sweep("fine", 1536, 12, 8, 128, 4, 10), 0.0173),
]


@pytest.mark.parametrize("kernel,sweep,want", ROWS)
def test_bound_matches_the_kernel_table(kernel, sweep, want):
    assert round(bound_ms(kernel, sweep), 4) == want


def test_point_flops_counts_every_layer_of_the_shipped_nets():
    # the fine NeRF-W net at D=8 W=128 (in_xyz 63, skip at 4): trunk,
    # xyz_final, dir and trans_0's point rows, trans_1..3 and the heads
    trunk = 63 * 128 + 3 * 128 * 128 + (128 + 63) * 128 + 3 * 128 * 128
    rest = 128 + 128 * 128 + 128 * 64 + 64 * 3 + 128 * 64 + 3 * 64 * 64 + 64 * 5
    assert point_flops(8, 128, 4, 63) == 2 * (trunk + rest)
    assert point_flops(2, 64, -1, 27, kind="sigma") == 2 * (27 * 64 + 64 * 64 + 64)
