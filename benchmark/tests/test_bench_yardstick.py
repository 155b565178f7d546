"""The benchmark's frozen operation and byte counts equal the program's at
the cells' shapes today."""

import pytest

from harness import yardstick as ys
from ft_fsd_path_planning_torch.ops import banded_cholesky as bc
from ft_fsd_path_planning_torch.ops import beam_search as bs


@pytest.mark.parametrize("k,l,c", [(32, 12, 5), (8, 8, 5), (16, 12, 5), (64, 16, 5), (32, 32, 7)])
def test_b2_flops(k, l, c):
    assert ys.b2_search_flops(k, l, c) == bs.search_flops(256, k, l, c)


@pytest.mark.parametrize("g,n", [(2, 256), (512, 256), (512, 128)])
def test_b2_bytes(g, n):
    assert ys.b2_search_bytes(g, n, 32, 12, 5) == bs.search_bytes(g, n, 32, 12, 5)


@pytest.mark.parametrize("b", [1, 2, 39, 256, 512])
@pytest.mark.parametrize("c,r", [(28, 2), (4, 2), (28, 1)])
def test_b1_counts(b, c, r):
    assert ys.b1_solve_bytes(b, c, r) == bc.solve_bytes(b, c, r)
    assert ys.b1_solve_flops(c, r) == bc.solve_flops(c, r)
    assert ys.b1_refined_solve_flops(c, r) == bc.refined_solve_flops(c, r)


def test_bound_takes_the_larger():
    assert ys.bound_seconds(67e12, 0) == pytest.approx(1.0)
    assert ys.bound_seconds(0, 3.35e12) == pytest.approx(1.0)
