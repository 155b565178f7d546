"""b1_roofline.*: kernel B1's bound over its device time, in %."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, "B1", "banded_cholesky_kernel")
