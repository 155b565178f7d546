"""b2_roofline.*: kernel B2's bound over its device time, in %."""

from harness.readers import roofline


def read(ctx):
    return roofline(ctx, "B2", "beam_search_kernel")
