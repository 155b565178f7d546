"""sorting_ms.*: models/sorting.py: wall ms a frame or step in the staged pass."""

from harness.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "sorting")
