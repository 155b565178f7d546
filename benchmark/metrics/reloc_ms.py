"""reloc_ms.*: models/relocalization.py: wall ms a frame in the staged pass."""

from harness.readers import stage_ms


def read(ctx):
    return stage_ms(ctx, "reloc")
