"""device_idle_pct.*: 100 * (1 - busy / window) of the traced window."""


def read(ctx):
    t = ctx["trace"]
    return 100.0 * (1.0 - t.busy_s / t.window_s)
