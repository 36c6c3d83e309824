"""The share of the traced window in which no kernel, copy or memset runs
on the card."""

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(ctx):
    window = ctx.trace.window_s
    if window <= 0 or not ctx.trace.device:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / window)
