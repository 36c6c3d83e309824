"""The frontend's share of its roofline: the yardstick's least time of a
batch's frontend work (perfbench/yardstick/counts.frontend_work) over
frontend_ms."""

LAYER = "frontend"
UNIT = "%"
BETTER = "higher"
MOVES = "audio_s_per_s"


def read(ctx):
    ms = ctx.metric("frontend_ms")
    if not ms:
        return None
    return 100.0 * ctx.least["frontend"] / (ms * 1e-3)
