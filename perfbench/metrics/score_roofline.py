"""The scoring's share of its roofline: the yardstick's least time of a
batch's scoring work (perfbench/yardstick/counts.score_work) over
score_ms."""

LAYER = "scoring"
UNIT = "%"
BETTER = "higher"
MOVES = "audio_s_per_s"


def read(ctx):
    ms = ctx.metric("score_ms")
    if not ms:
        return None
    return 100.0 * ctx.least["score"] / (ms * 1e-3)
