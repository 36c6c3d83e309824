"""The whole predict step's share of the card's peak: the yardstick's
least time of one batch end to end (perfbench/yardstick/counts.
predict_work: frontend and scoring, the same rule) over the traced
window's seconds a batch."""

LAYER = "predict step"
UNIT = "%"
BETTER = "higher"
MOVES = "audio_s_per_s"


def read(ctx):
    window = ctx.trace.window_s
    if window <= 0 or not ctx.batches:
        return None
    return 100.0 * ctx.least["predict"] / (window / ctx.batches)
