"""Host time of one call of the program: the host clock from the call of
fastpath.predict_scores to its return (its enqueue, since no step of the
timed path waits for the card), the mean over the calls of the untraced
pass that a traced run makes just before its window, so that the
profiler's own cost is not in it."""

LAYER = "host"
UNIT = "ms"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(ctx):
    if not ctx.host_s:
        return None
    return 1e3 * sum(ctx.host_s) / len(ctx.host_s)
