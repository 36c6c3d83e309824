"""Device operations a batch that the program launches: the kernels,
copies and memsets whose launch lies inside a `srt.predict` span
(api/fastpath.predict_scores), over the traced window's batches."""

LAYER = "host"
UNIT = "launches"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(ctx):
    att = ctx.reader("frontend_span_ms").Attribution(ctx.trace)
    n = sum("srt.predict" in att.spans_of(e) for e in ctx.trace.device)
    if not n or not ctx.batches:
        return None
    return n / ctx.batches
