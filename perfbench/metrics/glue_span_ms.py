"""Device time of the frontend's glue a batch, by the program's own span:
the small torch kernels launched inside `srt.frontend.glue`
(features/extract: the cast, the frame mask and the valid-frame counts
before the signal kernel; the deltas, CMVN, LPC and masking after it where
a route has them), summed over the traced window and divided by its
batches. The twin of glue_ms, which is what the name lists leave over."""

LAYER = "frontend glue"
UNIT = "ms"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(ctx):
    return ctx.reader("frontend_span_ms").device_ms(ctx, "srt.frontend.glue")
