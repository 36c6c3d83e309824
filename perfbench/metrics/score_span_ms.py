"""Device time of the scoring kernels a batch, by the program's own span:
the kernels launched inside `srt.score` (ops/gpu_gmm.batch_scores: K2's
bank_score_kernel and bank_mean_kernel), summed over the traced window and
divided by its batches. The twin of score_ms, which matches kernel
names."""

LAYER = "scoring"
UNIT = "ms"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(ctx):
    return ctx.reader("frontend_span_ms").device_ms(ctx, "srt.score")
