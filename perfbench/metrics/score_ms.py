"""Device time of the bank-scoring kernels a batch: ops/gpu_gmm's batched
kernel csrc/gmm_score.cu (K2: bank_score_kernel, then bank_mean_kernel),
summed over the traced window and divided by its batches."""

LAYER = "scoring"
UNIT = "ms"
BETTER = "lower"
MOVES = "audio_s_per_s"

KERNELS = frozenset({"bank_score_kernel", "bank_mean_kernel",
                     "bank_score_bf16_kernel"})


def read(ctx):
    base = ctx.reader("frontend_ms").base_name
    us = sum(e.dur for e in ctx.trace.kernels if base(e.name) in KERNELS)
    if not us or not ctx.batches:
        return None
    return us / 1e3 / ctx.batches
