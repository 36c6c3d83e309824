"""Device time of the program's other kernels a batch: the small torch
kernels of features/extract (the valid-frame counts and the frame mask)
and whatever else the program launches that is neither a frontend kernel
(frontend_ms) nor a scoring kernel (score_ms). The harness's own kernels
(the labels' argmax, launched in its `argmax` span) are left out."""

LAYER = "frontend glue"
UNIT = "ms"
BETTER = "lower"
MOVES = "audio_s_per_s"


def read(ctx):
    fe = ctx.reader("frontend_ms")
    named = fe.KERNELS | ctx.reader("score_ms").KERNELS
    us = sum(e.dur for e in ctx.trace.kernels
             if fe.base_name(e.name) not in named
             and ctx.trace.launched_in(e) not in ("argmax", "wait"))
    if not us or not ctx.batches:
        return None
    return us / 1e3 / ctx.batches
