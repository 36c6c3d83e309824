"""The share of the frames the scoring kernel computes that are padding:
100 * (1 - valid frames a batch / frames scored a call). The frames scored
come from the program's counters, ops/gpu_gmm.SCORED_FRAMES over
SCORED_CALLS (B * T a batch_scores call, over every call of the run: the
warm-up, the untraced pass and the window); the valid frames from the
yardstick's count over the pool's lengths
(perfbench/yardstick/counts.valid_frames), the mean over the pool. The
two means meet only where every pool batch has one shape [B, Lp], so that
every call scores the same B * T whichever pool batch it takes: a pool
whose batches differ in shape reads nothing."""

import sys

LAYER = "predict step"
UNIT = "%"
BETTER = "lower"
MOVES = "audio_s_per_s"

PROGRAM = "speaker_recognition_tpu_torch.ops.gpu_gmm"


def read(ctx):
    from perfbench.yardstick import counts
    gmm = sys.modules.get(PROGRAM)
    calls = getattr(gmm, "SCORED_CALLS", 0)
    frames = getattr(gmm, "SCORED_FRAMES", 0)
    if not calls or not frames or not ctx.pool:
        return None
    if len({tuple(b.signals.shape) for b in ctx.pool}) != 1:
        return None
    cfg = ctx.cell.config
    valid = sum(counts.valid_frames(int(cfg["fs"]), cfg["features"],
                                    b.lengths_np) for b in ctx.pool)
    return 100.0 * (1.0 - valid / len(ctx.pool) / (frames / calls))
