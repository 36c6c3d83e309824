"""The frozen yardstick: hand counts at a tiny shape, the least time's rule,
shares that stay at or under 100% when a kernel takes its bound, and
chip_smoke.py's figures reproduced where the two rules agree (the float32
terms and the projection's count)."""

import types

import numpy as np
import pytest

from perfbench import spec
from perfbench.reference import operators
from perfbench.yardstick import counts, peaks

import perfbench_helpers as H

TINY = {"mfcc": {"win_length_ms": 4.0, "win_shift_ms": 2.0, "fft_size": 64,
                 "n_filters": 4, "n_ceps": 3, "pre_emph": 0.95,
                 "power_floor": 1e-100, "cmvn": True, "f_min": 0.0,
                 "f_max": None, "mel_scale": True, "preemph_first": False},
        "lpc": {"win_length_ms": 4.0, "win_shift_ms": 2.0, "n_lpc": 2,
                "pre_emph": 0.95, "n_lpcc": 0},
        "use_lpc": True, "n_deltas": 0}


def test_least_fft_size():
    assert counts.least_fft_size(256, 2048) == 512     # 8 kHz, packed
    assert counts.least_fft_size(1536, 2048) == 2048   # 48 kHz, folded
    assert counts.least_fft_size(300, 2048) == 1024
    assert counts.least_fft_size(32, 64) == 64


def test_hand_counts_at_a_tiny_shape():
    # 8 kHz, 4 ms frames of 32 samples every 16: lengths 64 and 40 hold 3
    # and 1 frames; N = 64
    lengths = [64, 40]
    assert counts.valid_frames(8000, TINY, lengths) == 4
    mel = operators.mel_filterbank(8000, 64, 4)
    nnz = int((mel != 0).sum()) + 33 * 3      # the cosine lags are dense
    assert counts.projection_nonzeros(8000, TINY) == nnz
    per_frame = (3 * 32 + 2.5 * 64 * 6 + 3 * 33 + 4 + 2 * 4 * 3
                 + 2 * 2 * 2)
    assert per_frame == 1191
    w = counts.frontend_work(8000, TINY, lengths)
    assert w.fp32_flops == 4 * 1191
    assert w.tf32_flops == 3 * 2 * nnz * 4
    assert w.nbytes == 4 * 104 + 4 * 4 * 5 + 4 * (nnz + 12)
    s = counts.score_work(4, 5, 3, 2, 2)
    assert s.fp32_flops == 0
    assert s.tf32_flops == 3 * 4 * 5 * 6 * 4
    assert s.nbytes == 4 * 4 * 5 + 4 + 4 * 6 * 11 + 4 * 2 * 3
    p = counts.predict_work(8000, TINY, lengths, 3, 2)
    assert p.fp32_flops == w.fp32_flops
    assert p.tf32_flops == w.tf32_flops + 3 * 4 * 5 * 6 * 4
    assert p.nbytes == 4 * 104 + 4 * (nnz + 12) + 4 * 6 * 11 + 4 * 2 * 3


def test_least_time_is_the_largest_term():
    w = counts.Work(67e9, 990e9, 1e9)
    t = w.terms()
    assert t["fp32"] == pytest.approx(1e-3)
    assert t["tf32"] == pytest.approx(2e-3)
    assert t["bytes"] == pytest.approx(1e9 / peaks.HBM_BYTES_S)
    assert w.least_s() == max(t.values()) == t["tf32"]


def _ctx(least, frontend_us, score_us, batches=10, window_s=None):
    names = ["void packed_frontend_kernel<512, 9>(float const*)",
             "void bank_score_kernel<2>(float const*)"]
    kernels = [types.SimpleNamespace(name=n, dur=d, start=0.0)
               for n, d in zip(names, (frontend_us, score_us))]
    trace = types.SimpleNamespace(
        kernels=kernels, device=kernels, busy_s=0.0,
        window_s=window_s if window_s is not None else batches * 1.0,
        launched_in=lambda e: None)
    ctx = types.SimpleNamespace(trace=trace, batches=batches, least=least,
                                host_s=[])
    ctx.reader = lambda n: spec.metric_reader(n)
    ctx.metric = lambda n: spec.metric_reader(n).read(ctx)
    return ctx


@pytest.mark.parametrize("cell", ["tel8k-s80.fixed5s", "wb48k-s4.fixed5s",
                                  "tel8k-s80.ragged", "wb48k-s4.ragged"])
def test_shares_stay_within_100_at_the_bound(cell):
    """A kernel that takes exactly its least time reads 100%, and no more."""
    c = spec.cell(cell)
    from perfbench import traffic
    fs = int(c.config["fs"])
    lens = np.round(traffic.seconds(c.mix) * fs).astype(np.int64)
    b, feats = c.config["bank"], c.config["features"]
    least = {"frontend": counts.frontend_work(fs, feats, lens).least_s(),
             "score": counts.score_work(
                 counts.valid_frames(fs, feats, lens), b["dim"],
                 b["speakers"], b["components"], len(lens)).least_s(),
             "predict": counts.predict_work(fs, feats, lens, b["speakers"],
                                            b["components"]).least_s()}
    batches = 10
    ctx = _ctx(least, least["frontend"] * 1e6 * batches,
               least["score"] * 1e6 * batches, batches,
               window_s=least["predict"] * batches)
    for name in ("frontend_roofline", "score_roofline", "predict_mfu"):
        share = spec.metric_reader(name).read(ctx)
        assert share == pytest.approx(100.0, rel=1e-9)
        assert share <= 100.0 + 1e-9
    # the whole step's least time bounds the sum of its parts' work
    assert least["predict"] <= least["frontend"] + least["score"] + 1e-12


@pytest.mark.parametrize("config,route", [("tel8k-gmm32-s80", "packed"),
                                          ("wb48k-gmm32-s4", "full")])
def test_chip_smoke_figures_reproduced(config, route):
    """Where the rules agree: the float32 FLOPs of the frontend (window,
    FFT, power, log, DCT, Levinson) and its float32 bound, the projection's
    count, and the scoring's FLOPs."""
    import chip_smoke
    from speaker_recognition_tpu_torch import config as port_config
    from speaker_recognition_tpu_torch.features import extract
    from perfbench import harness

    cfg = H.load(f"perfbench/configs/{config}.json")
    fs, feats = cfg["fs"], cfg["features"]
    fe = extract.frontend(fs, harness.feature_config(feats), "cpu")
    assert type(fe).__name__ == {"packed": "PackedFrontend",
                                 "full": "FullFrontend"}[route]
    ops = ((fe.fft_mel, fe.fft_acorr) if route == "packed"
           else (fe.mel, fe.acorr))
    lengths = [40000, 23456, 8000]
    frames = counts.valid_frames(fs, feats, lengths)
    assert frames == sum(port_config.n_frames(n, fe.frame_len,
                                              fe.frame_shift)
                         for n in lengths)
    assert fe.n_fft == counts.least_fft_size(fe.frame_len,
                                             feats["mfcc"]["fft_size"])
    proj = chip_smoke.projection_flops(frames, fe.n_fft, ops)
    fp32 = chip_smoke.frontend_flops(
        frames, fe.n_fft, ops, feats["mfcc"]["n_ceps"],
        order=feats["lpc"]["n_lpc"], window=3 * fe.frame_len) - proj
    w = counts.frontend_work(fs, feats, lengths)
    assert w.fp32_flops == pytest.approx(fp32, rel=1e-12)
    assert w.tf32_flops == 3 * proj
    assert chip_smoke.bound(fp32, 0.0)["bound_ms"] == pytest.approx(
        w.terms()["fp32"] * 1e3, rel=1e-12)
    b = cfg["bank"]
    assert counts.score_work(frames, b["dim"], b["speakers"],
                             b["components"], 3).tf32_flops == (
        3 * chip_smoke.score_flops(frames, b["dim"],
                                   b["speakers"] * b["components"]))
    assert peaks.FP32_FLOPS == chip_smoke.FP32_FLOPS
    assert peaks.TF32_FLOPS == chip_smoke.TF32_FLOPS
    assert peaks.HBM_BYTES_S == chip_smoke.HBM_BYTES_S
