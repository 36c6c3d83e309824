"""The port's spans and frame counter on the CPU: the serving path's
`srt.*` profiler ranges nest in order under torch.profiler, a span is the
module's shared null context while the profiler is off, batch_scores
counts the frames it scores, and utils/profiling.trace writes a Chrome
trace that holds the spans."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from speaker_recognition_tpu_torch.api import fastpath  # noqa: E402
from speaker_recognition_tpu_torch.config import FeatureConfig  # noqa: E402
from speaker_recognition_tpu_torch.features import extract  # noqa: E402
from speaker_recognition_tpu_torch.models.gmm import GmmBank  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_gmm  # noqa: E402
from speaker_recognition_tpu_torch.utils import profiling  # noqa: E402

CFG = FeatureConfig()


def _bank(d, dtype=torch.float32, S=3, K=4, seed=0):
    rng = np.random.default_rng(seed)
    return GmmBank.from_numpy(rng.dirichlet(np.ones(K), S),
                              rng.normal(size=(S, K, d)),
                              0.5 + rng.random((S, K, d)), device="cpu",
                              dtype=dtype)


def _batch(fs, seconds=(1.0, 0.7), seed=1):
    """Two ragged utterances of Gaussian noise, zero-padded to the
    program's length bucket."""
    rng = np.random.default_rng(seed)
    lens = [int(s * fs) for s in seconds]
    lp = -(-max(lens) // extract.LENGTH_BUCKET) * extract.LENGTH_BUCKET
    sig = np.zeros((len(lens), lp), np.float32)
    for i, n in enumerate(lens):
        sig[i, :n] = rng.normal(0.0, 3000.0, n)
    return torch.from_numpy(sig), torch.tensor(lens)


def _dim(fs):
    sig, lens = _batch(fs)
    return extract.extract_batch(sig, lens, fs, CFG)[0].shape[-1]


def _srt_spans(path):
    """The trace's srt.* user_annotation events as (name, start, end),
    in order of start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + e["dur"])
                   for e in events if e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("srt.")),
                  key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("fs", [8000, 48000])
def test_predict_spans_nest_in_order(tmp_path, fs):
    """8 kHz takes the packed route (packed_from_signals), 48 kHz the
    full-spectrum route from the signals (mfcc_from_signals): on each,
    srt.predict holds the frontend's glue, then its kernel's entry point,
    then srt.score."""
    sig, lens = _batch(fs)
    bank = _bank(_dim(fs))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        scores = fastpath.predict_scores(sig, lens, bank, fs, CFG)
    assert scores.shape == (2, 3)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = _srt_spans(path)
    assert [s[0] for s in spans] == [
        "srt.predict", "srt.frontend.glue", "srt.frontend.kernel",
        "srt.score"]
    predict, glue, kernel, score = spans
    for s in (glue, kernel, score):
        assert _inside(s, predict)
    assert glue[2] <= kernel[1] and kernel[2] <= score[1]


def test_a_span_is_the_shared_null_context_while_the_profiler_is_off(
        monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with the profiler "
                             "off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("srt.predict"), profiling.span("srt.score")
    assert a is b is profiling._OFF
    with a:
        pass
    sig, lens = _batch(8000)
    fastpath.predict_scores(sig, lens, _bank(_dim(8000)), 8000, CFG)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batch_scores_counts_the_frames_it_scores(dtype):
    B, T, d = 3, 17, 6
    bank = _bank(d, dtype)
    feats = torch.randn((B, T, d), dtype=dtype)
    mask = torch.arange(T)[None, :] < torch.tensor([17, 9, 0])[:, None]
    calls, frames = gpu_gmm.SCORED_CALLS, gpu_gmm.SCORED_FRAMES
    out = gpu_gmm.batch_scores(bank, feats, mask)
    assert out.shape == (B, 3) and out.dtype == dtype
    assert gpu_gmm.SCORED_CALLS == calls + 1
    assert gpu_gmm.SCORED_FRAMES == frames + B * T
    gpu_gmm.batch_scores(bank, feats[:1, :5].contiguous(), mask[:1, :5])
    assert gpu_gmm.SCORED_CALLS == calls + 2
    assert gpu_gmm.SCORED_FRAMES == frames + B * T + 5


def test_trace_writes_the_programs_spans(tmp_path):
    sig, lens = _batch(8000)
    bank = _bank(_dim(8000))
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as prof:
        fastpath.predict_scores(sig, lens, bank, 8000, CFG)
    assert len(prof.key_averages()) > 0
    names = {s[0] for s in _srt_spans(str(tmp_path / "tr" / "trace.json"))}
    assert names == {"srt.predict", "srt.frontend.glue",
                     "srt.frontend.kernel", "srt.score"}
