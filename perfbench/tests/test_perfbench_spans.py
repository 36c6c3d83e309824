"""The readers of the program's spans and frame counter, on a trace written
by hand: two batches, each launched inside the harness's predict span,
whose calls the program marks with its `srt.*` spans (the glue, the
frontend kernel and CMVN, a memset and the scoring kernels), then the
harness's argmax and copy."""

import types

import numpy as np
import pytest

from perfbench import spec
from perfbench.trace import Trace

SPAN_READERS = ("frontend_span_ms", "score_span_ms", "glue_span_ms",
                "launches_per_batch", "host_late_idle_pct")


def _x(name, ts, dur, cat, corr=None):
    ev = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _batch(t, corr, program_spans=True, late_argmax=False,
           stray_glue=False):
    """One batch from t us. Host: predict [t, t+60) holding the program's
    spans, argmax [t+60, t+70), wait [t+70, t+400). Device: the glue
    kernel [t+15, t+20) (launched at t+5), K1 [t+25, t+125) (launched at
    t+16, before the gap it closes begins), CMVN, a memset, K2's two
    kernels, the argmax and the copy back to back to t+355. late_argmax:
    the argmax launched at t+340 from the harness's wait span, and run at
    [t+350, t+360) after a gap. stray_glue: the glue kernel launched at
    t+13, inside srt.predict but between the glue and kernel spans."""
    launch = [13 if stray_glue else 5, 16, 20, 43, 45, 50,
              340 if late_argmax else 62, 71]
    ev = [
        _x("perfbench.predict", t, 60, "user_annotation"),
        _x("perfbench.argmax", t + 60, 10, "user_annotation"),
        _x("perfbench.wait", t + 70, 330, "user_annotation"),
        _x("aten::arange", t + 4, 3, "cpu_op"),
    ]
    if program_spans:
        ev += [
            _x("srt.predict", t + 1, 58, "user_annotation"),
            _x("srt.frontend.glue", t + 3, 9, "user_annotation"),
            _x("srt.frontend.kernel", t + 14, 16, "user_annotation"),
            _x("srt.score", t + 42, 14, "user_annotation"),
        ]
    for i, at in enumerate(launch):
        ev.append(_x("cudaMemcpyAsync" if i == 7 else "cudaLaunchKernel",
                      t + at, 1, "cuda_runtime", corr + i))
    dev = [
        ("void at::native::vectorized_elementwise_kernel<4>(int)", 15, 5,
         "kernel"),
        ("void packed_frontend_kernel<512, 16>(float const*, int)", 25, 100,
         "kernel"),
        ("void cmvn_kernel(float*, int)", 125, 5, "kernel"),
        ("Memset (Device)", 130, 1, "gpu_memset"),
        ("void bank_score_kernel<RegFrames<40>, 2>(float const*)", 131, 199,
         "kernel"),
        ("void bank_mean_kernel(float*)", 330, 5, "kernel"),
        ("void at::native::reduce_kernel<512, 1, ArgMaxOps>(int)",
         350 if late_argmax else 335, 10, "kernel"),
        ("Memcpy DtoH (Device -> Pinned)", 360 if late_argmax else 345, 10,
         "gpu_memcpy"),
    ]
    ev += [_x(name, t + at, dur, cat, corr + i)
           for i, (name, at, dur, cat) in enumerate(dev)]
    return ev


def _pool_batch(lengths, lp=40960):
    """A pool batch as the reader sees it: its lengths and the shape of its
    zero-padded signals."""
    return types.SimpleNamespace(
        lengths_np=lengths,
        signals=types.SimpleNamespace(shape=(len(lengths), lp)))


def _ctx(trace, pool=(), config=None):
    c = types.SimpleNamespace(trace=trace, batches=2, pool=list(pool),
                              cell=types.SimpleNamespace(config=config))
    c.reader = lambda n: spec.metric_reader(n)
    c.metric = lambda n: spec.metric_reader(n).read(c)
    return c


@pytest.fixture
def ctx():
    return _ctx(Trace({"traceEvents": _batch(1000.0, 1)
                       + _batch(1400.0, 11)}))


def test_attribution_by_the_innermost_program_span(ctx):
    att = spec.metric_reader("frontend_span_ms").Attribution(ctx.trace)
    by_op = {e.name.split("<")[0].split("(")[0].strip(): att.spans_of(e)
             for e in ctx.trace.device if e.start < 1400}
    assert by_op["void packed_frontend_kernel"] == [
        "srt.frontend.kernel", "srt.predict"]
    assert by_op["void at::native::vectorized_elementwise_kernel"] == [
        "srt.frontend.glue", "srt.predict"]
    assert by_op["Memset"] == ["srt.score", "srt.predict"]
    assert by_op["void at::native::reduce_kernel"] == []
    assert by_op["Memcpy DtoH"] == []


def test_span_readers_agree_with_their_name_matched_twins(ctx):
    read = {n: spec.metric_reader(n).read(ctx) for n in SPAN_READERS + (
        "frontend_ms", "score_ms", "glue_ms")}
    assert read["frontend_span_ms"] == pytest.approx(0.105)
    assert read["score_span_ms"] == pytest.approx(0.204)   # not the memset
    assert read["glue_span_ms"] == pytest.approx(0.005)    # not the argmax
    for span, twin in (("frontend_span_ms", "frontend_ms"),
                       ("score_span_ms", "score_ms"),
                       ("glue_span_ms", "glue_ms")):
        assert read[span] == pytest.approx(read[twin])
    # six device operations a call inside srt.predict; the argmax and the
    # copy are the harness's
    assert read["launches_per_batch"] == pytest.approx(6.0)


def test_a_kernel_outside_the_stage_spans_silences_the_span_readers():
    """The second batch's glue kernel launched inside srt.predict but in no
    stage span: the three span readers read nothing rather than drop its
    time, while the launch count still holds it."""
    c = _ctx(Trace({"traceEvents": _batch(1000.0, 1)
                    + _batch(1400.0, 11, stray_glue=True)}))
    fe = spec.metric_reader("frontend_span_ms")
    stray = fe.unattributed(fe.Attribution(c.trace), c.trace.kernels)
    assert [e.start for e in stray] == [1415.0]
    for n in ("frontend_span_ms", "score_span_ms", "glue_span_ms"):
        assert spec.metric_reader(n).read(c) is None, n
    assert spec.metric_reader("frontend_ms").read(c) == pytest.approx(0.105)
    assert spec.metric_reader("launches_per_batch").read(c) == \
        pytest.approx(6.0)


def test_host_late_idle_counts_late_launches_not_bubbles(ctx):
    """Gaps: [1000, 1015) closed by the glue kernel launched at 1005, after
    the gap began (late, 15 us); [1020, 1025) closed by K1, queued at 1016
    (a bubble); [1355, 1415) closed by the next glue kernel, launched at
    1405 (late, 60 us); [1420, 1425) a bubble; [1755, 1800) closes with the
    window. 75 us of the 800 us window."""
    late = spec.metric_reader("host_late_idle_pct")
    assert late.by_span(ctx) == {"srt.frontend.glue": pytest.approx(75e-6)}
    assert late.read(ctx) == pytest.approx(100.0 * 75 / 800)
    assert spec.metric_reader("device_idle_pct").read(ctx) == pytest.approx(
        100.0 * (15 + 5 + 60 + 5 + 45) / 800)


def test_a_late_launch_outside_the_program_spans_does_not_count():
    """The first batch's argmax launched after its gap [1335, 1350) began,
    from the harness's wait span: the device idled, but not for the
    program."""
    c = _ctx(Trace({"traceEvents": _batch(1000.0, 1, late_argmax=True)
                    + _batch(1400.0, 11)}))
    late = spec.metric_reader("host_late_idle_pct")
    assert late.by_span(c) == {"srt.frontend.glue": pytest.approx(
        (15 + 45) * 1e-6)}
    assert spec.metric_reader("device_idle_pct").read(c) == pytest.approx(
        100.0 * (15 + 5 + 15 + 45 + 5 + 45) / 800)


def test_padded_frame_pct_reads_the_programs_counter(monkeypatch):
    gmm = pytest.importorskip("speaker_recognition_tpu_torch.ops.gpu_gmm")
    config = spec.cell("tel8k-s80.fixed5s").config
    pool = [_pool_batch(np.full(512, 40000)) for _ in range(3)]
    c = _ctx(Trace({"traceEvents": _batch(1000.0, 1)}), pool, config)
    reader = spec.metric_reader("padded_frame_pct")
    # 5 s at 8 kHz padded to 40960 samples: 311 of 319 frames valid
    monkeypatch.setattr(gmm, "SCORED_CALLS", 7)
    monkeypatch.setattr(gmm, "SCORED_FRAMES", 7 * 512 * 319)
    assert reader.read(c) == pytest.approx(100.0 * (1 - 311 / 319))
    # the ragged pool: half 3 s (186 frames), half 5 s, padded alike
    c.pool = [_pool_batch(np.repeat([24000, 40000], 256))] * 3
    assert reader.read(c) == pytest.approx(100.0 * (1 - 248.5 / 319))
    # a pool batch padded to another length: the two means would not meet
    c.pool = c.pool[:2] + [_pool_batch(np.full(512, 24000), lp=28672)]
    assert reader.read(c) is None
    monkeypatch.setattr(gmm, "SCORED_CALLS", 0)
    c.pool = pool
    assert reader.read(c) is None


def test_readers_return_nothing_without_the_programs_spans(monkeypatch):
    """A program without the spans or the counter (the parent of the
    change that adds them): every new reader returns None, none raises."""
    c = _ctx(Trace({"traceEvents": _batch(1000.0, 1, program_spans=False)
                    + _batch(1400.0, 11, program_spans=False)}))
    for n in SPAN_READERS:
        assert spec.metric_reader(n).read(c) is None, n
    gmm = pytest.importorskip("speaker_recognition_tpu_torch.ops.gpu_gmm")
    monkeypatch.delattr(gmm, "SCORED_CALLS")
    monkeypatch.delattr(gmm, "SCORED_FRAMES")
    c.pool = [_pool_batch(np.full(4, 40000))]
    c.cell.config = spec.cell("tel8k-s80.fixed5s").config
    assert spec.metric_reader("padded_frame_pct").read(c) is None
