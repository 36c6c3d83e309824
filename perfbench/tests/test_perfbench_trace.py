"""The reduction of a Chrome trace to the per-layer metrics, on a trace
written by hand: two batches, each a frontend kernel, a glue kernel and a
scoring kernel launched in the harness's predict span, then its argmax
and a copy."""

import types

import pytest

from perfbench import spec
from perfbench.trace import Trace, short_name


def _x(name, ts, dur, cat, corr=None):
    ev = {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _batch(t, corr):
    """One batch from t us: predict span [t, t+50) launching three
    kernels, argmax [t+50, t+60), wait [t+60, t+400)."""
    return [
        _x("perfbench.predict", t, 50, "user_annotation"),
        _x("aten::div", t + 5, 5, "cpu_op"),
        _x("cudaLaunchKernel", t + 6, 2, "cuda_runtime", corr),
        _x("cudaLaunchKernel", t + 20, 2, "cuda_runtime", corr + 1),
        _x("cudaLaunchKernel", t + 40, 2, "cuda_runtime", corr + 2),
        _x("perfbench.argmax", t + 50, 10, "user_annotation"),
        _x("cudaLaunchKernel", t + 52, 2, "cuda_runtime", corr + 3),
        _x("perfbench.wait", t + 60, 340, "user_annotation"),
        _x("cudaMemcpyAsync", t + 61, 330, "cuda_runtime", corr + 4),
        _x("void at::native::vectorized_elementwise_kernel<4>(int)",
           t + 10, 10, "kernel", corr),
        _x("void packed_frontend_kernel<512, 9>(float const*, int)",
           t + 20, 100, "kernel", corr + 1),
        _x("void bank_score_kernel<2>(float const*)", t + 120, 200,
           "kernel", corr + 2),
        _x("void at::native::reduce_kernel<512, 1, ArgMaxOps>(int)",
           t + 320, 20, "kernel", corr + 3),
        _x("Memcpy DtoH (Device -> Pageable)", t + 340, 10, "gpu_memcpy",
           corr + 4),
    ]


@pytest.fixture
def ctx():
    trace = Trace({"traceEvents": _batch(1000.0, 1) + _batch(1400.0, 11)})
    c = types.SimpleNamespace(trace=trace, batches=2, host_s=[4e-5, 6e-5],
                              least={"frontend": 50e-6, "score": 20e-6,
                                     "predict": 40e-6})
    c.reader = lambda n: spec.metric_reader(n)
    c.metric = lambda n: spec.metric_reader(n).read(c)
    return c


def test_window_busy_and_gaps(ctx):
    tr = ctx.trace
    assert tr.t0 == 1000.0 and tr.t1 == 1800.0
    assert tr.window_s == pytest.approx(800e-6)
    # each batch keeps the device busy over [t+10, t+350)
    assert tr.busy_s == pytest.approx(2 * 340e-6)
    gaps = dict()
    for what, s in tr.idle_gaps():
        gaps[what] = gaps.get(what, 0.0) + s
    assert sum(gaps.values()) == pytest.approx(120e-6)
    assert gaps["perfbench.predict > aten::div"] == pytest.approx(10e-6)
    assert gaps["perfbench.wait > cudaMemcpyAsync"] == pytest.approx(110e-6)
    k = {short_name(e.name): tr.launched_in(e) for e in tr.kernels}
    assert k["packed_frontend_kernel<512, 9>"] == "predict"
    assert k["at::native::reduce_kernel<512, 1, ArgMaxOps>"] == "argmax"


def test_breakdown(ctx):
    b = ctx.trace.breakdown()
    assert b["device_ops"][0] == ["bank_score_kernel<2>",
                                  pytest.approx(400e-6)]
    assert len(b["device_ops"]) == 5 and len(b["idle_gaps"]) <= 10
    assert b["idle_gaps"][0][0] == "perfbench.wait > cudaMemcpyAsync"


def test_readers(ctx):
    read = {n: spec.metric_reader(n).read(ctx) for n in (
        "host_enqueue_ms", "frontend_ms", "score_ms", "glue_ms",
        "frontend_roofline", "score_roofline", "device_idle_pct",
        "predict_mfu")}
    assert read["host_enqueue_ms"] == pytest.approx(0.05)
    assert read["frontend_ms"] == pytest.approx(0.1)
    assert read["score_ms"] == pytest.approx(0.2)
    assert read["glue_ms"] == pytest.approx(0.01)      # not the argmax
    assert read["frontend_roofline"] == pytest.approx(50.0)
    assert read["score_roofline"] == pytest.approx(10.0)
    assert read["device_idle_pct"] == pytest.approx(15.0)
    assert read["predict_mfu"] == pytest.approx(10.0)


def test_readers_find_nothing_and_return_nothing():
    empty = Trace({"traceEvents": [_x("perfbench.predict", 0, 5,
                                      "user_annotation")]})
    c = types.SimpleNamespace(trace=empty, batches=1, host_s=[],
                              least={"frontend": 1.0, "score": 1.0,
                                     "predict": 1.0})
    c.reader = lambda n: spec.metric_reader(n)
    c.metric = lambda n: spec.metric_reader(n).read(c)
    for n in ("host_enqueue_ms", "frontend_ms", "score_ms", "glue_ms",
              "frontend_roofline", "score_roofline", "device_idle_pct"):
        assert spec.metric_reader(n).read(c) is None, n
