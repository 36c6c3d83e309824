"""The port's copies of the JAX package's numpy-only utilities and its
tools on torch, against the JAX package's on the same inputs: the JFA text
formats (feature text, .lst manifests), the evaluation metrics, the svm
data format, the profiling helpers and the GMM plots."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from speaker_recognition_tpu.utils import datamanip as jdm  # noqa: E402
from speaker_recognition_tpu.utils import metrics as jmetrics  # noqa: E402
from speaker_recognition_tpu.utils import serialization as jser  # noqa: E402
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.utils import datamanip as tdm  # noqa: E402
from speaker_recognition_tpu_torch.utils import metrics as tmetrics  # noqa: E402,E501
from speaker_recognition_tpu_torch.utils import profiling  # noqa: E402
from speaker_recognition_tpu_torch.utils import serialization as tser  # noqa: E402,E501


def test_feature_text_is_the_jax_packages_byte_for_byte(tmp_path):
    feat = np.random.RandomState(0).randn(7, 5) * 10
    tser.write_feature_text(str(tmp_path / "port"), feat)
    jser.write_feature_text(str(tmp_path / "jax"), feat)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()
    np.testing.assert_array_equal(tser.read_feature_text(str(tmp_path / "jax")),
                                  feat)
    one = tmp_path / "one"
    tser.write_feature_text(str(one), feat[:1])
    assert tser.read_feature_text(str(one)).shape == (1, 5)


def test_lst_manifests_both_ways(tmp_path):
    pairs = [("alice", "/d/a 1.txt"), ("bob", "x=y"), ("alice", "rel/p")]
    tser.write_lst(str(tmp_path / "port.lst"), pairs)
    jser.write_lst(str(tmp_path / "jax.lst"), pairs)
    assert ((tmp_path / "port.lst").read_bytes()
            == (tmp_path / "jax.lst").read_bytes())
    assert tser.read_lst(str(tmp_path / "jax.lst")) == pairs
    assert jser.read_lst(str(tmp_path / "port.lst")) == pairs
    (tmp_path / "bad.lst").write_text("alice\n")
    with pytest.raises(ValueError, match="no '='"):
        tser.read_lst(str(tmp_path / "bad.lst"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_the_jax_packages(seed):
    rng = np.random.RandomState(seed)
    g = rng.randn(40) + 1.5
    i = rng.randn(200)
    for a, b in zip(tmetrics.det_points(g, i), jmetrics.det_points(g, i)):
        np.testing.assert_array_equal(a, b)
    assert tmetrics.eer(g, i) == jmetrics.eer(g, i)
    pred = list(rng.randint(0, 3, 30))
    truth = list(rng.randint(0, 3, 30))
    assert tmetrics.accuracy(pred, truth) == jmetrics.accuracy(pred, truth)
    assert tmetrics.eer([2.0, 3.0], [0.0, 1.0])[0] == 0.0


def test_svm_format_is_the_jax_packages(tmp_path):
    rng = np.random.RandomState(3)
    X = rng.randn(6, 5) * (rng.rand(6, 5) > 0.4)
    y = np.array([1, 0, 2, 1, 0, 3])
    tdm.write_svm_data(str(tmp_path / "port.svm"), X, y)
    jdm.write_svm_data(str(tmp_path / "jax.svm"), X, y)
    assert ((tmp_path / "port.svm").read_bytes()
            == (tmp_path / "jax.svm").read_bytes())
    for a, b in zip(tdm.read_svm_data(str(tmp_path / "jax.svm"), dim=5),
                    jdm.read_svm_data(str(tmp_path / "jax.svm"), dim=5)):
        np.testing.assert_array_equal(a, b)


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.trace(str(tmp_path / "tr"), device="cpu") as prof:
        torch.randn(32, 32) @ torch.randn(32, 32)
    assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
    assert len(prof.key_averages()) > 0


def _model(tmp_path, d=4, K=3):
    rng = np.random.RandomState(0)
    params = tgmm.GmmParams(rng.dirichlet(np.ones(K)), rng.randn(K, d) * 2,
                            0.5 + rng.rand(K, d))
    path = str(tmp_path / "model.txt")
    with open(path, "w") as f:
        tser.dump_reference_gmm(params, f)
    return params, path


def test_plot_gmm_renders(tmp_path):
    """tools/plot_gmm on the CPU, as tests/test_plot_gmm.py drives the JAX
    package's (matplotlib is imported where a plot is drawn: the card's
    machine has none)."""
    pytest.importorskip("matplotlib")
    from speaker_recognition_tpu_torch.tools import plot_gmm

    params, model_path = _model(tmp_path)
    rng = np.random.RandomState(1)
    comp = rng.choice(3, size=200, p=params.weights / params.weights.sum())
    pts = params.means[comp] + params.sigmas[comp] * rng.randn(200, 4)
    data_path = str(tmp_path / "data.txt")
    np.savetxt(data_path, pts)
    for data, dims, out in ((data_path, (0, 1), "gmm.pdf"),
                            (None, (1, 2), "gmm2.pdf")):
        plot_gmm.plot_gmm_density(model_path, data, dims=dims, grid=40,
                                  out=str(tmp_path / out), device="cpu")
        assert os.path.getsize(tmp_path / out) > 1000
    xy = str(tmp_path / "xy.txt")
    np.savetxt(xy, np.stack([np.arange(30.0), np.sin(np.arange(30.0))], 1))
    plot_gmm.main(["points", "-i", xy, "-o", str(tmp_path / "p.pdf"),
                   "--annotate-maximum", "--annotate-minimum"])
    xyz = str(tmp_path / "xyz.txt")
    np.savetxt(xyz, rng.randn(20, 3))
    plot_gmm.main(["points3d", "-i", xyz, "-o", str(tmp_path / "p3.pdf")])
    plot_gmm.main(["gmm", "-m", model_path, "-o", str(tmp_path / "g.pdf"),
                   "--grid", "30", "--device", "cpu"])
    for f in ("p.pdf", "p3.pdf", "g.pdf"):
        assert os.path.getsize(tmp_path / f) > 1000
