"""speaker_recognition_tpu_torch: config parity with the JAX package, the
shared session artifact, and the port's import and CLI surface."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from speaker_recognition_tpu import config as jcfg  # noqa: E402
from speaker_recognition_tpu.utils import serialization as jser  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.utils import serialization as tser  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = ["MfccConfig", "LpcConfig", "FeatureConfig", "GmmConfig",
           "VadConfig", "SilenceConfig", "PipelineConfig"]


@pytest.mark.parametrize("name", CONFIGS)
def test_default_fields_match(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert ([f.name for f in dataclasses.fields(j)]
            == [f.name for f in dataclasses.fields(t)])
    assert dataclasses.asdict(j) == dataclasses.asdict(t)


@pytest.mark.parametrize("kw", [
    {}, {"use_lpc": False}, {"n_deltas": 2},
    {"lpc": {"n_lpcc": 12}}, {"mfcc": {"n_ceps": 19}}])
def test_feature_dims_match(kw):
    def build(mod):
        k = dict(kw)
        if "lpc" in k:
            k["lpc"] = mod.LpcConfig(**k["lpc"])
        if "mfcc" in k:
            k["mfcc"] = mod.MfccConfig(**k["mfcc"])
        return mod.FeatureConfig(**k)
    j, t = build(jcfg), build(tcfg)
    assert (j.base_dim, j.dim) == (t.base_dim, t.dim)


def test_helpers_match():
    assert dataclasses.asdict(jcfg.bob_mfcc_config(n_ceps=12)) == \
        dataclasses.asdict(tcfg.bob_mfcc_config(n_ceps=12))
    for fs in (8000, 11025, 16000, 44100):
        assert jcfg.frame_geometry(fs, 32.0, 16.0) == \
            tcfg.frame_geometry(fs, 32.0, 16.0)
    for n in (0, 255, 256, 40000):
        assert jcfg.n_frames(n, 256, 128) == tcfg.n_frames(n, 256, 128)
    assert tcfg.PipelineConfig().torch_dtype == torch.float32
    assert tcfg.PipelineConfig(dtype="float64").torch_dtype == torch.float64


def _state(seed=0, S=2, K=4, d=5, ubm=False):
    rng = np.random.RandomState(seed)
    st = {"labels": ["a", "b"][:S], "reject_threshold": 3.5,
          "weights": rng.dirichlet(np.ones(K), size=S).astype(np.float32),
          "means": rng.randn(S, K, d).astype(np.float32),
          "sigmas": (0.5 + rng.rand(S, K, d)).astype(np.float32)}
    if ubm:
        st.update(ubm_weights=st["weights"][0], ubm_means=st["means"][0],
                  ubm_sigmas=st["sigmas"][0])
    return st


def _vad():
    return {"noise_amp": np.arange(6.0), "lambda0": 1.5, "lambda1": 3.0,
            "window_size": 371, "order": 5, "fs": 8000}


@pytest.mark.parametrize("writer,reader", [(jser, tser), (tser, jser)],
                         ids=["jax_to_torch", "torch_to_jax"])
@pytest.mark.parametrize("extras", [False, True], ids=["plain", "ubm_vad"])
def test_session_cross_load(tmp_path, writer, reader, extras):
    wmod = jcfg if writer is jser else tcfg
    rmod = tcfg if writer is jser else jcfg
    cfg = wmod.PipelineConfig(
        features=wmod.FeatureConfig(n_deltas=1),
        gmm=wmod.GmmConfig(n_mixtures=4), reject_threshold=2.5)
    st = _state(ubm=extras)
    path = str(tmp_path / "model.out")
    writer.save_session(path, gmmset_state=st, config=cfg,
                        vad_state=_vad() if extras else None)
    st2, cfg2, vad2 = reader.load_session(path)
    assert isinstance(cfg2, rmod.PipelineConfig)
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(cfg)
    assert st2["labels"] == st["labels"]
    for k in st:
        if k != "labels":
            np.testing.assert_array_equal(st2[k], st[k])
    if extras:
        np.testing.assert_array_equal(vad2["noise_amp"], _vad()["noise_amp"])
        assert vad2["window_size"] == 371
    else:
        assert vad2 is None


def test_port_imports_no_jax():
    code = ("import sys; import speaker_recognition_tpu_torch.cli, "
            "speaker_recognition_tpu_torch.api.interface; "
            "from speaker_recognition_tpu_torch.ops import gpu_frontend, "
            "gpu_gmm; assert 'jax' not in sys.modules, "
            "sorted(m for m in sys.modules if m.startswith('jax'))")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_cli_enroll_is_refused(capsys):
    from speaker_recognition_tpu_torch import cli
    with pytest.raises(SystemExit) as e:
        cli.main(["-t", "enroll", "-i", "x", "-m", "y"])
    assert e.value.code == 1
    assert "enroll is not ported yet" in capsys.readouterr().out
    args = cli.get_args(["-t", "predict", "-i", "a", "-m", "b"])
    assert args.device == "cuda"
