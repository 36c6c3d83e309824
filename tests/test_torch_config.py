"""speaker_recognition_tpu_torch: config parity with the JAX package, the
shared session artifact, and the port's import and CLI surface."""

import dataclasses
import inspect
import os
import re
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


def _port_files():
    pkg = os.path.join(REPO, "speaker_recognition_tpu_torch")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(pkg):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py with all it imports,
    load without jax and without any module of the JAX package."""
    code = """
import importlib, importlib.util, pkgutil, sys
import speaker_recognition_tpu_torch as pkg
for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(info.name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "speaker_recognition_tpu"))
assert not bad, bad
assert "speaker_recognition_tpu_torch.ops.gpu_predict" in sys.modules
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_JAX_IMPORT = re.compile(
    r"^\s*(import (jax|speaker_recognition_tpu)\b"
    r"|from (jax|speaker_recognition_tpu)[. ])", re.M)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_source_names_no_jax_import(path):
    """No file of the port nor chip_smoke.py imports jax or the JAX
    package (the word boundary keeps speaker_recognition_tpu_torch out)."""
    with open(path) as f:
        hits = [m.group(0).strip() for m in _JAX_IMPORT.finditer(f.read())]
    assert not hits, hits


def _entry_points():
    from speaker_recognition_tpu_torch import vad
    from speaker_recognition_tpu_torch.features import extract
    from speaker_recognition_tpu_torch.gui import server
    from speaker_recognition_tpu_torch.models.gmmset import GMMSet
    from speaker_recognition_tpu_torch.models import jfa
    from speaker_recognition_tpu_torch.tools import jfa_pipeline, plot_gmm, ubm
    from speaker_recognition_tpu_torch.utils import profiling
    from speaker_recognition_tpu_torch.vad import ltsd, noisered
    from speaker_recognition_tpu_torch.models import crbm, neural_net, rbm
    from speaker_recognition_tpu_torch.parallel import (entry, launch, mesh,
                                                        multihost)
    return {"crbm.fit": crbm.fit, "crbm.fit_bank": crbm.fit_bank,
            "crbm.fit_bank_segment": crbm.fit_bank_segment,
            "crbm.init_train_state": crbm.init_train_state,
            "rbm.fit": rbm.fit, "rbm.step_generator": rbm.step_generator,
            "rbm.Dbn.fit": rbm.Dbn.fit,
            "rbm.Dbn.fit_last_layer": rbm.Dbn.fit_last_layer,
            "neural_net.NeuralNet": neural_net.NeuralNet,
            "mesh.make_mesh": mesh.make_mesh,
            "multihost.initialize": multihost.initialize,
            "multihost.scaling_report": multihost.scaling_report,
            "entry.entry": entry.entry,
            "entry.dryrun_multichip": entry.dryrun_multichip,
            "launch.run": launch.run,
            "GMMSet": GMMSet, "GMMSet.from_state": GMMSet.from_state,
            "jfa.hyper_from_numpy": jfa.hyper_from_numpy,
            "jfa_pipeline.collect_session_stats":
                jfa_pipeline.collect_session_stats,
            "jfa_pipeline.train_jfa": jfa_pipeline.train_jfa,
            "jfa_pipeline.load_model": jfa_pipeline.load_model,
            "plot_gmm.plot_gmm_density": plot_gmm.plot_gmm_density,
            "profiling.phase_timer": profiling.phase_timer,
            "profiling.trace": profiling.trace,
            "mix_feature": extract.mix_feature,
            "mfcc_extract": extract.mfcc_extract,
            "lpc_extract": extract.lpc_extract,
            "PackedFrontend": extract.PackedFrontend,
            "FullFrontend": extract.FullFrontend,
            "train_ubm": ubm.train_ubm, "adapt_speakers": ubm.adapt_speakers,
            "VAD": vad.VAD, "LtsdVad": ltsd.LtsdVad,
            "noise_profile": ltsd.noise_profile,
            "ltsd_scores": ltsd.ltsd_scores,
            "NoiseReduction": noisered.NoiseReduction,
            "spectral_gate": noisered.spectral_gate,
            "GuiApp": server.GuiApp}


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """Public entry points run on the card unless the caller asks for the
    CPU, as ModelInterface and the CLI do."""
    from speaker_recognition_tpu_torch.api.interface import ModelInterface
    sig = inspect.signature(_entry_points()[name])
    assert sig.parameters["device"].default == "cuda"
    assert inspect.signature(ModelInterface).parameters[
        "device"].default == "cuda"


def test_cli_enroll_is_refused(capsys, tmp_path):
    """Without an input directory enroll exits 1, as the JAX CLI does
    (speaker_recognition_tpu/cli.py:58-60)."""
    from speaker_recognition_tpu_torch import cli
    with pytest.raises(SystemExit) as e:
        cli.main(["-t", "enroll", "-i", str(tmp_path / "x"), "-m",
                  str(tmp_path / "y"), "--device", "cpu"])
    assert e.value.code == 1
    assert "No valid directory found!" in capsys.readouterr().out
    args = cli.get_args(["-t", "predict", "-i", "a", "-m", "b"])
    assert args.device == "cuda"


def _bf16_surface():
    """The bf16 operand modes' arguments and their JAX counterparts:
    {name: (port function, argument, default, JAX function or None)}."""
    from speaker_recognition_tpu.api import fastpath as jfast
    from speaker_recognition_tpu.ops import pallas_frontend, pallas_gmm
    from speaker_recognition_tpu_torch.api import fastpath
    from speaker_recognition_tpu_torch.features import extract
    from speaker_recognition_tpu_torch.ops import gpu_frontend, gpu_gmm
    return {
        "batch_bank_avg_loglik": (gpu_gmm.batch_bank_avg_loglik,
                                  "precision", "f32",
                                  pallas_gmm.batch_bank_avg_loglik),
        "bank_sum_loglik": (gpu_gmm.bank_sum_loglik, "precision", "f32",
                            pallas_gmm.bank_sum_loglik),
        "packed_from_signals": (gpu_frontend.packed_from_signals, "mm_bf16",
                                False, pallas_frontend.packed_from_signals),
        "packed_from_frames": (gpu_frontend.packed_from_frames, "mm_bf16",
                               False, pallas_frontend.packed_from_frames),
        "predict_scores": (fastpath.predict_scores, "mm", "f32",
                           jfast.predict_scores_fn),
        "extract_batch": (extract.extract_batch, "mm", "f32", None),
        "frontend": (extract.frontend, "mm", "f32", None),
        "PackedFrontend": (extract.PackedFrontend, "mm", "f32", None),
        "FullFrontend": (extract.FullFrontend, "mm", "f32", None)}


@pytest.mark.parametrize("name", sorted(_bf16_surface()))
def test_bf16_modes_default_to_the_f32_operands(name):
    """Each bf16 operand mode is an argument that defaults to f32 operands,
    named as in the JAX signature it mirrors; bank_avg_loglik takes none,
    as the JAX package's does not."""
    from speaker_recognition_tpu.ops import pallas_gmm
    from speaker_recognition_tpu_torch.ops import gpu_gmm
    fn, arg, default, jfn = _bf16_surface()[name]
    assert inspect.signature(fn).parameters[arg].default == default
    if jfn is not None:
        assert inspect.signature(jfn).parameters[arg].default == default
    for f in (gpu_gmm.bank_avg_loglik, pallas_gmm.bank_avg_loglik):
        assert "precision" not in inspect.signature(f).parameters


def test_bf16_tile_runs_on_tensor_core_instructions():
    """K1's and K4's mm_bf16 (csrc/frontend_bf16.cu) and K6's bf16 route
    (csrc/predict_fused.cuh) take packed_tile.cuh's tile_sums, which runs
    X = frame . D as mma.sync on bf16 fragments with f32 accumulation (A by
    ldmatrix); the FP32-core bf16 stage (operands rounded as staged, fmaf
    on them) is gone, and no caller selects a precision."""
    csrc = os.path.join(REPO, "speaker_recognition_tpu_torch", "csrc")
    with open(os.path.join(csrc, "packed_tile.cuh")) as f:
        tile = f.read()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in tile
    assert "ldmatrix.sync.aligned.m8n8.x4.shared.b16" in tile
    for gone in ("staged<", "bool BF16", "fma4(", "KT * CC"):
        assert gone not in tile, gone
    callers = {}
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name)) as f:
            code = re.sub(r"//[^\n]*", "", f.read())
        calls = re.findall(r"(?<!rfft::)\btile_sums<([^>]*)>", code)
        if calls and name != "packed_tile.cuh":
            callers[name] = calls
    assert callers == {"frontend_bf16.cu": ["FT, OPL, GSEG"],
                       "predict_fused.cuh": ["FT, OPL, GSEG"]}


@pytest.mark.parametrize("source", ["gmm_score_bf16.cu",
                                    "gmm_serial_bf16.cu"])
def test_bf16_scoring_runs_on_tensor_core_instructions(source):
    """K2's and K3's bf16 kernels take csrc/gmm_mma.cuh's inner loop,
    which issues mma.sync on bf16 fragments with f32 accumulation."""
    csrc = os.path.join(REPO, "speaker_recognition_tpu_torch", "csrc")
    with open(os.path.join(csrc, source)) as f:
        assert '#include "gmm_mma.cuh"' in f.read()
    with open(os.path.join(csrc, "gmm_mma.cuh")) as f:
        assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" \
            in f.read()
