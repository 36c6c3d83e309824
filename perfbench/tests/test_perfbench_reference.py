"""The plain reference against the program's CPU plain path at a tiny size,
the control's reading above the limits where the program's is below them,
and the import rules: nothing the benchmark loads is JAX or the JAX
package (top-level names compared whole), and the reference and the
yardstick load nothing of the program."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import compare, harness, spec, traffic
from perfbench.reference import pipeline

import perfbench_helpers as H

FORBIDDEN = {"jax", "jaxlib", "flax", "speaker_recognition_tpu"}


def _variant(config, **changes):
    cfg = H.load(f"perfbench/configs/{config}.json")
    feats = cfg["features"]
    for key, value in changes.items():
        group, _, field = key.partition("__")
        if field:
            feats[group][field] = value
        else:
            feats[group] = value
    return cfg


VARIANTS = [
    ("tel8k-gmm32-s80", {}),
    ("wb48k-gmm32-s4", {}),
    ("tel8k-gmm32-s80", {"lpc__n_lpcc": 16}),
    ("tel8k-gmm32-s80", {"n_deltas": 1}),
    ("tel8k-gmm32-s80", {"use_lpc": False}),
    ("tel8k-gmm32-s80", {"mfcc__preemph_first": True,
                         "mfcc__f_max": 3800.0}),
    ("wb48k-gmm32-s4", {"lpc__n_lpcc": 12}),
    ("wb48k-gmm32-s4", {"n_deltas": 2}),
]


@pytest.mark.parametrize("config,changes", VARIANTS)
def test_reference_matches_the_program_on_the_cpu(config, changes):
    from speaker_recognition_tpu_torch.api import fastpath
    from speaker_recognition_tpu_torch.features import extract
    from speaker_recognition_tpu_torch.models.gmm import GmmBank
    cfg = _variant(config, **changes)
    dev = torch.device("cpu")
    fs, feats = cfg["fs"], cfg["features"]
    lpc = feats["lpc"]
    cfg["bank"]["dim"] = (feats["mfcc"]["n_ceps"]
                          + (0 if not feats["use_lpc"]
                             else lpc["n_lpcc"] - 1 if lpc["n_lpcc"]
                             else lpc["n_lpc"])) * (1 + feats["n_deltas"])
    cfg["bank"]["speakers"] = 3
    mix = H.load("perfbench/mixes/ragged.json")
    mix.update(batch=5, pool=1)
    mix["lengths"] = {"kind": "mix", "seconds": [0.3, 0.8, 1.5],
                      "shares": [2, 2, 1]}
    seed = 2 ** 31 + 17
    params = harness.bank_params(cfg, seed, dev)
    batch = traffic.make_pool(mix, fs, seed, dev)[0]
    fcfg = harness.feature_config(feats)
    fe = pipeline.Frontend(fs, feats, dev)
    feat, mask = fe(batch.signals, batch.lengths.long())
    pf, pm = extract.extract_batch(batch.signals, batch.lengths, fs, fcfg)
    T = min(feat.shape[1], pf.shape[1])
    assert torch.equal(mask[:, :T], pm[:, :T])
    assert not pm[:, T:].any() and not mask[:, T:].any()
    # float32 sums in other orders, and the program's Wiener-Khinchin
    # autocorrelation against the reference's time-domain one: 5e-4 of
    # features of O(1) (LPC cepstra of noise reach O(1e3))
    torch.testing.assert_close(feat[:, :T], pf[:, :T], rtol=5e-4, atol=5e-4)
    bank = GmmBank.from_numpy(params["weights"], params["means"],
                              params["sigmas"], device=dev)
    prog = fastpath.predict_scores(batch.signals, batch.lengths, bank, fs,
                                   fcfg).numpy()
    ref = pipeline.scores(batch.signals, batch.lengths, fe,
                          pipeline.Bank(params["weights"], params["means"],
                                        params["sigmas"], dev)).numpy()
    np.testing.assert_allclose(prog, ref, rtol=1e-5, atol=5e-4)


def test_the_control_fails_where_the_program_passes():
    """At the cells' own features and limits, on a small bank and short
    utterances on the CPU (TF32 products emulated by rounding their
    operands): the program reads under the limit, the control over it."""
    cell = spec.cell("tel8k-s80.fixed5s")
    cfg = dict(cell.config, bank=dict(cell.config["bank"], speakers=6))
    mix = dict(cell.mix, batch=8, pool=2,
               lengths={"kind": "fixed", "seconds": 1.0})
    dev = torch.device("cpu")
    for seed in (1, 2 ** 31 + 3, 5 * 10 ** 9):
        params = harness.bank_params(cfg, seed, dev)
        pool = traffic.make_pool(mix, cfg["fs"], seed, dev)
        ref = compare.reference_scores(cfg, pool, params, dev)
        ctl = compare.reference_scores(cfg, pool, params, dev, tf32=True)
        r = compare.readings(cfg, pool, params, dict(enumerate(ctl)),
                             {p: c.argmax(axis=1)[None]
                              for p, c in enumerate(ctl)}, dev,
                             reference=ref)
        assert r["score_err"] > cell.limits["score_err"], r


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -3.0000001])
    got = pipeline.round_tf32(x)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -3.0]


def _loaded(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=H.ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted(sys.modules)))"],
        capture_output=True, text=True, cwd=H.ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(out.stdout.split())


def test_nothing_the_benchmark_loads_is_jax():
    mods = _loaded(
        "import perfbench.run, perfbench.harness, perfbench.compare\n"
        "import perfbench.calibrate, perfbench.faults\n"
        "from perfbench import spec\n"
        "for m in spec.benchmark()['per_layer']:\n"
        "    spec.metric_reader(m['name'])\n"
        "import speaker_recognition_tpu_torch.api.fastpath\n"
        "from speaker_recognition_tpu_torch import _build\n")
    assert "speaker_recognition_tpu_torch" in mods
    assert not {m for m in mods if m.split(".")[0] in FORBIDDEN}
    assert harness.forbidden_modules() == sorted(
        m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def test_the_reference_and_yardstick_load_nothing_of_the_program():
    mods = _loaded("import perfbench.reference.pipeline\n"
                   "import perfbench.yardstick.counts\n"
                   "import perfbench.compare, perfbench.traffic\n")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & (FORBIDDEN | {"speaker_recognition_tpu_torch"})
    for sub in ("reference", "yardstick"):
        for name in os.listdir(os.path.join(H.ROOT, "perfbench", sub)):
            if name.endswith(".py"):
                with open(os.path.join(H.ROOT, "perfbench", sub, name)) as f:
                    src = f.read()
                assert "import speaker_recognition" not in src
                assert "from speaker_recognition" not in src


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "speaker_recognition_tpu_torch_x",
                        object())
    assert "jaxtyping_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax.numpy" in harness.forbidden_modules()
