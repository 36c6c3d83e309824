"""speaker_recognition_tpu_torch's JFA (models/jfa.py, tools/jfa_pipeline.py)
against the JAX package's on the same numpy inputs, and against the literal
numpy transcriptions of the reference MATLAB in tests/test_jfa.py
(estimate_{x_and_u,y_and_v,z_and_d}.m, linear_scoring.m); the model npz
and the UBM supervector directory in both directions; the CLI on a tiny
corpus; and the four places where the port does not copy the JAX
package's divergence guard (ROADMAP.md queue 3)."""

import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))

from test_jfa import (expand, oracle_estimate_x, oracle_estimate_y,  # noqa: E402,E501
                      oracle_estimate_z, setup)

from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu.models import jfa as jjfa  # noqa: E402
from speaker_recognition_tpu.tools import jfa_pipeline as jpipe  # noqa: E402
from speaker_recognition_tpu.utils import serialization as jser  # noqa: E402
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.models import jfa as tjfa  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402
from speaker_recognition_tpu_torch.tools import jfa_pipeline as tpipe  # noqa: E402,E501
from speaker_recognition_tpu_torch.utils import serialization as tser  # noqa: E402,E501

# float64 against the float64 transcriptions: tests/test_jfa.py's
# tolerances
RTOL, ATOL = 1e-8, 1e-8


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def _hyper(p, dtype=torch.float64):
    return tjfa.JfaHyper(*(_t(p[f], dtype) for f in "mEvud"))


def _jhyper(p):
    return jjfa.JfaHyper(*(jnp.asarray(p[f]) for f in "mEvud"))


def _ids(p):
    return torch.as_tensor(p["spk_ids"], dtype=torch.int64)


def _close(got, *wants):
    for want in wants:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("which", ["x", "y", "z"])
def test_estimators_match_the_oracle_and_jax(which):
    """estimate_x/y/z and their accumulators at float64 against the MATLAB
    transcriptions and the JAX functions."""
    p = setup(seed={"x": 0, "y": 1, "z": 2}[which])
    F, N, ids, K = _t(p["F"]), _t(p["N"]), _ids(p), p["K"]
    jF, jN, jids = (jnp.asarray(p["F"]), jnp.asarray(p["N"]),
                    jnp.asarray(p["spk_ids"]))
    if which == "x":
        got = tjfa.estimate_x(F, N, _hyper(p), _t(p["y"]), _t(p["z"]), ids,
                              K)
        ref = oracle_estimate_x(p)
        want = jjfa.estimate_x(jF, jN, _jhyper(p), jnp.asarray(p["y"]),
                               jnp.asarray(p["z"]), jids, K)
    elif which == "y":
        got = tjfa.estimate_y(F, N, _hyper(p), _t(p["x"]), _t(p["z"]), ids,
                              K, p["n_spk"])
        ref = oracle_estimate_y(p)
        want = jjfa.estimate_y(jF, jN, _jhyper(p), jnp.asarray(p["x"]),
                               jnp.asarray(p["z"]), jids, K, p["n_spk"])
    else:
        got = tjfa.estimate_z(F, N, _hyper(p), _t(p["x"]), _t(p["y"]), ids,
                              K, p["n_spk"])
        ref = oracle_estimate_z(p)
        want = jjfa.estimate_z(jF, jN, _jhyper(p), jnp.asarray(p["x"]),
                               jnp.asarray(p["y"]), jids, K, p["n_spk"])
    for g, r, w in zip(got, ref, want):
        assert g.dtype == torch.float64
        _close(g, r, w)


def test_updates_match_per_component_solves_and_jax():
    p = setup(seed=3)
    _, A, C = oracle_estimate_x(p)
    ref = np.zeros_like(C)
    dim = p["dim"]
    for c in range(p["K"]):
        sl = slice(c * dim, (c + 1) * dim)
        ref[:, sl] = np.linalg.solve(A[c], C[:, sl])
    got = tjfa.update_u(_t(A), _t(C))
    _close(got, ref, jjfa.update_u(jnp.asarray(A), jnp.asarray(C)))
    _close(tjfa.update_v(_t(A), _t(C)), ref)
    a, b = np.random.RandomState(4).rand(2, 12) + 0.5
    _close(tjfa.update_d(_t(a), _t(b)), b / a,
           jjfa.update_d(jnp.asarray(a), jnp.asarray(b)))


def test_linear_scores_match_the_oracle_and_jax():
    p = setup(seed=5)
    M = (p["z"] * p["d"][None, :] + p["y"] @ p["v"]) / p["E"][None, :]
    chan = (p["m"][None, :] + p["x"] @ p["u"]) * expand(p["N"], p["dim"])
    ref = M @ ((p["F"] - chan) / p["N"].sum(axis=1, keepdims=True)).T
    got = tjfa.linear_scores(_t(p["F"]), _t(p["N"]), _hyper(p), _t(p["y"]),
                             _t(p["z"]), _t(p["x"]), p["K"])
    want = jjfa.linear_scores(jnp.asarray(p["F"]), jnp.asarray(p["N"]),
                              _jhyper(p), jnp.asarray(p["y"]),
                              jnp.asarray(p["z"]), jnp.asarray(p["x"]),
                              p["K"])
    _close(got, ref, want)


def _ubm(K=4, d=3, seed=0):
    rng = np.random.RandomState(seed)
    return tgmm.GmmParams(rng.dirichlet(np.ones(K)), rng.randn(K, d),
                          0.5 + rng.rand(K, d))


def _sessions(n_spk=6, per=3, T=40, d=3, seed=1):
    """Feature arrays of n_spk speakers x per sessions, each speaker's
    frames around its own offset, with their speaker ids."""
    rng = np.random.RandomState(seed)
    offs = rng.randn(n_spk, d)
    feats = [offs[s] + 0.7 * rng.randn(T - 3 * k, d)
             for s in range(n_spk) for k in range(per)]
    return feats, np.repeat(np.arange(n_spk), per)


def test_collect_session_stats_matches_jax():
    """Baum-Welch stats of ragged sessions at f32 against the JAX
    package's (its E-step on the same numpy inputs)."""
    ubm = _ubm()
    feats, _ = _sessions()
    N, F = tpipe.collect_session_stats(ubm, feats, "cpu")
    jN, jF = jpipe.collect_session_stats(jgmm.GmmParams(*ubm), feats)
    assert N.dtype == torch.float32 and F.shape == (len(feats), 12)
    np.testing.assert_allclose(N.numpy(), jN, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(F.numpy(), jF, rtol=1e-5, atol=1e-4)


def _jax_inits(ubm, seed, nv, nu):
    """The first attempt's v and u inits of the JAX package's train_jfa at
    `seed` (its key split and random_init)."""
    E = jnp.asarray((np.asarray(ubm.sigmas) ** 2).reshape(-1), jnp.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return (np.asarray(jjfa.random_init(k1, nv, E)),
            np.asarray(jjfa.random_init(k2, nu, E)))


def test_train_jfa_on_the_jax_inits_matches_jax():
    """train_jfa (v, u, d) from the JAX package's inits, one attempt, f32
    on both sides: the trained model and its scores agree (f32 EM
    iterations in other summation orders; relative to the largest entry)."""
    ubm = _ubm()
    feats, ids = _sessions()
    jN, jF = jpipe.collect_session_stats(jgmm.GmmParams(*ubm), feats)
    want = jpipe.train_jfa(jgmm.GmmParams(*ubm), jN, jF, ids, nv=3, nu=2,
                           n_iter=6, train_d=True, seed=4, retries=1)
    got = tpipe.train_jfa(ubm, jN, jF, ids, nv=3, nu=2, n_iter=6,
                          train_d=True, seed=4, retries=1,
                          inits=_jax_inits(ubm, 4, 3, 2), device="cpu")
    for f in ("v", "u", "d"):
        g = getattr(got.hyper, f).numpy()
        w = np.asarray(getattr(want.hyper, f))
        assert np.abs(g - w).max() <= 1e-3 * np.abs(w).max(), f
    y, z = tpipe.enroll(got, jN, jF, ids, 6)
    s = tpipe.score(got, y, z, jN, jF).numpy()
    jy, jz = jpipe.enroll(want, jN, jF, ids, 6)
    js = np.asarray(jpipe.score(want, jy, jz, jN, jF))
    assert np.abs(s - js).max() <= 1e-3 * np.abs(js).max()
    assert (s.argmax(0) == js.argmax(0)).all()


def test_model_npz_scores_in_both_packages(tmp_path):
    """A model written by the JAX package's CLI layout scores in the port
    and one written by the port scores in the JAX package, with the same
    numbers (f32)."""
    ubm = _ubm()
    feats, ids = _sessions()
    N, F = jpipe.collect_session_stats(jgmm.GmmParams(*ubm), feats)
    jmodel = jpipe.train_jfa(jgmm.GmmParams(*ubm), N, F, ids, nv=2, nu=1,
                             n_iter=3, seed=1, retries=1)
    jpath = str(tmp_path / "jax_model.npz")
    np.savez(jpath, n_components=jmodel.n_components,
             **{k: np.asarray(v) for k, v in jmodel.hyper._asdict().items()})
    tmodel = tpipe.load_model(jpath, "cpu")
    jy, jz = jpipe.enroll(jmodel, N, F, ids, 6)
    ty, tz = tpipe.enroll(tmodel, N, F, ids, 6)
    np.testing.assert_allclose(
        tpipe.score(tmodel, ty, tz, N, F).numpy(),
        np.asarray(jpipe.score(jmodel, jy, jz, N, F)), rtol=1e-4, atol=1e-4)

    tpath = str(tmp_path / "port_model.npz")
    tpipe.save_model(tpath, tmodel)
    z = np.load(tpath)
    back = jpipe.JfaModel(jjfa.JfaHyper(**{k: jnp.asarray(z[k])
                                           for k in jjfa.JfaHyper._fields}),
                          int(z["n_components"]))
    for f in jjfa.JfaHyper._fields:  # the port keeps the model in f32
        np.testing.assert_allclose(np.asarray(getattr(back.hyper, f)),
                                   np.asarray(getattr(jmodel.hyper, f)),
                                   rtol=1e-6, atol=1e-7)
    assert back.n_components == jmodel.n_components
    by, bz = jpipe.enroll(back, N, F, ids, 6)
    np.testing.assert_allclose(
        np.asarray(jpipe.score(back, by, bz, N, F)),
        np.asarray(jpipe.score(jmodel, jy, jz, N, F)), rtol=1e-4, atol=1e-4)
    hyper = tjfa.hyper_from_numpy(
        jax.tree.map(np.asarray, jmodel.hyper), device="cpu")
    assert all(torch.equal(getattr(hyper, f), getattr(tmodel.hyper, f))
               for f in tjfa.JfaHyper._fields)


def test_supervector_directory_both_ways(tmp_path):
    """The UBM supervector directory is byte for byte the JAX package's,
    and each package reads what the other wrote."""
    ubm = _ubm(K=5, d=4, seed=3)
    tser.dump_jfa_supervectors(ubm, str(tmp_path / "port"))
    jser.dump_jfa_supervectors(jgmm.GmmParams(*ubm), str(tmp_path / "jax"))
    for name in ("ubm_means", "ubm_variances", "ubm_weights"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes())
    a = tser.load_jfa_supervectors(str(tmp_path / "jax"))
    b = jser.load_jfa_supervectors(str(tmp_path / "port"))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_cli_on_a_tiny_corpus(tmp_path, capsys):
    """gen-features -> stats -> train -> score through the port's CLI on
    the CPU; its stats equal the JAX CLI's stats of the same manifest, and
    the JAX CLI scores the port's model."""
    import scipy.io.wavfile as wavfile

    dirs = {task: [] for task in ("train", "test")}
    for i, v in enumerate(synth.voices(3, seed=5)):
        for task, n, sec in (("train", 2, 2.0), ("test", 1, 1.5)):
            d = tmp_path / "wav" / task / f"spk{i}"
            d.mkdir(parents=True)
            for k in range(n):
                wavfile.write(str(d / f"s{k}.wav"), synth.FS,
                              synth.voice_utterance(v, sec, 50 * i + k
                                                    + 7 * (task == "test")))
            dirs[task].append(str(d))
    ubm_feats = [np.asarray(f) for f in _sessions(d=28)[0]]
    ubm = tgmm.GmmParams(np.full(4, 0.25), np.stack(
        [f.mean(0) for f in ubm_feats[:4]]), np.ones((4, 28)) * 2.0)
    tser.dump_jfa_supervectors(ubm, str(tmp_path / "ubm"))
    feat, ubm_dir = str(tmp_path / "feat"), str(tmp_path / "ubm")
    for task in ("train", "test"):
        tpipe.main(["gen-features", "-i", " ".join(dirs[task]), "-o", feat,
                    "--task", task, "--device", "cpu"])
        tpipe.main(["stats", "--ubm-dir", ubm_dir, "--lst",
                    os.path.join(feat, task + ".lst"), "-o",
                    str(tmp_path / f"{task}_stats.npz"), "--device", "cpu"])
    jpipe.main(["stats", "--ubm-dir", ubm_dir, "--lst",
                os.path.join(feat, "train.lst"), "-o",
                str(tmp_path / "jax_stats.npz")])
    mine, theirs = (np.load(str(tmp_path / f)) for f in
                    ("train_stats.npz", "jax_stats.npz"))
    np.testing.assert_array_equal(mine["labels"], theirs["labels"])
    for k in ("N", "F"):
        np.testing.assert_allclose(mine[k], theirs[k], rtol=1e-4, atol=1e-2)
    tpipe.main(["train", "--ubm-dir", ubm_dir, "--stats",
                str(tmp_path / "train_stats.npz"), "-o",
                str(tmp_path / "model.npz"), "--nv", "2", "--nu", "1",
                "--iters", "3", "--device", "cpu"])
    capsys.readouterr()
    args = ["score", "--ubm-dir", ubm_dir, "--model",
            str(tmp_path / "model.npz"), "--enroll-stats",
            str(tmp_path / "train_stats.npz"), "--test-stats",
            str(tmp_path / "test_stats.npz")]
    tpipe.main(args + ["--device", "cpu"])
    port_lines = capsys.readouterr().out.strip().splitlines()
    jpipe.main(args)
    jax_lines = capsys.readouterr().out.strip().splitlines()
    assert len(port_lines) == 3
    assert ([ln.split(" (")[0] for ln in port_lines]
            == [ln.split(" (")[0] for ln in jax_lines])


# -- where the port does not copy the JAX package's divergence guard --------

def test_the_gate_is_divergence_not_rank_limited_accuracy():
    """ADVICE r5 (jfa_pipeline.py:97): the JAX gate retrains a healthy but
    rank-limited model whose self-consistency is under min(0.75, max(0.5,
    3/n)). The port retrains only a diverged one: a non-finite score, or
    an accuracy of at most twice chance."""
    ids = torch.arange(10).repeat(2)

    def scores_with(right: int):
        """Self-scores with sessions 0 .. right-1 on their own speaker and
        the others on the next speaker."""
        s = torch.zeros(10, 20)
        s[(ids + (torch.arange(20) >= right)) % 10, torch.arange(20)] = 1.0
        return s
    assert tpipe.diverged(scores_with(8), ids) == (False, 0.4)
    assert min(0.75, max(0.5, 3.0 / 10)) > 0.4   # the JAX gate retrains it
    assert tpipe.diverged(scores_with(4), ids) == (True, 0.2)  # 2 / n
    nan = scores_with(20)
    nan[3, 5] = float("nan")
    assert tpipe.diverged(nan, ids)[0]
    # a rank-2 model of 8 speakers: healthy but rank-limited (under the
    # JAX gate of min(0.75, max(0.5, 3/8)) = 0.5), trained once
    ubm = _ubm()
    feats, sids = _sessions(n_spk=8, per=2)
    N, F = tpipe.collect_session_stats(ubm, feats, "cpu")
    log = {}
    tpipe.train_jfa(ubm, N, F, sids, nv=2, nu=1, n_iter=3, retries=3,
                    device="cpu", log=log)
    acc = log["self_consistency"][0]
    assert log["attempts"] == 1 and 2 / 8 < acc < 0.5, log


def test_n_speakers_is_the_number_of_distinct_ids():
    """ADVICE r5 (jfa_pipeline.py:93): n_speakers = max() + 1 counts
    phantom zero-stat speakers for ids with gaps. The port counts distinct
    ids and refuses ids that are not 0 .. n-1; the CLI maps labels to them."""
    assert tjfa.n_speakers(torch.tensor([0, 0, 1, 2, 2])) == 3
    with pytest.raises(ValueError, match="0 .. n-1"):
        tjfa.n_speakers(torch.tensor([0, 0, 2, 2]))
    ubm = _ubm()
    feats, _ = _sessions(n_spk=2, per=2)
    N, F = tpipe.collect_session_stats(ubm, feats, "cpu")
    with pytest.raises(ValueError, match="0 .. n-1"):
        tpipe.train_jfa(ubm, N, F, np.array([0, 0, 5, 5]), nv=1, nu=1,
                        n_iter=1, device="cpu")
    order, ids = tpipe._speaker_ids(["b", "z", "b", "a"])
    assert order == ["a", "b", "z"] and ids.tolist() == [1, 2, 1, 0]


def test_the_docstring_states_the_gate_the_code_applies():
    """ADVICE r5 (jfa_pipeline.py:81): the JAX docstring names
    max(0.5, 3/n_speakers) where the code caps it at 0.75. The port's
    docstring names the rule `diverged` applies, at its boundary."""
    doc = " ".join(tpipe.train_jfa.__doc__.split())
    assert "at most 2 / n_speakers with more than two speakers" in doc
    ids = torch.arange(4)
    s = torch.eye(4)
    s[:, 2:] = torch.tensor([[0.0, 0.0], [0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]
                            ).roll(1, 0)
    assert tpipe.diverged(s[:, :4], ids)[1] == 0.5     # 2 / 4: diverged
    assert tpipe.diverged(s[:, :4], ids)[0]
    assert not tpipe.diverged(torch.eye(2), torch.arange(2))[0]  # n = 2


def test_retry_inits_never_collide_across_seeds():
    """ADVICE r5 (jfa_pipeline.py:102): PRNGKey(seed + 7919 * attempt)
    gives seed 7919's first attempt the draws of seed 0's second. The
    port's attempt_generators(seed, attempt) draw from SeedSequence([seed,
    attempt]): no two (seed, attempt) pairs share their first draw."""
    assert 7919 + 7919 * 0 == 0 + 7919 * 1  # the JAX collision
    draws = {}
    for seed in (0, 1, 2, 7919, 15838):
        for attempt in range(3):
            gv, gu = tpipe.attempt_generators(seed, attempt)
            key = (float(torch.randn(1, generator=gv)),
                   float(torch.randn(1, generator=gu)))
            assert key not in draws, ((seed, attempt), draws.get(key))
            draws[key] = (seed, attempt)
    a = tpipe.attempt_generators(3, 1)[0]
    b = tpipe.attempt_generators(3, 1)[0]
    assert torch.equal(torch.randn(4, generator=a), torch.randn(4, generator=b))
