"""speaker_recognition_tpu_torch's RBM family (models/rbm, models/crbm,
models/neural_net, the CRBM text format and tools/crbm_cli) against the
JAX package's on the same numpy inputs: the deterministic surfaces at f32
and f64, one CD step of each machine given the same noise (the JAX draws,
passed in as tensors), one MLP SGD step against jax.grad; the port's own
properties (segments compose bitwise, a speaker's model does not depend on
the bank's padding, which the JAX package's does: the recorded deviation);
the text format byte for byte, the bank npz and the CLIs both ways."""

import io
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu.models import crbm as jcrbm  # noqa: E402
from speaker_recognition_tpu.models import neural_net as jnn  # noqa: E402
from speaker_recognition_tpu.models import rbm as jrbm  # noqa: E402
from speaker_recognition_tpu.tools import crbm_cli as jcli  # noqa: E402
from speaker_recognition_tpu.utils import serialization as jser  # noqa: E402
from speaker_recognition_tpu_torch.models import crbm  # noqa: E402
from speaker_recognition_tpu_torch.models import neural_net as nn  # noqa: E402
from speaker_recognition_tpu_torch.models import rbm  # noqa: E402
from speaker_recognition_tpu_torch.tools import crbm_cli  # noqa: E402
from speaker_recognition_tpu_torch.utils import datamanip  # noqa: E402
from speaker_recognition_tpu_torch.utils import serialization  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.realpath(__file__)))
import refbuild  # noqa: E402

# The same arithmetic on the same inputs in another order: a few ulps of
# O(1) values through sigmoids and small matmuls (measured <= 3e-7 at f32,
# <= 1e-15 at f64)
TOL = {np.float32: 1e-5, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]
IDS = ["f32", "f64"]


def _frames(center, n, d, seed):
    rng = np.random.RandomState(seed)
    return (center[None, :] + rng.randn(n, d) * 0.15).astype(np.float32)


def _crbm_params(nv, nh, dt, seed=0, S=None):
    rng = np.random.RandomState(seed)
    lead = () if S is None else (S,)
    return jcrbm.CrbmParams(
        vb=(0.3 * rng.randn(*lead, nv)).astype(dt),
        hb=(0.3 * rng.randn(*lead, nh)).astype(dt),
        w=(0.5 * rng.randn(*lead, nv, nh)).astype(dt),
        a=(1.0 + 0.2 * rng.rand(*lead, nh)).astype(dt),
        vlo=(-1.0 - rng.rand(*lead, nv)).astype(dt),
        vhi=(1.0 + rng.rand(*lead, nv)).astype(dt))


def _jax(p):
    return type(p)(*(jnp.asarray(a) for a in p))


def _port(p, cls=crbm.CrbmParams):
    return cls(*(torch.as_tensor(np.asarray(a)) for a in p))


def _close(got, want, dt):
    got = got.detach().numpy() if hasattr(got, "detach") else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL[dt],
                               atol=TOL[dt])


# -- CRBM ------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_crbm_deterministic_surfaces_match_jax(dt):
    """The noise-free up-down pass, reconstruction_error over the valid
    frames, a bank's errors and its argmin decision."""
    rng = np.random.RandomState(1)
    p = _crbm_params(6, 5, dt)
    X = rng.randn(40, 6).astype(dt)
    mask = np.arange(40) < 33
    H = crbm.sample_hidden(_port(p), torch.from_numpy(X))
    _close(H, jcrbm.sample_hidden(_jax(p), jnp.asarray(X)), dt)
    _close(crbm.sample_visible(_port(p), H),
           jcrbm.sample_visible(_jax(p), jcrbm.sample_hidden(
               _jax(p), jnp.asarray(X))), dt)
    _close(crbm.reconstruction_error(_port(p), torch.from_numpy(X),
                                     torch.from_numpy(mask)),
           jcrbm.reconstruction_error(_jax(p), jnp.asarray(X),
                                      jnp.asarray(mask)), dt)
    bank = _crbm_params(6, 5, dt, seed=2, S=4)
    labels = ["a", "b", "c", "d"]
    for seed in range(3):
        Xt = np.random.RandomState(10 + seed).randn(25, 6).astype(dt)
        mt = np.ones(25, bool)
        errs = crbm.bank_reconstruction_errors(
            _port(bank), torch.from_numpy(Xt), torch.from_numpy(mt))
        want = jcrbm.bank_reconstruction_errors(_jax(bank), jnp.asarray(Xt),
                                                jnp.asarray(mt))
        _close(errs, want, dt)
        assert crbm.predict_bank(_port(bank), labels, torch.from_numpy(Xt),
                                 torch.from_numpy(mt)) == \
            jcrbm.predict_bank(_jax(bank), labels, jnp.asarray(Xt),
                               jnp.asarray(mt))


def _jax_cd_noise(key, shapes, dt, draw):
    """The draws JAX's _cd_batch makes from `key`, in its order."""
    keys = jax.random.split(key, len(shapes))
    return [np.asarray(draw(k, s, dt)) for k, s in zip(keys, shapes)]


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_crbm_cd_step_given_the_same_noise_matches_jax(dt):
    """One CD-2 minibatch step with momentum from a non-zero velocity: the
    JAX step draws its Gaussian noise from a key; the port's takes those
    draws as tensors."""
    p = _crbm_params(5, 4, dt, seed=3)
    rng = np.random.RandomState(4)
    vel = jcrbm._Velocity(*(0.01 * rng.randn(*np.shape(a)).astype(dt)
                            for a in p[:4]))
    batch = rng.randn(16, 5).astype(dt)
    cfg = jcrbm.CrbmTrainConfig(cd_k=2)
    key = jax.random.PRNGKey(5)
    want_p, want_v = jcrbm._cd_batch(_jax(p), _jax(vel), jnp.asarray(batch),
                                     key, cfg)
    noise = _jax_cd_noise(key, [(16, 4), (16, 5), (16, 4), (16, 5), (16, 4)],
                          dt, jax.random.normal)
    got_p, got_v = crbm.cd_batch(
        _port(p), _port(vel, crbm._Velocity), torch.from_numpy(batch),
        [torch.from_numpy(n) for n in noise], crbm.CrbmTrainConfig(cd_k=2))
    for g, w in zip((*got_p, *got_v), (*want_p, *want_v)):
        _close(g, w, dt)


def test_crbm_visible_range_tracked():
    X = np.array([[0.0, -2.0], [1.0, 3.0], [0.5, 0.0], [99.0, 99.0]],
                 np.float32)
    st = crbm.init_train_state(0, 4, X[None], (np.arange(4) < 3)[None],
                               device="cpu")
    np.testing.assert_array_equal(st.params.vlo.numpy(), [[0.0, -2.0]])
    np.testing.assert_array_equal(st.params.vhi.numpy(), [[1.0, 3.0]])
    assert st.step == 0 and float(st.params.a.min()) == 1.0


def _bank_data(n_valid, n_pad, d=5, seed=4):
    rng = np.random.RandomState(seed)
    S = len(n_valid)
    Xs = np.zeros((S, n_pad, d), np.float32)
    masks = np.zeros((S, n_pad), bool)
    for s, n in enumerate(n_valid):
        Xs[s, :n] = _frames(rng.randn(d), n, d, seed + s)
        masks[s, :n] = True
    return Xs, masks


def test_crbm_segments_compose_bitwise():
    """12 epochs in three uneven segments give the bits of one run, a
    ragged speaker among them (the port's own draws)."""
    Xs, masks = _bank_data([130, 100, 130], 130)
    cfg = crbm.CrbmTrainConfig(n_epochs=12, batch_size=50)
    mono = crbm.fit_bank(Xs, masks, 6, cfg, seed=7, device="cpu")
    state = None
    for seg in (5, 4, 3):
        state = crbm.fit_bank_segment(Xs, masks, 6, cfg, 7, state, seg, 12,
                                      device="cpu")
    for a, b in zip(mono, state.params):
        assert torch.equal(a, b)


def test_crbm_speaker_unchanged_by_the_banks_padding():
    """A bank padded to 300 rows and the same bank padded to 400: every
    speaker's model is bitwise the same, its minibatch walk following its
    own valid count (the reference's per-speaker epochs)."""
    Xs, masks = _bank_data([150, 300], 300)
    Xp = np.concatenate([Xs, np.full((2, 100, 5), 7.0, np.float32)], axis=1)
    mp = np.concatenate([masks, np.zeros((2, 100), bool)], axis=1)
    cfg = crbm.CrbmTrainConfig(n_epochs=3, batch_size=100)
    a = crbm.fit_bank(Xs, masks, 6, cfg, seed=1, device="cpu")
    b = crbm.fit_bank(Xp, mp, 6, cfg, seed=1, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_crbm_full_batch_speaker_unchanged_by_the_banks_padding():
    """At speaker_task_config of the padded row count (the enrollment
    regime), the same bank padded to 300 and to 400 rows: each speaker's
    batch is its own valid frames, so a short speaker (150 of 300) trains
    bitwise the same."""
    Xs, masks = _bank_data([150, 300], 300)
    Xp = np.concatenate([Xs, np.full((2, 100, 5), 7.0, np.float32)], axis=1)
    mp = np.concatenate([masks, np.zeros((2, 100), bool)], axis=1)
    runs = [crbm.fit_bank(X, m, 6, crbm.speaker_task_config(
        X.shape[1])._replace(n_epochs=30), seed=1, device="cpu")
        for X, m in ((Xs, masks), (Xp, mp))]
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def test_crbm_full_batch_step_averages_a_speakers_own_frames():
    """One full-batch CD step of a bank: the short speaker's update equals
    its step on its own 150 frames alone, given the same noise rows (f64;
    sums of 150 rows against 300 with zeros, 1e-12 relative)."""
    p = _crbm_params(5, 4, np.float64, seed=8, S=2)
    rng = np.random.RandomState(9)
    vel = crbm._Velocity(*(torch.from_numpy(0.01 * rng.randn(
        *np.shape(a))) for a in p[:4]))
    X = torch.from_numpy(rng.randn(2, 300, 5))
    valid = torch.arange(300)[None] < torch.tensor([[150], [300]])
    X = torch.where(valid[..., None], X, 0.0)
    noise = [torch.from_numpy(rng.randn(2, 300, k)) for k in (4, 5, 4)]
    cfg = crbm.speaker_task_config(300)
    bank_p, bank_v = crbm.cd_batch(_port(p), vel, X, noise, cfg, valid)
    one = lambda t: t[0]  # noqa: E731
    alone_p, alone_v = crbm.cd_batch(
        crbm.CrbmParams(*map(one, _port(p))),
        crbm._Velocity(*map(one, vel)), X[0, :150],
        [n[0, :150] for n in noise], cfg)
    for g, w in zip((*bank_p, *bank_v), (*alone_p, *alone_v)):
        np.testing.assert_allclose(g[0].numpy(), w.numpy(), rtol=1e-12,
                                   atol=1e-15)


def test_jax_fit_bank_changes_with_the_banks_padding():
    """The recorded deviation (ROADMAP, known faults on the reference
    side): the JAX package's `_fit_segment` walks the padded row count, so
    the same bank padded further trains different models, and a speaker in
    a bank differs from itself trained alone on its own frames."""
    Xs, masks = _bank_data([150, 300], 300)
    Xp = np.concatenate([Xs, np.zeros((2, 100, 5), np.float32)], axis=1)
    mp = np.concatenate([masks, np.zeros((2, 100), bool)], axis=1)
    cfg = jcrbm.CrbmTrainConfig(n_epochs=3, batch_size=100)
    key = jax.random.PRNGKey(1)
    a = jcrbm.fit_bank(jnp.asarray(Xs), jnp.asarray(masks), 6, cfg, key)
    b = jcrbm.fit_bank(jnp.asarray(Xp), jnp.asarray(mp), 6, cfg, key)
    assert np.abs(np.asarray(a.w[0]) - np.asarray(b.w[0])).max() > 1e-4
    k0 = jax.random.split(key, 2)[0]
    alone = jcrbm.fit(jnp.asarray(Xs[0, :150]), jnp.ones(150, bool), 6, cfg,
                      k0)
    assert np.abs(np.asarray(a.w[0]) - np.asarray(alone.w)).max() > 1e-4


def test_crbm_training_learns_and_classifies():
    """The port's training lowers the reconstruction error and a bank of
    three separated speakers classifies held-out frames."""
    rng = np.random.RandomState(3)
    centers = [rng.randn(6) * 2 for _ in range(3)]
    Xs = np.stack([_frames(c, 300, 6, 10 + i) for i, c in enumerate(centers)])
    masks = np.ones((3, 300), bool)
    cfg = crbm.CrbmTrainConfig(n_epochs=40, batch_size=100)
    state0 = crbm.init_train_state(1, 8, Xs, masks, device="cpu")
    bank = crbm.fit_bank(Xs, masks, 8, cfg, seed=1, device="cpu")
    X0, m0 = torch.from_numpy(Xs[0]), torch.ones(300, dtype=torch.bool)
    e0 = crbm.reconstruction_error(
        crbm.CrbmParams(*(p[0] for p in state0.params)), X0, m0)
    e1 = crbm.reconstruction_error(crbm.CrbmParams(*(p[0] for p in bank)),
                                   X0, m0)
    assert float(e1) < float(e0)
    labels = ["a", "b", "c"]
    correct = sum(
        crbm.predict_bank(bank, labels, torch.from_numpy(
            _frames(c, 100, 6, 20 + i)), torch.ones(100, dtype=torch.bool))
        == labels[i] for i, c in enumerate(centers))
    assert correct == 3


def test_speaker_task_config_matches_jax():
    """The JAX package's fields and defaults; the port's full_batch is set
    by speaker_task_config alone."""
    n = len(jcrbm.CrbmTrainConfig._fields)
    task = crbm.speaker_task_config(737)
    assert task[:n] == tuple(jcrbm.speaker_task_config(737))
    assert task.full_batch
    assert crbm.SIGMA == jcrbm.SIGMA
    assert crbm.CrbmTrainConfig()[:n] == tuple(jcrbm.CrbmTrainConfig())
    assert not crbm.CrbmTrainConfig().full_batch


# -- RBM, DBN, MLP ---------------------------------------------------------

def _rbm_params(nv, nh, dt, seed):
    rng = np.random.RandomState(seed)
    return jrbm.RbmParams((0.3 * rng.randn(nv)).astype(dt),
                          (0.3 * rng.randn(nh)).astype(dt),
                          (0.5 * rng.randn(nv, nh)).astype(dt))


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_rbm_probabilities_transform_and_dbn_match_jax(dt):
    """transform (the hidden probabilities), the visible probabilities and
    Dbn.propagate through two layers given the same parameters."""
    rng = np.random.RandomState(6)
    X = (rng.rand(30, 8) > 0.5).astype(dt)
    p1, p2 = _rbm_params(8, 6, dt, 1), _rbm_params(6, 4, dt, 2)
    H = rbm.transform(_port(p1, rbm.RbmParams), torch.from_numpy(X))
    _close(H, jrbm.transform(_jax(p1), jnp.asarray(X)), dt)
    _close(torch.sigmoid(H @ torch.from_numpy(p1.w).T
                         + torch.from_numpy(p1.vb)),
           jax.nn.sigmoid(jrbm.transform(_jax(p1), jnp.asarray(X))
                          @ jnp.asarray(p1.w).T + jnp.asarray(p1.vb)), dt)
    tdbn, jdbn = rbm.Dbn(), jrbm.Dbn()
    tdbn.layers = [_port(p, rbm.RbmParams) for p in (p1, p2)]
    jdbn.layers = [_jax(p) for p in (p1, p2)]
    for upto in (None, 1):
        _close(tdbn.propagate(torch.from_numpy(X), upto),
               jdbn.propagate(jnp.asarray(X), upto), dt)


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_rbm_cd_step_given_the_same_noise_matches_jax(dt):
    """One CD-2 step: the JAX step draws uniforms from a key; the port's
    takes them as tensors (hidden statistics from the probabilities, the
    products from the sampled states)."""
    p = _rbm_params(8, 6, dt, 3)
    X = (np.random.RandomState(7).rand(20, 8) > 0.5).astype(dt)
    cfg = jrbm.RbmTrainConfig(cd_k=2)
    key = jax.random.PRNGKey(8)
    want = jrbm._cd_batch(_jax(p), jnp.asarray(X), key, cfg)
    noise = _jax_cd_noise(key, [(20, 6), (20, 8), (20, 6), (20, 8), (20, 6)],
                          dt, jax.random.uniform)
    got = rbm.cd_step(_port(p, rbm.RbmParams), torch.from_numpy(X),
                      [torch.from_numpy(n) for n in noise],
                      rbm.RbmTrainConfig(cd_k=2))
    for g, w in zip(got, want):
        _close(g, w, dt)


def test_rbm_and_dbn_train():
    """The port's RBM denoises toward the prototypes it was trained on,
    and a DBN stacks and retrains its top layer."""
    rng = np.random.RandomState(4)
    protos = np.array([[1, 1, 0, 0, 1, 0], [0, 0, 1, 1, 0, 1]], np.float32)
    X = protos[rng.randint(0, 2, 500)]
    X = np.where(rng.rand(500, 6) < 0.02, 1 - X, X).astype(np.float32)
    params = rbm.fit(X, 4, rbm.RbmTrainConfig(n_epochs=60, batch_size=100),
                     seed=0, device="cpu")
    H = rbm.transform(params, torch.from_numpy(protos))
    V = torch.sigmoid(H @ params.w.T + params.vb)
    assert float((V - torch.from_numpy(protos)).abs().mean()) < 0.35
    d = rbm.Dbn()
    d.add_layer(6)
    d.add_layer(4)
    Xb = (rng.rand(200, 8) > 0.5).astype(np.float32)
    cfg = rbm.RbmTrainConfig(n_epochs=5, batch_size=50)
    d.fit(Xb, cfg, seed=0, device="cpu")
    assert d.propagate(torch.from_numpy(Xb)).shape == (200, 4)
    top = d.layers[-1]
    d.fit_last_layer(Xb, cfg, seed=1, device="cpu")
    assert len(d.layers) == 2 and not torch.equal(top.w, d.layers[-1].w)


def _mlp(dt, sizes=(7, 5, 3), seed=9):
    rng = np.random.RandomState(seed)
    Ws = tuple((0.5 * rng.randn(a, b)).astype(dt)
               for a, b in zip(sizes, sizes[1:]))
    bs = tuple((0.1 * rng.randn(b)).astype(dt) for b in sizes[1:])
    return Ws, bs


@pytest.mark.parametrize("dt", DTYPES, ids=IDS)
def test_mlp_forward_and_sgd_step_match_jax(dt):
    """The forward pass given the same parameters, and one minibatch SGD
    step (torch.autograd) against params - lr * jax.grad(loss)."""
    Ws, bs = _mlp(dt)
    rng = np.random.RandomState(10)
    X = rng.randn(12, 7).astype(dt)
    Y = np.eye(3, dtype=dt)[rng.randint(0, 3, 12)]
    jp = jnn.MlpParams(tuple(map(jnp.asarray, Ws)), tuple(map(jnp.asarray,
                                                             bs)))
    tp = nn.MlpParams(tuple(map(torch.from_numpy, Ws)),
                      tuple(map(torch.from_numpy, bs)))
    _close(nn.forward(tp, torch.from_numpy(X)),
           jnn._forward(jp, jnp.asarray(X)), dt)
    g = jax.grad(jnn._loss)(jp, jnp.asarray(X), jnp.asarray(Y))
    want = jax.tree.map(lambda p, gi: p - 0.3 * gi, jp, g)
    got = nn.sgd_step(tp, torch.from_numpy(X), torch.from_numpy(Y), 0.3)
    for a, b in zip((*got.weights, *got.biases),
                    (*want.weights, *want.biases)):
        _close(a, b, dt)


def test_neural_net_fits_and_pretrains():
    """NeuralNet separates two blobs, with and without DBN pretraining."""
    rng = np.random.RandomState(11)
    X = np.concatenate([rng.randn(60, 4) * 0.3 + 1.0,
                        rng.randn(60, 4) * 0.3 - 1.0]).astype(np.float32)
    y = np.repeat([0, 1], 60)
    for dbn in (False, True):
        net = nn.NeuralNet(n_iter=40, learning_rate=0.5, batch_size=20,
                           seed=1, device="cpu")
        net.add_layer(5)
        if dbn:
            net.fit_dbn((X > 0).astype(np.float32), y,
                        rbm.RbmTrainConfig(n_epochs=3, batch_size=20))
            Xp = (X > 0).astype(np.float32)
        else:
            net.fit(X, y)
            Xp = X
        assert net.predict_proba(Xp).shape == (120, 2)
        assert (net.predict(Xp) == y).mean() > 0.9


# -- the text format, the bank npz and the CLIs ----------------------------

def test_crbm_text_format_byte_equal_and_both_ways():
    """dump_reference_crbm writes the JAX package's bytes for the same
    model (from tensors or numpy), and each package loads the other's."""
    p = _crbm_params(4, 3, np.float32, seed=12)
    want = io.StringIO()
    jser.dump_reference_crbm(p, want)
    for src in (p, _port(p)):
        got = io.StringIO()
        serialization.dump_reference_crbm(src, got)
        assert got.getvalue() == want.getvalue()
    back = serialization.load_reference_crbm(io.StringIO(want.getvalue()))
    jback = jser.load_reference_crbm(io.StringIO(want.getvalue()))
    for a, b in zip(back, jback):
        np.testing.assert_array_equal(a, np.asarray(b))
    bad = want.getvalue().rsplit("\n", 2)[0] + "\n0.3000000000\n"
    with pytest.raises(ValueError, match="sigma"):
        serialization.load_reference_crbm(io.StringIO(bad))
    lines = want.getvalue().splitlines()
    lines[-2] = " ".join(["0.0000000000", "2.0000000000"] * 3) + " "
    with pytest.raises(ValueError, match="hidden range"):
        serialization.load_reference_crbm(io.StringIO("\n".join(lines)))


def _svm_corpus(tmp_path, n_train=60, n_test=20, d=5):
    rng = np.random.RandomState(13)
    centers = rng.randn(3, d) * 2
    paths = {}
    for split, n in (("train", n_train), ("test", n_test)):
        X = np.concatenate([_frames(c, n, d, 30 + i + len(split))
                            for i, c in enumerate(centers)])
        y = np.repeat([1, 2, 3], n)
        paths[split] = str(tmp_path / f"{split}.svm")
        datamanip.write_svm_data(paths[split], X, y)
    return paths


def _accuracy(capsys):
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("accuracy")][-1]
    return float(line.rsplit("=", 1)[1])


def test_crbm_cli_train_then_test_both_ways(tmp_path, capsys):
    """The port's CLI trains a bank (in checkpointed segments, with text
    models) and tests it from the npz and from the text models; it tests a
    bank npz written by the JAX CLI, and the JAX CLI tests the port's."""
    paths = _svm_corpus(tmp_path)
    bank, text = str(tmp_path / "bank.npz"), str(tmp_path / "text")
    common = ["--hidden", "6", "--epochs", "30", "--batch-size", "30"]
    crbm_cli.main(["train", "-i", paths["train"], "-m", bank, *common,
                   "--save-every", "10", "--text-dir", text,
                   "--device", "cpu"])
    assert "checkpoint at epoch 30/30" in capsys.readouterr().out
    assert sorted(os.listdir(text)) == [f"crbm.{i}.model" for i in (1, 2, 3)]
    accs = []
    for model in (bank, text):
        crbm_cli.main(["test", "-i", paths["test"], "-m", model,
                       "--device", "cpu"])
        accs.append(_accuracy(capsys))
    assert accs[0] == accs[1] and accs[0] >= 0.9
    z = np.load(bank)
    assert set(z.files) == {"labels", *crbm.CrbmParams._fields}
    assert z["w"].shape == (3, 5, 6) and z["w"].dtype == np.float32
    jcli.main(["test", "-i", paths["test"], "-m", bank])
    assert _accuracy(capsys) == accs[0]
    jbank = str(tmp_path / "jbank.npz")
    jcli.main(["train", "-i", paths["train"], "-m", jbank, *common])
    capsys.readouterr()
    jcli.main(["test", "-i", paths["test"], "-m", jbank])
    want = _accuracy(capsys)
    crbm_cli.main(["test", "-i", paths["test"], "-m", jbank,
                   "--device", "cpu"])
    assert _accuracy(capsys) == want


@pytest.mark.skipif(refbuild.ensure_refnn() is None,
                    reason="reference nn core not buildable (missing "
                    "checkout or g++), as tests/test_differential_nn.py")
def test_port_text_models_score_in_the_reference_as_in_the_port(tmp_path):
    """A model trained by the port, written in the text format, gives the
    reference C++ CRBM's reconstruction error the port computes."""
    import test_differential_nn as ref

    X = ref._synth_features(256, 13, seed=2)
    cfg = crbm.CrbmTrainConfig(n_epochs=25, batch_size=64)
    params = crbm.fit(X, np.ones(256, bool), 8, cfg, seed=0, device="cpu")
    path = str(tmp_path / "port.model")
    with open(path, "w") as f:
        serialization.dump_reference_crbm(params, f)
    Xt = ref._synth_features(90, 13, seed=3)
    ours = float(crbm.reconstruction_error(params, torch.from_numpy(Xt),
                                           torch.ones(90, dtype=torch.bool)))
    np.testing.assert_allclose(ours, ref.RefCrbm.load(
        path).reconstruction_error(Xt), rtol=1e-7)
