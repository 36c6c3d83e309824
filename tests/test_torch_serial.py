"""speaker_recognition_tpu_torch's serial, open-set path against the JAX
package on the same numpy inputs: the single-utterance bank score's plain
version (ops/gpu_gmm.bank_sum_loglik, which the serial kernel is held to on
the card) against the Pallas kernel in interpret mode and the XLA program,
GMMSet's serial scoring and rejection, the reference text GMM format, and
mix_feature (the frontend kernel's single-utterance entry point)."""

import io
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu.features import extract as jextract  # noqa: E402
from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu.models.gmmset import GMMSet as JGMMSet  # noqa: E402
from speaker_recognition_tpu.ops import pallas_gmm  # noqa: E402
from speaker_recognition_tpu.utils import serialization as jser  # noqa: E402
from speaker_recognition_tpu_torch.config import (  # noqa: E402
    FeatureConfig, GmmConfig, LpcConfig, MfccConfig)
from speaker_recognition_tpu_torch.features import extract  # noqa: E402
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.models.gmmset import (  # noqa: E402
    GMMSet, SCORE_FRAME_BUCKET)
from speaker_recognition_tpu_torch.ops import gpu_gmm  # noqa: E402
from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402
from speaker_recognition_tpu_torch.utils import serialization  # noqa: E402

# f32 on both sides, sums of a few hundred O(10-100) per-frame scores in
# other orders: tests/test_pallas_gmm.py:27 holds the kernel to 2e-5.
SUM_RTOL = 2e-5


def _bank_np(S, K, d, seed):
    rng = np.random.RandomState(seed)
    return (rng.dirichlet(np.ones(K), size=S).astype(np.float32),
            rng.randn(S, K, d).astype(np.float32),
            (0.5 + rng.rand(S, K, d)).astype(np.float32))


def _utt(n, d, n_valid, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * scale).astype(np.float32)
    mask = np.arange(n) < n_valid
    return np.where(mask[:, None], x, 0).astype(np.float32), mask


def _port_sum(bank_np, x, mask):
    bank = tgmm.GmmBank.from_numpy(*bank_np, device="cpu")
    return gpu_gmm.bank_sum_loglik(bank, torch.from_numpy(x),
                                   torch.from_numpy(mask)).numpy()


@pytest.mark.parametrize("S,K,d,n,n_valid", [
    (5, 8, 28, 300, 211),     # S not a multiple of 8, n not of 512
    (11, 4, 13, 700, 700),
    (1, 16, 28, 256, 90),     # one speaker
    (3, 8, 28, 130, 0),       # every frame masked
], ids=["s5_n300", "s11_n700", "s1", "all_masked"])
def test_plain_matches_pallas_serial_kernel(S, K, d, n, n_valid):
    bank = _bank_np(S, K, d, seed=S + K)
    x, mask = _utt(n, d, n_valid, seed=n)
    got = _port_sum(bank, x, mask)
    want = np.asarray(pallas_gmm.bank_sum_loglik(
        jgmm.GmmParams(*(jnp.asarray(a) for a in bank)), jnp.asarray(x),
        jnp.asarray(mask), interpret=True))
    assert got.shape == (S,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL, atol=1e-3)
    if n_valid == 0:
        assert (got == 0).all()
        tb = tgmm.GmmBank.from_numpy(*bank, device="cpu")
        avg = gpu_gmm.bank_avg_loglik(tb, torch.from_numpy(x),
                                      torch.from_numpy(mask))
        assert (avg == 0).all()  # 0 / max(0, 1)


def test_floor_matches_models_gmm_not_the_tpu_kernel():
    """Far-off frames underflow every component: the port floors them at
    log(1e-15) as models/gmm.bank_avg_loglik does; the TPU kernel, which
    omits the floor, does not agree there."""
    bank = _bank_np(3, 4, 6, seed=1)
    x, mask = _utt(40, 6, 30, seed=2, scale=300.0)
    tb = tgmm.GmmBank.from_numpy(*bank, device="cpu")
    got = gpu_gmm.bank_avg_loglik(tb, torch.from_numpy(x),
                                  torch.from_numpy(mask)).numpy()
    jb = jgmm.GmmParams(*(jnp.asarray(a) for a in bank))
    want = np.asarray(jgmm.bank_avg_loglik(jb, jnp.asarray(x),
                                           jnp.asarray(mask)))
    np.testing.assert_allclose(got, math.log(1e-15), rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    tpu = np.asarray(pallas_gmm.bank_avg_loglik(jb, jnp.asarray(x),
                                                jnp.asarray(mask),
                                                interpret=True))
    assert (tpu < 100 * got).all()  # unfloored: far below log(1e-15)


def test_avg_matches_xla_bank_program():
    bank = _bank_np(4, 8, 28, seed=3)
    x, mask = _utt(512, 28, 311, seed=4)
    tb = tgmm.GmmBank.from_numpy(*bank, device="cpu")
    got = gpu_gmm.bank_avg_loglik(tb, torch.from_numpy(x),
                                  torch.from_numpy(mask)).numpy()
    want = np.asarray(jgmm.bank_avg_loglik(
        jgmm.GmmParams(*(jnp.asarray(a) for a in bank)), jnp.asarray(x),
        jnp.asarray(mask)))
    np.testing.assert_allclose(got, want, rtol=SUM_RTOL)


@pytest.mark.parametrize("d,dp", [(28, 32), (13, 16), (56, 56)])
def test_serial_operator_layout(d, dp):
    """The scoring kernels' component-major layout, read the way the kernel
    reads it (x (a x + b) summed over padded dims, plus cw), gives the
    plain version's joint log-density."""
    S, K = 3, 4
    bank = tgmm.GmmBank.from_numpy(*_bank_np(S, K, d, seed=d),
                                   device="cpu")
    comp = bank.component_operator(2 * dp + 4).numpy()
    assert comp.shape == (S, K, 2 * dp + 4)
    assert bank.component_operator(2 * dp + 4) is bank.component_operator(
        2 * dp + 4)  # built once
    x, _ = _utt(7, d, 7, seed=1)
    xp = np.zeros((7, dp), np.float64)
    xp[:, :d] = x
    a, b, cw = comp[..., :dp], comp[..., dp:2 * dp], comp[..., 2 * dp]
    got = np.einsum("tj,tskj->tsk", xp,
                    a[None] * xp[:, None, None, :] + b[None]) + cw[None]
    Z = np.concatenate([x * x, x], axis=-1).astype(np.float64)
    want = (Z @ bank.op.numpy().astype(np.float64)
            + bank.cw.numpy()).reshape(7, S, K)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (comp[..., d:dp] == 0).all()
    assert (comp[..., dp + d:2 * dp] == 0).all()
    assert (comp[..., 2 * dp + 1:] == 0).all()


def _counting_plan():
    """A plan maker that records the banks it was asked for: what
    ops/gpu_gmm's wrappers keep of a bank between calls (the component
    rows, their pointer) stands in for a plan made by the card's
    library."""
    made = []

    def make(bank, precision):
        assert precision == "f32"
        comp = bank.component_operator(2 * (-(-bank.dim // 4) * 4) + 4)
        made.append(comp)
        return (comp, comp.data_ptr())
    return make, made


@pytest.mark.parametrize("change", ["op_in_place", "cw_in_place",
                                    "op_replaced", "moved"])
def test_serial_plan_follows_the_bank_parameters(change):
    """GmmBank.scoring_plan is made once per bank and made again, with
    component rows built from the new parameters, after op or cw is written
    to in place, replaced, or moved (Module.to makes new buffers); so is
    component_operator."""
    bank = tgmm.GmmBank.from_numpy(*_bank_np(3, 4, 6, seed=8), device="cpu")
    make, made = _counting_plan()
    first = bank.scoring_plan(make)
    assert bank.scoring_plan(make) is first and len(made) == 1
    row = first[0].shape[-1]
    assert bank.component_operator(row) is first[0]
    if change == "op_in_place":
        bank.op.mul_(2.0)
    elif change == "cw_in_place":
        bank.cw.add_(1.0)
    elif change == "op_replaced":
        bank.op = bank.op * 0.5
    else:
        bank.to(torch.float64)
    again = bank.scoring_plan(make)
    assert again is not first and len(made) == 2
    assert bank.scoring_plan(make) is again and len(made) == 2
    comp = again[0].reshape(-1, row)
    d, dp = bank.dim, (row - 4) // 2
    assert comp.dtype == bank.op.dtype
    assert torch.equal(comp[:, :d], bank.op[:d].T)
    assert torch.equal(comp[:, dp:dp + d], bank.op[d:].T)
    assert torch.equal(comp[:, 2 * dp], bank.cw)


def test_serial_plan_scores_the_changed_bank():
    """After a bank is written to in place, the plain serial score is the
    new bank's (the cached rows are not): a rerun against a fresh bank with
    the same parameters agrees exactly."""
    w, mu, sg = _bank_np(3, 4, 6, seed=9)
    x, mask = _utt(50, 6, 40, seed=10)
    bank = tgmm.GmmBank.from_numpy(w, mu, sg, device="cpu")
    make, _ = _counting_plan()
    bank.scoring_plan(make)
    bank.op.mul_(0.5)
    comp = bank.scoring_plan(make)[0]
    fresh = tgmm.GmmBank(bank.op.clone(), bank.cw.clone(), 3, 4)
    assert torch.equal(comp, fresh.component_operator(comp.shape[-1]))
    got = gpu_gmm.bank_sum_loglik(bank, torch.from_numpy(x),
                                  torch.from_numpy(mask))
    want = gpu_gmm.bank_sum_loglik(fresh, torch.from_numpy(x),
                                   torch.from_numpy(mask))
    assert torch.equal(got, want)


# -- GMMSet: serial scoring and the open set ---------------------------------

def _state(seed, S=3, K=4, d=6):
    w, mu, sg = _bank_np(S + 1, K, d, seed)
    return {"labels": [f"spk{i}" for i in range(S)], "weights": w[:S],
            "means": mu[:S], "sigmas": sg[:S], "reject_threshold": 0.5,
            "ubm_weights": w[S], "ubm_means": mu[S].copy() * 0.2,
            "ubm_sigmas": sg[S] + 1.0}


def _speaker_utts(st, seeds, n=150):
    """Frames drawn near speaker s's component means; s = seed % S."""
    S = len(st["labels"])
    out = []
    for seed in seeds:
        rng = np.random.RandomState(seed)
        mu = st["means"][seed % S]
        comps = rng.randint(0, mu.shape[0], size=n)
        out.append((mu[comps] + 0.3 * rng.randn(n, mu.shape[1]))
                   .astype(np.float32))
    return out


def test_gmmset_serial_and_rejection_match_jax():
    st = _state(10)
    port = GMMSet.from_state(st, device="cpu")
    jax_gs = JGMMSet.from_state(st)
    assert port.gmm_order == jax_gs.gmm_order == 4
    genuine = _speaker_utts(st, [0, 1, 2, 3, 4])
    rng = np.random.RandomState(11)
    imposter = [(rng.randn(120, 6) * 2.5).astype(np.float32)
                for _ in range(4)]
    for x in genuine + imposter:
        np.testing.assert_allclose(port._scores(x), jax_gs._scores(x),
                                   rtol=1e-5)
        s, u = port.llr_scores(x)
        js, ju = jax_gs.llr_scores(x)
        np.testing.assert_allclose(s, js, rtol=1e-5)
        np.testing.assert_allclose(u, ju, rtol=1e-5)
        assert port.predict_one_with_rejection(x) == \
            jax_gs.predict_one_with_rejection(x)
    assert port.predict(genuine) == jax_gs.predict(genuine) == \
        ["spk0", "spk1", "spk2", "spk0", "spk1"]
    assert port.predict_one_scores(genuine[0]) == pytest.approx(
        jax_gs.predict_one_scores(genuine[0]), rel=1e-5)
    for target in ("eer", "far"):
        op = port.calibrate_rejection(genuine, imposter, target=target,
                                      max_far=0.25)
        jop = jax_gs.calibrate_rejection(genuine, imposter, target=target,
                                         max_far=0.25)
        assert op["threshold"] == pytest.approx(jop["threshold"], rel=1e-4)
        assert (op["far"], op["frr"]) == (jop["far"], jop["frr"])
        assert port.predict_with_reject(genuine + imposter) == \
            jax_gs.predict_with_reject(genuine + imposter)
    assert port.state()["reject_threshold"] == port.reject_threshold


def test_gmmset_pads_to_the_frame_bucket():
    st = _state(20)
    port = GMMSet.from_state(st, device="cpu")
    x = _speaker_utts(st, [1], n=SCORE_FRAME_BUCKET + 7)[0]
    Xp, mask = port._utterance(x)
    assert Xp.shape == (2 * SCORE_FRAME_BUCKET, 6) and int(mask.sum()) == 263
    tb = tgmm.GmmBank.from_numpy(st["weights"], st["means"], st["sigmas"],
                                 device="cpu")
    exact = tgmm.bank_avg_loglik(tb, torch.from_numpy(x),
                                 torch.ones(len(x), dtype=torch.bool))
    np.testing.assert_allclose(port._scores(x), exact.numpy(), rtol=1e-6)


def test_gmmset_preconditions():
    st = _state(30)
    no_ubm = {k: v for k, v in st.items() if not k.startswith("ubm")}
    gs = GMMSet.from_state(no_ubm, device="cpu")
    x = _speaker_utts(st, [0])[0]
    with pytest.raises(RuntimeError, match="UBM must be given"):
        gs.predict_one_with_rejection(x)
    with pytest.raises(RuntimeError, match="requires a UBM"):
        gs.calibrate_rejection([x], [x])
    with pytest.raises(RuntimeError, match="train"):
        GMMSet(device="cpu").predict_one(x)
    # k-means|| seeding trains since it was ported (no longer refused)
    g = GMMSet(config=GmmConfig(n_mixtures=2, init_with_kmeans=True),
               device="cpu")
    g.fit_new(x, "a")
    g.train()
    assert g.params.means.shape == (1, 2, x.shape[1])
    assert g.train_log["kmeans_iterations"] >= 1
    # a UBM fixes the order (gmmset.py:24-27)
    ubm = tgmm.GmmParams(st["ubm_weights"], st["ubm_means"],
                         st["ubm_sigmas"])
    assert GMMSet(gmm_order=32, ubm=ubm, device="cpu").gmm_order == 4


def test_gmmset_fit_and_load_gmm(tmp_path):
    st = _state(40, S=2, K=2)
    utts = _speaker_utts(st, [0, 1, 2, 3], n=200)
    gs = GMMSet(gmm_order=2, dtype="float64",
                config=GmmConfig(n_mixtures=2, n_iterations=30),
                device="cpu")
    gs.fit(utts, ["a", "b", "a", "b"])
    assert gs.y == ["a", "b"] and gs.params.means.shape == (2, 2, 6)
    assert gs.bank.op.dtype == torch.float64
    assert gs.predict(utts) == ["a", "b", "a", "b"]
    path = str(tmp_path / "c.gmm")
    with open(path, "w") as f:
        serialization.dump_reference_gmm(
            tgmm.GmmParams(*(a[1] for a in gs.params)), f)
    gs.load_gmm("c", path)
    assert gs.y == ["a", "b", "c"]
    np.testing.assert_array_equal(gs.params.means[2], gs.params.means[1])
    assert gs.bank.n_speakers == 3


# -- reference text format ---------------------------------------------------

def test_reference_gmm_text_round_trip_both_packages():
    w, mu, sg = (a[0].astype(np.float64) for a in _bank_np(1, 3, 4, seed=5))
    port_text = serialization.dumps_reference_gmm(tgmm.GmmParams(w, mu, sg))
    jax_text = jser.dumps_reference_gmm(jgmm.GmmParams(w, mu, sg))
    assert port_text == jax_text
    for parsed in (jser.loads_reference_gmm(port_text),
                   serialization.loads_reference_gmm(jax_text)):
        for a, b in zip(parsed, (w, mu, sg)):
            np.testing.assert_array_equal(np.asarray(a), b)
    buf = io.StringIO(port_text.replace("4 1\n", "4 0\n", 1))
    with pytest.raises(ValueError, match="covariance"):
        serialization.load_reference_gmm(buf)


# -- the serial kernel's wrapper off the card --------------------------------

class _CudaTyped(torch.Tensor):
    @property
    def device(self):
        return torch.device("cuda", 0)


def test_serial_cuda_request_raises_without_cuda():
    """On a CUDA tensor the serial wrapper launches its kernel or raises;
    it never runs the plain version."""
    bank = tgmm.GmmBank.from_numpy(*_bank_np(2, 4, 5, seed=6), device="cpu")
    x, mask = _utt(20, 5, 12, seed=7)
    cuda = lambda t: t.as_subclass(_CudaTyped)  # noqa: E731
    bank.op, bank.cw = cuda(bank.op), cuda(bank.cw)
    before = gpu_gmm.SERIAL_LAUNCHES
    for fn in (gpu_gmm.bank_sum_loglik, gpu_gmm.bank_avg_loglik):
        with pytest.raises(RuntimeError):
            fn(bank, cuda(torch.from_numpy(x)), cuda(torch.from_numpy(mask)))
        with pytest.raises(ValueError, match="mask"):
            fn(bank, cuda(torch.from_numpy(x)),
               cuda(torch.from_numpy(mask[:5])))
    assert gpu_gmm.SERIAL_LAUNCHES == before
    meta = torch.zeros(3, 5, device="meta")
    with pytest.raises(ValueError, match="device"):
        gpu_gmm.bank_avg_loglik(bank, meta, meta[:, 0].bool())


# -- mix_feature -------------------------------------------------------------

@pytest.mark.parametrize("which", ["mix", "mix_deltas", "mfcc", "lpc"])
def test_mix_feature_matches_jax(which):
    sig = synth.synth_utterance("bob", 1.3, seed=3)
    if which == "mix":
        got = extract.mix_feature(synth.FS, sig, device="cpu")
        want = jextract.mix_feature(synth.FS, sig)
    elif which == "mix_deltas":
        got = extract.mix_feature(synth.FS, sig, FeatureConfig(n_deltas=2),
                                  device="cpu")
        from speaker_recognition_tpu.config import FeatureConfig as JF
        want = jextract.mix_feature(synth.FS, sig, JF(n_deltas=2))
    elif which == "mfcc":
        got = extract.mfcc_extract(synth.FS, sig, MfccConfig(), device="cpu")
        want = jextract.mfcc_extract(synth.FS, sig)
    else:
        got = extract.lpc_extract(synth.FS, sig, LpcConfig(), device="cpu")
        want = jextract.lpc_extract(synth.FS, sig)
    assert got.shape == want.shape and got.dtype == np.float32
    # tests/test_torch_frontend.py's bound for the f32 frontends
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=2e-3)


def test_mix_feature_channels_and_short_signals():
    sig = synth.synth_utterance("alice", 0.8, seed=4).astype(np.float64)
    stereo = np.stack([sig, 0.5 * sig], axis=1)
    np.testing.assert_allclose(extract.mix_feature(synth.FS, stereo,
                                                   device="cpu"),
                               extract.mix_feature(synth.FS, 0.75 * sig,
                                                   device="cpu"),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="Signal too short!"):
        extract.mix_feature(synth.FS, np.zeros(5 * 256), device="cpu")
    # float64 is served (the plain versions, tests/test_torch_f64.py);
    # another dtype is refused, naming the two
    assert extract.mix_feature(synth.FS, sig, dtype="float64",
                               device="cpu").dtype == np.float64
    with pytest.raises(ValueError, match="float32 or float64"):
        extract.mix_feature(synth.FS, sig, dtype="float16", device="cpu")
