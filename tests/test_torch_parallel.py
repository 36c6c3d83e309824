"""speaker_recognition_tpu_torch's multi-device programs (parallel/mesh,
seqshard, multihost, entry, launch and tools/ubm.train_ubm(mesh=...)) on
the CPU with gloo across processes, through the port's launcher: a
2-process run against the 1-process run; the 2-process results against
the JAX package's programs on a 2-device virtual mesh, in-process, as
tests/test_parallel.py runs them; the sequence-sharded features against
the port's features/extract.mix_feature (not the JAX seqshard, which
ignores f_max, preemph_first, n_lpcc and n_deltas)."""

import os
import socket
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from speaker_recognition_tpu.config import (  # noqa: E402
    GmmConfig as JGmmConfig)
from speaker_recognition_tpu.models import gmm as jgmm  # noqa: E402
from speaker_recognition_tpu.parallel import mesh as jmesh  # noqa: E402
from speaker_recognition_tpu_torch.features import extract  # noqa: E402
from speaker_recognition_tpu_torch.models import gmm as tgmm  # noqa: E402
from speaker_recognition_tpu_torch.parallel import launch  # noqa: E402
from speaker_recognition_tpu_torch.tools import ubm  # noqa: E402

HERE = os.path.dirname(os.path.realpath(__file__))
sys.path.insert(0, HERE)
import torch_parallel_workers as W  # noqa: E402

# a rendezvous can hang: each run is killed past this many seconds
TIMEOUT = 120
# 2 processes against 1, and against the JAX mesh: f32 sums of 203
# frames' statistics split in other places (~1e-6 relative measured)
RTOL = 1e-4
# features: mix_feature's plain versions per rank, CMVN's sums over the
# ranks in another order (~1e-6 measured on O(1) cepstra, O(1e2) LPCC)
FEAT_RTOL, FEAT_ATOL = 1e-4, 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{1: rank 0's results of a 1-process run, 2: both ranks' of a
    2-process run}, gloo on the CPU."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    return {n: launch.run(n, "torch_parallel_workers:run_all",
                          {"tmp": tmp, "device": "cpu"}, device="cpu",
                          timeout=TIMEOUT, path=[HERE])
            for n in (1, 2)}


def _close(a, b, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def test_every_rank_holds_the_same_results(runs):
    r0, r1 = runs[2]
    assert (r0["rank"], r1["rank"]) == (0, 1) and r0["threads"] == 2
    for key in ("em_step", "fit", "ubm", "ubm_ckpt"):
        for a, b in zip(r0[key], r1[key]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(r0["scores"], r1["scores"])
    for name in W.SEQ_CASES:
        np.testing.assert_array_equal(r0["seq"][name], r1["seq"][name])


def _em_step_unsharded():
    p = tgmm.GmmParams(*(torch.from_numpy(a)[None] for a in W.gmm_params()))
    X = torch.from_numpy(W.frames())[None]
    m = torch.from_numpy(W.em_mask())[None]
    new = tgmm.m_step(tgmm.sufficient_stats(p, X, m), W.CFG)
    return [a[0].numpy() for a in new]


def test_sharded_em_step(runs):
    """2 processes against 1, 1 against the unsharded step, and the JAX
    sharded_em_step on a 2-device 'data' mesh."""
    two, one = runs[2][0]["em_step"], runs[1][0]["em_step"]
    jax_step = jmesh.sharded_em_step(jmesh.make_mesh(
        data=2, bank=1, devices=jax.devices()[:2]), JGmmConfig(n_mixtures=4))
    Xp, mp = jmesh.pad_frames_for_mesh(W.frames(), W.em_mask(), 2)
    want = jax_step(jgmm.GmmParams(*map(jnp.asarray, W.gmm_params())),
                    jnp.asarray(Xp), jnp.asarray(mp))
    for a, b, c, d in zip(two, one, _em_step_unsharded(), want):
        _close(a, b)
        _close(b, c)
        _close(a, d)


def test_sharded_fit(runs):
    """sharded_fit (the port's EM loop with a reduce hook over the mesh)
    on 2 processes against 1 and against gmm.fit, and against the JAX
    package's EM sharded over a 2-device mesh from the port's init (the
    JAX fit draws its init from a jax key)."""
    X = W.frames()
    mask = np.ones(len(X), bool)
    got = runs[2][0]
    want, ll = tgmm.fit(torch.from_numpy(X)[None],
                        torch.from_numpy(mask)[None], W.CFG, 0)
    for a, b, c in zip(got["fit"], runs[1][0]["fit"], want):
        _close(a, b)
        _close(b, c[0].numpy())
    _close(got["fit_ll"], runs[1][0]["fit_ll"])
    _close(runs[1][0]["fit_ll"], float(ll[0]))
    init = tgmm.init_params(torch.from_numpy(X)[None],
                            torch.from_numpy(mask)[None], 4, 0)
    m = jmesh.make_mesh(data=2, bank=1, devices=jax.devices()[:2])
    shard = NamedSharding(m, P("data", None))
    fit = jax.jit(lambda X, mask, p0: jgmm.fit_from_params(
        X, mask, p0, JGmmConfig(n_mixtures=4, n_iterations=20)),
        in_shardings=(shard, NamedSharding(m, P("data")),
                      NamedSharding(m, P())))
    Xp, mp = jmesh.pad_frames_for_mesh(X, mask, 2)
    jp, jll = fit(jnp.asarray(Xp), jnp.asarray(mp), jgmm.GmmParams(
        *(jnp.asarray(a[0].numpy()) for a in init)))
    for a, b in zip(got["fit"], jp):
        _close(a, b, rtol=1e-3, atol=1e-4)
    _close(got["fit_ll"], jll, rtol=1e-5)


def test_sharded_bank_scores(runs):
    """Each process scores its half of the bank (K3's plain version here),
    the halves all_gathered: against 1 process, the unsharded scoring and
    the JAX sharded_bank_scores on a 2-device 'bank' mesh; the same
    argmax."""
    two, one = runs[2][0]["scores"], runs[1][0]["scores"]
    bank = W.bank_params()
    Xt, mt = W.frames(50, seed=5), np.arange(50) < 41
    plain = tgmm.bank_avg_loglik(tgmm.GmmBank.from_numpy(*bank, "cpu"),
                                 torch.from_numpy(Xt), torch.from_numpy(mt))
    score = jmesh.sharded_bank_scores(jmesh.make_mesh(
        data=1, bank=2, devices=jax.devices()[:2]))
    want = np.asarray(score(jgmm.GmmParams(*map(jnp.asarray, bank)),
                            jnp.asarray(Xt), jnp.asarray(mt)))
    assert two.shape == (4,)
    _close(two, one, rtol=1e-6)
    _close(one, plain.numpy(), rtol=1e-6)
    _close(two, want, rtol=1e-5)
    assert two.argmax() == one.argmax() == want.argmax()


def test_train_ubm_over_a_mesh(runs):
    """train_ubm(mesh=...) no longer raises: 2 processes against 1 and
    against train_ubm() on one device; the checkpointed run too, its
    file written by rank 0."""
    parts = [W.frames()[:120], W.frames()[120:]]
    want = ubm.train_ubm(parts, n_mixtures=4, n_iterations=12,
                         device="cpu")
    for key in ("ubm", "ubm_ckpt"):
        for a, b, c in zip(runs[2][0][key], runs[1][0][key], want):
            _close(a, b)
            _close(b, c)
    assert runs[2][0]["ubm_ckpt_file"] and runs[1][0]["ubm_ckpt_file"]


def test_dryrun_multichip(runs):
    """One sharded training step (EM over 'data', MAP over 'bank', scoring
    over 'bank', a full sharded fit): 2 processes on a 1 x 2 mesh against
    1 process; the EM step and the scores against the JAX programs on a
    2-device mesh given the same inputs. (The 2 x 1 mesh's sharded EM and
    fit are test_sharded_em_step's and test_sharded_fit's.)"""
    one, got = runs[1][0]["dryrun"], runs[2][0]["dryrun"]
    for key in ("ubm_means", "ubm_weights", "bank_means", "scores",
                "fit_means"):
        _close(got[key], one[key], atol=1e-5)
    assert got["argmax"] == one["argmax"]
    _close(got["fit_ll"], one["fit_ll"])
    rng = np.random.RandomState(0)
    cfg = JGmmConfig(n_mixtures=8)
    ubm0 = jgmm.GmmParams(jnp.full((8,), 1 / 8, jnp.float32),
                          jnp.asarray(rng.randn(8, 12).astype(np.float32)),
                          jnp.asarray((0.5 + rng.rand(8, 12)).astype(
                              np.float32)))
    X = rng.randn(64, 12).astype(np.float32)
    m = jmesh.make_mesh(data=2, bank=1, devices=jax.devices()[:2])
    new = jmesh.sharded_em_step(m, cfg)(ubm0, jnp.asarray(X),
                                        jnp.ones(64, bool))
    _close(one["ubm_means"], new.means, atol=1e-5)
    bank = jgmm.GmmParams(
        jnp.broadcast_to(new.weights, (4, 8)),
        jnp.asarray(got["bank_means"]),
        jnp.broadcast_to(new.sigmas, (4, 8, 12)))
    rng.randn(4, 64, 12)  # the speakers' frames, drawn before the tests'
    test_X = rng.randn(48, 12).astype(np.float32)
    scores = jmesh.sharded_bank_scores(jmesh.make_mesh(
        data=1, bank=2, devices=jax.devices()[:2]))(
        bank, jnp.asarray(test_X), jnp.ones(48, bool))
    _close(got["scores"], scores, rtol=1e-5)
    assert got["argmax"] == int(np.argmax(np.asarray(scores)))


@pytest.mark.parametrize("name", sorted(W.SEQ_CASES))
def test_seqshard_matches_mix_feature(runs, name):
    """The frame axis of one utterance over 2 processes and over 1,
    against the port's mix_feature at the same config: bob's MFCC
    (f_max, preemph_first), LPC cepstra, two deltas, and a ragged length
    on the full-spectrum route."""
    fs, cfg, L = W.SEQ_CASES[name]
    want = extract.mix_feature(fs, W.signal(fs, L), cfg, device="cpu")
    for n in (1, 2):
        got = runs[n][0]["seq"][name]
        assert got.shape == want.shape, (n, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=FEAT_RTOL,
                                   atol=FEAT_ATOL)


def test_launcher_reports_each_configuration(capsys):
    """`python -m ...parallel.launch` prints one JSON row per process count
    (scaling_report: the EM and bank-scoring rates over the group)."""
    import json

    launch.main(["--configs", "2", "--device", "cpu", "--frames", "512",
                 "--timeout", str(TIMEOUT)])
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(rows) == 1 and rows[0]["processes"] == 2
    assert rows[0]["backend"] == "gloo" and rows[0]["em_workload_frames"] \
        == 1024
    assert rows[0]["em_audio_s_per_s"] > 0 and rows[0]["score_ms"] > 0


def test_launcher_kills_a_run_past_its_timeout():
    """Ranks that outlive the run's timeout are killed, and the run
    raises."""
    import subprocess

    with pytest.raises(subprocess.TimeoutExpired):
        launch.run(2, "torch_parallel_workers:sleep", {"seconds": 60},
                   device="cpu", timeout=5, path=[HERE])


@pytest.fixture
def port_thief(monkeypatch):
    """A neighbour that takes every port a Python socket had bound the
    moment the socket closes (and listens on it): what another process may
    do between a free-port pick (bind port 0, read the port, close) and
    the later bind of that port. Its listeners close afterwards."""
    held = []
    close = socket.socket.close

    def close_and_take(self):
        try:
            port = (self.getsockname()[1]
                    if self.family == socket.AF_INET else 0)
        except OSError:
            port = 0
        close(self)
        if port:
            thief = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            try:
                thief.bind(("localhost", port))
                thief.listen()
                held.append(thief)
            except OSError:
                close(thief)

    monkeypatch.setattr(socket.socket, "close", close_and_take)
    yield held
    monkeypatch.undo()
    for t in held:
        t.close()


def test_initialize_alone_leaves_no_port_to_take(port_thief):
    """One process by itself rendezvouses through a store that binds its
    own port, so a neighbour that takes released ports cannot break it (a
    port picked, released and bound later by the tcp:// rendezvous could be
    taken in between: the full suite's intermittent failure of the
    rehearsal's phase 20)."""
    import torch.distributed as dist

    from speaker_recognition_tpu_torch.parallel import multihost

    multihost.initialize(None, 1, 0, device="cpu")
    try:
        t = torch.ones(3)
        dist.all_reduce(t)
        assert dist.get_world_size() == 1 and torch.equal(t, torch.ones(3))
    finally:
        dist.destroy_process_group()


def test_launcher_leaves_no_port_to_take(port_thief):
    """The launcher hosts its ranks' store on a port the store binds
    itself before any rank starts, so a neighbour that takes released
    ports cannot take the rendezvous's."""
    got = launch.run(2, "torch_parallel_workers:group", device="cpu",
                     timeout=TIMEOUT, path=[HERE])
    assert got == [(0, 2, 1.0), (1, 2, 1.0)]
