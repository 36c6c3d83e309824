"""End-to-end JFA on top of the UBM, the counterpart of
speaker_recognition_tpu/tools/jfa_pipeline.py (the reference's MATLAB
chain of scripts gen-features-file.py -> sc_compute_suf_stats ->
train_all.m -> sc_score_dot_product).

  1. collect_session_stats: per-utterance Baum-Welch stats against the UBM
     (models/jfa.collect_stats over padded sessions, on the device);
  2. train_jfa: v (eigenvoices) -> u (eigenchannels, y fixed) -> d
     (residual), train_all.m's order, with the reference's random inits
     and a divergence guard;
  3. enroll / score: speaker factors of the enrollment stats, channel
     factors of the test stats, then one linear-scoring matmul.

The model npz (m, E, v, u, d, n_components) and the UBM supervector
directory (utils/serialization.dump_jfa_supervectors) are the JAX
package's: a model trained by either package scores in the other.

    python -m speaker_recognition_tpu_torch.tools.jfa_pipeline \\
        gen-features -i "<dir>/alice <dir>/bob" -o <feats> [--device cuda]

then `stats`, `train` and `score` (see main). Every stage runs on
`--device` (the card by default).

Where the JAX package's divergence guard goes wrong, this one does not
copy it (ROADMAP.md queue 3):
  * it gates on divergence, not on rank-limited accuracy: a model has
    diverged when a self-score is not finite or its self-consistency is at
    most twice chance (2 / n_speakers, with more than two speakers); a
    healthy low-rank model that separates its training speakers less than
    perfectly is kept, not retrained;
  * n_speakers is the number of distinct speaker ids, not max() + 1;
  * each retry draws its inits from SeedSequence([seed, attempt]), so no
    (seed, attempt) pair shares another's draws.
"""

from __future__ import annotations

import argparse
import glob as globmod
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from ..models import gmm, jfa
from ..models.gmmset import _pad_stack
from ..utils import serialization

__all__ = ["JfaModel", "collect_session_stats", "train_jfa", "enroll",
           "score", "load_lst_features", "save_model", "load_model",
           "diverged", "attempt_generators", "main"]


class JfaModel(NamedTuple):
    hyper: jfa.JfaHyper
    n_components: int


def collect_session_stats(ubm: gmm.GmmParams, feature_arrays,
                          device: torch.device | str = "cuda"):
    """[per-session [T_i, d] features] -> (N [S, K], F [S, K*d]) float32
    tensors on `device`."""
    Xs, masks = _pad_stack([np.asarray(f) for f in feature_arrays])
    X = torch.as_tensor(Xs, dtype=torch.float32, device=device)
    mask = torch.as_tensor(masks, device=device)
    return jfa.collect_stats(gmm.params_to(ubm, torch.float32, device), X,
                             mask)


def diverged(scores: torch.Tensor, ids: torch.Tensor) -> tuple[bool, float]:
    """(whether a model diverged, its self-consistency accuracy) from its
    self-scores [n_speakers, n_sessions] of its training sessions: a
    non-finite score, or (past two speakers) an accuracy of at most twice
    chance, 2 / n_speakers."""
    n = scores.shape[0]
    if not bool(torch.isfinite(scores).all()):
        return True, 0.0
    acc = float((scores.argmax(dim=0) == ids).to(torch.float64).mean())
    return n > 2 and acc <= 2.0 / n, acc


def attempt_generators(seed: int, attempt: int):
    """The (v, u) init generators of one training attempt, from
    SeedSequence([seed, attempt]): distinct for every (seed, attempt)."""
    states = np.random.SeedSequence([seed, attempt]).generate_state(2)
    return tuple(torch.Generator().manual_seed(int(s)) for s in states)


def train_jfa(ubm: gmm.GmmParams, N, F, spk_ids, nv: int = 4, nu: int = 2,
              n_iter: int = 20, train_d: bool = False, seed: int = 0,
              retries: int = 3, inits=None,
              device: torch.device | str = "cuda",
              log: dict | None = None) -> JfaModel:
    """Train eigenvoices, eigenchannels and (with train_d) the residual
    diagonal from session stats N [S, K], F [S, K*d] and speaker ids
    (0 .. n-1; models/jfa). Defaults nv=4/nu=2 mirror the shipped scoring
    config (kscore_famous_19.m).

    Divergence guard: after training, the model scores its own training
    sessions (enroll every training speaker, score the same sessions);
    when that diverged (`diverged`: a non-finite score, or an accuracy of
    at most 2 / n_speakers with more than two speakers), training runs
    again from the next attempt's inits, at most `retries` attempts in
    all, and the most self-consistent model is returned. Attempt a draws
    from attempt_generators(seed, a); `inits` = (v0, u0) replaces the
    first attempt's draws (a test feeds the JAX package's). `log`, if
    given, receives the attempts and each one's accuracy."""
    K = int(np.asarray(ubm.weights).shape[-1])
    f32 = dict(dtype=torch.float32, device=device)
    m = torch.as_tensor(np.asarray(ubm.means).reshape(-1), **f32)
    E = torch.as_tensor((np.asarray(ubm.sigmas, np.float64) ** 2)
                        .reshape(-1), **f32)
    N = torch.as_tensor(N, **f32)
    F = torch.as_tensor(F, **f32)
    ids = torch.as_tensor(np.asarray(torch.as_tensor(spk_ids).cpu()),
                          dtype=torch.int64, device=device)
    n_spk = jfa.n_speakers(ids)
    best, best_acc, accs = None, -1.0, []
    for attempt in range(max(1, retries)):
        gv, gu = attempt_generators(seed, attempt)
        v0, u0 = inits if (attempt == 0 and inits is not None) else (None,
                                                                     None)
        v, y = jfa.train_v(F, N, m, E, nv, ids, K, n_iter, gv, v0)
        u, x = jfa.train_u(F, N, m, E, v, y, nu, ids, K, n_iter, gu, u0)
        d = (jfa.train_d(F, N, m, E, v, u, y, x, ids, K, n_iter)[0]
             if train_d else F.new_zeros(m.shape[-1]))
        model = JfaModel(jfa.JfaHyper(m=m, E=E, v=v, u=u, d=d), K)
        yy, zz = enroll(model, N, F, ids, n_spk)
        bad, acc = diverged(score(model, yy, zz, N, F), ids)
        accs.append(acc)
        if acc > best_acc or best is None:
            best, best_acc = model, acc
        if not bad:
            break
    else:
        print(f"jfa_pipeline.train_jfa: every one of {len(accs)} attempts "
              f"diverged (self-consistency {accs}); returning the best",
              file=sys.stderr)
    if log is not None:
        log.update(attempts=len(accs), self_consistency=accs)
    return best


def enroll(model: JfaModel, N, F, spk_ids, n_spk: int):
    """Speaker factors (y [n_spk, nv], z [n_spk, D]) of enrollment
    sessions, on the model's device."""
    h = model.hyper
    f32 = dict(dtype=torch.float32, device=h.m.device)
    N = torch.as_tensor(N, **f32)
    F = torch.as_tensor(F, **f32)
    ids = torch.as_tensor(spk_ids, dtype=torch.int64, device=h.m.device)
    x0 = F.new_zeros((N.shape[0], h.u.shape[0]))
    z0 = F.new_zeros((n_spk, h.D))
    K = model.n_components
    y, _, _ = jfa.estimate_y(F, N, h, x0, z0, ids, K, n_spk)
    z, _, _ = jfa.estimate_z(F, N, h, x0, y, ids, K, n_spk)
    return y, z


def score(model: JfaModel, y, z, N_test, F_test) -> torch.Tensor:
    """[n_models, n_test] channel-compensated linear scores."""
    h = model.hyper
    f32 = dict(dtype=torch.float32, device=h.m.device)
    N_test = torch.as_tensor(N_test, **f32)
    F_test = torch.as_tensor(F_test, **f32)
    n_test = N_test.shape[0]
    # each test session's channel factors, its speaker part unknown (0)
    test_ids = torch.arange(n_test, device=h.m.device)
    y0 = F_test.new_zeros((n_test, h.v.shape[0]))
    z0 = F_test.new_zeros((n_test, h.D))
    K = model.n_components
    x, _, _ = jfa.estimate_x(F_test, N_test, h, y0, z0, test_ids, K)
    return jfa.linear_scores(F_test, N_test, h, y, z, x, K)


def save_model(path: str, model: JfaModel):
    """The model npz both packages read: m, E, v, u, d, n_components."""
    np.savez(path, n_components=model.n_components,
             **jfa.hyper_numpy(model.hyper))


def load_model(path: str, device: torch.device | str = "cuda") -> JfaModel:
    """A model npz written by either package."""
    z = np.load(_npz(path))
    return JfaModel(jfa.hyper_from_numpy(z, device=device),
                    int(z["n_components"]))


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def load_lst_features(lst_path: str):
    """A `logical=physical` manifest (src/jfa/parse_list.m) and its
    per-utterance feature text files -> (labels [S], feature arrays)."""
    pairs = serialization.read_lst(lst_path)
    return ([p[0] for p in pairs],
            [serialization.read_feature_text(p[1]) for p in pairs])


def _speaker_ids(labels):
    """(sorted distinct labels, [S] ids 0 .. n-1)."""
    order = sorted(set(labels))
    index = {label: i for i, label in enumerate(order)}
    return order, np.asarray([index[label] for label in labels], np.int64)


def main(argv=None):
    """The JFA chain over the reference's text interchange formats (feature
    text, .lst manifests, the UBM supervector directory):

      gen-features  wav dirs -> feature text + <task>.lst (mix_feature, K1
                    on the card; src/test/gen-features-file.py)
      stats         UBM + .lst -> N/F stats npz (sc_compute_suf_stats.m)
      train         stats -> JFA model npz (train_all.m)
      score         model + enroll/test stats -> a line per test session
                    (sc_score_dot_product.m / linear_scoring.m)
    """
    ap = argparse.ArgumentParser(description="JFA pipeline over the "
                                 "reference's text interchange formats")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gen-features", help="wav dirs -> feature text + lst")
    g.add_argument("-i", "--input", required=True,
                   help="space-separated wav dirs; label = dir basename")
    g.add_argument("-o", "--output-dir", required=True)
    g.add_argument("--task", default="train", help="manifest name (<task>.lst)")

    s = sub.add_parser("stats", help="Baum-Welch N/F stats against the UBM")
    s.add_argument("--ubm-dir", required=True,
                   help="directory holding ubm_means/ubm_variances/ubm_weights")
    s.add_argument("--lst", required=True)
    s.add_argument("-o", "--output", required=True, help="stats npz path")

    t = sub.add_parser("train", help="train v/u/(d) from stats")
    t.add_argument("--ubm-dir", required=True)
    t.add_argument("--stats", required=True)
    t.add_argument("-o", "--output", required=True, help="model npz path")
    t.add_argument("--nv", type=int, default=4)
    t.add_argument("--nu", type=int, default=2)
    t.add_argument("--iters", type=int, default=20)
    t.add_argument("--train-d", action="store_true")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--retries", type=int, default=3,
                   help="training attempts in all for the divergence guard")

    c = sub.add_parser("score", help="channel-compensated linear scores")
    c.add_argument("--ubm-dir", required=True)
    c.add_argument("--model", required=True)
    c.add_argument("--enroll-stats", required=True)
    c.add_argument("--test-stats", required=True)
    for p in (g, s, t, c):
        p.add_argument("--device", default="cuda",
                       help="torch device the stage runs on (cuda or cpu)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    if args.cmd == "gen-features":
        from ..features.extract import mix_feature
        from ..utils.native_io import read_wav

        os.makedirs(args.output_dir, exist_ok=True)
        pairs = []
        for d in args.input.split():
            label = os.path.basename(os.path.normpath(d))
            for wav in sorted(globmod.glob(os.path.join(d, "*.wav"))):
                fs, sig = read_wav(wav)
                fname = os.path.join(args.output_dir,
                                     f"{args.task}-{label}-{len(pairs)}")
                serialization.write_feature_text(
                    fname, mix_feature(fs, sig, device=device))
                pairs.append((label, fname))
        serialization.write_lst(
            os.path.join(args.output_dir, args.task + ".lst"), pairs)
        print(f"wrote {len(pairs)} feature files + {args.task}.lst")
        return

    ubm = serialization.load_jfa_supervectors(args.ubm_dir)
    if args.cmd == "stats":
        labels, feats = load_lst_features(args.lst)
        N, F = collect_session_stats(ubm, feats, device)
        np.savez(args.output, N=N.cpu().numpy(), F=F.cpu().numpy(),
                 labels=np.asarray(labels))
        print(f"stats for {len(labels)} sessions -> {args.output}")
    elif args.cmd == "train":
        z = np.load(_npz(args.stats))
        _, spk_ids = _speaker_ids([str(v) for v in z["labels"]])
        model = train_jfa(ubm, z["N"], z["F"], spk_ids, nv=args.nv,
                          nu=args.nu, n_iter=args.iters,
                          train_d=args.train_d, seed=args.seed,
                          retries=args.retries, device=device)
        save_model(args.output, model)
        print(f"JFA model (nv={args.nv}, nu={args.nu}) -> {args.output}")
    elif args.cmd == "score":
        model = load_model(args.model, device)
        ez, tz = np.load(_npz(args.enroll_stats)), np.load(_npz(
            args.test_stats))
        speakers, spk_ids = _speaker_ids([str(v) for v in ez["labels"]])
        y, zf = enroll(model, ez["N"], ez["F"], spk_ids, len(speakers))
        scores = score(model, y, zf, tz["N"], tz["F"]).cpu().numpy()
        for j, tl in enumerate(str(v) for v in tz["labels"]):
            best = int(np.argmax(scores[:, j]))
            print(f"{tl} -> {speakers[best]} "
                  f"({' '.join('%.4f' % v for v in scores[:, j])})")


if __name__ == "__main__":
    main()
