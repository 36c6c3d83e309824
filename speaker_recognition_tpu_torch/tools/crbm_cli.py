#!/usr/bin/env python3
"""Per-speaker CRBM train/test driver, the reference's nn binary
(src/nn/src/main.cc), as in speaker_recognition_tpu/tools/crbm_cli.py:
read svm-format data (label = speaker id), train one CRBM per speaker as
one bank (the reference fans this out over 8 threads, main.cc:500-518),
classify test instances by argmin reconstruction error (main.cc:453-465)
and print the accuracy (overall_test, main.cc:547-553).

    python -m speaker_recognition_tpu_torch.tools.crbm_cli train \\
        -i train.svm -m bank.npz --hidden 32 --epochs 100 [--device cpu]
    python -m speaker_recognition_tpu_torch.tools.crbm_cli test \\
        -i test.svm -m bank.npz

The bank npz (labels and the CrbmParams fields, each [S, ...]) is the JAX
package's file, and `--text-dir` writes the reference's text models
(crbm.<label>.model), so a bank trained by either package is tested by the
other. `test` reads either.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def _save_bank(path, labels, bank):
    np.savez(path, labels=np.asarray(labels),
             **{k: v.detach().cpu().numpy()
                for k, v in bank._asdict().items()})


def _load_bank(path: str, device):
    """(labels, float32 bank) from a bank npz or a directory of
    crbm.<label>.model text models."""
    from ..models import crbm
    from ..utils import serialization

    if os.path.isdir(path):
        labels, parts = [], []
        for p in sorted(glob.glob(os.path.join(path, "crbm.*.model"))):
            labels.append(int(os.path.basename(p).split(".")[1]))
            with open(p) as f:
                parts.append(serialization.load_reference_crbm(f))
        fields = {k: np.stack([getattr(q, k) for q in parts])
                  for k in crbm.CrbmParams._fields}
    else:
        z = np.load(path if str(path).endswith(".npz") else path + ".npz")
        labels = [int(v) for v in z["labels"]]
        fields = {k: z[k] for k in crbm.CrbmParams._fields}
    return labels, crbm.CrbmParams(**{
        k: torch.as_tensor(v, dtype=torch.float32, device=device)
        for k, v in fields.items()})


def instance_errors(bank, X: torch.Tensor) -> torch.Tensor:
    """[S, n] reconstruction errors of each instance (row of X [n, nv])
    against each speaker: crbm.reconstruction_error of every one-frame
    utterance at once."""
    from ..models import crbm

    V = crbm.sample_visible(bank, crbm.sample_hidden(bank, X))
    return ((X - V) ** 2).sum(dim=-1)


def main(argv=None):
    ap = argparse.ArgumentParser(description="CRBM speaker modeling")
    ap.add_argument("task", choices=["train", "test"])
    ap.add_argument("-i", "--input", required=True, help="svm-format data")
    ap.add_argument("-m", "--model", required=True,
                    help="model npz file (test: or a directory of text "
                    "models)")
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--cd-k", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-every", type=int, default=0, metavar="N",
                    help="checkpoint the model every N epochs during "
                    "training (the reference's nr_epoch_save, "
                    "crbm.cc:370-376); resumable and bit-identical to a "
                    "monolithic run")
    ap.add_argument("--text-dir", default=None, metavar="DIR",
                    help="also dump per-speaker models in the reference's "
                    "CRBM text format (crbm.cc:238-263) as "
                    "DIR/crbm.<label>.model")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    from ..models import crbm
    from ..utils import datamanip, serialization

    X, y = datamanip.read_svm_data(args.input)
    labels = sorted(set(int(v) for v in y))

    if args.task == "train":
        groups = [X[y == label] for label in labels]
        n_max = max(len(g) for g in groups)
        S = len(labels)
        Xs = np.zeros((S, n_max, X.shape[1]), np.float32)
        masks = np.zeros((S, n_max), bool)
        for i, g in enumerate(groups):
            Xs[i, :len(g)] = g
            masks[i, :len(g)] = True
        cfg = crbm.CrbmTrainConfig(n_epochs=args.epochs,
                                   batch_size=args.batch_size,
                                   cd_k=args.cd_k)
        Xd = torch.as_tensor(Xs, device=args.device)
        md = torch.as_tensor(masks, device=args.device)
        state = None
        step = args.save_every if args.save_every > 0 else args.epochs
        done = 0
        while done < args.epochs:
            seg = min(step, args.epochs - done)
            state = crbm.fit_bank_segment(Xd, md, args.hidden, cfg,
                                          args.seed, state, seg, args.epochs,
                                          args.device)
            done += seg
            if args.save_every > 0:
                _save_bank(args.model, labels, state.params)
                print(f"checkpoint at epoch {done}/{args.epochs}")
        bank = state.params
        _save_bank(args.model, labels, bank)
        if args.text_dir:
            os.makedirs(args.text_dir, exist_ok=True)
            for i, label in enumerate(labels):
                with open(os.path.join(args.text_dir,
                                       f"crbm.{label}.model"), "w") as f:
                    serialization.dump_reference_crbm(
                        crbm.CrbmParams(*(p[i] for p in bank)), f)
        print(f"trained {S} speaker CRBMs (nh={args.hidden}) on {len(X)} "
              f"instances")
    else:
        model_labels, bank = _load_bank(args.model, args.device)
        errs = instance_errors(bank, torch.as_tensor(
            X, dtype=torch.float32, device=args.device))
        pred = np.asarray(model_labels)[errs.argmin(dim=0).cpu().numpy()]
        correct = int((pred == y.astype(int)).sum())
        print(f"accuracy: {correct}/{len(y)} = {correct / len(y):.4f}")


if __name__ == "__main__":
    main()
