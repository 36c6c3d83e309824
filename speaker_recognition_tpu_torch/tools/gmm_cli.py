#!/usr/bin/env python3
"""Standalone GMM trainer/scorer CLI, the reference's `bin/gmm`
(src/gmm/src/main.cc:51-182), as in speaker_recognition_tpu/tools/gmm_cli.py.

    python -m speaker_recognition_tpu_torch.tools.gmm_cli [train|score] \\
        -i data.txt -m model.txt [-k 10] [-f 1] [--device cuda|cpu]

Same flags (-k/--K mixtures, -i/--input dense text data, -m/--model,
-r/--iteration, -c/--mincovar, -t/--threshold, -f/--kmeans for k-means||
seeding, -w ignored: torch owns the parallelism) and the same plain-text
model format, so models interchange with the reference's `GMM::load`
(gmm.cc:666-682) and with the JAX package's CLI. train (the default)
writes the model; score prints the per-frame average log-likelihood of a
dataset under a model.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def read_dense_dataset(path: str) -> np.ndarray:
    """Whitespace-separated floats, one frame per line
    (read_dense_dataset, main.cc:99-110)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if parts:
                rows.append([float(v) for v in parts])
    return np.asarray(rows)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Gaussian Mixture Model (GMM)")
    ap.add_argument("task", nargs="?", default="train",
                    choices=["train", "score"])
    ap.add_argument("-k", "--K", type=int, default=10,
                    help="number of gaussians")
    ap.add_argument("-i", "--input", required=True, help="input file")
    ap.add_argument("-m", "--model", required=True, help="model file")
    ap.add_argument("-r", "--iteration", type=int, default=200)
    ap.add_argument("-c", "--mincovar", type=float, default=1e-3)
    ap.add_argument("-t", "--threshold", type=float, default=0.01)
    ap.add_argument("-f", "--kmeans", type=int, default=0,
                    help="init with kmeans||")
    ap.add_argument("-w", "--concurrency", type=int, default=0,
                    help="ignored (torch owns parallelism)")
    ap.add_argument("-s", "--seed", type=int, default=0)
    ap.add_argument("-u", "--ubm", default=None,
                    help="UBM model file for MAP adaptation (train only)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    from ..config import GmmConfig
    from ..models import gmm
    from ..utils import serialization

    X = read_dense_dataset(args.input)
    Xt = torch.as_tensor(X, dtype=torch.float32, device=args.device)[None]
    mask = torch.ones(Xt.shape[:2], dtype=torch.bool, device=args.device)

    if args.task == "train":
        cfg = GmmConfig(n_mixtures=args.K, n_iterations=args.iteration,
                        min_covar=args.mincovar, threshold=args.threshold,
                        init_with_kmeans=bool(args.kmeans))
        if args.ubm:
            with open(args.ubm) as f:
                ubm = serialization.load_reference_gmm(f)
            ubm = gmm.params_to(ubm, torch.float32, args.device)
            params, ll = gmm.fit_from_ubm(Xt, mask, ubm, cfg)
        else:
            params, ll = gmm.fit_with_init(Xt, mask, cfg, args.seed)
        params = gmm.params_numpy(params)
        with open(args.model, "w") as f:
            serialization.dump_reference_gmm(
                gmm.GmmParams(*(a[0] for a in params)), f)
        print(f"trained K={args.K} on {X.shape[0]}x{X.shape[1]}; "
              f"total ll {float(ll[0]):.6f}")
    else:
        with open(args.model) as f:
            params = serialization.load_reference_gmm(f)
        params = gmm.params_to(params, torch.float32, args.device)
        avg = float(gmm.avg_loglik(params, Xt[0], mask[0]))
        print(f"{avg:.6f}")


if __name__ == "__main__":
    main()
