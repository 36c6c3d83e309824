"""svm-format dataset IO — equivalent of src/nn/src/datamanip.cc.

The reference reads/writes sparse "label idx:val idx:val ..." lines
(read_svm_data, datamanip.cc:18-110) for its RBM/CRBM/NN programs; this
module round-trips the same format to/from dense numpy arrays (the
models are dense)."""

from __future__ import annotations

import numpy as np

__all__ = ["read_svm_data", "write_svm_data"]


def read_svm_data(path: str, dim: int | None = None):
    """-> (X [n, d] float64, y [n] float64). Indices in the file are
    1-based (libsvm convention, matching datamanip.cc's parser)."""
    labels = []
    rows = []
    max_idx = 0
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            feats = {}
            for tok in parts[1:]:
                idx, val = tok.split(":")
                idx = int(idx)
                feats[idx] = float(val)
                max_idx = max(max_idx, idx)
            rows.append(feats)
    d = dim if dim is not None else max_idx
    X = np.zeros((len(rows), d))
    for i, feats in enumerate(rows):
        for idx, val in feats.items():
            if idx <= d:
                X[i, idx - 1] = val
    return X, np.asarray(labels)


def write_svm_data(path: str, X, y):
    X = np.asarray(X)
    y = np.asarray(y)
    with open(path, "w") as f:
        for xi, yi in zip(X, y):
            toks = [f"{int(yi) if float(yi).is_integer() else yi}"]
            toks += [f"{j + 1}:{v:.10g}" for j, v in enumerate(xi) if v != 0]
            f.write(" ".join(toks) + "\n")
