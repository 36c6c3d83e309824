"""The comparison that decides `correct`.

Every pool batch goes through the plain reference (perfbench/reference) on
the same signals, lengths and raw bank parameters the program was given.
One number is read, the widest gap between the program and the reference
(`score_err`), over the frontend (cepstra, CMVN, LPC) and the scoring
both:

  - over every [B, S] score of the calls kept from the window (one call per
    pool batch, drawn from the seed): |program - reference|;
  - over every label of every call of the window: half the amount by which
    the reference's score of the program's label lies below the
    reference's best score of that utterance. Where every score lies within
    e of the reference's, a label parts from the reference's only on a near
    tie and lies at most 2e below the best, so this part stays within the
    same limit; a wrong label on any call reads as large.

The utterances that got no label at all are counted too (`unlabelled`,
limit 0). A number that is not finite fails its limit.
"""

from __future__ import annotations

import math

import numpy as np

from .reference import pipeline


def reference_scores(config: dict, pool, params: dict, device,
                     tf32: bool = False) -> list[np.ndarray]:
    """The reference's [B, S] scores of every pool batch (TF32 products
    with `tf32`: the control)."""
    fe = pipeline.Frontend(int(config["fs"]), config["features"], device)
    bank = pipeline.Bank(params["weights"], params["means"],
                         params["sigmas"], device)
    out = []
    for batch in pool:
        out.append(pipeline.scores(batch.signals, batch.lengths, fe, bank,
                                   tf32=tf32).cpu().numpy())
    return out


def _finite_max(x: np.ndarray) -> float:
    return float(x.max()) if np.isfinite(x).all() else math.inf


def readings(config: dict, pool, params: dict, scores: dict, labels: dict,
             device, reference: list | None = None) -> dict:
    """score_err of the program's kept `scores` ({pool index: [B, S]}) and
    `labels` ({pool index: [calls, B]}) against the reference's scores
    (computed here unless given)."""
    ref = (reference if reference is not None
           else reference_scores(config, pool, params, device))
    err = 0.0
    for p, r in enumerate(ref):
        if p in scores:
            err = max(err, _finite_max(np.abs(scores[p] - r)))
        if p in labels:
            lab = labels[p]
            rows = np.arange(r.shape[0])[None, :]
            short = r.max(axis=1)[None, :] - r[rows, lab]
            err = max(err, 0.5 * _finite_max(short))
    return {"score_err": err}


def checks(readings: dict, limits: dict, unlabelled: int) -> dict:
    """Each number beside its limit, in a fixed order."""
    return {"score_err": {"value": readings["score_err"],
                          "limit": limits["score_err"]},
            "unlabelled": {"value": unlabelled, "limit": 0}}


def passed(checks: dict) -> bool:
    """Whether every number lies within its limit (NaN never does)."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def jsonable(x):
    """x with every non-finite float written as a string ("inf", "nan"),
    which strict JSON cannot hold as a number."""
    if isinstance(x, dict):
        return {k: jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [jsonable(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return str(x)
    return x
