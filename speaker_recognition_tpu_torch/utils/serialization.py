"""Model persistence, in the formats of speaker_recognition_tpu/utils/
serialization.py (numpy only here):

  * the session artifact: one .npz holding the speaker bank, labels,
    optional UBM, VAD calibration and the pipeline config (save_session /
    load_session), byte for byte, so a session written by either package
    serves in the other;
  * the reference's plain-text GMM format (GMM::dump / GMM::load,
    src/gmm/src/gmm.cc:655-682; Gaussian::dump, gmm.cc:101-128):
        nr_mixtures
        w_0 ... w_{K-1}
        then per gaussian: dim covariance_type / means / sigmas.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os

import numpy as np

from ..config import PipelineConfig
from ..models.gmm import GmmParams

COVTYPE_DIAGONAL = 1  # src/gmm/src/type.hh (spherical=0, diagonal=1)


def dump_reference_gmm(params: GmmParams, fobj) -> None:
    """Write one GMM (weights [K], means/sigmas [K, d]) in the reference's
    text format."""
    w = np.asarray(params.weights, np.float64)
    means = np.asarray(params.means, np.float64)
    sigmas = np.asarray(params.sigmas, np.float64)
    K, d = means.shape
    fobj.write(f"{K}\n")
    fobj.write(" ".join(repr(float(v)) for v in w) + " \n")
    for k in range(K):
        fobj.write(f"{d} {COVTYPE_DIAGONAL}\n")
        fobj.write(" ".join(repr(float(v)) for v in means[k]) + " \n")
        fobj.write(" ".join(repr(float(v)) for v in sigmas[k]) + " \n")


def load_reference_gmm(fobj) -> GmmParams:
    """Parse the reference's text GMM format as a whitespace-token stream,
    like GMM::load's istream reader (gmm.cc:666-682)."""
    it = iter(fobj.read().split())
    K = int(next(it))
    w = np.array([float(next(it)) for _ in range(K)])
    means, sigmas = [], []
    for _ in range(K):
        d = int(next(it))
        cov = int(next(it))
        if cov != COVTYPE_DIAGONAL:
            raise ValueError(f"unsupported covariance type {cov}")
        means.append([float(next(it)) for _ in range(d)])
        sigmas.append([float(next(it)) for _ in range(d)])
    return GmmParams(w, np.array(means), np.array(sigmas))


def dumps_reference_gmm(params: GmmParams) -> str:
    buf = io.StringIO()
    dump_reference_gmm(params, buf)
    return buf.getvalue()


def loads_reference_gmm(text: str) -> GmmParams:
    return load_reference_gmm(io.StringIO(text))


def _config_to_json(cfg) -> str:
    return json.dumps(dataclasses.asdict(cfg))


def _config_from_json(cls, s: str):
    """Rebuild a nested frozen-dataclass config from its asdict JSON; field
    types come from a default instance (annotations are strings here)."""
    def build(c, dd):
        defaults = c()
        kwargs = {}
        for f in dataclasses.fields(c):
            cur = getattr(defaults, f.name)
            v = dd[f.name]
            kwargs[f.name] = (build(type(cur), v)
                              if dataclasses.is_dataclass(cur) else v)
        return c(**kwargs)

    return build(cls, json.loads(s))


def save_session(path: str, *, gmmset_state: dict, config: PipelineConfig,
                 vad_state: dict | None = None) -> None:
    arrays = {}
    meta = {"labels": gmmset_state["labels"],
            "reject_threshold": gmmset_state["reject_threshold"],
            "config": dataclasses.asdict(config),
            "has_ubm": "ubm_weights" in gmmset_state,
            "has_vad": vad_state is not None}
    for k in ("weights", "means", "sigmas"):
        arrays[k] = gmmset_state[k]
    if meta["has_ubm"]:
        for k in ("ubm_weights", "ubm_means", "ubm_sigmas"):
            arrays[k] = gmmset_state[k]
    if vad_state is not None:
        arrays["vad_noise_amp"] = np.asarray(vad_state["noise_amp"])
        meta["vad"] = {k: vad_state[k] for k in
                       ("lambda0", "lambda1", "window_size", "order", "fs")}
    arrays["meta_json"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    # the exact requested path: np.savez would append '.npz' to a bare name
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_session(path: str):
    """-> (gmmset state dict, PipelineConfig, vad state dict or None)."""
    if not os.path.exists(path) and os.path.exists(str(path) + ".npz"):
        path = str(path) + ".npz"
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z["meta_json"]).decode("utf-8"))
        st = {"labels": meta["labels"],
              "reject_threshold": meta["reject_threshold"],
              "weights": z["weights"], "means": z["means"],
              "sigmas": z["sigmas"]}
        if meta["has_ubm"]:
            for k in ("ubm_weights", "ubm_means", "ubm_sigmas"):
                st[k] = z[k]
        vad_state = None
        if meta.get("has_vad"):
            vad_state = dict(meta["vad"])
            vad_state["noise_amp"] = z["vad_noise_amp"]
    config = _config_from_json(PipelineConfig, json.dumps(meta["config"]))
    return st, config, vad_state
