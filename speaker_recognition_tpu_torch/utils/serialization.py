"""Model persistence, in the formats of speaker_recognition_tpu/utils/
serialization.py (numpy only here, torch tensors accepted where a model is
written):

  * the session artifact: one .npz holding the speaker bank, labels,
    optional UBM, VAD calibration and the pipeline config (save_session /
    load_session), byte for byte, so a session written by either package
    serves in the other;
  * the reference's plain-text GMM format (GMM::dump / GMM::load,
    src/gmm/src/gmm.cc:655-682; Gaussian::dump, gmm.cc:101-128):
        nr_mixtures
        w_0 ... w_{K-1}
        then per gaussian: dim covariance_type / means / sigmas;
  * the reference's CRBM text format (CRBM::dump / CRBM::load,
    src/nn/src/crbm.cc:238-290), written byte for byte as the JAX package
    writes it;
  * the JFA stack's text formats: the UBM supervector directory
    (ubm_means / ubm_variances / ubm_weights), one feature file per
    utterance and the `logical=physical` .lst manifests, so that data and
    models move between the two packages and the reference's MATLAB JFA
    scripts in every direction.
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


def dump_jfa_supervectors(params: GmmParams, directory: str) -> None:
    """Write the UBM as the reference's JFA text supervectors
    (ubm_means / ubm_variances / ubm_weights, the files src/test/UBM.py:33-47
    produces and src/jfa/sc_*.m load): one whitespace row per mixture of the
    mean / variance vectors, one weight per line."""
    os.makedirs(directory, exist_ok=True)
    means = np.asarray(params.means, np.float64)
    variances = np.asarray(params.sigmas, np.float64) ** 2
    weights = np.asarray(params.weights, np.float64)
    np.savetxt(os.path.join(directory, "ubm_means"), means)
    np.savetxt(os.path.join(directory, "ubm_variances"), variances)
    np.savetxt(os.path.join(directory, "ubm_weights"), weights)


def load_jfa_supervectors(directory: str) -> GmmParams:
    """Read the JFA text supervector triple back into GmmParams."""
    means = np.loadtxt(os.path.join(directory, "ubm_means"), ndmin=2)
    variances = np.loadtxt(os.path.join(directory, "ubm_variances"), ndmin=2)
    weights = np.loadtxt(os.path.join(directory, "ubm_weights"), ndmin=1)
    return GmmParams(weights, means, np.sqrt(variances))


# -- JFA text feature interchange -------------------------------------------
#
# The reference moves features between Python and its MATLAB JFA stack as
# plain-text files plus ".lst" manifests (src/test/gen-features-file.py:95-116,
# src/test/extract-mfcc-data.py): one feature file per utterance with one
# space-separated frame per line, and manifests of "logical=physical" lines
# (parsed by src/jfa/parse_list.m). Implementing the same format lets data
# flow between the reference's JFA scripts and this pipeline in both
# directions.

def write_feature_text(path: str, feat) -> None:
    """One utterance's [T, d] features, one frame per line (the
    gen-features-file.py `_write` layout, trailing space included)."""
    feat = np.asarray(feat, np.float64)
    with open(path, "w") as f:
        for row in feat:
            f.write(" ".join(repr(float(v)) for v in row) + " \n")


def read_feature_text(path: str) -> np.ndarray:
    return np.loadtxt(path, ndmin=2)


def write_lst(path: str, pairs) -> None:
    """Manifest of (logical, physical) entries as `logical=physical` lines
    (gen-features-file.py:114-116)."""
    with open(path, "w") as f:
        for logical, physical in pairs:
            f.write(f"{logical}={physical}\n")


def read_lst(path: str):
    """Parse a manifest into [(logical, physical)], like parse_list.m: split
    on the first '='."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            logical, _, physical = line.partition("=")
            if not physical:
                raise ValueError(f"malformed lst line (no '='): {line!r}")
            out.append((logical, physical))
    return out


# -- reference CRBM text format ---------------------------------------------

def _host64(x) -> np.ndarray:
    """A numpy or torch array (on any device) as float64 numpy."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def dump_reference_crbm(params, fobj) -> None:
    """Write one CRBM in the reference's text format (CRBM::dump,
    src/nn/src/crbm.cc:238-263):

        nv nh
        visible biases / hidden biases (one line each)
        w rows: nv lines of nh weights
        hidden slopes a
        visible ranges (lo hi pairs), hidden ranges (lo hi pairs)
        sigma
    """
    from ..models.crbm import SIGMA

    vb, hb, w, a, vlo, vhi = (_host64(x) for x in params)
    nv, nh = w.shape

    def row(vals):
        return " ".join(f"{float(v):.10f}" for v in vals) + " \n"

    fobj.write(f"{nv} {nh}\n")
    fobj.write(row(vb))
    fobj.write(row(hb))
    for i in range(nv):
        fobj.write(row(w[i]))
    fobj.write(row(a))
    fobj.write(row(np.stack([vlo, vhi], axis=1).reshape(-1)))
    # the hidden range is fixed [0, 1] in both implementations
    # (crbm.cc:96-100)
    fobj.write(row(np.tile([0.0, 1.0], nh)))
    fobj.write(f"{SIGMA:.10f}\n")


def load_reference_crbm(fobj):
    """Parse the reference CRBM text format (CRBM::load, crbm.cc:265-290)
    into CrbmParams of float64 numpy arrays; the fixed hidden range and
    sigma are checked."""
    from ..models.crbm import SIGMA, CrbmParams

    it = iter(fobj.read().split())
    nv, nh = int(next(it)), int(next(it))

    def take(n):
        return np.array([float(next(it)) for _ in range(n)])

    vb, hb = take(nv), take(nh)
    w = take(nv * nh).reshape(nv, nh)
    a = take(nh)
    vrange = take(2 * nv).reshape(nv, 2)
    hrange = take(2 * nh).reshape(nh, 2)
    sigma = float(next(it))
    if not (np.allclose(hrange[:, 0], 0.0) and np.allclose(hrange[:, 1], 1.0)):
        raise ValueError("hidden range must be [0,1] (crbm.cc:96-100)")
    if abs(sigma - SIGMA) > 1e-6:
        raise ValueError(f"sigma {sigma} != fixed {SIGMA} (crbm.cc:118-123)")
    return CrbmParams(vb=vb, hb=hb, w=w, a=a, vlo=vrange[:, 0],
                      vhi=vrange[:, 1])


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
