"""Sequence-sharded feature extraction for long utterances: the frame axis
of one utterance split over the mesh's 'data' axis, as in
speaker_recognition_tpu/parallel/seqshard.py, and held to the port's
features/extract.mix_feature (the JAX seqshard ignores f_max,
preemph_first, n_lpcc and n_deltas; ROADMAP, known faults on the reference
side).

Frames are i.i.d. given the GMM, so sharding the frame axis of one long
utterance is this workload's context parallelism. Rank r owns the chunk
of `chunk` samples at r * chunk (a multiple of the frame shift) and frames
its chunk's frame starts. Its couplings with the others are:
  * a right halo of frame_len - frame_shift samples, the head of the next
    rank's chunk (an all_gather of the heads over 'data'; zeros past the
    last rank). Window and pre-emphasis act within a frame in the port's
    extractor (ops/framing.window_preemph, in either order), so no sample
    left of the chunk is needed;
  * the per-utterance CMVN statistics (MFCC.py:74-77): the count and sum,
    then the squared deviations, each all_reduced over 'data';
  * deltas, which need neighbouring frames: the normalized frames are
    all_gathered over 'data' and the deltas applied to the whole.
Each rank's pre-CMVN features come from the frontend's own kernel
(features/extract's `pre_cmvn`, mix_feature's route with its CMVN off):
the signal frontend K1 (ops/gpu_frontend.packed_from_signals, counted in
gpu_frontend.LAUNCHES) on the packed route, the full-spectrum K5 on the
full route (from the signals, mfcc_from_signals, FULL_SIGNAL_LAUNCHES, at
a power-of-two fft_size; on frames, mfcc_from_frames, otherwise); on the
CPU, and at float64, their plain versions.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import FeatureConfig, frame_geometry, n_frames
from ..features import extract
from .mesh import mesh_device, shard_index

__all__ = ["sharded_mix_feature"]


def _cmvn(ceps: torch.Tensor, nv: int, group) -> torch.Tensor:
    """Masked two-pass CMVN of this rank's cepstra over the utterance's
    frames on every rank of `group`: the identity at <= 1 frame."""
    valid = ceps[:nv]
    acc = torch.cat([valid.sum(0), valid.new_tensor([float(nv)])])
    dist.all_reduce(acc, group=group)
    n = acc[-1]
    if float(n) <= 1:
        return ceps
    mu = acc[:-1] / n
    sq = ((valid - mu) ** 2).sum(0)
    dist.all_reduce(sq, group=group)
    return (ceps - mu) / torch.sqrt(sq / n)


def sharded_mix_feature(mesh: DeviceMesh, fs: int, signal,
                        cfg: FeatureConfig = FeatureConfig(),
                        dtype: str = "float32") -> np.ndarray:
    """One long utterance -> [T - n_deltas, d] features (numpy, on every
    rank), its frame axis sharded over the mesh's 'data' axis: the
    features of features/extract.mix_feature at (fs, cfg, dtype), on the
    mesh's device."""
    dev = mesh_device(mesh)
    group = mesh.get_group("data")
    r, n_shards = shard_index(mesh, ("data",))
    signal = np.asarray(signal, np.float64)
    if signal.ndim > 1:
        signal = signal.mean(axis=1)
    if extract.signal_too_short(fs, cfg, len(signal)):
        raise ValueError("Signal too short!")  # MFCC.py:56
    mf = cfg.mfcc
    flen, fshift = frame_geometry(fs, mf.win_length_ms, mf.win_shift_ms)
    L = len(signal)
    T = n_frames(L, flen, fshift)
    halo = flen - fshift
    chunk = -(-L // (n_shards * fshift)) * fshift
    if halo > chunk:
        raise ValueError(f"{L} samples over {n_shards} shards leave chunks "
                         f"of {chunk}, shorter than the {halo}-sample halo")
    fe = extract.frontend(fs, cfg, dev, dtype)
    np_dt = np.float64 if fe.dtype == torch.float64 else np.float32
    own = np.zeros(chunk, np_dt)
    part = signal[r * chunk:(r + 1) * chunk]
    own[:len(part)] = part
    own = torch.from_numpy(own).to(dev)
    heads = [torch.empty(halo, dtype=own.dtype, device=dev)
             for _ in range(n_shards)]
    dist.all_gather(heads, own[:halo].contiguous(), group=group)
    nxt = heads[r + 1] if r + 1 < n_shards else torch.zeros_like(heads[0])
    ext = torch.cat([own, nxt])
    fps = chunk // fshift  # frames a shard
    nv = int(np.clip(T - r * fps, 0, fps))  # its frames inside the signal
    # this rank's samples inside the signal, so that its valid frames are nv
    n_in = int(np.clip(L - r * chunk, 0, len(ext)))
    ceps, tail, _ = fe.pre_cmvn(ext[None], torch.tensor([n_in], device=dev))
    ceps, tail = ceps[0], tail[0]
    if fe.cmvn:
        ceps = _cmvn(ceps, nv, group)
    feat = torch.cat([ceps, tail], dim=-1).contiguous()
    parts = [torch.empty_like(feat) for _ in range(n_shards)]
    dist.all_gather(parts, feat, group=group)
    whole = torch.cat(parts)[:T]
    if cfg.n_deltas:
        whole, _ = extract.apply_deltas(
            whole, torch.ones(T, dtype=torch.bool, device=dev), cfg.n_deltas)
    return whole.cpu().numpy()
