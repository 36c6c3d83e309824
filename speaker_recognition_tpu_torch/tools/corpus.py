"""Corpus preparation, src/data/split-data.py and src/data/remove-silence.py,
as in speaker_recognition_tpu/tools/corpus.py (host only: no device work).

remove_silence_corpus gates each wav with the energy silence remover
(the corpus-prep variant uses perc=0.01, split-data.py:23-26, against the
CLI's 0.15) through the native threaded batch loader; split_corpus carves
each speaker wav into one 30 s training fragment (removed from the pool
for an unbiased split) plus N 5 s test fragments (split-data.py:62-77).
"""

from __future__ import annotations

import glob
import os
import random

import numpy as np
import scipy.io.wavfile as wavfile

from ..utils import native_io

__all__ = ["remove_silence_corpus", "split_wav", "split_corpus"]


def remove_silence_corpus(input_glob: str, output_dir: str,
                          perc: float = 0.01, n_threads: int = 0):
    """Silence-gate every wav (the native threaded path where the library
    loads); returns the paths written."""
    os.makedirs(output_dir, exist_ok=True)
    paths = sorted(glob.glob(input_glob))
    batch, lengths, fss = native_io.load_batch(
        paths, remove_silence=True, silence_perc=perc, n_threads=n_threads)
    out_paths = []
    for i, p in enumerate(paths):
        if lengths[i] == 0:
            continue
        out = os.path.join(output_dir, os.path.basename(p))
        wavfile.write(out, int(fss[i]),
                      batch[i, : lengths[i]].astype(np.int16))
        out_paths.append(out)
    return out_paths


def split_wav(fpath: str, outdir: str, train_time: float = 30.0,
              test_time: float = 5.0, nr_test: int = 100, seed: int = 0):
    """One speaker wav -> train.wav + test-i.wav fragments
    (split-data.py:62-77; training fragment removed before test draws)."""
    os.makedirs(outdir, exist_ok=True)
    rng = random.Random(seed)
    fs, signal = native_io.read_wav(fpath)
    signal = signal.astype(np.int16)

    count = min(len(signal), int(train_time * fs))
    pos = rng.randint(0, len(signal) - count)
    wavfile.write(os.path.join(outdir, "train.wav"), fs,
                  signal[pos:pos + count])
    signal = np.concatenate([signal[:pos], signal[pos + count:]])

    for i in range(nr_test):
        c = min(len(signal), int(test_time * fs))
        p = rng.randint(0, len(signal) - c)
        wavfile.write(os.path.join(outdir, f"test-{i}.wav"), fs,
                      signal[p:p + c])


def split_corpus(input_glob: str, output_root: str, **kwargs):
    """split_wav for every speaker file; outdir = wav basename."""
    for p in sorted(glob.glob(input_glob)):
        name = os.path.splitext(os.path.basename(p))[0]
        split_wav(p, os.path.join(output_root, name), **kwargs)
