"""Command-line tool with the flags of src/speaker-recognition.py.

    python -m speaker_recognition_tpu_torch.cli -t enroll \\
        -i "./bob/ ./mary/" -m model.out [--device cuda]
    python -m speaker_recognition_tpu_torch.cli -t predict -i "./*.wav" \\
        -m model.out [--device cuda]

enroll labels the wavs of each input directory with the directory's
basename, trains the bank and writes the session artifact
(speaker-recognition.py:52-83); predict prints "<file> -> <label>" per
input (speaker-recognition.py:85-90), scoring all files in one batched
program. The artifact is the one speaker_recognition_tpu reads and writes.
"""

from __future__ import annotations

import argparse
import glob
import itertools
import os
import sys

from .utils.native_io import read_wav


def get_args(argv=None):
    parser = argparse.ArgumentParser(
        description="Speaker Recognition Command Line Tool (PyTorch + CUDA)",
        epilog="Wildcard inputs should be *quoted* (they are passed to glob).",
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument('-t', '--task', required=True,
                        help='Task to do. Either "enroll" or "predict"')
    parser.add_argument('-i', '--input', required=True,
                        help='Input Files(to predict) or Directories(to enroll)')
    parser.add_argument('-m', '--model', required=True,
                        help='Model file to save(in enroll) or use(in predict)')
    parser.add_argument('--device', default='cuda',
                        help='torch device to run on (default: cuda)')
    return parser.parse_args(argv)


def task_enroll(input_dirs: str, output_model: str, device: str = "cuda",
                config=None):
    """Mirrors speaker-recognition.py:52-83: glob dirs, label = dir
    basename, enroll every contained wav, train, dump. `config` (a
    PipelineConfig; the default one when None) is dumped with the session,
    so predict serves the same features."""
    from .api.interface import ModelInterface

    m = ModelInterface(config, device=device)
    patterns = [os.path.expanduser(k) for k in input_dirs.strip().split()]
    dirs = itertools.chain(*(glob.glob(d) for d in patterns))
    dirs = [d for d in dirs if os.path.isdir(d)]
    if len(dirs) == 0:
        print("No valid directory found!")
        sys.exit(1)
    training_stats = []
    for d in dirs:
        label = os.path.basename(d.rstrip('/'))
        wavs = glob.glob(d + '/*.wav')
        if len(wavs) == 0:
            print(f"No wav file found in {d}")
            continue
        print(f"Label '{label}' has files: {', '.join(wavs)}")
        total_len = 0
        for wav in wavs:
            fs, signal = read_wav(wav)
            print(f"   File '{wav}' has frequency={fs} and "
                  f"length={len(signal)}")
            total_len += len(signal)
            m.enroll(label, fs, signal)
        training_stats.append((label, total_len))
    print("--------------------------------------------")
    if not training_stats:
        print("No wav files found in any input directory!")
        sys.exit(1)
    for label, total_len in training_stats:
        print(f"Total length of training data for '{label}' is {total_len}")
    print("For best accuracy, please make sure all labels have similar "
          "amount of training data!")
    m.train()
    m.dump(output_model)


def task_predict(input_files: str, input_model: str, device: str = "cuda"):
    """Mirrors speaker-recognition.py:85-90, batched."""
    from .api.interface import ModelInterface

    m = ModelInterface.load(input_model, device=device)
    files = sorted(glob.glob(os.path.expanduser(input_files)))
    if not files:
        return
    signals, fss = [], []
    for f in files:
        fs, signal = read_wav(f)
        fss.append(fs)
        signals.append(signal)
    if len(set(fss)) == 1:
        labels = m.predict_batch(fss[0], signals)
    else:  # mixed sample rates: one program per file
        labels = [m.predict(fs, s) for fs, s in zip(fss, signals)]
    for f, label in zip(files, labels):
        print(f, '->', label)


def main(argv=None):
    args = get_args(argv)
    if args.task == 'enroll':
        task_enroll(args.input, args.model, args.device)
    elif args.task == 'predict':
        task_predict(args.input, args.model, args.device)
    else:
        print(f"unknown task: {args.task}")
        sys.exit(1)


if __name__ == '__main__':
    main()
