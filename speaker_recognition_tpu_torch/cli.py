"""Command-line tool with the flags of src/speaker-recognition.py.

    python -m speaker_recognition_tpu_torch.cli -t predict -i "./*.wav" \\
        -m model.out [--device cuda]

prints "<file> -> <label>" per input (speaker-recognition.py:85-90),
scoring all files in one batched program. Enrollment is not ported yet:
enroll with speaker_recognition_tpu, whose session artifact this tool
reads.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

from speaker_recognition_tpu.utils.native_io import read_wav


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
                        help='torch device to predict on (default: cuda)')
    return parser.parse_args(argv)


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
        print("enroll is not ported yet; enroll with speaker_recognition_tpu")
        sys.exit(1)
    elif args.task == 'predict':
        task_predict(args.input, args.model, args.device)
    else:
        print(f"unknown task: {args.task}")
        sys.exit(1)


if __name__ == '__main__':
    main()
