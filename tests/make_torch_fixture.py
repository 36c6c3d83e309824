"""Make the fixture sessions of speaker_recognition_tpu_torch/testdata with
the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/make_torch_fixture.py [--fs 8000|48000]

For each sample rate (both by default) it enrolls the three synthetic
speakers through speaker_recognition_tpu's CLI at the default
PipelineConfig (GMM-32, MFCC13 + LPC15), then scores the test utterances
with its ModelInterface.scores_batch and stores seeds, durations, true
labels and those scores beside the session:
  8 kHz   synth3_{session.npz,expected.json}   (the packed frontend)
  48 kHz  synth48_{session.npz,expected.json}  (the full-spectrum frontend:
          fft_size 2048 < 2 * 1536-sample frames)
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402

FIXTURES = {  # fs -> (session, expected, test utterances)
    synth.FS: (synth.SESSION, synth.EXPECTED, synth.TEST),
    synth.FS48: (synth.SESSION48, synth.EXPECTED48, synth.TEST48),
}


def make(fs: int):
    from speaker_recognition_tpu import cli
    from speaker_recognition_tpu.api.interface import ModelInterface

    session, expected, tests = FIXTURES[fs]
    labels = list(synth.SPEAKER_FREQS)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = synth.write_training_wavs(tmp, fs)
        model = os.path.join(tmp, "model.out")
        cli.main(["-t", "enroll", "-i", " ".join(dirs), "-m", model])
        os.replace(model, session)

    m = ModelInterface.load(session)
    utts = [{"label": label, "seconds": sec, "seed": base + i}
            for sec, base in tests for i, label in enumerate(labels)]
    sigs = [synth.synth_utterance(u["label"], u["seconds"], u["seed"], fs)
            for u in utts]
    scores, valid = m.scores_batch(fs, sigs)
    assert valid.all()
    with open(expected, "w") as f:
        json.dump({"fs": fs, "speakers": m.gmmset.y, "utterances": utts,
                   "scores": np.asarray(scores, np.float64).tolist()},
                  f, indent=1)
        f.write("\n")
    print(fs, "labels:", m.predict_batch(fs, sigs))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fs", type=int, choices=sorted(FIXTURES),
                    help="make only this sample rate's fixture")
    args = ap.parse_args(argv)
    for fs in [args.fs] if args.fs else sorted(FIXTURES):
        make(fs)


if __name__ == "__main__":
    main()
