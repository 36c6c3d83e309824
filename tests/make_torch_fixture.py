"""Make speaker_recognition_tpu_torch/testdata/synth3_{session.npz,
expected.json} with the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/make_torch_fixture.py

Enrolls the three synthetic speakers through speaker_recognition_tpu's CLI
at the default PipelineConfig (GMM-32, MFCC13 + LPC15), then scores the
test utterances with its ModelInterface.scores_batch and stores seeds,
durations, true labels and those scores beside the session.
"""

import json
import os
import sys
import tempfile

import numpy as np
import scipy.io.wavfile as wavfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402

TRAIN = [(6.0, 100), (6.0, 110)]           # (seconds, seed base) per speaker
TEST = [(3.0, 200), (2.0, 210), (4.5, 220)]


def main():
    from speaker_recognition_tpu import cli
    from speaker_recognition_tpu.api.interface import ModelInterface

    labels = list(synth.SPEAKER_FREQS)
    with tempfile.TemporaryDirectory() as tmp:
        for i, label in enumerate(labels):
            d = os.path.join(tmp, label)
            os.makedirs(d)
            for j, (sec, base) in enumerate(TRAIN):
                wavfile.write(os.path.join(d, f"train{j}.wav"), synth.FS,
                              synth.synth_utterance(label, sec, base + i))
        model = os.path.join(tmp, "model.out")
        cli.main(["-t", "enroll", "-i",
                  " ".join(os.path.join(tmp, lb) for lb in labels),
                  "-m", model])
        os.replace(model, synth.SESSION)

    m = ModelInterface.load(synth.SESSION)
    utts = [{"label": label, "seconds": sec, "seed": base + i}
            for sec, base in TEST for i, label in enumerate(labels)]
    sigs = [synth.synth_utterance(u["label"], u["seconds"], u["seed"])
            for u in utts]
    scores, valid = m.scores_batch(synth.FS, sigs)
    assert valid.all()
    with open(synth.EXPECTED, "w") as f:
        json.dump({"fs": synth.FS, "speakers": m.gmmset.y,
                   "utterances": utts,
                   "scores": np.asarray(scores, np.float64).tolist()},
                  f, indent=1)
        f.write("\n")
    print("labels:", m.predict_batch(synth.FS, sigs))


if __name__ == "__main__":
    main()
