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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from speaker_recognition_tpu_torch.testdata import synth  # noqa: E402


def main():
    from speaker_recognition_tpu import cli
    from speaker_recognition_tpu.api.interface import ModelInterface

    labels = list(synth.SPEAKER_FREQS)
    with tempfile.TemporaryDirectory() as tmp:
        dirs = synth.write_training_wavs(tmp)
        model = os.path.join(tmp, "model.out")
        cli.main(["-t", "enroll", "-i", " ".join(dirs), "-m", model])
        os.replace(model, synth.SESSION)

    m = ModelInterface.load(synth.SESSION)
    utts = [{"label": label, "seconds": sec, "seed": base + i}
            for sec, base in synth.TEST for i, label in enumerate(labels)]
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
