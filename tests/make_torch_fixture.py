"""Make the fixture sessions of speaker_recognition_tpu_torch/testdata with
the JAX package on the CPU.

    JAX_PLATFORMS=cpu python tests/make_torch_fixture.py \
        [--fs 8000|48000 | --conv]

For each sample rate (both by default) it enrolls the three synthetic
speakers through speaker_recognition_tpu's CLI at the default
PipelineConfig (GMM-32, MFCC13 + LPC15), then scores the test utterances
with its ModelInterface.scores_batch and stores seeds, durations, true
labels and those scores beside the session:
  8 kHz   synth3_{session.npz,expected.json}   (the packed frontend)
  48 kHz  synth48_{session.npz,expected.json}  (the full-spectrum frontend:
          fft_size 2048 < 2 * 1536-sample frames)
and, for the live path (also by default; alone with --conv), the JAX
package's ModelInterface at 8 kHz with k-means|| seeding: init_noise on
synth.noise_clip(), each speaker enrolled from its VAD-filtered noisy
clips (synth.enrollment_clips), trained, dumped with its VAD state; then
its ConversationSession on synth.conversation_stream() in 0.4 s chunks,
with the labels of the held-out clips and each tick's margins:
  8 kHz   synth3_conv_{session.npz,expected.json}
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


def tick_windows(stream, fs):
    """(end time, window) of each conversation tick over `stream`, the
    windows ConversationSession._tick filters."""
    step, seg = int(0.4 * fs), int(1.5 * fs)
    x = np.asarray(stream, np.float64)
    return [(pos / fs, x[max(pos - seg, 0):pos])
            for pos in range(step, len(x) + 1, step)]


def ltsd_margin(vad, window) -> float:
    """The least distance of a window's LTSD scores from either threshold
    (inf for a window shorter than the detector's context)."""
    from speaker_recognition_tpu.vad.ltsd import ltsd_scores
    s = ltsd_scores(window, vad.noise_amp, vad.window_size, vad.order)
    if not len(s):
        return float("inf")
    return float(min(np.abs(s - vad.lambda0).min(),
                     np.abs(s - vad.lambda1).min()))


def make_conv():
    from speaker_recognition_tpu.api.conversation import ConversationSession
    from speaker_recognition_tpu.api.interface import ModelInterface
    from speaker_recognition_tpu.config import GmmConfig, PipelineConfig

    fs = synth.FS
    m = ModelInterface(PipelineConfig(gmm=GmmConfig(init_with_kmeans=True)))
    m.init_noise(fs, synth.noise_clip())
    for label, clip in synth.enrollment_clips():
        m.enroll(label, fs, m.filter(fs, clip))
    m.train()
    m.dump(synth.CONV_SESSION)
    m = ModelInterface.load(synth.CONV_SESSION)  # as it is served

    sec, base = synth.HELDOUT_CONV
    heldout = [m.predict(fs, m.filter(fs, synth.noisy_utterance(
        label, sec, base + i))) for i, label in enumerate(synth.SPEAKER_FREQS)]
    assert heldout == list(synth.SPEAKER_FREQS), heldout
    stream = synth.conversation_stream()
    conv = ConversationSession(m, fs)
    step = int(0.4 * fs)
    for i in range(0, len(stream), step):
        conv.feed(stream[i:i + step])
    ticks = []
    for (t, window), label in zip(tick_windows(stream, fs),
                                  conv.result_list):
        kept = len(m.filter(fs, window))
        tick = {"time": t, "kept": kept, "label": label,
                "ltsd_margin": ltsd_margin(m.vad, window)}
        if label is not None:
            scores, _ = m.scores_batch(fs, [m.filter(fs, window)])
            top = np.sort(scores[0])[::-1]
            tick["score_margin"] = float(top[0] - top[1])
        ticks.append(tick)
    with open(synth.CONV_EXPECTED, "w") as f:
        json.dump({"fs": fs, "speakers": m.gmmset.y, "heldout": heldout,
                   "timeline": [[t, label] for t, label in conv.timeline],
                   "ticks": ticks}, f, indent=1)
        f.write("\n")
    print("conversation timeline:", conv.timeline)
    print("least LTSD margin", min(t["ltsd_margin"] for t in ticks),
          "least score margin", min(t.get("score_margin", np.inf)
                                    for t in ticks))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fs", type=int, choices=sorted(FIXTURES),
                    help="make only this sample rate's fixture")
    ap.add_argument("--conv", action="store_true",
                    help="make only the live-path fixture")
    args = ap.parse_args(argv)
    if not args.conv:
        for fs in [args.fs] if args.fs else sorted(FIXTURES):
            make(fs)
    if args.conv or not args.fs:
        make_conv()


if __name__ == "__main__":
    main()
