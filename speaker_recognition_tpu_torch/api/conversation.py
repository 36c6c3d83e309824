"""Streaming conversation-mode identification, as in
speaker_recognition_tpu/api/conversation.py.

The reference GUI's conversation mode (src/gui/gui.py:165-213): every
CONV_INTERVAL seconds, classify the last CONV_DURATION seconds of audio
through VAD + predict, with the GUI's one-step label smoothing (a label
change shows only once it persists for a second tick, gui.py:196-203). An
explicit feed() API takes the place of the GUI's timer and microphone, so
any audio source can drive it; the timeline of (time, label) events takes
the place of the Qt timeline widget.

Each tick that reaches predict runs the port's frontend and bank-scoring
kernels (ops/gpu_frontend.packed_from_signals, ops/gpu_gmm.
batch_bank_avg_loglik) once each on the card, through ModelInterface.
predict; a tick whose window the VAD empties launches neither.

One deliberate deviation from the JAX package, which turns every
exception of a tick into "Nobody" (its conversation.py:66): a window that
the VAD strips too far still shows "Nobody", and ModelInterface.predict
still maps a signal too short for a feature frame to None, but any other
error raises.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ConversationSession"]


class ConversationSession:
    CONV_INTERVAL = 0.4   # seconds, gui.py Main.CONV_INTERVAL
    CONV_DURATION = 1.5   # seconds, gui.py Main.CONV_DURATION
    MIN_FILTERED_SAMPLES = 50  # gui.py:188 `len(signal) > 50`

    def __init__(self, model, fs: int):
        """model: a trained api.interface.ModelInterface whose VAD was
        calibrated (init_noise, or a session loaded with it)."""
        self.model = model
        self.fs = fs
        self.buffer = np.zeros(0, dtype=np.float64)
        self.now_pos = 0
        self._trimmed = 0  # samples dropped from the front of buffer
        self.result_list: list = []       # raw per-tick labels
        self.timeline: list = []          # (time_seconds, shown_label) events
        self._last_shown = None

    def feed(self, samples) -> list:
        """Append audio; runs one classification tick per CONV_INTERVAL of
        newly accumulated audio. Returns the new (time, label) timeline
        events. Only the trailing CONV_DURATION window is ever read, so
        older audio is dropped and a session can stream indefinitely."""
        self.buffer = np.concatenate([self.buffer,
                                      np.asarray(samples, np.float64)])
        events = []
        interval_len = int(self.CONV_INTERVAL * self.fs)
        segment_len = int(self.CONV_DURATION * self.fs)
        while (len(self.buffer) + self._trimmed
               - self.now_pos) >= interval_len:
            self.now_pos += interval_len
            events.extend(self._tick())
        keep_from = max(self.now_pos - segment_len - self._trimmed, 0)
        if keep_from > 0:
            self.buffer = self.buffer[keep_from:]
            self._trimmed += keep_from
        return events

    def _tick(self) -> list:
        segment_len = int(self.CONV_DURATION * self.fs)
        lo = max(self.now_pos - segment_len, self._trimmed) - self._trimmed
        to_filter = self.buffer[lo: self.now_pos - self._trimmed]
        label = None
        signal = self.model.filter(self.fs, to_filter)
        if len(signal) > self.MIN_FILTERED_SAMPLES:
            label = self.model.predict(self.fs, signal)

        # one-step smoothing (gui.py:196-203): suppress a change until it
        # repeats on the next tick
        label_to_show = label
        if label and self.result_list:
            last_label = self.result_list[-1]
            if last_label and last_label != label:
                label_to_show = self._last_shown
        self.result_list.append(label)
        self._last_shown = label_to_show

        shown = label_to_show if label_to_show is not None else "Nobody"
        t = self.now_pos / self.fs
        if not self.timeline or self.timeline[-1][1] != shown:
            self.timeline.append((t, shown))
            return [(t, shown)]
        return []
