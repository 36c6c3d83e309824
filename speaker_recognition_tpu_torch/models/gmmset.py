"""Speaker model bank for serving (src/testbench/gmmset.py:16-105).

The serving half of speaker_recognition_tpu/models/gmmset.py: labels, the
bank's parameters as they persist in a session (`params`), and the bank on
a device as a GmmBank (`bank`). Enrollment, training and open-set
rejection are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .gmm import GmmBank, GmmParams

__all__ = ["GMMSet"]


class GMMSet:
    def __init__(self, ubm: GmmParams | None = None,
                 reject_threshold: float = 10.0,
                 device: torch.device | str = "cpu"):
        # the UBM and threshold are carried for the session artifact; open-set
        # rejection, which reads them, is not ported yet
        self.ubm = ubm
        self.reject_threshold = reject_threshold
        self.device = torch.device(device)
        self.y: list[str] = []
        self.params: GmmParams | None = None
        self.bank: GmmBank | None = None

    def state(self) -> dict:
        if self.params is None:
            raise RuntimeError("a trained bank must be loaded before state()")
        st = {
            "labels": list(self.y),
            "weights": np.asarray(self.params.weights),
            "means": np.asarray(self.params.means),
            "sigmas": np.asarray(self.params.sigmas),
            "reject_threshold": self.reject_threshold,
        }
        if self.ubm is not None:
            st["ubm_weights"] = np.asarray(self.ubm.weights)
            st["ubm_means"] = np.asarray(self.ubm.means)
            st["ubm_sigmas"] = np.asarray(self.ubm.sigmas)
        return st

    @classmethod
    def from_state(cls, st: dict,
                   device: torch.device | str = "cpu") -> "GMMSet":
        ubm = None
        if "ubm_weights" in st:
            ubm = GmmParams(st["ubm_weights"], st["ubm_means"],
                            st["ubm_sigmas"])
        obj = cls(ubm=ubm, reject_threshold=float(st["reject_threshold"]),
                  device=device)
        obj.y = [str(label) for label in st["labels"]]
        obj.params = GmmParams(st["weights"], st["means"], st["sigmas"])
        obj.bank = GmmBank.from_numpy(*obj.params, device=obj.device)
        return obj
