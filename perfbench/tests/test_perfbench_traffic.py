"""The traffic generator: the same seed gives the same inputs, every seed
the same work; batches padded as the program's caller pads them."""

import numpy as np
import pytest
import torch

from perfbench import spec, traffic

import perfbench_helpers as H


def _small(mixname, batch=16):
    mix = H.load(f"perfbench/mixes/{mixname}.json")
    mix.update(batch=batch)
    return mix


@pytest.mark.parametrize("mixname", ["fixed5s", "ragged"])
def test_same_seed_same_inputs_every_seed_same_work(mixname):
    mix = _small(mixname)
    big = 2 ** 31 + 12345
    a = traffic.make_pool(mix, 8000, big, "cpu")
    b = traffic.make_pool(mix, 8000, big, "cpu")
    c = traffic.make_pool(mix, 8000, 2 ** 40 + 1, "cpu")
    assert len(a) == mix["pool"] >= 3
    for x, y, z in zip(a, b, c):
        assert torch.equal(x.signals, y.signals)
        assert np.array_equal(x.lengths_np, y.lengths_np)
        assert sorted(x.lengths_np) == sorted(z.lengths_np)
        assert x.signals.shape == z.signals.shape
        assert x.audio_s == z.audio_s
    assert not torch.equal(a[0].signals, c[0].signals)


def test_padding_and_samples():
    from speaker_recognition_tpu_torch.features import extract
    assert traffic.LENGTH_BUCKET == extract.LENGTH_BUCKET
    mix = _small("ragged", batch=64)
    (b, *_) = traffic.make_pool(mix, 8000, 3, "cpu")
    L = b.signals.shape[1]
    assert L % traffic.LENGTH_BUCKET == 0
    assert L - traffic.LENGTH_BUCKET < b.lengths_np.max() <= L
    pos = torch.arange(L)[None, :] >= b.lengths[:, None]
    assert not b.signals[pos].any()
    valid = b.signals[~pos]
    assert torch.equal(valid, valid.round())
    assert valid.abs().max() <= 32768 and valid.std() > 2000
    assert b.lengths.dtype == torch.int32


def test_ragged_lengths():
    s = traffic.seconds(H.load("perfbench/mixes/ragged.json"))
    assert len(s) == 512 and (s == 3.0).sum() == (s == 5.0).sum() == 256
    odd = traffic.seconds({"batch": 7, "lengths": {
        "kind": "mix", "seconds": [1.0, 2.0, 4.0], "shares": [1, 1, 1]}})
    assert sorted(np.unique(odd, return_counts=True)[1]) == [2, 2, 3]
    with pytest.raises(ValueError):
        traffic.seconds({"batch": 4, "lengths": {
            "kind": "mix", "seconds": [1.0, 2.0], "shares": [1]}})
    f = traffic.seconds(H.load("perfbench/mixes/fixed5s.json"))
    assert (f == 5.0).all()


def test_cells_name_existing_mixes_configs_and_limits():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell.mix["name"] == w["traffic"]
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) == {"score_err"}
