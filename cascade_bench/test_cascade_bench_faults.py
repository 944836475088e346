"""The comparison that decides ``correct`` fails when it should: a whole
run of the tiny cell on the CPU with the timed path broken underneath, and
the control (the reference in bfloat16 in the program's place)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from cascade_bench import control
from cascade_bench import run as runmod

torch.set_num_threads(1)


def half_the_batch_left_out(orig):
    def detect_batch(self, images, group=True, strategy="packed"):
        n = (len(images) + 1) // 2
        out = orig(self, images[:n], group=group, strategy=strategy)
        return out + [np.zeros((0, 4), np.int32)] * (len(images) - n)
    return detect_batch


def one_answer_altered(orig):
    def detect_batch(self, images, group=True, strategy="packed"):
        out = orig(self, images, group=group, strategy=strategy)
        for r in out:
            if len(r):
                r[0, 0] += 1
                break
        return out
    return detect_batch


def test_a_sound_run_is_correct(tiny_root):
    root, bench = tiny_root
    res = runmod.run_cell(root, bench, "tiny.t", 2**31 + 17, 0.2, False,
                          device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"] == {"rect_mismatch": {"value": 0, "limit": 0},
                             "answers_missing": {"value": 0, "limit": 0}}
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [half_the_batch_left_out,
                                   one_answer_altered])
def test_a_broken_timed_path_is_not_correct(tiny_root, monkeypatch, fault):
    from repro_torch.core.engine import Detector
    root, bench = tiny_root
    monkeypatch.setattr(Detector, "detect_batch",
                        fault(Detector.detect_batch))
    res = runmod.run_cell(root, bench, "tiny.t", 2**31 + 17, 0.2, False,
                          device="cpu")
    assert not res["correct"]
    assert res["checks"]["rect_mismatch"]["value"] > 0


def test_a_flush_that_raises_is_missing_and_not_correct(tiny_root,
                                                        monkeypatch):
    from repro_torch.core.engine import Detector
    root, bench = tiny_root
    orig = Detector.detect_batch
    calls = []

    def detect_batch(self, images, group=True, strategy="packed"):
        calls.append(1)
        if len(calls) == 3:            # the first flush of the window
            raise RuntimeError("batched-engine shared capacity overflow")
        return orig(self, images, group=group, strategy=strategy)
    monkeypatch.setattr(Detector, "detect_batch", detect_batch)
    res = runmod.run_cell(root, bench, "tiny.t", 3, 0.2, False, device="cpu")
    assert not res["correct"] and res["failed"] == 3
    assert res["checks"]["answers_missing"]["value"] == 3


def test_the_control_in_bfloat16_is_not_correct(tiny_root):
    root, bench = tiny_root
    got = control.readings(root, bench, "tiny.t", 2**31 + 17,
                           torch.device("cpu"), torch.bfloat16)
    assert got["rects_reference"] > 0
    assert got["rect_mismatch"] > 0 and not got["correct"]
    same = control.readings(root, bench, "tiny.t", 2**31 + 17,
                            torch.device("cpu"), torch.float32)
    assert same["rect_mismatch"] == 0 and same["correct"]
