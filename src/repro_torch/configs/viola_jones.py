"""The paper's own architecture: the 25-stage / 2913-weak-classifier Haar
cascade (paper section 4).  ``paper_cascade()`` is the paper-shaped random
cascade (performance runs); ``pretrained()`` reads the AdaBoost-trained
synthetic-face cascade from the port's own copy of the reference's npz
file (``pretrained/synthetic_face_v2.npz``, the same bytes)."""

from __future__ import annotations

import os

from repro_torch.core.cascade import load_cascade, paper_shaped_cascade

PRETRAINED_DIR = os.path.join(os.path.dirname(__file__), "pretrained")
DEFAULT_PRETRAINED = os.path.join(PRETRAINED_DIR, "synthetic_face_v2.npz")

# paper section 5/7 experiment constants
STEP = 1
SCALE_FACTOR = 1.2
DETECTION_WINDOW = 24
N_STAGES = 25
N_WEAK = 2913


def paper_cascade(seed: int = 0, device="cpu"):
    return paper_shaped_cascade(seed, device=device)


def pretrained(path: str = DEFAULT_PRETRAINED, device="cpu"):
    return load_cascade(path, device=device)
