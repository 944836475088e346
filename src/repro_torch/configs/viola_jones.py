"""The paper's own architecture: the 25-stage / 2913-weak-classifier Haar
cascade (paper section 4).  ``paper_cascade()`` is the paper-shaped random
cascade (performance runs); ``pretrained()`` reads the reference's
AdaBoost-trained synthetic-face cascade from its npz file in the
repository (a data file, not an import of the reference package)."""

from __future__ import annotations

from pathlib import Path

from repro_torch.core.cascade import load_cascade, paper_shaped_cascade

DEFAULT_PRETRAINED = str(Path(__file__).resolve().parents[2] / "repro"
                         / "configs" / "pretrained" / "synthetic_face_v2.npz")

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
