"""The system under test: the port's ``Detector.detect_batch``.

The only module of the benchmark that imports the program
(``repro_torch``).  It hands the port the cascade arrays through its public
constructor (``make_cascade``) and the images as float32 numpy arrays, and
takes back its rects; the timed call is ``detect_batch(images,
group=False)`` with the packed strategy.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from cascade_bench.frozen.stumps import FIELDS, stump_cascade


def cascade_arrays(config: dict, config_dir: Path) -> dict:
    """The configuration's cascade as numpy arrays in the field layout:
    drawn by the frozen generator, or read from its frozen ``.npz``."""
    spec = config["cascade"]
    if "npz" in spec:
        with np.load(config_dir / spec["npz"], allow_pickle=False) as z:
            return {f: z[f] for f in FIELDS}
    return stump_cascade(spec["seed"], spec["stage_sizes"])


def build_kernels(device) -> dict:
    """Build the port's CUDA kernels (a no-op once their libraries are in
    the checkout's ``build/``)."""
    if device.type != "cuda":
        return {"seconds": 0.0, "built": []}
    from repro_torch.kernels import native
    return native.build_all()


def detector(arrays: dict, engine: dict, device):
    from repro_torch.core.cascade import make_cascade
    from repro_torch.core.engine import Detector, EngineConfig
    cfg = EngineConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in engine.items()})
    cascade = make_cascade(*(arrays[f] for f in FIELDS), device=device)
    return Detector(cascade, cfg, device=device)


def flush(det, images: list) -> list:
    """One flush: the rects of every image, on the host."""
    return det.detect_batch(images, group=False)


def reset_launches() -> None:
    from repro_torch.kernels import native
    native.reset_launches()


def launches() -> dict:
    """Launches of each hand-written kernel since the last reset."""
    from repro_torch.kernels import native
    return native.launches()
