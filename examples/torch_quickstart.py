"""Quickstart on the PyTorch port: the paper's face detector in five
lines, plus the scheduling/energy layer (``examples/quickstart.py``
through ``repro_torch``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

With no ``--device`` it runs on the card (``cuda``) and fails without
one; ``--device cpu`` runs every kernel's plain version on the host.
"""

import argparse

import numpy as np

from repro_torch.configs.viola_jones import pretrained
from repro_torch.core import Detector, EngineConfig
from repro_torch.core.training.data import render_scene
from repro_torch.device import resolve_device
from repro_torch.scheduling import (BotlevScheduler, SequentialScheduler,
                                    build_detection_dag, odroid_xu4, rpi3b,
                                    simulate)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the port's quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device: {device}")

    # 1) load the AdaBoost-trained cascade and render a test scene
    cascade, meta = pretrained(device=device)
    print(f"cascade: {cascade.n_stages} stages, {cascade.n_weak} weak "
          f"classifiers (trained DR={meta['overall_dr']:.3f}, "
          f"FPR={meta['overall_fpr']:.2e})")
    img, gt = render_scene(np.random.default_rng(3), 128, 128, n_faces=1)

    # 2) detect with the wave engine (compaction between stages)
    det = Detector(cascade, EngineConfig(mode="wave", step=2,
                                         scale_factor=1.25,
                                         min_neighbors=2), device=device)
    boxes = det.detect(img)
    print(f"ground truth: {gt.tolist()}")
    print(f"detections:   {boxes.tolist()}")

    # 3) the asymmetric-scheduling layer: modelled time/energy on the
    #    paper's two boards
    dag = build_detection_dag(128, 128, cascade.stage_sizes(), step=2,
                              scale_factor=1.25)
    for name, plat in (("Odroid XU4", odroid_xu4()), ("RPi 3B+", rpi3b())):
        seq = simulate(dag, plat, SequentialScheduler())
        bot = simulate(dag, plat, BotlevScheduler())
        print(f"{name}: sequential {seq.makespan:.2f}s/{seq.energy:.1f}J -> "
              f"Botlev {bot.makespan:.2f}s/{bot.energy:.1f}J "
              f"({100 * (1 - bot.makespan / seq.makespan):.0f}% faster)")


if __name__ == "__main__":
    main()
