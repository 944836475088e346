"""Paper section 7 end to end on the PyTorch port: sweep (step,
scaleFactor) for accuracy, sweep DVFS for energy, pick the Table-I
optimal operating point, and run detection at that point
(``examples/energy_tuned_detection.py`` through ``repro_torch``).

    PYTHONPATH=src python examples/torch_energy_tuned_detection.py [--device cpu]

With no ``--device`` the sweep's and the final detectors run on the card
(``cuda``) and fail without one.
"""

import argparse

import numpy as np

from repro_torch.configs.viola_jones import pretrained
from repro_torch.core import Detector, EngineConfig
from repro_torch.core.training.data import render_scene
from repro_torch.device import resolve_device
from repro_torch.scheduling.autotune import accuracy_sweep, error_table
from repro_torch.scheduling.dvfs import dvfs_sweep, optimal_operating_point


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the port's energy tuning")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device: {device}")
    cascade, _ = pretrained(device=device)

    print("1) accuracy sweep over (step, scaleFactor) - paper Fig. 20")
    cells = accuracy_sweep(cascade, steps=(1, 2, 3),
                           scale_factors=(1.2, 1.35),
                           n_images=3, height=112, width=112, seed=11,
                           device=device)
    for c in cells:
        print(f"   step={c.step} scale={c.scale_factor}: "
              f"err={c.total_error}/{c.n_faces} "
              f"P={c.precision:.2f} R={c.recall:.2f}")

    print("2) DVFS x params sweep on the Odroid model - paper Figs 21-24")
    points = dvfs_sweep(cascade.stage_sizes(), error_table(cells),
                        height=240, width=320, n_images=4,
                        steps=(1, 2, 3), scale_factors=(1.2, 1.35))
    best = optimal_operating_point(points, max_error=0.10)
    print(f"   Table-I optimum: big={best.f_big} GHz, "
          f"LITTLE={best.f_little} GHz, step={best.step}, "
          f"scale={best.scale_factor} -> {best.makespan:.2f}s, "
          f"{best.energy:.1f}J, err={best.error_frac:.2%}")

    print("3) detection at the optimal operating point")
    det = Detector(cascade, EngineConfig(mode="wave", step=best.step,
                                         scale_factor=best.scale_factor,
                                         min_neighbors=2), device=device)
    img, gt = render_scene(np.random.default_rng(7), 128, 128, n_faces=2)
    print(f"   gt={gt.tolist()}  detected={det.detect(img).tolist()}")


if __name__ == "__main__":
    main()
