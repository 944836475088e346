"""Train a cascade with the PyTorch port at the widths of
``scripts/train_pretrained.py`` (14 stages, 1200 + 1200 windows, 3500
features, 60 weak classifiers per stage, seed 7) and save it in the
reference's npz layout.

    python scripts/port_train_pretrained.py [OUT.npz] [--device cpu]

``OUT.npz`` defaults to ``build/port_pretrained/synthetic_face_v2.npz``
(``build/`` is git-ignored).  The file loads through either package's
``load_cascade``.  Runs on the CUDA card unless ``--device cpu``.
"""

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core import save_cascade  # noqa: E402
from repro_torch.core.training import TrainConfig, train_cascade  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=str(
        ROOT / "build" / "port_pretrained" / "synthetic_face_v2.npz"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    out = Path(args.out).resolve()
    if (ROOT / "src" / "repro") in out.parents:
        ap.error("the port never writes into the reference package")
    cfg = TrainConfig(n_stages=14, n_pos=1200, n_neg=1200, max_features=3500,
                      max_weak_per_stage=60, stage_fpr=0.4, stage_dr=0.997,
                      seed=7, verbose=True)
    casc, info = train_cascade(cfg, device=args.device)
    out.parent.mkdir(parents=True, exist_ok=True)
    save_cascade(str(out), casc, {"config": cfg._asdict(),
                                  "stages": info["stages"],
                                  "overall_dr": info["overall_dr"],
                                  "overall_fpr": info["overall_fpr"]})
    print("DONE", out, casc.n_weak, "wc", casc.n_stages, "stages",
          "DR", info["overall_dr"], "FPR", info["overall_fpr"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
