"""End-to-end training on the port: the ~115M-parameter dense LM of
``scripts/train_100m.py`` (``repro-115m``) for a few hundred steps with the
full stack (pipeline -> train step -> AdamW -> atomic checkpoints ->
restart loop), on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python scripts/port_train_100m.py --steps 300
    PYTHONPATH=src python scripts/port_train_100m.py --device cpu --steps 20
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs.base import ModelConfig            # noqa: E402
from repro_torch.distributed.fault import run_with_restarts  # noqa: E402
from repro_torch.launch.train import train_loop             # noqa: E402
from repro_torch.models import param_count                  # noqa: E402

CFG_100M = ModelConfig(
    name="repro-115m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=50304,
    param_dtype="float32",
    compute_dtype="float32",
)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join("build", "repro_100m"))
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    args = ap.parse_args()

    print(f"config: {CFG_100M.name}, N = {param_count(CFG_100M) / 1e6:.1f}M "
          f"params", flush=True)

    def loop(attempt):
        return train_loop(cfg=CFG_100M, steps=args.steps, batch=args.batch,
                          seq=args.seq, ckpt=args.ckpt, lr=6e-4,
                          ckpt_every=50, log_every=10, device=args.device)

    out = run_with_restarts(loop, max_restarts=2)
    print("final:", {k: round(v, 4) for k, v in out.items()
                     if k in ("loss", "nll", "accuracy")})


if __name__ == "__main__":
    main()
