"""Training loop: config -> (mesh ->) model -> train step ->
checkpointed loop.

Atomic checkpoint and restart, deterministic resumable data, a straggler
detector fed the step times, optional int8 gradient compression, a
restart-bounded loop.  ``train_loop(mesh=)`` trains on a device mesh
(``launch.mesh``) over the process group the caller started: the model
and state sharded by ``make_rules(mesh)``, every rank building the same
global batch and keeping its dp shard, checkpoints gathered on save and
restored shard by shard.

On the CPU (the smoke config of an architecture):

    python -m repro_torch.launch.train --arch olmo-1b --smoke --device cpu \\
        --steps 200 --batch 8 --seq 256 --ckpt run1
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs import get_config, get_smoke_config
from ..data import SyntheticTokens
from ..distributed.compression import make_compressor
from ..distributed.fault import StragglerDetector, run_with_restarts
from ..distributed.sharding import (batch_pspecs, distribute, make_rules,
                                    shardings_of)
from ..models import Model
from ..train import init_train_state, make_train_step

__all__ = ["train_loop", "main"]


def train_loop(*, cfg, steps: int, batch: int, seq: int, ckpt: str | None,
               lr: float = 3e-4, microbatch: int = 0, mesh=None,
               compress: bool = False, ckpt_every: int = 50,
               log_every: int = 10, seed: int = 0,
               fail_at: int | None = None, device=None) -> dict:
    """Train ``steps`` steps from the latest checkpoint in ``ckpt`` (or
    from seed ``seed``) and return the last step's metrics as floats.
    ``mesh``: a ``DeviceMesh`` (every rank of it calls this).
    ``fail_at``: raise ``RuntimeError`` at that step (fault-tolerance
    tests).  ``device``: the card unless the caller names one (the
    mesh's device type with a mesh)."""
    rules = make_rules(mesh) if mesh is not None else None
    model = Model(cfg, device, rules)
    loud = mesh is None or dist.get_rank() == 0      # one rank logs
    pipe = SyntheticTokens(cfg.vocab_size, batch, seq, seed=seed)
    compressor = make_compressor()[0] if compress else None
    step_fn = make_train_step(
        model, peak_lr=lr, warmup=max(steps // 20, 5), total_steps=steps,
        microbatch=microbatch, compress_grads=compressor)

    state = init_train_state(
        model, torch.Generator(device=model.device).manual_seed(seed))
    start = 0
    if ckpt and latest_step(ckpt) is not None:
        if mesh is None:
            state, start, _ = restore_checkpoint(ckpt, state,
                                                 device=model.device)
        else:
            state, start, _ = restore_checkpoint(
                ckpt, state, shardings=shardings_of(state))
        if loud:
            print(f"restored step {start} from {ckpt}")

    det = StragglerDetector(n_pods=1)
    metrics: dict = {}
    t_last = time.time()
    for step in range(start, steps):
        if fail_at is not None and step == fail_at:
            raise RuntimeError(f"injected failure at step {step}")
        batch_t = {k: torch.from_numpy(v).to(model.device)
                   for k, v in pipe(step).items()}
        if mesh is not None:
            batch_t = distribute(batch_t, batch_pspecs(batch_t, rules), mesh)
        state, metrics = step_fn(state, batch_t)
        if ckpt and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt, step + 1, state,
                            metadata={"loss": float(metrics["loss"])})
        if (step + 1) % log_every == 0:
            dt = time.time() - t_last
            t_last = time.time()
            det.update([dt / log_every])
        if (step + 1) % log_every == 0 and loud:
            print(f"step {step + 1}/{steps} loss={float(metrics['loss']):.4f}"
                  f" acc={float(metrics['accuracy']):.3f}"
                  f" gnorm={float(metrics['grad_norm']):.2f}"
                  f" {dt / log_every * 1e3:.0f} ms/step", flush=True)
    if ckpt:
        save_checkpoint(ckpt, steps, state,
                        metadata={"loss": float(metrics.get("loss", 0.0))})
    return {k: float(v) for k, v in metrics.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU scale)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    args = ap.parse_args()

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)

    def loop(attempt):
        if attempt:
            print(f"restart #{attempt}")
        return train_loop(cfg=cfg, steps=args.steps, batch=args.batch,
                          seq=args.seq, ckpt=args.ckpt, lr=args.lr,
                          microbatch=args.microbatch,
                          compress=args.compress, device=args.device)

    out = run_with_restarts(loop, max_restarts=args.max_restarts)
    print("final:", {k: round(v, 4) for k, v in out.items()
                     if k in ("loss", "accuracy", "nll")})


if __name__ == "__main__":
    main()
