"""Cascade early-exit LM serving on the PyTorch port: the paper's
stage-wise rejection and criticality batching applied to decoder LMs
(``examples/early_exit_serving.py`` through ``repro_torch``).

    PYTHONPATH=src python examples/torch_early_exit_serving.py [--device cpu]

With no ``--device`` it runs on the card (``cuda``) and fails without
one.  The decode steps donate their cache (``donate=True``): each step
writes the new entries into the cache it is given.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.models.early_exit import CascadeBatcher, ExitConfig
from repro_torch.serve import make_cascade_decode_step, make_prefill_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="the port's early-exit LM")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    print(f"device: {device}")
    cfg = get_smoke_config("olmo-1b").with_(n_layers=8)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    B, S = 8, 16
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (B, S))).to(device)
    cache = model.init_cache(B, 64)
    _, cache = make_prefill_step(model, donate=True)(params, tokens, cache)

    # exits after scan groups 1/3/5: cascade stages over layer groups
    ecfg = ExitConfig(exit_groups=(1, 3, 5), thresholds=(0.6, 0.5, 0.4))
    step = make_cascade_decode_step(model, ecfg, donate=True)

    batcher = CascadeBatcher(model.n_scan)
    tok = tokens[:, -1]
    all_depths = []
    for _ in range(16):
        tok, cache, depth = step(params, tok, cache)
        all_depths.append(depth.cpu().numpy())
        for b in range(B):
            batcher.observe(b, float(depth[b]))
    depths = np.stack(all_depths)

    print(f"exit depth (of {model.n_scan} groups): "
          f"mean={depths.mean():.2f}, min={depths.min()}, "
          f"max={depths.max()}")
    print(f"executed fraction (delayed rejection): "
          f"{depths.mean() / model.n_scan:.1%}")
    wave = sum(batcher.group_budget(batcher.bucket(b)) for b in range(B))
    print(f"wave-compaction layer-groups/step: {wave} vs full "
          f"{B * model.n_scan} -> modeled compute/energy saving "
          f"{1 - wave / (B * model.n_scan):.1%}")
    print(f"buckets: {batcher.batches(list(range(B)))}")


if __name__ == "__main__":
    main()
