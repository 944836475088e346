"""Cascade early-exit decoding: the paper's technique applied to LMs.

The mapping: cascade stages = layer groups; detection windows = sequences
in the decode batch; stage thresholds = per-exit confidence thresholds.
The paper's two execution strategies both exist:

- **delayed rejection** (paper section 7.1 baseline): every sequence runs
  all layers; exits only *select* which logits to emit.  This is what a
  SIMD batch executes anyway: ``decode_step_cascade`` returns per-token
  exit depths so the serving layer can see the wasted work.
- **wave compaction**: the serving layer re-batches sequences by
  *predicted* depth (``CascadeBatcher``), so a batch of easy tokens
  really does stop at an early exit.

Exit heads are tied to the LM head (no extra vocab-sized parameters);
confidence = top-1 softmax probability against a per-exit threshold,
exactly a cascade stage's accept test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["ExitConfig", "exit_logits", "decode_step_cascade",
           "CascadeBatcher", "expected_depth"]


@dataclass(frozen=True)
class ExitConfig:
    exit_groups: tuple        # scan-group indices with an exit after them
    thresholds: tuple         # per-exit top-1 prob threshold


def exit_logits(model, params, x):
    """LM-head logits from an intermediate hidden state (tied head)."""
    return model._head(params, x)


def decode_step_cascade(model, params, token, cache, ecfg: ExitConfig,
                        donate: bool = False):
    """Masked (delayed-rejection) cascade decode step.

    Runs the full stack (SIMD semantics) but evaluates the exit head after
    each listed scan group and records, per sequence, the first exit whose
    confidence clears its threshold.  Returns (logits, new_cache,
    exit_depth (B,) int32).  An exit's threshold is looked up as the
    reference looks it up (``searchsorted`` over ``exit_groups``, clipped),
    in float32.  ``donate``: the new cache is ``cache``'s tensors, written
    in place (``Model.decode_step``'s).
    """
    B = token.shape[0]
    dev = model.device
    exit_set = np.asarray(ecfg.exit_groups)
    thresholds = torch.tensor(ecfg.thresholds, dtype=torch.float32,
                              device=dev)
    state = {"chosen": None,
             "depth": torch.full((B,), model.n_scan, dtype=torch.int32,
                                 device=dev),
             "done": torch.zeros((B,), dtype=torch.bool, device=dev)}

    def after_group(gi, x):
        if gi not in exit_set:
            return
        ti = int(np.clip(np.searchsorted(exit_set, gi), 0, len(exit_set) - 1))
        logits = exit_logits(model, params, x)              # (B,1,V)
        conf = torch.softmax(logits.float(), -1).amax(-1)[:, 0]
        fire = (conf >= thresholds[ti]) & ~state["done"]
        chosen = state["chosen"]
        if chosen is None:
            chosen = torch.zeros_like(logits)
        state["chosen"] = torch.where(fire[:, None, None], logits, chosen)
        state["depth"] = torch.where(fire, gi + 1, state["depth"])
        state["done"] = state["done"] | fire

    x = model._embed(params, token[:, None])
    x, new_cache, _ = model._stack_walk(params, x, cache, after_group,
                                        donate)
    new_cache["len"] = cache["len"] + 1
    logits = model._head(params, x)
    if state["chosen"] is not None:
        logits = torch.where(state["done"][:, None, None], state["chosen"],
                             logits)
    return logits, new_cache, state["depth"]


def expected_depth(depths: torch.Tensor, n_groups: int) -> float:
    """Mean executed fraction: the cascade's compute-saving potential
    (1.0 = no early exit ever fires)."""
    return float(depths.float().mean() / max(n_groups, 1))


class CascadeBatcher:
    """Wave-compaction serving: bucket sequences by observed exit depth.

    The paper's Botlev insight at the serving layer: deep (critical)
    sequences are batched together and run the full stack on the fast
    path; shallow ones share early-exit batches.  An EWMA of each
    stream's recent exit depths predicts its bucket; misprediction just
    costs the delayed-rejection overhead for that step.
    """

    def __init__(self, n_groups: int, boundaries: tuple = (0.34, 0.67),
                 ewma: float = 0.8):
        self.n_groups = n_groups
        self.bounds = tuple(boundaries)
        self.ewma = ewma
        self._depth: dict = {}

    def observe(self, stream_id, depth: float):
        prev = self._depth.get(stream_id, float(self.n_groups))
        self._depth[stream_id] = (self.ewma * prev + (1 - self.ewma)
                                  * float(depth))

    def bucket(self, stream_id) -> int:
        frac = self._depth.get(stream_id, self.n_groups) / self.n_groups
        for b, lim in enumerate(self.bounds):
            if frac <= lim:
                return b
        return len(self.bounds)

    def batches(self, stream_ids) -> list[list]:
        out: list[list] = [[] for _ in range(len(self.bounds) + 1)]
        for s in stream_ids:
            out[self.bucket(s)].append(s)
        return [b for b in out if b]

    def group_budget(self, bucket_idx: int) -> int:
        """Layer-group budget for a bucket (truncated stack depth)."""
        if bucket_idx >= len(self.bounds):
            return self.n_groups
        return max(1, int(np.ceil(self.bounds[bucket_idx] * self.n_groups)))
