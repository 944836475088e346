"""Deterministic, resumable token pipelines (numpy), the reference's.

Determinism contract: ``batch(step)`` is a pure function of (seed, step,
shape), so resuming from a checkpoint at step k reproduces the exact
stream with no iterator state to save.  Per-pod sharding composes the
same way: each pod slices its share of the global batch by rank, and the
heterogeneous-pod partitioner (``scheduling/hetero.py``) can re-split
shares at any step boundary because nothing is stateful.  The Philox
keying is the reference's, so both packages give the same batches.

Two backends: ``SyntheticTokens`` (counter-derived ids, the smoke and
benchmark default) and ``FileTokens`` (a memmapped flat token file;
windows strided deterministically by step)."""

from __future__ import annotations

import numpy as np

__all__ = ["SyntheticTokens", "FileTokens", "make_pipeline"]


class SyntheticTokens:
    """Pseudorandom-but-deterministic tokens: id = hash(seed, step, b, s).

    Uses Philox counter RNG keyed on (seed, step) so batches are O(1) to
    reproduce at any step.
    """

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0):
        self.vocab_size = vocab_size
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int, rank: int = 0, world: int = 1) -> dict:
        b0, b1 = _share(self.batch, rank, world)
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=[0, 0, 0, step]))
        tokens = rng.integers(0, self.vocab_size,
                              (self.batch, self.seq_len + 1), dtype=np.int32)
        return {"tokens": tokens[b0:b1]}

    def __call__(self, step: int, **kw) -> dict:
        return self.batch_at(step, **kw)


class FileTokens:
    """Flat .bin (int32) token file, memmapped; step-strided windows.

    window(step, i) = tokens[(step·B + i)·S' mod (len − S')], S' = S+1.
    Deterministic and seekable; no shuffle buffer state to checkpoint.
    """

    def __init__(self, path: str, batch: int, seq_len: int,
                 vocab_size: int | None = None):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.batch = batch
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        if len(self.data) < seq_len + 1:
            raise ValueError("token file shorter than one sequence")

    def batch_at(self, step: int, rank: int = 0, world: int = 1) -> dict:
        b0, b1 = _share(self.batch, rank, world)
        S1 = self.seq_len + 1
        n_windows = len(self.data) - S1
        out = np.empty((b1 - b0, S1), np.int32)
        for j, i in enumerate(range(b0, b1)):
            off = ((step * self.batch + i) * S1) % n_windows
            out[j] = self.data[off:off + S1]
        if self.vocab_size:
            out = out % self.vocab_size
        return {"tokens": out}

    def __call__(self, step: int, **kw) -> dict:
        return self.batch_at(step, **kw)


def _share(total: int, rank: int, world: int) -> tuple[int, int]:
    base = total // world
    rem = total % world
    b0 = rank * base + min(rank, rem)
    return b0, b0 + base + (1 if rank < rem else 0)


def make_pipeline(kind: str, **kw):
    if kind == "synthetic":
        return SyntheticTokens(**kw)
    if kind == "file":
        return FileTokens(**kw)
    raise ValueError(kind)
