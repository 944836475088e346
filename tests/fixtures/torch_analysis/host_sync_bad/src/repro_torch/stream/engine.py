"""Seeded HOST_SYNC fixture: eight host syncs in the streaming hot path,
none justified (the chained ``.numpy()`` is the same sync as its
``.cpu()``)."""
import numpy as np
import torch


def leaky_step(state, out, event):
    bitmap = state.bitmap.cpu()                # sync 1: .cpu()
    flags = out.flags.tolist()                 # sync 2: .tolist()
    slots = out.slots.cpu().numpy()            # sync 3: .cpu(), once
    ref = state.ref.to("cpu")                  # sync 4: .to("cpu")
    torch.cuda.synchronize()                   # sync 5: torch.cuda
    event.synchronize()                        # sync 6: an event
    n = out.n_rec.item()                       # sync 7: .item()
    drift = np.asarray(state.drift)            # sync 8: np.asarray
    return bitmap, flags, slots, ref, n, drift
