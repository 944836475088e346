"""Production meshes.

Single pod: (data=16, model=16), 256 chips.  Multi-pod: (pod=2, data=16,
model=16), 512 chips; the ``pod`` axis joins batch data parallelism
(outermost, so its collectives are the rarest and most overlappable).

Each function is an ``init_device_mesh`` over the process group the
caller has started (NCCL or gloo ranks, or ``dryrun.py``'s fake world),
whose world size must be the mesh's size.  The device type is the
card's unless the caller names ``"cpu"``.  Functions, not module
constants: importing this module touches no process group.
"""

from __future__ import annotations

import math

from torch.distributed.device_mesh import init_device_mesh

from ..device import resolve_device

__all__ = ["make_production_mesh", "make_smoke_mesh", "make_mesh",
           "mesh_chips"]


def make_mesh(shape: tuple, axes: tuple, device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` on the started group."""
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(data: int = 2, model: int = 4, device=None):
    """Small (data, model) mesh for the distributed tests (a world of
    ``data * model`` ranks)."""
    return make_mesh((data, model), ("data", "model"), device)


def mesh_chips(mesh) -> int:
    return int(math.prod(mesh.shape))
