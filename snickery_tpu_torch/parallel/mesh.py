"""Device mesh of the port: a (data, db) grid of torch devices.

Counterpart of ``snickery_tpu.parallel.mesh``.  Axes:

- ``data``: data-parallel over utterances (the batch axis of a synthesis
  step);
- ``db``: row shards of the unit database.

One process drives every member, as the JAX package's single controller
does.  A member is a ``torch.device`` and members may repeat: eight members
on ``"cpu"`` stand in for the JAX tests' eight virtual devices, and a 2 x 2
mesh can run on one card (``["cuda:0"] * 4``).  Nothing wraps a mesh onto
fewer cards than it asks for.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    """An (n_data, n_db) grid of devices: ``devices[d][j]`` is member
    (d, j)."""
    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.devices), "db": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    def distinct(self) -> list[torch.device]:
        """The distinct devices of the mesh, in member order."""
        seen: list[torch.device] = []
        for row in self.devices:
            for dev in row:
                if dev not in seen:
                    seen.append(dev)
        return seen


def _device(dev) -> torch.device:
    """``dev`` as a torch.device with its card index ("cuda" is the current
    card), so that members on one card compare equal."""
    dev = torch.device(dev)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh member {dev}: CUDA is not available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_mesh(n_data: int = 0, n_db: int = 1, devices=None) -> Mesh:
    """Build a (data, db) mesh.  ``n_data=0`` means all the devices the db
    axis leaves.  ``devices=None`` means the first ``n_data * n_db`` CUDA
    devices (all of them for ``n_data=0``): it raises where CUDA is absent or
    has fewer cards.  An explicit list may repeat a device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(): CUDA is not available; pass "
                               "devices= explicitly (e.g. ['cpu'] * 8)")
        count = torch.cuda.device_count()
        want = count if n_data == 0 else n_data * n_db
        if want > count:
            raise RuntimeError(
                f"mesh {n_data}x{n_db} needs {want} CUDA devices, the machine has "
                f"{count}; pass devices= (e.g. ['cuda:0'] * {want}) to repeat one")
        devices = [torch.device("cuda", i) for i in range(want)]
    devices = [_device(d) for d in devices]
    n = len(devices)
    if n_db < 1 or n % n_db != 0:
        raise ValueError(f"n_db={n_db} must divide device count {n}")
    if n_data == 0:
        n_data = n // n_db
    if n_data * n_db != n:
        raise ValueError(f"mesh {n_data}x{n_db} != {n} devices")
    return Mesh(tuple(tuple(devices[d * n_db:(d + 1) * n_db]) for d in range(n_data)))
