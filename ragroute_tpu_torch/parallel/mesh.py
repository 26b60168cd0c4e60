"""Device mesh construction.

PyTorch port of :mod:`ragroute_tpu.parallel.mesh`. The scaling axes of the
federated index-and-query engine:

* ``dp``  — query-batch data parallelism: each row of the mesh handles a
  slice of the incoming batch.
* ``idx`` — index parallelism: the document axis of every corpus shard is
  split across the row's devices (a corpus larger than one card's memory
  spans cards); each cell runs its local top-k, then the candidates are
  gathered to the row and merged.

A :class:`Mesh` is a ``[dp, idx]`` array of ``torch.device``. A list may name
one device more than once: ``[torch.device("cpu")] * 8`` stands in for the
eight host devices the JAX package's tests force, and ``cuda:0`` named four
times runs a 2x2 mesh on one card, each cell with launches of its own. Cells
on the same device share its memory: a row slice handed to such a cell is a
view, not a copy.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

AXES = ("dp", "idx")


class Mesh:
    """A ``(dp, idx)`` grid of devices (``devices[d][i]`` is cell (d, i)).

    ``shape`` is ``{"dp": dp, "idx": idx}`` as in JAX. ``process_of`` maps a
    cell to the process that owns it (all 0 in one process; see
    :mod:`ragroute_tpu_torch.parallel.multihost`)."""

    axis_names = AXES

    def __init__(self, devices: Sequence[Sequence[torch.device]], *,
                 process_of: Optional[Sequence[Sequence[int]]] = None,
                 process_index: int = 0):
        self.devices = tuple(tuple(torch.device(d) for d in row)
                             for row in devices)
        dp = len(self.devices)
        idx = len(self.devices[0]) if dp else 0
        if dp < 1 or idx < 1 or any(len(r) != idx for r in self.devices):
            raise ValueError("a mesh needs a non-empty [dp, idx] grid")
        self.process_of = (tuple(tuple(int(p) for p in r) for r in process_of)
                           if process_of is not None
                           else tuple((0,) * idx for _ in range(dp)))
        self.process_index = int(process_index)

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": len(self.devices), "idx": len(self.devices[0])}

    @property
    def primary(self) -> torch.device:
        """The device routing, the row merges' results and the host copy
        live on: the first cell this process owns."""
        for d, row in enumerate(self.devices):
            for i, dev in enumerate(row):
                if self.process_of[d][i] == self.process_index:
                    return dev
        return self.devices[0][0]

    def local(self, d: int, i: int) -> bool:
        """Whether this process owns cell ``(d, i)``."""
        return self.process_of[d][i] == self.process_index

    @property
    def multiprocess(self) -> bool:
        return any(p != self.process_index
                   for row in self.process_of for p in row)

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape['dp']}, idx={self.shape['idx']}, "
                f"devices={[[str(d) for d in r] for r in self.devices]})")


def default_devices() -> Tuple[torch.device, ...]:
    """Every visible card (the CPU when there is none)."""
    if torch.cuda.is_available():
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (torch.device("cpu"),)


def make_mesh(dp: int = 1, idx: Optional[int] = None, *,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a ``(dp, idx)`` mesh over ``devices`` (default: every visible
    card). ``idx`` defaults to ``len(devices) // dp``; the checks are the
    JAX package's."""
    devs = [torch.device(d) for d in
            (devices if devices is not None else default_devices())]
    n = len(devs)
    if idx is None:
        if n % dp != 0:
            raise ValueError(f"{n} devices not divisible by dp={dp}")
        idx = n // dp
    if dp * idx != n:
        raise ValueError(f"dp*idx = {dp * idx} != {n} devices")
    return Mesh([devs[r * idx:(r + 1) * idx] for r in range(dp)])


def parse_mesh_spec(spec: str) -> Tuple[int, int]:
    """Parse a ``--mesh DPxIDX`` spec ("2x4") into ``(dp, idx)``."""
    try:
        dp_s, idx_s = spec.lower().split("x")
        dp, idx = int(dp_s), int(idx_s)
    except ValueError:
        raise ValueError(
            f"--mesh expects DPxIDX (e.g. 2x4), got {spec!r}") from None
    if dp < 1 or idx < 1:
        raise ValueError(f"--mesh axes must be >= 1, got {spec!r}")
    return dp, idx
