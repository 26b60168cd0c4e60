"""Multi-process deployment: the federation spanning processes.

PyTorch port of :mod:`ragroute_tpu.parallel.multihost`. A deployment over
several processes changes only mesh construction and how the query batch
reaches every process; this module provides those two pieces plus the
serving lockstep:

* :func:`initialize` — join the process group (``torch.distributed``,
  backend ``"cpu:gloo,cuda:nccl"``: host tensors go over gloo, and an NCCL
  communicator starts only at the first collective over card tensors,
  which the search never makes, so a cluster whose ``idx`` stays inside
  each process never creates one).
* :func:`make_multihost_mesh` — a ``(dp, idx)`` mesh over the *global*
  device list, ordered process-major, so the ``idx`` axis (which carries
  the candidate gather) stays within each process whenever ``idx`` divides
  the local device count; only the ``dp`` axis, which exchanges nothing but
  the broadcast batch and the gathered results, crosses processes.
* :class:`LockstepEngine` — serving: process 0 owns the HTTP front end and
  broadcasts each padded batch bucket; the followers run
  :meth:`LockstepEngine.follow`'s step loop. Every process then runs the
  same step, and the results of the rows a follower computed reach the
  leader by a host all-gather.

A process names its device ``local_device_count`` times (the counterpart of
the host-platform device count the JAX package forces): two processes on
one card, each naming ``cuda:0`` twice, form a 2x2 cluster. Where ``idx``
crosses processes, the candidate gather is a ``torch.distributed``
all-gather of host tensors over the row's process group (gloo).
"""

from __future__ import annotations

import logging
import pickle
from typing import List, Optional

import numpy as np
import torch

from ragroute_tpu_torch.parallel.mesh import Mesh

log = logging.getLogger("ragroute.multihost")

_LOCAL: dict = {"devices": None}


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator: str, num_processes: int, process_id: int, *,
               local_device_count: Optional[int] = None,
               device=None) -> None:
    """Join the process group of ``num_processes`` processes whose process
    0 listens on ``coordinator`` (``host:port``).

    ``device``: this process's device (default: its first visible card,
    else the CPU); ``local_device_count``: how many mesh devices it stands
    for, each naming ``device`` (default: every visible card once)."""
    dist = _dist()
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    if local_device_count is None:
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" else [dev])
    else:
        devs = [dev] * int(local_device_count)
    backend = ("cpu:gloo,cuda:nccl"
               if dist.is_nccl_available() and torch.cuda.is_available()
               else "gloo")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    _LOCAL["devices"] = devs
    log.info("joined the process group: process %d/%d, %d local / %d "
             "global devices", process_id, num_processes, len(devs),
             device_count())


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def local_devices() -> List[torch.device]:
    if _LOCAL["devices"] is None:
        raise RuntimeError("initialize() first")
    return list(_LOCAL["devices"])


def _local_counts() -> List[int]:
    dist = _dist()
    mine = torch.tensor([len(local_devices())], dtype=torch.int64)
    outs = [torch.zeros_like(mine) for _ in range(process_count())]
    dist.all_gather(outs, mine)
    return [int(x) for x in outs]


def device_count() -> int:
    """Global device count (a collective: every process calls it)."""
    return sum(_local_counts())


def make_multihost_mesh(dp: Optional[int] = None,
                        idx: Optional[int] = None) -> Mesh:
    """A ``(dp, idx)`` mesh over the global device list, process-major, as
    the JAX package lays it out (a collective: every process calls it).
    Defaults: ``idx`` = the local device count, ``dp`` = the processes."""
    counts = _local_counts()
    n = sum(counts)
    local = counts[process_index()]
    if idx is None and dp is None:
        idx = local
        dp = n // local
    elif idx is None:
        if n % dp != 0:
            raise ValueError(f"{n} devices not divisible by dp={dp}")
        idx = n // dp
    elif dp is None:
        if n % idx != 0:
            raise ValueError(f"{n} devices not divisible by idx={idx}")
        dp = n // idx
    if dp * idx != n:
        raise ValueError(f"dp*idx = {dp * idx} != {n} global devices")
    if local % idx != 0 and idx % local != 0:
        log.warning(
            "idx=%d does not divide the local device count %d: candidate "
            "gathers will cross processes; prefer idx that keeps each "
            "group within a process", idx, local)
    me = process_index()
    mine = local_devices()
    devs, owner = [], []
    for p, c in enumerate(counts):
        for j in range(c):
            # another process's devices are named by their owner only
            devs.append(mine[j] if p == me else torch.device("cpu"))
            owner.append(p)
    grid = [devs[r * idx:(r + 1) * idx] for r in range(dp)]
    procs = [owner[r * idx:(r + 1) * idx] for r in range(dp)]
    return Mesh(grid, process_of=procs, process_index=me)


def row_groups(mesh: Mesh) -> list:
    """Per dp row: ``(group, ranks)`` of the processes owning its cells
    where there are several, else ``None``. Created once per mesh; a
    collective (every process creates every group, in row order)."""
    cached = getattr(mesh, "_row_groups", None)
    if cached is not None:
        return cached
    dist = _dist()
    out = []
    for row in mesh.process_of:
        ranks = sorted(set(row))
        if len(ranks) > 1:
            out.append((dist.new_group(ranks, backend="gloo"), ranks))
        else:
            out.append(None)
    mesh._row_groups = out
    return out


def allgather_objects(obj) -> list:
    """Every process's ``obj``, pickled into host bytes and all-gathered
    over gloo (JAX's ``process_allgather`` of host values)."""
    dist = _dist()
    data = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
    n = dist.get_world_size()
    size = torch.tensor([data.numel()], dtype=torch.int64)
    sizes = [torch.zeros_like(size) for _ in range(n)]
    dist.all_gather(sizes, size)
    buf = torch.zeros(int(max(int(x) for x in sizes)), dtype=torch.uint8)
    buf[:data.numel()] = data
    outs = [torch.zeros_like(buf) for _ in range(n)]
    dist.all_gather(outs, buf)
    return [pickle.loads(o[:int(sz)].numpy().tobytes())
            for o, sz in zip(outs, sizes)]


_STRATEGIES = ("ragroute", "all", "random", "none")


def _broadcast(t: torch.Tensor) -> torch.Tensor:
    _dist().broadcast(t, src=0)
    return t


class LockstepEngine:
    """Broadcast-driven lockstep serving over a multi-process mesh.

    Every process must run every step, but the HTTP front end (and hence
    the batch) lives only on process 0. This adapter wraps a mesh engine
    (:class:`~ragroute_tpu_torch.parallel.ShardedSearch` over a multi-process
    mesh) with the same host-facing interface, so the serving stack runs
    unmodified on process 0; followers run :meth:`follow`.

    Every :meth:`search` on the leader broadcasts, per step:

    1. header ``[4] int32`` = ``(bucket_index, strategy_index, flags,
       stop)``; flags packs ``staged`` / ``fetch_candidates``;
    2. one ``[bucket, dim]`` f32 block per world encoder;

    then every process runs the step; the followers drop its output. The
    engines' random generators stay in step because every process draws
    the same numbers from the same seed."""

    def __init__(self, engine, buckets, *, leader: bool):
        self.engine = engine
        self.buckets = tuple(int(b) for b in buckets)
        self.leader = leader
        # fail at construction, not mid-protocol: a bucket the engine would
        # refuse must never reach search(), where the header is already out
        dp = getattr(engine, "dp", 1)
        bad = [b for b in self.buckets if b % dp != 0]
        if bad:
            raise ValueError(
                f"buckets {bad} not divisible by mesh dp={dp}; "
                f"round them up (system.py does this for --mesh)")
        self.world = engine.world
        self.shard_set = engine.shard_set
        self.steps = 0

    def __getattr__(self, name):
        return getattr(self.engine, name)

    # -- process 0 -----------------------------------------------------
    def search(self, query_embs, *, strategy: str = "ragroute",
               staged: bool = False, fetch_candidates: bool = True):
        """Broadcast one batch and run the step (process 0 only)."""
        assert self.leader, "search() must only run on process 0"
        # every check that can raise runs before the first broadcast: once
        # the followers have the header they wait in the next collective,
        # and a leader that bailed would leave them there
        if "__rows__" in query_embs:
            query_embs = self.engine._host_embs(query_embs)
        missing = [e for e in self.world.encoders if e not in query_embs]
        if missing:
            raise KeyError(f"query_embs missing world encoders {missing}")
        b = np.shape(query_embs[self.world.encoders[0]])[0]
        dims = {s.encoder: s.embed_dim for s in self.world.sources}
        for enc in self.world.encoders:
            shape = np.shape(query_embs[enc])
            if shape != (b, dims[enc]):
                raise ValueError(
                    f"query_embs[{enc!r}] shape {shape} != "
                    f"({b}, {dims[enc]}) — followers allocate exactly "
                    f"that buffer")
        header = torch.tensor([
            self.buckets.index(b), _STRATEGIES.index(strategy),
            int(bool(staged)) | (int(bool(fetch_candidates)) << 1), 0,
        ], dtype=torch.int32)
        blocks = [torch.from_numpy(np.ascontiguousarray(
            query_embs[enc], np.float32)) for enc in self.world.encoders]
        _broadcast(header)
        embs = {enc: _broadcast(t).numpy()
                for enc, t in zip(self.world.encoders, blocks)}
        self.steps += 1
        return self.engine.search(
            embs, strategy=strategy, staged=staged,
            fetch_candidates=fetch_candidates)

    def search_submit(self, query_embs, *, strategy: str = "ragroute",
                      fetch_candidates: bool = True):
        from ragroute_tpu_torch.engine.engine import DoneSearch

        return DoneSearch(self.search(query_embs, strategy=strategy,
                                      fetch_candidates=fetch_candidates))

    def stop(self) -> None:
        """Release the followers (process 0, at shutdown)."""
        if self.leader:
            _broadcast(torch.tensor([0, 0, 0, 1], dtype=torch.int32))

    # -- processes 1..N-1 ---------------------------------------------
    def follow(self) -> None:
        """Step loop for follower processes; returns on the stop flag."""
        assert not self.leader
        dims = {s.encoder: s.embed_dim for s in self.world.sources}
        while True:
            header = _broadcast(torch.zeros(4, dtype=torch.int32))
            if int(header[3]):
                log.info("process %d: stop after %d steps",
                         process_index(), self.steps)
                return
            b = self.buckets[int(header[0])]
            embs = {enc: _broadcast(torch.zeros(
                (b, dims[enc]), dtype=torch.float32)).numpy()
                for enc in self.world.encoders}
            strategy = _STRATEGIES[int(header[1])]
            self.engine.search(
                embs, strategy=strategy, staged=bool(int(header[2]) & 1),
                fetch_candidates=bool(int(header[2]) & 2))
            self.steps += 1
            log.info("process %d: step %d (bucket %d, %s)",
                     process_index(), self.steps, b, strategy)
