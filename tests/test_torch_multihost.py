"""A two-process cluster of the port (CPU, gloo).

Two subprocess workers (``torch_multihost_worker.py``, torch and the port
only) join one ``torch.distributed`` process group, each naming the CPU four
times (``local_device_count=4``), and run :class:`ShardedSearch` over the
global eight-device mesh: ``2x4`` and ``4x2`` keep each ``idx`` group inside
one process, ``1x8`` crosses the two processes, so its candidate gather is
a gloo all-gather (exact, IVF). Every output equals the single-process
port over ``[cpu] * 8`` bit for bit, and the exact winners equal
``oracle.exact_oracle``'s. A served query through the leader of a ``--mesh
2x4`` cluster equals the single-process server's answer; the leader checks
a batch before it broadcasts anything.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from ragroute_tpu_torch.oracle import exact_oracle
from ragroute_tpu_torch.parallel import (LockstepEngine, ShardedSearch,
                                         make_mesh, parse_mesh_spec)
from torch_multihost_worker import LAYOUTS
from torch_multihost_world import world_and_engine_parts
from torch_serving import normalize, query_path, request

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_multihost_worker.py")


@pytest.fixture(autouse=True)
def _one_thread():
    """One thread for torch and for numpy's BLAS: the suite's workers share
    the cores, and oversubscribed ``eigh`` / matmul calls crawl."""
    torch.set_num_threads(1)
    with threadpool_limits(limits=1):
        yield


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONSTARTUP", "RAGROUTE_LOCAL_DEVICES")}
    env["OMP_NUM_THREADS"] = "1"
    return env


def _workers(mode, arg, port):
    return [subprocess.Popen(
        [sys.executable, WORKER, mode, str(pid), str(port), str(arg)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=os.path.dirname(HERE)) for pid in range(2)]


def test_cluster_equals_the_single_process_port_and_the_oracle(tmp_path):
    procs = _workers("search", tmp_path, _free_port())
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    for spec, impl, strategy in LAYOUTS:
        got = np.load(tmp_path / f"{spec}_{impl}_{strategy}.npz")
        syn, ss, router, bank = world_and_engine_parts(impl)
        dp, idx = parse_mesh_spec(spec)
        eng = ShardedSearch(ss, router, bank,
                            make_mesh(dp, idx, devices=["cpu"] * 8),
                            impl=impl)
        want = eng.search(dict(syn.query_embs), strategy=strategy)
        for f in got.files:
            np.testing.assert_array_equal(got[f], getattr(want, f),
                                          err_msg=f"{spec} {impl} {f}")
        if impl != "exact":
            continue
        oracle = exact_oracle(syn.world, syn.embeddings, syn.query_embs,
                              syn.world.k, mask=got["mask"])
        for q, ref in enumerate(oracle):
            won = {(int(s), int(li)) for s, li in zip(
                got["merged_shard"][q], got["merged_local"][q]) if s >= 0}
            assert len(won & ref) >= syn.world.k - 1, (spec, q)


def test_leader_serves_a_query_for_the_cluster(tmp_path):
    """``--mesh 2x4 --num-processes 2``: process 0 answers HTTP and
    broadcasts each batch, process 1 follows and logs its steps; the answer
    equals the single-process server's; SIGTERM on the leader releases
    the follower."""
    import signal

    from ragroute_tpu_torch.main import parse_args
    from ragroute_tpu_torch.system import ServingSystem
    from torch_serving import serving

    http_port = _free_port()
    procs = _workers("serve", http_port, _free_port())
    q = query_path("what about the fox", {"A": "x", "B": "y"}, "q1")
    try:
        deadline = time.time() + 240
        body = None
        while time.time() < deadline:
            try:
                st, _, body = request(http_port, "GET", q, timeout=60)
                break
            except OSError:
                time.sleep(0.5)
        assert body is not None and st == 200
        procs[0].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], outs[0][-2000:]
    assert "process 1: step" in outs[1] and "stop after" in outs[1]
    single = ServingSystem(parse_args([
        "--dataset", "medrag", "--simulate", "--disable-llm", "--device",
        "cpu", "--dtype", "float32", "--buckets", "8", "--port", "0"]))
    with serving(single.build()) as port:
        want = request(port, "GET", q)[2]
    assert normalize(body) == normalize(want)
    assert json.loads(body)["metadata"]["top_docs"]


class _Engine:
    """A stand-in mesh engine: records whether a step ran."""

    def __init__(self, syn, dp):
        self.world, self.shard_set, self.dp = syn.world, None, dp
        self.steps = 0

    def search(self, *a, **k):
        self.steps += 1


def test_leader_validates_everything_before_the_first_broadcast(monkeypatch):
    from ragroute_tpu_torch.parallel import multihost

    syn = world_and_engine_parts("exact")[0]
    sent = []
    monkeypatch.setattr(multihost, "_broadcast",
                        lambda t: sent.append(t) or t)
    with pytest.raises(ValueError, match="not divisible by mesh dp=2"):
        LockstepEngine(_Engine(syn, 2), (3, 8), leader=True)
    eng = LockstepEngine(_Engine(syn, 2), (8, 16), leader=True)
    embs = dict(syn.query_embs)
    bad = [
        ({e: v for e, v in embs.items()
          if e != syn.world.encoders[0]}, KeyError),
        ({e: v[:8, :-1] for e, v in embs.items()}, ValueError),
        ({e: v[:4] for e, v in embs.items()}, ValueError),   # no bucket
    ]
    for q, exc in bad:
        with pytest.raises(exc):
            eng.search(q, strategy="all")
    with pytest.raises(ValueError):
        eng.search({e: v[:8] for e, v in embs.items()}, strategy="nearest")
    assert sent == [] and eng.engine.steps == 0
    eng.search({e: v[:8] for e, v in embs.items()}, strategy="all")
    assert len(sent) == 1 + len(syn.world.encoders)
    assert eng.engine.steps == 1
    with pytest.raises(AssertionError):
        LockstepEngine(_Engine(syn, 2), (8,), leader=False).search(embs)
