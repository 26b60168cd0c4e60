"""The harness on a small world on the CPU: a sound run is correct, each
fault planted under the timed path and the control in the program's place
are not, and the trace, metric and import rules hold."""

import importlib
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from portbench import calibrate, roofline, run, trace
from portbench.world import World

BENCH = run.load_json(os.path.join(run.ROOT, "BENCHMARK.json"))
CELLS = [c["name"] for c in BENCH["workloads"]]
SMALL_DOCS = {"pubmed": 9000, "statpearls": 3000, "textbooks": 2500,
              "wikipedia": 5000}
# IVF's recall at this size, where a probed cluster holds tens of docs:
# sound runs read a shortfall of 0.105 to 0.127, half the probes 0.185
SMALL_RECALL_SHORT = 0.15


def small(workload):
    """The cell's configuration and traffic at a size the CPU runs in
    seconds. The port's plain CPU paths multiply f32 queries where the
    card's kernels round them to bf16 (the IVF path rounds them here too),
    so the reference's query form follows the path that runs."""
    cell = run.cell_of(BENCH, workload)
    cfg = run.load_json(os.path.join(run.HERE, "configs",
                                     f"{cell['config']}.json"))
    cfg["docs"] = dict(SMALL_DOCS)
    if cfg["engine"]["impl"] != "ivf":
        cfg["reference"]["query"] = "float32"
    if "recall_short" in cfg["limits"]:
        cfg["limits"]["recall_short"] = SMALL_RECALL_SHORT
    traffic = run.load_json(os.path.join(run.HERE, "traffic",
                                         f"{cell['traffic']}.json"))
    traffic.update(batch=64, pool_batches=4, check_queries=128)
    return cfg, traffic


def run_small(workload, cache, wrap=None, seed=3_000_000_017):
    cfg, traffic = small(workload)
    return run.run_cell(BENCH, workload, seed, 0.6, False, "cpu",
                        cfg=cfg, traffic=traffic, wrap=wrap, cache=str(cache))


@pytest.mark.parametrize("workload", CELLS)
def test_small_cell_is_correct(workload, tmp_path):
    res = run_small(workload, tmp_path)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    names = {m["name"] for m in run.metric_names(
        BENCH, run.cell_of(BENCH, workload), False)}
    # a batch percentile needs 20 batches, which a slow CPU path may not
    # finish in the window
    tails = {n for n in names if run.reader_of({"name": n}) == "batch_p95_ms"}
    assert set(res["metrics"]) - tails == names - tails
    assert list(res)[-3:] == ["checks", "_values", "_window"]
    json.dumps(res)


class Faulty:
    """The program with one fault planted where its answers are made."""

    def __init__(self, base, kind):
        self.base, self.kind, self.prev = base, kind, None

    def build(self, *a, **kw):
        return self.base.build(*a, **kw)

    def source_names(self, engine):
        return self.base.source_names(engine)

    def submit(self, engine, queries, strategy):
        return self.base.submit(engine, queries, strategy)

    def answer(self, pending):
        out = {k: v.copy() for k, v in self.base.answer(pending).items()}
        if self.kind == "unchanged":
            # the step hands back the answers it held before
            prev, self.prev = self.prev, out
            return out if prev is None else prev
        if self.kind == "half_batch":
            half = out["count"].shape[0] // 2
            out["count"][half:] = 0
            out["shard"][half:] = -1
            out["score"][half:] = np.nan
            return out
        if self.kind == "altered":
            out["local"][:, 0] += 1
            return out
        raise ValueError(self.kind)


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_fault_under_the_timed_path_is_not_correct(workload, kind, tmp_path):
    res = run_small(workload, tmp_path, wrap=lambda base: Faulty(base, kind))
    assert not res["correct"], res["checks"]


def test_half_probes_is_not_correct(tmp_path):
    """IVF probing half its clusters returns the wrong docs with their
    true scores: the ivf cell's recall limit fails it."""
    from portbench.faults import half_probes

    workload = next(c["name"] for c in BENCH["workloads"]
                    if c["config"] == "medrag_ivf")
    with half_probes():
        res = run_small(workload, tmp_path)
    assert not res["correct"], res["checks"]
    assert res["checks"]["score_err"]["value"] <= \
        res["checks"]["score_err"]["limit"]


def test_every_seed_serves_the_same_relevance_sets():
    """Every run seed serves the same relevance sets in each batch, in
    another order, so the routed work of a batch does not move with the
    seed; each query is relevant to 1 to 3 sources."""
    cfg, _ = small(CELLS[0])
    w = World(cfg, "cpu")
    (qa, ra), (qb, rb) = w.pool(5, 64, 16), w.pool(6, 64, 16)
    for lo in range(0, 64, 16):
        assert torch.equal(ra[lo:lo + 16].sum(0), rb[lo:lo + 16].sum(0))
    assert not torch.equal(ra, rb)
    many = ra.sum(1)
    assert int(many.min()) == 1 and int(many.max()) == 3


@pytest.mark.parametrize("workload", CELLS)
def test_control_in_the_programs_place_is_not_correct(workload, tmp_path):
    """The reference with rows a step below the configuration's stored
    form, answering in the program's place, fails the cell's limits."""
    cfg, traffic = small(workload)
    out = calibrate.calibrate(BENCH, workload, [], [3_000_000_031],
                              0.3, "cpu", cfg=cfg, traffic=traffic,
                              cache=str(tmp_path))
    (line,) = out["control"]
    assert not line["correct"], line["values"]


def test_trace_reduce_takes_the_union_and_labels_gaps():
    from torch.autograd import DeviceType

    def ev(name, lo, hi, dev=False, thread=1):
        return types.SimpleNamespace(
            name=name, time_range=types.SimpleNamespace(start=lo, end=hi),
            device_type=DeviceType.CUDA if dev else DeviceType.CPU,
            thread=thread)

    events = [
        ev("portbench.submit", 0, 45, dev=True, thread=7),   # its mirror
        ev("portbench.submit", 0, 45), ev("aten::item", 5, 44),
        ev("cudaStreamSynchronize", 30, 43),
        ev("portbench.wait", 50, 100), ev("aten::copy_", 60, 90),
        ev("void k1(int)", 0, 10, dev=True),
        ev("void k1(int)", 5, 20, dev=True),
        ev("Memcpy DtoH", 60, 95, dev=True),
        ev("void (anonymous namespace)::k2<1>(int)", 96, 97, dev=True),
        ev("portbench.submit", 0, 45, thread=2),   # another thread's
    ]
    t = trace.reduce(events)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(56e-6)   # [0, 20], [60, 95], [96, 97]
    assert t.kernel_s["void k1(int)"] == pytest.approx(25e-6)
    assert dict(t.device_ops) == pytest.approx({
        "k1": 25e-6, "Memcpy DtoH": 35e-6, "k2<1>": 1e-6})
    # [20, 60]: its middle inside the sync; [95, 96], [97, 100]: in wait
    assert dict(t.idle_gaps) == pytest.approx({
        "submit: aten::item > cudaStreamSynchronize": 40e-6, "wait": 4e-6})


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ragroute_tpu_torch_x", types.ModuleType("x"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ragroute_tpu.engine",
                        types.ModuleType("ragroute_tpu.engine"))
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "ragroute_tpu"]


def test_entry_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc == 3
    assert capsys.readouterr().out == ""


def test_files_are_found_by_name():
    """Every metric has its reader, every cell its configuration and
    traffic files, every configuration its stored forms."""
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(importlib.import_module(
            f"portbench.metrics.{run.reader_of(m)}").read)
    for c in BENCH["configs"]:
        cfg = run.load_json(os.path.join(run.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        for form in (cfg["reference"]["rows"],
                     cfg["reference"]["control_rows"]):
            importlib.import_module(f"portbench.rows.{form}")
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(run.HERE, "traffic",
                                           f"{w['traffic']}.json"))


def test_world_is_the_same_from_the_same_seeds():
    cfg, _ = small(CELLS[0])
    a, b = World(cfg, "cpu"), World(cfg, "cpu")
    assert torch.equal(a.block(0, 0), b.block(0, 0))
    qa, qb = a.queries(5, 32, 16), b.queries(5, 32, 16)
    assert all(torch.equal(qa[e], qb[e]) for e in qa)
    assert not torch.equal(next(iter(a.queries(6, 32, 16).values())),
                           next(iter(qa.values())))
    cents = a.centroids()
    ra, rb = a.router_state(cents), b.router_state(cents)
    assert all(torch.equal(ra[k], rb[k]) for k in ra)


def test_roofline_copies_the_ports_bounds():
    """The frozen bound of K1 equals the port's ``k1_bound`` at a shape."""
    from ragroute_tpu_torch.ops.kernel_checks import Case, k1_bound

    for dtype, tdtype in (("bfloat16", torch.bfloat16), ("int8", torch.int8)):
        n, d, b, k = 5000, 64, 48, 32
        case = Case("x", torch.zeros((b, d)), torch.zeros((n, d), dtype=tdtype),
                    k, "dot", bias=torch.zeros(n),
                    scale=torch.ones(n) if dtype == "int8" else None)
        ms = k1_bound(case)["bound_ms"]
        assert roofline.k1_bound_s(b, n, d, k, dtype) * 1e3 == \
            pytest.approx(ms, rel=1e-12)


@pytest.mark.gpu
def test_control_fails_at_the_cells_size():
    """On the card, at the cell's own size: the control fails each cell,
    and so does a cell's planted fault."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    for workload in CELLS:
        cfg = run.load_json(os.path.join(run.ROOT, next(
            c["file"] for c in BENCH["configs"]
            if c["name"] == run.cell_of(BENCH, workload)["config"])))
        faults = [3_000_000_043] if "fault" in cfg["reference"] else []
        out = calibrate.calibrate(BENCH, workload, [], [3_000_000_041],
                                  3.0, "cuda:0", fault_seeds=faults)
        for line in out["control"] + out["fault"]:
            assert not line["correct"], line
