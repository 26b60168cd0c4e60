"""Run one benchmark cell of the port on the card and print its result.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``workloads`` in ``BENCHMARK.json``) names a configuration
(``portbench/configs/<config>.json``: the world, the program's storage form
and layout, the check's limits) and a traffic mix
(``portbench/traffic/<traffic>.json``: batch size, batches in flight,
routing, the query pool and the checked queries). A run

1. makes the world on the card from the configuration's seeds and the query
   pool from ``--seed``, builds the program through its own set-up path and
   runs every pool batch once: the set-up, ``setup_s``;
2. runs a closed loop of batches for ``--seconds``: batch t + 1 is launched
   (``search_submit``) before batch t is waited on (``wait``), as many in
   flight as the traffic says, the pool's batches in turn;
3. with ``--trace 1``, runs the loop again for ``TRACE_SECONDS`` under
   ``torch.profiler``;
4. reads the peak device memory, frees the program, and holds the answers
   of the checked queries, as the window last served them, against the
   plain reference (``portbench/reference.py``, ``portbench/compare.py``);
5. prints the numbers compared beside their limits on standard error, and
   as the last line of standard output one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
   or with ``--trace 1`` its per-layer metrics, each read by
   ``portbench/metrics/<name>.py``), ``device``, with ``--trace 1``
   ``breakdown``, and ``checks`` last.

It exits 3 without a result where there is no CUDA card or fewer than the
cell asks for, and 4 where a module of JAX or of the JAX package is loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "ragroute_tpu")
TRACE_SECONDS = 3.0


def _environment() -> None:
    """Caches inside the checkout at fixed paths; no JAX through a library
    that would load it on its own."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``ragroute_tpu_torch`` is neither)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


@dataclasses.dataclass
class Batch:
    pool: int                    # pool batch served
    launch: float                # search_submit called
    launched: float              # search_submit returned
    waiting: float               # wait() called
    done: float                  # wait() returned
    routed: Dict[str, int]       # queries routed to each source


@dataclasses.dataclass
class Window:
    batches: List[Batch]
    seconds: float               # first launch to last answer
    queries: int                 # queries answered
    attempted: int
    failed: int


@dataclasses.dataclass
class Context:
    cfg: dict
    traffic: dict
    shapes: dict
    window: Window
    traced: Optional[Window]
    trace: object
    setup_s: float
    check: dict


def _no_span(name):
    return contextlib.nullcontext()


def closed_loop(engine, program, batches, strategy: str, depth: int, *,
                seconds: Optional[float] = None, count: Optional[int] = None,
                keep: Optional[Callable] = None, span=_no_span,
                names=None) -> Window:
    """Batches of the pool in turn, ``depth`` in flight: a batch is
    launched before the oldest in flight is waited on. Runs ``count``
    batches, or until ``seconds`` have passed, then waits for the rest."""
    done: List[Batch] = []
    inflight = collections.deque()
    failed = attempted = 0
    bsz = len(next(iter(batches[0].values())))
    clock = time.perf_counter
    start = clock()
    deadline = start + (seconds or 0.0)

    def finish():
        nonlocal failed
        b, launch, launched, pending = inflight.popleft()
        waiting = clock()
        try:
            with span("portbench.wait"):
                out = program.answer(pending)
        except Exception:  # a failed batch is counted, the loop goes on
            failed += bsz
            traceback.print_exc(file=sys.stderr)
            return
        routed = out["mask"].sum(axis=0)
        done.append(Batch(b, launch, launched, waiting, clock(),
                          {n: int(r) for n, r in zip(names, routed)}))
        if keep is not None:
            keep(b, out)

    i = 0
    while (i < count) if count is not None else (clock() < deadline):
        b = i % len(batches)
        i += 1
        attempted += bsz
        launch = clock()
        try:
            with span("portbench.submit"):
                pending = program.submit(engine, batches[b], strategy)
        except Exception:
            failed += bsz
            traceback.print_exc(file=sys.stderr)
            continue
        inflight.append((b, launch, clock(), pending))
        if len(inflight) >= depth:
            finish()
    while inflight:
        finish()
    end = clock()
    return Window(done, end - start, bsz * len(done), attempted, failed)


def cell_of(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")


def metric_names(bench: dict, cell: dict, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: an entry with ``workloads`` names its cells; a per-layer entry
    without it goes with every cell that reports the metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell["name"] in m.get("workloads", [cell["name"]])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]


def reader_of(metric: dict) -> str:
    """The module of ``portbench/metrics`` that reads a metric: its name
    before the first dot (``qps.ivf`` is ``qps`` in the cells that report
    it under a bound of their own)."""
    return metric["name"].split(".")[0]


def card_facts(torch) -> dict:
    """The card's name and power limit for standard error."""
    facts = {"kind": torch.cuda.get_device_name(0)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        facts["nvidia_smi"] = out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError) as e:
        facts["nvidia_smi"] = f"unavailable: {e}"
    return facts


class Session:
    """A cell's world and program, built once: the set-up of a run (the
    readings of ``portbench.calibrate`` reuse it over many seeds)."""

    def __init__(self, bench: dict, workload: str, device: str, *,
                 cfg: Optional[dict] = None, traffic: Optional[dict] = None,
                 wrap: Optional[Callable] = None, cache: str = CACHE):
        import torch

        from portbench import program as program_mod
        from portbench.world import World

        self.program = wrap(program_mod) if wrap is not None else program_mod
        self.cell = cell_of(bench, workload)
        self.cfg = cfg or load_json(os.path.join(ROOT, next(
            c["file"] for c in bench["configs"]
            if c["name"] == self.cell["config"])))
        self.traffic = traffic or load_json(os.path.join(
            HERE, "traffic", f"{self.cell['traffic']}.json"))
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.phases: Dict[str, float] = {}
        clock = time.perf_counter
        t = clock()
        if self.cuda:
            torch.cuda.init()
        self.world = World(self.cfg, self.dev)
        rows, cents = self.world.host_corpus()
        self.router_state = self.world.router_state(cents)
        centroids = {s["name"]: cents[i, :rows[s["name"]].shape[1]].cpu().numpy()
                     for i, s in enumerate(self.cfg["world"]["sources"])}
        self.phases["world_s"], t = clock() - t, clock()
        self.engine, self.shapes = self.program.build(
            self.cfg, rows, centroids, self.router_state, self.dev, cache)
        del rows
        self.phases["build_s"] = clock() - t
        # the peak is the serving state's: the world's rows made on the
        # card and the build's transients are set-up, not what the
        # deployment holds while it serves
        gc.collect()
        if self.cuda:
            torch.cuda.synchronize(self.dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)
        self.names = self.program.source_names(self.engine)
        cfg_names = [s["name"] for s in self.cfg["world"]["sources"]]
        self.order = [cfg_names.index(n) for n in self.names]
        self.bsz = self.traffic["batch"]
        self.pool_n = self.traffic["pool_batches"] * self.bsz
        self.strategy = self.traffic["routing"]

    def pool(self, seed: int):
        """The run's query pool as host batches, and the checked rows."""
        from portbench.world import sample_rows

        qs = {e: q.cpu().numpy()
              for e, q in self.world.queries(seed, self.pool_n,
                                                self.bsz).items()}
        b = self.bsz
        batches = [{e: q[i * b:(i + 1) * b] for e, q in qs.items()}
                   for i in range(self.traffic["pool_batches"])]
        return batches, sample_rows(seed, self.pool_n,
                                    self.traffic["check_queries"])

    def loop(self, batches, **kw) -> Window:
        return closed_loop(self.engine, self.program, batches, self.strategy,
                           self.traffic["in_flight"], names=self.names, **kw)

    def warm(self, batches) -> None:
        """Every pool batch once, through the window's own loop."""
        self.loop(batches, count=len(batches) + self.traffic["in_flight"])
        self.sync()

    def sync(self) -> None:
        if self.cuda:
            import torch

            torch.cuda.synchronize(self.dev)

    def measure(self, batches, checked, seconds: float, **kw):
        """A window of ``seconds``; each checked row's answer as the window
        last served it (none for a row whose answer never came)."""
        by_batch = collections.defaultdict(list)
        for j, r in enumerate(checked):
            by_batch[int(r) // self.bsz].append((j, int(r) % self.bsz))
        served: Dict[int, dict] = {}

        def keep(b, out):
            for j, r in by_batch.get(b, ()):
                served[j] = {key: val[r] for key, val in out.items()}

        window = self.loop(batches, seconds=seconds, keep=keep, **kw)
        self.sync()
        return window, served

    def answers(self, served: Dict[int, dict], n: int):
        """The served answers as tensors on the device, sources in the
        configuration's order; ``None`` if any is missing."""
        import numpy as np
        import torch

        if len(served) < n:
            return None
        got = {key: np.stack([served[j][key] for j in range(n)])
               for key in ("mask", "score", "shard", "local", "count")}
        order = np.asarray(self.order)
        got["mask"] = got["mask"][:, np.argsort(order)]
        got["shard"] = np.where(got["shard"] >= 0,
                                order[got["shard"].clip(0)], -1)
        return {key: torch.as_tensor(val).to(self.dev)
                for key, val in got.items()}

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.engine = None
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()


def checked_queries(session: Session, seed: int, checked):
    """The checked queries made again from the seed, on the device."""
    import torch

    idx = torch.as_tensor(checked, device=session.dev)
    return {e: q[idx] for e, q in
            session.world.queries(seed, session.pool_n,
                                  session.bsz).items()}


def judge(session: Session, ref, qs, got):
    """Every compared number of served answers ``got`` (``None``: some
    never came) against the reference ``ref``, and the verdict."""
    from portbench import compare

    if got is None:
        values = {"missing": 1.0}
        return values, False, {"missing": {"value": 1.0, "limit": 0.0}}
    ref_mask = ref.route(qs, session.strategy)
    values = compare.numbers(got, ref_mask, ref.answer(qs, ref_mask), ref,
                             qs)
    ok, checks = compare.verdict(values, session.cfg["limits"])
    return values, ok, checks


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str, *, cfg: Optional[dict] = None,
             traffic: Optional[dict] = None, wrap: Optional[Callable] = None,
             trace_seconds: float = TRACE_SECONDS, cache: str = CACHE) -> dict:
    """One run of a cell on ``device``; the result's dict. ``cfg`` and
    ``traffic`` replace the cell's files (the harness's tests run a small
    world); ``wrap`` wraps the program module (the tests plant faults);
    ``cache`` holds the layouts the program caches."""
    import torch

    from portbench.reference import Reference

    s = Session(bench, workload, device, cfg=cfg, traffic=traffic, wrap=wrap,
                cache=cache)
    t = time.perf_counter()
    batches, checked = s.pool(seed)
    s.warm(batches)
    setup_s = time.perf_counter() - T_START
    s.phases["warm_s"] = time.perf_counter() - t
    window, served = s.measure(batches, checked, seconds)
    traced = reduced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import trace as trace_mod

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if s.cuda else [])
        with profile(activities=acts) as prof:
            traced = s.loop(batches, seconds=trace_seconds,
                            span=record_function)
            s.sync()
        reduced = trace_mod.reduce(prof.events())
        del prof
    peak = torch.cuda.max_memory_allocated(s.dev) if s.cuda else 0
    got = s.answers(served, len(checked))
    s.free()

    ref = Reference(s.cfg, s.world, s.cfg["reference"]["rows"],
                    s.router_state)
    values, ok, checks = judge(s, ref, checked_queries(s, seed, checked), got)
    del ref

    ctx = Context(s.cfg, s.traffic, s.shapes, window, traced, reduced,
                  setup_s, values)
    metrics = {}
    for m in metric_names(bench, s.cell, trace):
        mod = importlib.import_module(f"portbench.metrics.{reader_of(m)}")
        v = mod.read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_facts = {"platform": "gpu" if s.cuda else s.dev.type,
                 "kind": (torch.cuda.get_device_name(s.dev) if s.cuda
                          else "cpu"),
                 "count": s.cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok), "attempted": window.attempted,
              "failed": window.failed, "metrics": metrics,
              "device": dev_facts}
    if reduced is not None:
        dev_facts["busy_s"] = reduced.busy_s
        dev_facts["window_s"] = reduced.window_s
        result["breakdown"] = {
            "device_ops": [list(x) for x in reduced.device_ops],
            "idle_gaps": [list(x) for x in reduced.idle_gaps]}
    result["checks"] = checks
    result["_values"] = values
    result["_window"] = window_facts(window, s.bsz)
    result["_window"]["setup_phases"] = s.phases
    return result


def window_facts(window: Window, bsz: int) -> dict:
    """The measured window's batch count, seconds and each source's share
    of the queries routed to it (standard error only)."""
    routed = collections.Counter()
    for b in window.batches:
        routed.update(b.routed)
    n = max(1, bsz * len(window.batches))
    return {"batches": len(window.batches), "seconds": window.seconds,
            "routed_share": {k: v / n for k, v in routed.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    print(f"portbench: {json.dumps(card_facts(torch))}", file=sys.stderr)
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0")
    values = result.pop("_values")
    found = forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: "
              f"{found}", file=sys.stderr)
        return 4
    print(f"portbench: all compared numbers: {json.dumps(values)}",
          file=sys.stderr)
    print(f"portbench: window {json.dumps(result.pop('_window'))}",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
