"""The readings a cell's limits are set from, in one process.

    python -m portbench.calibrate --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] --control-seeds <n> [<n> ...] \
        [--fault-seeds <n> [<n> ...]]

The world and the program are built once (the set-up of a run), then for
each of ``--seeds`` a run's traffic: the pool from the seed, its warm-up, a
window of ``--seconds`` and the check of the window's answers, as
``portbench.run`` makes them. For each of ``--control-seeds`` the control
takes the program's place: the plain reference itself, its rows in the
stored form one step below the configuration's (``reference.control_rows``:
int8 under bf16, int4 under int8), answers the same checked queries and is
judged by the same comparison. For each of ``--fault-seeds`` the program
runs as for ``--seeds`` with the configuration's planted fault
(``reference.fault``, a name in :mod:`portbench.faults`). One JSON line a
seed, then a summary: each number's lower reading (the largest over the
program's seeds), upper reading (the smallest over the control's) and fault
reading (the smallest over the fault's).
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    run._environment()
    bench = run.load_json(f"{run.ROOT}/BENCHMARK.json")
    readings = calibrate(bench, args.workload, args.seeds,
                         args.control_seeds, args.seconds, args.device,
                         fault_seeds=args.fault_seeds)
    print(json.dumps(readings["summary"]), flush=True)
    return 0


def calibrate(bench, workload, seeds, control_seeds, seconds, device, *,
              fault_seeds=(), cfg=None, traffic=None, cache=run.CACHE):
    from portbench.faults import FAULTS
    from portbench.reference import Reference

    s = run.Session(bench, workload, device, cfg=cfg, traffic=traffic,
                    cache=cache)
    ref = Reference(s.cfg, s.world, s.cfg["reference"]["rows"],
                    s.router_state)
    out = {"program": [], "control": [], "fault": []}

    def program_run(seed, side):
        batches, checked = s.pool(seed)
        s.warm(batches)
        window, served = s.measure(batches, checked, seconds)
        values, ok, _ = run.judge(s, ref, run.checked_queries(
            s, seed, checked), s.answers(served, len(checked)))
        line = {"side": side, "seed": seed, "correct": ok,
                "qps": window.queries / window.seconds, "values": values}
        print(json.dumps(line), flush=True)
        out[side].append(line)

    for seed in seeds:
        program_run(seed, "program")
    if fault_seeds:
        with FAULTS[s.cfg["reference"]["fault"]]():
            for seed in fault_seeds:
                program_run(seed, "fault")
    s.free()
    control = Reference(s.cfg, s.world, s.cfg["reference"]["control_rows"],
                        s.router_state)
    for seed in control_seeds:
        _, checked = s.pool(seed)
        qs = run.checked_queries(s, seed, checked)
        mask = control.route(qs, s.strategy)
        score, shard, local, count = control.answer(qs, mask)
        got = {"mask": mask, "score": score, "shard": shard, "local": local,
               "count": count}
        values, ok, _ = run.judge(s, ref, qs, got)
        line = {"side": "control", "seed": seed, "correct": ok,
                "values": values}
        print(json.dumps(line), flush=True)
        out["control"].append(line)
    names = sorted({n for side in out.values() for x in side
                    for n in x["values"]})
    out["summary"] = {
        "workload": workload, "limits": s.cfg["limits"],
        "lower": {n: max((x["values"].get(n, float("nan"))
                          for x in out["program"]), default=None)
                  for n in names},
        "upper": {n: min((x["values"].get(n, float("nan"))
                          for x in out["control"]), default=None)
                  for n in names},
        "fault": {n: min((x["values"].get(n, float("nan"))
                          for x in out["fault"]), default=None)
                  for n in names},
        "program_correct": sum(x["correct"] for x in out["program"]),
        "control_correct": sum(x["correct"] for x in out["control"]),
        "fault_correct": sum(x["correct"] for x in out["fault"])}
    return out


if __name__ == "__main__":
    sys.exit(main())
