"""Serving metrics: per-stage latency aggregates.

The reference's observability is per-query wall-clock timers propagated
in-band to CSVs (SURVEY §5.1). Those remain (response metadata); this adds
cheap server-side aggregates — count / mean / p50 / p95 / max per stage,
batch-size distribution — exposed on ``GET /stats`` for live monitoring.
"""

from __future__ import annotations

import collections
import threading
from typing import Deque, Dict

_RESERVOIR = 1024


class StageStat:
    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = 0.0
        self._recent: Deque[float] = collections.deque(maxlen=_RESERVOIR)

    def observe(self, v: float) -> None:
        self.count += 1
        self.total += v
        self.max = max(self.max, v)
        self._recent.append(v)

    def snapshot(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0}
        recent = sorted(self._recent)
        n = len(recent)
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "p50": recent[n // 2],
            "p95": recent[min(n - 1, int(n * 0.95))],
            "max": self.max,
        }


class ServerMetrics:
    # embedding/selection/doc_select/generate/e2e mirror the reference's
    # in-band timers (SURVEY §5.1); batch_wait (submit->result time minus
    # the device step, i.e. queueing + batching overhead) and assemble
    # (post-result response construction: per-source stats, doc
    # resolution, metadata build) are the host-side profile beside the
    # device step.
    STAGES = ("embedding", "selection", "doc_select", "generate", "e2e",
              "batch_wait", "assemble")

    def __init__(self):
        self._lock = threading.Lock()
        self.stages: Dict[str, StageStat] = {s: StageStat()
                                             for s in self.STAGES}
        self.batch_sizes = StageStat()
        self.queries = 0
        self.errors = 0
        # warmup-measured steady-state device step time per batch bucket
        # (live stage timings include host+dispatch; this is the honest
        # device-side number — see FederationServer._warmup)
        self.device_step_ms: Dict[int, float] = {}

    def set_device_step_ms(self, per_bucket: Dict[int, float]) -> None:
        with self._lock:
            self.device_step_ms = dict(per_bucket)

    def observe_query(self, *, embedding: float, selection: float,
                      doc_select: float, generate: float, e2e: float,
                      batch_size: int, batch_wait: float = 0.0,
                      assemble: float = 0.0) -> None:
        with self._lock:
            self.queries += 1
            self.stages["embedding"].observe(embedding)
            self.stages["selection"].observe(selection)
            self.stages["doc_select"].observe(doc_select)
            if generate >= 0:
                self.stages["generate"].observe(generate)
            self.stages["e2e"].observe(e2e)
            self.stages["batch_wait"].observe(batch_wait)
            self.stages["assemble"].observe(assemble)
            self.batch_sizes.observe(float(batch_size))

    def observe_error(self) -> None:
        with self._lock:
            self.errors += 1

    def snapshot(self) -> Dict:
        with self._lock:
            return {
                "num_queries": self.queries,
                "num_errors": self.errors,
                "stages_s": {s: st.snapshot()
                             for s, st in self.stages.items()},
                "batch_size": self.batch_sizes.snapshot(),
                "device_step_ms": dict(self.device_step_ms),
            }
