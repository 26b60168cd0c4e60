"""Native (C++) HTTP front end: ctypes bindings and the serving loop.

Port of :mod:`ragroute_tpu.engine.native_frontend`. ``--frontend native``
replaces aiohttp's Python IO plane with ``native/frontend.cpp``: an epoll
event loop owns the sockets, parses HTTP/1.1 (keep-alive, pipeline order)
and writes responses; this module pulls parsed requests in batches and
pushes whole response bodies. The batch pull is also the micro-batcher:
requests that arrive while Python runs an engine step wait in C++ and come
over as one batch.

It serves the whole surface: ``GET/POST /query`` (``stream=1`` as SSE; with
generation on, the deltas go out as chunked ``fe_stream_chunk`` frames as
they decode), ``POST /query/batch``, ``/docs/add``, ``/docs/delete``,
``/admin/snapshot``, ``/admin/profile``, ``/healthz``, ``/stats`` and
``--simulate``. Generation and simulate's LLM delay run on a finisher
asyncio loop in a side thread, so the serving loop never waits on the LLM;
finished responses enter C++ through the thread-safe ``fe_respond`` /
``fe_begin_stream`` / ``fe_stream_*`` calls.

Response assembly is the aiohttp server's (its sync ``_assemble_pre`` /
``_finalize`` and the raw doc splice), so both front ends return the same
bytes.

The library is built from ``native/frontend.cpp`` with ``g++`` at first use
into ``ragroute_tpu_torch/csrc/build/`` under a name that carries a hash of
the source and the flags, through a per-process temporary file and a
rename, so concurrent processes never load a half-written library. A
failed build raises: there is no fall-back to aiohttp.
"""

from __future__ import annotations

import asyncio
import ctypes
import functools
import hashlib
import json
import logging
import os
import subprocess
import threading
import time
import uuid
from typing import Dict, List, Optional
from urllib.parse import unquote_plus

from ragroute_tpu_torch.config import (BATCH_WINDOW_MS, LLM_DELAY,
                                       QUERY_TIMEOUT_S)
from ragroute_tpu_torch.engine import prompts as _prompts
from ragroute_tpu_torch.engine.batcher import (QueryResult,
                                               fetch_candidates_policy,
                                               pack_query_embs)
from ragroute_tpu_torch.engine.server import (FederationServer,
                                              ProfileCapture, _dumps,
                                              profile_body)
from ragroute_tpu_torch.ops._build import BUILD_DIR

logger = logging.getLogger("native_frontend")

TEXT = b"text/plain; charset=utf-8"

# decoded values are cached only up to this length: bodies reach the front
# end's 64 MB cap, and short values (qids, choices JSON) are what repeats
_UNQUOTE_CACHE_MAX_LEN = 2048


@functools.lru_cache(maxsize=8192)
def _unquote_cached_small(val: str) -> str:
    return unquote_plus(val, errors="replace")


def _unquote_cached(val: str) -> str:
    if len(val) <= _UNQUOTE_CACHE_MAX_LEN:
        return _unquote_cached_small(val)
    return unquote_plus(val, errors="replace")


def _parse_qs_first(qs: str, out: Dict[str, str]) -> Dict[str, str]:
    """First-value query-string parse into ``out`` (later duplicates and
    keys already in ``out`` are ignored); values are decoded only when
    they carry ``%xx`` or ``+`` escapes."""
    for part in qs.split("&"):
        if not part:
            continue
        key, _, val = part.partition("=")
        if "%" in key or "+" in key:
            key = _unquote_cached(key)
        if key in out:
            continue
        if "%" in val:
            val = _unquote_cached(val)
        elif "+" in val:
            val = val.replace("+", " ")
        out[key] = val
    return out


_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_REPO_ROOT, "native", "frontend.cpp")
_CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class _FeReq(ctypes.Structure):
    # must match FeReq in native/frontend.cpp
    _fields_ = [
        ("id", ctypes.c_uint64),
        ("method", ctypes.c_int32),
        ("path_len", ctypes.c_int32),
        ("qs_len", ctypes.c_int32),
        ("body_len", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
        ("path", ctypes.c_void_p),
        ("qs", ctypes.c_void_p),
        ("body", ctypes.c_void_p),
    ]


def library_path(src: str) -> str:
    """Where the build of ``src`` with this module's flags lives."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfrontend-{h.hexdigest()[:16]}.so")


def _build(src: str) -> str:
    """Compile ``src`` unless this exact build exists; return its path."""
    out = library_path(src)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = ["g++", *_CXX_FLAGS, "-o", tmp, src]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"native front end build failed: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"native front end build failed "
                           f"({proc.returncode}) for {src}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    """The loaded front-end library (built on first call); raises
    ``RuntimeError`` when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_build(_SRC))
        vp, ci, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
        lib.fe_start.argtypes = [ctypes.c_char_p, ci, ci]
        lib.fe_start.restype = vp
        lib.fe_port.argtypes = [vp]
        lib.fe_port.restype = ci
        lib.fe_next.argtypes = [vp, ctypes.POINTER(_FeReq), ci, ci, ci, ci,
                                ci]
        lib.fe_next.restype = ci
        lib.fe_respond.argtypes = [vp, u64, ci, ctypes.c_char_p,
                                   ctypes.c_char_p, ctypes.c_longlong]
        lib.fe_respond.restype = ci
        lib.fe_respond_many.argtypes = [
            vp, ci, ctypes.POINTER(u64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_longlong)]
        lib.fe_respond_many.restype = ci
        lib.fe_begin_stream.argtypes = [vp, u64, ci, ctypes.c_char_p]
        lib.fe_begin_stream.restype = ci
        lib.fe_stream_chunk.argtypes = [vp, u64, ctypes.c_char_p,
                                        ctypes.c_longlong]
        lib.fe_stream_chunk.restype = ci
        lib.fe_stream_end.argtypes = [vp, u64]
        lib.fe_stream_end.restype = ci
        lib.fe_stat.argtypes = [vp, ci]
        lib.fe_stat.restype = ctypes.c_longlong
        lib.fe_shutdown.argtypes = [vp]
        lib.fe_shutdown.restype = None
        lib.fe_stop.argtypes = [vp]
        lib.fe_stop.restype = None
        _lib = lib
        return lib


class NativeFrontend:
    """Thin wrapper over the C front-end handle."""

    MAX_POP = 512  # requests a fe_next call by default; the serving loop
    # sizes it to its largest batch bucket (a smaller pop padded up to the
    # bucket wastes device work)

    def __init__(self, host: str, port: int, reuse_port: bool = False,
                 max_pop: int = 0):
        lib = _load()
        self._lib = lib
        self._h = lib.fe_start(host.encode(), port, int(reuse_port))
        if not self._h:
            raise OSError(f"fe_start failed to bind {host}:{port}")
        self.max_pop = int(max_pop) or self.MAX_POP
        self._buf = (_FeReq * self.max_pop)()

    @property
    def port(self) -> int:
        return int(self._lib.fe_port(self._h))

    def next(self, max_n: int, first_timeout_ms: int = 200,
             window_ms: int = 0, fill_n: int = 0, fill_ms: int = 0):
        """Pop up to ``max_n`` parsed requests as ``(id, method, path, qs,
        body)`` tuples (bytes); ``None`` once shut down, ``[]`` on timeout.
        ``fill_n`` / ``fill_ms``: once one request is in hand, wait up to
        ``fill_ms`` for ``fill_n`` to queue (fuller device batches)."""
        max_n = min(max_n, self.max_pop)
        n = self._lib.fe_next(self._h, self._buf, max_n, first_timeout_ms,
                              window_ms, fill_n, fill_ms)
        if n < 0:
            return None
        out = []
        for i in range(n):
            r = self._buf[i]
            out.append((
                r.id, r.method,
                ctypes.string_at(r.path, r.path_len) if r.path_len else b"",
                ctypes.string_at(r.qs, r.qs_len) if r.qs_len else b"",
                ctypes.string_at(r.body, r.body_len) if r.body_len else b"",
            ))
        return out

    def respond(self, rid: int, status: int, body,
                ctype: bytes = b"application/json") -> None:
        if isinstance(body, str):
            body = body.encode()
        self._lib.fe_respond(self._h, rid, status, ctype, body, len(body))

    def respond_many(self, items) -> int:
        """Deliver ``[(rid, status, ctype, body), ...]`` in one native call
        (one queue push, one wake-up of the IO thread); returns how many
        ids were in flight."""
        n = len(items)
        if n == 0:
            return 0
        if n == 1:
            rid, status, ctype, body = items[0]
            self.respond(rid, status, body, ctype)
            return 1
        ids = (ctypes.c_uint64 * n)()
        sts = (ctypes.c_int32 * n)()
        cts = (ctypes.c_char_p * n)()
        bds = (ctypes.c_char_p * n)()
        lns = (ctypes.c_longlong * n)()
        bodies = []  # the encoded bytes stay alive through the call
        for i, (rid, status, ctype, body) in enumerate(items):
            if isinstance(body, str):
                body = body.encode()
            bodies.append(body)
            ids[i], sts[i], cts[i], bds[i], lns[i] = (rid, status, ctype,
                                                      body, len(body))
        return int(self._lib.fe_respond_many(self._h, n, ids, sts, cts, bds,
                                             lns))

    def begin_stream(self, rid: int, status: int = 200,
                     ctype: bytes = b"text/event-stream") -> bool:
        """Open a chunked streaming response (from any thread)."""
        return self._lib.fe_begin_stream(self._h, rid, status, ctype) == 0

    def stream_chunk(self, rid: int, data) -> bool:
        if isinstance(data, str):
            data = data.encode()
        return self._lib.fe_stream_chunk(self._h, rid, data, len(data)) == 0

    def stream_end(self, rid: int) -> bool:
        return self._lib.fe_stream_end(self._h, rid) == 0

    def stats(self) -> dict:
        names = ("accepted", "requests", "bad_requests", "responses",
                 "dropped_responses")
        return {n: int(self._lib.fe_stat(self._h, i))
                for i, n in enumerate(names)}

    def shutdown(self) -> None:
        """Wake any blocked fe_next; the loop thread then closes."""
        self._lib.fe_shutdown(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.fe_stop(self._h)
            self._h = None


class _Work:
    __slots__ = ("rid", "query", "choices", "qid", "stream", "group",
                 "gidx", "start", "embs", "row", "embed_time", "t_submit")

    def __init__(self, rid, query, choices, qid, stream=False, group=None,
                 gidx=0):
        self.rid = rid
        self.query = query
        self.choices = choices
        self.qid = qid
        self.stream = stream
        self.group = group    # _Group of a /query/batch member
        self.gidx = gidx
        self.start = time.time()
        self.embs = None
        self.row = None       # device query-table row
        self.embed_time = 0.0
        self.t_submit = 0.0


class _Group:
    """One ``POST /query/batch`` awaiting its members, which may finish on
    the serving thread and on the finisher thread (hence the lock)."""

    __slots__ = ("rid", "results", "remaining", "lock")

    def __init__(self, rid, n):
        self.rid = rid
        self.results: List = [None] * n
        self.remaining = n
        self.lock = threading.Lock()


class NativeFederationServer:
    """Serve a :class:`FederationServer`'s engine through the C++ front end.

    The FederationServer is the assembly library here; its aiohttp app and
    batcher never start. One Python thread runs the loop: pop a batch of
    requests, run one engine step a bucket-sized chunk, assemble with the
    shared sync helpers, push the bodies back to C++.
    """

    def __init__(self, server: FederationServer, *,
                 window_ms: float = BATCH_WINDOW_MS):
        if server.embed_batcher is not None:
            # zoo providers still work: embed_many() is called synchronously
            # per pop batch, which batches the encoder forward the same way
            server.embed_batcher = None
        self.server = server
        self.engine = server.engine
        self.world = server.world
        self.strategy = server.strategy
        self.provider = server.provider
        self.window_ms = int(window_ms)
        # after a pop of 32 or more, wait up to this many ms for the pop to
        # reach the largest bucket (a padded step costs as much as a full
        # one); 0 turns it off
        self.fill_ms = int(os.environ.get("RAGROUTE_NATIVE_FILL_MS", "15"))
        self.buckets = tuple(sorted(server.batcher.buckets))
        self._fetch = fetch_candidates_policy(self.world)
        self.fe: Optional[NativeFrontend] = None
        self._thread: Optional[threading.Thread] = None
        self._running = False
        # responses of one _handle pass, delivered in one fe_respond_many
        self._out: List = []
        # double buffering: one submitted step in flight while the host
        # assembles the previous one. On by default for engines with a
        # dispatch/complete split (hostrefine's host rescore overlaps the
        # next device scan), as in the JAX package;
        # RAGROUTE_NATIVE_PIPELINE=0/1 forces either way
        env = os.environ.get("RAGROUTE_NATIVE_PIPELINE")
        if env is not None:
            self.pipeline = env == "1"
        else:
            self.pipeline = getattr(server.engine,
                                    "supports_pipelined_dispatch", False)
        self._pending = None  # (chunk, PendingSearch)
        self._fin_loop: Optional[asyncio.AbstractEventLoop] = None
        self._fin_thread: Optional[threading.Thread] = None
        self._needs_finisher = (not server.disable_llm) or server.simulate

    # -- lifecycle ---------------------------------------------------------

    def start(self, *, thread: bool = False) -> None:
        if self.server.warmup:
            self.server._warmup()
        if self._needs_finisher:
            self._fin_loop = asyncio.new_event_loop()
            self._fin_thread = threading.Thread(
                target=self._fin_loop.run_forever,
                name="native-llm-finisher", daemon=True)
            self._fin_thread.start()
        self.fe = NativeFrontend(self.server.host, self.server.port,
                                 reuse_port=self.server.reuse_port,
                                 max_pop=max(NativeFrontend.MAX_POP,
                                             self.buckets[-1]))
        self._running = True
        logger.info("native HTTP front end on http://%s:%s",
                    self.server.host, self.fe.port)
        if thread:
            self._thread = threading.Thread(
                target=self.serve_forever, name="native-frontend-loop",
                daemon=True)
            self._thread.start()

    @property
    def bound_port(self) -> int:
        return self.fe.port if self.fe else self.server.port

    def stop(self) -> None:
        self._running = False
        if self.fe is not None:
            self.fe.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None
        elif self.fe is not None:
            self.fe.close()
            self.fe = None
        if self._fin_loop is not None:
            self._fin_loop.call_soon_threadsafe(self._fin_loop.stop)
            if self._fin_thread is not None:
                self._fin_thread.join(timeout=10)
                self._fin_thread = None
            self._fin_loop.close()
            self._fin_loop = None

    # -- loop --------------------------------------------------------------

    def serve_forever(self) -> None:
        last_n = 0
        try:
            while self._running:
                # the fill wait only under load: a lone request must not
                # wait for company
                fill = self.fill_ms if last_n >= 32 else 0
                # with a step in flight, poll: no new work means go drain
                # the pending step
                pending = self._pending is not None
                reqs = self.fe.next(self.fe.max_pop,
                                    first_timeout_ms=0 if pending else 200,
                                    window_ms=self.window_ms,
                                    fill_n=self.buckets[-1] if fill else 0,
                                    fill_ms=fill)
                if reqs is None:
                    # shutdown: answer the step in flight before the IO
                    # plane closes
                    self._drain_pending()
                    self._flush()
                    break
                if not reqs:
                    if pending:
                        self._drain_pending()
                        self._flush()
                    else:
                        last_n = 0
                    continue
                last_n = len(reqs)
                self._handle(reqs)
        finally:
            if self.fe is not None:
                self.fe.close()
                self.fe = None

    # -- request routing -----------------------------------------------------

    def _respond(self, rid: int, status: int, body,
                 ctype: bytes = b"application/json") -> None:
        self._out.append((rid, status, ctype, body))

    def _handle(self, reqs) -> None:
        work: List[_Work] = []
        try:
            for rid, method, path, qs, body in reqs:
                try:
                    self._route(rid, method, path, qs, body, work)
                except Exception as e:  # one request never kills the loop
                    logger.exception("request handling failed")
                    self._respond(rid, 500, f"Internal error: {e}",
                                  ctype=TEXT)
            if work:
                self._run_queries(work)
            elif self._pending is not None:
                # a pop of other traffic must not strand the step in flight
                self._drain_pending()
        finally:
            self._flush()

    def _flush(self) -> None:
        out, self._out = self._out, []
        if out:
            self.fe.respond_many(out)

    def _route(self, rid, method, path, qs, body, work: List[_Work]) -> None:
        if path == b"/query":
            params: Dict[str, str] = {}
            if method == 1 and body:
                # POST /query: the form body's fields win over the query
                # string's, as in the reference
                _parse_qs_first(body.decode("utf-8", "replace"), params)
            _parse_qs_first(qs.decode("utf-8", "replace"), params)
            query = params.get("q", "")
            choices = params.get("choices", "")
            question_id = params.get("qid", "")
            if not query:
                return self._respond(rid, 400, "Please provide a query",
                                     ctype=TEXT)
            if not choices:
                return self._respond(rid, 400, "Please provide choices",
                                     ctype=TEXT)
            if self.world.name == "feb4rag" and not question_id:
                return self._respond(
                    rid, 400,
                    "For FeB4RAG, please provide a question ID (qid)",
                    ctype=TEXT)
            try:
                choices = json.loads(choices)
            except json.JSONDecodeError:
                return self._respond(rid, 400, "Invalid choices format",
                                     ctype=TEXT)
            stream = params.get("stream") in ("1", "true")
            work.append(_Work(rid, query, choices, question_id,
                              stream=stream))
            return None

        if path == b"/query/batch" and method == 1:
            try:
                data = json.loads(body)
            except (json.JSONDecodeError, UnicodeDecodeError):
                return self._respond(rid, 400, "Invalid JSON body",
                                     ctype=TEXT)
            queries = data.get("queries") if isinstance(data, dict) else data
            if not isinstance(queries, list) or not queries:
                return self._respond(
                    rid, 400, "Provide a non-empty 'queries' list",
                    ctype=TEXT)
            group = _Group(rid, len(queries))
            for j, item in enumerate(queries):
                err = None
                if not isinstance(item, dict):
                    err = "Each query must be an object"
                else:
                    query = item.get("q", "")
                    choices = item.get("choices", "")
                    question_id = str(item.get("qid", "") or "")
                    if not query:
                        err = "Please provide a query"
                    elif not choices:
                        err = "Please provide choices"
                    elif self.world.name == "feb4rag" and not question_id:
                        err = ("For FeB4RAG, please provide a question ID "
                               "(qid)")
                    elif isinstance(choices, str):
                        try:
                            choices = json.loads(choices)
                        except json.JSONDecodeError:
                            err = "Invalid choices format"
                if err is not None:
                    self._group_done(group, j, {"error": err})
                else:
                    work.append(_Work(rid, query, choices, question_id,
                                      group=group, gidx=j))
            return None

        if path == b"/healthz":
            return self._respond(rid, 200, _dumps({
                "status": "ok",
                "world": self.world.name,
                "strategy": self.strategy,
                "total_docs": self.engine.shard_set.total_docs,
                "index_bytes": self.engine.shard_set.index_bytes,
            }))

        if path == b"/stats":
            snap = self.server.metrics.snapshot()
            snap["frontend"] = {"kind": "native", **self.fe.stats()}
            if self.server.reuse_port:
                snap["worker_pid"] = os.getpid()
            return self._respond(rid, 200, _dumps(snap))

        if path in (b"/docs/add", b"/docs/delete") and method == 1:
            # the aiohttp handlers' sync cores; the engine's update lock
            # orders them against the steps
            try:
                data = json.loads(body) if body else {}
            except (json.JSONDecodeError, UnicodeDecodeError):
                return self._respond(rid, 400, "Invalid JSON body",
                                     ctype=TEXT)
            fn = (self.server.docs_add_sync if path == b"/docs/add"
                  else self.server.docs_delete_sync)
            return self._sync_result(rid, *fn(data))

        if path == b"/admin/snapshot" and method == 1:
            return self._sync_result(rid, *self.server.snapshot_sync())

        if path == b"/admin/profile" and method == 1:
            return self._profile(rid, body)

        self._respond(rid, 501,
                      f"{path.decode('utf-8', 'replace')} is not implemented",
                      ctype=TEXT)

    def _sync_result(self, rid: int, status: int, res) -> None:
        if status != 200:
            return self._respond(rid, status, res, ctype=TEXT)
        return self._respond(rid, 200, _dumps(res))

    def _profile(self, rid: int, body: bytes) -> None:
        """``POST /admin/profile``: the capture window runs on a helper
        thread (the loop keeps serving meanwhile) that answers through the
        thread-safe ``fe_respond``."""
        try:
            data = json.loads(body) if body else {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            return self._respond(rid, 400, "Invalid JSON body", ctype=TEXT)
        seconds, logdir, err = profile_body(data)
        if err is not None:
            return self._respond(rid, 400, err, ctype=TEXT)
        if self.server._profiling:
            return self._respond(rid, 409,
                                 "A profile capture is already running",
                                 ctype=TEXT)
        self.server._profiling = True
        fe = self.fe

        def capture():
            try:
                cap = ProfileCapture(self.engine.device, logdir)
                cap.start()
                try:
                    time.sleep(seconds)
                finally:
                    cap.stop()
                cap.export()
            except (RuntimeError, OSError) as e:
                fe.respond(rid, 500, f"Profiler failed: {e}", ctype=TEXT)
                return
            finally:
                self.server._profiling = False
            fe.respond(rid, 200, _dumps({"trace_dir": logdir,
                                         "seconds": seconds}))

        threading.Thread(target=capture, name="native-profile",
                         daemon=True).start()

    # -- query execution -----------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _embed(self, items: List[_Work]) -> List[_Work]:
        """Fill ``w.embs`` (or ``w.row``) of each item; a failed item is
        answered and dropped. A blocking provider with ``embed_many``
        shares one batched forward."""
        texts = []
        for w in items:
            # wikipedia encodes query + choices (reference http_server.py)
            if self.world.name == "wikipedia":
                texts.append("\n".join([w.query, " | ".join(w.choices)]))
            else:
                texts.append(w.query)
        ok: List[_Work] = []
        if (getattr(self.provider, "blocking", False)
                and hasattr(self.provider, "embed_many") and len(items) > 1):
            t0 = time.time()
            try:
                many = self.provider.embed_many(texts, [w.qid for w in items])
            except Exception as e:
                for w in items:
                    self._fail(w, e)
                return []
            dt = (time.time() - t0) / max(len(items), 1)
            for w, e in zip(items, many):
                w.embs, w.embed_time = e, dt
                ok.append(w)
            return ok
        rows_wired = self.server._rows_wired
        for w, text in zip(items, texts):
            t0 = time.time()
            try:
                if rows_wired:
                    w.row = self.provider.row_of(w.qid)
                if w.row is None:
                    w.embs = self.provider.embed(text, w.qid)
            except Exception as e:
                self._fail(w, e)
                continue
            w.embed_time = time.time() - t0
            ok.append(w)
        return ok

    def _run_queries(self, work: List[_Work]) -> None:
        items = self._embed(work)
        max_b = self.buckets[-1]
        for i in range(0, len(items), max_b):
            chunk = items[i:i + max_b]
            if not self.pipeline:
                self._drain_pending()
            submitted = None
            try:
                submitted = self._submit_chunk(chunk)
            except Exception as e:
                logger.exception("engine submit failed")
                for w in chunk:
                    self._fail(w, e)
            if self.pipeline:
                # the previous step drains while the card runs this one
                self._drain_pending()
            self._pending = submitted
        if not self.pipeline:
            self._drain_pending()

    def _drain_pending(self) -> None:
        pc, self._pending = self._pending, None
        if pc is None:
            return
        chunk, pending = pc
        try:
            out = pending.wait()
        except Exception as e:
            logger.exception("engine step failed")
            for w in chunk:
                self._fail(w, e)
            return
        try:
            self._finish_chunk(chunk, out)
        except Exception as e:
            logger.exception("response assembly failed")
            for w in chunk:
                self._fail(w, e)

    def _submit_chunk(self, chunk: List[_Work]):
        embs = pack_query_embs(
            self.engine, [w.row for w in chunk], [w.embs for w in chunk],
            self._bucket(len(chunk)))
        for w in chunk:
            w.t_submit = time.time()
        return chunk, self.engine.search_submit(
            embs, strategy=self.strategy, fetch_candidates=self._fetch)

    def _finish_chunk(self, chunk: List[_Work], out) -> None:
        n = len(chunk)
        t_done = time.time()
        srv = self.server
        query_ids = [str(uuid.uuid4()) for _ in chunk]
        # one [n, N] message-size pass for the chunk (uuid4 strings share
        # one length; feb4rag sizes from its resolved docs instead)
        msg_sizes_all = None
        if out.msg_base is not None:
            msg_sizes_all = out.msg_base[:n] + len(query_ids[0])
        elif self.world.name != "feb4rag":
            msg_sizes_all = srv._estimate_message_sizes_chunk(
                out.shard_ids[:n], len(query_ids[0]))
        for i, w in enumerate(chunk):
            res = QueryResult(
                probs=out.probs[i], mask=out.mask[i],
                shard_scores=(None if out.shard_scores is None
                              else out.shard_scores[i]),
                shard_ids=(None if out.shard_ids is None
                           else out.shard_ids[i]),
                merged_score=out.merged_score[i],
                merged_shard=out.merged_shard[i],
                merged_local=out.merged_local[i],
                merged_valid=int(out.merged_valid[i]),
                selection_time=out.selection_time,
                doc_select_time=out.doc_select_time, batch_size=n)
            batch_wait = max(0.0, (t_done - w.t_submit)
                             - res.selection_time - res.doc_select_time)
            t_assemble = time.time()
            query_id = query_ids[i]
            try:
                selected, ds_stats, top_docs, raw_docs = srv._assemble_pre(
                    res, query_id, w.qid,
                    msg_sizes=(None if msg_sizes_all is None
                               else msg_sizes_all[i]))
            except Exception as e:
                logger.exception("assembly failed")
                self._fail(w, e)
                continue
            if self._fin_loop is not None:
                # generation / simulate: the async tail runs on the
                # finisher loop and answers through the thread-safe calls
                asyncio.run_coroutine_threadsafe(
                    self._finish_async(
                        w, res, query_id, selected, ds_stats, top_docs,
                        raw_docs, batch_wait, t_assemble),
                    self._fin_loop)
                continue
            try:
                result = srv._finalize(
                    {"query_id": query_id, "query": w.query, "answer": ""},
                    res, selected=selected, ds_stats=ds_stats,
                    top_docs=top_docs, raw_docs=raw_docs,
                    generate_time=0.0, docs_tokens=0, start=w.start,
                    embedding_time=w.embed_time, batch_wait=batch_wait,
                    t_assemble=t_assemble)
            except Exception as e:
                logger.exception("assembly failed")
                self._fail(w, e)
                continue
            self._deliver(w, result)

    async def _finish_async(self, w: _Work, res, query_id, selected,
                            ds_stats, top_docs, raw_docs, batch_wait,
                            t_assemble) -> None:
        """The post-retrieval tail on the finisher loop: the LLM stage
        (prompt, generation, SSE deltas through the C++ plane, the
        reference's timeout) or simulate's LLM delay, then finalize and
        answer; the second half of ``FederationServer._process``."""
        srv = self.server
        fe = self.fe  # serve_forever clears self.fe at shutdown
        if fe is None:
            return
        streaming = False  # the stream's headers are out
        response = {"query_id": query_id, "query": w.query, "answer": ""}
        docs_tokens = 0
        generate_time = 0.0
        llm_wall = 0.0
        try:
            async def tail():
                nonlocal docs_tokens, generate_time, llm_wall, streaming
                if srv.disable_llm:
                    response["answer"] = ""
                    if srv.simulate:
                        t0 = time.time()
                        await asyncio.sleep(LLM_DELAY)
                        llm_wall = time.time() - t0
                    return
                t0 = time.time()
                if self.world.name == "wikipedia":
                    messages, ntok = _prompts.generate_llm_message_wikipedia(
                        w.query, top_docs, w.choices, srv.model)
                else:
                    messages, ntok = _prompts.generate_llm_message(
                        self.world.name, w.query, top_docs, w.choices,
                        srv.model)
                docs_tokens = ntok
                if w.stream and w.group is None:
                    streaming = True
                    fe.begin_stream(w.rid)
                    llm_res = None
                    async for item in srv.llm.chat_stream(srv.model,
                                                          messages):
                        if isinstance(item, str):
                            fe.stream_chunk(
                                w.rid, "data: " + _dumps({"delta": item})
                                + "\n\n")
                        else:
                            llm_res = item
                else:
                    llm_res = await srv.llm.chat(srv.model, messages)
                generate_time = (llm_res.generate_time
                                 if llm_res.generate_time >= 0 else -1)
                response["answer"] = llm_res.answer
                llm_wall = time.time() - t0

            await asyncio.wait_for(tail(), timeout=QUERY_TIMEOUT_S)
            result = srv._finalize(
                response, res, selected=selected, ds_stats=ds_stats,
                top_docs=top_docs, raw_docs=raw_docs,
                generate_time=generate_time, docs_tokens=docs_tokens,
                start=w.start, embedding_time=w.embed_time,
                batch_wait=batch_wait, t_assemble=t_assemble,
                llm_wall=llm_wall)
        except asyncio.TimeoutError:
            return self._fail_direct(w, "Search timed out", streaming,
                                     status=504)
        except Exception as e:
            logger.exception("generation tail failed")
            return self._fail_direct(w, str(e), streaming)
        self._deliver_direct(w, result, streaming)

    def _fail_direct(self, w: _Work, msg: str, streaming: bool,
                     status: int = 500) -> None:
        """A failure answered from the finisher thread."""
        fe = self.fe
        if fe is None:
            return
        if streaming:
            # the headers went out as 200 event-stream: an in-band error
            # event, then [DONE], as the aiohttp handler does
            fe.stream_chunk(w.rid, "data: " + _dumps({"error": msg})
                            + "\n\n")
            fe.stream_chunk(w.rid, "data: [DONE]\n\n")
            fe.stream_end(w.rid)
            return
        if w.group is not None:
            return self._group_done(w.group, w.gidx, {"error": msg},
                                    direct=True)
        fe.respond(w.rid, status,
                   msg if status == 504 else f"Internal error: {msg}",
                   ctype=TEXT)

    def _deliver_direct(self, w: _Work, result: dict,
                        streaming: bool) -> None:
        """A success answered from the finisher thread."""
        fe = self.fe
        if fe is None:
            return
        if w.group is not None:
            return self._group_done(w.group, w.gidx, result, direct=True)
        body = self._encode_single(result)
        if streaming:
            fe.stream_chunk(w.rid, "data: " + body + "\n\n")
            fe.stream_chunk(w.rid, "data: [DONE]\n\n")
            fe.stream_end(w.rid)
        elif w.stream:
            fe.respond(w.rid, 200, "data: " + body + "\n\ndata: [DONE]\n\n",
                       ctype=b"text/event-stream")
        else:
            fe.respond(w.rid, 200, body)

    # -- response delivery ---------------------------------------------------

    def _fail(self, w: _Work, e: Exception) -> None:
        if w.group is not None:
            self._group_done(w.group, w.gidx, {"error": str(e)})
        else:
            self._respond(w.rid, 500, f"Internal error: {e}", ctype=TEXT)

    def _encode_single(self, result: dict) -> str:
        raw = result.pop("__rawdocs__", None)
        if raw is not None:
            body = self.server._splice_raw(_dumps(result), [raw], [result])
            if body is not None:
                return body
        return _dumps(result)

    def _deliver(self, w: _Work, result: dict) -> None:
        if w.group is not None:
            self._group_done(w.group, w.gidx, result)
            return
        body = self._encode_single(result)
        if w.stream:
            # with the LLM off there are no delta events: the final event,
            # then [DONE]
            self._respond(w.rid, 200,
                          "data: " + body + "\n\ndata: [DONE]\n\n",
                          ctype=b"text/event-stream")
        else:
            self._respond(w.rid, 200, body)

    def _group_done(self, group: _Group, idx: int, result,
                    direct: bool = False) -> None:
        with group.lock:
            group.results[idx] = result
            group.remaining -= 1
            if group.remaining > 0:
                return
        results = group.results
        frags, owners = [], []
        for r in results:
            if isinstance(r, dict):
                raw = r.pop("__rawdocs__", None)
                if raw is not None:
                    frags.append(raw)
                    owners.append(r)
        body = _dumps({"results": results})
        if frags:
            spliced = self.server._splice_raw(body, frags, owners)
            body = (spliced if spliced is not None
                    else _dumps({"results": results}))
        if direct:  # the finisher thread may not touch _out
            self.fe.respond(group.rid, 200, body)
        else:
            self._respond(group.rid, 200, body)
