"""Continuous batching for on-card generation (slot-based decode).

Port of :mod:`ragroute_tpu.llm.continuous`. The lockstep
:class:`~ragroute_tpu_torch.llm.service.GenerationService` decodes each
micro-batch to completion; here requests JOIN and LEAVE a persistent decode
loop:

* a fixed number of slots, each owning one row of a dense ``[L, slots, S,
  Hkv, Dh]`` KV cache (capacity slots x S, chosen at construction);
* slot prompts are RIGHT-padded (tokens at cache positions ``[0, len)``),
  so rotary positions equal cache indices and per-slot raggedness is one
  ``counts`` vector;
* decode runs in CHUNKS of C steps with eos / token-budget deactivation on
  the device, so the host reads only the small ``[C, slots]`` token block
  per chunk (one synchronisation a chunk);
* admission prefills new prompts as a small right-padded batch and writes
  their K/V into the free slots' cache rows between chunks;
* optional shared-prefix KV (``prefix_ids=``): the rendered head every RAG
  prompt shares is prefilled once and attended as a broadcast segment by
  every slot (one softmax over the concatenated score axis, exact);
  admission prefills only the per-request suffix.

Decode semantics are the lockstep path's: the same weights give the same
greedy tokens.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ragroute_tpu_torch.llm.model import (DecoderConfig, cache_write,
                                          inv_freq_tensor, make_generator,
                                          sample_token, stack_layers)
from ragroute_tpu_torch.llm.service import (_render_prompt, clamp_budget,
                                            encode_prompt, params_device,
                                            pick_bucket, resolve_special_id,
                                            validate_sampling)

logger = logging.getLogger("llm.continuous")
Tensor = torch.Tensor


def shared_prefix_from_messages(tokenizer, msgs_a, msgs_b) -> List[int]:
    """The longest common token prefix of two rendered chats (computed
    from the tokens, so a tokenizer that merges across the header/content
    boundary drops that token out of the prefix). Feed it two PROBE builds
    of the serving prompt with different questions/docs/options."""
    enc = []
    for msgs in (msgs_a, msgs_b):
        ids = tokenizer.encode(_render_prompt(tokenizer, msgs))
        enc.append(list(ids))
    n = 0
    for a, b in zip(*enc):
        if a != b:
            break
        n += 1
    return enc[0][:n]


def shared_prefix_ids(tokenizer, system: Optional[str]) -> List[int]:
    """Token prefix shared by every chat that opens with ``system`` (or,
    for ``None``, by every user-only chat)."""
    def msgs(p):
        return ([{"role": "system", "content": system}] if system
                else []) + [{"role": "user", "content": p}]

    return shared_prefix_from_messages(tokenizer, msgs("0"),
                                       msgs("qqqq zzzz 4242"))


# ---------------------------------------------------------------------------
# Device-side steps
# ---------------------------------------------------------------------------

def prefill_rows(params, cfg: DecoderConfig, ids: Tensor, lens: Tensor,
                 prefix_kv=None, pos0: int = 0):
    """Forward a RIGHT-padded prompt batch ``ids [n, P]`` (row b valid in
    ``[0, lens[b])``). Returns (logits at each row's last token [n, V],
    K [L, n, P, Hkv, Dh], V likewise). With a shared prefix (``prefix_kv``
    = (K, V) each [L, P0, Hkv, Dh], ``pos0`` = P0) the rows are the
    suffixes that follow it."""
    n, p = ids.shape
    dev = ids.device
    inv_freq = inv_freq_tensor(cfg, dev)
    iota = torch.arange(p, device=dev)
    positions = (pos0 + iota[None]).expand(n, p)
    valid = iota[None, :] < lens[:, None]                     # [n, P]
    kmask = (torch.tril(torch.ones((p, p), dtype=torch.bool, device=dev))
             [None] & valid[:, None, :])                      # [n, P, P]
    h = params.embed_lookup(ids)
    h, ks, vs = params.prefill_layers(cfg, h, positions, kmask,
                                      inv_freq=inv_freq, prefix_kv=prefix_kv)
    # each row's last hidden BEFORE the vocab product (P x cheaper)
    h_last = torch.gather(
        h, 1, (lens.long() - 1)[:, None, None].expand(n, 1, h.shape[-1]))
    return (params.logits(cfg, h_last)[:, 0], stack_layers(ks),
            stack_layers(vs))


def admit(params, cfg: DecoderConfig, state, ids: Tensor, lens: Tensor,
          slots: Tensor, budgets: Tensor, temperature: float, eos_id: int,
          seed: int, prefix_kv=None, pos0: int = 0, top_k: int = 0,
          top_p: float = 1.0):
    """Prefill ``ids [n, P]`` and install them into cache rows ``slots``
    [n] (in place). Returns (state, first sampled token per prompt [n])."""
    cache, counts, last_tok, active, budget, tstep, toks = state
    logits, k_new, v_new = prefill_rows(params, cfg, ids, lens,
                                        prefix_kv=prefix_kv, pos0=pos0)
    p = ids.shape[1]
    sl = slots.long()
    at_rows = (slice(None), sl, slice(None, p))
    cache_write(cache, "k", k_new, at_rows)
    cache_write(cache, "v", v_new, at_rows)
    gen = (make_generator(ids.device, seed) if temperature > 0.0 else None)
    tok0 = sample_token(logits, gen, temperature, top_k, top_p)
    counts[sl] = lens
    last_tok[sl] = tok0
    alive = (tok0 != eos_id) & (budgets > 0)
    active[sl] = alive
    budget[sl] = torch.where(alive, budgets, 0).to(torch.int32)
    toks[sl, :p] = ids  # token history (drafting source)
    return (cache, counts, last_tok, active, budget, tstep, toks), tok0


def decode_chunk(params, cfg: DecoderConfig, state, steps: int,
                 temperature: float, eos_id: int, pad_id: int,
                 prefix_kv=None, pos0: int = 0, top_k: int = 0,
                 top_p: float = 1.0, track_tokens: bool = True):
    """Run ``steps`` ragged decode steps over every slot. Returns (state,
    tokens [steps, slots] with ``pad_id`` on inactive lanes, alive [steps,
    slots]: whether the lane was active when the token was emitted).
    ``track_tokens=False`` skips the token-history writes that only
    speculative drafting reads."""
    cache, counts, tok, active, budget, tstep, toks = state
    dev = counts.device
    inv_freq = inv_freq_tensor(cfg, dev)
    s_max = cache["k"].shape[2]
    rows = torch.arange(counts.shape[0], device=dev)
    iota = torch.arange(s_max, device=dev)
    # one generator a chunk, seeded from the step count (host-side)
    gen = (make_generator(dev, (1 << 32) + tstep) if temperature > 0.0
           else None)
    out_toks, out_alive = [], []
    for _ in range(steps):
        positions = pos0 + counts[:, None]                     # [B, 1]
        kmask = (iota[None, :] <= counts[:, None])[:, None, :]
        cl = counts.long()
        if track_tokens:
            toks[rows, cl] = tok

        # per-row write at each slot's own position; inactive rows rewrite
        # their current (masked out, overwritten at the next admit) slot
        def write(cache, li, k, v):
            at_count = (li, rows, cl)
            cache_write(cache, "k", k[:, 0], at_count)
            cache_write(cache, "v", v[:, 0], at_count)

        h = params.embed_lookup(tok)[:, None]
        h = params.decode_layers(cfg, h, positions, kmask, cache, write,
                                 inv_freq=inv_freq, prefix_kv=prefix_kv)
        logits = params.logits(cfg, h)[:, 0]
        nxt = sample_token(logits, gen, temperature, top_k, top_p)
        nxt = torch.where(active, nxt, pad_id).to(torch.int32)
        act = active.to(torch.int32)
        counts = counts + act
        budget = budget - act
        done = active & ((nxt == eos_id) | (budget <= 0)
                         | (counts >= s_max - 1))
        # `active` at entry tells the host whether nxt is a real token; a
        # slot going inactive without eos/budget (cache capacity) must be
        # finished host-side
        out_toks.append(nxt)
        out_alive.append(active)
        active = active & ~done
        tok = nxt
        tstep += 1
    state = (cache, counts, tok, active, budget, tstep, toks)
    return state, torch.stack(out_toks), torch.stack(out_alive)


# ---------------------------------------------------------------------------
# Service
# ---------------------------------------------------------------------------

class ContinuousGenerationService:
    """Drop-in alternative to ``GenerationService`` (same ``chat()``
    protocol, same tokenizer handling) with slot-based continuous
    batching: requests join the running decode at chunk boundaries."""

    def __init__(self, params, cfg: DecoderConfig, tokenizer, *,
                 slots: int = 8,
                 cache_len: int = 1024,
                 max_new_tokens: int = 64,
                 prompt_buckets: Sequence[int] = (128, 512),
                 admit_buckets: Sequence[int] = (1, 2, 4),
                 chunk_steps: int = 16,
                 temperature: float = 0.0,
                 top_k: int = 0,
                 top_p: float = 1.0,
                 cache_dtype=torch.bfloat16,
                 eos_id: Optional[int] = None,
                 pad_id: Optional[int] = None,
                 spec_window: int = 0,
                 prefix_ids: Optional[Sequence[int]] = None):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = params_device(params)
        self.slots = int(slots)
        self.cache_len = int(cache_len)
        # prompt-lookup speculative decoding (speculative.py): each chunk
        # step verifies a spec_window-token window; greedy only
        self.spec_window = int(spec_window)
        if self.spec_window and temperature > 0:
            raise ValueError("speculative decoding is greedy-only "
                             "(temperature must be 0)")
        if self.spec_window < 0 or self.spec_window == 1:
            raise ValueError("spec_window must be 0 (off) or >= 2")
        self.max_new_tokens = int(max_new_tokens)
        self.prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        # a full-bucket prompt must leave room for at least one decode
        # window before the capacity guard fires
        margin = max(self.spec_window, 1) + 1
        if self.prompt_buckets[-1] + margin >= self.cache_len:
            raise ValueError(
                f"cache_len ({self.cache_len}) must exceed the largest "
                f"prompt bucket ({self.prompt_buckets[-1]}) by more than "
                f"{margin} (prompt + generation share a slot)")
        self.admit_buckets = tuple(sorted(int(b) for b in admit_buckets))
        self.chunk_steps = int(chunk_steps)
        self.temperature = float(temperature)
        self.top_k, self.top_p = validate_sampling(top_k, top_p)
        self.eos_id = resolve_special_id(tokenizer, eos_id,
                                         "eos_token_id", "eos_id")
        self.pad_id = resolve_special_id(tokenizer, pad_id,
                                         "pad_token_id", "pad_id")
        self.cache_dtype = cache_dtype
        self.prefix_ids: Optional[List[int]] = (
            [int(t) for t in prefix_ids] if prefix_ids else None)
        self._prefix_kv = None      # (K, V) [L,P0,Hkv,Dh], built lazily
        self._state = self._fresh_state()
        # host-side slot bookkeeping: None = free
        self._slot_req: List[Optional[dict]] = [None] * self.slots
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._seed = 0
        self.generated_tokens = 0
        self.chunks = 0
        self.admissions = 0
        self.spec_steps = 0      # verify steps executed (spec mode)
        self.spec_emitted = 0    # tokens they emitted (mean = accept+1)

    def _fresh_state(self):
        """A blank device state (empty cache, all slots inactive); also
        what the worker rebuilds after a failed step, whose in-place writes
        may have left the old state half updated."""
        dev, n = self.device, self.slots
        cache = self.params.init_cache(self.cfg, n, self.cache_len,
                                       self.cache_dtype)

        def zeros(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return (cache, zeros(n), zeros(n), zeros(n, dtype=torch.bool),
                zeros(n), 0, zeros(n, self.cache_len))

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._worker())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # resolve everything still waiting (in a slot or queued)
        leftovers = [r for r in self._slot_req if r is not None]
        self._slot_req = [None] * self.slots
        while not self._queue.empty():
            try:
                leftovers.append(self._queue.get_nowait())
            except asyncio.QueueEmpty:
                break
        for req in leftovers:
            fut = req["future"]
            if not fut.done():
                fut.cancel()
            stream = req.get("stream")
            if stream is not None:
                # a truncated stream must not look like a completed one
                stream.put_nowait(
                    {"final": self.tokenizer.decode(req["tokens"]),
                     "error": "service stopped before completion"})

    # -- API -----------------------------------------------------------------

    def _prefix(self):
        """(K, V) for the shared prefix, each [L, P0, Hkv, Dh]: one prefill
        on first use, kept for the service's lifetime."""
        if self._prefix_kv is None:
            ids = torch.tensor([self.prefix_ids], dtype=torch.int32,
                               device=self.device)
            lens = torch.tensor([len(self.prefix_ids)], dtype=torch.int32,
                                device=self.device)
            with torch.no_grad():
                _, k, v = prefill_rows(self.params, self.cfg, ids, lens)
            self._prefix_kv = (k[:, 0], v[:, 0])
        return self._prefix_kv

    def _encode_request(self, messages) -> List[int]:
        if self.prefix_ids is None:
            return encode_prompt(self.tokenizer, messages,
                                 self.prompt_buckets[-1])
        ids = self.tokenizer.encode(_render_prompt(self.tokenizer,
                                                   messages))
        if not isinstance(ids, list):
            ids = list(ids)
        p0 = len(self.prefix_ids)
        if ids[:p0] != self.prefix_ids or len(ids) <= p0:
            raise ValueError(
                "prompt does not extend the service's shared prefix "
                f"(prefix len {p0}, prompt len {len(ids)}); build "
                "prompts with the same system head the service was "
                "configured with (shared_prefix_ids)")
        tail = ids[p0:]
        cap = self.prompt_buckets[-1]
        return tail[-cap:] if len(tail) > cap else tail

    def _make_request(self, messages, max_new, **extra) -> dict:
        return {
            "ids": self._encode_request(messages),
            "future": asyncio.get_running_loop().create_future(),
            "tokens": [],
            "max_new": clamp_budget(max_new, self.max_new_tokens),
            **extra,
        }

    async def chat(self, messages: List[Dict[str, str]],
                   max_new: Optional[int] = None) -> str:
        if self._task is None:
            await self.start()
        req = self._make_request(messages, max_new)
        await self._queue.put(req)
        self._wake.set()
        return await req["future"]

    async def chat_stream(self, messages: List[Dict[str, str]],
                          max_new: Optional[int] = None):
        """Streaming variant of :meth:`chat`: text DELTAS as chunks land,
        then one ``{"final": text}`` dict with the full answer. Deltas are
        prefix-consistent (withheld while a trailing byte sequence is an
        incomplete UTF-8 character)."""
        if self._task is None:
            await self.start()
        stream: asyncio.Queue = asyncio.Queue()
        req = self._make_request(messages, max_new, stream=stream,
                                 streamed="")
        await self._queue.put(req)
        self._wake.set()
        while True:
            item = await stream.get()
            if isinstance(item, dict):
                yield item
                return
            yield item

    # -- worker --------------------------------------------------------------

    async def _worker(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            has_active = any(r is not None for r in self._slot_req)
            if not has_active and self._queue.empty():
                self._wake.clear()
                await self._wake.wait()
            try:
                # admission groups are built and futures credited on the
                # loop thread; only the device steps run in the executor
                for group in self._collect_admissions():
                    tok0 = await loop.run_in_executor(
                        None, self._run_admit, group)
                    for j, req in enumerate(group["reqs"]):
                        self._credit(req, [int(tok0[j])])
                if any(r is not None for r in self._slot_req):
                    if self.spec_window:
                        toks, n_emit = await loop.run_in_executor(
                            None, self._run_chunk_spec)
                        self._process_tokens_spec(toks, n_emit)
                    else:
                        toks, alive = await loop.run_in_executor(
                            None, self._run_chunk)
                        self._process_tokens(toks, alive)
            except Exception as e:  # device failure: fail loudly, resolve
                # every caller, keep the worker alive
                logger.exception("continuous generation step failed")
                for si, req in enumerate(self._slot_req):
                    if req is not None:
                        self._slot_req[si] = None
                        self._fail(req, e)
                while not self._queue.empty():
                    try:
                        self._fail(self._queue.get_nowait(), e)
                    except asyncio.QueueEmpty:
                        break
                # the failed step may have left the state half written
                self._state = self._fresh_state()
            # yield so chat() callers can enqueue between chunks
            await asyncio.sleep(0)

    def _fail(self, req: dict, exc: Exception) -> None:
        fut = req["future"]
        stream = req.get("stream")
        if stream is not None:
            # streamed callers read the stream, never the future: the error
            # travels in-band
            if not fut.done():
                fut.cancel()
            stream.put_nowait({"final": f"Error generating response: {exc}",
                               "error": str(exc)})
        elif not fut.done():
            fut.set_exception(exc)

    def _collect_admissions(self) -> List[dict]:
        """Drain the queue into EXACT-bucket-size admission groups (no
        padded scatter lanes: duplicate scatter targets have no defined
        order). Leftovers below the smallest bucket admit as the smallest
        group they fit."""
        free = [i for i, r in enumerate(self._slot_req) if r is None]
        pending: List[dict] = []
        while len(pending) < len(free) and not self._queue.empty():
            try:
                pending.append(self._queue.get_nowait())
            except asyncio.QueueEmpty:
                break
        groups = []
        while pending:
            n = next((b for b in reversed(self.admit_buckets)
                      if b <= len(pending)), self.admit_buckets[0])
            n = min(n, len(pending))
            take, pending = pending[:n], pending[n:]
            p = pick_bucket(self.prompt_buckets,
                            max(len(r["ids"]) for r in take))
            ids = np.full((n, p), self.pad_id, np.int32)
            lens = np.ones((n,), np.int32)
            slot_ids = np.zeros((n,), np.int32)
            for j, req in enumerate(take):
                toks = req["ids"][-p:]
                ids[j, :len(toks)] = toks
                lens[j] = len(toks)
                slot_ids[j] = free.pop(0)
                self._slot_req[slot_ids[j]] = req
            # tok0 (sampled at admit) counts toward the request's max_new,
            # so the device decode budget is max_new - 1
            groups.append({"reqs": take, "ids": ids, "lens": lens,
                           "slots": slot_ids,
                           "budgets": np.asarray(
                               [r["max_new"] - 1 for r in take],
                               np.int32)})
        return groups

    def _p0(self) -> int:
        return len(self.prefix_ids) if self.prefix_ids else 0

    def _run_admit(self, group: dict) -> np.ndarray:
        self._seed += 1
        dev = self.device

        def t(a):
            return torch.from_numpy(a).to(dev)

        with torch.no_grad():
            pkv = None if self.prefix_ids is None else self._prefix()
            self._state, tok0 = admit(
                self.params, self.cfg, self._state, t(group["ids"]),
                t(group["lens"]), t(group["slots"]), t(group["budgets"]),
                self.temperature, self.eos_id, self._seed, prefix_kv=pkv,
                pos0=self._p0(), top_k=self.top_k, top_p=self.top_p)
            tok0 = tok0.cpu().numpy()
        self.admissions += 1
        return tok0

    def _run_chunk(self):
        with torch.no_grad():
            pkv = None if self.prefix_ids is None else self._prefix()
            # this engine runs only with spec_window == 0, so it skips the
            # token-history writes that only drafting reads
            self._state, toks, alive = decode_chunk(
                self.params, self.cfg, self._state, self.chunk_steps,
                self.temperature, self.eos_id, self.pad_id, prefix_kv=pkv,
                pos0=self._p0(), top_k=self.top_k, top_p=self.top_p,
                track_tokens=False)
            toks, alive = toks.cpu().numpy(), alive.cpu().numpy()
        self.chunks += 1
        return toks, alive

    def _run_chunk_spec(self):
        from ragroute_tpu_torch.llm.speculative import spec_decode_chunk

        with torch.no_grad():
            pkv = None if self.prefix_ids is None else self._prefix()
            self._state, toks, n_emit = spec_decode_chunk(
                self.params, self.cfg, self._state, self.chunk_steps,
                self.spec_window, self.eos_id, self.pad_id, prefix_kv=pkv,
                pos0=self._p0())
            toks, n_emit = toks.cpu().numpy(), n_emit.cpu().numpy()
        self.chunks += 1
        return toks, n_emit

    def _process_tokens(self, toks: np.ndarray, alive: np.ndarray) -> None:
        """Distribute a [steps, slots] chunk to the owning requests. A slot
        whose lane went inactive without the host seeing eos/budget (cache
        capacity) is finished truncated."""
        for si in range(self.slots):
            req = self._slot_req[si]
            if req is None:
                continue
            real = [int(t) for t, a in zip(toks[:, si], alive[:, si]) if a]
            truncated = not bool(alive[-1, si])
            self._credit(req, real)
            if truncated and self._slot_req[si] is req:
                self._finish(req)  # capacity stop: no eos/budget will come

    def _process_tokens_spec(self, toks: np.ndarray,
                             n_emit: np.ndarray) -> None:
        """Distribute a [steps, slots, window] spec chunk: step s emitted
        ``toks[s, b, :n_emit[s, b]]`` for slot b."""
        steps = toks.shape[0]
        for si in range(self.slots):
            req = self._slot_req[si]
            if req is None:
                continue
            out = []
            for s in range(steps):
                n = int(n_emit[s, si])
                out.extend(int(t) for t in toks[s, si, :n])
                self.spec_steps += n > 0
                self.spec_emitted += n
            self._credit(req, out)
            # a whole chunk with zero emissions means the lane is inactive
            # (capacity stop): finish truncated, never hang
            if not out and self._slot_req[si] is req:
                self._finish(req)

    def _credit(self, req: dict, tokens: List[int]) -> None:
        cap = req["max_new"]
        for t in tokens:
            if len(req["tokens"]) >= cap or t == self.eos_id:
                self._finish(req)
                return
            req["tokens"].append(t)
        if len(req["tokens"]) >= cap:
            self._finish(req)
            return
        self._push_stream_delta(req)

    def _push_stream_delta(self, req: dict) -> None:
        stream = req.get("stream")
        if stream is None:
            return
        text = self.tokenizer.decode(req["tokens"])
        # a PARTIAL trailing byte sequence decodes to U+FFFD now but may
        # become a real character next chunk: never emit trailing
        # replacement characters
        while text.endswith("�"):
            text = text[:-1]
        if text.startswith(req["streamed"]):
            delta = text[len(req["streamed"]):]
            if delta:
                stream.put_nowait(delta)
                req["streamed"] = text

    def _finish(self, req: dict) -> None:
        si = next((i for i, r in enumerate(self._slot_req) if r is req),
                  None)
        if si is not None:
            self._slot_req[si] = None
        # req["tokens"] holds only live tokens (inactive lanes filtered by
        # alive / n_emit), so a token equal to pad_id is a real sample and
        # stays
        row = list(req["tokens"])
        text = self.tokenizer.decode(row)
        fut = req["future"]
        if not fut.done():
            self.generated_tokens += len(row)
            fut.set_result(text)
        stream = req.get("stream")
        if stream is not None:
            stream.put_nowait({"final": text})


def demo_continuous_service(seed: int = 0, device="cpu", **kw):
    """Continuous-batching twin of ``service.demo_service``."""
    from ragroute_tpu_torch.llm.model import init_decoder_params
    from ragroute_tpu_torch.llm.service import DEMO_CFG, ByteTokenizer

    tok = ByteTokenizer()
    params = init_decoder_params(seed, DEMO_CFG, device=device)
    kw.setdefault("prompt_buckets", (128, 512))
    kw.setdefault("cache_len", 768)
    kw.setdefault("max_new_tokens", 32)
    kw.setdefault("cache_dtype", torch.float32)
    return ContinuousGenerationService(
        params, DEMO_CFG, tok, eos_id=tok.eos_id, pad_id=tok.pad_id, **kw)
