"""Batched async generation service over the PyTorch decoder.

Port of :mod:`ragroute_tpu.llm.service`, the runtime half of ``LLMClient(
backend="jax")``: concurrent ``chat()`` calls are micro-batched (the pattern
of the retrieval ``QueryBatcher``), left-padded to a prompt bucket and a
batch bucket, and run through one prefill + decode per batch on the
weights' device (the card when serving, the CPU in the tests).

Weights come from a local HF checkpoint directory
(:meth:`GenerationService.from_checkpoint`; ``transformers`` is imported
there and only there, and the converted weights are cached beside the
checkpoint as the JAX package's ``ragroute_jax_params.npz``, which either
package reads), from :func:`demo_service` (a tiny seeded decoder with a
byte-level tokenizer that keeps the whole path executable offline; its
answers are gibberish), or from any :class:`~ragroute_tpu_torch.llm.model.
Decoder` handed to the constructor.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ragroute_tpu_torch.llm.model import (Decoder, DecoderConfig,
                                          DecoderLayer, config_from_hf,
                                          generate, init_decoder_params,
                                          params_from_torch_causal_lm,
                                          quantize_decoder_params)

logger = logging.getLogger("llm.jax")


def _ckpt_fingerprint(path: str) -> str:
    """Identity of the torch weight files (name, size, mtime of every
    weight shard + config.json), so a stale conversion cache is never
    served."""
    rows = []
    for name in sorted(os.listdir(path)):
        if name.endswith((".safetensors", ".bin")) or name == "config.json":
            st = os.stat(os.path.join(path, name))
            rows.append([name, st.st_size, int(st.st_mtime)])
    return json.dumps(rows)


def save_params_cache(cache_file: str, params: Decoder,
                      fingerprint: str) -> None:
    """Persist unquantized weights as one npz in the JAX package's layout
    (``embed``, ``ln_f``, ``lm_head``, ``layers.{i}.{name}``; bf16 leaves as
    uint16 views under ``name@bf16``)."""
    flat: Dict[str, np.ndarray] = {}

    def put(key, t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key + "@bf16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()

    for k, v in params.items():
        put(k, v)
    for i, layer in enumerate(params.layers):
        for lk, lv in layer.items():
            put(f"layers.{i}.{lk}", lv)
    flat["__fingerprint__"] = np.frombuffer(fingerprint.encode(), np.uint8)
    # per-process tmp name: concurrent boots must not publish a file that
    # another writer is still writing (ends in .npz so savez won't rename)
    tmp = f"{cache_file}.tmp.{os.getpid()}.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, cache_file)


def load_params_cache(cache_file: str,
                      fingerprint: str) -> Optional[Decoder]:
    """The cached weights (on the CPU) if present AND built from exactly
    the current torch weight files; None otherwise (convert + re-save)."""
    if not os.path.exists(cache_file):
        return None
    try:
        z = np.load(cache_file)
        fp = bytes(z["__fingerprint__"]).decode()
        if fp != fingerprint:
            logger.info("params cache %s is stale (weights changed); "
                        "reconverting", cache_file)
            return None
        top: Dict[str, torch.Tensor] = {}
        layers: List[Dict[str, torch.Tensor]] = []
        for key in z.files:
            if key == "__fingerprint__":
                continue
            name, bf16 = ((key[:-5], True) if key.endswith("@bf16")
                          else (key, False))
            arr = np.array(z[key])
            t = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                 if bf16 else torch.from_numpy(arr))
            if name.startswith("layers."):
                _, idx, leaf = name.split(".", 2)
                i = int(idx)
                while len(layers) <= i:
                    layers.append({})
                layers[i][leaf] = t
            else:
                top[name] = t
        return Decoder(top, [DecoderLayer(l) for l in layers])
    except Exception as e:  # corrupt cache: fall back to conversion
        logger.warning("params cache %s unreadable (%s); reconverting",
                       cache_file, e)
        return None


DEMO_CFG = DecoderConfig(
    vocab_size=260, hidden_size=128, num_layers=2, num_heads=8,
    num_kv_heads=4, head_dim=16, intermediate_size=256)


class ByteTokenizer:
    """Offline byte-level tokenizer: ids 0-255 = raw bytes, then
    pad/bos/eos. Lossless on any text; pairs with the demo decoder."""

    pad_id = 256
    bos_id = 257
    eos_id = 258
    vocab_size = 260
    is_fallback = True

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        raw = bytes(i for i in ids if i < 256)
        return raw.decode("utf-8", "replace")

    def apply_chat_template(self, messages, add_generation_prompt=True,
                            tokenize=False) -> str:
        parts = [f"<|{m['role']}|>\n{m['content']}" for m in messages]
        if add_generation_prompt:
            parts.append("<|assistant|>\n")
        return "\n".join(parts)


def _render_prompt(tokenizer, messages: List[Dict[str, str]]) -> str:
    """Chat-template the messages; fall back to role-tagged concat."""
    tmpl = getattr(tokenizer, "apply_chat_template", None)
    if tmpl is not None and getattr(tokenizer, "chat_template", True):
        try:
            return tmpl(messages, tokenize=False,
                        add_generation_prompt=True)
        except Exception:
            pass
    return "\n".join(
        f"<|{m['role']}|>\n{m['content']}" for m in messages
    ) + "\n<|assistant|>\n"


# shared helpers for both generation services -------------------------------

def resolve_special_id(tokenizer, explicit, attr: str, fallback_attr: str,
                       default: int = 0) -> int:
    """eos/pad id resolution: explicit arg > HF attr > byte-tokenizer
    attr > default."""
    if explicit is not None:
        return int(explicit)
    v = getattr(tokenizer, attr, None)
    if v is None:
        v = getattr(tokenizer, fallback_attr, None)
    return int(v) if v is not None else default


def validate_sampling(top_k, top_p) -> Tuple[int, float]:
    """Reject degenerate truncation params at CONSTRUCTION time: a negative
    top_k would fail every admission, and top_p=0 would floor every logit
    so that every step emits token id 0."""
    top_k, top_p = int(top_k), float(top_p)
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 = off), got {top_k}")
    if not 0.0 < top_p <= 1.0:
        raise ValueError(
            f"top_p must be in (0, 1] (1.0 = off), got {top_p}")
    return top_k, top_p


def pick_bucket(buckets: Sequence[int], n: int) -> int:
    """Smallest bucket that fits ``n`` (largest bucket if none do)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def encode_prompt(tokenizer, messages, max_prompt: int) -> List[int]:
    """Render + tokenize one chat, keeping the TAIL when over the
    largest prompt bucket (the question/options sit at the end)."""
    ids = tokenizer.encode(_render_prompt(tokenizer, messages))
    if not isinstance(ids, list):
        ids = list(ids)
    return ids[-max_prompt:] if len(ids) > max_prompt else ids


def clamp_budget(max_new, cap: int) -> int:
    return cap if max_new is None else max(1, min(int(max_new), cap))


def params_device(params: Decoder) -> torch.device:
    return params.ln_f.device


class GenerationService:
    """Micro-batching front-end over :func:`ragroute_tpu_torch.llm.model.
    generate`.

    ``chat()`` enqueues and awaits a future; one worker drains the queue,
    pads the batch to the smallest prompt and batch buckets that fit, and
    runs one generate on the weights' device in an executor thread, so the
    event loop stays responsive while a batch decodes."""

    def __init__(self, params: Decoder, cfg: DecoderConfig, tokenizer, *,
                 max_new_tokens: int = 64,
                 prompt_buckets: Sequence[int] = (128, 512, 2048),
                 batch_buckets: Sequence[int] = (1, 4, 16),
                 temperature: float = 0.0,
                 top_k: int = 0,
                 top_p: float = 1.0,
                 cache_dtype=torch.bfloat16,
                 eos_id: Optional[int] = None,
                 pad_id: Optional[int] = None,
                 flush_interval_s: float = 0.004):
        self.params = params
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.device = params_device(params)
        self.max_new_tokens = int(max_new_tokens)
        self.prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        self.batch_buckets = tuple(sorted(int(b) for b in batch_buckets))
        self.temperature = float(temperature)
        self.top_k, self.top_p = validate_sampling(top_k, top_p)
        self.cache_dtype = cache_dtype
        self.eos_id = resolve_special_id(tokenizer, eos_id,
                                         "eos_token_id", "eos_id")
        self.pad_id = resolve_special_id(tokenizer, pad_id,
                                         "pad_token_id", "pad_id")
        self._queue: asyncio.Queue = asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self._inflight: List = []  # dequeued-but-unresolved batch items
        self._flush_s = flush_interval_s
        self.generated_tokens = 0
        self.batches = 0

    # -- construction ------------------------------------------------------

    @classmethod
    def from_checkpoint(cls, path: str, quantize: Optional[str] = None,
                        device="cpu", **kw) -> "GenerationService":
        """Load a local HF causal-LM checkpoint directory onto ``device``.
        ``quantize="int8"``: weight-only per-channel int8; ``"int4"``:
        packed nibbles with group scales through the K5 kernel. The bf16
        conversion is cached beside the checkpoint
        (``ragroute_jax_params.npz``, fingerprinted against the weight
        files)."""
        from transformers import (AutoConfig, AutoModelForCausalLM,
                                  AutoTokenizer)

        hf_cfg = AutoConfig.from_pretrained(path, local_files_only=True)
        cfg = config_from_hf(hf_cfg)
        fp = _ckpt_fingerprint(path)
        cache_file = os.path.join(path, "ragroute_jax_params.npz")
        params = load_params_cache(cache_file, fp)
        if params is None:
            model = AutoModelForCausalLM.from_pretrained(
                path, local_files_only=True)
            params = params_from_torch_causal_lm(
                model.state_dict(), cfg, dtype=torch.bfloat16)
            del model
            try:
                save_params_cache(cache_file, params, fp)
            except OSError as e:  # read-only checkpoint dir: still serve
                logger.warning("could not write params cache %s: %s",
                               cache_file, e)
        params = params.to(device)
        if quantize in ("int8", "int4"):
            params = quantize_decoder_params(
                params, cfg, bits=(4 if quantize == "int4" else 8))
        elif quantize:
            raise ValueError(f"unknown quantize mode {quantize!r}")
        tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        return cls(params, cfg, tok, **kw)

    # -- lifecycle ---------------------------------------------------------

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
        # requests the worker had already dequeued (popped but unresolved
        # when the cancel landed) would otherwise await forever
        for item in self._inflight:
            fut = item[-1]
            if not fut.done():
                fut.cancel()
        self._inflight = []
        while not self._queue.empty():
            try:
                item = self._queue.get_nowait()
            except asyncio.QueueEmpty:
                break
            fut = item[-1]
            if not fut.done():
                fut.cancel()

    # -- API ---------------------------------------------------------------

    async def chat(self, messages: List[Dict[str, str]],
                   max_new: Optional[int] = None) -> str:
        """Generate a completion for one chat; batches with concurrent
        callers. ``max_new`` caps THIS request's tokens (<= the service
        max)."""
        if self._task is None:
            await self.start()
        ids = encode_prompt(self.tokenizer, messages,
                            self.prompt_buckets[-1])
        budget = clamp_budget(max_new, self.max_new_tokens)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        await self._queue.put((ids, budget, fut))
        return await fut

    # -- internals ----------------------------------------------------------

    async def _worker(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            first = await self._queue.get()
            items = self._inflight = [first]
            if self._flush_s:
                await asyncio.sleep(self._flush_s)  # let a batch gather
            max_b = self.batch_buckets[-1]
            while len(items) < max_b:
                try:
                    items.append(self._queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            try:
                texts = await loop.run_in_executor(
                    None, self._run_batch,
                    [it[0] for it in items], [it[1] for it in items])
                for (_, _, fut), text in zip(items, texts):
                    if not fut.done():
                        fut.set_result(text)
            except Exception as e:  # pragma: no cover - defensive
                logger.exception("generation batch failed")
                for _, _, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
            finally:
                self._inflight = []

    def _run_batch(self, prompts: List[List[int]],
                   budgets: List[int]) -> List[str]:
        p = pick_bucket(self.prompt_buckets, max(len(x) for x in prompts))
        b = pick_bucket(self.batch_buckets, len(prompts))
        ids = np.full((b, p), self.pad_id, np.int32)
        mask = np.zeros((b, p), np.int32)
        buds = np.zeros((b,), np.int32)
        for i, toks in enumerate(prompts):
            toks = toks[-p:]
            ids[i, p - len(toks):] = toks
            mask[i, p - len(toks):] = 1
            buds[i] = budgets[i]
        dev = self.device
        with torch.no_grad():
            # the seed advances per batch: at temperature > 0 a fixed seed
            # would sample the same answers batch after batch
            tokens, _ = generate(
                self.params, self.cfg, torch.from_numpy(ids).to(dev),
                torch.from_numpy(mask).to(dev), self.max_new_tokens,
                eos_id=self.eos_id, pad_id=self.pad_id,
                temperature=self.temperature, top_k=self.top_k,
                top_p=self.top_p, rng_seed=self.batches,
                cache_dtype=self.cache_dtype,
                budgets=torch.from_numpy(buds).to(dev))
            tokens = tokens.cpu().numpy()
        self.batches += 1
        out = []
        for i in range(len(prompts)):
            row = [int(t) for t in tokens[i][:budgets[i]]]
            if self.eos_id in row:
                row = row[: row.index(self.eos_id)]
            # padding never survives these cuts (pads are emitted only past
            # a row's eos or budget); a remaining trailing pad_id is a REAL
            # sampled token that aliases the pad id and is kept, as the
            # continuous engine keeps it
            self.generated_tokens += len(row)
            out.append(self.tokenizer.decode(row))
        return out


def demo_service(seed: int = 0, device="cpu", **kw) -> GenerationService:
    """Offline demo: tiny seeded decoder + byte tokenizer on ``device``.
    The full serving path executes end-to-end; answers are gibberish."""
    logger.warning(
        "jax LLM backend running DEMO weights (tiny random decoder): "
        "answers are not meaningful. Point --llm-checkpoint at a local "
        "HF causal-LM directory for real generation.")
    tok = ByteTokenizer()
    params = init_decoder_params(seed, DEMO_CFG, device=device)
    kw.setdefault("prompt_buckets", (128, 512))
    kw.setdefault("max_new_tokens", 32)
    kw.setdefault("cache_dtype", torch.float32)
    return GenerationService(params, DEMO_CFG, tok, eos_id=tok.eos_id,
                             pad_id=tok.pad_id, **kw)
