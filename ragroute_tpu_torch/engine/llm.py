"""LLM generation shim.

The reference calls an external Ollama daemon
(``http_server.py:309-327``: ``AsyncClient().chat`` with ``num_predict``
and a 240 s timeout returning ``generate_time=-1`` on expiry). Generation
stays an external-service concern here too — the measured configuration is
retrieval-only (``--disable-llm``) — but the shim keeps full behavioral
parity and pluggable backends:

* ``ollama``  — the reference backend, speaking the Ollama HTTP API
  (``POST /api/chat``, non-streaming) directly over aiohttp — no
  ``ollama`` pip package needed; honors ``$OLLAMA_HOST`` / ``endpoint``
  exactly like the reference's client does
  (``http_server.py:309-327``). Protocol-gated in CI against a mock
  daemon (``tests/test_llm_backends.py``).
* ``openai``  — any OpenAI-compatible HTTP endpoint (aiohttp).
* ``echo``    — deterministic canned answers for simulation/testing
  (answers "A" in the reference answer formats, optional delay matching
  ``LLM_DELAY``).
* ``jax``     — generation on the card next to retrieval (the value keeps
  the JAX package's name): the registry models run as this package's
  PyTorch decoder through the micro-batching
  :class:`ragroute_tpu_torch.llm.GenerationService` or the continuous
  :class:`ragroute_tpu_torch.llm.ContinuousGenerationService` (``service=``:
  a local HF checkpoint via ``GenerationService.from_checkpoint``, or the
  offline demo model).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from typing import Dict, List, Optional

from ragroute_tpu_torch.config import LLM_MODELS, LLM_TIMEOUT_S

logger = logging.getLogger("llm")


@dataclasses.dataclass
class LLMResult:
    answer: str
    generate_time: float  # -1.0 on timeout (reference http_server.py:326)
    ok: bool


class LLMClient:
    """Async LLM client with reference timeout semantics."""

    def __init__(
        self,
        backend: str = "echo",
        *,
        delay_s: float = 0.0,
        endpoint: Optional[str] = None,
        timeout_s: float = LLM_TIMEOUT_S,
        service=None,
    ):
        if backend not in ("ollama", "openai", "echo", "jax"):
            raise ValueError(f"unknown LLM backend {backend!r}")
        if backend == "jax" and service is None:
            raise ValueError("backend='jax' needs a GenerationService")
        self.backend = backend
        self.delay_s = delay_s
        self.endpoint = endpoint
        self.timeout_s = timeout_s
        self.service = service

    async def chat(
        self, model: str, messages: List[Dict[str, str]]
    ) -> LLMResult:
        import time

        start = time.time()
        try:
            content = await asyncio.wait_for(
                self._dispatch(model, messages), timeout=self.timeout_s)
            return LLMResult(content, time.time() - start, True)
        except asyncio.TimeoutError:
            logger.warning("LLM generation timed out")
            return LLMResult("Error generation timed out.", -1.0, False)
        except Exception as e:  # reference wraps all errors into the answer
            logger.error("Error generating LLM message: %s", e)
            return LLMResult(
                f"Error generating response: {e}", time.time() - start, False)

    async def chat_stream(self, model: str, messages):
        """Async generator: text deltas as they decode, then one final
        ``LLMResult``. Incremental only on backends that stream (the jax
        continuous service); others emit the whole answer as one delta —
        the interface is uniform either way."""
        import time

        start = time.time()
        svc_stream = (getattr(self.service, "chat_stream", None)
                      if self.backend == "jax" else None)
        if svc_stream is None:
            res = await self.chat(model, messages)
            if res.answer:
                yield res.answer
            yield res
            return
        final = ""
        try:
            agen = svc_stream(messages)
            while True:
                item = await asyncio.wait_for(
                    agen.__anext__(), timeout=self.timeout_s)
                if isinstance(item, dict):
                    final = item["final"]
                    if item.get("error"):
                        # in-band failure from the service worker (the
                        # stream is the only channel once deltas went
                        # out); mirror the non-streaming error contract
                        yield LLMResult(final, time.time() - start, False)
                        return
                    break
                yield item
            yield LLMResult(final, time.time() - start, True)
        except StopAsyncIteration:
            yield LLMResult(final, time.time() - start, True)
        except asyncio.TimeoutError:
            logger.warning("LLM generation timed out")
            yield LLMResult("Error generation timed out.", -1.0, False)
        except Exception as e:
            logger.error("Error generating LLM message: %s", e)
            yield LLMResult(f"Error generating response: {e}",
                            time.time() - start, False)

    async def _dispatch(self, model: str, messages) -> str:
        if self.backend == "jax":
            return await self.service.chat(messages)
        if self.backend == "echo":
            if self.delay_s:
                await asyncio.sleep(self.delay_s)
            # Canned answer that parses under both answer checkers
            # (benchmark.py:39-97): MIRAGE json answer_choice and MMLU
            # "The best answer is X".
            return (
                '{"step_by_step_thinking": "synthetic", '
                '"answer_choice": "A"}\nThe best answer is A'
            )
        model_info = LLM_MODELS[model]
        import aiohttp

        if self.backend == "ollama":
            import os

            host = (self.endpoint
                    or os.environ.get("OLLAMA_HOST")
                    or "http://127.0.0.1:11434")
            if not host.startswith("http"):
                host = f"http://{host}"
            async with aiohttp.ClientSession() as client:
                async with client.post(
                    f"{host.rstrip('/')}/api/chat",
                    json={
                        "model": model_info["ollama_name"],
                        "messages": messages,
                        "stream": False,
                        "options": {
                            "num_predict": model_info["max_tokens"]},
                    },
                ) as r:
                    r.raise_for_status()
                    data = await r.json()
                    return data["message"]["content"]
        # openai-compatible endpoint
        async with aiohttp.ClientSession() as client:
            async with client.post(
                f"{self.endpoint}/v1/chat/completions",
                json={"model": model_info["hf_name"], "messages": messages,
                      "max_tokens": model_info["max_tokens"]},
            ) as r:
                data = await r.json()
                return data["choices"][0]["message"]["content"]
