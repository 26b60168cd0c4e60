"""Registry decoder shapes and random quantized weights at those shapes.

Own copy of the Qwen3 shapes in the JAX package's ``scripts/bench_llm.py``
(``config.LLM_MODELS``; widths from the HF configs the reference serves
through Ollama), which the kernel checks and the smoke run use, and
:func:`quantized_from_masters`: random weights made the serving path's way,
seeded masters on the device through :func:`quantize_decoder_params`.
"""

from __future__ import annotations

import torch

from ragroute_tpu_torch.llm.model import (Decoder, DecoderConfig,
                                          init_decoder_params, make_generator,
                                          quantize_decoder_params)

QWEN3_06B = DecoderConfig(
    vocab_size=151936, hidden_size=1024, num_layers=28, num_heads=16,
    num_kv_heads=8, head_dim=128, intermediate_size=3072,
    rope_theta=1e6, qk_norm=True, tie_embeddings=True)
QWEN3_8B = DecoderConfig(
    vocab_size=151936, hidden_size=4096, num_layers=36, num_heads=32,
    num_kv_heads=8, head_dim=128, intermediate_size=12288,
    rope_theta=1e6, qk_norm=True, tie_embeddings=False)


def quantized_from_masters(cfg: DecoderConfig, bits: int, device,
                           seed: int = 0, dtype=torch.bfloat16) -> Decoder:
    """Random weights the way a checkpoint is served: masters drawn on
    ``device`` from a seeded generator (``init_decoder_params``, in
    ``dtype``), quantized there by ``quantize_decoder_params`` and then
    freed, so only the quantized decoder stays."""
    masters = init_decoder_params(make_generator(device, seed), cfg,
                                  dtype=dtype, device=device)
    params = quantize_decoder_params(masters, cfg, bits=bits)
    del masters
    return params
