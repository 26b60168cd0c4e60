"""On-card LLM generation (llama-family decoder + batched services)."""

from ragroute_tpu_torch.llm.model import (  # noqa: F401
    DecoderConfig, config_from_hf, decode_step, generate, init_cache,
    init_decoder_params, params_from_jax, params_from_torch_causal_lm,
    prefill,
)
from ragroute_tpu_torch.llm.service import (  # noqa: F401
    ByteTokenizer, GenerationService, demo_service,
)
from ragroute_tpu_torch.llm.continuous import (  # noqa: F401
    ContinuousGenerationService, demo_continuous_service,
)
