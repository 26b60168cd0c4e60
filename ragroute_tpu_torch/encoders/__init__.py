"""Query-encoder zoo: text -> embedding on the card.

Port of :mod:`ragroute_tpu.encoders`. The reference encodes queries with a
zoo of HF torch models (``ragroute/models/**``: MedCPT CLS pooling, DPR,
and the FeB4RAG zoo of AnglE / E5 / SGPT / Instructor / SBERT models). The
port runs each family with its own forward (BERT / XLM-R, MPNet, GPT-J, T5)
in bf16 on the engine's device, reads local checkpoints with its own reader
(:mod:`~ragroute_tpu_torch.encoders.checkpoint`) and tokenizes with its own
WordPiece and byte-level BPE (:mod:`~ragroute_tpu_torch.encoders.tokenize`);
without a checkpoint an encoder is a deterministic hash stub, flagged in
:attr:`EncoderZoo.backends`. Importing the package imports no
``transformers``.
"""

from ragroute_tpu_torch.encoders.registry import ENCODER_SPECS, EncoderSpec
from ragroute_tpu_torch.encoders.zoo import EncoderZoo

__all__ = ["EncoderZoo", "ENCODER_SPECS", "EncoderSpec"]
