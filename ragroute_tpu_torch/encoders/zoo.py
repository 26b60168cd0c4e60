"""EncoderZoo: load and run the query encoders of a world.

Port of :mod:`ragroute_tpu.encoders.zoo`. The load order of one encoder:

1. **The port's forward** on the engine's device: the checkpoint found
   locally (:func:`ragroute_tpu_torch.encoders.checkpoint.resolve`) is read
   by the port's own reader, its tokenizer by the port's own tokenizers,
   and the family's forward (BERT / XLM-R, MPNet, GPT-J, T5; chosen by the
   checkpoint's ``model_type``) runs in the serving dtype
   (``config.ENCODER_COMPUTE_DTYPE``, bf16 unless
   ``RAGROUTE_ENCODER_DTYPE=float32``).
2. **Hash embeddings**, only when no checkpoint exists: the JAX package's
   offline semantics, logged and shown in :attr:`EncoderZoo.backends`.

A checkpoint that is found but fails to load, or fails its first forward on
the device, raises: it never falls back to hash or to the host CPU. The JAX
package's sentence-transformers / transformers fallbacks (``TorchEncoder``
and the HF wrappers of ``custom.py``) have no counterpart: the port's own
forward does their work for every family.
"""

from __future__ import annotations

import hashlib
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from ragroute_tpu_torch import config as _config
from ragroute_tpu_torch.config import WorldConfig
from ragroute_tpu_torch.encoders import bert as _bert
from ragroute_tpu_torch.encoders import checkpoint as _ckpt
from ragroute_tpu_torch.encoders import gptj as _gptj
from ragroute_tpu_torch.encoders import layers as _layers
from ragroute_tpu_torch.encoders import mpnet as _mpnet
from ragroute_tpu_torch.encoders import t5 as _t5
from ragroute_tpu_torch.encoders.custom import (InstructorEncoder,
                                                SGPTEncoder, backend_of,
                                                normalized, run_forward)
from ragroute_tpu_torch.encoders.registry import ENCODER_SPECS, EncoderSpec
from ragroute_tpu_torch.encoders.tokenize import load_tokenizer

logger = logging.getLogger("encoders")


class HashEncoder:
    """Deterministic stand-in when no weights are available."""

    backend = "hash"

    def __init__(self, spec: EncoderSpec):
        self.spec = spec

    def encode(self, texts: List[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.spec.dim), np.float32)
        for i, t in enumerate(texts):
            seed = int.from_bytes(
                hashlib.sha256(f"{self.spec.name}::{t}".encode())
                .digest()[:8], "little")
            rng = np.random.default_rng(seed)
            out[i] = rng.standard_normal(self.spec.dim).astype(np.float32)
        if self.spec.normalize:
            out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True),
                              1e-12)
        return out

    def encode_corpus(self, texts: List[str]) -> np.ndarray:
        # doc-side formatting salted in so query/passage spaces differ
        # exactly when the real prefixes differ
        return self.encode([self.spec.format_passage(t) for t in texts])


class TextEncoder:
    """A BERT / XLM-R or MPNet encoder with its spec's pooling, prefixes and
    normalization (the JAX package's ``JaxBertEncoder`` /
    ``JaxMPNetEncoder``). Batches pad to their longest row, not to
    ``max_length``: masked keys add nothing to any attention."""

    def __init__(self, spec: EncoderSpec, model, tokenizer):
        self.spec = spec
        self.model = model
        self.tokenizer = tokenizer
        self.backend = backend_of(model)

    def _run(self, texts: List[str]) -> np.ndarray:
        batch = self.tokenizer(texts, return_tensors="np", padding=True,
                               truncation=True,
                               max_length=self.spec.max_length)
        with torch.inference_mode():
            outs, mask = run_forward(self.model, batch["input_ids"],
                                     batch["attention_mask"],
                                     batch.get("token_type_ids"))
            # pool + normalize in f32 whatever the weights' dtype (the
            # embedding feeds the scoring/routing paths, which are f32)
            emb = normalized(_bert.pool(outs, mask, self.spec.pooling),
                             self.spec.normalize)
            return emb.cpu().numpy().astype(np.float32)

    def encode(self, texts: List[str]) -> np.ndarray:
        return self._run([self.spec.format_query(t) for t in texts])

    def encode_corpus(self, texts: List[str]) -> np.ndarray:
        """Doc-side encode (E5 "passage: " prefix, raw for the rest —
        custom_models.py:47-53,113-116)."""
        return self._run([self.spec.format_passage(t) for t in texts])


def _serving_cast(model):
    """Cast a loaded f32 encoder's projections and tables to the serving
    dtype (``config.ENCODER_COMPUTE_DTYPE``, bf16 by default); norms,
    pooling and normalization stay f32."""
    name = _config.ENCODER_COMPUTE_DTYPE
    if name in ("float32", "f32"):
        return model
    return _layers.cast_(model, getattr(torch, name))


# model_type of config.json -> (family module, encoder kind)
MODEL_TYPES = {"bert": (_bert, "text"), "xlm-roberta": (_bert, "text"),
               "mpnet": (_mpnet, "text"), "gptj": (_gptj, "sgpt"),
               "t5": (_t5, "instructor")}


def encoder_from_model(spec: EncoderSpec, model, tokenizer, kind: str,
                       dense=None):
    """The spec's encoder class around a built model."""
    if kind == "sgpt":
        return SGPTEncoder(spec, model, tokenizer)
    if kind == "instructor":
        return InstructorEncoder(spec, model, tokenizer, dense=dense)
    return TextEncoder(spec, model, tokenizer)


def load_checkpoint_encoder(spec: EncoderSpec, path: str, device):
    """The spec's encoder from the checkpoint directory ``path``, on
    ``device``, in the serving dtype; raises on any failure."""
    conf = _ckpt.read_config(path)
    model_type = conf.get("model_type")
    if model_type not in MODEL_TYPES:
        raise ValueError(f"{spec.name}: {path} holds a {model_type!r} "
                         f"model, which the port has no forward for")
    fam, kind = MODEL_TYPES[model_type]
    cfg = fam.config_from_hf(conf)
    state = fam.params_from_state_dict(_ckpt.load_state_dict(path), cfg)
    model = _serving_cast(fam.from_state(cfg, state)).to(device)
    tok = load_tokenizer(path, model_type)
    dense = (_ckpt.find_instructor_dense(path) if kind == "instructor"
             else None)
    enc = encoder_from_model(spec, model, tok, kind, dense)
    enc.encode(["warm-up query"])       # fails here, not at serve time
    return enc


def load_encoder(spec: EncoderSpec, prefer: str = "torch", device=None):
    """Load ONE encoder: the port's forward on ``device`` (default the
    card) when a checkpoint exists locally, else hash embeddings. Shared by
    the zoo and the corpus-ingest path."""
    if prefer == "hash":
        return HashEncoder(spec)
    path = _ckpt.resolve(spec.hf_name)
    if path is None:
        logger.warning(
            "no checkpoint for %s in the local caches; using hash "
            "embeddings (retrieval quality is meaningless for this "
            "encoder)", spec.name)
        return HashEncoder(spec)
    from ragroute_tpu_torch.utils.precision import resolve_device

    return load_checkpoint_encoder(spec, path,
                                   resolve_device(device or "cuda"))


def encode_corpus_batched(enc, texts, batch_size: int = 32) -> np.ndarray:
    """Doc-side encode in batches with whatever corpus semantics the
    encoder carries (falls back to query-side encode for encoders with
    no doc/query asymmetry). Shared by EncoderZoo.encode_corpus and the
    raw-jsonl ingest path."""
    fn = getattr(enc, "encode_corpus", enc.encode)
    outs = [fn(texts[i:i + batch_size])
            for i in range(0, len(texts), batch_size)]
    return np.concatenate(outs, axis=0)


def resolve_spec(enc_name: str, dim: int = 768) -> EncoderSpec:
    """Registry spec for a name, or a synthesized mean-pool default."""
    spec = ENCODER_SPECS.get(enc_name)
    if spec is None:
        spec = EncoderSpec(enc_name, "unknown", enc_name, dim,
                           "mean", False)
    return spec


class EncoderZoo:
    """All distinct encoders of a world, each on the best backend there is
    (``encoders``: a name -> encoder map that stands in for loading, e.g.
    models the caller already holds on the card)."""

    def __init__(self, world: WorldConfig, *, prefer: str = "torch",
                 device=None, encoders: Optional[Dict[str, object]] = None):
        self.world = world
        self.encoders: Dict[str, object] = {}
        self.backends: Dict[str, str] = {}
        for enc_name in world.encoders:
            if encoders is not None:
                enc = encoders[enc_name]
            else:
                dim = next(s.embed_dim for s in world.sources
                           if s.encoder == enc_name)
                enc = load_encoder(resolve_spec(enc_name, dim), prefer,
                                   device)
            self.encoders[enc_name] = enc
            self.backends[enc_name] = enc.backend
        logger.info("encoder backends: %s", self.backends)

    def encode_query(self, text: str) -> Dict[str, np.ndarray]:
        """One query through every encoder (reference router.py:285-303)."""
        return {name: enc.encode([text])[0]
                for name, enc in self.encoders.items()}

    def encode_queries(self, texts: List[str]) -> Dict[str, np.ndarray]:
        return {name: enc.encode(texts)
                for name, enc in self.encoders.items()}

    def encode_corpus(self, enc_name: str, texts: List[str],
                      batch_size: int = 32) -> np.ndarray:
        """Doc-side encode with one named encoder (ingest path): E5
        "passage: " prefixes, SGPT brace brackets, instructor corpus-side
        instructions — each encoder class carries its own doc semantics
        (reference ``custom_models.py`` encode_corpus methods)."""
        return encode_corpus_batched(self.encoders[enc_name], texts,
                                     batch_size)
