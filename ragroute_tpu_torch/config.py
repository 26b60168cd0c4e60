"""Typed configuration for the federated search engine (the port's own
copy of the JAX package's ``config.py``: same names, same values).

This module carries every behavioral constant of the reference system
(``ragroute/config.py`` in sacs-epfl/ragroute) in a typed, relocatable form:

* dataset "worlds" (federated source lists, per-source query encoders,
  embedding pad lengths, retrieval ``k``): reference ``config.py:32-101``
* router decision thresholds (0.4924 medrag / 0.5 else): ``router.py:277-280``
* router MLP input dims (1540 / 8205 / 1546): ``router.py:32-34``
* random-routing subset sizes (2 of 4 / 9 of 13 / 2 of 10): ``router.py:229-235``
* LLM registry and prompt templates: ``config.py:103-172``
* simulation delays: ``config.py:26-29``

Unlike the reference (hardcoded NFS paths, ``config.py:16-24``), all data
roots are relocatable via ``RAGROUTE_DATA`` / explicit arguments, and the
whole config is a frozen dataclass so jitted code can close over it safely
(hashable static argument).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Mapping, Optional, Sequence, Tuple

# --------------------------------------------------------------------------
# Data roots (relocatable; reference hardcodes /mnt/nfs/... at config.py:16-24)
# --------------------------------------------------------------------------

DEFAULT_DATA_ROOT = os.environ.get(
    "RAGROUTE_DATA", os.path.join(os.path.expanduser("~"), ".ragroute_tpu_torch")
)


def data_root() -> str:
    """Return the active data root (checkpoints, shards, benchmark logs)."""
    return os.environ.get("RAGROUTE_DATA", DEFAULT_DATA_ROOT)


# --------------------------------------------------------------------------
# Host serving constants (reference config.py:3-13)
# --------------------------------------------------------------------------

HTTP_HOST = os.environ.get("RAGROUTE_HTTP_HOST", "127.0.0.1")
HTTP_PORT = int(os.environ.get("RAGROUTE_HTTP_PORT", "8000"))
MAX_QUEUE_SIZE = 100          # router queue bound, reference config.py:13
QUERY_TIMEOUT_S = 300.0       # reference http_server.py:160
LLM_TIMEOUT_S = 240.0         # reference http_server.py:317

# Simulation-mode stage delays in seconds (reference config.py:26-29). Tests
# override these to 0; the defaults mirror the reference for latency modeling.
ROUTER_DELAY = 1.0
DATA_SOURCE_DELAY = 2.0
LLM_DELAY = 1.0

# Micro-batcher defaults (new: the reference routes one query at a time
# through an asyncio queue, router.py:207-218; we batch onto the device).
BATCH_WINDOW_MS = 2.0         # max time to wait filling a device batch
BATCH_BUCKETS = (1, 8, 32, 128, 512)  # padded batch sizes to avoid recompiles
# Live-encoder serving (--embedder zoo): concurrent queries micro-batch
# through the encoder forwards too (one padded [B, L] forward per encoder
# instead of B size-1 forwards). Smaller buckets than the search step —
# encoder FLOPs per row are ~1000x a scoring row's.
EMBED_WINDOW_MS = 2.0
EMBED_BATCH_BUCKETS = (1, 8, 32)
# Compute dtype for the serving-path query encoders (bf16 weights;
# pooling/normalization stay f32). Set RAGROUTE_ENCODER_DTYPE=float32 for
# bit-level parity runs.
ENCODER_COMPUTE_DTYPE = os.environ.get(
    "RAGROUTE_ENCODER_DTYPE", "bfloat16")
# balanced-IVF approximate mode: clusters probed per query when nprobe
# is not given = max(1, C // IVF_NPROBE_DIVISOR) per shard
IVF_NPROBE_DIVISOR = 8
# impl="hybrid": use the IVF path only for small batches on large shards
# (the exhaustive scan with compaction serves the rest). The choice reads
# only the batch size and the shard's doc count, both known on the host.
# The hybrid branch defaults to a shallower probe than plain --impl ivf
# (C//32 vs C//8).
IVF_HYBRID_MAX_BATCH = 16
IVF_HYBRID_MIN_DOCS = 400_000
IVF_HYBRID_NPROBE_DIVISOR = 32

# Index layout constants (index/shard.py). Shards are padded to a
# multiple of this row count (the on-disk and cache layouts are shared
# with the JAX package); live updates scatter in fixed-width chunks.
SHARD_PAD_MULTIPLE = 512
UPDATE_CHUNK = 512

# Routing-aware batch compaction: a compacted sub-batch (B/2 or B/4)
# is only formed when it keeps at least this many rows.
COMPACTION_MIN_ROWS = 8

# impl="lowrank": two-stage exact-rescored retrieval (low-rank coarse scan
# + full-precision refine, index/lowrank.py). Candidate depth per query is
# k' = LOWRANK_REFINE_MULT * k; automatic rank selection keeps the
# smallest 128-multiple rank covering LOWRANK_ENERGY of the corpus
# spectrum (refusing shards whose spectrum is too flat to profit).
LOWRANK_REFINE_MULT = 4
LOWRANK_ENERGY = 0.99
# Rank granularity of the automatic rank selection.
LOWRANK_RANK_MULTIPLE = 128
# Above this fraction of the full dimension the coarse scan saves too
# little to pay for the refine stage; build_lowrank refuses (returns None).
LOWRANK_MAX_RANK_FRACTION = 0.5
# Row subsample cap for the second-moment estimate (the basis barely moves
# past ~100k rows; keeps the host-side X^T X pass bounded at any scale).
LOWRANK_MOMENT_SAMPLE_ROWS = 131072

# int4 packed shards: per-GROUP quantization scales (one f32 scale per
# INT4_GROUP_DIMS dims per doc) instead of one per doc. With only 15
# levels a single per-doc scale wastes resolution wherever magnitude
# varies along the vector (tests/test_recall_gate.py holds the recall
# floor) at a capacity cost of d/128 f32 scales per doc. The kernel
# dequantizes groups during the nibble unpack, before the product.
# Dims not divisible by the group size fall back to per-doc scales.
# Env override (RAGROUTE_INT4_GROUP_DIMS): 0 disables grouping (per-doc
# scales).
INT4_GROUP_DIMS = int(os.environ.get("RAGROUTE_INT4_GROUP_DIMS", "128")
                      ) or (1 << 30)

# Host-RAM capacity tiers (--impl stream / hostrefine):
# STREAM_HBM_BUDGET_GB bounds the device-resident bytes; the overflow
# lives in host RAM and is scanned in uploaded slabs (STREAM_SLAB_MB each,
# STREAM_PREFETCH in flight) or exact-rescored from host rows
# (HOSTREFINE_REFINE_MULT * k candidates).
STREAM_HBM_BUDGET_GB = float(os.environ.get("RAGROUTE_HBM_BUDGET_GB", "6.0"))
STREAM_SLAB_MB = int(os.environ.get("RAGROUTE_STREAM_SLAB_MB", "256"))
STREAM_PREFETCH = 2
HOSTREFINE_REFINE_MULT = 4
# Probed coarse scan of the hostrefine tier: opt-in (clustering triggers
# only when HOSTREFINE_CLUSTER_MIN_DOCS > 0 or cluster_coarse=True at
# build). KAPPA caps per-(query, cluster-tile) winners.
HOSTREFINE_CLUSTER_MIN_DOCS = int(
    os.environ.get("RAGROUTE_HOSTREFINE_CLUSTER_MIN_DOCS", "0"))
HOSTREFINE_NPROBE_DIVISOR = int(
    os.environ.get("RAGROUTE_HOSTREFINE_NPROBE_DIVISOR", "8"))
HOSTREFINE_KAPPA = int(os.environ.get("RAGROUTE_HOSTREFINE_KAPPA", "8"))

# Store-dtype policy (--dtype policy): per shard (dtype_name, use_lowrank).
#   * low-dim (<= 1024) dot/l2 shards: int8;
#   * high-dim (> 1024) cos shards: int4 + lowrank (coarse-authoritative
#     ordering);
#   * elsewhere: bfloat16; capacity=True picks int4 everywhere.
def store_dtype_policy(embed_dim: int, score_mode: str,
                       *, capacity: bool = False):
    if capacity:
        return ("int4", embed_dim > 1024 or score_mode == "cos")
    if embed_dim > 1024 and score_mode == "cos":
        return ("int4", True)
    if embed_dim <= 1024 and score_mode in ("dot", "l2"):
        return ("int8", False)
    return ("bfloat16", False)


# Doc-side encoders that built the reference indexes upstream (query-side
# zoo encoders differ for these worlds; feb4rag indexes were built with
# each source's own zoo encoder). Used by the corpus-ingest path
# (scripts/import_real_data.py --encode-from-jsonl).
DOC_SIDE_ENCODER = {
    "medrag": "ncbi/MedCPT-Article-Encoder",
    "wikipedia": "facebook/dpr-ctx_encoder-single-nq-base",
}


# --------------------------------------------------------------------------
# Score semantics
# --------------------------------------------------------------------------

# How a shard's document embeddings are scored against a query embedding and
# how scores order (reference: FAISS index types per dataset, see
# data_source.py:165-215 and rerank.py:3-34).
#   "dot":   inner product, higher is better (medrag MedCPT, feb4rag dot models)
#   "cos":   cosine = dot over L2-normalized vectors, higher is better
#            (feb4rag cos_sim models, model_zoo.py:25-32)
#   "l2":    squared L2 distance, LOWER is better (wikipedia: L2-normalized
#            index searched with normalized queries, data_source.py:196-205,
#            merged ascending at rerank.py:28-34)
SCORE_MODES = ("dot", "cos", "l2")


@dataclasses.dataclass(frozen=True)
class SourceSpec:
    """One federated data source (corpus shard)."""

    name: str
    encoder: str                 # query-encoder model name for this corpus
    encoder_kind: Optional[str]  # None | "custom" | "beir" (feb4rag zoo split)
    embed_dim: int               # native embedding dim of this corpus
    score_mode: str = "dot"


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    """A federated dataset 'world' (reference --dataset choices, main.py:14)."""

    name: str
    sources: Tuple[SourceSpec, ...]
    embed_pad_len: int            # EMBEDDING_MAX_LENGTH, config.py:92-96
    k: int                        # retrieval top-k, config.py:97-101
    router_input_dim: int         # router.py:32-34
    router_threshold: float       # router.py:277-280
    random_subset: int            # router.py:229-235
    source_to_id: Mapping[str, int]  # one-hot ids, config.py:72-90
    uses_scaler: bool             # StandardScaler applied (medrag/wikipedia
    #                               only, router.py:269-270)

    @property
    def num_sources(self) -> int:
        return len(self.sources)

    @property
    def source_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.sources)

    def source(self, name: str) -> SourceSpec:
        for s in self.sources:
            if s.name == name:
                return s
        raise KeyError(name)

    @property
    def encoders(self) -> Tuple[str, ...]:
        """Distinct encoder names, in first-use order (router.py:73-75)."""
        seen = []
        for s in self.sources:
            if s.encoder not in seen:
                seen.append(s.encoder)
        return tuple(seen)

    def onehot_id(self, name: str) -> int:
        return self.source_to_id[name]


# --------------------------------------------------------------------------
# The three worlds (reference config.py:32-101)
# --------------------------------------------------------------------------

def _medrag_world() -> WorldConfig:
    names = ("pubmed", "statpearls", "textbooks", "wikipedia")
    sources = tuple(
        SourceSpec(n, "ncbi/MedCPT-Query-Encoder", None, 768, "dot")
        for n in names
    )
    return WorldConfig(
        name="medrag",
        sources=sources,
        embed_pad_len=768,
        k=32,
        router_input_dim=1540,    # 768 q + 768 centroid + 4 one-hot
        router_threshold=0.4924,  # ROC-optimal threshold, router.py:278
        random_subset=2,
        source_to_id={"pubmed": 0, "statpearls": 1, "textbooks": 2, "wikipedia": 3},
        uses_scaler=True,
    )


# feb4rag encoder registry: (encoder name, kind, native dim, score mode).
# Source order follows reference config.py:34; one-hot ids follow the
# alphabetical FEB4RAG_SOURCE_TO_ID map (config.py:72-86) — these DIFFER,
# which the router feature code must respect.
# Dims: e5-large/multilingual-e5-large 1024, e5-base 768,
# SGPT-5.8B 4096, UAE-Large-V1 1024, all-mpnet-base-v2 768, ember-v1 1024,
# gte-base 768. Score functions from model_zoo.py:25-32,81-87.
_FEB4RAG_SOURCES: Tuple[Tuple[str, str, Optional[str], int, str], ...] = (
    ("msmarco", "e5-large", "custom", 1024, "cos"),
    ("trec-covid", "SGPT-5.8B-weightedmean-msmarco-specb-bitfit", "custom", 4096, "cos"),
    ("nfcorpus", "UAE-Large-V1", "custom", 1024, "cos"),
    ("scidocs", "all-mpnet-base-v2", "beir", 768, "dot"),
    ("nq", "multilingual-e5-large", "custom", 1024, "cos"),
    ("hotpotqa", "ember-v1", "beir", 1024, "cos"),
    ("fiqa", "all-mpnet-base-v2", "beir", 768, "dot"),
    ("arguana", "UAE-Large-V1", "custom", 1024, "cos"),
    ("webis-touche2020", "e5-base", "custom", 768, "cos"),
    ("dbpedia-entity", "UAE-Large-V1", "custom", 1024, "cos"),
    ("fever", "UAE-Large-V1", "custom", 1024, "cos"),
    ("climate-fever", "UAE-Large-V1", "custom", 1024, "cos"),
    ("scifact", "gte-base", "beir", 768, "dot"),
)


def _feb4rag_world() -> WorldConfig:
    sources = tuple(
        SourceSpec(n, enc, kind, dim, mode)
        for (n, enc, kind, dim, mode) in _FEB4RAG_SOURCES
    )
    source_to_id = {
        "arguana": 0, "climate-fever": 1, "dbpedia-entity": 2, "fever": 3,
        "fiqa": 4, "hotpotqa": 5, "msmarco": 6, "nfcorpus": 7, "nq": 8,
        "scidocs": 9, "scifact": 10, "trec-covid": 11, "webis-touche2020": 12,
    }
    return WorldConfig(
        name="feb4rag",
        sources=sources,
        embed_pad_len=4096,
        k=10,
        router_input_dim=8205,    # 4096 q + 4096 centroid + 13 one-hot
        router_threshold=0.5,
        random_subset=9,
        source_to_id=source_to_id,
        uses_scaler=False,
    )


def _wikipedia_world() -> WorldConfig:
    names = tuple(str(i) for i in range(10))
    sources = tuple(
        SourceSpec(n, "facebook/dpr-question_encoder-single-nq-base", None, 768, "l2")
        for n in names
    )
    return WorldConfig(
        name="wikipedia",
        sources=sources,
        embed_pad_len=768,
        k=10,
        router_input_dim=1546,    # 768 q + 768 centroid + 10 one-hot
        router_threshold=0.5,
        random_subset=2,
        source_to_id={n: int(n) for n in names},
        uses_scaler=True,
    )


WORLDS: Dict[str, WorldConfig] = {
    "medrag": _medrag_world(),
    "feb4rag": _feb4rag_world(),
    "wikipedia": _wikipedia_world(),
}

ROUTING_STRATEGIES = ("ragroute", "all", "random", "none")  # main.py:15


def get_world(name: str) -> WorldConfig:
    try:
        return WORLDS[name]
    except KeyError:
        raise ValueError(
            f"Unknown dataset world {name!r}; expected one of {sorted(WORLDS)}"
        ) from None


# --------------------------------------------------------------------------
# LLM registry + prompts (reference config.py:103-172)
# --------------------------------------------------------------------------

SUPPORTED_MODELS = ("llama3.1-8B-instruct", "qwen3-8B", "qwen3-0.6B")

LLM_MODELS: Dict[str, Dict[str, object]] = {
    "llama3.1-8B-instruct": {
        "docs_context_length": 128000,
        "max_tokens": 131072,
        "hf_name": "meta-llama/Meta-Llama-3.1-8B-Instruct",
        "ollama_name": "llama3.1_extended",
    },
    "qwen3-8B": {
        "docs_context_length": 38000,
        "max_tokens": 40960,
        "hf_name": "Qwen/Qwen3-8B",
        "ollama_name": "qwen3:8b",
    },
    "qwen3-0.6B": {
        "docs_context_length": 38000,
        "max_tokens": 40960,
        "hf_name": "Qwen/Qwen3-0.6B",
        "ollama_name": "qwen3:0.6b",
    },
}

SYSTEM_PROMPTS: Dict[str, str] = {
    "medrag": (
        "You are a helpful medical expert, and your task is to answer a "
        "multi-choice medical question using the relevant documents.\n"
        "Please first think step-by-step and then choose the answer from the "
        "provided options.\n"
        "Organize your output in a json formatted as Dict{\"step_by_step_thinking\": "
        "Str(explanation), \"answer_choice\": Str{A/B/C/...}}.\n"
        "Your responses will be used for research purposes only, so please "
        "have a definite answer."
    ),
    "feb4rag": (
        "You are a helpful assistant helping to answer user requests based on "
        "the provided search result.\n"
        "Your responses should directly address the user's request and must be "
        "based on the information obtained from the provided search results.\n"
        "You are forbidden to create new information that is not supported by "
        "these results.\n"
        "You must attribute your response to the source from the search "
        "results by including citations, for example, [1]."
    ),
    "wikipedia": (
        "You are an assistant for answering multiple-choice questions. Below "
        "are relevant parts of documents retrieved for the question. \n"
        "Use the provided context to choose the correct answer. If the context "
        "does not help, use the question and options alone. \n"
        "Your response should be a single letter: A, B, C, or D. Only output "
        "one letter."
    ),
}

USER_PROMPT_TEMPLATES: Dict[str, str] = {
    "medrag": (
        "Here are the relevant documents:\n{{context}}\n\n"
        "Here is the question:\n{{question}}\n\n"
        "Here are the potential choices:\n{{options}}\n\n"
        "Please think step-by-step and generate your output in json formatted "
        "as Dict{\"step_by_step_thinking\": Str(explanation), \"answer_choice\": "
        "Str{A/B/C/...}}:"
    ),
    "feb4rag": (
        "Here are the search results:\n{{context}}\n\n"
        "Here is the question:\n{{question}}"
    ),
    "wikipedia": (
        "Given the following context, question, and four candidate answers "
        "(A, B, C, and D), choose the best answer.\n\n"
        "Context:\n{{context}}\n\n"
        "Question: {{question}}\n"
        "A. {{options[0]}}\n"
        "B. {{options[1]}}\n"
        "C. {{options[2]}}\n"
        "D. {{options[3]}}\n\n"
        "Your response should be in the format: \"The best answer is "
        "[letter]\".\nDo not include any additional explanation or "
        "justification.\nOnly output one letter: A, B, C, or D.\n\n"
        "The best answer is"
    ),
}
