"""Per-encoder behavioral specs (the port's own copy of
``ragroute_tpu/encoders/registry.py``, held equal to it by
``tests/test_torch_vendored.py``).

Everything the reference encodes in wrapper-class code
(``ragroute/models/feb4rag/model_zoo.py:12-118``,
``custom_models.py:19-274``, ``custom_sentence_transformer.py:9-14``)
becomes data: architecture family, pooling mode, L2 normalization, query
prefix/instruction, native dim, HF checkpoint name.

Query-side behaviors replicated:

* MedCPT-Query-Encoder — BERT, forced CLS pooling
  (custom_sentence_transformer.py:9-14), no normalization.
* DPR question encoder — BERT, pooler_output == CLS hidden
  (reference uses ``model(**inputs).pooler_output``, router.py:300-302).
* e5-base / e5-large / multilingual-e5-large — "query: " prefix, mean
  pooling, L2 normalize (custom_models.py:89-152).
* UAE-Large-V1 (AnglE) — CLS pooling, L2 normalize, retrieval prompt
  (custom_models.py:19-86).
* all-mpnet-base-v2 — MPNet arch: mean pooling, normalize (BEIR
  SentenceBERT path, model_zoo.py:58-118); the port's forward in
  :mod:`ragroute_tpu_torch.encoders.mpnet`.
* ember-v1 / gte-base — BERT SentenceBERT: mean pooling (gte), cls
  (ember), normalize.
* SGPT-5.8B — GPT-family, weighted-mean pooling with the [SOS]/{SOS}
  bracket-token scheme (custom_models.py:183-229): the port's GPT-J
  forward (:mod:`ragroute_tpu_torch.encoders.gptj`) via SGPTEncoder;
  scheme in :mod:`ragroute_tpu_torch.encoders.custom`.
* INSTRUCTOR — T5-encoder with instruction-masked mean pooling and the
  per-(model, dataset, side) instruction table
  (instructor/instructor_model.py:223-386): the port's T5 encoder
  (:mod:`ragroute_tpu_torch.encoders.t5`) via InstructorEncoder; pooling in
  :mod:`ragroute_tpu_torch.encoders.custom`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# AnglE UAE retrieval prompt (custom_models.py Prompts.C equivalent).
# NOTE: no separator after the colon — the reference concatenates the
# instruction and query directly ('...passages:' + q).
ANGLE_QUERY_PROMPT = (
    "Represent this sentence for searching relevant passages:{text}"
)


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    name: str
    family: str                   # "bert" | "mpnet" | "gpt" | "t5"
    hf_name: str
    dim: int
    pooling: str                  # cls | pooler | mean | weightedmean
    normalize: bool
    query_prefix: str = ""        # prepended to query text
    query_template: Optional[str] = None  # full template with {text}
    max_length: int = 512
    passage_prefix: str = ""      # prepended to corpus/doc text (E5
    #                               "passage: ", custom_models.py:113-116;
    #                               AnglE/BEIR docs encode raw, :47-53)

    def format_query(self, text: str) -> str:
        if self.query_template:
            return self.query_template.format(text=text)
        return self.query_prefix + text

    def format_passage(self, text: str) -> str:
        return self.passage_prefix + text


ENCODER_SPECS: Dict[str, EncoderSpec] = {
    "ncbi/MedCPT-Query-Encoder": EncoderSpec(
        name="ncbi/MedCPT-Query-Encoder", family="bert",
        hf_name="ncbi/MedCPT-Query-Encoder", dim=768,
        pooling="cls", normalize=False, max_length=64),
    "facebook/dpr-question_encoder-single-nq-base": EncoderSpec(
        name="facebook/dpr-question_encoder-single-nq-base", family="bert",
        hf_name="facebook/dpr-question_encoder-single-nq-base", dim=768,
        pooling="pooler", normalize=False),
    "e5-base": EncoderSpec(
        name="e5-base", family="bert",
        hf_name="intfloat/e5-base", dim=768,
        pooling="mean", normalize=True, query_prefix="query: ",
        passage_prefix="passage: "),
    "e5-large": EncoderSpec(
        name="e5-large", family="bert",
        hf_name="intfloat/e5-large", dim=1024,
        pooling="mean", normalize=True, query_prefix="query: ",
        passage_prefix="passage: "),
    "multilingual-e5-large": EncoderSpec(
        name="multilingual-e5-large", family="bert",
        hf_name="intfloat/multilingual-e5-large", dim=1024,
        pooling="mean", normalize=True, query_prefix="query: ",
        passage_prefix="passage: "),
    "UAE-Large-V1": EncoderSpec(
        name="UAE-Large-V1", family="bert",
        hf_name="WhereIsAI/UAE-Large-V1", dim=1024,
        pooling="cls", normalize=True,
        query_template=ANGLE_QUERY_PROMPT),
    "ember-v1": EncoderSpec(
        name="ember-v1", family="bert",
        hf_name="llmrails/ember-v1", dim=1024,
        pooling="cls", normalize=True),
    "gte-base": EncoderSpec(
        name="gte-base", family="bert",
        hf_name="thenlper/gte-base", dim=768,
        pooling="mean", normalize=True),
    "all-mpnet-base-v2": EncoderSpec(
        name="all-mpnet-base-v2", family="mpnet",
        hf_name="sentence-transformers/all-mpnet-base-v2", dim=768,
        pooling="mean", normalize=True),
    "SGPT-5.8B-weightedmean-msmarco-specb-bitfit": EncoderSpec(
        name="SGPT-5.8B-weightedmean-msmarco-specb-bitfit", family="gpt",
        hf_name="Muennighoff/SGPT-5.8B-weightedmean-msmarco-specb-bitfit",
        dim=4096, pooling="weightedmean", normalize=False),
    "instructor-large": EncoderSpec(
        name="instructor-large", family="t5",
        hf_name="hkunlp/instructor-large", dim=768,
        pooling="mean", normalize=True),
    # Doc-side (article/context) encoders for corpus ingest — the models
    # that built the reference's indexes upstream (MedRAG corpora:
    # MedCPT-Article-Encoder; wikipedia clusters: DPR context encoder).
    "ncbi/MedCPT-Article-Encoder": EncoderSpec(
        name="ncbi/MedCPT-Article-Encoder", family="bert",
        hf_name="ncbi/MedCPT-Article-Encoder", dim=768,
        pooling="cls", normalize=False, max_length=512),
    "facebook/dpr-ctx_encoder-single-nq-base": EncoderSpec(
        name="facebook/dpr-ctx_encoder-single-nq-base", family="bert",
        hf_name="facebook/dpr-ctx_encoder-single-nq-base", dim=768,
        pooling="pooler", normalize=False),
}
