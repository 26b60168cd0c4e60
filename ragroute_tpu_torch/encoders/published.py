"""The zoo's encoders at their published widths, with seeded random weights.

No checkpoint of the zoo is in the repository, and the card's machine has no
network, so the chip smoke and ``measure.py --encoders`` build every
registry encoder at its published width from a seed, on the card, in the
serving dtype; the vocabularies the port's tokenizers read are made in code
(XLM-R's and T5's as a SentencePiece unigram ``tokenizer.json`` written at
run time, :func:`write_unigram_checkpoint`).
Each architecture and shape is built once (:data:`SPEC_MODEL` maps the 13
registry specs onto :data:`MODELS`).

:func:`write_hub_checkpoint` lays a BERT out as a hub-cache checkpoint
(``config.json``, ``model.safetensors`` or ``pytorch_model.bin``,
``vocab.txt``) in ``transformers``' own key names, for the served path to
read through the port's reader.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ragroute_tpu_torch.encoders import bert as _bert
from ragroute_tpu_torch.encoders import checkpoint as _ckpt
from ragroute_tpu_torch.encoders import gptj as _gptj
from ragroute_tpu_torch.encoders import layers as L
from ragroute_tpu_torch.encoders import mpnet as _mpnet
from ragroute_tpu_torch.encoders import t5 as _t5
from ragroute_tpu_torch.encoders.registry import ENCODER_SPECS, EncoderSpec
from ragroute_tpu_torch.encoders.tokenize import (ByteLevelBPETokenizer,
                                                  WordPieceTokenizer,
                                                  bytes_to_unicode,
                                                  load_tokenizer)
from ragroute_tpu_torch.encoders.zoo import encoder_from_model


@dataclasses.dataclass(frozen=True)
class Published:
    family: str          # bert | mpnet | gptj | t5
    cfg: object
    source: str          # the public config.json the widths come from
    tokenizer: str       # wordpiece | mpnet | bpe | unigram
    dense_out: Optional[int] = None    # instructor's 2_Dense width


_HF = "https://huggingface.co/{}/blob/main/config.json"
MODELS: Dict[str, Published] = {
    "bert-base": Published(
        "bert", _bert.BertConfig(), _HF.format("ncbi/MedCPT-Query-Encoder"),
        "wordpiece"),
    "bert-large": Published(
        "bert", _bert.BertConfig(hidden_size=1024, num_layers=24,
                                 num_heads=16, intermediate_size=4096),
        _HF.format("intfloat/e5-large"), "wordpiece"),
    "xlm-r-large": Published(
        "bert", _bert.BertConfig(
            vocab_size=250002, hidden_size=1024, num_layers=24, num_heads=16,
            intermediate_size=4096, max_position_embeddings=514,
            type_vocab_size=1, model_type="xlm-roberta",
            layer_norm_eps=1e-5, pad_token_id=1),
        _HF.format("intfloat/multilingual-e5-large"), "unigram"),
    "mpnet-base": Published(
        "mpnet", _mpnet.MPNetConfig(),
        _HF.format("sentence-transformers/all-mpnet-base-v2"), "mpnet"),
    "gpt-j": Published(
        "gptj", _gptj.GPTJConfig(),
        _HF.format("Muennighoff/SGPT-5.8B-weightedmean-msmarco-specb-bitfit"),
        "bpe"),
    "t5-large-encoder": Published(
        "t5", _t5.T5Config(), _HF.format("hkunlp/instructor-large"),
        "unigram", dense_out=768),
}
SPEC_MODEL = {
    "ncbi/MedCPT-Query-Encoder": "bert-base",
    "facebook/dpr-question_encoder-single-nq-base": "bert-base",
    "e5-base": "bert-base", "gte-base": "bert-base",
    "ncbi/MedCPT-Article-Encoder": "bert-base",
    "facebook/dpr-ctx_encoder-single-nq-base": "bert-base",
    "e5-large": "bert-large", "UAE-Large-V1": "bert-large",
    "ember-v1": "bert-large",
    "multilingual-e5-large": "xlm-r-large",
    "all-mpnet-base-v2": "mpnet-base",
    "SGPT-5.8B-weightedmean-msmarco-specb-bitfit": "gpt-j",
    "instructor-large": "t5-large-encoder",
}
_CLASSES = {"bert": _bert.BertEncoder, "mpnet": _mpnet.MPNetEncoder,
            "gptj": _gptj.GPTJEncoder, "t5": _t5.T5Encoder}
KINDS = {"bert": "text", "mpnet": "text", "gptj": "sgpt", "t5": "instructor"}


def _std(family: str, cfg, name: str) -> float:
    """The initializer's spread of one parameter: ``transformers``' init
    (0.02 everywhere; T5's factor-scaled normals)."""
    if family != "t5":
        return 0.02
    leaf = name.split(".")[-2]
    d, kv, ff = cfg.hidden_size, cfg.head_dim, cfg.intermediate_size
    return {"embed": 1.0, "q": (d * kv) ** -0.5,
            "o": (cfg.num_heads * kv) ** -0.5,
            "wo": ff ** -0.5}.get(leaf, d ** -0.5)


def random_model(key: str, device, dtype=torch.bfloat16, seed: int = 0
                 ) -> nn.Module:
    """``MODELS[key]`` with seeded random weights, made on ``device`` in
    ``dtype`` (norms f32: ones and zeros)."""
    pub = MODELS[key]
    with torch.device("meta"):
        model = _CLASSES[pub.family](pub.cfg, dtype=dtype)
    model = model.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if isinstance(model.get_submodule(name.rsplit(".", 1)[0]),
                          (L.LayerNorm, L.RMSNorm)):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            else:
                p.normal_(0.0, _std(pub.family, pub.cfg, name),
                          generator=gen)
    return model.eval()


def random_dense(key: str, device, seed: int = 0):
    """The instructor's ``2_Dense`` (kernel ``[d_in, d_out]``, bias) from a
    seed, f32, or None."""
    pub = MODELS[key]
    if pub.dense_out is None:
        return None
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    d = pub.cfg.hidden_size
    w = torch.empty(d, pub.dense_out, device=device).normal_(
        0.0, d ** -0.5, generator=gen)
    b = torch.empty(pub.dense_out, device=device).normal_(0.0, 0.02,
                                                          generator=gen)
    return w, b


def n_params(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def forward_bytes(model: nn.Module, batch: int, seq: int) -> int:
    """Bytes one forward over ``[batch, seq]`` tokens must read: every
    weight but the tables once, and of each table the rows of its tokens
    (at most the table)."""
    total = 0
    for m in model.modules():
        if isinstance(m, nn.Embedding):
            w = m.weight
            total += min(batch * seq, w.shape[0]) * w.shape[1] * \
                w.element_size()
        else:
            total += sum(p.numel() * p.element_size()
                         for p in m.parameters(recurse=False))
    return total


def forward_flops(key: str, batch: int, seq: int) -> float:
    """Operations of one forward over ``[batch, seq]`` tokens: the
    projections (2 x their weights a token) and the attention products (4 x
    seq x inner width a token a layer); tables and norms are not counted."""
    pub = MODELS[key]
    c = pub.cfg
    if pub.family == "t5":
        inner = c.num_heads * c.head_dim
        per = (4 * c.hidden_size * inner
               + (3 if c.gated_act else 2) * c.hidden_size
               * c.intermediate_size)
    else:
        inner = c.hidden_size
        per = 4 * c.hidden_size ** 2 + 2 * c.hidden_size * c.intermediate_size
    tokens = batch * seq
    flops = c.num_layers * (2 * per * tokens + 4 * tokens * seq * inner)
    if pub.dense_out:
        flops += 2 * batch * c.hidden_size * pub.dense_out
    return float(flops)


# ---- vocabularies made in code -----------------------------------------------

def wordpiece_vocab(size: int, words: Sequence[str] = (),
                    kind: str = "bert") -> List[str]:
    """A ``vocab.txt`` of ``size`` entries: the specials where the models'
    own vocabularies keep them, the printable ASCII characters and their
    ``##`` pieces, ``words``, then filler pieces."""
    if kind == "mpnet":
        head = ["<s>", "<pad>", "</s>", "<unk>"]
    else:
        head = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
            "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    if kind == "mpnet":
        head += ["[UNK]", "<mask>"]
    chars = [chr(c) for c in range(33, 127)]
    vocab = head + chars + ["##" + c for c in chars if c.isalnum()]
    seen = set(vocab)
    for w in words:
        for piece in (w, "##" + w):
            if piece not in seen:
                vocab.append(piece)
                seen.add(piece)
    i = 0
    while len(vocab) < size:
        piece = f"##q{i}"
        i += 1
        if piece not in seen:
            vocab.append(piece)
            seen.add(piece)
    return vocab[:size]


def wordpiece_tokenizer(words: Sequence[str] = (), kind: str = "bert",
                        size: int = 30522) -> WordPieceTokenizer:
    vocab = wordpiece_vocab(size, words, kind)
    return WordPieceTokenizer({t: i for i, t in enumerate(vocab)}, kind=kind)


def bpe_tokenizer(words: Sequence[str] = ()) -> ByteLevelBPETokenizer:
    """GPT-2-style byte-level BPE: the 256 byte symbols, then one merge
    chain for each of ``words`` (with and without its leading space), so
    that each of them becomes one token."""
    chars = list(bytes_to_unicode().values())
    vocab = {c: i for i, c in enumerate(chars)}
    merges = []
    enc = bytes_to_unicode()
    for w in words:
        for form in (w, " " + w):
            sym = [enc[b] for b in form.encode()]
            cur = sym[0]
            for nxt in sym[1:]:
                pair = (cur, nxt)
                cur = cur + nxt
                if cur not in vocab:
                    vocab[cur] = len(vocab)
                    merges.append(pair)
    vocab["<|endoftext|>"] = len(vocab)
    return ByteLevelBPETokenizer(vocab, merges, specials=["<|endoftext|>"],
                                 unk_token="<|endoftext|>")


def write_unigram_checkpoint(path: str, kind: str, vocab_size: int,
                             words: Sequence[str] = ()) -> str:
    """A SentencePiece unigram ``tokenizer.json`` of ``vocab_size`` ids under
    ``path``, with the layout of ``kind``'s checkpoints: "xlm-roberta"
    (``<s>`` 0, ``<pad>`` 1, ``</s>`` 2, ``<unk>`` 3, ``<mask>`` last;
    ``<s> … </s>``) or "t5" (``<pad>`` 0, ``</s>`` 1, ``<unk>`` 2, 100
    ``<extra_id_*>`` last; ``… </s>``). Its pieces: ``▁``, every character
    of ``words`` and of the ASCII letters and digits (alone and after
    ``▁``), each word whole after ``▁`` (scored above its characters), then
    filler pieces up to the size."""
    os.makedirs(path, exist_ok=True)
    meta = "\u2581"
    if kind == "xlm-roberta":
        head = ["<s>", "<pad>", "</s>", "<unk>"]
        tail = ["<mask>"]
        unk, template = 3, [("<s>", 0), None, ("</s>", 2)]
    else:
        head = ["<pad>", "</s>", "<unk>"]
        tail = [f"<extra_id_{i}>" for i in range(99, -1, -1)]
        unk, template = 2, [None, ("</s>", 1)]
    chars = sorted(set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
                       "0123456789.,?!'-").union(*map(set, words)))
    pieces = [(meta, -2.0)]
    pieces += [(c, -8.0) for c in chars] + [(meta + c, -7.0) for c in chars]
    pieces += [(meta + w, -3.0) for w in sorted(set(words))]
    seen = {p for p, _ in pieces} | set(head) | set(tail)
    n_fill = vocab_size - len(head) - len(tail) - len(pieces)
    if n_fill < 0:
        raise ValueError(f"vocab_size {vocab_size} too small")
    i = 0
    while n_fill:
        piece = f"{meta}q{i}"
        i += 1
        if piece not in seen:
            pieces.append((piece, -20.0))
            n_fill -= 1
    vocab = [[t, 0.0] for t in head] + [list(p) for p in pieces] + \
        [[t, 0.0] for t in tail]
    single = [{"Sequence": {"id": "A", "type_id": 0}} if t is None else
              {"SpecialToken": {"id": t[0], "type_id": 0}} for t in template]
    spec = {
        "version": "1.0",
        "added_tokens": [{"id": vocab.index([t, 0.0]) if t in head
                          else len(vocab) - len(tail) + tail.index(t),
                          "content": t, "special": True, "normalized": False,
                          "single_word": False, "lstrip": False,
                          "rstrip": False} for t in head + tail],
        "normalizer": {"type": "Replace", "pattern": {"Regex": " {2,}"},
                       "content": " "},
        "pre_tokenizer": {"type": "Metaspace", "replacement": meta,
                          "prepend_scheme": "always", "split": True},
        "post_processor": {
            "type": "TemplateProcessing", "single": single, "pair": single,
            "special_tokens": {t[0]: {"id": t[0], "ids": [t[1]],
                                      "tokens": [t[0]]}
                               for t in template if t is not None}},
        "model": {"type": "Unigram", "unk_id": unk, "vocab": vocab,
                  "byte_fallback": False},
    }
    with open(os.path.join(path, "tokenizer.json"), "w",
              encoding="utf-8") as f:
        json.dump(spec, f, ensure_ascii=False)
    return path


def tokenizer_for(key: str, words: Sequence[str] = ()):
    pub = MODELS[key]
    if pub.tokenizer == "wordpiece":
        return wordpiece_tokenizer(words, "bert", pub.cfg.vocab_size)
    if pub.tokenizer == "mpnet":
        return wordpiece_tokenizer(words, "mpnet", pub.cfg.vocab_size)
    if pub.tokenizer == "bpe":
        return bpe_tokenizer(words)
    # SentencePiece unigram: a tokenizer.json written here, read back by
    # the port's own reader
    kind = "t5" if pub.family == "t5" else "xlm-roberta"
    with tempfile.TemporaryDirectory() as d:
        write_unigram_checkpoint(d, kind, pub.cfg.vocab_size, words)
        return load_tokenizer(d, kind)


def encoder(spec: EncoderSpec, model: nn.Module, tokenizer, dense=None):
    """The spec's encoder class around a published-width model."""
    key = SPEC_MODEL[spec.name]
    return encoder_from_model(spec, model, tokenizer,
                              KINDS[MODELS[key].family], dense)


def distinct_models() -> Dict[str, List[EncoderSpec]]:
    """The registry's specs grouped by the model they share, GPT-J last."""
    groups: Dict[str, List[EncoderSpec]] = {}
    for name, spec in ENCODER_SPECS.items():
        groups.setdefault(SPEC_MODEL[name], []).append(spec)
    return dict(sorted(groups.items(), key=lambda kv: kv[0] == "gpt-j"))


# ---- a BERT as a hub-cache checkpoint ----------------------------------------

def bert_hf_state(model: _bert.BertEncoder) -> Dict[str, torch.Tensor]:
    """A :class:`~ragroute_tpu_torch.encoders.bert.BertEncoder`'s weights
    under ``transformers``' ``BertModel`` key names (the inverse of
    :func:`~ragroute_tpu_torch.encoders.bert.params_from_state_dict`)."""
    ours = model.state_dict()
    out = {
        "embeddings.word_embeddings.weight": ours["embeddings.word.weight"],
        "embeddings.position_embeddings.weight": ours[
            "embeddings.position.weight"],
        "embeddings.token_type_embeddings.weight": ours[
            "embeddings.token_type.weight"],
        "embeddings.LayerNorm.weight": ours["embeddings.ln.weight"],
        "embeddings.LayerNorm.bias": ours["embeddings.ln.bias"],
    }
    for i in range(model.cfg.num_layers):
        for mine, theirs in _bert._LAYER_KEYS:
            for p in ("weight", "bias"):
                out[f"encoder.layer.{i}.{theirs}.{p}"] = ours[
                    f"layers.{i}.{mine}.{p}"]
    if model.pooler is not None:
        out["pooler.dense.weight"] = ours["pooler.weight"]
        out["pooler.dense.bias"] = ours["pooler.bias"]
    return {k: v.detach().float().cpu().contiguous() for k, v in out.items()}


def write_hub_checkpoint(cache: str, hf_name: str, model: _bert.BertEncoder,
                         vocab: Sequence[str], *, fmt: str = "safetensors",
                         revision: str = "main-smoke") -> str:
    """Lay ``model`` out under the hub cache ``cache`` as ``hf_name``'s
    ``refs/main`` snapshot (``fmt``: "safetensors" or "bin", f32 weights);
    returns the snapshot directory."""
    repo = _ckpt.hub_snapshot_dir(cache, hf_name)
    snap = os.path.join(repo, "snapshots", revision)
    os.makedirs(snap, exist_ok=True)
    os.makedirs(os.path.join(repo, "refs"), exist_ok=True)
    with open(os.path.join(repo, "refs", "main"), "w") as f:
        f.write(revision)
    c = model.cfg
    conf = {"model_type": c.model_type, "architectures": ["BertModel"],
            "vocab_size": c.vocab_size, "hidden_size": c.hidden_size,
            "num_hidden_layers": c.num_layers,
            "num_attention_heads": c.num_heads,
            "intermediate_size": c.intermediate_size,
            "max_position_embeddings": c.max_position_embeddings,
            "type_vocab_size": c.type_vocab_size,
            "layer_norm_eps": c.layer_norm_eps,
            "pad_token_id": c.pad_token_id, "hidden_act": "gelu"}
    with open(os.path.join(snap, "config.json"), "w") as f:
        json.dump(conf, f, indent=1)
    with open(os.path.join(snap, "vocab.txt"), "w", encoding="utf-8") as f:
        f.write("\n".join(vocab) + "\n")
    with open(os.path.join(snap, "tokenizer_config.json"), "w") as f:
        json.dump({"do_lower_case": True, "model_max_length": 512}, f)
    for stale in _ckpt.WEIGHT_FILES:
        if os.path.exists(os.path.join(snap, stale)):
            os.unlink(os.path.join(snap, stale))
    state = bert_hf_state(model)
    if fmt == "safetensors":
        _ckpt.write_safetensors(os.path.join(snap, "model.safetensors"), state)
    else:
        torch.save(state, os.path.join(snap, "pytorch_model.bin"))
    return snap
