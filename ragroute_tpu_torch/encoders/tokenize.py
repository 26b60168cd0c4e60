"""The port's own tokenizers, for a machine without ``transformers``.

The JAX package tokenizes with ``AutoTokenizer``. The card's machine has no
``transformers``, ``tokenizers`` or ``sentencepiece``, so the port reads the
vocabulary files itself and offers the call surface the encoders use:
``__call__(texts, padding="max_length" | True, truncation, max_length,
return_tensors="np")``, ``encode(text, add_special_tokens=False, ...)`` and
``pad_token_id``.

* :class:`WordPieceTokenizer` from ``vocab.txt``: BERT's basic tokenizer
  (control characters dropped, CJK characters split out, lower-casing and
  accent stripping by ``do_lower_case`` / ``strip_accents``, splits on
  punctuation) and then greedy longest-match WordPiece with ``##``
  continuations. BERT's specials (``[CLS] x [SEP]``, token types) or
  MPNet's (``<s> x </s>``, no token types).
* :class:`ByteLevelBPETokenizer` from ``vocab.json`` and ``merges.txt``:
  GPT-2's byte-level BPE (its pre-tokenizing pattern, written out as a
  scanner over Unicode categories, then merges by rank). No specials are
  added, as GPT-2's and GPT-J's tokenizers add none.

SentencePiece unigram models (XLM-R, T5) are not here: :func:`load_tokenizer`
takes ``transformers``' tokenizer for them where it can be imported, and
raises where it cannot (ROADMAP queue 1, item 8: the unigram tokenizer).
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional, Sequence

import numpy as np


class _Tokenizer:
    """Batching, truncation and padding shared by both tokenizers."""

    pad_token_id: Optional[int] = None
    token_types = False          # returns token_type_ids (BERT)
    n_specials = 0               # ids _wrap adds around a sequence

    def _ids(self, text: str) -> List[int]:
        raise NotImplementedError

    def _wrap(self, ids: List[int]) -> List[int]:
        return ids

    def encode(self, text: str, add_special_tokens: bool = True,
               truncation: bool = False, max_length: Optional[int] = None,
               **_) -> List[int]:
        ids = self._ids(text)
        if add_special_tokens:
            if truncation and max_length is not None:
                ids = ids[:max(max_length - self.n_specials, 0)]
            return self._wrap(ids)
        if truncation and max_length is not None:
            ids = ids[:max_length]
        return ids

    def __call__(self, texts, padding=False, truncation: bool = False,
                 max_length: Optional[int] = None,
                 return_tensors: Optional[str] = None, **_):
        if isinstance(texts, str):
            texts = [texts]
        seqs = [self.encode(t, truncation=truncation, max_length=max_length)
                for t in texts]
        if padding == "max_length" and max_length is not None:
            width = max(max_length, max(len(s) for s in seqs))
        elif padding:
            width = max(len(s) for s in seqs)
        else:
            width = None
        if width is None:
            if return_tensors == "np" and len({len(s) for s in seqs}) > 1:
                raise ValueError("ragged batch: pass padding=True")
            width = len(seqs[0])
        if self.pad_token_id is None and any(len(s) < width for s in seqs):
            raise ValueError("the tokenizer has no pad token to pad with")
        ids = np.full((len(seqs), width), self.pad_token_id or 0, np.int64)
        mask = np.zeros((len(seqs), width), np.int64)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
            mask[i, :len(s)] = 1
        out = {"input_ids": ids}
        if self.token_types:
            out["token_type_ids"] = np.zeros_like(ids)
        out["attention_mask"] = mask
        return out

    def _split_specials(self, text: str, specials: Sequence[str]):
        """``text`` cut around the special tokens it holds literally:
        ``[(piece, is_special), ...]``."""
        parts = [(text, False)]
        for tok in sorted(specials, key=len, reverse=True):
            nxt = []
            for piece, special in parts:
                if special or tok not in piece:
                    nxt.append((piece, special))
                    continue
                chunks = piece.split(tok)
                for j, c in enumerate(chunks):
                    if c:
                        nxt.append((c, False))
                    if j < len(chunks) - 1:
                        nxt.append((tok, True))
            parts = nxt
        return parts


# ---- WordPiece ------------------------------------------------------------

def _is_whitespace(ch: str) -> bool:
    if ch in " \t\n\r":
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in "\t\n\r":
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


# (cls, sep, pad, unk) and whether token type ids are returned
WORDPIECE_SPECIALS = {"bert": ("[CLS]", "[SEP]", "[PAD]", "[UNK]", True),
                      "mpnet": ("<s>", "</s>", "<pad>", "[UNK]", False)}


class WordPieceTokenizer(_Tokenizer):
    n_specials = 2

    def __init__(self, vocab: Dict[str, int], *, do_lower_case: bool = True,
                 strip_accents: Optional[bool] = None,
                 tokenize_chinese_chars: bool = True, kind: str = "bert",
                 cls_token: Optional[str] = None,
                 sep_token: Optional[str] = None,
                 pad_token: Optional[str] = None,
                 unk_token: Optional[str] = None,
                 extra_specials: Sequence[str] = (),
                 max_input_chars_per_word: int = 100):
        cls, sep, pad, unk, types = WORDPIECE_SPECIALS[kind]
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.cls_token = cls_token or cls
        self.sep_token = sep_token or sep
        self.pad_token = pad_token or pad
        self.unk_token = unk_token or unk
        self.token_types = types
        self.max_chars = max_input_chars_per_word
        self.pad_token_id = vocab.get(self.pad_token)
        self.specials = [t for t in (self.cls_token, self.sep_token,
                                     self.pad_token, self.unk_token,
                                     *extra_specials) if t in vocab]

    @classmethod
    def from_dir(cls, path: str, kind: str = "bert") -> "WordPieceTokenizer":
        vocab = {}
        with open(os.path.join(path, "vocab.txt"), encoding="utf-8") as f:
            for index, line in enumerate(f):     # a line is its id
                vocab[line.rstrip("\n")] = index
        conf = _tokenizer_config(path)
        kw = {k: conf[k] for k in ("do_lower_case", "strip_accents",
                                   "tokenize_chinese_chars") if k in conf}
        for k in ("cls_token", "sep_token", "pad_token", "unk_token"):
            if isinstance(conf.get(k), str):
                kw[k] = conf[k]
        extra = [conf[k] for k in ("mask_token", "bos_token", "eos_token")
                 if isinstance(conf.get(k), str)]
        return cls(vocab, kind=kind, extra_specials=extra, **kw)

    def _wrap(self, ids: List[int]) -> List[int]:
        return [self.vocab[self.cls_token]] + ids + [self.vocab[self.sep_token]]

    def _basic(self, text: str) -> List[str]:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                chars.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(cp):
                chars.extend((" ", ch, " "))
            else:
                chars.append(ch)
        text = unicodedata.normalize("NFC", "".join(chars))
        out = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                if self.strip_accents is not False:
                    tok = _strip_accents(tok)
            elif self.strip_accents:
                tok = _strip_accents(tok)
            word = []
            for ch in tok:
                if _is_punctuation(ch):
                    if word:
                        out.append("".join(word))
                        word = []
                    out.append(ch)
                else:
                    word.append(ch)
            if word:
                out.append("".join(word))
        return out

    def _wordpiece(self, word: str) -> List[int]:
        unk = self.vocab[self.unk_token]
        if len(word) > self.max_chars:
            return [unk]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [unk]
            ids.append(cur)
            start = end
        return ids

    def _ids(self, text: str) -> List[int]:
        ids = []
        for piece, special in self._split_specials(text, self.specials):
            if special:
                ids.append(self.vocab[piece])
                continue
            for word in self._basic(piece):
                ids.extend(self._wordpiece(word))
        return ids


def _strip_accents(text: str) -> str:
    return "".join(ch for ch in unicodedata.normalize("NFD", text)
                   if unicodedata.category(ch) != "Mn")


# ---- byte-level BPE -------------------------------------------------------

def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _klass(ch: str) -> str:
    if ch.isspace():
        return "s"
    cat = unicodedata.category(ch)
    return "L" if cat[0] == "L" else "N" if cat[0] == "N" else "o"


def gpt2_pretokenize(text: str) -> List[str]:
    """GPT-2's pattern ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+|
    ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`` as a left-to-right scanner."""
    out, i, n = [], 0, len(text)
    while i < n:
        if text[i] == "'":
            hit = next((c for c in _CONTRACTIONS
                        if text.startswith(c, i + 1)), None)
            if hit is not None:
                out.append(text[i:i + 1 + len(hit)])
                i += 1 + len(hit)
                continue
        j = i + 1 if (text[i] == " " and i + 1 < n
                      and _klass(text[i + 1]) != "s") else i
        k = _klass(text[j])
        if k != "s":
            e = j + 1
            while e < n and _klass(text[e]) == k:
                e += 1
            out.append(text[i:e])
            i = e
            continue
        e = i
        while e < n and text[e].isspace():
            e += 1
        if e < n and e - i >= 2:
            e -= 1           # \s+(?!\S): leave one space to the next word
        out.append(text[i:e])
        i = e
    return out


class ByteLevelBPETokenizer(_Tokenizer):
    def __init__(self, vocab: Dict[str, int], merges: Sequence[tuple], *,
                 specials: Sequence[str] = (), pad_token: Optional[str] = None,
                 unk_token: Optional[str] = None):
        self.vocab = vocab
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.byte_map = bytes_to_unicode()
        self.specials = [t for t in specials if t in vocab]
        self.pad_token_id = vocab.get(pad_token) if pad_token else None
        self.unk_id = vocab.get(unk_token) if unk_token else None
        self._cache: Dict[str, List[str]] = {}

    @classmethod
    def from_dir(cls, path: str) -> "ByteLevelBPETokenizer":
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        merges = []
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        conf = _tokenizer_config(path)
        specials = [conf[k] for k in ("bos_token", "eos_token", "unk_token",
                                      "pad_token")
                    if isinstance(conf.get(k), str)]
        return cls(vocab, merges, specials=specials,
                   pad_token=conf.get("pad_token") if isinstance(
                       conf.get("pad_token"), str) else None,
                   unk_token=conf.get("unk_token") if isinstance(
                       conf.get("unk_token"), str) else None)

    def _bpe(self, word: str) -> List[str]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        parts = list(word)
        while len(parts) > 1:
            best, rank = None, None
            for a, b in zip(parts, parts[1:]):
                r = self.ranks.get((a, b))
                if r is not None and (rank is None or r < rank):
                    best, rank = (a, b), r
            if best is None:
                break
            merged, i = [], 0
            while i < len(parts):
                if (i < len(parts) - 1 and parts[i] == best[0]
                        and parts[i + 1] == best[1]):
                    merged.append(best[0] + best[1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def _ids(self, text: str) -> List[int]:
        ids = []
        for piece, special in self._split_specials(text, self.specials):
            if special:
                ids.append(self.vocab[piece])
                continue
            for word in gpt2_pretokenize(piece):
                mapped = "".join(self.byte_map[b] for b in word.encode())
                for tok in self._bpe(mapped):
                    tid = self.vocab.get(tok, self.unk_id)
                    if tid is None:
                        raise KeyError(f"token {tok!r} is not in the vocab")
                    ids.append(tid)
        return ids


def _tokenizer_config(path: str) -> dict:
    """``tokenizer_config.json`` with ``special_tokens_map.json`` over it
    (string values; added-token objects reduced to their content)."""
    conf = {}
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        fpath = os.path.join(path, name)
        if os.path.isfile(fpath):
            with open(fpath, encoding="utf-8") as f:
                for k, v in json.load(f).items():
                    conf[k] = v.get("content") if isinstance(v, dict) else v
    return conf


def load_tokenizer(path: str, model_type: str):
    """The tokenizer of the checkpoint at ``path``: WordPiece for BERT and
    MPNet vocabularies, byte-level BPE for GPT-2-style ones, and
    ``transformers``' tokenizer for SentencePiece models where it can be
    imported."""
    if os.path.isfile(os.path.join(path, "vocab.txt")) and model_type in (
            "bert", "mpnet"):
        return WordPieceTokenizer.from_dir(path, kind=model_type)
    if (os.path.isfile(os.path.join(path, "vocab.json"))
            and os.path.isfile(os.path.join(path, "merges.txt"))):
        return ByteLevelBPETokenizer.from_dir(path)
    try:
        from transformers import AutoTokenizer
    except ImportError as e:
        raise RuntimeError(
            f"{path}: a {model_type!r} checkpoint needs a SentencePiece "
            "unigram tokenizer, which the port does not have yet (ROADMAP "
            "queue 1, item 8: the SentencePiece unigram tokenizer) and "
            "transformers is not installed to lend one") from e
    return AutoTokenizer.from_pretrained(path, local_files_only=True)
