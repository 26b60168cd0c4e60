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

* :class:`UnigramTokenizer`, SentencePiece's unigram model (XLM-R, T5),
  from a ``tokenizer.json`` of model type ``Unigram`` or from the
  SentencePiece ``.model`` protobuf (``sentencepiece.bpe.model`` /
  ``spiece.model``, read by a small reader of its own): the normalizer
  (SentencePiece's precompiled charsmap, a darts-clone double-array trie
  over a blob of normalised strings, read as the ``spm_precompiled`` crate
  reads it; then ``Replace`` and the like, in order), the Metaspace
  pre-tokenizer (``▁`` for spaces, one prepended), a Viterbi pass over the
  piece lattice with unknown characters as ``unk`` (consecutive ones
  fused), and the post-processor's specials: XLM-R's fairseq offset and
  ``<s> … </s>``, T5's trailing ``</s>`` and ``<extra_id_*>`` tokens.
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata
from typing import Dict, List, Optional, Sequence, Tuple

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


# ---- SentencePiece unigram ---------------------------------------------------

class PrecompiledCharsmap:
    """SentencePiece's precompiled normaliser (``nmt_nfkc``'s table): a
    little-endian u32 trie size, a darts-clone double array of that many
    bytes, then the normalised strings, each ended by a 0 byte. Read and
    applied as the ``spm_precompiled`` crate does."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError("precompiled charsmap too short")
        (size,) = struct.unpack_from("<I", blob, 0)
        if size % 4 or 4 + size > len(blob):
            raise ValueError("precompiled charsmap: bad trie size")
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.normalized = blob[4 + size:]
        self._cache: Dict[str, Optional[str]] = {}

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & (1 << 9)) >> 6)

    def prefix_values(self, key: bytes) -> List[int]:
        """Values of every prefix of ``key`` in the trie, shortest first
        (darts-clone's common prefix search)."""
        units = self.units
        out = []
        pos = self._offset(units[0])
        for c in key:
            pos ^= c
            if pos >= len(units):
                break
            unit = units[pos]
            if unit & ((1 << 31) | 0xFF) != c:
                break
            pos ^= self._offset(unit)
            if (unit >> 8) & 1:
                out.append(units[pos] & 0x7FFFFFFF)
        return out

    def transform(self, chunk: str) -> Optional[str]:
        """The normalised form of ``chunk`` by its shortest prefix in the
        trie, or ``None``."""
        if chunk in self._cache:
            return self._cache[chunk]
        vals = self.prefix_values(chunk.encode("utf-8"))
        out = None
        if vals:
            start = vals[0]
            end = self.normalized.find(b"\0", start)
            out = self.normalized[start:end if end >= 0 else None].decode(
                "utf-8")
        self._cache[chunk] = out
        return out

    def normalize(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            if len(g.encode("utf-8")) < 6:
                norm = self.transform(g)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self.transform(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


_ZWJ = "\u200d"


def _extends(ch: str) -> bool:
    """Whether ``ch`` joins the grapheme before it (Extend / SpacingMark:
    combining marks, variation selectors, emoji modifiers)."""
    cp = ord(ch)
    return (unicodedata.category(ch) in ("Mn", "Mc", "Me") or ch == _ZWJ
            or 0xFE00 <= cp <= 0xFE0F or 0xE0100 <= cp <= 0xE01EF
            or 0x1F3FB <= cp <= 0x1F3FF or 0xE0020 <= cp <= 0xE007F)


def _hangul(ch: str) -> str:
    cp = ord(ch)
    if 0x1100 <= cp <= 0x115F or 0xA960 <= cp <= 0xA97C:
        return "L"
    if 0x1160 <= cp <= 0x11A7 or 0xD7B0 <= cp <= 0xD7C6:
        return "V"
    if 0x11A8 <= cp <= 0x11FF or 0xD7CB <= cp <= 0xD7FB:
        return "T"
    if 0xAC00 <= cp <= 0xD7A3:
        return "LV" if (cp - 0xAC00) % 28 == 0 else "LVT"
    return ""


def graphemes(text: str) -> List[str]:
    """Extended grapheme clusters (UAX #29's main rules: CR LF, Hangul
    syllable sequences, regional-indicator pairs, combining marks and other
    extenders, ZWJ sequences)."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        j = i + 1
        ch = text[i]
        if ch == "\r" and j < n and text[j] == "\n":
            j += 1
        elif 0x1F1E6 <= ord(ch) <= 0x1F1FF:
            if j < n and 0x1F1E6 <= ord(text[j]) <= 0x1F1FF:
                j += 1
        elif _hangul(ch):
            prev = _hangul(ch)
            while j < n:
                cur = _hangul(text[j])
                ok = ((prev == "L" and cur in ("L", "V", "LV", "LVT"))
                      or (prev in ("LV", "V") and cur in ("V", "T"))
                      or (prev in ("LVT", "T") and cur == "T"))
                if not ok:
                    break
                prev = cur
                j += 1
        if ch not in "\r\n" and not unicodedata.category(ch).startswith("C"):
            while j < n:
                if _extends(text[j]):
                    j += 1
                    if text[j - 1] == _ZWJ and j < n and not _extends(text[j]) \
                            and unicodedata.category(text[j]) == "So":
                        j += 1
                else:
                    break
        out.append(text[i:j])
        i = j
    return out


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    val = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7


def _proto_fields(buf: bytes):
    """``(field number, wire type, value)`` of one protobuf message: ints
    for varints and fixed widths, bytes for length-delimited fields."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"protobuf wire type {wire} not supported")
        yield field, wire, val


def read_sentencepiece_model(path: str) -> dict:
    """The parts of a SentencePiece ``ModelProto`` the tokenizer needs:
    ``pieces`` [(piece, score, type)] (field 1: piece 1, score 2, type 3),
    ``unk_id`` (the piece of type UNKNOWN, else trainer_spec.unk_id) and
    ``precompiled_charsmap`` (normalizer_spec field 2)."""
    with open(path, "rb") as f:
        buf = f.read()
    pieces, charsmap, unk_id = [], b"", None
    for field, _, val in _proto_fields(buf):
        if field == 1:
            piece, score, typ = "", 0.0, 1
            for f2, _, v2 in _proto_fields(val):
                if f2 == 1:
                    piece = v2.decode("utf-8")
                elif f2 == 2:
                    score = struct.unpack("<f", v2)[0]
                elif f2 == 3:
                    typ = v2
            pieces.append((piece, score, typ))
        elif field == 2:
            for f2, _, v2 in _proto_fields(val):
                if f2 == 40:
                    unk_id = v2
        elif field == 3:
            for f2, _, v2 in _proto_fields(val):
                if f2 == 2:
                    charsmap = bytes(v2)
    for i, (_, _, typ) in enumerate(pieces):
        if typ == 2:
            unk_id = i
            break
    return {"pieces": pieces, "unk_id": 0 if unk_id is None else unk_id,
            "precompiled_charsmap": charsmap}


def _regex(pattern) -> "re.Pattern":
    if "Regex" in pattern:
        return re.compile(pattern["Regex"])
    return re.compile(re.escape(pattern["String"]))


def _normalizer(spec: Optional[dict]):
    """A ``tokenizer.json`` normalizer as a function of ``str``."""
    if not spec:
        return lambda t: t
    kind = spec["type"]
    if kind == "Sequence":
        steps = [_normalizer(n) for n in spec["normalizers"]]

        def seq(t):
            for f in steps:
                t = f(t)
            return t
        return seq
    if kind == "Precompiled":
        raw = spec.get("precompiled_charsmap")
        if not raw:
            return lambda t: t
        cmap = PrecompiledCharsmap(
            base64.b64decode(raw) if isinstance(raw, str) else bytes(raw))
        return cmap.normalize
    if kind == "Replace":
        pat, content = _regex(spec["pattern"]), spec["content"]
        return lambda t: pat.sub(lambda m: content, t)
    if kind in ("NFC", "NFD", "NFKC", "NFKD"):
        return lambda t: unicodedata.normalize(kind, t)
    if kind == "Lowercase":
        return str.lower
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right",
                                                             True)
        return lambda t: (t.lstrip() if left else t).rstrip() if right \
            else (t.lstrip() if left else t)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda t: pre + t if t else t
    raise ValueError(f"normalizer type {kind!r} not supported")


class UnigramTokenizer(_Tokenizer):
    """SentencePiece's unigram model with the specials of its checkpoint.

    ``vocab``: ``[(piece, score)]`` in id order; ``unk_id``; ``specials``:
    the added tokens matched literally in text before normalisation;
    ``template``: the ids around one sequence, ``(before, after)``."""

    K_UNK_PENALTY = 10.0

    def __init__(self, vocab: Sequence[Tuple[str, float]], unk_id: int, *,
                 normalizer=None, replacement: str = "\u2581",
                 prepend_scheme: str = "always", split: bool = True,
                 specials: Optional[Dict[str, int]] = None,
                 template: Tuple[Sequence[int], Sequence[int]] = ((), ()),
                 pad_token_id: Optional[int] = None,
                 fuse_unk: bool = True):
        self.vocab = [(p, float(sc)) for p, sc in vocab]
        self.unk_id = int(unk_id)
        self.normalize = normalizer or (lambda t: t)
        self.replacement = replacement
        self.prepend_scheme = prepend_scheme
        self.split = split
        self.specials = dict(specials or {})
        self.before, self.after = list(template[0]), list(template[1])
        self.n_specials = len(self.before) + len(self.after)
        self.pad_token_id = pad_token_id
        self.fuse_unk = fuse_unk
        self.piece_to_id = {}
        self.trie: dict = {}
        for i, (piece, _) in enumerate(self.vocab):
            self.piece_to_id.setdefault(piece, i)
            if not piece:
                continue
            node = self.trie
            for ch in piece:
                node = node.setdefault(ch, {})
            node.setdefault(None, i)
        self.min_score = min((sc for _, sc in self.vocab), default=0.0)
        self.unk_score = self.min_score - self.K_UNK_PENALTY

    # -- loading --------------------------------------------------------
    @classmethod
    def from_tokenizer_json(cls, path: str) -> "UnigramTokenizer":
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"{path}: model type {model.get('type')!r} is "
                             "not Unigram")
        vocab = [(p, sc) for p, sc in model["vocab"]]
        pre = spec.get("pre_tokenizer") or {}
        if pre.get("type") == "Sequence":
            pre = next((p for p in pre["pretokenizers"]
                        if p["type"] == "Metaspace"), {})
        specials = {t["content"]: t["id"]
                    for t in spec.get("added_tokens") or []}
        ids = dict(specials)
        for i, (p, _) in enumerate(vocab):
            ids.setdefault(p, i)
        before, after = _template(spec.get("post_processor"), ids)
        scheme = pre.get("prepend_scheme") or (
            "always" if pre.get("add_prefix_space", True) else "never")
        return cls(vocab, model.get("unk_id") or 0,
                   normalizer=_normalizer(spec.get("normalizer")),
                   replacement=pre.get("replacement", "\u2581"),
                   prepend_scheme=scheme, split=pre.get("split", True),
                   specials=specials, template=(before, after),
                   pad_token_id=ids.get("<pad>"))

    @classmethod
    def from_sentencepiece(cls, path: str, kind: str,
                           extra_ids: int = 100) -> "UnigramTokenizer":
        """From a ``.model`` protobuf, with the ids and specials the
        checkpoint's tokenizer gives: ``kind`` "xlm-roberta" (the fairseq
        offset: ``<s>`` 0, ``<pad>`` 1, ``</s>`` 2, ``<unk>`` 3, pieces from
        SentencePiece id 3 on shifted by one, ``<mask>`` last; ``<s> …
        </s>``) or "t5" (SentencePiece's ids, then ``extra_ids``
        ``<extra_id_*>`` tokens, ``<extra_id_0>`` last; a trailing
        ``</s>``). The normaliser is the charsmap, then runs of spaces
        collapsed to one."""
        sp = read_sentencepiece_model(path)
        pieces = sp["pieces"]
        if kind == "xlm-roberta":
            vocab = ([("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0),
                      ("<unk>", 0.0)]
                     + [(p, sc) for p, sc, _ in pieces[3:]]
                     + [("<mask>", 0.0)])
            unk_id = 3
            specials = {"<s>": 0, "<pad>": 1, "</s>": 2, "<unk>": 3,
                        "<mask>": len(vocab) - 1}
            template = ([0], [2])
            pad = 1
        elif kind == "t5":
            vocab = ([(p, sc) for p, sc, _ in pieces]
                     + [(f"<extra_id_{i}>", 0.0)
                        for i in range(extra_ids - 1, -1, -1)])
            unk_id = sp["unk_id"]
            specials = {p: i for i, (p, _, t) in enumerate(pieces)
                        if t in (2, 3)}
            specials.update({p: len(pieces) + j for j, (p, _) in
                             enumerate(vocab[len(pieces):])})
            eos = specials.get("</s>", 1)
            template = ([], [eos])
            pad = specials.get("<pad>", 0)
        else:
            raise ValueError(f"no SentencePiece specials for {kind!r}")
        steps = []
        if sp["precompiled_charsmap"]:
            steps.append(PrecompiledCharsmap(sp["precompiled_charsmap"])
                         .normalize)
        spaces = re.compile(" {2,}")
        steps.append(lambda t: spaces.sub(" ", t))

        def norm(t):
            for f in steps:
                t = f(t)
            return t
        return cls(vocab, unk_id, normalizer=norm, specials=specials,
                   template=template, pad_token_id=pad)

    # -- encoding -------------------------------------------------------
    def _wrap(self, ids: List[int]) -> List[int]:
        return self.before + ids + self.after

    def _viterbi(self, text: str) -> List[int]:
        """Best segmentation of one pre-token: the lattice's highest total
        score; a position no piece of one character starts gets an
        ``unk`` node."""
        n = len(text)
        best = [(None, 0.0, -1)] * (n + 1)      # (id, score, start)
        best[0] = (None, 0.0, 0)
        for start in range(n):
            if best[start][2] < 0:
                continue
            base = best[start][1]
            node = self.trie
            single = False
            for end in range(start, n):
                node = node.get(text[end])
                if node is None:
                    break
                tid = node.get(None)
                if tid is not None:
                    sc = base + self.vocab[tid][1]
                    b = best[end + 1]
                    if b[2] < 0 or sc > b[1]:
                        best[end + 1] = (tid, sc, start)
                    if end == start:
                        single = True
            if not single:
                sc = base + self.unk_score
                b = best[start + 1]
                if b[2] < 0 or sc > b[1]:
                    best[start + 1] = (self.unk_id, sc, start)
        ids: List[int] = []
        pos = n
        while pos > 0:
            tid, _, start = best[pos]
            if not (self.fuse_unk and tid == self.unk_id and ids
                    and ids[-1] == self.unk_id):
                ids.append(tid)
            pos = start
        ids.reverse()
        return ids

    def _pretokenize(self, text: str, first: bool) -> List[str]:
        text = text.replace(" ", self.replacement)
        if (self.prepend_scheme == "always"
                or (self.prepend_scheme == "first" and first)):
            if not text.startswith(self.replacement):
                text = self.replacement + text
        if not self.split:
            return [text]
        words, cur = [], ""
        for ch in text:
            if ch == self.replacement and cur:
                words.append(cur)
                cur = ""
            cur += ch
        if cur:
            words.append(cur)
        return words

    def _ids(self, text: str) -> List[int]:
        ids: List[int] = []
        first = True
        for piece, special in self._split_specials(text, self.specials):
            if special:
                ids.append(self.specials[piece])
                first = False
                continue
            norm = self.normalize(piece)
            if not norm:
                continue
            for word in self._pretokenize(norm, first):
                ids.extend(self._viterbi(word))
            first = False
        return ids


def _template(post: Optional[dict], ids: Dict[str, int]):
    """The ids a post-processor puts before and after one sequence."""
    if not post:
        return [], []
    kind = post["type"]
    if kind == "Sequence":
        for p in post.get("processors", []):
            if p["type"] in ("TemplateProcessing", "RobertaProcessing",
                             "BertProcessing"):
                return _template(p, ids)
        return [], []
    if kind in ("RobertaProcessing", "BertProcessing"):
        return [post["cls"][1]], [post["sep"][1]]
    if kind == "TemplateProcessing":
        before, after, seen = [], [], False
        for item in post["single"]:
            if "Sequence" in item:
                seen = True
                continue
            tok = item["SpecialToken"]["id"]
            tok_ids = post.get("special_tokens", {}).get(tok, {}).get(
                "ids") or [ids[tok]]
            (after if seen else before).extend(tok_ids)
        return before, after
    return [], []


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
    """The tokenizer of the checkpoint at ``path``: the SentencePiece unigram
    model for XLM-R and T5 checkpoints (``tokenizer.json``, else the
    ``.model`` protobuf), WordPiece for BERT and MPNet vocabularies,
    byte-level BPE for GPT-2-style ones."""
    if model_type in ("xlm-roberta", "t5"):
        tj = os.path.join(path, "tokenizer.json")
        if os.path.isfile(tj):
            with open(tj, encoding="utf-8") as f:
                is_unigram = json.load(f)["model"].get("type") == "Unigram"
            if is_unigram:
                return UnigramTokenizer.from_tokenizer_json(tj)
        for name in ("sentencepiece.bpe.model", "spiece.model"):
            if os.path.isfile(os.path.join(path, name)):
                return UnigramTokenizer.from_sentencepiece(
                    os.path.join(path, name), model_type)
        raise FileNotFoundError(
            f"{path}: a {model_type!r} checkpoint needs a SentencePiece "
            "unigram tokenizer (tokenizer.json, sentencepiece.bpe.model or "
            "spiece.model) and has none")
    if os.path.isfile(os.path.join(path, "vocab.txt")) and model_type in (
            "bert", "mpnet"):
        return WordPieceTokenizer.from_dir(path, kind=model_type)
    if (os.path.isfile(os.path.join(path, "vocab.json"))
            and os.path.isfile(os.path.join(path, "merges.txt"))):
        return ByteLevelBPETokenizer.from_dir(path)
    raise FileNotFoundError(
        f"{path}: no tokenizer files for a {model_type!r} checkpoint "
        "(vocab.txt, vocab.json + merges.txt, tokenizer.json or a "
        "SentencePiece .model)")
