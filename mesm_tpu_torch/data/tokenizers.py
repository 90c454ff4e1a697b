"""Host-side tokenizers: CLIP BPE and GloVe word tokenizers.

Parity targets: reference dataset/tokenizer.py — CLIPTokenizer (:67-214,
byte-level BPE over bpe_simple_vocab_16e6), GloVeSimpleTokenizer (:248-316),
NLTKTokenizer (:319-333), NLTKTokenizerWithFeature (:336-397, emits 300-d
GloVe vectors directly). All outputs are numpy (this layer never touches the
device); tokenization is offline-cacheable work.

POS-based MLM weights: content words (noun/verb/adj/adverb) get weight 2,
everything else 1 (reference :139-147). When the NLTK tagger data is not
installed (this container has no egress), a closed-class-word heuristic is
used instead: weight 1 for function words, 2 otherwise — same spirit, and
only affects the *sampling distribution* of masked words, not correctness.
"""
from __future__ import annotations

import gzip
import html
import re as std_re
import string
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

try:
    import regex as re
except ImportError:  # pragma: no cover
    re = std_re

try:
    import ftfy

    _HAS_FTFY = True
except ImportError:
    _HAS_FTFY = False

try:
    import nltk

    try:
        nltk.pos_tag(["hello"])
        _HAS_POS = True
    except LookupError:
        _HAS_POS = False
    try:
        nltk.tokenize.word_tokenize("hello world")
        _HAS_PUNKT = True
    except LookupError:
        _HAS_PUNKT = False
except ImportError:  # pragma: no cover
    nltk = None
    _HAS_POS = False
    _HAS_PUNKT = False

# closed-class (function) words for the no-NLTK-data fallback tagger
_FUNCTION_WORDS = frozenset(
    """a an the and or but if while of to in on at by for with about against
    between into through during before after above below from up down out off
    over under again further then once here there when where why how all any
    both each few more most other some such no nor not only own same so than
    too very s t can will just don should now is are was were be been being
    have has had having do does did doing he she it they them his her its
    their this that these those i you we me him us my your our as""".split()
)


def pos_weights(words: Sequence[str]) -> List[int]:
    """Weight 2 for content words, 1 otherwise."""
    if _HAS_POS and words:
        tags = nltk.pos_tag(list(words))
        return [
            2 if any(t in tag for t in ("NN", "VB", "JJ", "RB")) else 1
            for _, tag in tags
        ]
    return [1 if w.lower() in _FUNCTION_WORDS else 2 for w in words]


def word_tokenize(sentence: str) -> List[str]:
    if _HAS_PUNKT:
        return nltk.tokenize.word_tokenize(sentence)
    # fallback: split on words/punctuation clusters
    return std_re.findall(r"\w+|[^\w\s]", sentence)


@lru_cache()
def byte_unicode_table() -> Dict[int, str]:
    """GPT-2 style reversible byte -> printable-unicode mapping."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    mapping = {}
    extra = 0
    for b in range(256):
        if b in keep:
            mapping[b] = chr(b)
        else:
            mapping[b] = chr(256 + extra)
            extra += 1
    return mapping


def _clean_text(text: str) -> str:
    if _HAS_FTFY:
        text = ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    text = std_re.sub(r"\s+", " ", text)
    return text.strip()


class ClipBPETokenizer:
    """Byte-level BPE with CLIP's merge table and <|startoftext|>/<|endoftext|>
    specials; emits MLM labels over a frequency-truncated keep-vocab."""

    CONTEXT_LENGTH = 77

    def __init__(self, recfw: bool, id2label: Optional[Dict], bpe_path: str):
        self.recfw = recfw
        self.id2label = id2label
        self.byte_enc = byte_unicode_table()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(m.split()) for m in lines[1 : 49152 - 256 - 2 + 1] if m]
        base = list(self.byte_enc.values())
        vocab = base + [v + "</w>" for v in base]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.merge_rank = {m: i for i, m in enumerate(merges)}
        self._bpe_cache: Dict[str, str] = {}
        self.pattern = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if re is not std_re
            else r"'s|'t|'re|'ve|'m|'ll|'d|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+",
            re.IGNORECASE,
        )
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            ranked = min(pairs, key=lambda p: self.merge_rank.get(p, float("inf")))
            if ranked not in self.merge_rank:
                break
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i < len(parts) - 1
                    and parts[i] == ranked[0]
                    and parts[i + 1] == ranked[1]
                ):
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        out = " ".join(parts)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> Tuple[List[int], List[int]]:
        text = _clean_text(text).lower()
        token_strs: List[str] = []
        token_ids: List[int] = []
        for raw in re.findall(self.pattern, text):
            mapped = "".join(self.byte_enc[b] for b in raw.encode("utf-8"))
            for piece in self._bpe(mapped).split(" "):
                token_strs.append(piece.replace("</w>", ""))
                token_ids.append(self.encoder[piece])
        weights = pos_weights(token_strs)
        return token_ids, weights

    def tokenize(
        self,
        texts: Union[str, List[str]],
        context_length: int = CONTEXT_LENGTH,
        max_valid_length: int = 32,
    ):
        if isinstance(texts, str):
            texts = [texts]
        n = len(texts)
        ids = np.zeros((n, context_length), np.int64)
        weights = np.zeros((n, max_valid_length), np.int64)
        unknown = np.zeros((n, max_valid_length), bool) if self.recfw else None
        labels = np.zeros((n, max_valid_length), np.int64) if self.recfw else None
        for i, text in enumerate(texts):
            tok, w = self.encode(text)
            tok = tok[: max_valid_length - 2]
            w = w[: max_valid_length - 2]
            seq = [self.sot] + tok + [self.eot]
            if len(seq) > context_length:
                raise RuntimeError(f"input too long for context {context_length}")
            ids[i, : len(seq)] = seq
            weights[i, 1 : 1 + len(w)] = w  # sot/eot carry weight 0
            if self.recfw:
                unk = [False] + [t not in self.id2label for t in tok] + [False]
                lab = (
                    [self.id2label["<start>"]]
                    + [self.id2label.get(t, self.id2label["<unknown>"]) for t in tok]
                    + [self.id2label["<end>"]]
                )
                unknown[i, : len(seq)] = unk
                labels[i, : len(seq)] = lab
        return ids, weights, unknown, labels


class GloVeSimpleTokenizer:
    """Lowercase + punctuation-strip word split into a Vocabulary
    (reference :248-316)."""

    def __init__(self, recfw: bool, id2label: Optional[Dict], vocab):
        self.recfw = recfw
        self.id2label = id2label
        self.vocab = vocab
        self._table = str.maketrans(string.punctuation, " " * len(string.punctuation))

    def split_words(self, text: str) -> List[str]:
        return str(text).lower().translate(self._table).strip().split()

    def encode(self, text: str) -> Tuple[List[int], List[int]]:
        words = self.split_words(text)
        return [self.vocab.get(w) for w in words], pos_weights(words)

    def tokenize(self, texts, context_length: int = 77, max_valid_length: int = 32):
        if isinstance(texts, str):
            texts = [texts]
        n = len(texts)
        ids = np.zeros((n, max_valid_length), np.int64)
        weights = np.zeros((n, max_valid_length), np.int64)
        unknown = np.zeros((n, max_valid_length), bool) if self.recfw else None
        labels = np.zeros((n, max_valid_length), np.int64) if self.recfw else None
        for i, text in enumerate(texts):
            tok, w = self.encode(text)
            tok = tok[:max_valid_length]
            w = w[:max_valid_length]
            ids[i, : len(tok)] = tok
            weights[i, : len(tok)] = w
            if self.recfw:
                unknown[i, : len(tok)] = [t not in self.id2label for t in tok]
                labels[i, : len(tok)] = [
                    self.id2label.get(t, self.id2label["<unknown>"]) for t in tok
                ]
        return ids, weights, unknown, labels


class NLTKTokenizer(GloVeSimpleTokenizer):
    """NLTK word tokenization variant (reference :319-333)."""

    def encode(self, sentence: str) -> Tuple[List[int], List[int]]:
        words = [w.lower() for w in word_tokenize(sentence)]
        return [self.vocab.get(w) for w in words], pos_weights(words)


class NLTKFeatureTokenizer:
    """Emits 300-d GloVe vectors directly as `words_id` (the model's text
    encoder becomes a pass-through); words absent from the pkl vocab are
    dropped (reference :336-397). `vocab` is the glove.pkl dict with keys
    w2id / id2vec / counter."""

    def __init__(self, recfw: bool, id2label: Optional[Dict], vocab: Dict):
        self.recfw = recfw
        self.id2label = id2label
        self.vocab = vocab
        self.dim = int(np.asarray(next(iter(vocab["id2vec"].values()))).shape[-1]) if isinstance(vocab["id2vec"], dict) else int(np.asarray(vocab["id2vec"]).shape[-1])

    def encode(self, sentence: str):
        kept: List[str] = []
        for w in word_tokenize(sentence):
            w = w.lower()
            if w in self.vocab["w2id"]:
                kept.append(w)
        weights = pos_weights(kept)
        id2vec = self.vocab["id2vec"]
        feats = [
            np.asarray(id2vec[self.vocab["w2id"][w]], dtype=np.float32) for w in kept
        ]
        return kept, feats, weights

    def tokenize(self, texts, context_length: int = 77, max_valid_length: int = 32):
        if isinstance(texts, str):
            texts = [texts]
        n = len(texts)
        ids = np.zeros((n, max_valid_length, self.dim), np.float32)
        weights = np.zeros((n, max_valid_length), np.int64)
        unknown = np.zeros((n, max_valid_length), bool) if self.recfw else None
        labels = np.zeros((n, max_valid_length), np.int64) if self.recfw else None
        for i, text in enumerate(texts):
            words, feats, w = self.encode(text)
            words = words[:max_valid_length]
            feats = feats[:max_valid_length]
            w = w[:max_valid_length]
            if feats:
                ids[i, : len(feats)] = np.stack(feats)
            weights[i, : len(w)] = w
            if self.recfw:
                unknown[i, : len(words)] = [t not in self.id2label for t in words]
                labels[i, : len(words)] = [
                    self.id2label.get(t, self.id2label["<unknown>"]) for t in words
                ]
        return ids, weights, unknown, labels
