"""CLIP BPE tokenizer (host-side), self-contained.

The reference uses two HF CLIPTokenizers (inference.py:255-263). Both SDXL
tokenizers share the OpenAI CLIP BPE vocab (49408 tokens, `</w>` word-end
markers, byte-level unicode mapping); they differ only in the pad token
(tokenizer: eos 49407; tokenizer_2: pad 0 "!"). This implements that scheme
directly from vocab.json + merges.txt — no network, no transformers
dependency. When vocab files are absent (hermetic tests), a deterministic
hash tokenizer with the same interface stands in.

Own copy of ``idmvton_tpu/data/tokenizer.py`` for the PyTorch port, which
imports nothing of the JAX package; tests hold the two bit for bit.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import json
import os
import re
from typing import List, Optional

import numpy as np


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"
    if False else
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\s a-zA-Z0-9]+",
    re.IGNORECASE)


class CLIPTokenizer:
    """OpenAI CLIP BPE. bos=49406, eos=49407, context length 77."""

    def __init__(self, vocab_path: str, merges_path: str, *,
                 max_length: int = 77, pad_token_id: Optional[int] = None):
        with open(vocab_path) as f:
            self.encoder = json.load(f)
        opener = gzip.open if merges_path.endswith(".gz") else open
        with opener(merges_path, "rt") as f:
            merges = f.read().split("\n")
        # skip header line(s); merges are "a b" pairs
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith("#") and len(m.split()) == 2]
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = _bytes_to_unicode()
        self.max_length = max_length
        self.bos = self.encoder["<|startoftext|>"]
        self.eos = self.encoder["<|endoftext|>"]
        self.pad = pad_token_id if pad_token_id is not None else self.eos
        self.cache = {}

    def _bpe(self, token: str) -> List[str]:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e12))
            if bigram not in self.bpe_ranks:
                break
            a, b = bigram
            new_word = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == a and word[i + 1] == b:
                    new_word.append(a + b)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        self.cache[token] = list(word)
        return list(word)

    def encode(self, text: str) -> List[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids = []
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok))
        return ids

    def __call__(self, texts, max_length: Optional[int] = None) -> np.ndarray:
        """Returns int32 (B, max_length) with bos/eos, truncated + padded —
        HF CLIPTokenizer(padding="max_length", truncation=True) semantics
        (reference: tryon_pipeline.py:613-619)."""
        if isinstance(texts, str):
            texts = [texts]
        n = max_length or self.max_length
        out = np.full((len(texts), n), self.pad, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode(t)[: n - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in with the CLIPTokenizer interface for hermetic
    tests / random-weight benches (no vocab files in this environment)."""

    def __init__(self, vocab_size: int = 49408, max_length: int = 77,
                 pad_token_id: int = 49407):
        self.vocab_size = vocab_size
        self.max_length = max_length
        self.bos, self.eos, self.pad = 49406 % vocab_size, 49407 % vocab_size, pad_token_id % vocab_size

    def encode(self, text: str) -> List[int]:
        words = _whitespace_clean(text).lower().split()
        # stable per-word content hash into the non-special vocab range
        # (builtin hash() is salted per process — not reproducible)
        return [
            int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little")
            % (self.vocab_size - 3)
            for w in words
        ]

    def __call__(self, texts, max_length: Optional[int] = None) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        n = max_length or self.max_length
        out = np.full((len(texts), n), self.pad, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + self.encode(t)[: n - 2] + [self.eos]
            out[i, : len(ids)] = ids
        return out


def load_tokenizers(dir_1: Optional[str] = None, dir_2: Optional[str] = None):
    """Load the SDXL tokenizer pair from diffusers-layout dirs (vocab.json +
    merges.txt); falls back to HashTokenizer when unavailable."""

    def load(d, pad):
        if d:
            v, m = os.path.join(d, "vocab.json"), os.path.join(d, "merges.txt")
            if os.path.exists(v) and os.path.exists(m):
                return CLIPTokenizer(v, m, pad_token_id=pad)
        return HashTokenizer(pad_token_id=pad if pad is not None else 49407)

    return load(dir_1, None), load(dir_2, 0)
