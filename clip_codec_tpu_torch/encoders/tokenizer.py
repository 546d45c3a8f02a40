"""CLIP BPE tokenizer — the port's copy of ``clip_codec_tpu/encoders/tokenizer.py``.

The standard byte-level BPE scheme of openai / open_clip: ``basic_clean``
(``textclean.fix_text`` + double ``html.unescape``), lowercase, whitespace
collapse, byte-to-unicode mapping, ``</w>`` word suffix,
``<|startoftext|>``/``<|endoftext|>`` specials, a 77-token context with
truncation that keeps the EOT last. The merges table is not bundled: point
``CLIP_BPE_PATH`` or ``bpe_path`` at ``bpe_simple_vocab_16e6.txt.gz``.
``regex`` (unicode-property classes) is imported at the first tokenization,
so the package imports without it.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .textclean import fix_text


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode map (standard GPT-2/CLIP table)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _get_pairs(word: Tuple[str, ...]) -> set:
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


@lru_cache()
def _word_re():
    """The open_clip / openai word-split pattern (unicode letter/number
    properties: "café" stays one word)."""
    import regex

    return regex.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
        regex.IGNORECASE,
    )


class CLIPTokenizer:
    def __init__(self, bpe_path: Optional[str] = None, context_length: int = 77) -> None:
        bpe_path = bpe_path or os.environ.get("CLIP_BPE_PATH")
        if not bpe_path or not Path(bpe_path).exists():
            raise FileNotFoundError(
                "CLIP BPE merges file not found. Download bpe_simple_vocab_16e6.txt.gz "
                "(ships with openai/CLIP and open_clip) and set CLIP_BPE_PATH or pass bpe_path."
            )
        self.context_length = context_length
        self.byte_encoder = bytes_to_unicode()
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            raw = f.read().split("\n")
        merges = [tuple(m.split()) for m in raw[1 : 49152 - 256 - 2 + 1]]
        vocab: List[str] = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self._cache: Dict[str, str] = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    def _bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(fix_text(text)))
        text = re.sub(r"\s+", " ", text.strip()).lower()
        ids: List[int] = []
        for tok in _word_re().findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return ids

    def __call__(self, texts) -> np.ndarray:
        """List of strings -> (N, context_length) int32, SOT ... EOT padded
        with zeros; over-long sequences truncate and keep EOT last."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.zeros((len(texts), self.context_length), dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode(text) + [self.eot]
            if len(ids) > self.context_length:
                ids = ids[: self.context_length]
                ids[-1] = self.eot
            out[i, : len(ids)] = ids
        return out
