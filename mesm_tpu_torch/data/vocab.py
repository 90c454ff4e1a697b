"""Natural-language vocabulary for the GloVe tokenizer paths.

Parity: reference dataset/tokenizer.py:217-245 — ids 0/1 are <PAD>/<UNK>,
remaining words sorted lexicographically.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Iterable


class Vocabulary:
    SPECIAL = ["<PAD>", "<UNK>"]

    def __init__(self, *word_sets: Iterable[str]):
        self.wtoi: "OrderedDict[str, int]" = OrderedDict()
        self.itow: "OrderedDict[int, str]" = OrderedDict()
        for i, w in enumerate(self.SPECIAL):
            self.wtoi[w] = i
            self.itow[i] = w
        words = set()
        for ws in word_sets:
            words.update(ws)
        for i, w in enumerate(sorted(words)):
            j = i + len(self.SPECIAL)
            self.wtoi[w] = j
            self.itow[j] = w

    def __len__(self) -> int:
        return len(self.wtoi)

    def __contains__(self, w: str) -> bool:
        return w in self.wtoi

    def get(self, w: str) -> int:
        return self.wtoi.get(w, 1)  # 1 = <UNK>
