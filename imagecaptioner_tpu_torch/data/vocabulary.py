"""Vocabulary lookup for serving, with the JSON schema of
``imagecaptioner_tpu.data.vocabulary``.

Only what serving needs: load a saved vocabulary and map ids back to words.
Building a vocabulary needs the tokenizer and stays with the JAX package.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List

PAD, START, END, UNK = 0, 1, 2, 3
SPECIALS = {0: "<PAD>", 1: "<START>", 2: "<END>", 3: "<UNK>"}


class Vocabulary:
    def __init__(self, freq_threshold: int = 5):
        self.itos: Dict[int, str] = dict(SPECIALS)
        self.stoi: Dict[str, int] = {v: k for k, v in SPECIALS.items()}
        self.freq_threshold = freq_threshold

    def __len__(self) -> int:
        return len(self.itos)

    def decode(self, ids: Iterable[int], *, strip_specials: bool = True
               ) -> List[str]:
        words = []
        for i in ids:
            i = int(i)
            if strip_specials and i in (PAD, START, END):
                continue
            words.append(self.itos.get(i, "<UNK>"))
        return words

    def to_json(self) -> str:
        return json.dumps({
            "freq_threshold": self.freq_threshold,
            "itos": {str(k): v for k, v in self.itos.items()},
        })

    @classmethod
    def from_json(cls, s: str) -> "Vocabulary":
        d = json.loads(s)
        v = cls(d["freq_threshold"])
        v.itos = {int(k): w for k, w in d["itos"].items()}
        v.stoi = {w: i for i, w in v.itos.items()}
        return v

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Vocabulary":
        with open(path) as f:
            return cls.from_json(f.read())
