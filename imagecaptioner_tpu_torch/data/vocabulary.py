"""Vocabulary with the ordering rule and the JSON schema of
``imagecaptioner_tpu.data.vocabulary``.

Serving loads a saved vocabulary and maps ids back to words.  Training on
the in-memory synthetic data also builds one: ``build_vocabulary`` adds a
word when its running count reaches ``freq_threshold``, with ids in
first-reached order from 4.  Its tokenizer is the rule-based one of
``data/tokenizer.py``, the port's copy of the JAX package's ``tokenize_py``,
so a saved ``vocab.json`` encodes punctuated captions to the same ids in
both packages.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List

from imagecaptioner_tpu_torch.data.tokenizer import tokenize

PAD, START, END, UNK = 0, 1, 2, 3
SPECIALS = {0: "<PAD>", 1: "<START>", 2: "<END>", 3: "<UNK>"}


class Vocabulary:
    def __init__(self, freq_threshold: int = 5):
        self.itos: Dict[int, str] = dict(SPECIALS)
        self.stoi: Dict[str, int] = {v: k for k, v in SPECIALS.items()}
        self.freq_threshold = freq_threshold

    def __len__(self) -> int:
        return len(self.itos)

    @staticmethod
    def tokenizer_eng(text: str) -> List[str]:
        return tokenize(text)

    def build_vocabulary(self, sentence_list: Iterable[str]) -> None:
        """First-reached-threshold insertion order."""
        frequencies: Dict[str, int] = {}
        idx = len(self.itos)
        for sentence in sentence_list:
            for word in tokenize(sentence):
                frequencies[word] = frequencies.get(word, 0) + 1
                if frequencies[word] == self.freq_threshold:
                    self.stoi[word] = idx
                    self.itos[idx] = word
                    idx += 1

    def numericalize(self, text: str) -> List[int]:
        return [self.stoi.get(tok, UNK) for tok in tokenize(text)]

    def encode_caption(self, text: str) -> List[int]:
        """<START> + tokens + <END> framing."""
        return [START] + self.numericalize(text) + [END]

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
