"""Rule-based English tokenizer: the port's own copy of
``imagecaptioner_tpu/data/tokenizer.py`` (``tokenize_py`` and its helpers,
pure ``re``; ``tokenize``), so that the port's vocabulary tokenizes exactly
as the JAX package's does without importing it.

It reproduces the subset of spaCy's English tokenizer, lowercased, that
matters for caption text:

  * whitespace split, then per-chunk prefix/suffix punctuation peeling
  * ellipsis runs (2+ dots) kept as ONE token, suffix and infix
  * dotted single-letter acronyms ("u.k.", "u.s.a.") kept whole
  * contraction suffixes (n't, 's, 'm, 're, 've, 'll, 'd)
  * whole-word exceptions (cannot -> can|not, gonna -> gon|na, gotta,
    wanna, lemme, gimme)
  * infix splitting on hyphens and slashes between word characters
  * everything lowercased

``tokenize`` runs the native C++ twin of the same contract
(``native/__init__.py``, the port's copy of ``tokenizer.cpp``) when it
builds, and ``tokenize_py`` otherwise, as the JAX package's ``tokenize``
does; both give the same tokens.
"""

from __future__ import annotations

import os
import re
from typing import List

# Punctuation peeled one char at a time from the front / back of a chunk.
_PREFIX_PUNCT = set("([{\"'`$#@<")
_SUFFIX_PUNCT = set(".,!?:;\"')]}%>")
# Contraction suffixes spaCy splits as their own tokens.
_CONTRACTIONS = ("n't", "'s", "'m", "'re", "'ve", "'ll", "'d")
# Whole-word splits from spaCy's English tokenizer_exceptions.
_EXCEPTIONS = {
    "cannot": ("can", "not"),
    "gonna": ("gon", "na"),
    "gotta": ("got", "ta"),
    "wanna": ("wan", "na"),
    "lemme": ("lem", "me"),
    "gimme": ("gim", "me"),
}
# Infix separators that become their own tokens between word chars; an
# ellipsis run is a single token.
_INFIX_RE = re.compile(r"(\.{2,}|[\-/])")
_WORDISH_RE = re.compile(r"\w")
# letters only: "u.k." / "a." stay whole, "9." still splits
_ACRONYM_RE = re.compile(r"(?:[^\W\d_]\.)+")


def _split_chunk(chunk: str) -> List[str]:
    prefix: List[str] = []
    suffix: List[str] = []
    while chunk and chunk[0] in _PREFIX_PUNCT:
        prefix.append(chunk[0])
        chunk = chunk[1:]
    while chunk and chunk[-1] in _SUFFIX_PUNCT:
        m = re.search(r"\.{2,}$", chunk)
        if m:  # trailing ellipsis run is ONE token
            suffix.append(m.group(0))
            chunk = chunk[: m.start()]
            continue
        if chunk[-1] == "." and _ACRONYM_RE.fullmatch(chunk):
            break  # dotted acronym keeps its final period ("u.k.")
        suffix.append(chunk[-1])
        chunk = chunk[:-1]
    suffix.reverse()

    middle: List[str] = []
    if chunk:
        lowered = chunk.lower()
        exc = _EXCEPTIONS.get(lowered)
        if exc:
            pos = 0
            for part in exc:
                middle.append(chunk[pos: pos + len(part)])
                pos += len(part)
        else:
            matched = None
            for c in _CONTRACTIONS:
                if lowered.endswith(c) and len(chunk) > len(c):
                    matched = c
                    break
            if matched:
                head = chunk[: -len(matched)]
                middle.extend(_split_infix(head))
                middle.append(chunk[-len(matched):])
            else:
                middle.extend(_split_infix(chunk))
    return prefix + middle + suffix


def _is_sep(p: str) -> bool:
    return p in ("-", "/") or (len(p) >= 2 and set(p) == {"."})


def _split_infix(chunk: str) -> List[str]:
    if not chunk:
        return []
    parts = _INFIX_RE.split(chunk)
    # Only keep the split if the separators sit between wordish chars;
    # otherwise (e.g. a bare "-") return the chunk whole.
    if len(parts) == 1:
        return [chunk]
    out = [p for p in parts if p != ""]
    if all(_WORDISH_RE.search(p) or _is_sep(p) for p in out):
        return out
    return [chunk]


def tokenize_py(text: str) -> List[str]:
    """Tokenize and lowercase in Python, mirroring
    ``[t.text.lower() for t in spacy(...)]`` on caption text."""
    tokens: List[str] = []
    for chunk in str(text).split():
        tokens.extend(_split_chunk(chunk))
    return [t.lower() for t in tokens]


_native_tokenize = None
_native_checked = False


def tokenize(text: str) -> List[str]:
    """Tokenize and lowercase: the C++ tokenizer when it builds
    (token-identical by contract, fuzz-tested), else ``tokenize_py``.
    ``IC_NO_NATIVE=1`` forces Python."""
    global _native_tokenize, _native_checked
    if not _native_checked:
        _native_checked = True
        if os.environ.get("IC_NO_NATIVE") != "1":
            from imagecaptioner_tpu_torch.native import (native_available,
                                                         tokenize_native)

            if native_available():
                _native_tokenize = tokenize_native
    if _native_tokenize is not None:
        return _native_tokenize(text)
    return tokenize_py(text)
