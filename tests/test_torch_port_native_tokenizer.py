"""The port's native caption tokenizer (``imagecaptioner_tpu_torch/native``:
its own copy of ``tokenizer.cpp``, built by ``g++`` at first use) against
the port's ``tokenize_py``, the JAX package's ``tokenize_py`` and the JAX
package's ``native.tokenize_native``, token for token.

The port's library is built into a ``tmp_path`` directory here, never into
the package.  The JAX library is only read: its build function is replaced
for the test by one that refuses, and the one comparison that needs it is
skipped if no built library is there.
"""

import ctypes
import random
import string
import types

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from imagecaptioner_tpu.data.tokenizer import tokenize_py as jax_tokenize_py
from imagecaptioner_tpu_torch import native as NT
from imagecaptioner_tpu_torch.data import tokenizer as TK
from imagecaptioner_tpu_torch.data.vocabulary import Vocabulary

# tests/test_native.py's alphabet and cases
ALPHABET = string.ascii_letters + " .,!?'\"-/()[]{}0123456789   "
CASES = ["A dog runs .", "A dog runs.", "Two dogs, one ball!", "don't stop",
         "it's a man's hat", "blue-eyed child", '"hello" (world)',
         "I'm running", "they'll we've you're he'd", "", "   ", "a---b",
         "...", "$100 (50%)", "and/or this-or-that", "U.K. u.s.a. 9. a.",
         "Cannot gonna gotta wanna lemme gimme", "a dog... runs..",
         "Café naïve résumé"]
WORDS = ["A", "dog", "runs", "on", "the", "grass", "don't", "it's",
         "blue-eyed", "child's", "two", "dogs,", "ball!", '"quote"',
         "(paren)", "and/or", "U.S.", "cannot", "well...", "mid-air"]


@pytest.fixture(scope="module")
def port_native(tmp_path_factory):
    """The port's library, built by g++ into a temporary directory."""
    mp = pytest.MonkeyPatch()
    mp.setattr(NT, "BUILD", tmp_path_factory.mktemp("native_build"))
    mp.setattr(NT, "_lib", None)
    mp.setattr(NT, "_tried", False)
    if not NT.native_available():
        mp.undo()
        pytest.fail("the port's native tokenizer did not build with g++")
    yield NT
    mp.undo()


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's tokenize_native on its library as built, never
    rebuilding it; None if there is none."""
    from imagecaptioner_tpu import native as JN

    mp = pytest.MonkeyPatch()
    mp.setattr(JN, "_build", lambda: False)
    mp.setattr(JN, "_lib", None)
    mp.setattr(JN, "_tried", False)
    try:
        yield JN.tokenize_native if JN.native_available() else None
    finally:
        mp.undo()


def test_library_is_built_from_the_ports_source(port_native, tmp_path):
    """The library sits in the build directory under a name that hashes
    the port's own source and flags; the source is the package's copy."""
    path = port_native.library_path()
    assert path.parent == port_native.BUILD and path.exists()
    assert path.name.startswith("libtokenizer-") and path.suffix == ".so"
    assert port_native.SRC.parent.name == "native"
    assert port_native.SRC.parent.parent.name == "imagecaptioner_tpu_torch"
    assert "ic_tokenize" in port_native.SRC.read_text()


@pytest.mark.parametrize("text", CASES)
def test_native_matches_python_on_cases(port_native, text):
    got = port_native.tokenize_native(text)
    assert got == TK.tokenize_py(text) == jax_tokenize_py(text)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.text(alphabet=ALPHABET, max_size=60))
def test_native_fuzz_matches_both_python_tokenizers(port_native, text):
    assert port_native.tokenize_native(text) == TK.tokenize_py(text) \
        == jax_tokenize_py(text)


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.sampled_from(WORDS), min_size=1, max_size=12))
def test_native_caption_like_fuzz(port_native, words):
    text = " ".join(words) + " ."
    assert port_native.tokenize_native(text) == TK.tokenize_py(text)


def test_native_matches_jax_native(port_native, jax_native):
    """The port's library against the JAX package's, on the cases and a
    seeded fuzz set of both kinds."""
    if jax_native is None:
        pytest.skip("the JAX package's native tokenizer is not built")
    rng = random.Random(0)
    texts = list(CASES)
    texts += ["".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 60)))
              for _ in range(500)]
    texts += [" ".join(rng.choice(WORDS) for _ in range(rng.randint(1, 12)))
              + " ." for _ in range(300)]
    for text in texts:
        assert port_native.tokenize_native(text) == jax_native(text), text


def test_buffer_overflow_retries_with_a_larger_buffer(port_native,
                                                      monkeypatch):
    """A call whose output does not fit returns -1 and is retried with a
    four times larger buffer; a long text still tokenizes whole."""
    lib = port_native._load()
    data = b"a-b " * 200
    small = ctypes.create_string_buffer(16)
    assert lib.ic_tokenize(data, small, 16) == -1
    calls = []

    def tight(text, buf, cap):
        calls.append(cap)
        return -1 if len(calls) == 1 else lib.ic_tokenize(text, buf, cap)

    monkeypatch.setattr(port_native, "_lib",
                        types.SimpleNamespace(ic_tokenize=tight))
    text = "A blue-eyed child's dog... runs (fast)! " * 50
    assert port_native.tokenize_native(text) == TK.tokenize_py(text)
    assert calls[1] == 4 * calls[0]
    monkeypatch.setattr(port_native, "_lib", types.SimpleNamespace(
        ic_tokenize=lambda text, buf, cap: -1))
    with pytest.raises(RuntimeError, match="overflow"):
        port_native.tokenize_native("a b")


def test_tokenize_takes_the_native_library_and_python_alike(port_native,
                                                            monkeypatch):
    """``tokenize`` runs the native library when it builds and
    ``tokenize_py`` under ``IC_NO_NATIVE=1`` or when it does not, and the
    vocabulary built either way is the same."""
    captions = [" ".join(random.Random(i).choice(WORDS) for _ in range(8))
                for i in range(200)]
    vocabs = []
    for env, available in (("0", True), ("1", True), ("0", False)):
        monkeypatch.setenv("IC_NO_NATIVE", env)
        monkeypatch.setattr(TK, "_native_checked", False)
        monkeypatch.setattr(TK, "_native_tokenize", None)
        monkeypatch.setattr(port_native, "native_available",
                            lambda available=available: available)
        TK.tokenize("warm")
        assert (TK._native_tokenize is port_native.tokenize_native) == (
            env == "0" and available)
        vocab = Vocabulary(freq_threshold=3)
        vocab.build_vocabulary(captions)
        vocabs.append(vocab.stoi)
    assert vocabs[0] == vocabs[1] == vocabs[2] and len(vocabs[0]) > 10


def test_native_unavailable_raises(monkeypatch):
    """Without a library (no g++) ``tokenize_native`` raises and
    ``native_available`` is False."""
    monkeypatch.setattr(NT, "_lib", None)
    monkeypatch.setattr(NT, "_tried", True)
    assert not NT.native_available()
    with pytest.raises(RuntimeError, match="unavailable"):
        NT.tokenize_native("a dog")
