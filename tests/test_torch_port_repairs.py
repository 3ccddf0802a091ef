"""Two results in which the port differed from the JAX package, held here
against it on the CPU:

* the vocabulary's tokenizer (the port split on whitespace only, so "dog."
  became one unknown word): ``data/tokenizer.py`` against the JAX package's
  ``tokenize_py`` on the golden fixture, and the port's ``Vocabulary``
  against the JAX ``Vocabulary`` on punctuated captions;
* sampled serving (the port advanced one generator from batch to batch):
  every batch samples with a generator seeded afresh, as the JAX CLI's
  closed-over ``PRNGKey(seed)`` does, so one batch captioned twice gives the
  same tokens.
"""

import numpy as np
import pytest
import torch

from imagecaptioner_tpu.data.tokenizer import tokenize_py
from imagecaptioner_tpu.data.vocabulary import Vocabulary as JVocabulary
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.data.tokenizer import tokenize
from imagecaptioner_tpu_torch.data.vocabulary import UNK, Vocabulary
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.utils.convert import jax_student_to_state_dict
from test_tokenizer_golden import GOLDEN

CAPTIONS = [
    "A dog runs.", "A dog runs across the grass.", "The dog's ball, red.",
    "Two dogs (brown/white) play!", "A well-known man can't swim...",
    "A dog runs.", "A child's toy-car; a dog runs.", "Dogs run, dogs play.",
    "A dog runs!", "the dog's ball is red.", "He cannot swim.",
    "A dog runs across the grass .",
]


@pytest.mark.parametrize("text,expected", GOLDEN,
                         ids=[t[:24] for t, _ in GOLDEN])
def test_port_tokenizer_matches_jax_on_the_golden_fixture(text, expected):
    assert tokenize(text) == tokenize_py(text) == expected
    assert Vocabulary.tokenizer_eng(text) == expected


def test_vocabulary_matches_jax_on_punctuated_captions():
    ref, got = JVocabulary(freq_threshold=2), Vocabulary(freq_threshold=2)
    ref.build_vocabulary(CAPTIONS)
    got.build_vocabulary(CAPTIONS)
    assert got.stoi == ref.stoi and got.itos == ref.itos
    assert "dog" in got.stoi and "." in got.stoi  # "dog." is two words
    for text in CAPTIONS + ["A cat runs.", "Zebras!"]:
        assert got.encode_caption(text) == ref.encode_caption(text)
        assert got.numericalize(text) == ref.numericalize(text)
    assert got.numericalize("A dog runs.") == [
        got.stoi["a"], got.stoi["dog"], got.stoi["runs"], got.stoi["."]]
    assert UNK not in got.numericalize("A dog runs.")


def test_sampled_captioner_repeats_a_batch():
    """Temperature 2: the same uint8 batch through one captioner twice gives
    identical tokens, and the tokens are those of a generator seeded with
    ``seed`` for that batch alone."""
    V, E, H = 40, 16, 24
    cfg = PC.full_student_config(V, embed_size=E, hidden_size=H)
    params, state = student_init(0, cfg)
    model = Student(cfg)
    model.load_state_dict(jax_student_to_state_dict(params, state, cfg),
                          strict=True)
    model.eval()
    images = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    caption = serve.make_greedy_captioner(model, cfg, "cpu", max_length=8,
                                          temperature=2.0, seed=5)
    first, second = caption(images), caption(images)
    np.testing.assert_array_equal(first, second)
    other = serve.make_greedy_captioner(model, cfg, "cpu", max_length=8,
                                        temperature=2.0, seed=6)(images)
    assert not np.array_equal(first, other)  # the seed does reach the sampler
