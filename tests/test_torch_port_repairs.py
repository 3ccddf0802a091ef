"""Results in which the port differed from the JAX package, held here
against it on the CPU:

* the vocabulary's tokenizer (the port split on whitespace only, so "dog."
  became one unknown word): ``data/tokenizer.py`` against the JAX package's
  ``tokenize_py`` on the golden fixture, and the port's ``Vocabulary``
  against the JAX ``Vocabulary`` on punctuated captions;
* sampled serving (the port advanced one generator from batch to batch):
  every batch samples with a generator seeded afresh, as the JAX CLI's
  closed-over ``PRNGKey(seed)`` does, so one batch captioned twice gives the
  same tokens;
* ``dense`` at bf16 (the card's form multiplies bf16 operands with a
  float32 result; the CPU form kept here widens them to float32 for the
  same values): against JAX ``modules.dense`` to one bf16 ulp;
* the KD trainer's command line: the reference's ``--no-data-parallel``
  (data parallelism on by default, a no-op on one device) and
  ``--stream-steps`` passed on;
* ``monitoring_bleu`` lives in ``eval/metrics.py``, as in the reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core import modules as JM
from imagecaptioner_tpu.data.tokenizer import tokenize_py
from imagecaptioner_tpu.eval import metrics as JMET
from imagecaptioner_tpu.data.vocabulary import Vocabulary as JVocabulary
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core import modules as PM
from imagecaptioner_tpu_torch.data.tokenizer import tokenize
from imagecaptioner_tpu_torch.data.vocabulary import UNK, Vocabulary
from imagecaptioner_tpu_torch.eval import metrics as PMET
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.train import train_student_kd as TK
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


@pytest.mark.parametrize("bias", [True, False])
def test_dense_bf16_matches_jax_to_one_ulp(bias):
    """bf16 activations, float32 weights: the port's CPU form against JAX
    ``modules.dense`` (bf16 operands, float32 accumulation, float32 bias,
    one rounding), elementwise within one bf16 ulp of the JAX value."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3, 7, 64)).astype(np.float32)
    w = rng.standard_normal((48, 64)).astype(np.float32) * 0.2
    b = rng.standard_normal(48).astype(np.float32)
    p = {"weight": jnp.asarray(w)}
    if bias:
        p["bias"] = jnp.asarray(b)
    ref = np.asarray(JM.dense(p, jnp.asarray(x, jnp.bfloat16)
                              ).astype(jnp.float32))
    got = PM.dense(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w),
                   torch.from_numpy(b) if bias else None)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    # one ulp of bf16 at |v|: 2^(floor(log2|v|) - 7)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= ulp)
    assert np.mean(got == ref) > 0.9


def test_kd_cli_takes_the_reference_flags(monkeypatch):
    """``--no-data-parallel`` (dest data_parallel, default on) and
    ``--stream-steps`` reach the trainer, from a dataset on disk
    (``train_student_with_kd``) and from the in-memory grid
    (``train_student_with_kd_on_loaders``); the port's former
    ``--data-parallel`` is no flag of the reference and is refused."""
    seen = []
    for name in ("train_student_with_kd", "train_student_with_kd_on_loaders"):
        monkeypatch.setattr(TK, name, lambda *a, _n=name, **kw: seen.append(
            dict(kw, called=_n)))
    for base in (["--synthetic-grid", "8", "--image-size", "32"],
                 ["--data-root", "data/flickr8k"]):
        base = base + ["--device", "cpu"]
        seen.clear()
        assert TK.main(base) == 0
        assert TK.main(base + ["--no-data-parallel", "--stream-steps", "3"]) \
            == 0
        assert (seen[0]["data_parallel"], seen[0]["stream_steps"]) == (True, 8)
        assert (seen[1]["data_parallel"], seen[1]["stream_steps"]) == (False, 3)
        assert seen[0]["called"] == ("train_student_with_kd_on_loaders"
                                     if "--synthetic-grid" in base
                                     else "train_student_with_kd")
        with pytest.raises(SystemExit):
            TK.main(base + ["--data-parallel"])


@pytest.mark.parametrize("pred,target", [
    ([4, 5, 2], [4, 2, 0]), ([5], [4]), ([1, 2, 0], [0, 1]),
    ([4, 4, 5, 9], [5, 4, 3, 2]), ([], [4])])
def test_monitoring_bleu_in_eval_metrics_matches_jax(pred, target):
    class V:
        itos = {0: "<PAD>", 1: "<START>", 2: "<END>", 4: "dog", 5: "runs"}

    assert PMET.monitoring_bleu(pred, target, V()) == \
        JMET.monitoring_bleu(pred, target, V())
