"""The port's building blocks against imagecaptioner_tpu.core.modules.

Inputs come from numpy seeds and go to both sides; everything runs at
float32 on the CPU, where the port takes its plain versions.  atol 1e-5:
the two sides sum in different orders at float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core import config as JC
from imagecaptioner_tpu.core import modules as JM
from imagecaptioner_tpu.data.vocabulary import Vocabulary as JVocabulary
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core import modules as PM
from imagecaptioner_tpu_torch.data.vocabulary import Vocabulary

ATOL = 1e-5


def _np(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=atol, rtol=0)


def test_dense():
    x, w, b = _np(3, 5, 16, seed=1), _np(24, 16, seed=2), _np(24, seed=3)
    ref = JM.dense({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                   jnp.asarray(x))
    _close(PM.dense(_t(x), _t(w), _t(b)), ref)
    lin = PM.Linear(16, 24)
    lin.load_state_dict({"weight": _t(w), "bias": _t(b)})
    _close(lin(_t(x)), ref)


def test_layer_norm():
    x = _np(4, 7, 32, seed=4, scale=3.0) + 1.5
    w, b = _np(32, seed=5), _np(32, seed=6)
    ref = JM.layer_norm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                        jnp.asarray(x))
    _close(PM.layer_norm(_t(x), _t(w), _t(b)), ref)


def test_embedding():
    table = _np(50, 8, seed=7)
    ids = np.array([[0, 3, 49], [7, 7, 1]], np.int32)
    ref = JM.embedding({"weight": jnp.asarray(table)}, jnp.asarray(ids))
    _close(PM.embedding(_t(table), torch.from_numpy(ids).long()), ref, atol=0)


@pytest.mark.parametrize("stride,padding,k", [(1, 0, 1), (2, 3, 7), (2, 1, 3)])
def test_conv2d_nchw(stride, padding, k):
    x = _np(2, 6, 13, 13, seed=8)                  # NCHW
    w = _np(10, 6, k, k, seed=9, scale=0.2)        # OIHW
    ref = JM.conv2d({"weight": jnp.asarray(w)},
                    jnp.asarray(x.transpose(0, 2, 3, 1)),
                    stride=stride, padding=padding)
    got = PM.conv2d(_t(x), _t(w), stride=stride, padding=padding)
    _close(got.permute(0, 2, 3, 1), ref)


def test_batch_norm_eval():
    x = _np(2, 8, 5, 5, seed=10)
    w, b = _np(8, seed=11), _np(8, seed=12)
    mean = _np(8, seed=13)
    var = np.abs(_np(8, seed=14)) + 0.5
    ref, _ = JM.batch_norm({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                           {"running_mean": jnp.asarray(mean),
                            "running_var": jnp.asarray(var)},
                           jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    got = PM.batch_norm(_t(x), _t(w), _t(b), _t(mean), _t(var))
    _close(got.permute(0, 2, 3, 1), ref)


def test_max_pool2d():
    x = _np(2, 4, 11, 11, seed=15)
    ref = JM.max_pool2d(jnp.asarray(x.transpose(0, 2, 3, 1)), 3, 2, 1)
    _close(PM.max_pool2d(_t(x), 3, 2, 1).permute(0, 2, 3, 1), ref, atol=0)


@pytest.mark.parametrize("hw", [(2, 2), (7, 7), (9, 11)])
def test_adaptive_avg_pool2d(hw):
    x = _np(2, 5, *hw, seed=16)
    ref = JM.adaptive_avg_pool2d(jnp.asarray(x.transpose(0, 2, 3, 1)), (7, 7))
    got = PM.adaptive_avg_pool2d(_t(x), (7, 7))
    assert got.shape == (2, 5, 7, 7)
    _close(got.permute(0, 2, 3, 1), ref)


@pytest.mark.parametrize("lq,lk,causal", [(9, 9, False), (5, 12, False),
                                          (9, 9, True)])
def test_multi_head_attention(lq, lk, causal):
    E, H = 32, 4
    w_in, b_in = _np(3 * E, E, seed=17, scale=0.2), _np(3 * E, seed=18)
    w_out, b_out = _np(E, E, seed=19, scale=0.2), _np(E, seed=20)
    q, kv = _np(2, lq, E, seed=21), _np(2, lk, E, seed=22)
    jp = {"in_proj_weight": jnp.asarray(w_in), "in_proj_bias": jnp.asarray(b_in),
          "out_proj": {"weight": jnp.asarray(w_out), "bias": jnp.asarray(b_out)}}
    ref, _ = JM.multi_head_attention(jp, jnp.asarray(q), jnp.asarray(kv),
                                     jnp.asarray(kv), num_heads=H,
                                     causal=causal, attn_impl="xla")
    mha = PM.MultiheadAttention(E, H)
    mha.load_state_dict({"in_proj_weight": _t(w_in), "in_proj_bias": _t(b_in),
                         "out_proj.weight": _t(w_out),
                         "out_proj.bias": _t(b_out)}, strict=True)
    _close(mha(_t(q), _t(kv), _t(kv), causal=causal), ref)


def test_student_config_matches_jax_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(JC.StudentConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(PC.StudentConfig)]
    assert pf == jf
    over = dict(embed_size=16, hidden_size=24)
    assert (dataclasses.asdict(PC.full_student_config(2994, **over))
            == dataclasses.asdict(JC.full_student_config(2994, **over)))
    assert (dataclasses.asdict(PC.full_student_config(2994))
            == dataclasses.asdict(JC.full_student_config(2994)))


def test_vocabulary_json_round_trip(tmp_path):
    jv = JVocabulary(freq_threshold=2)
    jv.build_vocabulary(["a dog runs", "a dog sits", "the cat sits", "a cat"])
    path = tmp_path / "vocab.json"
    jv.save(str(path))
    pv = Vocabulary.load(str(path))
    assert pv.itos == jv.itos and pv.stoi == jv.stoi
    ids = [1, 4, 5, 3, 99, 2, 0, 0]
    assert pv.decode(ids) == jv.decode(ids)
    back = JVocabulary.from_json(pv.to_json())
    assert back.itos == jv.itos and back.freq_threshold == 2


def test_numpy_init_bounds():
    rng = np.random.default_rng(0)
    lin = PM.linear_init(rng, 64, 8)
    assert lin["weight"].shape == (8, 64) and np.abs(lin["weight"]).max() <= 1 / 8
    q = PM.orthogonal(rng, (32, 8))
    np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-5)
    jq = np.asarray(JM.orthogonal(jax.random.PRNGKey(0), (32, 8)))
    assert jq.shape == q.shape
