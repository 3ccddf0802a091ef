"""The port's teacher (ViT encoder + transformer decoder) against the JAX
teacher from one converted parameter tree: depth 2, narrow widths, 32x32
images (4 patches + CLS), float32 on the CPU.

Tolerance 2e-5 absolute: the same float32 arithmetic through two encoder
blocks and two decoder layers, summed in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core.config import TeacherConfig as JTeacherConfig
from imagecaptioner_tpu.distill.wrapper import \
    teacher_forward_for_kd as j_teacher_forward_for_kd
from imagecaptioner_tpu.models import teacher as JTM
from imagecaptioner_tpu.models import transformer as JTD
from imagecaptioner_tpu.models import vit as JV
from imagecaptioner_tpu_torch.core.config import TeacherConfig
from imagecaptioner_tpu_torch.distill.wrapper import teacher_forward_for_kd
from imagecaptioner_tpu_torch.models.teacher import Teacher, teacher_init
from imagecaptioner_tpu_torch.utils.convert import jax_teacher_to_state_dict

ATOL = 2e-5
KW = dict(vocab_size=40, embed_size=32, num_heads=2, num_decoder_layers=2,
          dropout=0.15, encoder_dim=24, encoder_depth=2, encoder_heads=2,
          patch_size=16, image_size=32)
B, T = 3, 6


@pytest.fixture(scope="module")
def teachers():
    jcfg = JTeacherConfig(**KW)
    p = jax.tree.map(np.asarray, JTM.teacher_init(jax.random.PRNGKey(0), jcfg))
    cfg = TeacherConfig(**KW)
    model = Teacher(cfg)
    model.load_state_dict(jax_teacher_to_state_dict(p), strict=True)
    rng = np.random.default_rng(1)
    images = rng.standard_normal((B, 3, 32, 32)).astype(np.float32)
    caps = rng.integers(0, 40, (T, B)).astype(np.int32)
    return jcfg, p, cfg, model.eval(), images, caps


def test_vit_features(teachers):
    jcfg, p, _, model, images, _ = teachers
    ref = JV.vit_forward_features(p["encoder"], jnp.asarray(images), jcfg)
    with torch.no_grad():
        got = model.encoder(torch.from_numpy(images))
    assert got.shape == (B, 5, 24)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_decoder_stack(teachers):
    jcfg, p, _, model, _, _ = teachers
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, 32)).astype(np.float32)
    mem = rng.standard_normal((B, 5, 32)).astype(np.float32)
    ref = JTD.decoder_apply(p["decoder"], jnp.asarray(x), jnp.asarray(mem),
                            num_heads=2, tgt_mask=None, tgt_causal=True)
    from imagecaptioner_tpu_torch.models.transformer import decoder_apply
    with torch.no_grad():
        got = decoder_apply(model.decoder, torch.from_numpy(x),
                            torch.from_numpy(mem), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_teacher_logits(teachers):
    jcfg, p, _, model, images, caps = teachers
    ref = JTM.teacher_apply(p, jnp.asarray(images), jnp.asarray(caps), jcfg)
    with torch.no_grad():
        got = model(torch.from_numpy(images), torch.from_numpy(caps).long())
    assert got.shape == (T, B, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_teacher_forward_for_kd(teachers):
    jcfg, p, _, model, images, caps = teachers
    ref = j_teacher_forward_for_kd(p, jnp.asarray(images), jnp.asarray(caps),
                                   jcfg)
    model.train()      # the wrapper runs the teacher in eval mode regardless
    got = teacher_forward_for_kd(model, torch.from_numpy(images),
                                 torch.from_numpy(caps).long())
    assert model.training
    model.eval()
    assert got["hidden_states"] is None and ref["hidden_states"] is None
    for k in ("logits", "encoder_features"):
        assert got[k].dtype == torch.float32 and not got[k].requires_grad
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=ATOL, rtol=0)


def test_numpy_teacher_init_has_the_jax_tree_layout(teachers):
    _, p, cfg, _, _, _ = teachers
    p2 = teacher_init(0, cfg)
    assert jax.tree.structure(p2) == jax.tree.structure(p)
    assert jax.tree.map(np.shape, p2) == jax.tree.map(np.shape, p)
    Teacher(cfg).load_state_dict(jax_teacher_to_state_dict(p2), strict=True)
    same = TeacherConfig(**{**KW, "encoder_dim": 32})
    assert "encoder_projection" not in teacher_init(0, same)
    assert Teacher(same).encoder_projection is None
