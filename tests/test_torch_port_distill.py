"""The port's distillation losses, feature projector, AdamW, clipping and
schedule against ``imagecaptioner_tpu/distill`` and ``train/optim.py``, on
shared numpy inputs, float32 on the CPU.  Tolerance 1e-5 (losses) and 1e-6
(optimizer): same float32 arithmetic, other summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core.config import DistillConfig as JDistillConfig
from imagecaptioner_tpu.distill import losses as JDL
from imagecaptioner_tpu.distill import projector as JPR
from imagecaptioner_tpu.train import optim as JO
from imagecaptioner_tpu_torch.core.config import DistillConfig
from imagecaptioner_tpu_torch.distill import losses as PDL
from imagecaptioner_tpu_torch.distill import projector as PPR
from imagecaptioner_tpu_torch.train import optim as PO
from imagecaptioner_tpu_torch.utils.convert import (
    jax_projectors_to_state_dict, tree_to_state_dict)

T, B, V = 7, 4, 20
ATOL = 1e-5


@pytest.fixture(scope="module")
def outputs():
    rng = np.random.default_rng(0)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    lengths = np.array([5, 3, 6, 4], np.int32)     # incl. START and END
    targets = rng.integers(4, V, (T, B)).astype(np.int32)
    for b, n in enumerate(lengths):
        targets[n - 1:, b] = 0                      # PAD after the caption
    student = {"logits": r(T, B, V) * 2, "encoder_features": r(B, 9, 8),
               "hidden_states": r(T, B, 12)}
    teacher = {"logits": r(T, B, V) * 2, "encoder_features": r(B, 9, 8),
               "hidden_states": None}
    return student, teacher, targets, lengths


def _j(d):
    return {k: None if v is None else jnp.asarray(v) for k, v in d.items()}


def _p(d):
    return {k: None if v is None else torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("with_lengths", [True, False])
def test_distillation_loss_and_its_terms(outputs, with_lengths):
    student, teacher, targets, lengths = outputs
    jl = jnp.asarray(lengths) if with_lengths else None
    pl = torch.from_numpy(lengths).long() if with_lengths else None
    ref_total, ref = JDL.distillation_loss(_j(student), _j(teacher),
                                           jnp.asarray(targets),
                                           JDistillConfig(), jl)
    got_total, got = PDL.distillation_loss(_p(student), _p(teacher),
                                           torch.from_numpy(targets).long(),
                                           DistillConfig(), pl)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), atol=ATOL,
                                   rtol=0, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(ref_total), atol=ATOL)
    # the preserved quirks: CE weight exactly 0, gamma dead
    assert float(got["hidden_kd_loss"]) == 0.0 and float(got["ce_loss"]) > 0
    np.testing.assert_allclose(
        float(got_total), 0.7 * float(got["token_kd_loss"])
        + 0.2 * float(got["feature_kd_loss"]), atol=ATOL)


def test_hidden_state_term_and_custom_weights(outputs):
    student, teacher, targets, lengths = outputs
    teacher = dict(teacher, hidden_states=np.random.default_rng(1)
                   .standard_normal((T + 2, B, 12)).astype(np.float32))
    jc = JDistillConfig(alpha=0.5, beta=0.2, gamma=0.2, temperature=2.0)
    pc = DistillConfig(alpha=0.5, beta=0.2, gamma=0.2, temperature=2.0)
    ref_total, ref = JDL.distillation_loss(_j(student), _j(teacher),
                                           jnp.asarray(targets), jc,
                                           jnp.asarray(lengths))
    got_total, got = PDL.distillation_loss(_p(student), _p(teacher),
                                           torch.from_numpy(targets).long(),
                                           pc, torch.from_numpy(lengths).long())
    assert float(ref["hidden_kd_loss"]) > 0
    for k in ref:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), atol=ATOL,
                                   rtol=0, err_msg=k)


def test_loss_gradient_matches_jax(outputs):
    student, teacher, targets, lengths = outputs

    def jloss(logits, feats):
        s = dict(_j(student), logits=logits, encoder_features=feats)
        return JDL.distillation_loss(s, _j(teacher), jnp.asarray(targets),
                                     JDistillConfig(), jnp.asarray(lengths))[0]

    ref = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(student["logits"]), jnp.asarray(student["encoder_features"]))
    s = _p(student)
    for k in ("logits", "encoder_features"):
        s[k].requires_grad_(True)
    PDL.distillation_loss(s, _p(teacher), torch.from_numpy(targets).long(),
                          DistillConfig(), torch.from_numpy(lengths).long()
                          )[0].backward()
    np.testing.assert_allclose(s["logits"].grad.numpy(), np.asarray(ref[0]),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(s["encoder_features"].grad.numpy(),
                               np.asarray(ref[1]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("t_dim,s_dim,t_len,s_len", [(16, 8, 17, 9),
                                                     (8, 8, 17, 9),
                                                     (16, 8, 9, 9)])
def test_feature_projector(t_dim, s_dim, t_len, s_len):
    params, meta = JPR.create_feature_projectors(
        jax.random.PRNGKey(0), teacher_embed=t_dim, student_embed=s_dim,
        student_hidden=12, student_seq_len=s_len, teacher_seq_len=t_len)
    params = jax.tree.map(np.asarray, params)
    x = np.random.default_rng(2).standard_normal((3, t_len, t_dim)
                                                 ).astype(np.float32)
    ref = JPR.feature_projector_apply(params["encoder"], jnp.asarray(x),
                                      teacher_seq_len=t_len,
                                      student_seq_len=s_len)
    proj = PPR.make_projectors(t_dim, s_dim, 12)
    proj.load_state_dict(jax_projectors_to_state_dict(params), strict=True)
    with torch.no_grad():
        got = proj.eval()["encoder"](torch.from_numpy(x),
                                     teacher_seq_len=t_len,
                                     student_seq_len=s_len)
    assert got.shape == (3, s_len, s_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    p2, meta2 = PPR.create_feature_projectors(
        0, teacher_embed=t_dim, student_embed=s_dim, student_hidden=12,
        student_seq_len=s_len, teacher_seq_len=t_len)
    assert meta2 == meta
    assert jax.tree.map(np.shape, p2) == jax.tree.map(np.shape, params)


@pytest.mark.parametrize("t", [0.0, 0.37, 4.99, 5.0, 7.5, 14.999, 15.0, 33.3])
def test_cosine_warm_restarts(t):
    kw = dict(base_lr=2e-4, t0=5, t_mult=2, eta_min=1e-6)
    np.testing.assert_allclose(PO.cosine_warm_restarts(t, **kw),
                               float(JO.cosine_warm_restarts(t, **kw)),
                               rtol=2e-5)
    kw1 = dict(base_lr=1e-3, t0=3, t_mult=1, eta_min=0.0)
    np.testing.assert_allclose(PO.cosine_warm_restarts(t, **kw1),
                               float(JO.cosine_warm_restarts(t, **kw1)),
                               rtol=2e-4, atol=1e-9)


def test_adamw_and_clipping_over_three_steps():
    """Mixed lr scales, a schedule, weight decay and a frozen leaf, three
    steps; parameters and both moments after each."""
    rng = np.random.default_rng(3)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    tree = {"a": {"w": r(5, 4), "b": r(5)}, "c": [r(3, 3), r(2)], "f": r(6)}
    scales = {"a": {"w": 0.1, "b": 0.1}, "c": [1.0, 1.0], "f": 1.5}
    trainable = {"a": {"w": True, "b": True}, "c": [True, True], "f": False}
    jp = jax.tree.map(jnp.asarray, tree)
    jstate = JO.adamw_init(jp)
    pp = {k: v.clone() for k, v in tree_to_state_dict(tree).items()}
    pscale = {k: float(v) for k, v in tree_to_state_dict(scales).items()}
    ptrain = {"a.w": True, "a.b": True, "c.0": True, "c.1": True, "f": False}
    pstate = PO.adamw_init(pp)
    for step in range(3):
        grads = jax.tree.map(lambda x: r(*x.shape) * 3, tree)
        t = 0.4 * step
        # JAX side, as the KD step does it: mask, clip, per-leaf schedule
        jg = jax.tree.map(lambda g, tr: jnp.asarray(g) if tr
                          else jnp.zeros_like(g), grads, trainable)
        jg, jnorm = JO.clip_by_global_norm(jg, 1.0)
        lr_tree = jax.tree.map(lambda s: JO.cosine_warm_restarts(
            t, base_lr=2e-4 * s, t0=5, t_mult=2, eta_min=1e-6), scales)
        jp, jstate = JO.adamw_update(jg, jstate, jp, lr=1.0, lr_scale=lr_tree,
                                     weight_decay=0.01, trainable=trainable)
        # the port
        pg = {k: v.clone() for k, v in tree_to_state_dict(grads).items()
              if ptrain[k]}
        pnorm = PO.clip_by_global_norm(pg, 1.0)
        PO.adamw_update(pg, pstate, pp, lr_fn=lambda s: PO.cosine_warm_restarts(
            t, base_lr=2e-4 * s, t0=5, t_mult=2, eta_min=1e-6),
            lr_scale=pscale, weight_decay=0.01, trainable=ptrain)
        np.testing.assert_allclose(float(pnorm), float(jnorm), rtol=1e-6)
        assert pstate.step == int(jstate.step) == step + 1
        for got, ref in ((pp, jp), (pstate.mu, jstate.mu),
                         (pstate.nu, jstate.nu)):
            ref = tree_to_state_dict(jax.tree.map(np.asarray, ref))
            for k in got:
                np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                           atol=1e-6, rtol=1e-5, err_msg=k)
    np.testing.assert_array_equal(pp["f"].numpy(), tree["f"])
    assert float(pstate.mu["f"].abs().max()) == 0.0
    # a small gradient is not scaled up by the clip
    small = {"x": torch.full((4,), 0.1)}
    assert abs(float(PO.clip_by_global_norm(small, 1.0)) - 0.2) < 1e-6
    np.testing.assert_allclose(small["x"].numpy(), 0.1, rtol=1e-6)
