"""The slice as a whole: one KD train step and one eval step of the port
against ``imagecaptioner_tpu/train/steps.py``, from one student, one teacher,
one projector set and one AdamW state, on the same uint8 batch (A=2, B=2,
64x64 images; ResNet-50's widths are fixed, so the images shrink instead).

Float32 compute, augmentation off (``AugmentConfig()``), dropout off on both
sides: the student is built with dropout 0, and the dropout function itself
is made the identity (the encoder's 0.2 and the refinement's and
projector's 0.1 are hard-coded in both packages, and ``jax.random`` masks
cannot be reproduced in torch).  Off the TPU the JAX step takes its
``lax.scan`` decoder, which the JAX tests hold equal to the kernel path.

Tolerances are stated where they are used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core import modules as JM
from imagecaptioner_tpu.core.config import (DistillConfig as JDistillConfig,
                                            KDTrainConfig as JKDTrainConfig,
                                            TeacherConfig as JTeacherConfig,
                                            full_student_config as j_full)
from imagecaptioner_tpu.data import transforms as JT
from imagecaptioner_tpu.distill.projector import \
    create_feature_projectors as j_projectors
from imagecaptioner_tpu.models import student as JSM
from imagecaptioner_tpu.models import teacher as JTM
from imagecaptioner_tpu.train import optim as JO
from imagecaptioner_tpu.train import steps as JS
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core import modules as PM
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.distill.losses import LOSS_NAMES
from imagecaptioner_tpu_torch.distill.projector import make_projectors
from imagecaptioner_tpu_torch.models.student import Student
from imagecaptioner_tpu_torch.models.teacher import Teacher
from imagecaptioner_tpu_torch.train import steps as PS
from imagecaptioner_tpu_torch.utils import convert as CV

V, E, H = 30, 16, 24
A, B, TCAP, S = 2, 2, 8, 64
TKW = dict(vocab_size=V, embed_size=32, num_heads=2, num_decoder_layers=1,
           dropout=0.15, encoder_dim=24, encoder_depth=1, encoder_heads=2,
           patch_size=16, image_size=S)
SCHED_T = 0.25


def _np_tree(t):
    # copies: the port updates its tensors in place
    return jax.tree.map(lambda x: np.array(x, copy=True), t)


def _batch():
    rng = np.random.default_rng(5)
    caps = np.zeros((A, TCAP, B), np.int32)
    lengths = rng.integers(4, TCAP + 1, (A, B)).astype(np.int32)
    for a in range(A):
        for b in range(B):
            n = lengths[a, b]
            caps[a, :n, b] = [1] + list(rng.integers(4, V, n - 2)) + [2]
    return {"images": rng.integers(0, 256, (A, B, S, S, 3), dtype=np.uint8),
            "captions": caps, "lengths": lengths}


@pytest.fixture(scope="module")
def run():
    """Both packages take one train step and one eval step; everything the
    tests compare is gathered here once (the JAX step compiles a ResNet-50
    backward: the dear part)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JM, "dropout", lambda rng, x, rate, train: x)
    try:
        jt_cfg = JTeacherConfig(**TKW)
        js_cfg = j_full(V, embed_size=E, hidden_size=H, dropout=0.0)
        jtr = JKDTrainConfig(dropout=0.0)
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        t_params = JTM.teacher_init(k1, jt_cfg)
        s_params, s_state = JSM.student_init(k2, js_cfg)
        proj, _ = j_projectors(k3, teacher_embed=32, student_embed=E,
                               student_hidden=H, student_seq_len=49,
                               teacher_seq_len=jt_cfg.num_tokens)
        params = {"student": s_params, "projectors": proj}
        start = _np_tree((t_params, params, s_state))
        batch = _batch()

        jstep = JS.make_kd_train_step(jt_cfg, js_cfg, JDistillConfig(), jtr,
                                      aug=JT.AugmentConfig(),
                                      compute_dtype=jnp.float32)
        jstate = JS.TrainState(params, JO.adamw_init(params), s_state)
        jstate, jmetrics = jstep(
            jstate, t_params, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.float32(SCHED_T), jnp.int32(0), jax.random.PRNGKey(1))
        jeval = JS.make_kd_eval_step(jt_cfg, js_cfg, JDistillConfig(),
                                     compute_dtype=jnp.float32)
        one = {k: jnp.asarray(v[0]) for k, v in batch.items()}
        jev = jeval(jstate.params, jstate.model_state, t_params, one,
                    jnp.int32(0))
        jax_side = dict(
            metrics={k: float(v) for k, v in jmetrics.items()},
            params=_np_tree(jstate.params), mstate=_np_tree(jstate.model_state),
            mu=_np_tree(jstate.opt_state.mu), nu=_np_tree(jstate.opt_state.nu),
            step=int(jstate.opt_state.step), eval_loss=float(jev[0]),
            eval_ld={k: float(v) for k, v in jev[1].items()},
            preds=np.asarray(jev[2]), cap_tgt=np.asarray(jev[3]))
    finally:
        mp.undo()

    t0, p0, s0 = start
    t_cfg = PC.TeacherConfig(**TKW)
    s_cfg = PC.full_student_config(V, embed_size=E, hidden_size=H, dropout=0.0)
    teacher = Teacher(t_cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(t0), strict=True)
    student = Student(s_cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(
        p0["student"], s0, s_cfg), strict=True)
    projectors = make_projectors(32, E, H)
    projectors.load_state_dict(CV.jax_projectors_to_state_dict(
        p0["projectors"]), strict=True)
    state = PS.init_train_state(student, projectors, s_cfg)
    named = state.named_parameters()
    step0, mu0, nu0 = CV.jax_adamw_to_state(
        {"step": 0, "mu": jax.tree.map(np.zeros_like, p0),
         "nu": jax.tree.map(np.zeros_like, p0)}, named)
    assert step0 == 0 and set(mu0) == set(named) == set(nu0)
    pstep = PS.make_kd_train_step(teacher.eval(), t_cfg, s_cfg,
                                  PC.DistillConfig(),
                                  PC.KDTrainConfig(dropout=0.0),
                                  aug=PT.AugmentConfig(),
                                  compute_dtype=torch.float32)
    with PM.no_dropout():
        metrics = pstep(state, PS.batch_to_device(batch, "cpu"), SCHED_T,
                        None)
    peval = PS.make_kd_eval_step(teacher, t_cfg, s_cfg, PC.DistillConfig())
    ev = peval(state, PS.batch_to_device(
        {k: v[0] for k, v in batch.items()}, "cpu"))
    return dict(jax=jax_side, start=start, state=state, metrics=metrics,
                ev=ev, s_cfg=s_cfg)


def test_metrics_match(run):
    """Loss terms to 1e-5 absolute (float32 sums in another order); the
    learning rate to float32 precision; the gradient norm to 5e-3 relative.
    The norm is dominated by the ResNet's leaves, whose gradients at this
    size are ill-conditioned: two 64x64 images leave layer4's batch norms
    8 samples a channel, and a 1e-6 relative perturbation of the input
    alone moves single ResNet leaf gradients by up to 30% (measured with
    the port against itself)."""
    ref, got = run["jax"]["metrics"], run["metrics"]
    assert set(got) == set(ref) == {"total_loss", "ce_loss", "token_kd_loss",
                                    "feature_kd_loss", "hidden_kd_loss",
                                    "grad_norm", "lr"}
    for k in LOSS_NAMES:
        np.testing.assert_allclose(float(got[k]), ref[k], atol=1e-5, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["grad_norm"]), ref["grad_norm"],
                               rtol=5e-3)
    np.testing.assert_allclose(float(got["lr"]), ref["lr"], rtol=1e-5)
    assert float(got["hidden_kd_loss"]) == 0.0


def _flat(tree):
    return {k: v.numpy() for k, v in CV.tree_to_state_dict(tree).items()}


def test_gradients_of_every_leaf_match(run):
    """AdamW's first moment after one step is 0.1 x the clipped mean
    gradient; times each side's own gradient norm it is the unclipped
    gradient of every leaf.  Outside the ResNet each leaf agrees to 2e-4 of
    its largest entry (float32, other summation order, and the noise the
    ResNet's features carry into the other leaves).  The ResNet's own
    leaves are ill-conditioned at this size (see ``test_metrics_match``):
    each agrees to 10% in the L2 norm, which still tells a wrong sign, a
    missing term or a wrong scale."""
    ref_mu, ref_nu = _flat(run["jax"]["mu"]), _flat(run["jax"]["nu"])
    st = run["state"].opt_state
    assert st.step == run["jax"]["step"] == 1
    assert set(st.mu) == set(ref_mu)
    n_ref = run["jax"]["metrics"]["grad_norm"]
    n_got = float(run["metrics"]["grad_norm"])
    assert n_ref > 1.0 and n_got > 1.0          # both sides clipped
    for k, ref in ref_mu.items():
        g_ref, g_got = ref * n_ref, st.mu[k].numpy() * n_got
        v_ref, v_got = ref_nu[k] * n_ref ** 2, st.nu[k].numpy() * n_got ** 2
        if ".resnet." in k:
            assert (np.linalg.norm(g_got - g_ref)
                    <= 0.1 * np.linalg.norm(g_ref) + 1e-9), k
            assert (np.linalg.norm(v_got - v_ref)
                    <= 0.2 * np.linalg.norm(v_ref) + 1e-12), k
        else:
            np.testing.assert_allclose(
                g_got, g_ref, atol=2e-4 * np.abs(g_ref).max() + 1e-9, rtol=0,
                err_msg=k)
            np.testing.assert_allclose(
                v_got, v_ref, atol=4e-4 * np.abs(v_ref).max() + 1e-14, rtol=0,
                err_msg=k)


GROUPS = {"encoder": ("student.encoder.", 0.1),
          "decoder": ("student.decoder.", 1.0),
          "others": ("student.attention_refinement.", 1.0),
          "projectors": ("projectors.", 1.0)}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_updated_parameters_match_per_lr_group(run, group):
    """After one AdamW step a parameter has moved by about lr_leaf x
    sign(gradient): entries whose gradient is well above the float32 noise
    must agree to 2% of that step, which tells the three learning-rate
    groups apart (they differ tenfold); every entry agrees to within one
    full step, since a noise-level gradient may flip its sign.  In the
    ResNet's ill-conditioned leaves (see ``test_metrics_match``) a few
    clear entries flip too: 99% of each leaf's must agree."""
    prefix, scale = GROUPS[group]
    lr = PC.KDTrainConfig().learning_rate * scale   # upper bound of the step
    ref = _flat(run["jax"]["params"])
    start = _flat(run["start"][1])
    mu = _flat(run["jax"]["mu"])
    named = run["state"].named_parameters()
    moved = checked = 0
    for k, p in named.items():
        if not k.startswith(prefix) or not p.requires_grad:
            continue
        got = p.detach().numpy()
        np.testing.assert_allclose(got, ref[k], atol=2.1 * lr, rtol=0,
                                   err_msg=k)
        clear = np.abs(mu[k]) > max(1e-2 * np.abs(mu[k]).max(), 1e-8)
        if clear.any():
            close = np.abs(got[clear] - ref[k][clear]) <= 0.02 * lr
            assert close.mean() >= (0.99 if ".resnet." in k else 1.0), k
            checked += int(clear.sum())
        moved += int((got != start[k]).sum())
    assert moved > 0 and checked > 0


def test_frozen_leaves_did_not_move(run):
    start = _flat(run["start"][1])
    ref = _flat(run["jax"]["params"])
    frozen = [k for k, p in run["state"].named_parameters().items()
              if not p.requires_grad]
    assert frozen and all(k.startswith("student.encoder.resnet.")
                          for k in frozen)
    assert any(".layer2." in k for k in frozen)
    assert not any(".layer3." in k or ".layer4." in k for k in frozen)
    for k in frozen:
        got = run["state"].named_parameters()[k].detach().numpy()
        np.testing.assert_array_equal(got, start[k])
        np.testing.assert_array_equal(ref[k], start[k])
        assert float(run["state"].opt_state.mu[k].abs().max()) == 0.0


def test_batch_norm_statistics_match(run):
    """Running statistics after the two micro-batches, frozen layers
    included: 1e-4 relative to each statistic's scale."""
    _, mstate = CV.student_to_jax_trees(run["state"].student)
    got, ref = _flat(mstate), _flat(run["jax"]["mstate"])
    start = _flat(run["start"][2])
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4,
                                   atol=1e-4 * np.abs(ref[k]).max() + 1e-7,
                                   err_msg=k)
    assert not np.array_equal(got["resnet.bn1.running_mean"],
                              start["resnet.bn1.running_mean"])
    assert not np.array_equal(got["resnet.layer4.2.bn3.running_var"],
                              start["resnet.layer4.2.bn3.running_var"])


def test_eval_step_matches(run):
    """The eval step on the updated students: the two differ by at most one
    optimizer step of a few noise-level entries, so the losses agree to
    1e-3 and the argmax tokens on nearly every position."""
    loss, ld, preds, cap_tgt = run["ev"]
    ref = run["jax"]
    np.testing.assert_allclose(float(loss), ref["eval_loss"], atol=1e-3)
    for k, v in ref["eval_ld"].items():
        np.testing.assert_allclose(float(ld[k]), v, atol=1e-3, err_msg=k)
    assert preds.shape == ref["preds"].shape == (TCAP - 1, B)
    assert (preds.numpy() == ref["preds"]).mean() >= 0.85
    np.testing.assert_array_equal(cap_tgt.numpy(), ref["cap_tgt"])
    assert not run["state"].student.training
