"""Teacher training in the port (``train/optim.label_smoothing_loss``, the
masks of ``models/vit.py`` and ``models/teacher.py``, the teacher steps of
``train/steps.py``, ``train/train_teacher.py``) against the JAX package.

A tiny teacher (ViT depth 6, so that blocks 0-1 stay frozen apart from their
norms; 24 wide, 2 heads; decoder 32 wide, 2 heads, 2 layers; 32x32 images)
with weights from the port's numpy ``teacher_init``, whose tree is the JAX
layout.  The data is a tiny grid dataset written by
``make_synthetic_dataset`` (16 images, 2 captions each, V=26); the step runs
on its first two batches of 4 (A=2, captions padded to 16), so PAD targets
are in the loss.  Float32, dropout off (the teacher is built with dropout
0), augmentation off (``AugmentConfig()``).  The JAX train step is the
per-leaf one ``train_teacher.train`` runs (``opt=None``), compiled once in a
module fixture and handed to the JAX trainer as well.

Tolerances are stated where they are used.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core.config import (TeacherConfig as JTeacherConfig,
                                            TeacherTrainConfig as JTrainConfig)
from imagecaptioner_tpu.data import transforms as JT
from imagecaptioner_tpu.models import teacher as JTM
from imagecaptioner_tpu.train import optim as JO
from imagecaptioner_tpu.train import steps as JS
from imagecaptioner_tpu.train import train_teacher as JTT
from imagecaptioner_tpu.utils import checkpoint as JCKPT
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.data.loader import get_loader
from imagecaptioner_tpu_torch.data.synthetic import make_synthetic_dataset
from imagecaptioner_tpu_torch.models import teacher as PTM
from imagecaptioner_tpu_torch.train import common, optim as PO
from imagecaptioner_tpu_torch.train import steps as PS
from imagecaptioner_tpu_torch.train import train_teacher as PTT
from imagecaptioner_tpu_torch.utils import checkpoint as PCKPT
from imagecaptioner_tpu_torch.utils import convert as CV

TKW = dict(embed_size=32, num_heads=2, num_decoder_layers=2, dropout=0.0,
           encoder_dim=24, encoder_depth=6, encoder_heads=2, patch_size=16)
S, TCAP, A, B = 32, 16, 2, 4
TRAIN_KW = dict(batch_size=B, accumulation_steps=A)
SCHED_T = 0.25


def _flat(tree):
    return {k: v.numpy() for k, v in CV.tree_to_state_dict(tree).items()}


def _np_tree(t):
    # copies: the port updates its tensors in place
    return jax.tree.map(lambda x: np.array(x, copy=True), t)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The dataset on disk, its vocabulary size and the step's stacked
    batch (the first two batches of the unshuffled loader)."""
    root = str(tmp_path_factory.mktemp("grid"))
    make_synthetic_dataset(root, n_images=16, captions_per_image=2,
                           image_size=S, learnable=True, task="grid")
    loader, ds = get_loader(root, os.path.join(root, "captions_clean.csv"),
                            batch_size=B, max_caption_len=TCAP,
                            shuffle=False, image_size=S)
    batch = next(iter(common.stacked_batches(loader, A)))
    assert (batch["captions"] == 0).any()        # PAD targets in the loss
    return dict(root=root, V=len(ds.vocab), batch=batch)


@pytest.fixture(scope="module")
def run(data):
    """One train step and the eval step in both packages from one teacher;
    everything the tests compare is gathered here once."""
    V, batch = data["V"], data["batch"]
    jcfg = JTeacherConfig(vocab_size=V, image_size=S, **TKW)
    jtr = JTrainConfig(**TRAIN_KW)
    pcfg = PC.TeacherConfig(vocab_size=V, image_size=S, **TKW)
    ptr = PC.TeacherTrainConfig(**TRAIN_KW)
    p0 = PTM.teacher_init(0, pcfg)

    jstep = JS.make_teacher_train_step(jcfg, jtr, aug=JT.AugmentConfig(),
                                       compute_dtype=jnp.float32)
    jeval = JS.make_teacher_eval_step(jcfg, jtr, compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, p0)
    jstate = JS.TrainState(params, jax.jit(JO.adamw_init)(params), {})
    one = {k: jnp.asarray(v[0]) for k, v in batch.items()}
    jeval0 = float(jeval(params, one))
    jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                       jnp.float32(SCHED_T), jax.random.PRNGKey(1))
    jax_side = dict(
        metrics={k: float(v) for k, v in jm.items()},
        params=_np_tree(jstate.params), mu=_np_tree(jstate.opt_state.mu),
        nu=_np_tree(jstate.opt_state.nu), step=int(jstate.opt_state.step),
        eval0=jeval0, eval1=float(jeval(jstate.params, one)),
        mask=JTM.teacher_trainable_mask(p0, jcfg),
        scales=JS.teacher_group_scales(p0, encoder_scale=jtr.encoder_lr_scale))

    teacher = PTM.Teacher(pcfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(p0), strict=True)
    state = PS.init_teacher_train_state(teacher, pcfg)
    peval = PS.make_teacher_eval_step(pcfg, ptr)
    one_t = PS.batch_to_device({k: v[0] for k, v in batch.items()}, "cpu")
    eval0 = float(peval(teacher, one_t))
    pstep = PS.make_teacher_train_step(pcfg, ptr, aug=PT.AugmentConfig())
    metrics = pstep(state, PS.batch_to_device(batch, "cpu"), SCHED_T, None)
    return dict(jax=jax_side, start=p0, state=state, pcfg=pcfg, ptr=ptr,
                jcfg=jcfg, jtr=jtr, jstep=jstep, jeval=jeval,
                metrics={k: float(v) for k, v in metrics.items()},
                eval0=eval0, eval1=float(peval(teacher, one_t)))


@pytest.mark.parametrize("with_lengths", [False, True])
def test_label_smoothing_loss_matches_jax(with_lengths):
    """Random logits and targets with PAD rows; the denominator counts PAD
    rows and, with ``lengths``, cuts the rows at or past max(lengths) - 1
    (float32, 1e-6 relative)."""
    rng = np.random.default_rng(3)
    T_, B_, V_ = 9, 5, 13
    logits = (3 * rng.standard_normal((T_, B_, V_))).astype(np.float32)
    targets = rng.integers(0, V_, (T_, B_)).astype(np.int32)
    targets[6:, 1] = 0
    targets[4:, 3] = 0
    lengths = np.array([8, 7, 6, 5, 7], np.int32)
    kw = dict(num_classes=V_, smoothing=0.1)
    ref = JO.label_smoothing_loss(
        jnp.asarray(logits), jnp.asarray(targets),
        lengths=jnp.asarray(lengths) if with_lengths else None, **kw)
    got = PO.label_smoothing_loss(
        torch.from_numpy(logits), torch.from_numpy(targets).long(),
        lengths=torch.from_numpy(lengths).long() if with_lengths else None,
        **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_trainable_mask_and_lr_scales_match_jax(run):
    """Name for name against JAX's trees: the ViT's blocks 0-1 frozen apart
    from their norms, 2-5 whole, the final norm trainable, patch_embed,
    cls_token and pos_embed frozen; every ``encoder*`` name at 0.1."""
    state = run["state"]
    mask = {k: v == 1.0 for k, v in _flat(run["jax"]["mask"]).items()}
    got = {n: p.requires_grad for n, p in state.named_parameters().items()}
    assert got == mask
    assert got == PTM.teacher_trainable_mask(state.teacher, run["pcfg"])
    frozen = sorted(n for n, t in got.items() if not t)
    assert "encoder.patch_embed.proj.weight" in frozen
    assert "encoder.blocks.1.attn.qkv.weight" in frozen
    assert not any(n.startswith("encoder.blocks.2.") for n in frozen)
    assert not any(".norm" in n for n in frozen)
    scales = _flat(run["jax"]["scales"])         # as float32 arrays
    assert {k: np.float32(v) for k, v in PS.teacher_group_scales(
        got, encoder_scale=0.1).items()} == scales
    assert scales["encoder_projection.weight"] == 0.1
    assert scales["fc_out.weight"] == 1.0
    assert PTM.count_parameters(state.teacher) == JTM.count_parameters(
        run["start"])


def test_step_metrics_match(run):
    """Loss, gradient norm and learning rate to 1e-5 relative (float32
    sums in another order)."""
    ref, got = run["jax"]["metrics"], run["metrics"]
    assert set(got) == set(ref) == {"loss", "grad_norm", "lr"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    assert ref["grad_norm"] > run["ptr"].grad_clip   # the clip acts


def _grads(side_mu, gnorm, clip):
    """AdamW's first moment after one step is 0.1 x the clipped mean
    gradient: undo both."""
    scale = min(1.0, clip / max(gnorm, 1e-6))
    return {k: v / 0.1 / scale for k, v in side_mu.items()}


def test_gradients_of_every_leaf_match(run):
    """Every leaf's gradient to 2e-4 of its largest entry (float32, other
    summation order); the second moments likewise, and the frozen leaves'
    moments stay zero on both sides."""
    clip = run["ptr"].grad_clip
    st = run["state"].opt_state
    assert st.step == run["jax"]["step"] == 1
    ref = _grads(_flat(run["jax"]["mu"]), run["jax"]["metrics"]["grad_norm"],
                 clip)
    got = _grads({k: v.numpy() for k, v in st.mu.items()},
                 run["metrics"]["grad_norm"], clip)
    assert set(got) == set(ref)
    ref_nu = _flat(run["jax"]["nu"])
    for k, g_ref in ref.items():
        np.testing.assert_allclose(
            got[k], g_ref, atol=2e-4 * np.abs(g_ref).max() + 1e-12, rtol=0,
            err_msg=k)
        v_ref, v_got = ref_nu[k], st.nu[k].numpy()
        np.testing.assert_allclose(
            v_got, v_ref, atol=4e-4 * np.abs(v_ref).max() + 1e-20, rtol=0,
            err_msg=k)


GROUPS = {"encoder": (True, 0.1), "rest": (False, 1.0)}


@pytest.mark.parametrize("group", sorted(GROUPS))
def test_updated_parameters_match_per_lr_group(run, group):
    """After one AdamW step a parameter has moved by about lr_leaf x
    sign(gradient): entries whose gradient is well above the float32 noise
    agree to 2% of that step, which tells the two groups apart (tenfold);
    every entry agrees to within one full step, since a noise-level
    gradient may flip its sign."""
    is_encoder, scale = GROUPS[group]
    lr = PC.TeacherTrainConfig().learning_rate * scale
    ref, start = _flat(run["jax"]["params"]), _flat(run["start"])
    mu = _flat(run["jax"]["mu"])
    moved = checked = 0
    for k, p in run["state"].named_parameters().items():
        if k.startswith("encoder") != is_encoder or not p.requires_grad:
            continue
        got = p.detach().numpy()
        np.testing.assert_allclose(got, ref[k], atol=2.1 * lr, rtol=0,
                                   err_msg=k)
        clear = np.abs(mu[k]) > max(1e-2 * np.abs(mu[k]).max(), 1e-8)
        if clear.any():
            assert (np.abs(got[clear] - ref[k][clear]) <= 0.02 * lr).all(), k
            checked += int(clear.sum())
        moved += int((got != start[k]).sum())
    assert moved > 0 and checked > 0


def test_frozen_leaves_did_not_move(run):
    start, ref = _flat(run["start"]), _flat(run["jax"]["params"])
    named = run["state"].named_parameters()
    frozen = [k for k, p in named.items() if not p.requires_grad]
    assert len(frozen) == 2 + 2 + 2 * 8      # patch_embed, cls/pos, 2 blocks
    for k in frozen:
        np.testing.assert_array_equal(named[k].detach().numpy(), start[k])
        np.testing.assert_array_equal(ref[k], start[k])
        assert float(run["state"].opt_state.mu[k].abs().max()) == 0.0


def test_eval_step_matches(run):
    """Before the step, the same parameters: 1e-5 relative.  After it the
    two sides differ by noise-level entries that flipped their step, so
    1e-4 absolute."""
    np.testing.assert_allclose(run["eval0"], run["jax"]["eval0"], rtol=1e-5)
    np.testing.assert_allclose(run["eval1"], run["jax"]["eval1"], atol=1e-4)
    assert not run["state"].teacher.training


def test_bf16_compute_matches_jax(run, data):
    """bf16 compute with float32 parameters, as the trainer runs by default:
    the images and the ViT are bf16, so the memory is; the caption stream
    stays float32 (the embedding's dtype), and JAX's type promotion makes
    the decoder float32 wherever the stream meets the memory, except
    cross-attention's K/V, P·V and out-projection.  The logits are float32
    on both sides and agree to 5e-3 of their largest value (bf16's 8-bit
    mantissa in the ViT, rounded in another order: 3.1e-3 measured), the
    eval loss to 1e-4 relative (2.3e-5).  A decoder cast whole to bf16
    misses both (9.5e-3 and 3.5e-4)."""
    batch = {k: v[0] for k, v in data["batch"].items()}
    jcfg, jtr = run["jcfg"], run["jtr"]

    @jax.jit
    def jax_fwd(p, b):
        images = JT.normalize(b["images"], dtype=jnp.bfloat16)
        logits = JTM.teacher_apply(p, images, b["captions"][:-1], jcfg)
        return logits, JS.make_teacher_eval_step(
            jcfg, jtr, compute_dtype=jnp.bfloat16)(p, b)

    p0 = run["start"]
    ref_logits, ref_loss = jax_fwd(jax.tree.map(jnp.asarray, p0),
                                   {k: jnp.asarray(v) for k, v in batch.items()})
    teacher = PTM.Teacher(run["pcfg"])
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(p0), strict=True)
    teacher.eval()
    tb = PS.batch_to_device(batch, "cpu")
    with torch.no_grad():
        logits = teacher(PT.normalize(tb["images"], dtype=torch.bfloat16),
                         tb["captions"][:-1])
    loss = PS.make_teacher_eval_step(run["pcfg"], run["ptr"],
                                     compute_dtype=torch.bfloat16)(teacher, tb)
    assert ref_logits.dtype == jnp.float32 and logits.dtype == torch.float32
    ref = np.asarray(ref_logits)
    np.testing.assert_allclose(logits.numpy(), ref,
                               atol=5e-3 * np.abs(ref).max(), rtol=0)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)


def test_train_checkpoints_and_resume_across_packages(run, data, tmp_path,
                                                      monkeypatch):
    """The port's ``train()`` writes the best and final checkpoints,
    ``vocab.json`` and ``training_history.json``; its checkpoint gives JAX's
    ``teacher_apply`` the port's logits (float32, 2e-5 absolute); the JAX
    trainer resumes it (epoch + 1, its moments), and the port resumes the
    JAX trainer's checkpoint with the saved moments."""
    root, V = data["root"], data["V"]
    common_kw = dict(teacher_cfg_overrides=dict(TKW), max_caption_len=TCAP,
                     image_size=S, aug=PT.AugmentConfig(), seed=0,
                     data_parallel=False, verbose=False,
                     max_steps_per_epoch=2)
    out = str(tmp_path / "port")
    state, cfg, vocab = PTT.train(root, output_dir=out, train_cfg=run["ptr"],
                                  num_epochs=1, compute_dtype="float32",
                                  device="cpu", **common_kw)
    assert cfg == run["pcfg"] and len(vocab) == V
    assert sorted(os.listdir(out)) == ["best_teacher_model.npz",
                                       "final_teacher_model.npz",
                                       "training_history.json", "vocab.json"]
    assert state.opt_state.step == 2
    best = os.path.join(out, "best_teacher_model.npz")

    # the port's checkpoint through JAX's reader and teacher_apply
    ck = JCKPT.load_checkpoint(best)
    assert int(ck["epoch"]) == 0 and int(ck["vocab_size"]) == V
    jcfg = JTeacherConfig(vocab_size=V, **ck["model_config"])
    assert jcfg == run["jcfg"]
    rng = np.random.default_rng(4)
    images = rng.standard_normal((2, 3, S, S)).astype(np.float32)
    caps = rng.integers(0, V, (7, 2)).astype(np.int32)
    ref = JTM.teacher_apply(
        jax.tree.map(jnp.asarray, ck["model_state_dict"]["params"]),
        jnp.asarray(images), jnp.asarray(caps), jcfg)
    teacher, _ = PTM.load_teacher(best, "cpu")
    with torch.no_grad():
        got = teacher(torch.from_numpy(images), torch.from_numpy(caps).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=0)

    # JAX resumes the port's checkpoint (its own compiled step, handed in)
    def jax_step(t_cfg, tr_cfg, **kw):    # num_epochs: not the step's
        assert t_cfg == run["jcfg"]
        assert dataclasses.replace(tr_cfg, num_epochs=25) == run["jtr"]
        return run["jstep"]

    monkeypatch.setattr(JS, "make_teacher_train_step", jax_step)
    jout = str(tmp_path / "jax")
    jstate, _, _ = JTT.train(
        root, output_dir=jout, train_cfg=run["jtr"], num_epochs=2,
        compute_dtype=jnp.float32, resume_from=best,
        **dict(common_kw, aug=JT.AugmentConfig()))
    assert int(jstate.opt_state.step) == 4       # 2 from the port, 2 its own
    jfinal = os.path.join(jout, "final_teacher_model.npz")

    # the port resumes the JAX checkpoint, moments and all
    jck = PCKPT.load_checkpoint(jfinal)
    probe = PS.init_teacher_train_state(PTM.Teacher(run["pcfg"]), run["pcfg"])
    assert PTT.resume_teacher_state(probe, jfinal, "cpu") == 3
    want_mu = CV.tree_to_state_dict(jck["optimizer_state_dict"]["mu"])
    assert probe.opt_state.step == 4 and set(probe.opt_state.mu) == set(want_mu)
    for k, v in want_mu.items():
        assert torch.equal(probe.opt_state.mu[k], v), k
    state, _, _ = PTT.train(root, output_dir=str(tmp_path / "again"),
                            train_cfg=run["ptr"], num_epochs=4,
                            compute_dtype="float32", device="cpu",
                            resume_from=jfinal, **common_kw)
    assert state.opt_state.step == 6


def test_entry_runs_on_the_card_unless_asked_and_refuses_several(
        data, tmp_path, monkeypatch):
    """The default device is the card: without one the trainer raises; with
    several cards visible, data parallelism (the default) starts one
    process per card (``common.run_per_card``, recorded here) before any
    data is read.  The CLI passes its flags on."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PTT.train(data["root"], output_dir=str(tmp_path))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

    def per_card(fn, n, kwargs):
        assert fn is PTT.train and kwargs["data_root"] == "no/such/dir"
        raise SystemExit(f"one process per card: {n}")
    monkeypatch.setattr(PTT.common, "run_per_card", per_card)
    with pytest.raises(SystemExit, match="one process per card: 2"):
        PTT.train("no/such/dir", output_dir=str(tmp_path))
    seen = {}
    monkeypatch.setattr(PTT, "train",
                        lambda *a, **kw: seen.update(args=a, **kw))
    assert PTT.main(["--data-root", "R", "--output-dir", "O", "--epochs",
                     "3", "--resume-from", "C", "--device", "cpu"]) == 0
    assert seen == dict(args=("R", None, "O"), num_epochs=3, seed=0,
                        resume_from="C", device="cpu")
