"""The optimized KD trainer of the port against the JAX package, at float32
on the CPU with small widths: the rounding of the bf16 frozen teacher's
parameters, the focal and optimized distillation losses, OneCycle, the three
lr groups and the per-name weight decay, the random crop and rotation, the
numpy resize against PIL, one optimized KD step of the compact student, and
a short run of the trainer whose checkpoint the JAX trainer resumes.

Tolerances are stated where they are used.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from imagecaptioner_tpu.core import config as JC
from imagecaptioner_tpu.core import modules as JM
from imagecaptioner_tpu.core import precision as JP
from imagecaptioner_tpu.data import dataset as JDS
from imagecaptioner_tpu.data import transforms as JT
from imagecaptioner_tpu.distill import losses as JL
from imagecaptioner_tpu.distill.projector import \
    create_feature_projectors as j_projectors
from imagecaptioner_tpu.distill.wrapper import \
    teacher_forward_for_kd as j_teacher_forward_for_kd
from imagecaptioner_tpu.models import student as JSM
from imagecaptioner_tpu.train import optim as JO
from imagecaptioner_tpu.train import steps as JS
from imagecaptioner_tpu.train import train_student_kd_optimized as JTO
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core import modules as PM
from imagecaptioner_tpu_torch.data import dataset as PDS
from imagecaptioner_tpu_torch.data import synthetic as PSY
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.distill import losses as PL
from imagecaptioner_tpu_torch.distill import wrapper as PW
from imagecaptioner_tpu_torch.distill.projector import (
    create_feature_projectors, make_projectors)
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.models.teacher import Teacher, teacher_init
from imagecaptioner_tpu_torch.train import optim as PO
from imagecaptioner_tpu_torch.train import steps as PS
from imagecaptioner_tpu_torch.train import train_student_kd_optimized as PTO
from imagecaptioner_tpu_torch.utils import convert as CV
from imagecaptioner_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
from test_torch_port_compact import (TKW, assert_kd_step_matches,
                                     both_configs, few_threads, np_tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------------------
# The bf16 frozen teacher: every floating parameter rounded, as JAX casts
# ---------------------------------------------------------------------------

RKW = dict(vocab_size=40, embed_size=32, num_heads=2, num_decoder_layers=1,
           dropout=0.15, encoder_dim=24, encoder_depth=1, encoder_heads=2,
           patch_size=16, image_size=32)


def _perturbed_teacher_tree():
    """A teacher tree whose LayerNorm weights and biases, embeddings,
    position embedding, CLS token and biases are moved off bf16's grid by
    a numpy seed.  The MLP out-projections are zero: the JAX package
    computes GELU in bf16 arithmetic, torch in float32 rounded once, and
    that difference (a bf16 ulp in a third of the elements) would hide the
    parameters' rounding; zeroed, the MLPs add exactly 0 on both sides."""
    p = teacher_init(0, PC.TeacherConfig(**RKW))
    rng = np.random.default_rng(11)

    def move(tree, path=""):
        if isinstance(tree, dict):
            return {k: move(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [move(v, f"{path}/{i}") for i, v in enumerate(tree)]
        if any(s in path for s in ("norm", "pos", "cls", "embedding")) \
                or path.endswith("bias"):
            return (tree + 0.3 * rng.standard_normal(tree.shape)
                    ).astype(np.float32)
        return tree

    p = move(p)
    for mlp in [b["mlp"]["fc2"] for b in p["encoder"]["blocks"]] \
            + [layer["linear2"] for layer in p["decoder"]]:
        for k in mlp:
            mlp[k] = np.zeros_like(mlp[k])
    return p


def test_bf16_teacher_rounds_every_parameter_as_jax_does():
    """The port's bf16 ``teacher_forward_for_kd`` against the teacher half
    of JAX's ``_kd_forward`` with ``bf16_compute`` parameters (the JAX
    step casts the tree once and the wrapper's second cast is a no-op), on
    zero images (the patch embedding is then its bias, which both packages
    add exactly; JAX rounds its bf16 convolution before the bias, torch
    after).  At least 99% of the elements bit-identical and none off by
    more than one bf16 ulp (2^-8) of the largest value (the repaired port
    reads 100% identical).  A teacher that keeps its float32 LayerNorms,
    embeddings and biases reads 31% and 41% identical and is off by 0.65%
    and 0.45% of the largest logit and feature.  The teacher passed in
    keeps its float32 values."""
    p = _perturbed_teacher_tree()
    assert all((np.asarray(jnp.asarray(v.numpy()).astype(jnp.bfloat16)
                           .astype(jnp.float32)) != v.numpy()).any()
               for k, v in CV.tree_to_state_dict(p).items() if "norm" in k)
    cfg, jcfg = PC.TeacherConfig(**RKW), JC.TeacherConfig(**RKW)
    B, T = 3, 6
    images = np.zeros((B, 3, 32, 32), np.float32)
    caps = np.random.default_rng(12).integers(0, 40, (T, B)).astype(np.int32)
    # compiled without XLA's excess precision, which would keep float32
    # between fused bf16 operations: the values of the eager wrapper
    args = (jax.tree.map(jnp.asarray, p), jnp.asarray(images),
            jnp.asarray(caps))
    ref = jax.jit(lambda q, x, c: j_teacher_forward_for_kd(
        JP.bf16_compute(q), x, c, jcfg, compute_dtype=jnp.bfloat16)).lower(
        *args).compile(compiler_options={
            "xla_allow_excess_precision": False})(*args)
    model = Teacher(cfg)
    model.load_state_dict(CV.jax_teacher_to_state_dict(p), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = PW.teacher_forward_for_kd(model.eval(), _t(images),
                                    _t(caps).long(),
                                    compute_dtype=torch.bfloat16)
    for k in ("logits", "encoder_features"):
        r, g = np.asarray(ref[k]), got[k].numpy()
        assert g.dtype == np.float32 and g.shape == r.shape
        assert np.mean(g == r) >= 0.99, (k, np.mean(g == r))
        assert np.abs(g - r).max() <= 2.0 ** -8 * np.abs(r).max(), k
    for k, v in model.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[k]), k


def test_kd_step_rounds_the_bf16_teacher_once_a_step(monkeypatch):
    """Under ``teacher_bf16`` the step casts the teacher once a step,
    outside its micro-batches (A=2 here), into the same copy each step,
    while the float32 teacher (validation, beam serving) stays as it
    was."""
    calls = []
    real = PS.cast_teacher

    def counting(teacher, dtype, into=None):
        out = real(teacher, dtype, into=into)
        calls.append((dtype, into is None, id(out)))
        return out

    monkeypatch.setattr(PS, "cast_teacher", counting)
    t_cfg = PC.TeacherConfig(**TKW)
    teacher = Teacher(t_cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(
        teacher_init(0, t_cfg)), strict=True)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    _, s_cfg = both_configs("compact", TKW["vocab_size"], dropout=0.0)
    student, projectors = _port_student(s_cfg)
    state = PS.init_train_state(student, projectors, s_cfg)
    step = PS.make_kd_train_step(
        teacher.eval(), t_cfg, s_cfg, PC.DistillConfig(),
        PC.KDTrainConfig(teacher_bf16=True), aug=PT.AugmentConfig())
    batch = PS.batch_to_device(_batch(64), "cpu")
    with few_threads():
        for _ in range(2):
            step(state, batch, 0.0, torch.Generator().manual_seed(0))
    assert [(d, first) for d, first, _ in calls] == [
        (torch.bfloat16, True), (torch.bfloat16, False)]
    assert calls[0][2] == calls[1][2]
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k


# ---------------------------------------------------------------------------
# Losses, schedule, groups
# ---------------------------------------------------------------------------

LT, LB, LV, LE, LL = 7, 3, 11, 8, 5


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    student = {"logits": 2 * f(LT, LB, LV), "encoder_features": f(LB, LL, LE),
               "hidden_states": f(LT, LB, LE)}
    teacher = {"logits": 2 * f(LT, LB, LV), "encoder_features": f(LB, LL, LE),
               "hidden_states": f(LT, LB, LE)}
    targets = rng.integers(0, LV, (LT, LB)).astype(np.int32)
    return student, teacher, targets


@pytest.mark.parametrize("with_lengths", [False, True])
@pytest.mark.parametrize("epoch", [0, 1, 3])
def test_optimized_loss_matches_jax(epoch, with_lengths):
    """Every returned term to 1e-6 relative, at epochs 0 (the warmup: only
    the token loss counts), 1 and 3 (the full weights), with and without
    lengths (the step mask; PAD targets count in the focal loss).  The
    hidden-state term takes JAX's random step weights as ready draws."""
    s, t, tg = _loss_inputs(epoch)
    lengths = np.array([LT + 1, 4, 2], np.int32) if with_lengths else None
    key = jax.random.PRNGKey(epoch)
    noise = np.asarray(jax.random.normal(key, (LT, LB)))
    jx = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    cfg, pcfg = JC.OptimizedDistillConfig(), PC.OptimizedDistillConfig()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(pcfg)
    for rng, hidden in ((None, None), (key, _t(noise))):
        ref_total, ref = JL.optimized_distillation_loss(
            jx(s), jx(t), jnp.asarray(tg), cfg, epoch,
            lengths=None if lengths is None else jnp.asarray(lengths),
            rng=rng)
        total, got = PL.optimized_distillation_loss(
            {k: _t(v) for k, v in s.items()},
            {k: _t(v) for k, v in t.items()}, _t(tg).long(), pcfg, epoch,
            lengths=None if lengths is None else _t(lengths).long(),
            hidden_noise=hidden)
        assert list(got) == list(ref) and len(got) == 7
        for k in ref:
            np.testing.assert_allclose(float(got[k]), float(ref[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
        assert float(total) == float(got["total_loss"])
        assert got["ce_loss"] is got["hard_loss"]
        assert (float(got["hidden_kd_loss"]) > 0) == (hidden is not None)
    if epoch == 0:
        assert float(got["total_loss"]) == float(got["token_kd_loss"])


@pytest.mark.parametrize("with_mask", [False, True])
def test_focal_loss_matches_jax(with_mask):
    """1e-6 relative; PAD (id 0) targets count."""
    s, _, tg = _loss_inputs(5)
    tg[:2] = 0
    logits, targets = s["logits"].reshape(-1, LV), tg.reshape(-1)
    mask = (np.arange(LT * LB) % 3 != 0).astype(np.float32) if with_mask \
        else None
    ref = JL.focal_loss(jnp.asarray(logits), jnp.asarray(targets), 0.25, 2.0,
                        None if mask is None else jnp.asarray(mask))
    got = PL.focal_loss(_t(logits), _t(targets).long(), 0.25, 2.0,
                        None if mask is None else _t(mask))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("total", [13, 100])
def test_onecycle_matches_jax_at_every_step(total):
    """The port's float64 schedule against JAX's float32 one at every step,
    1e-6 relative above float32's resolution at the peak (2^-23 x max_lr:
    JAX anneals ``end + (start - end) * ...`` in float32, so its smallest
    rates, the final 1e-3 x max_lr, carry an absolute error of that
    order); each group's schedule scales whole with its lr scale."""
    steps = np.arange(total + 1)
    for max_lr in (3e-4, 3e-4 * 0.1, 3e-4 * 1.5):
        ref = np.asarray(JO.onecycle_lr(jnp.asarray(steps, jnp.float32),
                                        max_lr=max_lr, total_steps=total))
        got = np.array([PO.onecycle_lr(s, max_lr=max_lr, total_steps=total)
                        for s in steps])
        np.testing.assert_allclose(got, ref, rtol=1e-6,
                                   atol=2.0 ** -23 * max_lr)
    lr = PO.onecycle_lr(0, max_lr=3e-4, total_steps=total)
    assert lr == pytest.approx(3e-5)
    assert PO.onecycle_lr(total - 1, max_lr=3e-4, total_steps=total) \
        == pytest.approx(3e-7)


@pytest.mark.parametrize("variant", ["compact", "full"])
def test_group_scales_and_weight_decays_match_jax(variant):
    """Per parameter, the port's lr scale and weight decay equal the JAX
    optimizer's trees: the encoder at 0.1 and 0.01, the decoder at 1 and
    0.01, the others (the projectors, and the full student's refinement)
    at 1.5 and 0.005."""
    kw = dict(embed_size=16, hidden_size=24)
    jcfg = {"compact": JC.compact_student_config,
            "full": JC.full_student_config}[variant](30, **kw)
    pcfg = PC.STUDENT_CONFIGS[variant](30, **kw)
    p, s = student_init(0, pcfg)
    proj, _ = create_feature_projectors(1, teacher_embed=32,
                                        student_embed=pcfg.embed_size,
                                        student_hidden=pcfg.hidden_size)
    params = {"student": p, "projectors": proj}
    tr = JC.KDTrainConfig(weight_decay=0.01, encoder_lr_scale=0.1)
    scales = JS.kd_group_scales(params, encoder_scale=0.1, others_scale=1.5)
    # the optimizer's flat per-element decay, as one compiled program, cut
    # back into the tree in ravel order
    wd_flat = np.asarray(jax.jit(lambda q: JS.make_kd_opt(
        q, jcfg, tr, others_scale=1.5, others_wd=0.005).wd_flat)(params))
    leaves, treedef = jax.tree.flatten(params)
    cuts = np.cumsum([np.size(a) for a in leaves])[:-1]
    wd_tree = jax.tree.unflatten(treedef, [
        c.reshape(np.shape(a)) for c, a in zip(np.split(wd_flat, cuts),
                                                leaves)])

    def by_name(tree):
        leaves = jax.tree.map(lambda v, a: np.broadcast_to(
            np.asarray(v, np.float32), np.shape(a)).copy(), tree, params)
        sd = CV.jax_student_to_state_dict(leaves["student"], s, pcfg)
        out = {f"student.{k}": float(v.reshape(-1)[0]) for k, v in sd.items()}
        out.update({f"projectors.{k}": float(v.reshape(-1)[0]) for k, v in
                    CV.jax_projectors_to_state_dict(
                        leaves["projectors"]).items()})
        return out

    student = Student(pcfg)
    projectors = make_projectors(32, pcfg.embed_size, pcfg.hidden_size)
    state = PS.TrainState(student, projectors, None)
    names = list(state.named_parameters())
    ref_scale, ref_wd = by_name(scales), by_name(wd_tree)
    got_scale = PS.kd_group_scales(names, encoder_scale=0.1, others_scale=1.5)
    got_wd = PS.kd_weight_decays(names, weight_decay=0.01, others_wd=0.005)
    assert got_scale == {n: pytest.approx(ref_scale[n]) for n in names}
    assert got_wd == {n: pytest.approx(ref_wd[n]) for n in names}
    others = {n for n in names if got_scale[n] == 1.5}
    assert others and all(got_wd[n] == 0.005 for n in others)
    assert any(n.startswith("student.attention_refinement.") for n in others) \
        == (variant == "full")
    assert PS.kd_weight_decays(names, weight_decay=0.01) == 0.01


# ---------------------------------------------------------------------------
# Augmentation and the resize
# ---------------------------------------------------------------------------


def _jax_draws(key, n, h, cfg):
    """The values ``augment_and_normalize`` draws from ``key``, for the
    port: crop offsets, angles (degrees), jitter factors, flips."""
    k_crop, k_rot, k_jit, k_flip = jax.random.split(key, 4)
    ky, kx = jax.random.split(k_crop)
    top = h - cfg.out_size + 1
    offsets = tuple(_t(jax.random.randint(k, (n,), 0, top)) for k in (ky, kx))
    theta = _t(jax.random.uniform(k_rot, (n,), minval=-cfg.rotation_deg,
                                  maxval=cfg.rotation_deg))
    kb, kc, ks, kh = jax.random.split(k_jit, 4)

    def u(k, f):
        return _t(jax.random.uniform(k, (n, 1, 1, 1), minval=max(0.0, 1.0 - f),
                                     maxval=1.0 + f))
    factors = {"brightness": u(kb, cfg.brightness),
               "contrast": u(kc, cfg.contrast),
               "saturation": u(ks, cfg.saturation),
               "hue": _t(jax.random.uniform(kh, (n, 1, 1), minval=-cfg.hue,
                                            maxval=cfg.hue))}
    flip = _t(jax.random.bernoulli(k_flip, cfg.hflip_prob, (n, 1, 1, 1)))
    return {"offsets": offsets, "theta": theta, "factors": factors,
            "flip": flip[:, 0, 0, 0]}


def test_crop_and_rotation_match_jax_on_its_draws():
    """The crop exactly; the rotation to 1e-6 absolute on [0, 1] pixels;
    the whole optimized pipeline (crop, rotation, jitter, flip, normalize)
    to 1e-5 on normalized values (four times 1e-6 over the std 0.225)."""
    x = np.random.default_rng(4).random((3, 12, 12, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    cfg = dataclasses.replace(JT.OPTIMIZED_KD_AUG, out_size=8)
    pcfg = dataclasses.replace(PT.OPTIMIZED_KD_AUG, out_size=8)
    assert dataclasses.asdict(PT.OPTIMIZED_KD_AUG) == \
        dataclasses.asdict(JT.OPTIMIZED_KD_AUG)
    d = _jax_draws(key, 3, 12, cfg)
    k_crop, k_rot, _, _ = jax.random.split(key, 4)
    crop = PT.random_crop(_t(x), 8, None, d["offsets"])
    np.testing.assert_array_equal(crop.numpy(), np.asarray(jax.jit(
        JT.random_crop, static_argnums=2)(k_crop, jnp.asarray(x), 8)))
    assert sorted({int(o) for o in d["offsets"][0]}) != [0]
    rot = PT.random_rotation(_t(x), 5.0, None, d["theta"])
    ref = np.asarray(jax.jit(JT.random_rotation, static_argnums=2)(
        k_rot, jnp.asarray(x), 5.0))
    np.testing.assert_allclose(rot.numpy(), ref, atol=1e-6, rtol=0)
    assert (ref == 0).any() and (ref != x).any()     # corners left the image
    u8 = (x * 255).astype(np.uint8)
    ref = jax.jit(lambda k, x: JT.augment_and_normalize(k, x, cfg))(
        key, jnp.asarray(u8))
    got = PT.augment_and_normalize(_t(u8), pcfg, None, draws=d)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=0)
    # an image no larger than out_size is not cropped
    small = PT.augment_and_normalize(_t(u8[:, :8, :8]), pcfg,
                                     torch.Generator().manual_seed(0))
    assert small.shape == (3, 3, 8, 8)
    g = torch.Generator().manual_seed(1)
    assert PT.augment_and_normalize(_t(u8), pcfg, g).shape == (3, 3, 8, 8)


@pytest.mark.parametrize("src,dst", [((224, 224), (256, 256)),
                                     ((256, 256), (224, 224)),
                                     ((37, 53), (61, 29))])
def test_numpy_resize_matches_pil_bit_for_bit(src, dst):
    """``resize_bilinear`` against this machine's PIL ``Image.resize(...,
    BILINEAR)``: every byte equal (height, width pairs)."""
    img = np.random.default_rng(sum(src)).integers(0, 256, src + (3,),
                                                   dtype=np.uint8)
    ref = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
    got = PDS.resize_bilinear(img, dst[1], dst[0])
    assert got.dtype == np.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_dataset_resizes_a_ppm_without_pil_as_jax_reads_it(tmp_path,
                                                           monkeypatch):
    """A PPM read at two other sizes (the optimized trainer's 32 pixels
    larger training images) equals the JAX dataset's PIL read, with PIL
    made unimportable on the port's side."""
    root = tmp_path / "d"
    (root / "Images").mkdir(parents=True)
    img = np.random.default_rng(3).integers(0, 256, (64, 64, 3),
                                            dtype=np.uint8)
    PDS.write_ppm(str(root / "Images" / "a.ppm"), img)
    (root / "c.csv").write_text("image,caption\na.ppm,a dog runs\n")
    for size in (96, 48):
        ref = JDS.CaptionDataset(str(root), str(root / "c.csv"),
                                 image_size=size).load_image(0)
        monkeypatch.setitem(__import__("sys").modules, "PIL", None)
        got = PDS.CaptionDataset(str(root), str(root / "c.csv"),
                                 image_size=size).load_image(0)
        monkeypatch.undo()
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# One optimized KD step, against JAX's per-leaf step
# ---------------------------------------------------------------------------

OA, OB, OT, OSIZE, OTOTAL, OSTEP, OEPOCH = 2, 4, 8, 96, 13, 2, 1
OAUG = dict(brightness=0.2, contrast=0.2, saturation=0.2, hue=0.1,
            hflip_prob=0.5, rotation_deg=5.0, random_crop=True, out_size=64)


def _batch(size, seed=5, vocab=30):
    rng = np.random.default_rng(seed)
    caps = np.zeros((OA, OT, OB), np.int32)
    lengths = rng.integers(4, OT + 1, (OA, OB)).astype(np.int32)
    for a in range(OA):
        for b in range(OB):
            n = lengths[a, b]
            caps[a, :n, b] = [1] + list(rng.integers(4, vocab, n - 2)) + [2]
    return {"images": rng.integers(0, 256, (OA, OB, size, size, 3),
                                   dtype=np.uint8),
            "captions": caps, "lengths": lengths}


def _port_student(s_cfg, seed=0, proj=None):
    student = Student(s_cfg)
    p, s = student_init(seed, s_cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(p, s, s_cfg),
                            strict=True)
    projectors = make_projectors(32, s_cfg.embed_size, s_cfg.hidden_size)
    if proj is None:
        proj, _ = create_feature_projectors(
            1, teacher_embed=32, student_embed=s_cfg.embed_size,
            student_hidden=s_cfg.hidden_size,
            student_seq_len=s_cfg.feature_tokens,
            teacher_seq_len=PC.TeacherConfig(**TKW).num_tokens)
    projectors.load_state_dict(CV.jax_projectors_to_state_dict(proj),
                               strict=True)
    return student, projectors


@pytest.fixture(scope="module")
def opt_step():
    return optimized_step_both()


def optimized_step_both():
    """One optimized KD step of the compact student in both packages from
    one student, teacher, projector set and AdamW state: float32, A=2 x B=4
    96x96 images cropped to 64 and rotated, jittered and flipped with the
    values the JAX step draws (handed to the port), dropout off on both
    sides, epoch 1 (the loss's warmup at a third), OneCycle at step 2 of
    13, lr groups 0.1 / 1 / 1.5 and the others' weight decay 0.005.  B=4,
    not 2: the rotation's sines and cosines differ between XLA and torch
    in the last float32 bit, and with 2 images the backbone's last batch
    norms (8 samples a channel) amplify that pixel noise until the
    encoder projection's gradient misses its 2e-4 limit (1.03 x the limit
    in one element of 20,480); with 4, the worst leaf reads 0.52 x."""
    vocab = TKW["vocab_size"]
    mp = pytest.MonkeyPatch()
    mp.setattr(JM, "dropout", lambda rng, x, rate, train: x)
    tr = PC.OptimizedKDTrainConfig()
    try:
        jt_cfg = JC.TeacherConfig(**TKW)
        js_cfg, s_cfg = both_configs("compact", vocab, dropout=0.0)
        t_params = jax.tree.map(jnp.asarray, teacher_init(
            0, PC.TeacherConfig(**TKW)))
        s_params, s_state = jax.tree.map(jnp.asarray, student_init(0, s_cfg))
        proj, _ = j_projectors(jax.random.PRNGKey(3), teacher_embed=32,
                               student_embed=s_cfg.embed_size,
                               student_hidden=s_cfg.hidden_size,
                               student_seq_len=js_cfg.feature_tokens,
                               teacher_seq_len=jt_cfg.num_tokens)
        params = {"student": s_params, "projectors": proj}
        start = np_tree((t_params, params, s_state))
        batch = _batch(OSIZE, vocab=vocab)
        shim = JC.KDTrainConfig(learning_rate=tr.learning_rate,
                                weight_decay=tr.weight_decay,
                                grad_clip=tr.grad_clip,
                                encoder_lr_scale=tr.encoder_lr_scale)
        aug = JT.AugmentConfig(**OAUG)
        jstep = JS.make_kd_train_step(
            jt_cfg, js_cfg, None, shim, aug=aug, compute_dtype=jnp.float32,
            optimized=True, od_cfg=JC.OptimizedDistillConfig(),
            onecycle_total_steps=OTOTAL, others_scale=tr.others_lr_scale,
            others_wd=tr.others_weight_decay)
        jstate = JS.TrainState(params, jax.jit(JO.adamw_init)(params), s_state)
        rng = jax.random.PRNGKey(1)
        jstate, jmetrics = jstep(
            jstate, t_params, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.float32(OSTEP), jnp.int32(OEPOCH), rng)
        draws = [_jax_draws(jax.random.split(k, 3)[0], OB, OSIZE, aug)
                 for k in jax.random.split(rng, OA)]
        jax_side = dict(
            metrics={k: float(v) for k, v in jmetrics.items()},
            params=np_tree(jstate.params), mstate=np_tree(jstate.model_state),
            mu=np_tree(jstate.opt_state.mu), nu=np_tree(jstate.opt_state.nu))
    finally:
        mp.undo()

    t0, p0, s0 = start
    t_cfg = PC.TeacherConfig(**TKW)
    teacher = Teacher(t_cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(t0), strict=True)
    student, projectors = _port_student(s_cfg, proj=p0["projectors"])
    student.load_state_dict(CV.jax_student_to_state_dict(
        p0["student"], s0, s_cfg), strict=True)
    state = PS.init_train_state(student, projectors, s_cfg)
    pstep = PS.make_kd_train_step(
        teacher.eval(), t_cfg, s_cfg, None, tr, aug=PT.AugmentConfig(**OAUG),
        compute_dtype=torch.float32, optimized=True,
        od_cfg=PC.OptimizedDistillConfig(), onecycle_total_steps=OTOTAL,
        others_scale=tr.others_lr_scale, others_wd=tr.others_weight_decay)
    real_aug, handed = PT.augment_and_normalize, iter(draws)
    mp.setattr(PS.T, "augment_and_normalize",
               lambda *a, **k: real_aug(*a, draws=next(handed), **k))
    try:
        with PM.no_dropout(), few_threads():
            metrics = pstep(state, PS.batch_to_device(batch, "cpu"), OSTEP,
                            None, OEPOCH)
    finally:
        mp.undo()
    return dict(jax=jax_side, start=start, state=state, metrics=metrics,
                s_cfg=s_cfg, tr=tr)


def test_optimized_kd_step_matches_jax(opt_step):
    """Loss terms, gradients, updated parameters and batch-norm statistics
    within ``test_torch_port_compact.py``'s limits (loss terms 1e-4
    absolute; leaf gradients 2e-4 of their largest entry, the backbone's
    10% in L2; parameters within one step of the largest rate, here the
    others' 1.5 x); ``lr`` (scale 1) equal to JAX's to 1e-6 relative; the
    feature term weighs in at epoch 1."""
    tr = opt_step["tr"]
    m, ref = opt_step["metrics"], opt_step["jax"]["metrics"]
    assert set(m) == set(ref) == set(PL.OPTIMIZED_LOSS_NAMES) | {
        "ce_loss", "grad_norm", "lr"}
    np.testing.assert_allclose(float(m["lr"]), ref["lr"], rtol=1e-6)
    assert float(m["lr"]) == pytest.approx(PO.onecycle_lr(
        OSTEP, max_lr=tr.learning_rate, total_steps=OTOTAL), rel=1e-7)
    peak = PO.onecycle_lr(OSTEP, max_lr=tr.learning_rate * tr.others_lr_scale,
                          total_steps=OTOTAL)
    assert_kd_step_matches(opt_step, loss_names=PL.OPTIMIZED_LOSS_NAMES,
                           lr=peak)
    beta = PC.OptimizedDistillConfig().beta * OEPOCH / 3
    np.testing.assert_allclose(
        float(m["total_loss"]) - float(m["token_kd_loss"]),
        beta * float(m["feature_kd_loss"]), rtol=1e-4)
    assert float(m["feature_kd_loss"]) > 0


# ---------------------------------------------------------------------------
# The trainer: a run on the CPU, its files, and JAX's resume of them
# ---------------------------------------------------------------------------

S, MAXLEN = 64, 12
TEACHER = dict(embed_size=32, num_heads=2, num_decoder_layers=1, dropout=0.1,
               encoder_dim=32, encoder_depth=1, encoder_heads=2,
               patch_size=16, image_size=S)
SMALL = dict(embed_size=32, hidden_size=32)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """16 grid images with two captions each (JPEG), a tiny teacher over
    the trainer's vocabulary, and one epoch of the port's trainer (one
    optimizer step of 2 x 16, training images at 96, validation at 64)."""
    root = tmp_path_factory.mktemp("opt")
    data = str(root / "data")
    PSY.make_synthetic_dataset(data, n_images=16, captions_per_image=2,
                               image_size=S, seed=0, learnable=True,
                               task="grid")
    V = len(PDS.CaptionDataset(data, os.path.join(data, "captions_clean.csv"))
            .vocab)
    t_path = str(root / "teacher.npz")
    save_checkpoint(t_path, {"model_state_dict": {"params": teacher_init(
        0, PC.TeacherConfig(vocab_size=V, **TEACHER))},
        "vocab_size": V, "model_config": TEACHER})
    out = str(root / "out")
    with few_threads():
        state, s_cfg, vocab = PTO.train_student_with_kd_optimized(
            data, None, t_path, out, image_size=S, max_caption_len=MAXLEN,
            num_epochs=1, compute_dtype=torch.float32, device="cpu",
            verbose=False, student_cfg_overrides=SMALL)
    return dict(root=root, data=data, t_path=t_path, out=out, V=V,
                state=state, s_cfg=s_cfg, vocab=vocab)


def _run_jax_trainer(run, out, monkeypatch, **kw):
    """The JAX optimized trainer on the same data with its steps replaced
    by recorders (no JAX step is compiled): it writes its checkpoint and
    history, and with ``resume_from`` reads the port's.  Returns the
    scheduler steps its train step saw and its final state."""
    seen = []

    def make_train(*a, **k):
        def step(state, teacher_params, batch, sched_t, epoch, rng):
            seen.append(float(sched_t))
            names = ["total_loss", "ce_loss", "token_kd_loss",
                     "feature_kd_loss", "hidden_kd_loss", "kd_loss",
                     "hard_loss", "grad_norm", "lr"]
            return state, {n: jnp.float32(1.0) for n in names}
        return step

    def make_eval(*a, **k):
        def step(params, model_state, teacher_params, batch, epoch):
            cap = batch["captions"]
            return (jnp.float32(1.0), {}, jnp.zeros_like(cap[1:]), cap[1:])
        return step

    def init_from_numpy(key, cfg):
        pcfg = PC.StudentConfig(**dataclasses.asdict(cfg))
        return jax.tree.map(jnp.asarray, student_init(0, pcfg))

    def zero_moments(params):      # AdamWState's trees, without a dispatch
        zeros = jax.tree.map(lambda a: np.zeros(np.shape(a), np.float32),
                             params)
        return JO.AdamWState(step=np.int32(0), mu=zeros, nu=zeros)

    monkeypatch.setattr(JS, "make_kd_train_step", make_train)
    monkeypatch.setattr(JS, "make_kd_eval_step", make_eval)
    monkeypatch.setattr(JSM, "student_init", init_from_numpy)
    monkeypatch.setattr(JO, "adamw_init", zero_moments)
    state, _, _ = JTO.train_student_with_kd_optimized(
        run["data"], None, run["t_path"], out, image_size=S,
        max_caption_len=MAXLEN, data_parallel=False, verbose=False,
        student_cfg_overrides=SMALL, **kw)
    monkeypatch.undo()
    return seen, state


def _keys(tree, depth=2):
    if not isinstance(tree, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in tree.items()}


def test_trainer_files_have_the_jax_trainers_keys(trained, tmp_path,
                                                  monkeypatch):
    """The best checkpoint's and the history's keys, two levels deep
    (scheduler, distillation and training configs, performance metrics,
    loss components, hyperparameters), equal those the JAX trainer
    writes; one step of 2 x 16 an epoch, OneCycle's global step saved."""
    out = trained["out"]
    jout = str(tmp_path / "jax_out")
    _run_jax_trainer(trained, jout, monkeypatch, num_epochs=1)
    ours = load_checkpoint(os.path.join(out, PTO.BEST))
    theirs = load_checkpoint(os.path.join(jout, PTO.BEST))
    skip = ("student_state_dict", "projectors_state_dict",
            "optimizer_state_dict")
    assert set(ours) == set(theirs)
    assert {k: _keys(v) for k, v in ours.items() if k not in skip} == \
        {k: _keys(v) for k, v in theirs.items() if k not in skip}
    assert int(ours["scheduler_state_dict"]["global_step"]) == 1
    assert int(ours["optimizer_state_dict"]["step"]) == 1
    assert trained["state"].opt_state.step == 1
    hist = json.load(open(os.path.join(out, PTO.HISTORY)))
    jhist = json.load(open(os.path.join(jout, PTO.HISTORY)))
    assert _keys(hist) == _keys(jhist)
    assert len(hist["train_losses"]) == len(hist["val_losses"]) == 1
    assert np.isfinite(hist["train_losses"] + hist["val_losses"]).all()
    assert hist["loss_components"]["total_loss"] == hist["train_losses"]


def test_jax_trainer_resumes_the_port_checkpoint(trained, tmp_path,
                                                 monkeypatch):
    """JAX's resume reading takes the port's best checkpoint: its trees
    have the leaf shapes of ``jax.eval_shape(student_init)``, its values
    are the port's, and training goes on at the saved global step in the
    next epoch."""
    best = os.path.join(trained["out"], PTO.BEST)
    seen, state = _run_jax_trainer(trained, str(tmp_path / "r"), monkeypatch,
                                   num_epochs=2, resume_from=best)
    assert seen == [1.0]
    jcfg = JC.compact_student_config(trained["V"], **SMALL)
    lay_p, lay_s = jax.eval_shape(lambda k: JSM.student_init(k, jcfg),
                                  jax.random.PRNGKey(0))
    for tree, layout in ((state.params["student"], lay_p),
                         (state.model_state, lay_s)):
        assert jax.tree.structure(tree) == jax.tree.structure(layout)
        assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, layout)
    port = trained["state"]
    got = CV.tree_to_state_dict(jax.tree.map(np.asarray,
                                             state.params["student"]))
    for k, v in port.student.named_parameters():
        np.testing.assert_array_equal(got[k].numpy(), v.detach().numpy(),
                                      err_msg=k)
    assert int(state.opt_state.step) == port.opt_state.step


def test_port_resumes_at_the_saved_global_step(trained, tmp_path,
                                               monkeypatch):
    """The port resumes its own checkpoint in the next epoch at the saved
    global step, with the saved moments."""
    seen = []
    real = PS.make_kd_train_step

    def recording(*a, **k):
        step = real(*a, **k)

        def rec(state, batch, sched_t, gen, epoch=0):
            seen.append((sched_t, epoch, state.opt_state.step))
            return step(state, batch, sched_t, gen, epoch)
        return rec

    monkeypatch.setattr(PS, "make_kd_train_step", recording)
    with few_threads():
        state, _, _ = PTO.train_student_with_kd_optimized(
            trained["data"], None, trained["t_path"], str(tmp_path / "o"),
            image_size=S, max_caption_len=MAXLEN, num_epochs=2,
            resume_from=os.path.join(trained["out"], PTO.BEST),
            compute_dtype=torch.float32, device="cpu", verbose=False,
            student_cfg_overrides=SMALL)
    assert seen == [(1, 1, 1)] and state.opt_state.step == 2
    ck = load_checkpoint(str(tmp_path / "o" / PTO.BEST))
    assert int(ck["scheduler_state_dict"]["global_step"]) == 2
    assert int(ck["epoch"]) == 1


@pytest.mark.parametrize("kw,match", [
    (dict(data_parallel=True, device="cuda"), "item 13"),
    (dict(device_dataset=True), "item 11"),
    (dict(student_variant="tiny"), "unknown student_variant"),
])
def test_unported_options_and_the_default_device(kw, match, monkeypatch):
    """The options the flagship trainer refuses, refused the same way
    before any data is read; without a card the default device raises."""
    if "data_parallel" in kw:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    err = ValueError if "student_variant" in kw else SystemExit
    with pytest.raises(err, match=match) as e:
        PTO.train_student_with_kd_optimized("no/data", None, "t.npz", "out",
                                            **{"device": "cpu", **kw})
    if err is SystemExit:
        assert "imagecaptioner_tpu.train.train_student_kd_optimized" in \
            str(e.value)
    monkeypatch.undo()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PTO.main(["--data-root", "no/data"])
