"""The compact student of the port against the JAX package, at float32 on
the CPU with small widths (V=50, E=16, H=24, 64x64 images; MobileNetV2's
channel widths are fixed, so the images shrink instead): the backbone, the
plain versions of the two compact kernels against the Pallas kernels in
interpret mode and against the scan path, their gradients, greedy tokens,
the student's 4-tuple, converters, one KD step, the serve CLI's loader and a
short trainer run.

The helpers at the top take the variant as an argument:
``tests/test_torch_port_enhanced.py`` uses them for the enhanced student.
Tolerances are stated where they are used; 1e-4 unless shown otherwise.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core import config as JC
from imagecaptioner_tpu.core import modules as JM
from imagecaptioner_tpu.data import transforms as JT
from imagecaptioner_tpu.distill.projector import \
    create_feature_projectors as j_projectors
from imagecaptioner_tpu.models import lstm as JL
from imagecaptioner_tpu.models import mobilenet as JMN
from imagecaptioner_tpu.models import student as JSM
from imagecaptioner_tpu.ops import decode as JD
from imagecaptioner_tpu.ops import pallas_lstm as JPL
from imagecaptioner_tpu.ops.pallas_greedy import pallas_greedy_decode_compact
from imagecaptioner_tpu.train import optim as JO
from imagecaptioner_tpu.train import steps as JS
from imagecaptioner_tpu.utils import checkpoint as JCKPT
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core import modules as PM
from imagecaptioner_tpu_torch.data import synthetic as PSY
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.data.vocabulary import END, PAD
from imagecaptioner_tpu_torch.distill.losses import LOSS_NAMES
from imagecaptioner_tpu_torch.distill.projector import make_projectors
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.models import lstm as PL
from imagecaptioner_tpu_torch.models.mobilenet import MobileNetV2
from imagecaptioner_tpu_torch.models.student import (Student, student_init,
                                                     student_trainable_mask)
from imagecaptioner_tpu_torch.models.teacher import Teacher, teacher_init
from imagecaptioner_tpu_torch.ops import decode as PD
from imagecaptioner_tpu_torch.ops import greedy as G
from imagecaptioner_tpu_torch.ops import lstm_scan as S
from imagecaptioner_tpu_torch.train import steps as PS
from imagecaptioner_tpu_torch.train import train_student_kd as TK
from imagecaptioner_tpu_torch.utils import convert as CV
from imagecaptioner_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_port_beam_attn import stub_launches

V, E, H, B, T = 50, 16, 24, 2, 8
J_CONFIGS = {"compact": JC.compact_student_config,
             "enhanced": JC.enhanced_student_config}


# ---------------------------------------------------------------------------
# Helpers shared with the enhanced student's tests
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def few_threads(n=2):
    """Cap torch's intra-op threads for a heavy CPU section.  The suite runs
    several workers on one machine; a thread per core in each of them
    oversubscribes it, and a few seconds of convolutions become minutes."""
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def np_tree(t):
    """Numpy copies: the port updates its tensors in place."""
    return jax.tree.map(lambda x: np.array(x, copy=True), t)


def flat(tree):
    return {k: v.numpy() for k, v in CV.tree_to_state_dict(tree).items()}


def both_configs(variant, vocab=V, **over):
    kw = dict(embed_size=E, hidden_size=H, **over)
    return (J_CONFIGS[variant](vocab, **kw),
            PC.STUDENT_CONFIGS[variant](vocab, **kw))


def both_students(variant, seed=0, **over):
    """One student in both packages: ``(jcfg, params, state, pcfg, port model
    in eval mode)``.  The trees come from the port's numpy ``student_init``,
    whose layout ``test_numpy_init_and_masks_have_the_jax_layout`` holds
    against the JAX ``student_init``."""
    jcfg, pcfg = both_configs(variant, **over)
    p, s = student_init(seed, pcfg)
    model = Student(pcfg)
    model.load_state_dict(CV.jax_student_to_state_dict(p, s, pcfg), strict=True)
    return jcfg, p, s, pcfg, model.eval()


def sharpen(dec, gain=4.0, end_bias=1.0):
    """Scale a random decoder's LSTM and head in place and raise END's bias,
    so that greedy rows differ and some end mid-way."""
    for layer in dec["lstm"]:
        layer["weight_ih"] = layer["weight_ih"] * gain
        layer["weight_hh"] = layer["weight_hh"] * gain
    head = dec["output_projection"]
    head = head["fc2"] if "fc2" in head else head
    head["weight"] = head["weight"] * gain
    head["bias"] = head["bias"].copy()
    head["bias"][END] += end_bias


def assert_rows_differ_and_end(toks, max_length):
    """A token comparison only has power if rows differ and END occurs."""
    first_pad = [(r == PAD).argmax() if (r == PAD).any() else max_length
                 for r in toks]
    assert len({tuple(r) for r in toks.tolist()}) > 1
    assert any(0 < fp < max_length for fp in first_pad)
    assert len(set(first_pad)) > 1
    assert not (toks == END).any()


def jit_encode(jcfg):
    """``encode_image``'s refined features as one compiled program (eager,
    a backbone dispatches hundreds of ops one by one)."""
    return jax.jit(lambda p, s, x: JSM.encode_image(p, s, x, jcfg)[1])


def images_u8(seed=7, n=B, size=64):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def backbone_both(j_apply, port_cls, train):
    """One backbone forward in both packages on two 64x64 images, from the
    port's numpy init; returns ``(jax features, jax new state, port
    features, port model)``."""
    p, s = port_cls.init(np.random.default_rng(0))
    x = np.array(JT.normalize(jnp.asarray(images_u8())))
    ref, new_s = jax.jit(lambda p, s, x: j_apply(p, s, x, train=train))(
        p, s, jnp.asarray(x))
    model = port_cls()
    sd = CV.tree_to_state_dict(np_tree(p))
    for k, v in CV.tree_to_state_dict(np_tree(s)).items():
        sd[CV._stat_to_buffer(k, "backbone")] = v
    model.load_state_dict(sd, strict=True)
    model.train(train)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    return np.asarray(ref), np_tree(new_s), got.numpy(), model


def assert_backbone_stats(model, new_s, moved):
    """Running statistics after one forward: 1e-4 relative to each one's
    scale in train mode (1e-6 absolute: a mean of order 1e-8 is float32
    noise on both sides), untouched in eval mode."""
    ref = flat(new_s)
    got = {CV._buffer_to_stat(k, "backbone"): v.numpy()
           for k, v in model.named_buffers()}
    assert set(got) == set(ref)
    changed = 0
    for k, r in ref.items():
        np.testing.assert_allclose(got[k], r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max() + 1e-6,
                                   err_msg=k)
        start = 0.0 if k.endswith("running_mean") else 1.0
        changed += int(not np.all(got[k] == start))
    assert (changed == len(ref)) if moved else (changed == 0)


TKW = dict(vocab_size=30, embed_size=32, num_heads=2, num_decoder_layers=1,
           dropout=0.15, encoder_dim=24, encoder_depth=1, encoder_heads=2,
           patch_size=16, image_size=64)
KD_A, KD_B, KD_T, SCHED_T = 2, 2, 8, 0.25


def kd_batch(vocab=30):
    rng = np.random.default_rng(5)
    caps = np.zeros((KD_A, KD_T, KD_B), np.int32)
    lengths = rng.integers(4, KD_T + 1, (KD_A, KD_B)).astype(np.int32)
    for a in range(KD_A):
        for b in range(KD_B):
            n = lengths[a, b]
            caps[a, :n, b] = [1] + list(rng.integers(4, vocab, n - 2)) + [2]
    return {"images": rng.integers(0, 256, (KD_A, KD_B, 64, 64, 3),
                                   dtype=np.uint8),
            "captions": caps, "lengths": lengths}


def kd_step_both(variant):
    """One KD train step in both packages from one student, teacher,
    projector set and AdamW state on one uint8 batch: float32, augmentation
    off, dropout off on both sides (the student is built with dropout 0 and
    the dropout function itself is the identity, since ``jax.random`` masks
    cannot be drawn in torch).  Off the TPU the JAX step takes its
    ``lax.scan`` decoder."""
    vocab = TKW["vocab_size"]
    mp = pytest.MonkeyPatch()
    mp.setattr(JM, "dropout", lambda rng, x, rate, train: x)
    try:
        jt_cfg = JC.TeacherConfig(**TKW)
        js_cfg, s_cfg = both_configs(variant, vocab, dropout=0.0)
        _, k3 = jax.random.split(jax.random.PRNGKey(0))
        # the port's numpy inits (eager JAX inits compile every initializer
        # on its own; the layouts are held equal by the init tests)
        t_params = jax.tree.map(jnp.asarray, teacher_init(
            0, PC.TeacherConfig(**TKW)))
        s_params, s_state = jax.tree.map(jnp.asarray, student_init(0, s_cfg))
        proj, _ = j_projectors(k3, teacher_embed=32, student_embed=E,
                               student_hidden=H,
                               student_seq_len=js_cfg.feature_tokens,
                               teacher_seq_len=jt_cfg.num_tokens)
        params = {"student": s_params, "projectors": proj}
        start = np_tree((t_params, params, s_state))
        batch = kd_batch(vocab)
        jstep = JS.make_kd_train_step(
            jt_cfg, js_cfg, JC.DistillConfig(), JC.KDTrainConfig(dropout=0.0),
            aug=JT.AugmentConfig(), compute_dtype=jnp.float32)
        # one compiled program, not an eager zeros_like a leaf
        jstate = JS.TrainState(params, jax.jit(JO.adamw_init)(params), s_state)
        jstate, jmetrics = jstep(
            jstate, t_params, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.float32(SCHED_T), jnp.int32(0), jax.random.PRNGKey(1))
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
    student = Student(s_cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(
        p0["student"], s0, s_cfg), strict=True)
    projectors = make_projectors(32, E, H)
    projectors.load_state_dict(CV.jax_projectors_to_state_dict(
        p0["projectors"]), strict=True)
    state = PS.init_train_state(student, projectors, s_cfg)
    pstep = PS.make_kd_train_step(
        teacher.eval(), t_cfg, s_cfg, PC.DistillConfig(),
        PC.KDTrainConfig(dropout=0.0), aug=PT.AugmentConfig(),
        compute_dtype=torch.float32)
    with PM.no_dropout(), few_threads():
        metrics = pstep(state, PS.batch_to_device(batch, "cpu"), SCHED_T, None)
    return dict(jax=jax_side, start=start, state=state, metrics=metrics,
                s_cfg=s_cfg)


def assert_kd_step_matches(run, backbone_tag=".backbone."):
    """Loss terms to 1e-4 absolute; every leaf's gradient (AdamW's first
    moment after one step, times each side's gradient norm) to 2e-4 of its
    largest entry outside the backbone and to 10% in the L2 norm inside it:
    a few 64x64 images leave the last stages' batch norms a handful of
    samples a channel, which makes single backbone leaf gradients
    ill-conditioned (the full student's step test measures the same in the
    ResNet).  Updated parameters: every entry within one optimizer step of
    JAX's, frozen leaves unmoved on both sides.  Batch-norm statistics to
    1e-4 relative (1e-6 absolute: a running mean of order 1e-8 is float32
    noise on both sides)."""
    ref, got = run["jax"]["metrics"], run["metrics"]
    for k in LOSS_NAMES:
        np.testing.assert_allclose(float(got[k]), ref[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(float(got["grad_norm"]), ref["grad_norm"],
                               rtol=2e-2)
    st = run["state"].opt_state
    ref_mu = flat(run["jax"]["mu"])
    assert st.step == 1 and set(st.mu) == set(ref_mu)
    n_ref, n_got = ref["grad_norm"], float(got["grad_norm"])
    for k, r in ref_mu.items():
        g_ref, g_got = r * n_ref, st.mu[k].numpy() * n_got
        if backbone_tag in k:
            # a leaf whose gradient is zero in exact arithmetic (a bias
            # ahead of a train-mode batch norm) holds noise on both sides
            assert (np.linalg.norm(g_got - g_ref)
                    <= 0.1 * np.linalg.norm(g_ref) + 1e-6 * n_ref), k
        else:
            # (a one-element leaf fed by the backbone's features, such as
            # the spatial gate's bias, carries their noise at 1e-7 of the norm)
            np.testing.assert_allclose(
                g_got, g_ref, rtol=0, err_msg=k,
                atol=2e-4 * np.abs(g_ref).max() + 1e-7 * n_ref)
    lr = PC.KDTrainConfig().learning_rate
    new, old = flat(run["jax"]["params"]), flat(run["start"][1])
    moved = frozen = 0
    for k, p in run["state"].named_parameters().items():
        v = p.detach().numpy()
        if p.requires_grad:
            np.testing.assert_allclose(v, new[k], atol=2.1 * lr, rtol=0,
                                       err_msg=k)
            moved += int((v != old[k]).any())
        else:
            np.testing.assert_array_equal(v, old[k])
            np.testing.assert_array_equal(new[k], old[k])
            frozen += 1
    assert moved > 0 and frozen > 0
    _, mstate = CV.student_to_jax_trees(run["state"].student)
    got_s, ref_s = flat(mstate), flat(run["jax"]["mstate"])
    assert set(got_s) == set(ref_s)
    for k, r in ref_s.items():
        np.testing.assert_allclose(got_s[k], r, rtol=1e-4,
                                   atol=1e-4 * np.abs(r).max() + 1e-6,
                                   err_msg=k)


def serve_and_train_on_cpu(variant, tmp_path, overrides, jax_decode=True):
    """A short trainer run on the CPU, then the checkpoint it wrote through
    the serve loader and captioner, and back into the JAX package: its trees
    have the shapes of the JAX ``student_init`` and, with ``jax_decode``, the
    JAX package decodes it to the same tokens."""
    train_loader, val_loader, vocab = PSY.make_grid_loaders(
        16, image_size=64, seed=0, batch_size=4, max_caption_len=10,
        freq_threshold=1)
    teacher_kw = dict(embed_size=32, num_heads=2, num_decoder_layers=1,
                      dropout=0.1, encoder_dim=32, encoder_depth=1,
                      encoder_heads=2, patch_size=16, image_size=64)
    ckpt = str(tmp_path / "teacher.npz")
    save_checkpoint(ckpt, {
        "model_state_dict": {"params": teacher_init(
            0, PC.TeacherConfig(vocab_size=len(vocab), **teacher_kw))},
        "vocab_size": len(vocab), "model_config": teacher_kw})
    out = str(tmp_path / "kd_out")
    with few_threads():
        state, s_cfg, _ = TK.train_student_with_kd_on_loaders(
            train_loader, val_loader, vocab, ckpt, out, num_epochs=1,
            compute_dtype=torch.float32, seed=0, device="cpu", verbose=False,
            student_variant=variant, student_cfg_overrides=overrides)
    assert s_cfg.variant == variant and state.opt_state.step == 2
    hist = json.load(open(os.path.join(out, "student_training_history.json")))
    assert np.isfinite(hist["train_losses"]).all()
    path = os.path.join(out, "final_student_model.npz")
    ck = JCKPT.load_checkpoint(path)
    assert ck["model_config"]["model_type"] == variant
    mc = dict(ck["model_config"])
    mc.pop("model_type")
    jcfg = J_CONFIGS[variant](ck["vocab_size"], **mc)
    init_p, init_s = jax.eval_shape(lambda k: JSM.student_init(k, jcfg),
                                    jax.random.PRNGKey(0))  # layout only
    sd = ck["student_state_dict"]
    assert jax.tree.map(np.shape, init_p) == jax.tree.map(np.shape, sd["params"])
    assert jax.tree.map(np.shape, init_s) == jax.tree.map(np.shape,
                                                          sd["model_state"])
    model, cfg = serve.load_student(path, "cpu")
    assert cfg == s_cfg
    imgs = next(iter(val_loader))["images"]
    toks = serve.make_greedy_captioner(model, cfg, "cpu", max_length=6)(imgs)
    assert toks.shape == (4, 6) and toks.max() < len(vocab)
    # the serve CLI on three PNG files (PIL is available here)
    from PIL import Image
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in range(3):
        Image.fromarray(imgs[i]).save(img_dir / f"{i}.png")
    jsonl = tmp_path / "captions.jsonl"
    with few_threads():
        rc = serve.main(["--model", "student", "--checkpoint", path, "--vocab",
                         os.path.join(out, "vocab.json"), "--images",
                         str(img_dir), "--out", str(jsonl), "--batch", "2",
                         "--max-length", "6", "--device", "cpu"])
    lines = jsonl.read_text().splitlines()
    words = set(vocab.itos.values())
    assert rc == 0 and len(lines) == 3
    assert all(w in words for line in lines
               for w in json.loads(line)["caption"].split())
    if not jax_decode:
        return
    refined = jit_encode(jcfg)(sd["params"], sd["model_state"],
                               JT.normalize(jnp.asarray(imgs)))
    ref = JD.greedy_decode_student(sd["params"], refined, jcfg, max_length=6)
    np.testing.assert_array_equal(toks, np.asarray(ref))


# ---------------------------------------------------------------------------
# MobileNetV2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_mobilenet_matches_jax(train):
    """(2, 3, 64, 64) -> (2, 1280, 2, 2) and the batch-norm statistics.
    Eval mode to 1e-4 of the largest feature; train mode to 1e-3: the last
    stages normalise with the statistics of 8 samples a channel, which
    amplifies float32 summation-order noise through 50 layers."""
    ref, new_s, got, model = backbone_both(JMN.mobilenet_v2_apply,
                                           MobileNetV2, train)
    assert got.shape == ref.shape == (B, 1280, 2, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=(1e-3 if train else 1e-4)
                               * max(1.0, np.abs(ref).max()))
    assert_backbone_stats(model, new_s, moved=train)


def test_numpy_init_and_masks_have_the_jax_layout():
    """The port's numpy ``student_init`` has the JAX ``student_init``'s
    layout (structure, shapes and dtypes, traced by ``jax.eval_shape``
    without compiling a leaf's initializer); masks agree; the converters
    round-trip the tree exactly."""
    for refine in (False, True):
        jcfg, p, s, pcfg, model = both_students(
            "compact", use_attention_refinement=refine)
        ref_p, ref_s = jax.eval_shape(lambda k: JSM.student_init(k, jcfg),
                                      jax.random.PRNGKey(0))
        p2, s2 = student_init(0, pcfg)
        shapes = lambda t: jax.tree.map(np.shape, t)  # noqa: E731
        dtypes = lambda t: jax.tree.map(lambda x: np.dtype(x.dtype), t)  # noqa: E731
        assert jax.tree.structure(p2) == jax.tree.structure(ref_p)
        assert shapes(p2) == shapes(ref_p) and shapes(s2) == shapes(ref_s)
        assert dtypes(p2) == dtypes(ref_p) and dtypes(s2) == dtypes(ref_s)
        Student(pcfg).load_state_dict(
            CV.jax_student_to_state_dict(p2, s2, pcfg), strict=True)
        ref = CV.tree_to_state_dict(jax.tree.map(
            np.float32, JSM.student_trainable_mask(p, jcfg)))
        got = student_trainable_mask(model, pcfg)
        assert {k: bool(v) for k, v in ref.items()} == got
        assert not got["encoder.backbone.features.9.project.conv.weight"]
        assert got["encoder.backbone.features.10.expand.conv.weight"]
        back_p, back_s = CV.student_to_jax_trees(model)
        for a, b in ((back_p, p), (back_s, s)):
            assert jax.tree.structure(a) == jax.tree.structure(b)
            jax.tree.map(np.testing.assert_array_equal, a, b)


# ---------------------------------------------------------------------------
# Kernel #7: the teacher-forced compact recurrence
# ---------------------------------------------------------------------------


def _decoder(seed=0, **over):
    jcfg, pcfg = both_configs("compact", **over)
    dec = np_tree(JL.compact_decoder_init(jax.random.PRNGKey(seed), jcfg))
    port = PL.CompactDecoder(pcfg)
    port.load_state_dict(CV.tree_to_state_dict(dec), strict=True)
    return jcfg, pcfg, dec, port


def _scan_inputs(Tn, Bn, Lf, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bn, Lf, E)).astype(np.float32),
            rng.integers(0, V, (Tn, Bn)).astype(np.int32))


@pytest.mark.parametrize("Tn,Bn,Lf", [(6, 2, 9), (12, 4, 49)])
def test_compact_scan_plain_matches_pallas_and_scan(Tn, Bn, Lf):
    jcfg, pcfg, dec, port = _decoder()
    feats, caps = _scan_inputs(Tn, Bn, Lf)
    kern = JPL.pallas_compact_decoder_scan_train(
        dec, jnp.asarray(feats), jnp.asarray(caps), jcfg, interpret=True)
    scan = JL.compact_decoder_apply(dec, jnp.asarray(feats), jnp.asarray(caps),
                                    jcfg)
    with torch.no_grad():
        got = PL.compact_decoder_apply(port, torch.from_numpy(feats),
                                       torch.from_numpy(caps).long(), pcfg)
    for ref in (kern, scan):
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    assert S.launches_compact == 0


def test_compact_scan_residual_matches_pallas_kernel():
    """The cell trajectory the kernel writes as the backward's residual."""
    jcfg, pcfg, dec, port = _decoder()
    feats, caps = _scan_inputs(7, 3, 9)
    emb = dec["embedding"]["weight"][caps]
    l0 = dec["lstm"][0]
    ref = JPL._fused_compact_core_fwd_call(
        jnp.asarray(emb), jnp.asarray(feats), jnp.asarray(dec["attention"]["weight"].T),
        jnp.asarray(dec["attention"]["bias"][None]), jnp.asarray(l0["weight_ih"].T),
        jnp.asarray(l0["weight_hh"].T),
        jnp.asarray((l0["bias_ih"] + l0["bias_hh"])[None]), interpret=True)
    with torch.no_grad():
        got = S.compact_scan_plain(torch.from_numpy(emb), torch.from_numpy(feats),
                                   *PL.compact_scan_weights(port, torch.float32))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("Tn,Bn,Lf", [(6, 2, 9), (10, 4, 49)])
def test_compact_scan_gradients_match_jax(Tn, Bn, Lf):
    """Gradients of every decoder parameter and of the features, with random
    cotangents on logits, h and attn: autograd through the plain forward
    and the plain reverse-time backward (what a CUDA tensor gets), both
    against ``jax.grad`` through the Pallas custom VJP and the scan."""
    jcfg, pcfg, dec, port = _decoder()
    feats, caps = _scan_inputs(Tn, Bn, Lf)
    rng = np.random.default_rng(3)
    r1, r2, r3 = (rng.standard_normal(s).astype(np.float32)
                  for s in ((Tn, Bn, V), (Tn, Bn, H), (Tn, Bn, Lf)))

    def jloss(fn):
        def f(p, x):
            logits, h, attn = fn(p, x)
            return (jnp.sum(logits * r1) + jnp.sum(h * r2)
                    + jnp.sum(attn * r3))
        return f

    jc = jnp.asarray(caps)
    refs = [jax.jit(jax.grad(jloss(fn), argnums=(0, 1)))(dec,
                                                        jnp.asarray(feats))
            for fn in (
                lambda p, x: JL.compact_decoder_apply(p, x, jc, jcfg),
                lambda p, x: JPL.pallas_compact_decoder_scan_train(
                    p, x, jc, jcfg, interpret=True))]

    for prm in port.parameters():
        prm.requires_grad_(True)
    x = torch.from_numpy(feats).requires_grad_(True)
    logits, h, attn = PL.compact_decoder_apply(
        port, x, torch.from_numpy(caps).long(), pcfg)
    ((logits * torch.from_numpy(r1)).sum() + (h * torch.from_numpy(r2)).sum()
     + (attn * torch.from_numpy(r3)).sum()).backward()
    auto = {k: v.grad.numpy() for k, v in port.named_parameters()}
    for ref_p, ref_x in refs:
        for k, r in flat(np_tree(ref_p)).items():
            np.testing.assert_allclose(auto[k], r, atol=2e-4, rtol=1e-3,
                                       err_msg=k)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_x),
                                   atol=2e-4, rtol=1e-3)

    # the hand-written backward over the kernel's residuals
    with torch.no_grad():
        ops = (port.embedding(torch.from_numpy(caps).long()),
               torch.from_numpy(feats)) + PL.compact_scan_weights(
                   port, torch.float32)
        res = ops + S.compact_scan_plain(*ops)
        dh = torch.from_numpy(r2) + torch.from_numpy(r1) @ \
            port.output_projection.weight
        g = S.compact_scan_bwd_plain(res, dh, torch.from_numpy(r3))
    names = dict(zip(S.COMPACT_INPUTS, g))
    l0 = "lstm.0."
    np.testing.assert_allclose(names["feats"].numpy(), x.grad.numpy(),
                               atol=1e-4)
    for k, got in (("attention.weight", names["w_attn"]),
                   ("attention.bias", names["b_attn"]),
                   (l0 + "weight_ih", names["w_ih"]),
                   (l0 + "weight_hh", names["w_hh"]),
                   (l0 + "bias_ih", names["b"]), (l0 + "bias_hh", names["b"])):
        np.testing.assert_allclose(got.numpy(), auto[k], atol=1e-4, err_msg=k)
    demb = torch.zeros(V, E).index_add_(
        0, torch.from_numpy(caps).long().reshape(-1),
        names["emb"].reshape(-1, E))
    np.testing.assert_allclose(demb.numpy(), auto["embedding.weight"],
                               atol=1e-4)
    assert all(float(v.abs().max()) > 0 for v in g)


# ---------------------------------------------------------------------------
# Kernel #3: the whole greedy loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Vn,En,Hn,Bn,Lf,Tn,temperature", [
    (40, 16, 16, 2, 9, 8, 1.0),
    (50, 16, 24, 6, 9, 10, 2.0),
    (300, 256, 256, 4, 49, 20, 1.0),   # production widths
])
def test_compact_greedy_plain_matches_jax(Vn, En, Hn, Bn, Lf, Tn, temperature):
    jcfg = JC.compact_student_config(Vn, embed_size=En, hidden_size=Hn)
    pcfg = PC.compact_student_config(Vn, embed_size=En, hidden_size=Hn)
    dec = np_tree(JL.compact_decoder_init(jax.random.PRNGKey(4), jcfg))
    sharpen(dec)
    feats = (np.random.default_rng(5).standard_normal((Bn, Lf, En)) * 3.0
             ).astype(np.float32)
    port = PL.CompactDecoder(pcfg)
    port.load_state_dict(CV.tree_to_state_dict(dec), strict=True)
    x = torch.from_numpy(feats)
    got = G.greedy_decode_compact_plain(
        G.greedy_compact_operands(port, x.dtype), x, max_length=Tn,
        temperature=temperature).numpy()
    params = {"decoder": dec}
    kern = np.asarray(pallas_greedy_decode_compact(
        params, jnp.asarray(feats), jcfg, max_length=Tn,
        temperature=temperature, interpret=True))
    scan = np.asarray(JD.greedy_decode_student(
        params, jnp.asarray(feats), jcfg, max_length=Tn,
        temperature=temperature, early_exit=False))
    assert got.dtype == np.int32 and got.shape == (Bn, Tn)
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, scan)
    if Bn > 2:
        assert_rows_differ_and_end(got, Tn)
    assert G.launches_compact == 0


def test_cpu_tensors_never_launch_the_compact_kernels():
    x = torch.zeros(2, 9, 16)
    with pytest.raises(ValueError, match="CUDA"):
        G.greedy_decode_compact_cuda({}, x)
    with pytest.raises(ValueError, match="CUDA"):
        S.compact_scan_cuda(*[x] * 7)
    assert G.launches_compact == 0 and S.launches_compact == 0


# The two compact chain kernels' wrappers, with their launches routed to stub
# entry points (no nvcc, no card) and their cooperative grid given.
GRID = 132  # blocks of the H100's cooperative grid
_GREEDY_ENTRIES = ("ic_greedy_compact_blocks",
                   "ic_greedy_compact_workspace_bytes",
                   "ic_greedy_decode_compact", "ic_error_string")
_SCAN_ENTRIES = ("ic_compact_scan_blocks", "ic_compact_scan_workspace_bytes",
                 "ic_compact_scan", "ic_error_string")


def _stub_compact(monkeypatch, module, cache, entries, grid_key, blocks=GRID):
    """``stub_launches`` for a compact wrapper, with the grid ``blocks``
    given for ``grid_key`` and the workspace cache emptied: a workspace
    entry point that answers 64 bytes, an error string for a failed
    launch."""
    from imagecaptioner_tpu_torch.ops import _build
    stubs = stub_launches(monkeypatch, module, cache, entries)
    stubs[entries[1]].ret = 64
    stubs["ic_error_string"].ret = b"stub failure"
    monkeypatch.setitem(_build._GRIDS, grid_key, (blocks, 0))
    monkeypatch.setattr(_build, "_WORKSPACES", {})
    return stubs


def _compact_greedy_operands(En=16, Hn=16, Vn=40):
    z = torch.zeros
    return {"emb": z(Vn, En), "w_attn": z(En, Hn), "b_attn": z(En),
            "w_ih": z(4 * Hn, En), "w_hh": z(4 * Hn, Hn), "b": z(4 * Hn),
            "out_w": z(Vn, Hn), "out_b": z(Vn)}


def _compact_scan_operands(Tn=3, Bn=2, Lf=9, En=16, Hn=16):
    z = torch.zeros
    return (z(Tn, Bn, En), z(Bn, Lf, En), z(En, Hn), z(En), z(4 * Hn, En),
            z(4 * Hn, Hn), z(4 * Hn))


def test_compact_entry_points_are_typed_once_and_launches_counted(
        monkeypatch):
    """Both compact wrappers take their entry points from one table made at
    the first launch (``argtypes`` and ``restype`` set once over three
    launches), ask the workspace's size once and reuse it, and count one
    launch per kernel launch: a launch the card refuses raises, naming the
    CUDA error, and is not counted."""
    cpu = torch.device("cpu")
    g = _stub_compact(monkeypatch, G, "_COMPACT", _GREEDY_ENTRIES,
                      ("greedy_decode_compact", torch.float32, cpu, 9, 16, 16))
    w, feats = _compact_greedy_operands(), torch.zeros(2, 9, 16)
    for _ in range(3):
        out = G.greedy_decode_compact_cuda(w, feats, max_length=5)
    assert out.shape == (2, 5) and out.dtype == torch.int32
    assert G.launches_compact == 3
    assert len(g["ic_greedy_decode_compact"].calls) == 3
    assert len(g["ic_greedy_compact_workspace_bytes"].calls) == 1
    assert g["ic_greedy_decode_compact"].calls[0][4] == GRID
    s = _stub_compact(monkeypatch, S, "_COMPACT", _SCAN_ENTRIES,
                      ("compact_scan", torch.float32, cpu, 9, 16, 16))
    for _ in range(3):
        hs, attn, cs = S.compact_scan_cuda(*_compact_scan_operands())
    assert (hs.shape, attn.shape, cs.shape) == ((3, 2, 16), (3, 2, 9),
                                                (3, 2, 16))
    assert S.launches_compact == 3 and len(s["ic_compact_scan"].calls) == 3
    assert len(s["ic_compact_scan_workspace_bytes"].calls) == 1
    for stubs in (g, s):
        for name in stubs:
            if name != "ic_error_string":
                assert stubs[name].typed == 1, name
                assert stubs[name].restype is not None, name
    g["ic_greedy_decode_compact"].ret = s["ic_compact_scan"].ret = 2
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        G.greedy_decode_compact_cuda(w, feats, max_length=5)
    with pytest.raises(RuntimeError, match="CUDA error 2"):
        S.compact_scan_cuda(*_compact_scan_operands())
    assert G.launches_compact == 3 and S.launches_compact == 3


@pytest.mark.parametrize("kernel,shape,blocks,limit", [
    ("greedy", dict(Hn=GRID * 4 + 16), GRID, "at most 4 columns of H"),
    ("greedy", dict(En=GRID * 2 + 24), GRID, "at most 2 columns of E"),
    ("greedy", dict(Vn=GRID * 24 + 1), GRID, "at most 24 columns of V"),
    ("greedy", {}, 31, "fewer than the 32 rows of a chunk"),
    ("scan", dict(Hn=GRID * 4 + 16), GRID, "at most 4 columns of H"),
    ("scan", dict(En=GRID * 2 + 24), GRID, "at most 2 columns of E"),
    ("scan", {}, 15, "fewer than the 16 rows of a chunk"),
])
def test_compact_grids_name_the_cap_they_exceed(kernel, shape, blocks, limit,
                                                monkeypatch):
    """Each block of a compact chain owns at most 4 hidden units, 2 of E
    and (#3) 24 of V, and each row of a chunk takes a block of its own: a
    grid too small for the shape is refused with the cap named, before
    anything is launched."""
    cpu, dims = torch.device("cpu"), dict(En=16, Hn=16, Vn=40)
    dims.update(shape)
    En, Hn = dims["En"], dims["Hn"]
    if kernel == "greedy":
        stubs = _stub_compact(monkeypatch, G, "_COMPACT", _GREEDY_ENTRIES, (
            "greedy_decode_compact", torch.float32, cpu, 9, En, Hn), blocks)
        with pytest.raises(ValueError, match=limit):
            G.greedy_decode_compact_cuda(_compact_greedy_operands(**dims),
                                         torch.zeros(2, 9, En))
        launched = stubs["ic_greedy_decode_compact"].calls
    else:
        stubs = _stub_compact(monkeypatch, S, "_COMPACT", _SCAN_ENTRIES, (
            "compact_scan", torch.float32, cpu, 9, En, Hn), blocks)
        with pytest.raises(ValueError, match=limit):
            S.compact_scan_cuda(*_compact_scan_operands(En=En, Hn=Hn))
        launched = stubs["ic_compact_scan"].calls
    assert not launched
    assert G.launches_compact == 0 and S.launches_compact == 0


# ---------------------------------------------------------------------------
# The student as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[False, True],
                ids=["no_refinement", "refinement"])
def students(request):
    out = both_students("compact", use_attention_refinement=request.param)
    sharpen(out[1]["decoder"])
    out[4].load_state_dict(CV.jax_student_to_state_dict(out[1], out[2], out[3]),
                           strict=True)
    return out


def test_student_forward_and_step_match_jax(students):
    """``Student.forward`` in eval mode against ``student_apply`` (the
    4-tuple with the unrefined tap), and one decoder step."""
    jcfg, p, s, pcfg, model = students
    u8 = images_u8()
    caps = np.random.default_rng(9).integers(0, V, (T, B)).astype(np.int32)
    ref, _ = jax.jit(lambda *a: JSM.student_apply(*a, jcfg))(
        p, s, JT.normalize(jnp.asarray(u8)), jnp.asarray(caps))
    with torch.inference_mode():
        got = model(PT.normalize(torch.from_numpy(u8)),
                    torch.from_numpy(caps).long())
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    assert got[1].shape == (B, 49, E)
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    h, c = (rng.standard_normal((1, B, H)).astype(np.float32) * 0.5
            for _ in range(2))
    feats = rng.standard_normal((B, 49, E)).astype(np.float32)
    ref_logits, (ref_h, ref_c), ref_attn = jax.jit(
        lambda *a: JSM.decoder_step(*a, jcfg))(
        p, jnp.asarray(emb), (jnp.asarray(h), jnp.asarray(c)),
        jnp.asarray(feats))
    with torch.inference_mode():
        logits, (h2, c2), attn = model.decoder_step(
            torch.from_numpy(emb), (torch.from_numpy(h), torch.from_numpy(c)),
            torch.from_numpy(feats))
    for g, r in ((logits, ref_logits), (h2, ref_h), (c2, ref_c),
                 (attn, ref_attn)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def test_captions_match_jax_on_both_decode_paths(students):
    jcfg, p, s, pcfg, model = students
    u8 = images_u8(n=6)
    refined = jit_encode(jcfg)(p, s, JT.normalize(jnp.asarray(u8)))
    ref = np.asarray(JD.best_greedy_decode_student(p, refined, jcfg,
                                                   max_length=T))
    with torch.inference_mode():
        _, p_ref = model.encode_image(PT.normalize(torch.from_numpy(u8)))
        fast = PD.best_greedy_decode_student(model, p_ref, pcfg, max_length=T)
        loop = PD.greedy_decode_student(model, p_ref, pcfg, max_length=T)
    np.testing.assert_allclose(p_ref.numpy(), np.asarray(refined), atol=1e-4)
    np.testing.assert_array_equal(fast.numpy(), ref)
    np.testing.assert_array_equal(loop.numpy(), ref)


def test_jax_checkpoint_serves_through_the_port(students, tmp_path):
    jcfg, p, s, pcfg, _ = students
    path = str(tmp_path / "student.npz")
    JCKPT.save_checkpoint(path, {
        "student_state_dict": {"params": p, "model_state": s},
        "vocab_size": V,
        "model_config": dict(
            embed_size=E, hidden_size=H, num_layers=1, dropout=0.1,
            use_attention_refinement=pcfg.use_attention_refinement,
            model_type="compact")})
    model, cfg = serve.load_student(path, "cpu")
    assert cfg == pcfg
    u8 = images_u8()
    refined = jit_encode(jcfg)(p, s, JT.normalize(jnp.asarray(u8)))
    ref = JD.best_greedy_decode_student(p, refined, jcfg, max_length=T)
    toks = serve.make_greedy_captioner(model, cfg, "cpu", max_length=T)(u8)
    np.testing.assert_array_equal(toks, np.asarray(ref))


@pytest.fixture(scope="module")
def kd_run():
    return kd_step_both("compact")


def test_kd_step_matches_jax(kd_run):
    assert_kd_step_matches(kd_run)
    frozen = [k for k, p in kd_run["state"].named_parameters().items()
              if not p.requires_grad]
    assert all(k.startswith("student.encoder.backbone.features.")
               for k in frozen)
    assert float(kd_run["metrics"]["feature_kd_loss"]) > 0


def test_trainer_and_serve_cli_on_cpu(tmp_path):
    serve_and_train_on_cpu("compact", tmp_path,
                           dict(embed_size=32, hidden_size=32))
