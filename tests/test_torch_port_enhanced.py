"""The enhanced student of the port against the JAX package, at float32 on
the CPU with small widths (V=50, E=16, H=24, 8 heads of 2, 64x64 images;
EfficientNet-B3's channel widths are fixed, so the images shrink instead):
the backbone, the plain version of the enhanced recurrence against the
Pallas kernel in interpret mode and against the scan path, its hand-written
backward, train mode with the JAX dropout masks, the generic greedy loop,
the student's 4-tuple, converters, one KD step and a short trainer run.

Shares its helpers with ``tests/test_torch_port_compact.py``.  Tolerances are
stated where they are used; 1e-4 unless shown otherwise.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.data import transforms as JT
from imagecaptioner_tpu.models import efficientnet as JEN
from imagecaptioner_tpu.models import student as JSM
from imagecaptioner_tpu.models import student_enhanced as JSE
from imagecaptioner_tpu.ops import decode as JD
from imagecaptioner_tpu.ops import pallas_enhanced as JPE
from imagecaptioner_tpu.utils import checkpoint as JCKPT
from imagecaptioner_tpu_torch.core import modules as PM
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.models import student_enhanced as PSE
from imagecaptioner_tpu_torch.models.efficientnet import EfficientNetB3
from imagecaptioner_tpu_torch.models.student import (Student, student_init,
                                                     student_trainable_mask)
from imagecaptioner_tpu_torch.ops import attention as A
from imagecaptioner_tpu_torch.ops import decode as PD
from imagecaptioner_tpu_torch.ops import enhanced_scan as ES
from imagecaptioner_tpu_torch.utils import convert as CV
from test_torch_port_compact import (B, E, H, T, V, assert_backbone_stats,
                                     assert_kd_step_matches,
                                     assert_rows_differ_and_end,
                                     backbone_both, both_configs,
                                     both_students, flat, images_u8,
                                     few_threads, kd_step_both, np_tree,
                                     serve_and_train_on_cpu, sharpen)
from test_torch_port_beam_attn import stub_launches

NH = 8


# ---------------------------------------------------------------------------
# EfficientNet-B3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("train", [False, True])
def test_efficientnet_matches_jax(train):
    """(2, 3, 64, 64) -> (2, 1536, 2, 2) and the batch-norm statistics.
    Eval mode to 1e-4 of the largest feature; train mode to 1e-3 (batch
    statistics of 8 samples a channel in the last stages, as for
    MobileNetV2)."""
    ref, new_s, got, model = backbone_both(JEN.efficientnet_b3_apply,
                                           EfficientNetB3, train)
    assert got.shape == ref.shape == (B, 1536, 2, 2)
    np.testing.assert_allclose(got, ref, rtol=0, atol=(1e-3 if train else 1e-4)
                               * max(1.0, np.abs(ref).max()))
    assert_backbone_stats(model, new_s, moved=train)


def test_numpy_init_and_masks_have_the_jax_layout():
    """The port's numpy ``student_init`` has the JAX ``student_init``'s
    layout: tree structure and every leaf's shape and dtype, which
    ``jax.eval_shape`` traces without compiling a leaf's initializer; the
    trainable masks agree and the converters round-trip the tree exactly."""
    jcfg, p, s, pcfg, model = both_students("enhanced")
    ref_p, ref_s = jax.eval_shape(lambda k: JSM.student_init(k, jcfg),
                                  jax.random.PRNGKey(0))
    p2, s2 = student_init(0, pcfg)
    shapes = lambda t: jax.tree.map(np.shape, t)  # noqa: E731
    dtypes = lambda t: jax.tree.map(lambda x: np.dtype(x.dtype), t)  # noqa: E731
    assert jax.tree.structure(p2) == jax.tree.structure(ref_p)
    assert shapes(p2) == shapes(ref_p) and shapes(s2) == shapes(ref_s)
    assert dtypes(p2) == dtypes(ref_p) and dtypes(s2) == dtypes(ref_s)
    sd = CV.jax_student_to_state_dict(p2, s2, pcfg)
    Student(pcfg).load_state_dict(sd, strict=True)
    for k in ("decoder.pos_encoding", "attention_refinement.pos_encoding",
              "decoder.lstm_norms.2.weight",
              "attention_refinement.layers.1.ffn.fc2.bias",
              "encoder.backbone.stages.5.3.se.fc1.bias",
              "encoder.backbone.stem.bn.running_var",
              "feature_compressor.fc2.weight"):
        assert k in sd, k
    ref = CV.tree_to_state_dict(jax.tree.map(
        np.float32, JSM.student_trainable_mask(p, jcfg)))
    got = student_trainable_mask(model, pcfg)
    assert {k: bool(v) for k, v in ref.items()} == got
    assert not got["encoder.backbone.stages.3.0.project.conv.weight"]
    assert got["encoder.backbone.stages.4.0.expand.conv.weight"]
    back_p, back_s = CV.student_to_jax_trees(model)
    for a, b in ((back_p, p), (back_s, s)):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        jax.tree.map(np.testing.assert_array_equal, a, b)


# ---------------------------------------------------------------------------
# Kernel #8: the teacher-forced enhanced recurrence
# ---------------------------------------------------------------------------


def _decoder(seed=0, **over):
    """The port's numpy decoder init (its layout is the JAX init's, see
    ``test_numpy_init_and_masks_have_the_jax_layout``): the JAX init compiles
    every initializer on its own."""
    jcfg, pcfg = both_configs("enhanced", **over)
    dec = PSE.EnhancedDecoder.init(np.random.default_rng(seed), pcfg)
    port = PSE.EnhancedDecoder(pcfg)
    port.load_state_dict(CV.tree_to_state_dict(dec), strict=True)
    return jcfg, pcfg, dec, port


def _scan_inputs(Tn, Bn, Lf, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Bn, Lf, E)).astype(np.float32),
            rng.integers(0, V, (Tn, Bn)).astype(np.int32))


LN_BLOCKS = 5  # the mirror's blocks at H=24: spans of 4 and 5 units


def _apply_ln_partials(port, pcfg, feats, caps, monkeypatch):
    """The port's forward with every LayerNorm's statistics taken as the
    CUDA kernel takes them (``layer_norm_partials``)."""
    with monkeypatch.context() as m, torch.no_grad():
        m.setattr(ES, "_layer_norm_stats", functools.partial(
            ES.layer_norm_partials, blocks=LN_BLOCKS))
        return PSE.enhanced_decoder_apply(port, feats, caps, pcfg)


@pytest.mark.parametrize("Tn,Bn,Lf", [(6, 2, 9), (12, 4, 64)])
def test_enhanced_scan_plain_matches_pallas_and_scan(Tn, Bn, Lf, monkeypatch):
    """The plain version, and its LayerNorm statistics from per-block
    partials as the kernel combines them, against the Pallas kernel in
    interpret mode and the scan path (1e-4)."""
    jcfg, pcfg, dec, port = _decoder(dropout=0.0)
    feats, caps = _scan_inputs(Tn, Bn, Lf)
    kern = JPE.pallas_enhanced_decoder_scan_train(
        dec, jnp.asarray(feats), jnp.asarray(caps), jcfg, interpret=True)
    scan = JSE.enhanced_decoder_apply(dec, jnp.asarray(feats),
                                      jnp.asarray(caps), jcfg)
    x, c = torch.from_numpy(feats), torch.from_numpy(caps).long()
    with torch.no_grad():
        got = PSE.enhanced_decoder_apply(port, x, c, pcfg)
    mirror = _apply_ln_partials(port, pcfg, x, c, monkeypatch)
    for ref in (kern, scan):
        for out in (got, mirror):
            for g, r in zip(out, ref):
                assert g.shape == r.shape
                np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    assert ES.launches == 0


def test_layer_norm_partials_match_pallas_at_bf16(monkeypatch):
    """At bf16, where every product reads its input rounded to 8 bits, the
    plain version with the kernel's LayerNorm statistics against the Pallas
    kernel in interpret mode: within 1e-2 of each output's largest value
    (about two bf16 ulps; a float32 sum order that rounds one h the other
    way moves an output by one ulp)."""
    jcfg, pcfg, dec, port = _decoder(dropout=0.0)
    feats, caps = _scan_inputs(6, 2, 9)
    kern = JPE.pallas_enhanced_decoder_scan_train(
        dec, jnp.asarray(feats).astype(jnp.bfloat16), jnp.asarray(caps), jcfg,
        interpret=True)
    got = _apply_ln_partials(port, pcfg,
                             torch.from_numpy(feats).to(torch.bfloat16),
                             torch.from_numpy(caps).long(), monkeypatch)
    assert got[1].dtype == torch.bfloat16
    for g, r in zip(got, kern):
        r = np.asarray(r.astype(jnp.float32))
        assert g.shape == r.shape
        np.testing.assert_allclose(g.float().numpy(), r, rtol=0,
                                   atol=1e-2 * np.abs(r).max())


def test_layer_norm_partials_is_the_plain_statistic():
    """The mirror's combination of partials is exact algebra: it equals the
    two-pass statistic in float64 at any split, empty spans included."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 5, 768)))
    ref = ES._layer_norm_stats(x)
    for blocks in (1, 7, 132, 1000):
        for g, r in zip(ES.layer_norm_partials(x, blocks), ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), atol=1e-12)


def test_enhanced_scan_positions_beyond_the_learned_table():
    """T > MAX_POS: steps 50.. get no position, as in the JAX package."""
    jcfg, pcfg, dec, port = _decoder(dropout=0.0)
    feats, caps = _scan_inputs(PSE.MAX_POS + 3, 2, 9)
    ref = JSE.enhanced_decoder_apply(dec, jnp.asarray(feats),
                                     jnp.asarray(caps), jcfg)
    with torch.no_grad():
        got = PSE.enhanced_decoder_apply(port, torch.from_numpy(feats),
                                         torch.from_numpy(caps).long(), pcfg)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def _operands(port, pcfg, feats, caps, masks=None):
    """The kernel's operands as ``enhanced_decoder_apply`` prepares them,
    captured at the call of the scan."""
    seen = {}
    real = ES.enhanced_decoder_scan

    def spy(*ops):
        seen["ops"] = ops
        return real(*ops)

    ES.enhanced_decoder_scan = spy
    try:
        with torch.no_grad():
            PSE.enhanced_decoder_apply(port, torch.from_numpy(feats),
                                       torch.from_numpy(caps).long(), pcfg,
                                       train=masks is not None, masks=masks)
    finally:
        ES.enhanced_decoder_scan = real
    return seen["ops"]


@pytest.mark.parametrize("Tn,Bn,Lf,masked", [(6, 2, 9, False),
                                             (7, 3, 16, True)])
def test_enhanced_backward_plain_matches_autograd(Tn, Bn, Lf, masked):
    """The hand-written reverse-time backward over the residuals (what a
    CUDA tensor gets) against autograd through the plain forward: all 27
    gradients, random cotangents on h_tops, enh and attn, with and without
    dropout multipliers.  1e-4 of each gradient's largest entry."""
    jcfg, pcfg, dec, port = _decoder(dropout=0.3)
    feats, caps = _scan_inputs(Tn, Bn, Lf)
    rng = np.random.default_rng(2)
    masks = None
    if masked:
        masks = {"attn": torch.from_numpy(
                     (rng.random((Tn, Bn, NH, Lf)) < 0.9) / 0.9).float(),
                 "lstm": torch.from_numpy(
                     (rng.random((3, Tn, Bn, H)) < 0.7) / 0.7).float(),
                 "proj": torch.ones(Tn, Bn, E, dtype=torch.bool)}
    ops = _operands(port, pcfg, feats, caps, masks)
    assert (ops[4] is not None) == masked and (ops[5] is not None) == masked
    leaves = [None if o is None else o.detach().clone().requires_grad_(
        i not in (4, 5)) for i, o in enumerate(ops)]
    outs = ES.enhanced_scan_plain(*leaves)
    cots = [torch.from_numpy(rng.standard_normal(tuple(o.shape)).astype(
        np.float32)) for o in outs[:3]]
    sum((o * c).sum() for o, c in zip(outs[:3], cots)).backward()
    with torch.no_grad():
        got = ES.enhanced_scan_bwd_plain(
            tuple(ops) + tuple(o.detach() for o in outs), *cots)
    names = ("embp", "gate_w", "k", "v", "amask", "lmask") + ES.WEIGHTS
    assert len(got) == len(names) == 29
    for n, g, leaf in zip(names, got, leaves):
        if n in ("amask", "lmask"):
            assert g is None
            continue
        top = float(leaf.grad.abs().max())
        assert top > 0, n
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), rtol=0,
                                   atol=1e-4 * top, err_msg=n)


@pytest.mark.parametrize("Tn,Bn,Lf", [(6, 2, 9), (10, 4, 64)])
def test_enhanced_gradients_match_jax(Tn, Bn, Lf):
    """Gradients of every decoder parameter and of the features through
    ``enhanced_decoder_apply`` against ``jax.grad`` through the scan and
    through the Pallas custom VJP (the JAX tests' tolerance: one element in
    1,536 at 1.2e-4 through the 3-layer recurrence)."""
    jcfg, pcfg, dec, port = _decoder(dropout=0.0)
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
                lambda p, x: JSE.enhanced_decoder_apply(p, x, jc, jcfg),
                lambda p, x: JPE.pallas_enhanced_decoder_scan_train(
                    p, x, jc, jcfg, interpret=True))]
    for prm in port.parameters():
        prm.requires_grad_(True)
    x = torch.from_numpy(feats).requires_grad_(True)
    logits, h, attn = PSE.enhanced_decoder_apply(
        port, x, torch.from_numpy(caps).long(), pcfg)
    ((logits * torch.from_numpy(r1)).sum() + (h * torch.from_numpy(r2)).sum()
     + (attn * torch.from_numpy(r3)).sum()).backward()
    auto = {k: v.grad.numpy() for k, v in port.named_parameters()}
    for ref_p, ref_x in refs:
        ref_flat = flat(np_tree(ref_p))
        assert set(ref_flat) == set(auto)
        for k, r in ref_flat.items():
            np.testing.assert_allclose(auto[k], r, atol=2e-4, rtol=1e-3,
                                       err_msg=k)
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_x),
                                   atol=2e-4, rtol=1e-3)


def test_enhanced_train_mode_with_the_jax_masks():
    """Train mode: the JAX scan path's dropout masks, rebuilt by its key
    derivation (``fold_in(rng, t)`` split into 1 + layers keys; the
    projection's mask from ``fold_in(rng, T)``), fed to the port as
    multipliers."""
    jcfg, pcfg, dec, port = _decoder(dropout=0.3)
    Tn, Bn, Lf = 8, 3, 9
    feats, caps = _scan_inputs(Tn, Bn, Lf)
    rng = jax.random.PRNGKey(11)
    ref = jax.jit(lambda d, f, c: JSE.enhanced_decoder_apply(
        d, f, c, jcfg, train=True, rng=rng))(dec, jnp.asarray(feats),
                                             jnp.asarray(caps))
    keep_a, keep_l = 1.0 - PSE.ATTN_DROPOUT, 1.0 - jcfg.dropout

    @jax.jit
    def draws():  # one program, not a compile per eager draw
        r = [jax.random.split(jax.random.fold_in(rng, t), 1 + 3)
             for t in range(Tn)]
        return ([jax.random.bernoulli(r[t][0], keep_a, (Bn, NH, 1, Lf))
                 for t in range(Tn)],
                [[jax.random.bernoulli(r[t][1 + i], keep_l, (Bn, H))
                  for i in range(3)] for t in range(Tn)],
                jax.random.bernoulli(jax.random.fold_in(rng, Tn), keep_l,
                                     (Tn, Bn, E)))

    a_draw, l_draw, proj = jax.tree.map(np.asarray, draws())
    amask = [a[:, :, 0, :] / keep_a for a in a_draw]
    lmask = [[m / keep_l for m in ms] for ms in l_draw]
    masks = {"attn": torch.from_numpy(np.stack(amask)).float(),
             "lstm": torch.from_numpy(np.stack(lmask)).float().transpose(0, 1),
             "proj": torch.from_numpy(proj)}
    assert 0.0 < float((masks["lstm"] == 0).float().mean()) < 0.5
    with torch.no_grad():
        got = PSE.enhanced_decoder_apply(
            port, torch.from_numpy(feats), torch.from_numpy(caps).long(), pcfg,
            train=True, masks=masks)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)


def test_cpu_tensors_never_launch_the_enhanced_kernel():
    x = torch.zeros(2, 3, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ES.enhanced_scan_cuda(x, x, x[None], x[None], None, None, *[x] * 23)
    with pytest.raises(ValueError, match="23 weights"):
        ES.enhanced_scan_cuda(x, x, x, x, None, None, x)
    assert ES.launches == 0


def _kernel_operands(E_=32, H_=32, L_=9, nh=NH, T_=3, B_=2):
    """Zero operands of the kernel's shapes and dtypes (float32) on the CPU."""
    shapes = ES.weight_shapes(E_, H_)
    return (torch.zeros(T_, B_, E_), torch.zeros(T_, B_, E_),
            torch.zeros(B_, nh, L_, E_ // nh), torch.zeros(B_, nh, L_, E_ // nh),
            None, None) + tuple(torch.zeros(shapes[n]) for n in ES.WEIGHTS)


def test_enhanced_entry_points_are_typed_on_the_first_launch_only(monkeypatch):
    """The wrapper takes its three entry points from one table made at the
    first launch: their ``argtypes`` are set once, not per call (launches
    go to stubs: no nvcc, no card)."""
    stubs = stub_launches(monkeypatch, ES, "_LIB",
                          ("ic_enhanced_scan_blocks",
                           "ic_enhanced_scan_workspace_bytes",
                           "ic_enhanced_scan"), ret=0)
    from imagecaptioner_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "cooperative_grid",
                        lambda key, query, what, caps=(): 132)
    ops = _kernel_operands()
    for _ in range(3):
        outs = ES.enhanced_scan_cuda(*ops)
    assert [tuple(o.shape) for o in outs] == [(3, 2, 32)] * 2 + [(3, 2, 9)] \
        + [(3, 2, 32)] * 5
    for stub in stubs.values():
        assert stub.typed == 1
    assert len(stubs["ic_enhanced_scan"].calls) == 3 and ES.launches == 3


@pytest.mark.parametrize("over,limit", [
    (dict(E_=24), "divisible by 16"), (dict(H_=40), "divisible by 16"),
    (dict(L_=ES.MAX_L + 1), "L <= 512"), (dict(nh=3, E_=48), "nh \\* hd == E")])
def test_enhanced_wrapper_names_the_limits_it_refuses(over, limit, monkeypatch):
    """With the device check stubbed off, a shape the kernel does not take
    is refused before anything is built, and the message names the limit."""
    stub_launches(monkeypatch, ES, "_LIB", ())
    ops = list(_kernel_operands(**over))
    if "nh" in over:  # heads that do not divide E
        ops[2] = ops[3] = torch.zeros(2, 3, 9, 15)
    with pytest.raises(ValueError, match=limit):
        ES.enhanced_scan_cuda(*ops)
    assert ES.launches == 0


def test_enhanced_wrapper_refuses_more_attention_jobs_than_blocks(monkeypatch):
    """Each cooperative block holds one (row, head) attention job's K/V for
    the whole launch: a grid smaller than min(B, 16) x nh is refused, with
    the limit named, before anything is launched."""
    stubs = stub_launches(monkeypatch, ES, "_LIB",
                          ("ic_enhanced_scan_blocks",
                           "ic_enhanced_scan_workspace_bytes",
                           "ic_enhanced_scan"), ret=0)
    from imagecaptioner_tpu_torch.ops import _build
    monkeypatch.setattr(_build, "cooperative_grid",
                        lambda key, query, what, caps=(): 2 * NH - 1)
    with pytest.raises(ValueError, match=r"min\(B, 16\) x nh = %d" % (2 * NH)):
        ES.enhanced_scan_cuda(*_kernel_operands(B_=2))
    assert not stubs["ic_enhanced_scan"].calls and ES.launches == 0
    monkeypatch.setattr(_build, "cooperative_grid",
                        lambda key, query, what, caps=(): 2 * NH)
    ES.enhanced_scan_cuda(*_kernel_operands(B_=2))
    assert len(stubs["ic_enhanced_scan"].calls) == 1 and ES.launches == 1


def test_attention_core_takes_head_dim_48():
    """The cross refinement's shape at full width (384 / 8): the plain core
    on the CPU; the wrapper's checks accept 48 and 64 and refuse others."""
    assert A.HEAD_DIMS == (64, 48)
    q = torch.randn(1, 8, 64, 48, generator=torch.Generator().manual_seed(0))
    out = A.attention_core(q, q, q, scale=48 ** -0.5)
    ref = torch.softmax(q @ q.transpose(-1, -2) * 48 ** -0.5, -1) @ q
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# The student as a whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def students():
    out = both_students("enhanced")
    sharpen(out[1]["decoder"], gain=3.0, end_bias=0.6)
    out[4].load_state_dict(CV.jax_student_to_state_dict(out[1], out[2], out[3]),
                           strict=True)
    return out


CAPS = np.random.default_rng(9).integers(0, V, (T, B)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_on_images(students):
    """The JAX student on ``images_u8()``, computed once for the tests that
    share it, as one compiled program (eager, EfficientNet-B3 dispatches
    hundreds of ops one by one): ``student_apply``'s 4-tuple with ``CAPS``,
    and ``encode_image``'s refined features."""
    jcfg, p, s, _, _ = students

    def run(p, s, x, caps):
        out, _ = JSM.student_apply(p, s, x, caps, jcfg)
        return out, JSM.encode_image(p, s, x, jcfg)[1]

    return jax.jit(run)(p, s, JT.normalize(jnp.asarray(images_u8())),
                        jnp.asarray(CAPS))


def test_student_forward_and_step_match_jax(students, jax_on_images):
    """``Student.forward`` in eval mode against ``student_apply``: the
    4-tuple whose feature tap is the compressed refined features; and one
    decoder step."""
    jcfg, p, s, pcfg, model = students
    u8, caps = images_u8(), CAPS
    ref = jax_on_images[0]
    with torch.inference_mode():
        x = PT.normalize(torch.from_numpy(u8))
        got = model(x, torch.from_numpy(caps).long())
        raw, refined = model.encode_image(x)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    assert got[1].shape == (B, 64, E) and torch.equal(raw, got[1])
    np.testing.assert_allclose(
        raw.numpy(), model.feature_compressor(refined).detach().numpy())
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    h, c = (rng.standard_normal((3, B, H)).astype(np.float32) * 0.5
            for _ in range(2))
    feats = rng.standard_normal((B, 64, E)).astype(np.float32)
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


def test_greedy_loop_matches_jax(students):
    """The generic step loop (learned per-step positions) against
    ``greedy_decode_student`` on features drawn per row, so that rows differ
    and END occurs; the enhanced student has no greedy kernel in either
    package, and ``best_greedy_decode_student`` takes the same loop."""
    jcfg, p, s, pcfg, model = students
    Tn = 12
    feats = (np.random.default_rng(5).standard_normal((6, 64, E)) * 2.0
             ).astype(np.float32)
    ref = np.asarray(JD.greedy_decode_student(p, jnp.asarray(feats), jcfg,
                                              max_length=Tn, early_exit=False))
    with torch.inference_mode():
        x = torch.from_numpy(feats)
        loop = PD.greedy_decode_student(model, x, pcfg, max_length=Tn,
                                        early_exit=False)
        best = PD.best_greedy_decode_student(model, x, pcfg, max_length=Tn)
    np.testing.assert_array_equal(loop.numpy(), ref)
    np.testing.assert_array_equal(best.numpy(), ref)
    assert_rows_differ_and_end(ref, Tn)
    warm = np.asarray(JD.greedy_decode_student(
        p, jnp.asarray(feats), jcfg, max_length=Tn, temperature=2.0))
    with torch.inference_mode():
        got = PD.greedy_decode_student(model, x, pcfg, max_length=Tn,
                                       temperature=2.0)
    np.testing.assert_array_equal(got.numpy(), warm)


def test_jax_checkpoint_serves_through_the_port(students, jax_on_images,
                                                tmp_path):
    jcfg, p, s, pcfg, _ = students
    path = str(tmp_path / "student.npz")
    JCKPT.save_checkpoint(path, {
        "student_state_dict": {"params": p, "model_state": s},
        "vocab_size": V,
        "model_config": dict(embed_size=E, hidden_size=H, num_layers=3,
                             dropout=0.15, use_attention_refinement=True,
                             model_type="enhanced")})
    model, cfg = serve.load_student(path, "cpu")
    assert cfg == pcfg
    u8 = images_u8()
    ref = JD.best_greedy_decode_student(p, jax_on_images[1], jcfg, max_length=T)
    with few_threads():
        toks = serve.make_greedy_captioner(model, cfg, "cpu", max_length=T)(u8)
    np.testing.assert_array_equal(toks, np.asarray(ref))
    assert A.launches == 0


@pytest.fixture(scope="module")
def kd_run():
    return kd_step_both("enhanced")


def test_kd_step_matches_jax(kd_run):
    assert_kd_step_matches(kd_run)
    frozen = [k for k, p in kd_run["state"].named_parameters().items()
              if not p.requires_grad]
    assert all(k.startswith(("student.encoder.backbone.stem.",
                             "student.encoder.backbone.stages."))
               for k in frozen)
    assert float(kd_run["metrics"]["feature_kd_loss"]) > 0


def test_train_mode_forward_draws_its_masks():
    """In train mode without ready masks the multipliers come from the
    generator: two seeds differ, one seed repeats."""
    jcfg, pcfg, dec, port = _decoder(dropout=0.3)
    feats, caps = _scan_inputs(5, 2, 9)
    args = (port, torch.from_numpy(feats), torch.from_numpy(caps).long(), pcfg)

    def run(seed):
        with torch.no_grad():
            return PSE.enhanced_decoder_apply(
                *args, train=True,
                generator=torch.Generator().manual_seed(seed))[1]

    assert torch.equal(run(0), run(0)) and not torch.equal(run(0), run(1))
    with PM.no_dropout(), torch.no_grad():
        off = PSE.enhanced_decoder_apply(*args, train=True)[1]
        ev = PSE.enhanced_decoder_apply(*args)[1]
    assert torch.equal(off, ev)


def test_trainer_and_serve_cli_on_cpu(tmp_path):
    """The JAX package decodes a converted enhanced student to the port's
    tokens in ``test_jax_checkpoint_serves_through_the_port``; compiling
    EfficientNet-B3 once more for the trained one is left out."""
    serve_and_train_on_cpu("enhanced", tmp_path,
                           dict(embed_size=32, hidden_size=32),
                           jax_decode=False)
