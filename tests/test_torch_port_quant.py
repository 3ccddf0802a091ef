"""int8 serving of the port (``ops/quant.py``, ``ops/int8.py``, the modules'
dispatch, ``eval/serve.py``'s flags) against ``imagecaptioner_tpu/ops/
quant.py`` on the CPU, where the int8 products take their plain version
(integer sums exact in float64).

Parameter trees come from the port's numpy initializers (the JAX layout), so
both packages quantize the same weights; the JAX side runs eagerly where
bit-identity is asserted, because under ``jax.jit`` XLA contracts the
epilogue's multiply and bias add into one fused multiply-add (one float32
ulp, asserted separately).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core import config as JC
from imagecaptioner_tpu.data import transforms as JT
from imagecaptioner_tpu.eval import serve as jserve
from imagecaptioner_tpu.models import student as JSM
from imagecaptioner_tpu.models import teacher as JTM
from imagecaptioner_tpu.ops import quant as JQ
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core.modules import Conv2d, Linear
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.models.teacher import Teacher, teacher_init
from imagecaptioner_tpu_torch.ops import int8 as I8
from imagecaptioner_tpu_torch.ops import quant as Q
from imagecaptioner_tpu_torch.utils import convert as CV
from test_torch_port_serve_teacher import _args, artifacts  # noqa: F401

V, S = 50, 64
# E=64: the packed in-projections (12,288 weights) reach MIN_QUANT_ELEMENTS
TEACHER = dict(embed_size=64, num_heads=4, num_decoder_layers=2, dropout=0.0,
               encoder_dim=48, encoder_depth=2, encoder_heads=3, patch_size=16,
               image_size=S)
WIDTHS = {"full": 16, "compact": 16, "enhanced": 48}


def _jax_paths(tree, prefix=""):
    """Dotted path -> which int8 weight, of every quantized dict."""
    out = {}
    if isinstance(tree, dict):
        for key in ("weight_q", "in_proj_weight_q"):
            if key in tree:
                out[prefix.rstrip(".")] = key
        for k, v in tree.items():
            out.update(_jax_paths(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_jax_paths(v, f"{prefix}{i}."))
    return out


def _leaf(tree, path):
    for part in path.split("."):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codes_and_scales_are_jaxs(dtype):
    """Weights (conv OIHW and dense, a zero output channel among them) and
    activations (a zero example among them): the same int8 codes and
    float32 scales bit for bit, ties rounded half to even."""
    rng = np.random.default_rng(3)
    jdt, pdt = jnp.dtype(dtype), getattr(torch, dtype)
    for shape in ((16, 8, 3, 3), (24, 40)):
        w = rng.standard_normal(shape).astype(np.float32)
        w[1] = 0.0
        w[2, 0] = 127.0 * 0.5 / 127.0 * 2.5   # exact halves after scaling
        jw = jnp.asarray(w).astype(jdt)
        pw = torch.from_numpy(w).to(pdt)
        jq, js = JQ.quantize_weight_int8(jw)
        pq, ps = Q.quantize_weight_int8(pw)
        np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
        assert ps[1] == 1.0 and pq.dtype == torch.int8
    x = rng.standard_normal((3, 5, 7, 4)).astype(np.float32)
    x[2] = 0.0
    jq, js = JQ.quantize_activation_int8(jnp.asarray(x).astype(jdt))
    pq, ps = Q.quantize_activation_int8(torch.from_numpy(x).to(pdt))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert ps.shape == (3, 1, 1, 1) and float(ps[2]) == 1.0


def _student(variant):
    cfg = PC.STUDENT_CONFIGS[variant](V, embed_size=WIDTHS[variant],
                                      hidden_size=24)
    p, s = student_init(0, cfg)
    m = Student(cfg)
    m.load_state_dict(CV.jax_student_to_state_dict(p, s, cfg), strict=True)
    return cfg, p, s, m.eval()


def _teacher():
    cfg = PC.TeacherConfig(vocab_size=V, **TEACHER)
    p = teacher_init(0, cfg)
    m = Teacher(cfg)
    m.load_state_dict(CV.jax_teacher_to_state_dict(p), strict=True)
    return cfg, p, m.eval()


def _jit(fn, **kw):
    """JAX's rewrite compiled once for the tree (run eagerly, every
    primitive compiles once a shape: seconds a backbone)."""
    return lambda tree: jax.jit(lambda t: fn(t, **kw))(
        jax.tree.map(jnp.asarray, tree))


ARMS = {
    "full": lambda p, m: (_jit(JQ.quantize_student_encoder_int8)(p),
                          Q.quantize_student_encoder_int8(m)),
    "full exclude conv1": lambda p, m: (
        _jit(JQ.quantize_student_encoder_int8, exclude=("conv1",))(p),
        Q.quantize_student_encoder_int8(m, exclude=("conv1",))),
    "compact": lambda p, m: (_jit(JQ.quantize_student_encoder_int8)(p),
                             Q.quantize_student_encoder_int8(m)),
    "enhanced": lambda p, m: (_jit(JQ.quantize_student_encoder_int8)(p),
                              Q.quantize_student_encoder_int8(m)),
    "teacher encoder": lambda p, m: (_jit(JQ.quantize_teacher_encoder_int8)(p),
                                     Q.quantize_teacher_encoder_int8(m)),
    "teacher full": lambda p, m: (_jit(JQ.quantize_teacher_full_int8)(p),
                                  Q.quantize_teacher_full_int8(m)),
    "teacher full min_elements 3000": lambda p, m: (
        _jit(JQ.quantize_params_int8, mha=True, min_elements=3000)(p),
        Q.quantize_params_int8(m, mha=True, min_elements=3000)),
}


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_quantized_paths_and_codes_are_jaxs(arm):
    """The set of int8 weights, by path, is JAX's for every arm (the three
    students' encoders, the teacher's encoder and whole, ``exclude`` and
    ``min_elements``); embeddings, norms and the decoders' LSTM weights stay
    float; the float model is not touched.  JAX's rewrite runs compiled
    here (eagerly, each primitive compiles once a shape: 10-15 s a
    backbone), and XLA then divides by 127 as a multiply by its reciprocal:
    scales within one float32 ulp and codes within one step, where the
    eager rewrite is bit for bit (``test_codes_and_scales_are_jaxs``)."""
    variant = arm.split()[0]
    if variant == "teacher":
        _, p, m = _teacher()
    else:
        _, p, _, m = _student(variant)
    jtree, qm = ARMS[arm](p, m)
    got, ref = Q.quantized_paths(qm), _jax_paths(jtree)
    assert got == ref and len(got) == Q.count_quantized(qm) \
        == JQ.count_quantized(jtree) > 0
    if "exclude" in arm:       # every child named conv1, at any depth
        assert not any(k.endswith(".conv1") for k in got)
        assert "encoder.resnet.layer1.0.conv2" in got
    if "full" in arm and variant == "teacher":
        assert got["decoder.0.self_attn"] == "in_proj_weight_q"
        assert "decoder.1.multihead_attn.out_proj" in got
        assert "embedding" not in got and "decoder.0.norm1" not in got
        assert ("fc_out" in got) == ("min_elements" in arm)  # 3,200 weights
    sd = qm.state_dict()
    for path, key in got.items():
        leaf = _leaf(jtree, path)
        scale = "w_scale" if key == "weight_q" else "in_proj_scale"
        codes = sd[f"{path}.{key}"].numpy().astype(np.int32)
        assert np.abs(codes - np.asarray(leaf[key])).max() <= 1, path
        np.testing.assert_allclose(sd[f"{path}.{scale}"].numpy(),
                                   np.asarray(leaf[scale]), rtol=1.2e-7,
                                   atol=0, err_msg=path)
    assert not any(Q.is_quantized(mod) for mod in m.modules())
    assert all(p_.dtype != torch.int8 for p_ in m.state_dict().values())


# (in, out, kernel, stride, padding, groups, bias): stem-like, 3x3 stride
# 2, a depthwise 5x5 with bias, a 1x1 with bias
CONVS = [(3, 16, 7, 2, 3, 1, False), (16, 24, 3, 2, 1, 1, False),
         (24, 24, 5, 1, 2, 24, True), (24, 40, 1, 1, 0, 1, True)]


@pytest.mark.parametrize("case", range(len(CONVS)))
@pytest.mark.parametrize("static", [False, True])
def test_conv2d_int8_is_jaxs(case, static):
    """``Conv2d`` on ``weight_q`` against ``quant.conv2d_int8``, dynamic
    (per example) and static scales: bit for bit against JAX run eagerly.
    Against ``jax.jit`` (dynamic scales) within two float32 ulps of the
    largest output: there XLA contracts the epilogue's multiply and bias
    add into one fused multiply-add and divides by 127 as a multiply by
    its reciprocal, one ulp each."""
    cin, cout, k, st, pad, g, bias = CONVS[case]
    rng = np.random.default_rng(case)
    x = rng.standard_normal((2, cin, 11, 11)).astype(np.float32)
    m = Conv2d(cin, cout, k, stride=st, padding=pad, bias=bias, groups=g)
    m.weight.data = torch.from_numpy(
        rng.standard_normal(m.weight.shape).astype(np.float32) * 0.1)
    if bias:
        m.bias.data = torch.from_numpy(
            rng.standard_normal(cout).astype(np.float32))
    qm = Q.quantize_params_int8(m, min_elements=1)
    jp = JQ.quantize_params_int8({"c": {k_: jnp.asarray(v.numpy()) for k_, v
                                        in m.state_dict().items()}},
                                 min_elements=1)["c"]
    if static:
        qm.register_buffer("x_scale", torch.tensor(0.013, dtype=torch.float32))
        jp = dict(jp, x_scale=jnp.asarray(0.013, jnp.float32))
    xj = jnp.asarray(x.transpose(0, 2, 3, 1))

    def jfn(p, x_):
        return JQ.conv2d_int8(p, x_, stride=st, padding=pad, groups=g)
    with jax.disable_jit():
        eager = np.asarray(jfn(jp, xj)).transpose(0, 3, 1, 2)
    got = qm(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, eager)
    if not static:
        jitted = np.asarray(jax.jit(jfn)(jp, xj)).transpose(0, 3, 1, 2)
        np.testing.assert_allclose(got, jitted, rtol=0,
                                   atol=2.4e-7 * np.abs(jitted).max())
    y = qm(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16


@pytest.mark.parametrize("static", [False, True])
def test_dense_int8_is_jaxs(static):
    """``Linear`` on ``weight_q`` over (B, L, K) (one scale an example) and
    (B, K): JAX's ``dense_int8`` bit for bit, eagerly."""
    rng = np.random.default_rng(9)
    m = Linear(40, 24)
    m.weight.data = torch.from_numpy(rng.standard_normal((24, 40)).astype(
        np.float32))
    m.bias.data = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    qm = Q.quantize_params_int8(m, min_elements=1)
    jp = JQ.quantize_params_int8({"d": {k: jnp.asarray(v.numpy()) for k, v
                                        in m.state_dict().items()}},
                                 min_elements=1)["d"]
    if static:
        qm.register_buffer("x_scale", torch.tensor(0.02, dtype=torch.float32))
        jp = dict(jp, x_scale=jnp.asarray(0.02, jnp.float32))
    for shape in ((3, 7, 40), (5, 40)):
        x = rng.standard_normal(shape).astype(np.float32)
        with jax.disable_jit():
            ref = np.asarray(JQ.dense_int8(jp, jnp.asarray(x)))
        np.testing.assert_array_equal(qm(torch.from_numpy(x)).numpy(), ref)


def test_plain_int8_product_is_exact():
    """The plain version's float64 sums are the exact integer sums, at a
    window whose sums pass float32's 2^24 (3x3x512 of +-127)."""
    x = torch.full((1, 3, 3, 512), 127, dtype=torch.int8)
    w = torch.full((2, 512, 3, 3), -127, dtype=torch.int8)
    w[1, 0, 0, 0] = 126
    one = torch.ones(1)
    y = I8.int8_conv_plain(x, w, one, torch.ones(2), None, padding=0,
                           rows_per_scale=1)
    exact = [-127 * 127 * 4608, -127 * 127 * 4607 + 127 * 126]
    assert exact[0] < -2 ** 24
    assert y.reshape(-1).tolist() == [float(np.float32(e)) for e in exact]
    with pytest.raises(ValueError, match="CUDA"):
        I8.int8_conv_cuda(x, w, one, torch.ones(2), None, rows_per_scale=1)


def test_packed_weight_rows():
    """The kernel's weight rows: (kh, kw, C/g) order, zero up to a multiple
    of 128 (the kernel's stage depth, and its TMA tile's 128 bytes); a dense
    weight packs as its 1x1 convolution; a row slice of a packed
    in-projection is the packing of the slice."""
    w = torch.arange(5 * 3 * 7 * 7, dtype=torch.int64).remainder(251).sub(
        125).to(torch.int8).reshape(5, 3, 7, 7)
    p = I8.pack_weight(w)
    assert I8.K_ALIGN == 128
    assert p.shape == (5, 256) and p.dtype == torch.int8 and p.is_contiguous()
    assert torch.equal(p[:, :147], w.permute(0, 2, 3, 1).reshape(5, 147))
    assert not p[:, 147:].any()
    d = w.reshape(5, -1)[:, :64].contiguous()
    assert torch.equal(I8.pack_weight(d), I8.pack_weight(d[:, :, None, None]))
    assert torch.equal(I8.pack_weight(d)[2:4], I8.pack_weight(d[2:4]))


def test_student_features_through_jaxs_quantized_tree():
    """JAX's own quantized compact student (its encoder compiled, as its
    serving CLI runs it) loaded into the port: refined features 1e-3
    relative in L2 (a code at a .5 boundary may flip between the packages'
    float paths; here none did: the difference is XLA's fused epilogue)."""
    cfg, p, s, m = _student("compact")
    jcfg = JC.compact_student_config(V, embed_size=16, hidden_size=24)
    jq = _jit(JQ.quantize_student_encoder_int8)(p)
    imgs = np.random.default_rng(7).integers(0, 256, (2, S, S, 3),
                                             dtype=np.uint8)
    ref = np.asarray(jax.jit(lambda q, st, x: JSM.encode_image(
        q, st, x, jcfg, train=False)[1])(
            jq, jax.tree.map(jnp.asarray, s), JT.normalize(jnp.asarray(imgs))))
    qm = Q.quantize_student_encoder_int8(m)
    Q.load_int8_state_dict(qm, CV.jax_student_to_state_dict(
        jax.tree.map(np.asarray, jq), s, cfg))
    with torch.inference_mode():
        got = qm.encode_image(PT.normalize(torch.from_numpy(imgs)))[1].numpy()
    assert np.linalg.norm(got - ref) <= 1e-3 * np.linalg.norm(ref)


def test_teacher_logits_and_scales_through_jaxs_int8_full_tree():
    """The whole teacher quantized (packed in-projections included) by JAX
    and calibrated by JAX on teacher-forced captions (eagerly, as JAX
    calibrates), loaded into the port: logits 1e-3 relative in L2 against
    JAX's compiled forward, uncalibrated and calibrated.  The port's own
    calibration on the same inputs gives static scales to the same layers
    (each in-projection's three inputs folded into one scale), each within
    1e-5 relative of JAX's; an uncalibrated copy keeps dynamic scales, and
    the recording context refuses to nest."""
    cfg, p, m = _teacher()
    jcfg = JC.TeacherConfig(vocab_size=V, **TEACHER)
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, (2, S, S, 3), dtype=np.uint8)
    caps = np.concatenate([np.ones((1, 2), np.int32),
                           rng.integers(4, V, (5, 2)).astype(np.int32)])
    xj, cj = JT.normalize(jnp.asarray(imgs)), jnp.asarray(caps)
    jq = _jit(JQ.quantize_teacher_full_int8)(p)
    jcal = JQ.calibrate_activation_scales(
        jq, lambda q: JTM.teacher_apply(q, xj, cj, jcfg), margin=1.25)
    apply = jax.jit(lambda q: JTM.teacher_apply(q, xj, cj, jcfg))
    x, pc = PT.normalize(torch.from_numpy(imgs)), torch.from_numpy(caps)
    for tree in (jq, jcal):
        want = np.asarray(apply(tree))
        qm = Q.quantize_teacher_full_int8(m)
        Q.load_int8_state_dict(qm, CV.jax_teacher_to_state_dict(
            jax.tree.map(np.asarray, tree)))
        with torch.inference_mode():
            got = qm(x, pc).numpy()
        assert np.linalg.norm(got - want) <= 1e-3 * np.linalg.norm(want)
    plain = Q.quantize_teacher_full_int8(m)
    own = Q.calibrate_activation_scales(plain, lambda q: q(x, pc),
                                        margin=1.25)
    got = {f"{n}.{k}": float(v) for n, mod in own.named_modules()
           for k, v in mod._buffers.items()
           if k in ("x_scale", "in_proj_x_scale")}
    ref = {k: float(v) for k, v in CV.jax_teacher_to_state_dict(
        jax.tree.map(np.asarray, jcal)).items() if k.endswith("x_scale")}
    assert set(got) == set(ref) and len(got) == Q.count_quantized(own)
    assert "decoder.1.multihead_attn.in_proj_x_scale" in got
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-5), k
    assert not any(k.endswith("x_scale") for k in plain.state_dict())
    with pytest.raises(RuntimeError, match="not reentrant"), Q.recording():
        Q.calibrate_activation_scales(own, lambda q: None)


def test_int8_full_calibrated_cli_writes_the_jax_clis_captions(artifacts):  # noqa: F811
    """``--int8-full --int8-calibrate 2`` on the tiny sharpened teacher:
    the port's CLI writes the JAX CLI's captions (the float teacher's
    greedy captions of the first two images calibrate both packages)."""
    extra = ["--int8-full", "--int8-calibrate", "2"]
    ref, got = artifacts / "jax_full_cal.jsonl", artifacts / "port_cal.jsonl"
    assert jserve.main(_args(artifacts, ref, *extra)) == 0
    assert serve.main(_args(artifacts, got, "--device", "cpu", *extra)) == 0
    rows = got.read_text().splitlines()
    assert len(rows) == 5 and rows == ref.read_text().splitlines()


@pytest.mark.parametrize("extra", [
    ["--model", "student", "--int8-full"],
    ["--model", "teacher", "--int8-calibrate", "2"],
    ["--model", "student", "--int8-calibrate", "3", "--int8-margin", "2"]])
def test_parse_errors_are_the_jax_clis(extra, capsys):
    """Both CLIs refuse the same flag combinations with the same message
    and exit code 2, before reading anything."""
    base = ["--checkpoint", "c.npz", "--vocab", "v.json", "--images", "i"]
    codes, errs = [], []
    for main in (jserve.main, lambda a: serve.main(a + ["--device", "cpu"])):
        with pytest.raises(SystemExit) as e:
            main(base + extra)
        codes.append(e.value.code)
        errs.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert codes == [2, 2]
    assert errs[0].split("error: ")[1] == errs[1].split("error: ")[1]
