"""The port's building blocks against imagecaptioner_tpu.core.modules.

Inputs come from numpy seeds and go to both sides; everything runs at
float32 on the CPU, where the port takes its plain versions.  atol 1e-5:
the two sides sum in different orders at float32.
"""

import ast
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core import config as JC
from imagecaptioner_tpu.core import modules as JM
from imagecaptioner_tpu.data import transforms as JT
from imagecaptioner_tpu.data.vocabulary import Vocabulary as JVocabulary
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core import modules as PM
from imagecaptioner_tpu_torch.data import transforms as PT
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


@pytest.mark.parametrize("groups,k,stride", [(6, 3, 1), (6, 5, 2), (2, 3, 1)])
def test_conv2d_grouped(groups, k, stride):
    """Depthwise (groups = channels) and grouped convolutions, as MobileNetV2
    and EfficientNet-B3 use them."""
    x = _np(2, 6, 13, 13, seed=8)
    w = _np(12, 6 // groups, k, k, seed=9, scale=0.2)   # (O, I/groups, kH, kW)
    ref = JM.conv2d({"weight": jnp.asarray(w)},
                    jnp.asarray(x.transpose(0, 2, 3, 1)), stride=stride,
                    padding=k // 2, groups=groups)
    got = PM.conv2d(_t(x), _t(w), stride=stride, padding=k // 2, groups=groups)
    _close(got.permute(0, 2, 3, 1), ref)
    conv = PM.Conv2d(6, 12, k, stride=stride, padding=k // 2, groups=groups)
    assert conv.weight.shape == w.shape
    conv.load_state_dict({"weight": _t(w)})
    _close(conv(_t(x)).permute(0, 2, 3, 1), ref)
    init = PM.conv2d_init(np.random.default_rng(0), 6, 12, k, groups=groups)
    assert init["weight"].shape == w.shape


def test_relu6_and_silu():
    from imagecaptioner_tpu.models.mobilenet import relu6 as j_relu6
    x = _np(4, 9, seed=30, scale=5.0)
    _close(PM.relu6(_t(x)), j_relu6(jnp.asarray(x)), atol=0)
    _close(PM.silu(_t(x)), jax.nn.silu(jnp.asarray(x)), atol=1e-6)


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


def test_adaptive_avg_pool2d_to_a_larger_map():
    """The enhanced encoder pools to 8x8; at a 64x64 image the map is 2x2."""
    x = _np(2, 5, 2, 2, seed=16)
    ref = JM.adaptive_avg_pool2d(jnp.asarray(x.transpose(0, 2, 3, 1)), (8, 8))
    got = PM.adaptive_avg_pool2d(_t(x), (8, 8))
    assert got.shape == (2, 5, 8, 8)
    _close(got.permute(0, 2, 3, 1), ref)
    _close(got, torch.nn.functional.adaptive_avg_pool2d(_t(x), (8, 8)))


@pytest.mark.parametrize("lq,lk,heads", [(1, 9, 8), (5, 12, 4)])
def test_multi_head_attention_need_weights(lq, lk, heads):
    """``need_weights``: the head-averaged weights beside the output."""
    E = 32
    w_in, b_in = _np(3 * E, E, seed=17, scale=0.2), _np(3 * E, seed=18)
    w_out, b_out = _np(E, E, seed=19, scale=0.2), _np(E, seed=20)
    q, kv = _np(2, lq, E, seed=21), _np(2, lk, E, seed=22)
    jp = {"in_proj_weight": jnp.asarray(w_in), "in_proj_bias": jnp.asarray(b_in),
          "out_proj": {"weight": jnp.asarray(w_out), "bias": jnp.asarray(b_out)}}
    ref, ref_w = JM.multi_head_attention(
        jp, jnp.asarray(q), jnp.asarray(kv), jnp.asarray(kv), num_heads=heads,
        need_weights=True)
    mha = PM.MultiheadAttention(E, heads)
    mha.load_state_dict({"in_proj_weight": _t(w_in), "in_proj_bias": _t(b_in),
                         "out_proj.weight": _t(w_out),
                         "out_proj.bias": _t(b_out)}, strict=True)
    out, w = mha(_t(q), _t(kv), _t(kv), need_weights=True)
    assert w.shape == (2, lq, lk)
    _close(out, ref)
    _close(w, ref_w)
    _close(w.sum(-1), np.ones((2, lq)))
    _close(mha(_t(q), _t(kv), _t(kv)), ref)
    # in train mode the returned weights are the dropped ones
    mha.train()
    _, wd = mha(_t(q), _t(kv), _t(kv), need_weights=True, dropout_rate=0.5,
                generator=torch.Generator().manual_seed(0))
    assert float((wd.sum(-1) - 1).abs().max()) > 1e-3


def test_student_config_matches_jax_field_for_field():
    jf = [(f.name, f.default) for f in dataclasses.fields(JC.StudentConfig)]
    pf = [(f.name, f.default) for f in dataclasses.fields(PC.StudentConfig)]
    assert pf == jf
    over = dict(embed_size=16, hidden_size=24)
    assert (dataclasses.asdict(PC.full_student_config(2994, **over))
            == dataclasses.asdict(JC.full_student_config(2994, **over)))
    for jf_, pf_ in ((JC.compact_student_config, PC.compact_student_config),
                     (JC.enhanced_student_config, PC.enhanced_student_config)):
        assert (dataclasses.asdict(pf_(2994)) == dataclasses.asdict(jf_(2994)))
        assert (dataclasses.asdict(pf_(50, **over))
                == dataclasses.asdict(jf_(50, **over)))
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


@pytest.mark.parametrize("name", ["TeacherConfig", "DistillConfig",
                                  "KDTrainConfig", "TeacherTrainConfig",
                                  "DataConfig", "OptimizedDistillConfig",
                                  "OptimizedKDTrainConfig"])
def test_training_configs_match_jax_field_for_field(name):
    jf = [(f.name, f.default) for f in dataclasses.fields(getattr(JC, name))]
    pf = [(f.name, f.default) for f in dataclasses.fields(getattr(PC, name))]
    assert pf == jf
    if name == "TeacherConfig":
        assert PC.TeacherConfig().num_tokens == JC.TeacherConfig().num_tokens
        assert PC.replace(PC.TeacherConfig(), image_size=32).num_tokens == 5


def test_batch_norm_train_matches_jax_and_updates_running_stats():
    x = _np(4, 8, 5, 5, seed=30, scale=2.0) + 0.5
    w, b = _np(8, seed=31), _np(8, seed=32)
    mean = _np(8, seed=33)
    var = np.abs(_np(8, seed=34)) + 0.5
    ref, new = JM.batch_norm(
        {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
        {"running_mean": jnp.asarray(mean), "running_var": jnp.asarray(var)},
        jnp.asarray(x.transpose(0, 2, 3, 1)), train=True)
    bn = PM.BatchNorm2d(8)
    bn.load_state_dict({"weight": _t(w), "bias": _t(b), "running_mean":
                        _t(mean), "running_var": _t(var)})
    got = bn.train()(_t(x))
    _close(got.permute(0, 2, 3, 1), ref)
    _close(bn.running_mean, new["running_mean"])
    _close(bn.running_var, new["running_var"])
    # frozen affine parameters do not stop the statistics from updating
    assert not bn.weight.requires_grad
    before = bn.running_mean.clone()
    bn.eval()(_t(x))
    assert torch.equal(bn.running_mean, before)


def test_dropout_semantics():
    x = _t(_np(6, 10, seed=35))
    assert PM.dropout(x, 0.5, False) is x and PM.dropout(x, 0.0, True) is x
    with pytest.raises(ValueError, match="Generator"):
        PM.dropout(x, 0.5, True)
    keep = np.random.default_rng(36).random((6, 10)) < 0.7
    key = jax.random.PRNGKey(0)
    got = PM.dropout(x, 0.3, True, mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(),
                               np.where(keep, x.numpy() / 0.7, 0.0), atol=1e-7)
    # the same inverted-dropout rule as the JAX function, on its own mask
    jmask = np.asarray(jax.random.bernoulli(key, 0.7, (6, 10)))
    _close(PM.dropout(x, 0.3, True, mask=torch.from_numpy(jmask)),
           JM.dropout(key, jnp.asarray(x.numpy()), 0.3, True), atol=1e-7)
    g = torch.Generator().manual_seed(0)
    big = torch.ones(200, 200)
    kept = (PM.dropout(big, 0.3, True, g) != 0).float().mean().item()
    assert abs(kept - 0.7) < 0.02
    with PM.no_dropout():
        assert PM.dropout(x, 0.5, True) is x
    with pytest.raises(ValueError):
        PM.dropout(x, 0.5, True)


def test_positional_encoding_gelu_and_pool1d():
    np.testing.assert_array_equal(PM.sinusoidal_positional_encoding(50, 16),
                                  JM.sinusoidal_positional_encoding(50, 16))
    x = _np(3, 7, seed=37, scale=2.0)
    _close(PM.gelu(_t(x)), jax.nn.gelu(jnp.asarray(x), approximate=False),
           atol=1e-6)
    y = _np(2, 6, 17, seed=38)
    _close(PM.adaptive_avg_pool1d(_t(y), 5),
           JM.adaptive_avg_pool1d(jnp.asarray(y), 5))


def test_conv2d_with_bias():
    x, w, b = _np(2, 3, 32, 32, seed=39), _np(8, 3, 16, 16, seed=40, scale=0.1), \
        _np(8, seed=41)
    ref = JM.conv2d({"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                    jnp.asarray(x.transpose(0, 2, 3, 1)), stride=16, padding=0)
    conv = PM.Conv2d(3, 8, 16, stride=16, bias=True)
    conv.load_state_dict({"weight": _t(w), "bias": _t(b)})
    _close(conv(_t(x)).permute(0, 2, 3, 1), ref, atol=5e-5)


def test_color_jitter_and_flip_match_jax_on_shared_draws():
    """The JAX functions draw their factors from a key; the same factors,
    computed here as they do, go ready-made to the port."""
    cfg = JT.KD_TRAIN_AUG
    pcfg = PT.KD_TRAIN_AUG
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(cfg)
    x = np.random.default_rng(42).random((3, 8, 8, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    kb, kc, ks, kh = jax.random.split(key, 4)
    u = lambda k, f: np.asarray(jax.random.uniform(  # noqa: E731
        k, (3, 1, 1, 1), minval=max(0.0, 1.0 - f), maxval=1.0 + f))
    factors = {"brightness": _t(u(kb, cfg.brightness)),
               "contrast": _t(u(kc, cfg.contrast)),
               "saturation": _t(u(ks, cfg.saturation)),
               "hue": _t(np.asarray(jax.random.uniform(
                   kh, (3, 1, 1), minval=-cfg.hue, maxval=cfg.hue)))}
    ref = JT.color_jitter(key, jnp.asarray(x), cfg)
    _close(PT.color_jitter(_t(x), pcfg, None, factors), ref)
    flip = np.asarray(jax.random.bernoulli(key, 0.5, (3, 1, 1, 1)))
    _close(PT.random_hflip(_t(x), 0.5, None, torch.from_numpy(flip[:, 0, 0, 0])),
           JT.random_hflip(key, jnp.asarray(x), 0.5), atol=0)
    u8 = np.random.default_rng(43).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    _close(PT.augment_and_normalize(torch.from_numpy(u8), PT.AugmentConfig(),
                                    None),
           JT.augment_and_normalize(key, jnp.asarray(u8), JT.AugmentConfig()),
           atol=1e-6)
    g = torch.Generator().manual_seed(1)
    out = PT.augment_and_normalize(torch.from_numpy(u8), pcfg, g)
    assert out.shape == (2, 3, 8, 8) and torch.isfinite(out).all()
    # the optimized trainer's pipeline (crop and rotation) is ported too
    crop = dataclasses.replace(PT.OPTIMIZED_KD_AUG, out_size=6)
    out = PT.augment_and_normalize(torch.from_numpy(u8), crop, g)
    assert out.shape == (2, 3, 6, 6) and torch.isfinite(out).all()


REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(REPO)) for p in
                    (REPO / "imagecaptioner_tpu_torch").rglob("*.py")
                    ) + ["chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax_and_picks_no_device(path):
    """Every file of the port and the smoke script: no import of jax or of
    the JAX package, and no ``"cuda" if torch.cuda.is_available() else
    "cpu"``-style fallback to the CPU."""
    src = (REPO / path).read_text()
    for node in ast.walk(ast.parse(src)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        for n in names:
            root = n.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax",
                                "imagecaptioner_tpu"), f"{path} imports {n}"
    picks = re.findall(r"is_available\(\)\s*else|if\s+torch\.cuda\.is_available"
                       r"\(\)\s*else|else\s+[\"']cpu[\"']", src)
    assert not picks, f"{path} picks its device by itself: {picks}"


class _ImportsRunAtImport(ast.NodeVisitor):
    """The modules a file imports when it is imported: every import outside
    a function body (class bodies run at import)."""

    def __init__(self):
        self.roots = set()

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_Lambda = visit_FunctionDef

    def visit_Import(self, node):
        self.roots.update(a.name.split(".")[0] for a in node.names)

    def visit_ImportFrom(self, node):
        self.roots.add((node.module or "").split(".")[0])


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_pandas_pil_or_matplotlib_at_module_level(path):
    """The card's machine has no pandas, PIL, matplotlib or streamlit: no
    file of the port imports pandas at all, and PIL, matplotlib and
    streamlit only inside the function that uses them, so importing any
    module (the runners' too) needs none of them."""
    tree = ast.parse((REPO / path).read_text())
    anywhere = {(n.module or "") if isinstance(n, ast.ImportFrom) else a.name
                for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in (n.names if isinstance(n, ast.Import) else [n])}
    assert not any(m.split(".")[0] == "pandas" for m in anywhere), \
        f"{path} imports pandas"
    top = _ImportsRunAtImport()
    top.visit(tree)
    banned = top.roots & {"PIL", "matplotlib", "pandas", "streamlit"}
    assert not banned, f"{path} imports {banned} at module level"
