"""The reference pipeline's ``.pth`` checkpoints -> the port, and back
(``imagecaptioner_tpu/utils/torch_convert.py``, in numpy).

The original PyTorch repository saves state dicts of its own modules: the
timm ViT-S/16 + ``nn.TransformerDecoder`` teacher, the torchvision
ResNet-50 and MobileNetV2 students and the EfficientNet-B3 one, each inside
a checkpoint dict (``epoch``, ``model_state_dict``, ``vocab_size``, ...).
Their tensors already have the layouts the port keeps (Linear (out, in),
conv OIHW), so an import is a re-keying into the JAX-layout trees that
``utils/convert.jax_teacher_to_state_dict`` and
``jax_student_to_state_dict`` load with ``strict=True``.

A keymap is the JAX tree with each leaf replaced by the reference key that
holds it.  ``*_from_reference`` reads a reference state dict through it and
raises if a key is left over (the teacher's ``pe`` table, a buffer the port
rebuilds, aside); ``*_to_reference`` writes a tree back under the reference
keys.  The block tables come from the port's own models
(``models/resnet.STAGES``, ``models/mobilenet.block_meta``,
``models/efficientnet.STAGES``).

The enhanced student has two projections with no reference counterpart
(``decoder.query_projection``, ``decoder.highway_context_projection``: the
reference builds a fresh random Linear inside its forward and its highway
gate cannot broadcast).  ``enhanced_student_from_reference`` takes them as
an argument, or draws them from a numpy seed with ``linear_init``.

``load_reference_pth`` reads a file with ``weights_only=True`` unless the
caller passes ``allow_pickle=True``.

  ck = load_reference_pth("best_teacher_model.pth")
  cfg = TeacherConfig(vocab_size=int(ck["vocab_size"]))
  teacher = Teacher(cfg)
  teacher.load_state_dict(jax_teacher_to_state_dict(
      teacher_from_reference(ck["model_state_dict"], cfg)), strict=True)
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from imagecaptioner_tpu_torch.core.config import StudentConfig, TeacherConfig
from imagecaptioner_tpu_torch.core.modules import linear_init
from imagecaptioner_tpu_torch.models import efficientnet, mobilenet, resnet

# reference keys that hold no parameter of the port: the teacher's
# sinusoidal table, which the port rebuilds as a buffer
IGNORED = ("pe",)


def _lin(prefix: str) -> dict:
    return {"weight": f"{prefix}.weight", "bias": f"{prefix}.bias"}


def _lin_nobias(prefix: str) -> dict:
    return {"weight": f"{prefix}.weight"}


_ln = _lin


def _bn(prefix: str) -> Tuple[dict, dict]:
    return (_lin(prefix), {"running_mean": f"{prefix}.running_mean",
                           "running_var": f"{prefix}.running_var"})


def _mha(prefix: str) -> dict:
    return {"in_proj_weight": f"{prefix}.in_proj_weight",
            "in_proj_bias": f"{prefix}.in_proj_bias",
            "out_proj": _lin(f"{prefix}.out_proj")}


def _lstm(prefix: str, n: int, sep: str) -> list:
    """``lstm.weight_ih_l{i}`` (``sep='_l'``) or ``lstm_layers.{i}.weight_ih``
    (``sep='.'``) for each of ``n`` layers."""
    def key(i, name):
        return f"{prefix}.{name}_l{i}" if sep == "_l" else f"{prefix}.{i}.{name}"
    return [{k: key(i, k) for k in ("weight_ih", "weight_hh", "bias_ih",
                                    "bias_hh")} for i in range(n)]


def _read(keymap, sd, used: set):
    if isinstance(keymap, dict):
        return {k: _read(v, sd, used) for k, v in keymap.items()}
    if isinstance(keymap, list):
        return [_read(v, sd, used) for v in keymap]
    used.add(keymap)
    return np.asarray(sd[keymap])


def _import(keymaps, sd: Dict) -> tuple:
    """Each keymap of ``keymaps`` read from ``sd``; every key of ``sd`` must
    be read (``IGNORED`` aside)."""
    used: set = set()
    trees = tuple(_read(km, sd, used) for km in keymaps)
    left = sorted(k for k in sd if k not in used and k not in IGNORED)
    if left:
        raise ValueError(f"reference keys with no place in the port: {left}")
    return trees


def _export(keymap, tree, out: Dict[str, np.ndarray]) -> None:
    if isinstance(keymap, dict):
        for k, v in keymap.items():
            _export(v, tree[k], out)
    elif isinstance(keymap, list):
        for v, t in zip(keymap, tree):
            _export(v, t, out)
    else:
        out[keymap] = np.asarray(tree)


def _export_all(pairs) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for keymap, tree in pairs:
        _export(keymap, tree, out)
    return out


# ---------------------------------------------------------------------------
# Teacher (timm ViT-S/16 + torch TransformerDecoder, teacher_model.py)
# ---------------------------------------------------------------------------


def teacher_keymap(cfg: TeacherConfig) -> dict:
    enc = {
        "patch_embed": {"proj": _lin("encoder.patch_embed.proj")},
        "cls_token": "encoder.cls_token",
        "pos_embed": "encoder.pos_embed",
        "blocks": [{
            "norm1": _ln(f"encoder.blocks.{i}.norm1"),
            "attn": {"qkv": _lin(f"encoder.blocks.{i}.attn.qkv"),
                     "proj": _lin(f"encoder.blocks.{i}.attn.proj")},
            "norm2": _ln(f"encoder.blocks.{i}.norm2"),
            "mlp": {"fc1": _lin(f"encoder.blocks.{i}.mlp.fc1"),
                    "fc2": _lin(f"encoder.blocks.{i}.mlp.fc2")},
        } for i in range(cfg.encoder_depth)],
        "norm": _ln("encoder.norm"),
    }
    km = {
        "encoder": enc,
        "embedding": _lin_nobias("embedding"),
        "decoder": [{
            "self_attn": _mha(f"decoder.layers.{i}.self_attn"),
            "multihead_attn": _mha(f"decoder.layers.{i}.multihead_attn"),
            "linear1": _lin(f"decoder.layers.{i}.linear1"),
            "linear2": _lin(f"decoder.layers.{i}.linear2"),
            "norm1": _ln(f"decoder.layers.{i}.norm1"),
            "norm2": _ln(f"decoder.layers.{i}.norm2"),
            "norm3": _ln(f"decoder.layers.{i}.norm3"),
        } for i in range(cfg.num_decoder_layers)],
        "pre_output_norm": _ln("pre_output_norm"),
        "fc_out": _lin("fc_out"),
    }
    if cfg.encoder_dim != cfg.embed_size:
        km["encoder_projection"] = _lin("encoder_projection")
    return km


def teacher_from_reference(sd: Dict, cfg: TeacherConfig) -> dict:
    """A reference teacher state dict -> the JAX-layout parameter tree."""
    return _import([teacher_keymap(cfg)], sd)[0]


def teacher_to_reference(params: dict, cfg: TeacherConfig
                         ) -> Dict[str, np.ndarray]:
    return _export_all([(teacher_keymap(cfg), params)])


# ---------------------------------------------------------------------------
# Full student (torchvision ResNet-50, student_model.py)
# ---------------------------------------------------------------------------


def _resnet_keymap() -> Tuple[dict, dict]:
    """conv1 / bn1 / layer{L}[b] <-> the reference's nn.Sequential of the
    torchvision children: 0=conv1, 1=bn1, 2=relu, 3=maxpool, 4..7=layers."""
    p = {"conv1": _lin_nobias("encoder.resnet.0")}
    s = {}
    p["bn1"], s["bn1"] = _bn("encoder.resnet.1")
    for li, (blocks, _mid, _stride) in enumerate(resnet.STAGES, start=1):
        pl, sl = [], []
        for b in range(blocks):
            pref = f"encoder.resnet.{3 + li}.{b}"
            bp = {f"conv{i}": _lin_nobias(f"{pref}.conv{i}") for i in (1, 2, 3)}
            bs = {}
            for i in (1, 2, 3):
                bp[f"bn{i}"], bs[f"bn{i}"] = _bn(f"{pref}.bn{i}")
            if b == 0:
                bp["downsample"] = {"conv": _lin_nobias(f"{pref}.downsample.0")}
                bp["downsample"]["bn"], bs["downsample_bn"] = _bn(
                    f"{pref}.downsample.1")
            pl.append(bp)
            sl.append(bs)
        p[f"layer{li}"], s[f"layer{li}"] = pl, sl
    return p, s


def full_student_keymap(cfg: StudentConfig) -> Tuple[dict, dict]:
    rp, rs = _resnet_keymap()
    params_km = {
        "encoder": {
            "resnet": rp,
            "projection": {"fc": _lin("encoder.projection.0"),
                           "ln": _ln("encoder.projection.3")},
        },
        "decoder": {
            "embedding": _lin_nobias("decoder.embedding"),
            "attention": _lin("decoder.attention"),
            "attention_combine": _lin("decoder.attention_combine"),
            "lstm": _lstm("decoder.lstm", cfg.num_layers, "_l"),
            "output_projection": {
                "fc1": _lin("decoder.output_projection.0"),
                "fc2": _lin("decoder.output_projection.3"),
            },
        },
    }
    if cfg.use_attention_refinement:
        params_km["attention_refinement"] = {
            "attention": _mha("attention_refinement.attention"),
            "ffn": {"fc1": _lin("attention_refinement.ffn.0"),
                    "fc2": _lin("attention_refinement.ffn.3")},
            "norm1": _ln("attention_refinement.norm1"),
            "norm2": _ln("attention_refinement.norm2"),
        }
    return params_km, {"resnet": rs}


# ---------------------------------------------------------------------------
# Compact student (torchvision MobileNetV2, student_model_compact.py)
# ---------------------------------------------------------------------------


def _conv_bn(conv_key: str, bn_key: str) -> Tuple[dict, dict]:
    p = {"conv": _lin_nobias(conv_key)}
    p["bn"], s = _bn(bn_key)
    return p, s


def _mobilenet_keymap() -> Tuple[dict, dict]:
    """torchvision ``features`` naming under ``encoder.backbone``; an
    inverted residual with expansion is conv.0 expand / conv.1 depthwise /
    conv.2 project / conv.3 its bn, without one everything shifts down."""
    fp, fs = [], []
    p0, s0 = _conv_bn("encoder.backbone.0.0", "encoder.backbone.0.1")
    fp.append(p0)
    fs.append(s0)
    for bi, (_in, _out, t, _stride) in enumerate(mobilenet.block_meta(),
                                                 start=1):
        pref = f"encoder.backbone.{bi}.conv"
        bp, bs = {}, {}
        if t != 1:
            bp["expand"], bs["expand"] = _conv_bn(f"{pref}.0.0", f"{pref}.0.1")
            bp["depthwise"], bs["depthwise"] = _conv_bn(f"{pref}.1.0",
                                                        f"{pref}.1.1")
            proj, projbn = f"{pref}.2", f"{pref}.3"
        else:
            bp["depthwise"], bs["depthwise"] = _conv_bn(f"{pref}.0.0",
                                                        f"{pref}.0.1")
            proj, projbn = f"{pref}.1", f"{pref}.2"
        bp["project"], bs["project"] = _conv_bn(proj, projbn)
        fp.append(bp)
        fs.append(bs)
    last = len(fp)
    ph, sh = _conv_bn(f"encoder.backbone.{last}.0", f"encoder.backbone.{last}.1")
    fp.append(ph)
    fs.append(sh)
    return {"features": fp}, {"features": fs}


def compact_student_keymap(cfg: StudentConfig) -> Tuple[dict, dict]:
    mp, ms = _mobilenet_keymap()
    params_km = {
        "encoder": {"backbone": mp,
                    "projection": {"fc": _lin("encoder.projection.0")}},
        "decoder": {
            "embedding": _lin_nobias("decoder.embedding"),
            "attention": _lin("decoder.attention"),
            "lstm": _lstm("decoder.lstm", cfg.num_layers, "_l"),
            "output_projection": _lin("decoder.output_projection"),
        },
    }
    if cfg.use_attention_refinement:
        params_km["attention_refinement"] = {
            "attention": _mha("attention_refinement"), "norm": _ln("norm")}
    return params_km, {"backbone": ms}


# ---------------------------------------------------------------------------
# Enhanced student (EfficientNet-B3, student_model_enhanced.py)
# ---------------------------------------------------------------------------


def _efficientnet_keymap() -> Tuple[dict, dict]:
    """torchvision efficientnet_b3 ``features`` naming under
    ``encoder.backbone.0`` (the reference wraps Sequential(features,
    avgpool)).  An MBConv with expansion is block.0 expand / block.1
    depthwise / block.2 SE / block.3 project; stage 1 (t=1) has no expand,
    so everything shifts down one."""
    def conv_bn(prefix):
        return _conv_bn(f"{prefix}.0", f"{prefix}.1")

    root = "encoder.backbone.0"
    p, s = {}, {}
    p["stem"], s["stem"] = conv_bn(f"{root}.0")
    p["stages"], s["stages"] = [], []
    for si, (t, _in, _out, blocks, _st, _k) in enumerate(efficientnet.STAGES,
                                                         start=1):
        sp, ss = [], []
        for b in range(blocks):
            pref = f"{root}.{si}.{b}.block"
            bp, bs = {}, {}
            j = 0
            if t != 1:
                bp["expand"], bs["expand"] = conv_bn(f"{pref}.{j}")
                j += 1
            bp["depthwise"], bs["depthwise"] = conv_bn(f"{pref}.{j}")
            bp["se"] = {"fc1": _lin(f"{pref}.{j + 1}.fc1"),
                        "fc2": _lin(f"{pref}.{j + 1}.fc2")}
            bp["project"], bs["project"] = conv_bn(f"{pref}.{j + 2}")
            sp.append(bp)
            ss.append(bs)
        p["stages"].append(sp)
        s["stages"].append(ss)
    head = len(efficientnet.STAGES) + 1
    p["head"], s["head"] = conv_bn(f"{root}.{head}")
    return p, s


def enhanced_student_keymap(cfg: StudentConfig) -> Tuple[dict, dict]:
    """The two projections without a reference counterpart are not in it
    (see the module docstring)."""
    ep, es = _efficientnet_keymap()
    params_km = {
        "encoder": {
            "backbone": ep,
            "spatial_attention": {
                "conv1": _lin("encoder.spatial_attention.0"),
                "conv2": _lin("encoder.spatial_attention.2"),
            },
            "projection": {"fc1": _lin("encoder.projection.0"),
                           "fc2": _lin("encoder.projection.3"),
                           "ln": _ln("encoder.projection.4")},
        },
        "decoder": {
            "embedding": _lin_nobias("decoder.embedding"),
            "pos_encoding": "decoder.pos_encoding",
            "image_attention": _mha("decoder.image_attention"),
            "attention_gate": _lin("decoder.attention_gate.0"),
            "lstm": _lstm("decoder.lstm_layers", cfg.num_layers, "."),
            "lstm_norms": [_ln(f"decoder.lstm_norms.{i}")
                           for i in range(cfg.num_layers)],
            "highway_gate": _lin("decoder.highway_gate.0"),
            "output_projection": {
                "fc1": _lin("decoder.output_projection.0"),
                "fc2": _lin("decoder.output_projection.3"),
            },
        },
        "feature_compressor": {"fc1": _lin("feature_compressor.0"),
                               "fc2": _lin("feature_compressor.2")},
    }
    if cfg.use_attention_refinement:
        ar = "attention_refinement"
        params_km["attention_refinement"] = {
            "pos_encoding": f"{ar}.pos_encoding",
            "layers": [
                {"attention": _mha(f"{ar}.attention_layers.{i}"),
                 "ffn": {"fc1": _lin(f"{ar}.ffn_layers.{i}.0"),
                         "fc2": _lin(f"{ar}.ffn_layers.{i}.3")},
                 "norm1": _ln(f"{ar}.norm_layers.{2 * i}"),
                 "norm2": _ln(f"{ar}.norm_layers.{2 * i + 1}")}
                for i in range(2)
            ],
            "global_context": {"fc1": _lin(f"{ar}.global_context.2"),
                               "fc2": _lin(f"{ar}.global_context.4")},
        }
    return params_km, {"backbone": es}


def enhanced_projections(cfg: StudentConfig, seed: int = 0) -> dict:
    """The two projections the reference lacks, drawn as ``linear_init``
    draws them: ``query_projection`` (hidden -> embed) then
    ``highway_context_projection`` (embed -> hidden)."""
    rng = np.random.default_rng(seed)
    return {"query_projection": linear_init(rng, cfg.hidden_size,
                                            cfg.embed_size),
            "highway_context_projection": linear_init(rng, cfg.embed_size,
                                                      cfg.hidden_size)}


def _student_from(keymap, sd: Dict, cfg: StudentConfig) -> Tuple[dict, dict]:
    pkm, skm = keymap(cfg)
    return _import([pkm, skm], sd)


def _student_to(keymap, params: dict, state: dict, cfg: StudentConfig
                ) -> Dict[str, np.ndarray]:
    pkm, skm = keymap(cfg)
    return _export_all([(pkm, params), (skm, state)])


def full_student_from_reference(sd: Dict, cfg: StudentConfig
                                ) -> Tuple[dict, dict]:
    """A reference full-student state dict -> ``(params, state)`` trees."""
    return _student_from(full_student_keymap, sd, cfg)


def full_student_to_reference(params: dict, state: dict, cfg: StudentConfig
                              ) -> Dict[str, np.ndarray]:
    return _student_to(full_student_keymap, params, state, cfg)


def compact_student_from_reference(sd: Dict, cfg: StudentConfig
                                   ) -> Tuple[dict, dict]:
    return _student_from(compact_student_keymap, sd, cfg)


def compact_student_to_reference(params: dict, state: dict,
                                 cfg: StudentConfig) -> Dict[str, np.ndarray]:
    return _student_to(compact_student_keymap, params, state, cfg)


def enhanced_student_from_reference(sd: Dict, cfg: StudentConfig, *,
                                    projections: Optional[dict] = None,
                                    seed: int = 0) -> Tuple[dict, dict]:
    """``projections`` gives ``decoder.query_projection`` and
    ``decoder.highway_context_projection`` ({name: {"weight", "bias"}});
    without it ``enhanced_projections(cfg, seed)`` draws them."""
    params, state = _student_from(enhanced_student_keymap, sd, cfg)
    extra = projections or enhanced_projections(cfg, seed)
    for name in ("query_projection", "highway_context_projection"):
        params["decoder"][name] = {k: np.asarray(v)
                                   for k, v in extra[name].items()}
    return params, state


def enhanced_student_to_reference(params: dict, state: dict,
                                  cfg: StudentConfig) -> Dict[str, np.ndarray]:
    """The two extra projections have no reference key and are dropped."""
    return _student_to(enhanced_student_keymap, params, state, cfg)


# ---------------------------------------------------------------------------
# .pth files
# ---------------------------------------------------------------------------


def _to_numpy(obj):
    """Tensors -> numpy copies, recursively; other values as they are."""
    if hasattr(obj, "detach"):
        return np.array(obj.detach().cpu().numpy(), copy=True)
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_numpy(v) for v in obj)
    return obj


def load_reference_pth(path: str, *, allow_pickle: bool = False) -> Dict:
    """A torch checkpoint file -> the same (nested) dict with numpy leaves.
    ``weights_only=True`` unless ``allow_pickle``: a file from an untrusted
    pipeline must not run pickle code."""
    obj = torch.load(path, map_location="cpu", weights_only=not allow_pickle)
    return _to_numpy(obj)
