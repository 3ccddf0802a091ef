"""JAX parameter trees <-> the port's ``state_dict``s.

The JAX parameters are already stored in torch layouts (Linear (out, in),
conv OIHW) and the port's submodules are named after the JAX tree, so the
conversion is a flatten of the parameter tree plus a merge of the separate
batch-norm state tree into the ``running_mean``/``running_var`` buffers.
Two naming quirks of the JAX state tree are undone here: its top level is
the backbone's name (``{"resnet": ...}`` for the full student, ``{"backbone":
...}`` for the compact and enhanced ones, not ``{"encoder": ...}``), and a
ResNet downsample branch keeps its statistics under ``downsample_bn`` while
its affine parameters sit in ``downsample.bn`` (``resnet.py:42-43``).  In the
MobileNet and EfficientNet state trees each conv-bn pair's statistics sit
directly under the pair's name, and go to its ``bn`` submodule.

The teacher, the projectors and the AdamW moments flatten the same way; the
inverse direction (``state_dict_to_tree``, ``student_to_jax_trees``) writes
checkpoints that the JAX package reads.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from imagecaptioner_tpu_torch.core.config import StudentConfig
from imagecaptioner_tpu_torch.models.student import check_variant


def tree_to_state_dict(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Flatten a nested dict/list tree of float arrays into dotted keys
    (``lstm/0/weight_ih`` -> ``lstm.0.weight_ih``), copied to float32."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Any, path: str) -> None:
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        else:
            out[path] = torch.from_numpy(np.array(node, dtype=np.float32))

    walk(tree, prefix)
    return out


def jax_student_to_state_dict(params: Dict, state: Dict, cfg: StudentConfig
                              ) -> Dict[str, torch.Tensor]:
    """``(params, state)`` of ``student_init`` / a KD checkpoint (numpy
    leaves) -> a ``state_dict`` for ``models.student.Student(cfg)`` that
    loads with ``strict=True``."""
    check_variant(cfg)
    sd = tree_to_state_dict(params)
    key = backbone_key(cfg)
    for k, v in tree_to_state_dict(state[key], f"encoder.{key}").items():
        sd[_stat_to_buffer(k, key)] = v
    return sd


def backbone_key(cfg: StudentConfig) -> str:
    """Name of the backbone in the encoder and in the JAX state tree."""
    return "resnet" if cfg.variant == "full" else "backbone"


def _stat_to_buffer(k: str, key: str) -> str:
    if key == "resnet":
        return k.replace(".downsample_bn.", ".downsample.bn.")
    head, stat = k.rsplit(".", 1)      # ...depthwise.running_mean
    return f"{head}.bn.{stat}"


def _buffer_to_stat(k: str, key: str) -> str:
    if key == "resnet":
        return k.replace(".downsample.bn.", ".downsample_bn.")
    head, bn, stat = k.rsplit(".", 2)
    return f"{head}.{stat}"


def jax_teacher_to_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """``teacher_init`` / a teacher checkpoint's params -> a ``state_dict``
    for ``models.teacher.Teacher`` (``strict=True``; the positional table is
    not a parameter on either side)."""
    return tree_to_state_dict(params)


def jax_projectors_to_state_dict(params: Dict) -> Dict[str, torch.Tensor]:
    """``create_feature_projectors`` params -> a ``state_dict`` for
    ``distill.projector.make_projectors``."""
    return tree_to_state_dict(params)


def jax_adamw_to_state(opt_state: Dict, named_params) -> Tuple[int, Dict, Dict]:
    """A JAX per-leaf ``AdamWState`` (as a dict with ``step``, ``mu``,
    ``nu``; the KD trainer's over ``{"student": ..., "projectors": ...}``,
    the teacher trainer's over the teacher's parameters) -> ``(step, mu,
    nu)`` keyed like ``named_params``."""
    mu = tree_to_state_dict(opt_state["mu"])
    nu = tree_to_state_dict(opt_state["nu"])
    names = list(named_params)
    if set(mu) != set(names) or set(nu) != set(names):
        raise ValueError("optimizer state does not match the parameters")
    return (int(opt_state["step"]), {n: mu[n] for n in names},
            {n: nu[n] for n in names})


def state_dict_to_tree(sd: Dict[str, torch.Tensor]) -> Any:
    """The inverse of ``tree_to_state_dict``: dotted keys -> nested dicts of
    float32 numpy arrays; a level whose keys are 0..n-1 becomes a list."""
    root: Dict = {}
    for key, value in sd.items():
        node = root
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value.detach().float().cpu().numpy()

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.isdigit() for k in node):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def projectors_to_tree(values: Dict[str, torch.Tensor], names) -> Dict:
    """Values keyed ``<projector>.<parameter>`` -> the JAX projectors tree:
    one subtree per projector in ``names``, empty for a projector without
    parameters (``create_feature_projectors`` makes it so when the teacher's
    and the student's widths agree)."""
    return {name: state_dict_to_tree({k[len(name) + 1:]: v
                                      for k, v in values.items()
                                      if k.startswith(name + ".")})
            for name in names}


def student_to_jax_trees(model) -> Tuple[Dict, Dict]:
    """A ``Student`` -> ``(params, model_state)`` in the JAX layout: the
    parameters' tree, and the batch-norm statistics under the backbone's
    name, keyed as the JAX state tree keys them."""
    params = state_dict_to_tree(dict(model.named_parameters()))
    key = backbone_key(model.cfg)
    prefix = f"encoder.{key}."
    buffers = {_buffer_to_stat(k[len(prefix):], key): v
               for k, v in model.named_buffers() if k.startswith(prefix)}
    return params, {key: state_dict_to_tree(buffers)}
