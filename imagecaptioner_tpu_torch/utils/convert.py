"""JAX student parameter trees -> the port's ``state_dict``.

The JAX parameters are already stored in torch layouts (Linear (out, in),
conv OIHW) and the port's submodules are named after the JAX tree, so the
conversion is a flatten of the parameter tree plus a merge of the separate
batch-norm state tree into the ``running_mean``/``running_var`` buffers.
Two naming quirks of the JAX state tree are undone here: its top level is
``{"resnet": ...}`` (not ``{"encoder": ...}``), and a downsample branch keeps
its statistics under ``downsample_bn`` while its affine parameters sit in
``downsample.bn`` (``resnet.py:42-43``).
"""

from __future__ import annotations

from typing import Any, Dict

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
    for k, v in tree_to_state_dict(state["resnet"], "encoder.resnet").items():
        sd[k.replace(".downsample_bn.", ".downsample.bn.")] = v
    return sd
