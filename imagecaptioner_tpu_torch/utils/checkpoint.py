"""Numpy-only reader and writer for the JAX package's npz checkpoints.

Format (``imagecaptioner_tpu/utils/checkpoint.py``): one ``.npz`` whose
arrays are keyed by their tree path, plus ``__structure__``, a JSON mirror
of the nested dict/list tree stored as uint8 bytes.  Leaves are numpy
arrays, None, str, bool, int or float.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, List

import numpy as np

from imagecaptioner_tpu_torch.core.config import STUDENT_CONFIGS, StudentConfig

_SENTINEL_NONE = "__none__"


def _flatten(tree: Any, prefix: str, out: Dict[str, np.ndarray]) -> Any:
    """Returns a JSON-able structure mirror; arrays go to ``out``."""
    if isinstance(tree, dict):
        return {k: _flatten(v, f"{prefix}/{k}", out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kind = "tuple" if isinstance(tree, tuple) else "list"
        return {"__seq__": kind,
                "items": [_flatten(v, f"{prefix}/{i}", out)
                          for i, v in enumerate(tree)]}
    if tree is None:
        return _SENTINEL_NONE
    if isinstance(tree, str):
        return {"__str__": tree}
    if isinstance(tree, bool):
        return {"__bool__": tree}
    if isinstance(tree, int):
        return {"__int__": tree}
    if isinstance(tree, float):
        return {"__float__": tree}
    if hasattr(tree, "detach"):                  # a torch tensor
        tree = tree.detach().cpu().numpy()
    out[prefix] = np.array(tree, copy=True)      # a snapshot, not a view
    return {"__array__": prefix}


def _unflatten(node: Any, arrays: Dict[str, np.ndarray]) -> Any:
    if node == _SENTINEL_NONE:
        return None
    if isinstance(node, dict):
        if "__seq__" in node:
            items = [_unflatten(v, arrays) for v in node["items"]]
            return tuple(items) if node["__seq__"] == "tuple" else items
        if "__array__" in node:
            return arrays[node["__array__"]]
        if "__str__" in node:
            return node["__str__"]
        if "__bool__" in node:
            return bool(node["__bool__"])
        if "__int__" in node:
            return int(node["__int__"])
        if "__float__" in node:
            return float(node["__float__"])
        return {k: _unflatten(v, arrays) for k, v in node.items()}
    raise ValueError(f"corrupt checkpoint node: {node!r}")


def _snapshot(tree: Any) -> Dict[str, np.ndarray]:
    """Every leaf copied to host numpy now: the trainer updates its tensors
    in place, so only the disk write may wait."""
    arrays: Dict[str, np.ndarray] = {}
    structure = _flatten(tree, "", arrays)
    arrays["__structure__"] = np.frombuffer(
        json.dumps(structure).encode(), dtype=np.uint8)
    return arrays


def _write_npz(path: str, arrays: Dict[str, np.ndarray]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_checkpoint(path: str, tree: Any) -> None:
    _write_npz(path, _snapshot(tree))


_save_lock = threading.Lock()
_pending: List[Any] = []
_executor = None


def save_checkpoint_async(path: str, tree: Any):
    """Snapshot ``tree`` to the host now, write the npz in the background.
    Returns the Future (a write error surfaces there and in
    ``wait_for_saves``)."""
    global _executor
    arrays = _snapshot(tree)
    with _save_lock:
        if _executor is None:
            from concurrent.futures import ThreadPoolExecutor

            _executor = ThreadPoolExecutor(max_workers=1,
                                           thread_name_prefix="ckpt-save")
        fut = _executor.submit(_write_npz, path, arrays)
        _pending.append(fut)
    return fut


def wait_for_saves() -> None:
    """Block until every queued checkpoint write has landed; re-raises the
    first write error.  The trainer calls it before it returns, so a caller
    that loads ``best_student_model.npz`` next finds the whole file."""
    with _save_lock:
        futs = list(_pending)
        _pending.clear()
    for f in futs:
        f.result()


def load_checkpoint(path: str) -> Any:
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    structure = json.loads(bytes(arrays.pop("__structure__")).decode())
    return _unflatten(structure, arrays)


def load_student_checkpoint(path: str):
    """A KD checkpoint -> ``(params, cfg, model_state)`` as numpy trees in
    the JAX package's layout; ``model_type`` (full, compact or enhanced)
    picks the variant's defaults, which ``model_config`` overrides."""
    ckpt = load_checkpoint(path)
    mc = dict(ckpt.get("model_config", {}))
    variant = mc.pop("model_type", "full")
    if variant not in STUDENT_CONFIGS:
        raise ValueError(f"unknown student model_type {variant!r}")
    cfg: StudentConfig = STUDENT_CONFIGS[variant](int(ckpt["vocab_size"]),
                                                  **mc)
    sd = ckpt["student_state_dict"]
    return sd["params"], cfg, sd["model_state"]
