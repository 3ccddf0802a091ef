"""Device-resident dataset (``imagecaptioner_tpu/data/device_cache.py``):
decode once, upload once, gather each batch on the card.

A KD step re-reads the same images every epoch, and a host loader uploads
each batch every time it is used.  ``DeviceDataset`` decodes every row once
(``CaptionDataset.load_image`` in a thread pool; a missing file gives the
black placeholder) and keeps them on the card as

- ``images``   (N, H, W, 3) uint8
- ``captions`` (N, T) int32, PAD-padded
- ``lengths``  (N,) int32

so a train step uploads only its (A, B) int32 row indices and
``gather_batch`` assembles the batch on the card
(``train/steps.make_device_data_step`` chains several such steps).

Batch semantics are ``data/loader.BatchLoader``'s: the silent batch-size
cap of 16, the shuffle order from ``np.random.default_rng(seed)`` (one
permutation an epoch), drop_last, captions (T, B) time-major with their
lengths; trailing incomplete accumulation groups are dropped, as the
trainers' ``stacked_batches`` drops them.  A byte budget (4 GiB, or
``IC_DEVICE_DATASET_BYTES``) refuses a dataset that would not fit.

Under data parallelism (``core/mesh.py``) each rank holds the rows of its
own loader on its card, as the JAX class replicates them over a mesh, and
``gather_batch(..., mesh)`` assembles its part of each index batch: the
contiguous block of the batch axis at its data index when the world's
batches are global (``mesh.split``), the whole batch when each process
loaded its own rows (the rows of its data index).
The chained steps (``train/steps.make_device_data_step``) are unchanged
per rank.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from imagecaptioner_tpu_torch.core import mesh as MS
from imagecaptioner_tpu_torch.data.dataset import CaptionDataset
from imagecaptioner_tpu_torch.data.vocabulary import PAD

__all__ = ["DeviceDataset", "gather_batch"]


def _default_budget() -> int:
    return int(os.environ.get("IC_DEVICE_DATASET_BYTES", 4 << 30))


class DeviceDataset:
    """Uploads a whole ``CaptionDataset`` to ``device``; ``arrays`` holds
    the three tensors above."""

    def __init__(self, dataset: CaptionDataset, *, max_caption_len: int = 48,
                 byte_budget: Optional[int] = None, num_workers: int = 8,
                 device="cuda"):
        n = len(dataset)
        h = w = dataset.image_size
        budget = _default_budget() if byte_budget is None else byte_budget
        need = n * h * w * 3 + n * max_caption_len * 4 + n * 4
        if need > budget:
            raise ValueError(
                f"DeviceDataset: {need/2**30:.2f} GiB of rows exceeds the "
                f"{budget/2**30:.2f} GiB budget (IC_DEVICE_DATASET_BYTES); "
                f"use the host BatchLoader for this dataset")

        imgs = np.empty((n, h, w, 3), np.uint8)
        if num_workers > 1 and n > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=num_workers,
                                    thread_name_prefix="ic-devcache") as pool:
                for i, im in enumerate(pool.map(dataset.load_image,
                                                range(n))):
                    imgs[i] = im
        else:
            for i in range(n):
                imgs[i] = dataset.load_image(i)

        caps = np.full((n, max_caption_len), PAD, np.int32)
        lens = np.zeros((n,), np.int32)
        for i in range(n):
            t = dataset.encode_caption(i)[:max_caption_len]
            caps[i, : len(t)] = t
            lens[i] = len(t)

        self.n = n
        self.max_caption_len = max_caption_len
        self.device = torch.device(device)
        self.arrays: Dict[str, torch.Tensor] = {
            k: torch.from_numpy(v).to(self.device)
            for k, v in (("images", imgs), ("captions", caps),
                         ("lengths", lens))}
        self._rng = np.random.default_rng(0)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.arrays.values())

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    def epoch_indices(self, *, batch_size: int, accumulation_steps: int = 1,
                      shuffle: bool = True, drop_last: bool = True,
                      batch_size_cap: Optional[int] = 16) -> np.ndarray:
        """(steps, A, B) int32 row indices for one epoch, drawn as the JAX
        class draws them (module docstring)."""
        if not drop_last:
            raise ValueError("device batching needs uniform shapes — "
                             "drop_last=False is not supported")
        bs = min(batch_size, self.n)
        if batch_size_cap is not None and bs > batch_size_cap:
            bs = batch_size_cap
        order = np.arange(self.n)
        if shuffle:
            self._rng.shuffle(order)
        n_batches = self.n // bs
        a = max(1, accumulation_steps)
        steps = n_batches // a
        if steps == 0:
            return np.zeros((0, a, bs), np.int32)
        used = order[: steps * a * bs]
        return used.reshape(steps, a, bs).astype(np.int32)


def gather_batch(arrays: Dict[str, torch.Tensor], idx: torch.Tensor,
                 mesh=None) -> Dict[str, torch.Tensor]:
    """idx (A, B) int32 on the arrays' device -> the batch a host
    ``BatchLoader`` stack gives: (A, B, H, W, 3) uint8 images, (A, T, B)
    captions, (A, B) lengths; rows gathered on the leading axis with
    ``index_select``.  With a ``mesh`` whose batches are global, only the
    block of the B axis at this rank's data index is gathered (module
    docstring)."""
    if mesh is not None and mesh.split:
        idx = MS.batch_block(idx, mesh, 1)
    a, b = idx.shape
    flat = idx.reshape(-1)
    imgs = arrays["images"].index_select(0, flat)
    caps = arrays["captions"].index_select(0, flat)          # (A*B, T)
    lens = arrays["lengths"].index_select(0, flat)
    return {"images": imgs.reshape((a, b) + imgs.shape[1:]),
            "captions": caps.reshape(a, b, -1).transpose(1, 2),  # (A, T, B)
            "lengths": lens.reshape(a, b)}
