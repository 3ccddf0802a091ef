"""Data-parallel serving: each image batch split over several devices
(``imagecaptioner_tpu/eval/serving.py``).

Captioning is per-image independent, so serving needs no collectives: the
factories copy the model to each device of an explicit list (default:
every visible card), split each batch into contiguous blocks, one a
device, start every block before waiting on any (a thread a block: the
beam search reads its early-exit flag on the host), and concatenate the
results.  A device may be listed more than once; its blocks then share
one copy of the model, which is how one card, or the CPU, checks the
split.  Each block is an ordinary single-device call
(``serve.make_greedy_captioner``, or ``serve.make_beam_captioner``'s
search), so on a
card each block runs kernel #1 (the full student's greedy loop; #3 for the
compact student) or #9/#10 (the beam's attention).  The JAX factories
decode through XLA because a ``pallas_call`` is opaque to GSPMD; that is a
constraint of GSPMD, and it does not carry over.

Greedy rows and beam hypotheses do not depend on the other rows of their
batch, so the results equal one device's on the whole batch.  Sampling
(``temperature != 1``) seeds each block's generator afresh, so its draws
depend on the split.
"""

from __future__ import annotations

import copy
import functools
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.ops import decode as D

__all__ = ["make_dp_greedy_captioner", "make_dp_beam_captioner"]


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if not devices:
        raise RuntimeError("no CUDA device is available: data-parallel "
                           "serving runs on the cards; pass devices=['cpu', "
                           "...] to split batches on the CPU")
    return [torch.device(d) for d in devices]


def _copies(model, devices: List[torch.device]) -> dict:
    """One copy of ``model`` a distinct device (the model itself where it
    already lies)."""
    home = next(model.parameters()).device
    return {d: model if d == home else copy.deepcopy(model).to(d)
            for d in dict.fromkeys(devices)}


def _guard_batch(fn, n_data: int, per_shard_multiple: int = 1):
    """Raise a readable error for a batch that the devices cannot split
    evenly.  ``per_shard_multiple``: each block must also be a multiple of
    this (the pipelined beam's pack width)."""
    need = n_data * per_shard_multiple

    @functools.wraps(fn)
    def call(images):
        if images.shape[0] % need:
            raise ValueError(
                f"batch {images.shape[0]} not divisible by the mesh's "
                f"data axis ({n_data})"
                + (f" x pack {per_shard_multiple}"
                   if per_shard_multiple > 1 else "")
                + "; pad the trailing batch to a multiple")
        return fn(images)

    return call


def _split_call(fns: List[Callable], pool: ThreadPoolExecutor):
    """images -> each block through its device's function, all started
    before any is waited on; the blocks' outputs concatenated."""
    def call(images_u8: np.ndarray):
        blocks = np.split(np.asarray(images_u8), len(fns))
        futures = [pool.submit(f, b) for f, b in zip(fns, blocks)]
        outs = [f.result() for f in futures]
        if isinstance(outs[0], tuple):
            return tuple(np.concatenate(o) for o in zip(*outs))
        return np.concatenate(outs)
    return call


def make_dp_greedy_captioner(
    student, cfg, devices: Optional[Sequence] = None, *,
    max_length: int = 20, temperature: float = 1.0, seed: int = 0,
) -> Callable[[np.ndarray], np.ndarray]:
    """Student greedy serving split over ``devices``: uint8 images
    (N, H, W, 3) -> tokens (N, max_length) int32, N divisible by the
    number of devices."""
    devs = _devices(devices)
    models = _copies(student, devs)
    fns = [serve.make_greedy_captioner(models[d], cfg, d,
                                       max_length=max_length,
                                       temperature=temperature, seed=seed)
           for d in devs]
    pool = ThreadPoolExecutor(max_workers=len(devs),
                              thread_name_prefix="ic-dp-serve")
    return _guard_batch(_split_call(fns, pool), len(devs))


def make_dp_beam_captioner(
    teacher, cfg, devices: Optional[Sequence] = None, *,
    max_length: int = 20, beam_size: int = 5, length_penalty: float = 0.6,
    pipelined_pack: int = 0,
) -> Callable[[np.ndarray], Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Teacher beam-search serving split over ``devices``: uint8 images
    -> ``(seqs (N, K, S), scores (N, K), lens (N, K))``, as
    ``serve.make_beam_captioner`` gives for the whole batch.

    ``pipelined_pack > 0``: each block encodes at its full size and decodes
    in packs of that many images (``ops/decode.beam_search_teacher_pipelined``);
    the batch must then divide by devices x pack."""
    devs = _devices(devices)
    models = _copies(teacher, devs)
    kw = dict(max_length=max_length, beam_size=beam_size,
              length_penalty=length_penalty)
    fns = [_beam(models[d], d, pipelined_pack, kw) for d in devs]
    pool = ThreadPoolExecutor(max_workers=len(devs),
                              thread_name_prefix="ic-dp-serve")
    return _guard_batch(_split_call(fns, pool), len(devs),
                        per_shard_multiple=pipelined_pack or 1)


def _beam(teacher, device, pack: int, kw: dict):
    """``serve.make_beam_captioner`` with the length penalty, and with
    ``pack`` the pipelined search."""
    dtype = next(teacher.parameters()).dtype

    @torch.inference_mode()
    def caption(images_u8: np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(device)
        memory = teacher.encode_image(T.normalize(x, dtype=dtype))
        out = (D.beam_search_teacher_pipelined(teacher, memory, pack=pack,
                                               **kw) if pack
               else D.beam_search_teacher_packed(teacher, memory, **kw))
        return tuple(t.cpu().numpy() for t in out)

    return caption
