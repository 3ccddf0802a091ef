"""The synthetic grid captioning task, in memory
(``imagecaptioner_tpu/data/synthetic.py``, ``task="grid"``).

Each image shows 2-4 colored shapes (12 colors x 12 shapes) in distinct
cells of a 3x3 grid; its caption names them in raster order, "<color>
<shape> <color> <shape> ...", with no glue words.  The drawing code and the
order of the random draws are the JAX package's, so one seed gives the same
captions and the same pixels (the JAX package then stores them as JPEG).
Nothing is written to disk and nothing needs PIL.

``GridLoader`` yields batches in the loader's layout: ``images`` uint8
(B, S, S, 3), ``captions`` int32 (max_caption_len, B) time-major and
PAD-filled, ``lengths`` int32 (B,).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from imagecaptioner_tpu_torch.data.vocabulary import PAD, Vocabulary

GRID_PALETTE = [
    (220, 40, 40), (40, 180, 40), (40, 70, 220), (230, 210, 40),
    (40, 200, 200), (200, 40, 200), (240, 140, 30), (150, 150, 150),
    (120, 70, 20), (250, 180, 190), (130, 30, 220), (30, 100, 60),
]
GRID_COLORS = ["red", "green", "blue", "yellow", "cyan", "magenta",
               "orange", "gray", "brown", "pink", "violet", "olive"]
GRID_SHAPES = ["square", "circle", "triangle", "cross", "ring",
               "diamond", "bar", "chevron", "dot", "frame", "tee", "ell"]


def draw_shape(cell: np.ndarray, shape: str, color) -> None:
    """Rasterize ``shape`` in ``color`` onto a square uint8 cell (H, W, 3)."""
    h = cell.shape[0]
    yy, xx = np.mgrid[0:h, 0:h].astype(np.float32)
    cy = cx = (h - 1) / 2.0
    r = h * 0.36
    y, x = yy - cy, xx - cx
    if shape == "square":
        m = (np.abs(y) < r) & (np.abs(x) < r)
    elif shape == "circle":
        m = y * y + x * x < r * r
    elif shape == "triangle":
        m = (y > -r) & (np.abs(x) < (y + r) * 0.6)
    elif shape == "cross":
        m = ((np.abs(x) < r * 0.3) | (np.abs(y) < r * 0.3)) & \
            (np.abs(x) < r) & (np.abs(y) < r)
    elif shape == "ring":
        d2 = y * y + x * x
        m = (d2 < r * r) & (d2 > (r * 0.55) ** 2)
    elif shape == "diamond":
        m = np.abs(y) + np.abs(x) < r
    elif shape == "bar":
        m = (np.abs(y) < r * 0.35) & (np.abs(x) < r)
    elif shape == "chevron":
        m = (np.abs(y - np.abs(x) * 0.8 + r * 0.4) < r * 0.3) & \
            (np.abs(x) < r)
    elif shape == "dot":
        m = y * y + x * x < (r * 0.45) ** 2
    elif shape == "frame":
        m = (np.maximum(np.abs(y), np.abs(x)) < r) & \
            (np.maximum(np.abs(y), np.abs(x)) > r * 0.55)
    elif shape == "tee":
        m = ((np.abs(y + r * 0.65) < r * 0.3) & (np.abs(x) < r)) | \
            ((np.abs(x) < r * 0.3) & (np.abs(y) < r))
    elif shape == "ell":
        m = ((np.abs(x + r * 0.65) < r * 0.3) & (np.abs(y) < r)) | \
            ((np.abs(y - r * 0.65) < r * 0.3) & (np.abs(x) < r))
    else:
        raise ValueError(shape)
    cell[m] = color


def make_grid_dataset(n_images: int = 24, *, image_size: int = 224,
                      seed: int = 0) -> Tuple[np.ndarray, List[str]]:
    """``n_images`` grid images uint8 (N, S, S, 3) and their captions."""
    rng = np.random.default_rng(seed)
    images = np.empty((n_images, image_size, image_size, 3), np.uint8)
    captions: List[str] = []
    cs = image_size // 3
    for i in range(n_images):
        n_obj = int(rng.integers(2, 5))
        cells = rng.choice(9, size=n_obj, replace=False)
        cells.sort()  # raster order = caption order
        colors = rng.integers(0, len(GRID_COLORS), n_obj)
        shapes = rng.integers(0, len(GRID_SHAPES), n_obj)
        arr = np.full((image_size, image_size, 3), 24, np.uint8)
        words = []
        for cell, ci, si in zip(cells, colors, shapes):
            r, c = divmod(int(cell), 3)
            draw_shape(arr[r * cs:(r + 1) * cs, c * cs:(c + 1) * cs],
                       GRID_SHAPES[si], GRID_PALETTE[ci])
            words += [GRID_COLORS[ci], GRID_SHAPES[si]]
        images[i] = np.clip(arr.astype(np.int16)
                            + rng.integers(-10, 11, arr.shape), 0, 255
                            ).astype(np.uint8)
        captions.append(" ".join(words))
    return images, captions


class GridLoader:
    """Static-shape batches over an in-memory dataset, with the semantics
    of the JAX ``BatchLoader``: the silent batch cap of 16, ``drop_last``,
    a fresh shuffle per pass."""

    def __init__(self, images: np.ndarray, captions: List[str],
                 vocab: Vocabulary, *, batch_size: int = 16,
                 max_caption_len: int = 48, shuffle: bool = True,
                 seed: int = 0, batch_size_cap: Optional[int] = 16):
        self.images, self.vocab = images, vocab
        self.tokens = [vocab.encode_caption(c)[:max_caption_len]
                       for c in captions]
        bs = min(batch_size, len(images))
        if batch_size_cap is not None and bs > batch_size_cap:
            bs = batch_size_cap
        self.batch_size = bs
        self.max_caption_len = max_caption_len
        self.shuffle = shuffle
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.images) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.images))
        if self.shuffle:
            self._rng.shuffle(order)
        for k in range(len(self)):
            idxs = order[k * self.batch_size:(k + 1) * self.batch_size]
            caps = np.full((self.max_caption_len, len(idxs)), PAD, np.int32)
            lengths = np.zeros((len(idxs),), np.int32)
            for j, i in enumerate(idxs):
                t = self.tokens[int(i)]
                caps[:len(t), j] = t
                lengths[j] = len(t)
            yield {"images": self.images[idxs], "captions": caps,
                   "lengths": lengths}


def make_grid_loaders(n_images: int, *, image_size: int = 224, seed: int = 0,
                      batch_size: int = 16, max_caption_len: int = 48,
                      freq_threshold: int = 5
                      ) -> Tuple[GridLoader, GridLoader, Vocabulary]:
    """(train loader, val loader, vocabulary) over one grid dataset: the
    training pass shuffled, the validation pass in order, as the KD trainer
    builds its two loaders over one CSV."""
    images, captions = make_grid_dataset(n_images, image_size=image_size,
                                         seed=seed)
    vocab = Vocabulary(freq_threshold)
    vocab.build_vocabulary(captions)
    kw = dict(batch_size=batch_size, max_caption_len=max_caption_len)
    return (GridLoader(images, captions, vocab, shuffle=True, seed=seed, **kw),
            GridLoader(images, captions, vocab, shuffle=False, **kw), vocab)
