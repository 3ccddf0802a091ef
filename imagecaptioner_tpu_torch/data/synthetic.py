"""Synthetic captioning data (``imagecaptioner_tpu/data/synthetic.py``).

``make_synthetic_dataset`` writes a Flickr8k-shaped directory, ``Images/*.jpg``
and ``captions_clean.csv``, with the JAX package's random draws, CSV text and
pixels for each of its three tasks (noise, ``bands`` and ``grid``); it needs
PIL to write the JPEGs.  It is the no-download dataset behind the trainer's
``--data-root``.

The grid task is also kept in memory (``make_grid_dataset``, no disk and
no PIL).  Each image shows 2-4 colored shapes (12 colors x 12 shapes) in
distinct cells of a 3x3 grid; its caption names them in raster order,
"<color> <shape> <color> <shape> ...", with no glue words.  The drawing
code and the order of the random draws are the JAX package's, so one seed
gives the same captions and the same pixels (the JAX package then stores
them as JPEG).

``make_grid_loaders`` serves it through ``data/loader.BatchLoader``, as
the trainer reads a dataset from disk.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from imagecaptioner_tpu_torch.data.loader import BatchLoader
from imagecaptioner_tpu_torch.data.vocabulary import Vocabulary

WORDS = [
    "a", "dog", "runs", "on", "the", "grass", "child", "plays", "with",
    "ball", "man", "rides", "bike", "through", "park", "woman", "walks",
    "two", "dogs", "jump", "into", "water", "boy", "girl", "smiles",
]
# the bands task: three colored bands; the caption names them
PALETTE = [
    (220, 40, 40), (40, 180, 40), (40, 70, 220), (230, 210, 40),
    (40, 200, 200), (200, 40, 200), (240, 140, 30), (120, 120, 120),
]
COLOR_WORDS = ["red", "green", "blue", "yellow",
               "cyan", "purple", "orange", "gray"]
NOUNS = ["dog", "child", "ball", "bike", "bird", "car", "tree", "house"]
VERBS = ["runs", "jumps", "sits", "waits", "turns", "stands", "moves", "rests"]

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


def grid_image(rng: np.random.Generator, image_size: int
               ) -> Tuple[np.ndarray, List[str]]:
    """One grid image uint8 (S, S, 3) and its words, in the JAX package's
    order of draws."""
    n_obj = int(rng.integers(2, 5))
    cells = rng.choice(9, size=n_obj, replace=False)
    cells.sort()  # raster order = caption order
    colors = rng.integers(0, len(GRID_COLORS), n_obj)
    shapes = rng.integers(0, len(GRID_SHAPES), n_obj)
    arr = np.full((image_size, image_size, 3), 24, np.uint8)
    cs = image_size // 3
    words = []
    for cell, ci, si in zip(cells, colors, shapes):
        r, c = divmod(int(cell), 3)
        draw_shape(arr[r * cs:(r + 1) * cs, c * cs:(c + 1) * cs],
                   GRID_SHAPES[si], GRID_PALETTE[ci])
        words += [GRID_COLORS[ci], GRID_SHAPES[si]]
    arr = np.clip(arr.astype(np.int16) + rng.integers(-10, 11, arr.shape),
                  0, 255).astype(np.uint8)
    return arr, words


def make_synthetic_dataset(root: str, *, n_images: int = 24,
                           captions_per_image: int = 1, image_size: int = 224,
                           seed: int = 0, learnable: bool = False,
                           task: str = "bands") -> str:
    """Write ``root/Images/img_NNNN.jpg`` and ``root/captions_clean.csv``;
    returns the CSV's path.  ``learnable=False``: random noise images and
    random captions.  ``learnable=True``: the caption names what the image
    shows, by ``task``: ``"bands"`` (three colored bands, "the <color>
    <noun> <verb> on the <color> ground .") or ``"grid"`` (2-4 colored
    shapes on a 3x3 grid, "<color> <shape> ..." in raster order)."""
    if task not in ("bands", "grid"):
        raise ValueError(f"unknown synthetic task {task!r}")
    from PIL import Image

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "Images")
    os.makedirs(img_dir, exist_ok=True)
    rows: List[str] = ["image,caption"]
    for i in range(n_images):
        name = f"img_{i:04d}.jpg"
        if learnable and task == "grid":
            arr, words = grid_image(rng, image_size)
            caption = " ".join(words)
        elif learnable:
            c = rng.integers(0, 8, 3)
            arr = np.zeros((image_size, image_size, 3), np.uint8)
            third = image_size // 3
            arr[:third] = PALETTE[c[0]]
            arr[third:2 * third] = PALETTE[c[1]]
            arr[2 * third:] = PALETTE[c[2]]
            arr = np.clip(arr.astype(np.int16)
                          + rng.integers(-12, 13, arr.shape), 0, 255
                          ).astype(np.uint8)
            caption = (f"the {COLOR_WORDS[c[0]]} {NOUNS[c[1]]} "
                       f"{VERBS[c[2]]} on the {COLOR_WORDS[c[2]]} ground .")
        else:
            arr = rng.integers(0, 256, (image_size, image_size, 3),
                               dtype=np.uint8)
        Image.fromarray(arr).save(os.path.join(img_dir, name))
        for _ in range(captions_per_image):
            if learnable:
                rows.append(f"{name},{caption}")
            else:       # noise: a fresh random caption per row
                k = int(rng.integers(4, 9))
                words = [WORDS[int(w)]
                         for w in rng.integers(0, len(WORDS), k)]
                rows.append(f"{name},{' '.join(words)} .")
    csv_path = os.path.join(root, "captions_clean.csv")
    with open(csv_path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return csv_path


def make_grid_dataset(n_images: int = 24, *, image_size: int = 224,
                      seed: int = 0) -> Tuple[np.ndarray, List[str]]:
    """``n_images`` grid images uint8 (N, S, S, 3) and their captions."""
    rng = np.random.default_rng(seed)
    images = np.empty((n_images, image_size, image_size, 3), np.uint8)
    captions: List[str] = []
    for i in range(n_images):
        images[i], words = grid_image(rng, image_size)
        captions.append(" ".join(words))
    return images, captions


class GridDataset:
    """Grid images and captions in memory, with the reading interface of
    ``CaptionDataset`` that ``BatchLoader`` uses (every image "cached")."""

    def __init__(self, images: np.ndarray, captions: List[str],
                 vocab: Vocabulary):
        self.images, self.captions, self.vocab = images, captions, vocab

    def __len__(self) -> int:
        return len(self.images)

    def load_image(self, index: int) -> np.ndarray:
        return self.images[index]

    def cached_batch(self, indices) -> np.ndarray:
        return self.images[np.asarray(indices)]

    def encode_caption(self, index: int) -> List[int]:
        return self.vocab.encode_caption(self.captions[index])


def make_grid_loaders(n_images: int, *, image_size: int = 224, seed: int = 0,
                      batch_size: int = 16, max_caption_len: int = 48,
                      freq_threshold: int = 5
                      ) -> Tuple[BatchLoader, BatchLoader, Vocabulary]:
    """(train loader, val loader, vocabulary) over one grid dataset: the
    training pass shuffled with ``seed``, the validation pass in order, as
    the KD trainer builds its two loaders over one CSV."""
    images, captions = make_grid_dataset(n_images, image_size=image_size,
                                         seed=seed)
    vocab = Vocabulary(freq_threshold)
    vocab.build_vocabulary(captions)
    ds = GridDataset(images, captions, vocab)
    kw = dict(batch_size=batch_size, max_caption_len=max_caption_len)
    return (BatchLoader(ds, shuffle=True, seed=seed, **kw),
            BatchLoader(ds, shuffle=False, **kw), vocab)
