"""Caption dataset of the port (``imagecaptioner_tpu/data/dataset.py``): a
CSV of ``image,caption`` rows beside an ``Images/`` directory.

Reference semantics kept: the vocabulary is built over *all* captions at
construction (or passed in), ``Images/<name>`` is the file layout, a missing
or unreadable file gives a black placeholder, captions are framed
``<START> + tokens + <END>``, and decoded uint8 images are cached in RAM by
image name under a byte budget (``IC_DECODE_CACHE_BYTES``, default 2 GiB; 0
turns the cache off).

The CSV is read with the stdlib ``csv`` module: quoted fields with commas
parse as ``pandas.read_csv`` parses them, blank lines are skipped, and a
field that pandas reads as missing (empty, ``NA``, ``nan``, ...) becomes
the text ``"nan"``, which is what the JAX package's ``str()`` of the
missing value gives.

Images: a binary PPM (``P6``, maxval 255) is read with numpy and, when it
is not at ``image_size``, resized by ``resize_bilinear``, numpy's copy of
PIL's bilinear resize, so a machine without PIL (the GPU host) can train
from disk, at two sizes too (the optimized trainer reads its training
images 32 pixels larger than its validation images).  Both give the array
PIL gives, bit for bit.  Every other file goes to PIL, imported where it is
used: without PIL such a file raises ``ImportError``, never a placeholder.
A missing file gives the placeholder without PIL.
"""

from __future__ import annotations

import csv
import math
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from imagecaptioner_tpu_torch.data.vocabulary import Vocabulary

# the strings pandas.read_csv reads as a missing value by default
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})


def read_captions_csv(path: str) -> Tuple[List[str], List[str]]:
    """(image names, captions) of an ``image,caption`` CSV, as text."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError("The DataFrame is empty. Please check the captions CSV.")
    header, body = rows[0], rows[1:]
    try:
        ci, cc = header.index("image"), header.index("caption")
    except ValueError:
        raise ValueError(f"{path}: the header must name the columns image "
                         f"and caption, not {header}") from None
    for n, r in enumerate(body, start=2):
        if len(r) > len(header):
            raise ValueError(f"{path}: expected {len(header)} fields in line "
                             f"{n}, saw {len(r)}")
        r.extend([""] * (len(header) - len(r)))    # pandas: missing values
    if not body:
        raise ValueError("The DataFrame is empty. Please check the captions CSV.")

    def text(v: str) -> str:
        return "nan" if v in _NA_VALUES else v
    return [text(r[ci]) for r in body], [text(r[cc]) for r in body]


def read_ppm(path: str) -> Optional[np.ndarray]:
    """A binary PPM (``P6``, maxval 255) -> uint8 (H, W, 3); None for any
    other file (which PIL then decodes).  Raises ``OSError`` when the file
    cannot be opened."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] != b"P6":
        return None
    pos, fields = 2, []
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":            # a comment, to end of line
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if pos == start:
            return None
        fields.append(int(data[start:pos]))
    if not data[pos:pos + 1].isspace():
        return None
    w, h, maxval = fields
    pos += 1                                     # one whitespace byte
    if maxval != 255 or w < 1 or h < 1 or len(data) < pos + w * h * 3:
        return None
    return np.frombuffer(data, np.uint8, w * h * 3, pos).reshape(h, w, 3).copy()


def write_ppm(path: str, image: np.ndarray) -> None:
    """uint8 (H, W, 3) -> a binary PPM file, with the header PIL writes."""
    h, w, c = image.shape
    if c != 3 or image.dtype != np.uint8:
        raise ValueError(f"write_ppm takes uint8 (H, W, 3), not {image.dtype} "
                         f"{image.shape}")
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(image).tobytes())


# Pillow's fixed-point resampling: coefficients with 22 fraction bits, the
# 8-bit result rounded and clipped after each of the two passes
_PRECISION_BITS = 32 - 8 - 2


def _bilinear_coefficients(in_size: int, out_size: int):
    """Pillow's ``precompute_coeffs`` for the bilinear filter, then
    ``normalize_coeffs_8bpc``: for each output pixel the first source pixel
    (N,), and the integer weights (N, K) of that pixel and the next K - 1
    (0 past the last one used), in the C code's float64 arithmetic."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    k = np.zeros((out_size, ksize))
    for x in range(ksize):
        t = np.abs(((x + xmin).astype(np.float64) - center + 0.5) * ss)
        k[:, x] = np.where((x < xmax) & (t < 1.0), 1.0 - t, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):                   # the C loop's summation order
        ww = ww + k[:, x]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None],
                 k)
    return xmin, (0.5 + k * (1 << _PRECISION_BITS)).astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of Pillow's 8-bit resampling along ``axis`` of a uint8
    array."""
    in_size = img.shape[axis]
    xmin, kk = _bilinear_coefficients(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    tail = (slice(None),) + (None,) * (src.ndim - 1)
    for x in range(kk.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)
        acc += src[idx] * kk[:, x][tail]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 (H, W, C) -> uint8 (height, width, C) as PIL's
    ``Image.resize((width, height), Image.BILINEAR)`` gives it, bit for bit:
    the horizontal pass first, each pass only where the size changes."""
    out = image
    if out.shape[1] != width:
        out = _resample_axis(out, width, 1)
    if out.shape[0] != height:
        out = _resample_axis(out, height, 0)
    return np.ascontiguousarray(out)


def decode_image_file(path: str, size: int) -> np.ndarray:
    """An image file -> uint8 (size, size, 3), as the JAX dataset's
    ``Image.open(path).convert("RGB")`` and bilinear resize give it: a binary
    PPM by numpy, every other file by PIL, imported here.  Raises
    ``OSError`` when the file cannot be opened or decoded."""
    arr = read_ppm(path)
    if arr is not None:
        if arr.shape[:2] != (size, size):
            arr = resize_bilinear(arr, size, size)
        return arr
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img, dtype=np.uint8)


class CaptionDataset:
    def __init__(self, root_dir: str, captions_file: str, *,
                 freq_threshold: int = 5, image_size: int = 224,
                 vocab: Optional[Vocabulary] = None,
                 decode_cache_bytes: Optional[int] = None):
        self.root_dir = root_dir
        self.image_size = image_size
        self.imgs, self.captions = read_captions_csv(captions_file)
        if vocab is None:
            vocab = Vocabulary(freq_threshold)
            vocab.build_vocabulary(self.captions)
        self.vocab = vocab
        if decode_cache_bytes is None:
            decode_cache_bytes = int(os.environ.get("IC_DECODE_CACHE_BYTES",
                                                    2 << 30))
        self._cache_budget = decode_cache_bytes
        self._cache: dict = {}
        self._cache_bytes = 0
        self._cache_lock = threading.Lock()      # the loader decodes in threads

    def __len__(self) -> int:
        return len(self.imgs)

    def __getstate__(self):
        """Pickles (a trainer sends its loaders to the processes it starts)
        without the lock and the decoded images."""
        state = dict(self.__dict__, _cache={}, _cache_bytes=0)
        del state["_cache_lock"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._cache_lock = threading.Lock()

    def select(self, indices) -> "CaptionDataset":
        """Narrow to a subset of rows in place, after the vocabulary was
        built over all captions (token ids agree across shards).  Cache
        entries are keyed by image name and stay valid."""
        idx = [int(i) for i in indices]
        self.imgs = [self.imgs[i] for i in idx]
        self.captions = [self.captions[i] for i in idx]
        return self

    def _decode_image(self, index: int) -> np.ndarray:
        s = self.image_size
        path = os.path.join(self.root_dir, "Images", str(self.imgs[index]))
        try:
            return decode_image_file(path, s)
        except OSError:                 # missing, a directory, unreadable
            return np.zeros((s, s, 3), np.uint8)

    def load_image(self, index: int) -> np.ndarray:
        """uint8 (S, S, 3), from the cache when the name was decoded
        before.  Flickr-style CSVs repeat each image for every caption row,
        and one decode serves all of them."""
        name = str(self.imgs[index])
        cached = self._cache.get(name)
        if cached is not None:
            return cached
        arr = self._decode_image(index)
        if self._cache_budget:
            # the budget is checked under the lock: decode threads racing
            # past an unlocked check could overshoot it
            with self._cache_lock:
                if (name not in self._cache and self._cache_bytes + arr.nbytes
                        <= self._cache_budget):
                    arr.setflags(write=False)    # shared across batches
                    self._cache[name] = arr
                    self._cache_bytes += arr.nbytes
        return arr

    def cached_batch(self, indices) -> Optional[np.ndarray]:
        """Stacked uint8 (B, S, S, 3) when every index hits the cache, else
        None: the loader's warm path (a copy, no decode)."""
        out = []
        for i in indices:
            arr = self._cache.get(str(self.imgs[int(i)]))
            if arr is None:
                return None
            out.append(arr)
        return np.stack(out)

    def encode_caption(self, index: int) -> List[int]:
        return self.vocab.encode_caption(self.captions[index])

    def __getitem__(self, index: int) -> Tuple[np.ndarray, List[int]]:
        return self.load_image(index), self.encode_caption(index)
