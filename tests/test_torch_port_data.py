"""The port's data path against the JAX package on the CPU: the CSV/image
dataset (JPEG, PNG, PPM, a missing file, an unreadable one, one that needs
a resize), the numpy PPM route and the machine without PIL, the batch
loader over two epochs, and ``make_synthetic_dataset``.  Images are 32x32
and compared bit for bit."""

import sys
import threading
import time

import numpy as np
import pytest
from PIL import Image

from imagecaptioner_tpu.data.dataset import CaptionDataset as JDataset
from imagecaptioner_tpu.data.loader import BatchLoader as JLoader
from imagecaptioner_tpu.data.synthetic import \
    make_synthetic_dataset as j_make_synthetic
from imagecaptioner_tpu_torch.data import loader as PLD
from imagecaptioner_tpu_torch.data.dataset import (CaptionDataset, read_ppm,
                                                   write_ppm)
from imagecaptioner_tpu_torch.data.loader import BatchLoader, get_loader
from imagecaptioner_tpu_torch.data.synthetic import make_synthetic_dataset

S = 32
WORDS = ["a", "dog", "runs", "on", "grass", "red", "ball", "child"]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    """A Flickr-shaped directory whose rows name a JPEG, a PNG, a PPM at
    the dataset's size, a PPM and a PNG that need resizing, a missing file
    and a file that is not an image; each image has two caption rows, one of
    them quoted with a comma, and every word passes the threshold."""
    root = tmp_path_factory.mktemp("mixed")
    img = root / "Images"
    img.mkdir()
    rng = np.random.default_rng(0)
    px = lambda s: rng.integers(0, 256, (s, s, 3), dtype=np.uint8)  # noqa: E731
    Image.fromarray(px(S)).save(img / "a.jpg")
    Image.fromarray(px(S)).save(img / "b.png")
    Image.fromarray(px(S)).save(img / "c.ppm")
    Image.fromarray(px(S + 8)).save(img / "d.ppm")
    Image.fromarray(px(20)).save(img / "e.png")
    (img / "g.jpg").write_bytes(b"not an image at all")
    names = ["a.jpg", "b.png", "c.ppm", "d.ppm", "e.png", "f.jpg", "g.jpg"]
    rows = ["image,caption"]
    for i, n in enumerate(names):
        w = [WORDS[(i + k) % len(WORDS)] for k in range(5)]
        rows.append(f"{n},{' '.join(w)} .")
        rows.append(f'{n},"{w[0]} {w[1]}, {w[2]} {w[3]}"')
    csv = root / "captions_clean.csv"
    csv.write_text("\n".join(rows) + "\n")
    return str(root), str(csv)


def test_dataset_rows_images_and_vocabulary_match_jax(mixed):
    root, csv = mixed
    j = JDataset(root, csv, freq_threshold=3, image_size=S)
    p = CaptionDataset(root, csv, freq_threshold=3, image_size=S)
    assert len(p) == len(j) == 14
    assert p.vocab.itos == j.vocab.itos and len(p.vocab) > 8
    assert p.captions == j.captions and p.captions[1] == "a dog, runs on"
    assert "," in p.vocab.stoi
    for i in range(len(j)):
        ji, jc = j[i]
        pi, pc = p[i]
        assert pi.dtype == np.uint8 and pi.shape == (S, S, 3)
        np.testing.assert_array_equal(pi, ji)
        assert pc == jc
    assert not p[10][0].any() and not p[12][0].any()     # missing, unreadable
    assert p[6][0].any() and p[8][0].any()               # resized


def test_ppm_reads_as_pil_decodes_it_bit_for_bit(tmp_path):
    rng = np.random.default_rng(1)
    for h, w in ((S, S), (7, 13)):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        Image.fromarray(a).save(tmp_path / "x.ppm")
        got = read_ppm(str(tmp_path / "x.ppm"))
        np.testing.assert_array_equal(got, np.asarray(Image.open(
            tmp_path / "x.ppm").convert("RGB")))
        write_ppm(str(tmp_path / "y.ppm"), a)
        assert (tmp_path / "y.ppm").read_bytes() == \
            (tmp_path / "x.ppm").read_bytes()
    # a commented header, and what is not binary 8-bit RGB goes to PIL
    a = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    (tmp_path / "c.ppm").write_bytes(b"P6 # made by hand\n5\t4 255\n"
                                     + a.tobytes())
    np.testing.assert_array_equal(read_ppm(str(tmp_path / "c.ppm")), a)
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "c.ppm").convert("RGB")), a)
    Image.fromarray(a).save(tmp_path / "x.png")
    Image.fromarray(a[..., 0]).save(tmp_path / "g.pgm")
    (tmp_path / "t.ppm").write_bytes(b"P6\n5 4\n255\n" + a.tobytes()[:-1])
    for f in ("x.png", "g.pgm", "t.ppm"):
        assert read_ppm(str(tmp_path / f)) is None
    with pytest.raises(OSError):
        read_ppm(str(tmp_path / "absent.ppm"))


def test_without_pil_ppm_and_missing_files_work_and_jpeg_raises(mixed,
                                                                monkeypatch):
    root, csv = mixed
    ref = CaptionDataset(root, csv, freq_threshold=3, image_size=S,
                         decode_cache_bytes=0)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    p = CaptionDataset(root, csv, freq_threshold=3, image_size=S,
                       decode_cache_bytes=0)
    np.testing.assert_array_equal(p.load_image(4), ref.load_image(4))  # c.ppm
    # a PPM at another size: resized by numpy, as PIL resizes it
    np.testing.assert_array_equal(p.load_image(6), ref.load_image(6))
    assert not p.load_image(10).any()                                  # f.jpg
    for i in (0, 12):        # a JPEG, junk
        with pytest.raises(ImportError):
            p.load_image(i)


def test_csv_edge_cases_read_as_pandas_reads_them(tmp_path):
    import pandas as pd

    path = tmp_path / "c.csv"
    path.write_text('image,caption\na.jpg,"one, two"\n\nb.jpg,\nc.jpg,NA\n'
                    'd.jpg\n"e,f.jpg",three\n')
    df = pd.read_csv(path)
    p = CaptionDataset(str(tmp_path), str(path), freq_threshold=1)
    assert p.imgs == [str(x) for x in df["image"]]
    assert p.captions == [str(x) for x in df["caption"]]
    for text in ("image,caption\n", ""):     # no rows; not even a header
        path.write_text(text)
        with pytest.raises(ValueError):
            JDataset(str(tmp_path), str(path))
        with pytest.raises(ValueError, match="empty"):
            CaptionDataset(str(tmp_path), str(path))


def test_select_cache_and_budget(mixed, monkeypatch):
    root, csv = mixed
    p = CaptionDataset(root, csv, freq_threshold=3, image_size=S)
    vocab = dict(p.vocab.itos)
    assert p.cached_batch([0, 1]) is None
    a0 = p.load_image(0)
    assert not a0.flags.writeable and p.load_image(1) is a0  # one name, one decode
    np.testing.assert_array_equal(p.cached_batch([0, 1]), np.stack([a0, a0]))
    p.select([2, 3, 0])
    assert p.imgs == ["b.png", "b.png", "a.jpg"] and p.vocab.itos == vocab
    assert p.load_image(2) is a0                           # keyed by name
    monkeypatch.setenv("IC_DECODE_CACHE_BYTES", "0")
    off = CaptionDataset(root, csv, freq_threshold=3, image_size=S)
    off.load_image(0)
    assert off.cached_batch([0]) is None
    small = CaptionDataset(root, csv, freq_threshold=3, image_size=S,
                           decode_cache_bytes=S * S * 3 * 2)
    for i in range(0, 14, 2):
        small.load_image(i)
    assert len(small._cache) == 2 and small._cache_bytes == S * S * 3 * 2


def _batches(loader, epochs=2):
    return [b for _ in range(epochs) for b in loader]


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_match_jax_over_two_epochs(mixed, shuffle):
    root, csv = mixed
    kw = dict(batch_size=4, max_caption_len=9, shuffle=shuffle, seed=3)
    j = _batches(JLoader(JDataset(root, csv, freq_threshold=3, image_size=S),
                         **kw))
    p = _batches(BatchLoader(CaptionDataset(root, csv, freq_threshold=3,
                                            image_size=S), **kw))
    assert len(p) == len(j) == 6
    for pb, jb in zip(p, j):
        assert set(pb) == set(jb) == {"images", "captions", "lengths"}
        for k in pb:
            assert pb[k].dtype == jb[k].dtype and pb[k].shape == jb[k].shape
            np.testing.assert_array_equal(pb[k], jb[k])
    caps = [b["captions"] for b in p]
    assert caps[0].shape == (9, 4) and (caps[0][0] == 1).all()
    if shuffle:   # a fresh permutation each epoch
        assert any((x != y).any() for x, y in zip(caps[:3], caps[3:]))


def test_loader_cap_drop_last_and_parallel_decode(mixed):
    root, csv = mixed
    ds = CaptionDataset(root, csv, freq_threshold=3, image_size=S,
                        decode_cache_bytes=0)
    ds.select(list(range(14)) * 3)                         # 42 rows
    big = BatchLoader(ds, batch_size=32, shuffle=False)
    assert big.batch_size == 16 and len(big) == 2
    assert [len(b["lengths"]) for b in big] == [16, 16]
    tail = BatchLoader(ds, batch_size=32, shuffle=False, drop_last=False)
    assert [len(b["lengths"]) for b in tail] == [16, 16, 10] and len(tail) == 3
    serial = _batches(BatchLoader(ds, batch_size=8, seed=1, num_workers=1), 1)
    threads = _batches(BatchLoader(ds, batch_size=8, seed=1, num_workers=4), 1)
    for a, b in zip(serial, threads):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_abandoned_iterator_stops_its_producer(mixed):
    root, csv = mixed
    ds = CaptionDataset(root, csv, freq_threshold=3, image_size=S)
    loader = BatchLoader(ds, batch_size=2, prefetch=1)
    before = {t.ident for t in threading.enumerate()}
    it = iter(loader)
    next(it)
    it.close()                 # what an abandoned for-loop does at collection
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        extra = [t for t in threading.enumerate()
                 if t.ident not in before and t.is_alive()
                 and not t.name.startswith("ic-decode")]
        if not extra:
            break
        time.sleep(0.05)
    assert not extra, f"producer thread(s) leaked: {extra}"


def test_get_loader_shards_only_in_one_process(mixed, monkeypatch):
    root, csv = mixed
    loader, ds = get_loader(root, csv, batch_size=4, image_size=S,
                            freq_threshold=3, host_shard=True)
    assert len(ds) == 14 and loader.batch_size == 4 and loader.shuffle
    val, vds = get_loader(root, csv, batch_size=4, image_size=S, shuffle=False,
                          vocab=ds.vocab)
    assert vds.vocab is ds.vocab and not val.shuffle
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    # a world of two processes: this rank's host_shard, the vocabulary of all
    _, shard = get_loader(root, csv, image_size=S, freq_threshold=3,
                          host_shard=True)
    assert shard.imgs == ds.imgs[1::2][:len(ds) // 2]
    assert shard.vocab.stoi == ds.vocab.stoi
    assert PLD.get_loader(root, csv, image_size=S)[1].imgs == ds.imgs


@pytest.mark.parametrize("kw", [dict(), dict(learnable=True),
                                dict(learnable=True, task="grid")],
                         ids=["noise", "bands", "grid"])
def test_make_synthetic_dataset_matches_jax(tmp_path, kw):
    args = dict(n_images=4, captions_per_image=2, image_size=24, seed=0, **kw)
    jcsv = j_make_synthetic(str(tmp_path / "j"), **args)
    pcsv = make_synthetic_dataset(str(tmp_path / "p"), **args)
    text = open(pcsv).read()
    assert text == open(jcsv).read() and len(text.splitlines()) == 9
    for i in range(4):
        name = f"img_{i:04d}.jpg"
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / "p" / "Images" / name)),
            np.asarray(Image.open(tmp_path / "j" / "Images" / name)))
    with pytest.raises(ValueError, match="unknown synthetic task"):
        make_synthetic_dataset(str(tmp_path / "x"), task="stripes")
