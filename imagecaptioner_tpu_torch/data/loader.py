"""Static-shape batch loader of the port (``imagecaptioner_tpu/data/loader.py``).

Every batch has the same shapes: images uint8 (B, S, S, 3) NHWC, captions
int32 (max_caption_len, B) time-major, lengths int32 (B,).  Reference
semantics kept:

  * the silent batch-size cap at 16;
  * ``drop_last=True``;
  * captions padded with PAD=0, time-major (T, B);
  * ``lengths`` holds each caption's true length (with START and END).

The shuffle draws from ``np.random.default_rng(seed)``, one permutation per
epoch, so one seed gives the JAX loader's batch order.  Images decode in a
thread pool and come from the dataset's RAM cache once decoded; a
background thread prefetches batches and stops when the iterator is
abandoned.  ``device_prefetch`` double-buffers batches onto a card from
pinned host memory on a side stream.  ``get_loader(host_shard=True)``
narrows the dataset to this process's rows in a data-parallel world
(``parallel/multihost.host_shard``), each process onto its own card.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from imagecaptioner_tpu_torch.data.dataset import CaptionDataset
from imagecaptioner_tpu_torch.data.vocabulary import PAD


class BatchLoader:
    def __init__(self, dataset: CaptionDataset, *, batch_size: int = 32,
                 max_caption_len: int = 48, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 0,
                 batch_size_cap: Optional[int] = 16, prefetch: int = 2,
                 num_workers: int = 8):
        self.dataset = dataset
        bs = min(batch_size, len(dataset))
        if batch_size_cap is not None and bs > batch_size_cap:
            bs = batch_size_cap                  # the reference's silent cap
        self.batch_size = bs
        self.max_caption_len = max_caption_len
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        # PIL and the numpy PPM reader release the GIL for most of a decode
        self.num_workers = max(1, num_workers)
        self._pool = None
        self._rng = np.random.default_rng(seed)
        self._tokens: Optional[list] = None

    def __getstate__(self):
        """Pickles without the decode pool, which is made again at use."""
        return dict(self.__dict__, _pool=None)

    def _decode_pool(self):
        if self._pool is None and self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=self.num_workers,
                                            thread_name_prefix="ic-decode")
        return self._pool

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _encode_all(self) -> list:
        if self._tokens is None:
            self._tokens = [self.dataset.encode_caption(i)
                            for i in range(len(self.dataset))]
        return self._tokens

    def _make_batch(self, idxs: np.ndarray) -> Dict[str, np.ndarray]:
        tokens = self._encode_all()
        imgs = self.dataset.cached_batch(idxs)   # warm path: no decode
        if imgs is None:
            pool = self._decode_pool()
            load = self.dataset.load_image
            imgs = np.stack(list(pool.map(load, (int(i) for i in idxs)))
                            if pool is not None
                            else [load(int(i)) for i in idxs])
        caps = np.full((self.max_caption_len, len(idxs)), PAD, dtype=np.int32)
        lengths = np.zeros((len(idxs),), dtype=np.int32)
        for j, i in enumerate(idxs):
            t = tokens[int(i)][:self.max_caption_len]
            caps[:len(t), j] = t
            lengths[j] = len(t)
        return {"images": imgs, "captions": caps, "lengths": lengths}

    def _index_batches(self) -> Iterator[np.ndarray]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(order)
        n_full = len(order) // self.batch_size
        for k in range(n_full):
            yield order[k * self.batch_size:(k + 1) * self.batch_size]
        if not self.drop_last and len(order) % self.batch_size:
            yield order[n_full * self.batch_size:]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Batches built by a background thread.  Abandoning the iterator
        (the trainer's 50-batch validation cap) sets ``stop``, so the
        producer does not stay blocked on a full queue."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idxs in self._index_batches():
                    if not put_or_stop(self._make_batch(idxs)):
                        return
            finally:
                put_or_stop(sentinel)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            stop.set()


def device_prefetch(iterator, device, *, size: int = 2
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Batches of ``iterator`` (dicts of numpy arrays) as tensors on
    ``device``, ``size`` of them in flight ahead of the consumer, so host
    decode and the host-to-device copy overlap the device's work (JAX
    ``loader.device_prefetch``).  On a card each batch is copied into
    pinned host buffers and then, without blocking, on a side stream; the
    consumer's stream waits on the copy's event before it uses the batch
    (PyTorch's pinned-memory cache reuses a buffer only after its copy has
    completed).  On the CPU the batches come through as tensors.  Values
    and dtypes are the iterator's."""
    dev = torch.device(device)
    it = iter(iterator)
    if dev.type != "cuda":
        for batch in it:
            yield {k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in batch.items()}
        return
    side = torch.cuda.Stream(device=dev)
    pending: "collections.deque" = collections.deque()

    def put(batch):
        host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                for k, v in batch.items()}
        with torch.cuda.stream(side):
            out = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    for batch in it:
        pending.append(put(batch))
        if len(pending) >= size:
            break
    while pending:
        out, done = pending.popleft()
        torch.cuda.current_stream(dev).wait_event(done)
        for t in out.values():            # freed only after this stream's use
            t.record_stream(torch.cuda.current_stream(dev))
        nxt = next(it, None)
        if nxt is not None:
            pending.append(put(nxt))
        yield out


def get_loader(root_folder: str,
               annotation_file: str = "data/flickr8k/captions_clean.csv", *,
               batch_size: int = 32, max_caption_len: int = 48,
               shuffle: bool = True, image_size: int = 224,
               freq_threshold: int = 5, seed: int = 0, vocab=None,
               host_shard: bool = False) -> Tuple[BatchLoader, CaptionDataset]:
    """The reference's entry point: ``(loader, dataset)``.

    ``host_shard=True``: in a world of more than one data index whose
    processes load their own rows, narrow the dataset to this process's
    ``host_shard`` (the rows of its data index: every model rank of one
    data index loads the same rows) AFTER the vocabulary is built (token
    ids must agree across processes): the train-loader setting for data
    parallelism.  A no-op in one process, and where the world's loader
    batches are global (``parallel/multihost.launch(split=True)``)."""
    from imagecaptioner_tpu_torch.core import mesh as MS
    from imagecaptioner_tpu_torch.parallel import multihost as MH

    dataset = CaptionDataset(root_folder, annotation_file,
                             freq_threshold=freq_threshold,
                             image_size=image_size, vocab=vocab)
    if host_shard and MS.data_size() > 1 and not MH.split_batches():
        dataset.select(MH.host_shard(len(dataset)))
    loader = BatchLoader(dataset, batch_size=batch_size,
                         max_caption_len=max_caption_len, shuffle=shuffle,
                         seed=seed)
    return loader, dataset
