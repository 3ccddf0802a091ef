"""The traffic generator: every input a cell sends, from ``--seed`` and the
parameters of its traffic mix (``portbench/workloads/<name>.json``).

Images are grids of flat random colours (``grid`` pixels a cell) with a
little noise, drawn on the device in one call and copied to the host once:
every image differs from the others in every patch a ViT or a ResNet
reads, as the port's ``data/synthetic.py`` grid images do (a random network
maps plain noise images to nearly one feature).  Captions are START, Zipf-
ranked word ids over the vocabulary, END, padded with PAD; their word
counts are drawn from a core range with a tail.
"""

from __future__ import annotations

import numpy as np
import torch

PAD, START, END, FIRST_WORD = 0, 1, 2, 4


def images(n: int, size: int, seed: int, device, *, grid: int = 16,
           noise: int = 8) -> np.ndarray:
    """``n`` uint8 images (n, size, size, 3) on the host."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    cells = -(-size // grid)
    blocks = torch.randint(0, 256, (n, cells, cells, 3), generator=g,
                           device=device, dtype=torch.int16)
    img = blocks.repeat_interleave(grid, 1).repeat_interleave(grid, 2)
    img = img[:, :size, :size] + torch.randint(
        -noise, noise + 1, (n, size, size, 3), generator=g, device=device,
        dtype=torch.int16)
    return img.clamp(0, 255).to(torch.uint8).cpu().numpy()


def captions(n: int, T: int, vocab: int, rng: np.random.Generator, *,
             core=(8, 20), tail=(21, 40), tail_share: float = 0.1,
             zipf: float = 1.1):
    """``n`` captions time-major (T, n) int32, PAD-padded, and their
    lengths (n,) int32 counting START and END."""
    words = np.where(rng.random(n) < tail_share,
                     rng.integers(tail[0], tail[1] + 1, n),
                     rng.integers(core[0], core[1] + 1, n))
    words = np.minimum(words, T - 2)
    ranks = np.arange(1, vocab - FIRST_WORD + 1, dtype=np.float64)
    p = ranks ** -zipf
    p /= p.sum()
    caps = np.full((T, n), PAD, np.int32)
    for j, w in enumerate(words):
        ids = FIRST_WORD + rng.choice(len(p), size=int(w), p=p)
        caps[:w + 2, j] = np.concatenate([[START], ids, [END]])
    return caps, (words + 2).astype(np.int32)
