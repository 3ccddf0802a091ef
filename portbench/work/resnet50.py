"""ResNet-50 (v1.5) without its classifier."""

STAGES = [(3, 64, 1), (4, 128, 2), (6, 256, 2), (3, 512, 2)]


def convs(image_size: int = 224):
    """(in_ch, out_ch, kernel, out_hw) of every convolution, in order."""
    out = []
    s = image_size // 2
    out.append((3, 64, 7, s))
    s //= 2                                   # max pool
    in_ch = 64
    for blocks, mid, stride in STAGES:
        for b in range(blocks):
            st = stride if b == 0 else 1
            so = s // st
            out += [(in_ch, mid, 1, s), (mid, mid, 3, so),
                    (mid, mid * 4, 1, so)]
            if b == 0:
                out.append((in_ch, mid * 4, 1, so))
            in_ch, s = mid * 4, so
    return out


def macs(image_size: int = 224) -> float:
    """Multiply-adds of one image's forward pass."""
    return float(sum(i * o * k * k * hw * hw for i, o, k, hw in convs(image_size)))


def params(image_size: int = 224) -> int:
    return sum(i * o * k * k for i, o, k, _ in convs(image_size))


def forward(batch: int, image_size: int = 224, act_bytes: int = 2):
    """(operations, bytes) of one batch: images in, features out, weights
    once."""
    feat = (image_size // 32) ** 2 * 2048
    nbytes = act_bytes * (batch * (3 * image_size ** 2 + feat) + params(image_size))
    return 2.0 * batch * macs(image_size), float(nbytes)


def trained_macs(image_size: int = 224, frozen_stages: int = 2) -> float:
    """Multiply-adds of the layers after the frozen stem and stages."""
    n_frozen = 1 + sum(b * 3 + 1 for b, _, _ in STAGES[:frozen_stages])
    return float(sum(i * o * k * k * hw * hw
                     for i, o, k, hw in convs(image_size)[n_frozen:]))
