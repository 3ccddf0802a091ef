"""ViT encoder (the configuration's ``teacher`` group)."""


def tokens(t: dict) -> int:
    return (t["image_size"] // t["patch_size"]) ** 2 + 1


def macs(t: dict) -> float:
    """Multiply-adds of one image: patch embedding and the blocks."""
    d, p = t["encoder_dim"], t["patch_size"]
    n = tokens(t)
    hidden = int(d * t["encoder_mlp_ratio"])
    patch = (n - 1) * 3 * p * p * d
    block = n * d * 3 * d + 2 * n * n * d + n * d * d + 2 * n * d * hidden
    return float(patch + t["encoder_depth"] * block)


def params(t: dict) -> int:
    d, p = t["encoder_dim"], t["patch_size"]
    hidden = int(d * t["encoder_mlp_ratio"])
    return 3 * p * p * d + t["encoder_depth"] * (4 * d * d + 2 * d * hidden)


def encode(t: dict, batch: int, act_bytes: int = 4):
    """(operations, bytes) of the encoder and the projection to the
    decoder's width: images in, memory out, weights once."""
    d, e, n = t["encoder_dim"], t["embed_size"], tokens(t)
    ops = 2.0 * batch * (macs(t) + n * d * e)
    nbytes = act_bytes * (batch * (3 * t["image_size"] ** 2 + n * e)
                          + params(t) + d * e)
    return ops, float(nbytes)
