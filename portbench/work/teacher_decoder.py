"""The teacher's transformer decoder (post-LN, FFN 2E) and head."""

from portbench.work import vit


def layer_macs(t: dict, pos: int) -> float:
    """One token of one layer at position ``pos`` (0-based): self-attention
    over pos + 1 keys, cross-attention over the memory, the FFN."""
    E, n = t["embed_size"], vit.tokens(t)
    self_attn = 4 * E * E + 2 * (pos + 1) * E
    cross = 2 * E * E + 2 * n * E
    ffn = 2 * E * 2 * E
    return float(self_attn + cross + ffn)


def memory_kv_macs(t: dict) -> float:
    """Per image: every layer's K and V projections of the memory."""
    E = t["embed_size"]
    return float(t["num_decoder_layers"] * vit.tokens(t) * 2 * E * E)


def forced_macs(t: dict, T: int) -> float:
    """Per sequence, teacher-forced over T positions: layers and head."""
    return (sum(t["num_decoder_layers"] * layer_macs(t, p) for p in range(T))
            + memory_kv_macs(t) + T * t["embed_size"] * t["vocab_size"])


def beam_step_macs(t: dict, pos: int) -> float:
    """Per beam row at step ``pos``: the layers and the head."""
    return (t["num_decoder_layers"] * layer_macs(t, pos)
            + t["embed_size"] * t["vocab_size"])


def beam_attention(t: dict, rows: int, images: int, pos: int,
                   act_bytes: int = 4):
    """(operations, bytes) of one step's two attention cores (#9 and #10)
    in every layer: q in, out written, K/V of the cache positions read once
    per beam row for self-attention and once per image for the memory."""
    E, n, layers = t["embed_size"], vit.tokens(t), t["num_decoder_layers"]
    ops = 2.0 * layers * rows * (2 * (pos + 1) * E + 2 * n * E)
    nbytes = act_bytes * layers * (rows * (2 * (pos + 1) * E + 4 * E)
                                   + images * 2 * n * E) + 4 * rows * (pos + 1)
    return ops, float(nbytes)
