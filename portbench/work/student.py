"""The full student's projection, refinement and decoder (E, H, L, V from
the configuration's ``student`` group)."""


def encoder_head_macs(s: dict, channels: int = 2048) -> float:
    """Per image: the 2048 -> E projection and the refinement (4-head
    self-attention over L tokens and its 2E FFN)."""
    E, L = s["embed_size"], s["feature_tokens"]
    proj = L * channels * E
    attn = 4 * L * E * E + 2 * L * L * E
    ffn = 2 * L * E * 2 * E
    return float(proj + attn + ffn)


def head_params(s: dict, channels: int = 2048) -> int:
    E = s["embed_size"]
    return channels * E + 4 * E * E + 4 * E * E


def step_macs(s: dict) -> float:
    """Per row and step of the decoder: attention, combine, both LSTM
    layers, the two-layer head."""
    E, H, L, V = (s["embed_size"], s["hidden_size"], s["feature_tokens"],
                  s["vocab_size"])
    attention = H * E + L * E
    combine = 2 * E * E
    lstm = (E + H) * 4 * H + 2 * H * 4 * H
    head = H * E + E * V
    return float(attention + combine + lstm + head)


def decoder_params(s: dict) -> int:
    E, H, V = s["embed_size"], s["hidden_size"], s["vocab_size"]
    return (V * E + (H + E) * E + 2 * E * E + (E + H) * 4 * H + 2 * H * 4 * H
            + H * E + E * V)


def decode(s: dict, rows: int, steps: int, act_bytes: int = 2):
    """(operations, bytes) of a greedy decode of ``rows`` rows for
    ``steps`` steps: the feature projection once, then the steps; bytes:
    features in, tokens out, weights once."""
    E, L = s["embed_size"], s["feature_tokens"]
    ops = 2.0 * rows * (L * E * E + steps * step_macs(s))
    nbytes = act_bytes * (rows * L * E + decoder_params(s)) + 4 * rows * steps
    return ops, float(nbytes)


def scan(s: dict, rows: int, steps: int, backward: bool,
         act_bytes: int = 2):
    """(operations, bytes) of the teacher-forced recurrence (#4/#5) and,
    with ``backward``, its reverse chain (#6, twice the products): the
    attention, the combine of the context and both LSTM layers; bytes:
    the step inputs, features and outputs once, the weights once."""
    E, H, L = s["embed_size"], s["hidden_size"], s["feature_tokens"]
    per = H * E + L * E + E * E + (E + H) * 4 * H + 2 * H * 4 * H
    ops = 2.0 * rows * steps * per * (3 if backward else 1)
    weights = H * E + E * E + (E + H) * 4 * H + 2 * H * 4 * H
    acts = rows * (steps * (E + H + L) + 2 * L * E)
    nbytes = act_bytes * (acts * (2 if backward else 1) + weights)
    return ops, float(nbytes)
