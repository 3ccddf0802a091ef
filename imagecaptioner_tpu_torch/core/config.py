"""Student configuration, a jax-free copy of ``imagecaptioner_tpu.core.config``.

The JAX package's ``core/__init__`` imports jax, so even its plain
dataclasses cannot be imported on a machine without jax.  Field names and
defaults are identical (``tests/test_torch_port_modules.py`` checks them
field for field).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StudentConfig:
    """CNN-LSTM students. ``variant`` selects full / compact / enhanced; the
    port serves ``full`` only so far."""

    vocab_size: int = 5000
    variant: str = "full"            # full | compact | enhanced
    embed_size: int = 256
    hidden_size: int = 512
    num_layers: int = 2
    dropout: float = 0.2
    use_attention_refinement: bool = True
    feature_tokens: int = 49         # 7x7 spatial locations
    image_size: int = 224
    decoder_impl: str = "scan"
    freeze_backbone: bool = True


def full_student_config(vocab_size: int, **over) -> StudentConfig:
    return StudentConfig(**{**dict(
        vocab_size=vocab_size, variant="full", embed_size=256, hidden_size=512,
        num_layers=2, dropout=0.2, use_attention_refinement=True,
        feature_tokens=49), **over})
