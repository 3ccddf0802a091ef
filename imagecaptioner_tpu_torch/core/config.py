"""Configuration dataclasses, a jax-free copy of ``imagecaptioner_tpu.core.config``.

The JAX package's ``core/__init__`` imports jax, so even its plain
dataclasses cannot be imported on a machine without jax.  Field names and
defaults are identical (``tests/test_torch_port_modules.py`` checks them
field for field).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline semantics (the fields the trainers read)."""

    root_dir: str = "data/flickr8k"
    captions_file: str = "data/flickr8k/captions_clean.csv"
    image_size: int = 224
    freq_threshold: int = 5
    batch_size: int = 32
    batch_size_cap: int = 16         # the reference's silent cap
    max_caption_len: int = 48        # static pad length
    mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    drop_last: bool = True
    shuffle: bool = True


@dataclass(frozen=True)
class TeacherConfig:
    """CaptioningTeacher: ViT-S/16 encoder + post-LN transformer decoder,
    production config 512/8/4/0.15."""

    vocab_size: int = 5000
    embed_size: int = 512
    num_heads: int = 8
    num_decoder_layers: int = 4
    dropout: float = 0.15
    encoder_dim: int = 384
    encoder_depth: int = 12
    encoder_heads: int = 6
    encoder_mlp_ratio: float = 4.0
    patch_size: int = 16
    image_size: int = 224
    max_pe_len: int = 5000

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def num_tokens(self) -> int:     # 196 patches + CLS = 197
        return self.num_patches + 1


@dataclass(frozen=True)
class StudentConfig:
    """CNN-LSTM students. ``variant`` selects full / compact / enhanced."""

    vocab_size: int = 5000
    variant: str = "full"            # full | compact | enhanced
    embed_size: int = 256
    hidden_size: int = 512
    num_layers: int = 2
    dropout: float = 0.2
    use_attention_refinement: bool = True
    feature_tokens: int = 49         # 7x7 spatial locations (8x8=64 for enhanced)
    image_size: int = 224
    decoder_impl: str = "scan"
    freeze_backbone: bool = True


def full_student_config(vocab_size: int, **over) -> StudentConfig:
    return StudentConfig(**{**dict(
        vocab_size=vocab_size, variant="full", embed_size=256, hidden_size=512,
        num_layers=2, dropout=0.2, use_attention_refinement=True,
        feature_tokens=49), **over})


def compact_student_config(vocab_size: int, **over) -> StudentConfig:
    """Compact defaults: MobileNetV2, 256/256, one LSTM layer, no refinement."""
    return StudentConfig(**{**dict(
        vocab_size=vocab_size, variant="compact", embed_size=256,
        hidden_size=256, num_layers=1, dropout=0.1,
        use_attention_refinement=False, feature_tokens=49), **over})


def enhanced_student_config(vocab_size: int, **over) -> StudentConfig:
    """Enhanced defaults: EfficientNet-B3, 384/768, three LSTM layers, 8x8=64
    tokens."""
    return StudentConfig(**{**dict(
        vocab_size=vocab_size, variant="enhanced", embed_size=384,
        hidden_size=768, num_layers=3, dropout=0.15,
        use_attention_refinement=True, feature_tokens=64), **over})


STUDENT_CONFIGS = {"full": full_student_config,
                   "compact": compact_student_config,
                   "enhanced": enhanced_student_config}


@dataclass(frozen=True)
class DistillConfig:
    """DistillationLoss weights.  With the defaults the ground-truth CE
    coefficient (1-a-b-g) is exactly 0.0: a reference quirk, preserved."""

    alpha: float = 0.7               # token-level KD
    beta: float = 0.2                # encoder feature KD
    gamma: float = 0.1               # decoder hidden-state KD
    temperature: float = 4.0


@dataclass(frozen=True)
class KDTrainConfig:
    """The KD trainer's hyperparameters."""

    learning_rate: float = 2e-4
    batch_size: int = 16
    accumulation_steps: int = 2
    num_epochs: int = 1
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    encoder_lr_scale: float = 0.1
    patience: int = 7
    validate_every: int = 2
    sched_t0: int = 5
    sched_t_mult: int = 2
    sched_eta_min: float = 1e-6
    dropout: float = 0.3             # the student is built with dropout 0.3 here
    teacher_bf16: bool = False       # run the frozen teacher in bf16


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
