"""The operation counts of ``portbench/work`` against hand counts."""

import json

import pytest

from portbench import spec
from portbench.work import peaks, resnet50, student, teacher_decoder, vit

S = json.load(open(spec.HERE / "configs/full_student.json"))["student"]
T = json.load(open(spec.HERE / "configs/vits16_teacher.json"))["teacher"]


def test_resnet50_macs():
    # 4.1 GMACs at 224 (He et al.; torchvision counts 4.09 with the
    # classifier's 2M, which is not here)
    assert resnet50.macs(224) == pytest.approx(4.09e9, rel=0.01)
    assert resnet50.params() == pytest.approx(23.45e6, rel=0.01)


def test_vit_s16_macs():
    # 4.6 GMACs at 224 (DeiT-S); 197 tokens
    assert vit.tokens(T) == 197
    assert vit.macs(T) == pytest.approx(4.6e9, rel=0.02)


def test_lstm_step_from_its_matrices():
    E, H, L, V = 256, 512, 49, 2994
    hand = (H * E + L * E) + 2 * E * E + (E + H) * 4 * H + 2 * H * 4 * H \
        + H * E + E * V
    assert student.step_macs(S) == hand
    ops, nbytes = student.decode(S, 256, 20)
    assert ops == 2 * 256 * (L * E * E + 20 * hand)
    assert nbytes > 2 * student.decoder_params(S)


def test_beam_step_from_its_matrices():
    E = 512
    layer = (4 * E * E + 2 * 8 * E) + (2 * E * E + 2 * 197 * E) + 4 * E * E
    assert teacher_decoder.layer_macs(T, 7) == layer
    assert teacher_decoder.beam_step_macs(T, 7) == 4 * layer + E * 2994


def test_bound_takes_the_larger():
    assert peaks.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 0, "float32") == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, "float32") == pytest.approx(1.0)
