"""The port's spans (``core/spans.py``): nothing entered without a profiler,
and under a CPU ``torch.profiler`` session the ``ic:`` ranges of a greedy
call, a beam search and a KD step, as ``user_annotation`` events nested at
the layer boundaries ``core/spans.NAMES`` lists.

Tiny widths on the CPU, where the port takes its plain versions: a full
student at E=H=32 on 64x64 images, a teacher at E=32 on 32x32 images, B=2
images a call, A=2 micro-batches of 2 a KD step.  The beam search runs a
teacher whose END bias is raised, so that every beam ends early and the
loop exits before ``max_length``, and one whose bias is not, so that it runs
every step."""

import ast
import collections
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core import spans as SP
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.data.vocabulary import END
from imagecaptioner_tpu_torch.distill.projector import (
    create_feature_projectors, make_projectors)
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.models import transformer as TD
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.models.teacher import Teacher, teacher_init
from imagecaptioner_tpu_torch.train import steps as PS
from imagecaptioner_tpu_torch.utils import convert as CV

PACKAGE = Path(__file__).resolve().parent.parent / "imagecaptioner_tpu_torch"
V, B, A, STEPS = 40, 2, 2, 6
TKW = dict(vocab_size=V, embed_size=32, num_heads=4, num_decoder_layers=2,
           dropout=0.0, encoder_dim=24, encoder_depth=2, encoder_heads=3,
           image_size=32, patch_size=16)


def _images(n, size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                dtype=np.uint8)


def _student():
    cfg = PC.full_student_config(V, embed_size=32, hidden_size=32,
                                 dropout=0.0, image_size=64)
    p, s = student_init(0, cfg)
    model = Student(cfg)
    model.load_state_dict(CV.jax_student_to_state_dict(p, s, cfg),
                          strict=True)
    return model, cfg


def _teacher(end_bias=0.0):
    cfg = PC.TeacherConfig(**TKW)
    p = teacher_init(0, cfg)
    p["fc_out"]["bias"] = np.array(p["fc_out"]["bias"], copy=True)
    p["fc_out"]["bias"][END] += end_bias
    model = Teacher(cfg)
    model.load_state_dict(CV.jax_teacher_to_state_dict(p), strict=True)
    return model.eval(), cfg


def _traced(fn, tmp_path):
    """``fn()`` under a CPU profiler session; its result and the ``ic:``
    events of the exported Chrome trace."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X"
             and str(e.get("name", "")).startswith(SP.PREFIX)]
    assert spans and {e["cat"] for e in spans} == {"user_annotation"}
    return out, spans


def _parents(spans):
    """(span, its parent) name pairs, the parent the shortest other span of
    the thread whose interval holds it (None at the top), counted."""
    def iv(e):
        return float(e["ts"]), float(e["ts"]) + float(e["dur"])
    pairs = collections.Counter()
    for e in spans:
        a, b = iv(e)
        holders = [h for h in spans if h is not e and h["tid"] == e["tid"]
                   and iv(h)[0] <= a and b <= iv(h)[1]]
        parent = min(holders, key=lambda h: float(h["dur"]), default=None)
        pairs[e["name"][len(SP.PREFIX):],
              parent and parent["name"][len(SP.PREFIX):]] += 1
    return pairs


SERVE = {("serve.call", None): 1, ("serve.upload", "serve.call"): 1,
         ("serve.encode", "serve.call"): 1, ("serve.decode", "serve.call"): 1,
         ("serve.fetch", "serve.call"): 1}


def test_without_a_profiler_no_range_is_entered(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a))
    assert not torch.autograd._profiler_enabled()
    assert SP.span("serve.call") is SP.span("kd.step")
    with SP.span("beam.step"):
        pass
    student, cfg = _student()
    caption = serve.make_greedy_captioner(student.eval(), cfg, "cpu",
                                          max_length=STEPS)
    assert caption(_images(B, 64)).shape == (B, STEPS)
    assert entered == []


def test_greedy_call_spans(tmp_path):
    student, cfg = _student()
    caption = serve.make_greedy_captioner(student.eval(), cfg, "cpu",
                                          max_length=STEPS)
    toks, spans = _traced(lambda: caption(_images(B, 64)), tmp_path)
    assert toks.shape == (B, STEPS)
    assert _parents(spans) == SERVE


@pytest.mark.parametrize("end_bias", [0.0, 20.0], ids=["all_steps",
                                                        "early_exit"])
def test_beam_call_spans(end_bias, tmp_path, monkeypatch):
    """One ``beam.step`` (holding ``beam.decoder`` and ``beam.select``) for
    each decoder step the loop ran, each after a ``beam.exit_check``, and
    one check more where the loop exited early."""
    teacher, cfg = _teacher(end_bias)
    ran = []
    step = TD.decoder_step_cached
    monkeypatch.setattr(TD, "decoder_step_cached",
                        lambda *a, **k: ran.append(1) or step(*a, **k))
    caption = serve.make_beam_captioner(teacher, cfg, "cpu",
                                        max_length=STEPS, beam_size=3)
    (seqs, scores, lens), spans = _traced(lambda: caption(_images(B, 32)),
                                          tmp_path)
    n = len(ran)
    assert seqs.shape == (B, 3, STEPS + 1)
    assert n == STEPS if end_bias == 0.0 else 0 < n < STEPS
    checks = n + (n < STEPS)
    assert _parents(spans) == collections.Counter({
        **SERVE, ("beam.memory_kv", "serve.decode"): 1,
        ("beam.exit_check", "serve.decode"): checks,
        ("beam.step", "serve.decode"): n, ("beam.decoder", "beam.step"): n,
        ("beam.select", "beam.step"): n, ("beam.finish", "serve.decode"): 1})


def test_kd_step_spans(tmp_path):
    t_cfg = PC.TeacherConfig(**{**TKW, "image_size": 64})
    teacher = Teacher(t_cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(
        teacher_init(0, t_cfg)), strict=True)
    student, s_cfg = _student()
    projectors = make_projectors(t_cfg.embed_size, s_cfg.embed_size,
                                 s_cfg.hidden_size)
    projectors.load_state_dict(CV.jax_projectors_to_state_dict(
        create_feature_projectors(1, teacher_embed=t_cfg.embed_size,
                                  student_embed=s_cfg.embed_size,
                                  student_hidden=s_cfg.hidden_size)[0]),
        strict=True)
    state = PS.init_train_state(student, projectors, s_cfg)
    step = PS.make_kd_train_step(
        teacher.eval(), t_cfg, s_cfg, PC.DistillConfig(),
        PC.KDTrainConfig(batch_size=B, accumulation_steps=A, dropout=0.0),
        aug=PT.AugmentConfig(), compute_dtype=torch.float32)
    T = 7
    rng = np.random.default_rng(2)
    caps = rng.integers(1, V, (A, T, B)).astype(np.int32)
    host = {"images": _images(A * B, 64).reshape(A, B, 64, 64, 3),
            "captions": caps, "lengths": np.full((A, B), T, np.int32)}

    def one_step():
        return step(state, PS.batch_to_device(host, "cpu"), 0.0,
                    torch.Generator().manual_seed(0))
    metrics, spans = _traced(one_step, tmp_path)
    assert torch.isfinite(metrics["total_loss"])
    per_micro = ("kd.augment", "kd.teacher", "kd.student", "kd.loss",
                 "kd.backward")
    assert _parents(spans) == collections.Counter({
        ("kd.feed", None): 1, ("kd.step", None): 1,
        ("kd.optimizer", "kd.step"): 1,
        **{(n, "kd.step"): A for n in per_micro}})


def _span_names_used():
    """Every string given to a ``span(...)`` call in the package."""
    used = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and getattr(
                    node.func, "id", getattr(node.func, "attr", None))
                    == "span" and node.args):
                arg = node.args[0]
                assert isinstance(arg, ast.Constant), \
                    f"{path}: a span's name is a literal"
                used.add(arg.value)
    return used


def test_every_span_name_is_listed_and_every_listed_name_used():
    assert _span_names_used() == set(SP.NAMES)
    assert len(set(SP.NAMES)) == len(SP.NAMES)


def test_no_span_name_is_part_of_another():
    """A trace reader matches a range's name as a substring."""
    labels = [SP.PREFIX + n for n in SP.NAMES]
    assert not [(a, b) for a in labels for b in labels if a != b and a in b]
