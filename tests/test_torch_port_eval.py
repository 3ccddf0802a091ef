"""The port's evaluation layer against the JAX package on the CPU: the
caption metrics, the latency harness, the metric log, asynchronous
checkpoints, and both evaluators on one tiny float32 checkpoint pair
(a full student E=16, H=24 and a two-layer teacher, 64x64 images, both
sharpened so that captions differ between images): the same captions,
BLEU-1/2, METEOR, parameter counts and report keys.  Timings are not
compared."""

import json

import jax
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.data.dataset import CaptionDataset as JDataset
from imagecaptioner_tpu.eval import evaluate_student as JES
from imagecaptioner_tpu.eval import evaluate_teacher as JET
from imagecaptioner_tpu.eval import latency as JLAT
from imagecaptioner_tpu.eval import metrics as JMET
from imagecaptioner_tpu.utils import logging as JLOG
from imagecaptioner_tpu_torch.core.config import (TeacherConfig,
                                                  full_student_config)
from imagecaptioner_tpu_torch.data.dataset import CaptionDataset
from imagecaptioner_tpu_torch.data.synthetic import make_synthetic_dataset
from imagecaptioner_tpu_torch.eval import evaluate_student as ES
from imagecaptioner_tpu_torch.eval import evaluate_teacher as ET
from imagecaptioner_tpu_torch.eval import latency as LAT
from imagecaptioner_tpu_torch.eval import metrics as MET
from imagecaptioner_tpu_torch.models.student import student_init
from imagecaptioner_tpu_torch.models.teacher import teacher_init
from imagecaptioner_tpu_torch.utils import checkpoint as CKPT
from imagecaptioner_tpu_torch.utils.logging import MetricLogger
from test_torch_port_compact import few_threads, sharpen

S, N = 64, 4
TEACHER = dict(embed_size=32, num_heads=4, num_decoder_layers=2, dropout=0.0,
               encoder_dim=24, encoder_depth=2, encoder_heads=3,
               patch_size=16, image_size=S)
STUDENT = dict(embed_size=16, hidden_size=24, num_layers=2, dropout=0.0,
               use_attention_refinement=True, model_type="full")

CANDIDATES = [[], ["a"], ["a", "dog"], ["a", "dog", "a", "dog"],
              ["the", "red", "ball", "the", "red"], ["x", "y", "z"],
              ["dog", "a", "runs", "on", "the", "grass", "."]]
REFERENCES = [[], ["a"], ["a", "dog", "runs"], ["the", "red", "ball"],
              ["a", "dog", "runs", "on", "the", "grass", "."]]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_bleu_and_meteor_match_jax(n):
    for c in CANDIDATES:
        for r in REFERENCES:
            assert MET.ngram_precision(c, r, n) == JMET.ngram_precision(c, r, n)
            assert MET.bleu_n(c, r, n) == JMET.bleu_n(c, r, n)
            if n == 1:
                assert MET.meteor_f1(c, r) == JMET.meteor_f1(c, r)
    assert MET.bleu_n(["a", "b"], ["a", "b"], 2) == 1.0
    assert MET.bleu_n(["a"], ["a", "b"], 2) == 0.0
    assert MET.meteor_f1(["x"], ["a"]) == 0.0


def test_length_diversity_floor_and_monitoring_bleu_match_jax():
    for caps in (CANDIDATES, [], [[]], REFERENCES[2:]):
        assert MET.caption_length_stats(caps) == JMET.caption_length_stats(caps)
        assert MET.vocabulary_diversity(caps) == JMET.vocabulary_diversity(caps)
    refs = REFERENCES[1:] + [["a", "red", "dog"]]
    for kw in (dict(), dict(extra_candidates=[["a", "the", "red"]]),
               dict(max_len=2)):
        got = MET.adversarial_constant_bleu1(refs, **kw)
        assert got == JMET.adversarial_constant_bleu1(refs, **kw)
        assert 0 < got["floor"] <= 1 and got["adversarial_tokens"]

    class V:
        itos = {0: "<PAD>", 1: "<START>", 2: "<END>", 4: "dog", 5: "runs"}

    for p, t in (([4, 5, 2], [4, 2, 0]), ([5], [4]), ([4, 9], [1, 2]),
                 ([], [5, 5])):
        assert MET.monitoring_bleu(p, t, V()) == JMET.monitoring_bleu(p, t, V())


def test_latency_harness_keys_and_distinct_inputs():
    seen = []

    def fn(x):
        seen.append(float(x[0]))
        return (x * 2, {"n": x.sum()})

    out = LAT.measure_inference_time(fn, lambda i: torch.full((3,), float(i)),
                                     num_runs=4, warmup=2)
    ref = JLAT.measure_inference_time(lambda x: x * 2, lambda i: np.full(
        (3,), float(i), np.float32), num_runs=4, warmup=2)
    assert set(out) == set(ref) == {"mean_s", "p50_s", "min_s", "max_s",
                                    "num_runs"}
    assert out["num_runs"] == 4 and 0 <= out["min_s"] <= out["p50_s"] \
        <= out["max_s"] and out["min_s"] <= out["mean_s"] <= out["max_s"]
    assert len(seen) == 6 and len(set(seen)) == 6


def test_metric_logger_writes_the_jax_records(tmp_path):
    steps = [{"total_loss": 1.5, "grad_norm": np.float32(0.25)},
             {"total_loss": 1.25, "grad_norm": torch.tensor(0.5)}]
    for logger, name in ((MetricLogger, "p"), (JLOG.MetricLogger, "j")):
        with logger(str(tmp_path / name / "m.jsonl")) as log:
            for i, m in enumerate(steps):
                log.log_step(10 + i, {k: float(v) for k, v in m.items()},
                             epoch=1, lr=1e-3 if i else None)
    p = [json.loads(x) for x in (tmp_path / "p" / "m.jsonl").read_text()
         .splitlines()]
    j = [json.loads(x) for x in (tmp_path / "j" / "m.jsonl").read_text()
         .splitlines()]
    assert [sorted(r) for r in p] == [sorted(r) for r in j]
    assert [{k: v for k, v in r.items() if k != "t"} for r in p] == \
        [{k: v for k, v in r.items() if k != "t"} for r in j]
    MetricLogger(None).log_step(0, {"x": 1.0})          # logs nothing


def test_async_checkpoint_snapshots_and_reports_write_errors(tmp_path):
    w = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    tree = {"w": w, "n": np.ones(2, np.int32), "epoch": 3, "name": "x",
            "layers": [{"b": torch.zeros(2)}], "none": None}
    sync_path, async_path = tmp_path / "s.npz", tmp_path / "a.npz"
    CKPT.save_checkpoint(str(sync_path), tree)
    CKPT.save_checkpoint_async(str(async_path), tree)
    w.add_(100.0)                  # an optimizer step after the call
    CKPT.wait_for_saves()
    a, s = CKPT.load_checkpoint(str(async_path)), CKPT.load_checkpoint(
        str(sync_path))
    np.testing.assert_array_equal(a["w"], np.arange(6).reshape(2, 3))
    assert jax.tree.structure(a) == jax.tree.structure(s)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(s)):
        np.testing.assert_array_equal(x, y)
    (tmp_path / "file").write_text("")
    fut = CKPT.save_checkpoint_async(str(tmp_path / "file" / "x.npz"), tree)
    with pytest.raises(OSError):
        CKPT.wait_for_saves()
    assert fut.exception() is not None
    CKPT.wait_for_saves()          # the error was reported once


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A grid dataset, its vocabulary, and a sharpened student and teacher
    from the port's numpy initialisers, written as JAX-format checkpoints."""
    root = tmp_path_factory.mktemp("evalpair")
    data = root / "data"
    make_synthetic_dataset(str(data), n_images=N, image_size=S, seed=1,
                           learnable=True, task="grid")
    csv = str(data / "captions_clean.csv")
    vocab = CaptionDataset(str(data), csv, freq_threshold=1).vocab
    vocab.save(str(root / "vocab.json"))
    V = len(vocab)
    t_params = teacher_init(1, TeacherConfig(vocab_size=V, **TEACHER))
    for layer in t_params["decoder"]:        # the images matter
        layer["multihead_attn"]["out_proj"]["weight"] *= 4.0
        layer["multihead_attn"]["in_proj_weight"] *= 2.0
    CKPT.save_checkpoint(str(root / "teacher.npz"), {
        "model_state_dict": {"params": t_params}, "vocab_size": V,
        "model_config": TEACHER})
    s_cfg = full_student_config(V, embed_size=16, hidden_size=24, dropout=0.0)
    s_params, s_state = student_init(1, s_cfg)
    sharpen(s_params["decoder"], gain=2.0, end_bias=0.0)
    CKPT.save_checkpoint(str(root / "student.npz"), {
        "student_state_dict": {"params": s_params, "model_state": s_state},
        "vocab_size": V, "model_config": STUDENT})
    paths = {k: str(root / f) for k, f in (("student", "student.npz"),
                                           ("teacher", "teacher.npz"),
                                           ("vocab", "vocab.json"))}
    return root, str(data), csv, paths


@pytest.fixture(scope="module")
def reports(pair):
    """Both packages' student and teacher reports on the same rows."""
    root, data, csv, paths = pair
    kw = dict(max_samples=N, eval_batch=2, verbose=False)
    jds = JDataset(data, csv, image_size=S, vocab=JES.Vocabulary.load(
        paths["vocab"]))
    jst = JES.load_student_evaluator(paths["student"], paths["teacher"],
                                     paths["vocab"])
    jte = JET.load_teacher_evaluator(paths["teacher"], paths["vocab"])
    out = {"jax": (jst.generate_comparison_report(
        jds, str(root / "js.json"), measure_latency_samples=0, **kw),
        jte.generate_report(jds, str(root / "jt.json"), **kw))}
    with few_threads():
        pst = ES.load_student_evaluator(paths["student"], paths["teacher"],
                                        paths["vocab"], device="cpu")
        pte = ET.load_teacher_evaluator(paths["teacher"], paths["vocab"],
                                        device="cpu")
        pds = CaptionDataset(data, csv, image_size=S, vocab=pst.vocab)
        out["port"] = (pst.generate_comparison_report(
            pds, str(root / "ps.json"), measure_latency_samples=0, **kw),
            pte.generate_report(pds, str(root / "pt.json"), **kw))
    return out


def _keys(d):
    """The nested key structure of a report."""
    if isinstance(d, dict):
        return {k: _keys(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_keys(v) for v in d]
    return type(d).__name__ if d is None else "value"


def test_student_report_matches_jax(reports):
    (js, _), (ps, _) = reports["jax"], reports["port"]
    assert _keys(ps) == _keys(js)
    assert ps["sample_comparisons"] == js["sample_comparisons"]
    for model in ("student", "teacher"):
        assert ps[model] == js[model] and ps[model]["success_rate"] == 1.0
    assert ps["summary"] == js["summary"]
    assert ps["summary"]["student_parameters"] > 20_000_000   # ResNet-50
    students = [r["student"] for r in ps["sample_comparisons"]]
    teachers = [r["teacher"] for r in ps["sample_comparisons"]]
    assert len(set(students)) > 1 and len(set(teachers)) > 1      # power
    assert len({len(c.split()) for c in students + teachers}) > 1


def test_teacher_report_matches_jax(reports):
    (_, jt), (_, pt) = reports["jax"], reports["port"]
    assert _keys(pt) == _keys(jt)
    assert pt == jt and pt["num_samples"] == N and pt["success_rate"] == 1.0


def test_evaluator_batches_equal_single_images(pair):
    """The batched decoders give each image's own caption; a batch that
    fails falls back to single images and counts per-image failures."""
    root, data, csv, paths = pair
    with few_threads():
        ev = ES.load_student_evaluator(paths["student"], paths["teacher"],
                                       paths["vocab"], device="cpu")
        ds = CaptionDataset(data, csv, image_size=S, vocab=ev.vocab)
        images = ET.to_images(np.stack([ds[i][0] for i in range(N)]), "cpu",
                              torch.float32)
        assert ev.student_captions_batch(images) == [
            ev.student_caption(images[i:i + 1]) for i in range(N)]
        assert ev.teacher_captions_batch(images) == [
            ev.teacher_caption(images[i:i + 1]) for i in range(N)]
        ev.student_captions_batch = None                # every batch fails
        calls = []
        real = ev.teacher_caption

        def flaky(image, **kw):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("boom")
            return real(image, **kw)

        ev.teacher_captions_batch = None
        ev.teacher_caption = flaky
        res = ev.compare_models_on_dataset(ds, max_samples=N, eval_batch=2,
                                           measure_latency_samples=0,
                                           verbose=False)
    assert res["student"]["success_rate"] == 1.0
    assert res["teacher"]["success_rate"] == (N - 1) / N
    assert res["comparisons"][1]["teacher"] == "<error: boom>"


def test_evaluator_clis_write_reports_and_need_a_card(pair, tmp_path):
    root, data, csv, paths = pair
    common = ["--vocab", paths["vocab"], "--data-root", data]
    s_out, t_out = tmp_path / "s.json", tmp_path / "t.json"
    s_args = ["--student-checkpoint", paths["student"], "--teacher-checkpoint",
              paths["teacher"], *common, "--output", str(s_out)]
    t_args = ["--checkpoint", paths["teacher"], *common, "--output",
              str(t_out)]
    with few_threads():
        assert ES.main(s_args + ["--device", "cpu"]) == 0
        assert ET.main(t_args + ["--max-samples", "2", "--device", "cpu"]) == 0
    rep = json.loads(s_out.read_text())
    assert rep["num_samples"] == N and len(rep["sample_comparisons"]) == N
    for model in ("student", "teacher"):   # latency of every image, by default
        assert 0 < rep[model]["avg_inference_time_s"] < 60
    assert rep["summary"]["speedup"] > 0
    assert json.loads(t_out.read_text())["num_samples"] == 2
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for main, args, out in ((ES.main, s_args, tmp_path / "s2.json"),
                            (ET.main, t_args, tmp_path / "t2.json")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(args[:-1] + [str(out)])
        assert not out.exists()


def test_single_image_figures(pair, tmp_path):
    root, data, csv, paths = pair
    with few_threads():
        ev = ES.load_student_evaluator(paths["student"], paths["teacher"],
                                       paths["vocab"], device="cpu")
        ds = CaptionDataset(data, csv, image_size=S, vocab=ev.vocab)
        r = ev.evaluate_single_image_comparison(
            ds, 1, save_figure=str(tmp_path / "s.png"))
        t = ET.load_teacher_evaluator(paths["teacher"], paths["vocab"],
                                      device="cpu").evaluate_single_image(
            ds, 1, save_figure=str(tmp_path / "t.png"))
    assert r["figure"] == str(tmp_path / "s.png") and (tmp_path / "s.png").exists()
    assert (tmp_path / "t.png").stat().st_size > 0
    assert t["generated"] == r["teacher"] and t["reference"] == r["reference"]
