"""The port's twins of the root runners (``imagecaptioner_tpu_torch/
runners/``) on the CPU: the prerequisite checks, the pipeline's subprocess
command lines and exit codes, the optimized-training launcher, the demo
launcher's exits, the streamlit session-state flow with a fake streamlit
module (as ``tests/test_streamlit_ui.py`` drives the JAX package's demo),
the demo's captions against the port's own searches, and the device rule.
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from imagecaptioner_tpu_torch.core.config import (TeacherConfig,
                                                  compact_student_config)
from imagecaptioner_tpu_torch.data.dataset import write_ppm
from imagecaptioner_tpu_torch.data.vocabulary import Vocabulary
from imagecaptioner_tpu_torch.models.student import student_init
from imagecaptioner_tpu_torch.models.teacher import load_teacher, teacher_init
from imagecaptioner_tpu_torch.ops import decode as D
from imagecaptioner_tpu_torch.runners import run_app as RA
from imagecaptioner_tpu_torch.runners import run_kd_pipeline as RP
from imagecaptioner_tpu_torch.runners import run_optimized_training as RO
from imagecaptioner_tpu_torch.runners import streamlit_app as APP
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.eval.serve import load_student
from imagecaptioner_tpu_torch.utils.checkpoint import save_checkpoint
from test_streamlit_ui import FakeSt, Rerun, SessionState
from test_torch_port_compact import few_threads

TEACHER = dict(embed_size=32, num_heads=4, num_decoder_layers=1, dropout=0.0,
               encoder_dim=24, encoder_depth=1, encoder_heads=3,
               encoder_mlp_ratio=4.0, patch_size=16, image_size=32)


@pytest.fixture()
def dataset_dir(tmp_path):
    """The three things the pipelines check for: a teacher checkpoint, a
    captions CSV and an Images directory (contents unread)."""
    root = tmp_path / "data"
    (root / "Images").mkdir(parents=True)
    (root / "captions_clean.csv").write_text("image,caption\n")
    teacher = tmp_path / "teacher.npz"
    teacher.write_bytes(b"")
    return str(root), str(teacher)


def test_prerequisite_checks(dataset_dir, capsys):
    root, teacher = dataset_dir
    csv = os.path.join(root, "captions_clean.csv")
    assert RP.check_prerequisites(teacher, root, csv)
    out = capsys.readouterr().out
    assert "[ok] package torch" in out and "[ok] package numpy" in out
    assert "jax" not in out and "pandas" not in out
    assert not RP.check_prerequisites(teacher + ".missing", root, csv)
    assert "[MISSING] teacher checkpoint" in capsys.readouterr().out


def _record_runs(monkeypatch, rcs):
    """Replace ``subprocess.run`` with a recorder returning ``rcs`` in turn."""
    calls = []

    def run(argv, env=None, **kw):
        calls.append((argv, env))
        return type("Done", (), {"returncode": rcs[len(calls) - 1]})()
    monkeypatch.setattr(RP.subprocess, "run", run)
    return calls


def test_pipeline_command_lines_and_exit_codes(dataset_dir, tmp_path,
                                               monkeypatch, capsys):
    """The trainer, then the evaluator, each as ``python -m`` of the port's
    module with the data, checkpoints and ``--device`` passed through and
    this package on ``PYTHONPATH``; exit 0 and the artifact list; exit 1
    when a step fails (the evaluator then does not run) or a prerequisite
    is missing (nothing runs); ``--skip-eval`` runs the trainer only."""
    root, teacher = dataset_dir
    out = str(tmp_path / "out")
    csv = os.path.join(root, "captions_clean.csv")
    argv = ["--data-root", root, "--teacher-checkpoint", teacher,
            "--output-dir", out, "--epochs", "1", "--student", "compact",
            "--max-samples", "7", "--device", "cpu"]
    calls = _record_runs(monkeypatch, [0, 0])
    assert RP.main(argv) == 0
    assert [c[0] for c in calls] == [
        [sys.executable, "-m", "imagecaptioner_tpu_torch.train.train_student_kd",
         "--data-root", root, "--captions-file", csv,
         "--teacher-checkpoint", teacher, "--output-dir", out,
         "--student", "compact", "--device", "cpu", "--epochs", "1"],
        [sys.executable, "-m",
         "imagecaptioner_tpu_torch.eval.evaluate_student",
         "--student-checkpoint", os.path.join(out, "best_student_model.npz"),
         "--teacher-checkpoint", teacher,
         "--vocab", os.path.join(out, "vocab.json"), "--data-root", root,
         "--captions-file", csv, "--max-samples", "7", "--device", "cpu"]]
    assert calls[0][1]["PYTHONPATH"].split(os.pathsep)[0] == RP.PACKAGE_PARENT
    assert os.path.isdir(os.path.join(RP.PACKAGE_PARENT,
                                      "imagecaptioner_tpu_torch"))
    listed = capsys.readouterr().out
    for name in RP.ARTIFACTS:
        assert f"[missing] {os.path.join(out, name)}" in listed
    assert f"[missing] {RP.REPORT}" in listed

    calls = _record_runs(monkeypatch, [3])
    assert RP.main(argv) == 1 and len(calls) == 1
    assert "FAILED (exit 3)" in capsys.readouterr().out
    calls = _record_runs(monkeypatch, [0, 2])
    assert RP.main(argv) == 1 and len(calls) == 2
    calls = _record_runs(monkeypatch, [0])
    assert RP.main(argv + ["--skip-eval"]) == 0 and len(calls) == 1
    assert RP.REPORT not in capsys.readouterr().out.split("Artifacts:")[-1]
    calls = _record_runs(monkeypatch, [])
    assert RP.main(["--data-root", str(tmp_path / "nothing"),
                    "--device", "cpu"]) == 1
    assert calls == [] and "aborting" in capsys.readouterr().out


def test_optimized_training_launcher(dataset_dir, monkeypatch, capsys):
    """A missing file exits 1 before training; the trainer runs in this
    process with the student and device passed on; its exception exits 1."""
    root, teacher = dataset_dir
    from imagecaptioner_tpu_torch.train import train_student_kd_optimized as O
    seen = []

    def train(data_root, captions, t_ckpt, out, **kw):
        seen.append((data_root, captions, t_ckpt, out, kw))
        return None, None, None

    monkeypatch.setattr(O, "train_student_with_kd_optimized", train)
    argv = ["--data-root", root, "--teacher-checkpoint", teacher,
            "--device", "cpu"]
    assert RO.main(argv[:2] + ["--teacher-checkpoint", "no.npz",
                               "--device", "cpu"]) == 1
    assert "Missing teacher checkpoint: no.npz" in capsys.readouterr().out
    assert seen == []
    assert RO.main(argv + ["--student", "full", "--epochs", "2"]) == 0
    (d, c, t, out, kw), = seen
    assert (d, c, t, out) == (root, os.path.join(root, "captions_clean.csv"),
                              teacher, "saved_models")
    assert kw["student_variant"] == "full" and kw["num_epochs"] == 2
    assert torch.device(kw["device"]).type == "cpu"
    assert "Devices: [cpu]" in capsys.readouterr().out

    def broken(*a, **k):
        raise ValueError("no such data")
    monkeypatch.setattr(O, "train_student_with_kd_optimized", broken)
    assert RO.main(argv) == 1
    assert "no such data" in capsys.readouterr().err


def test_demo_launcher_exits(tmp_path, monkeypatch, capsys):
    """Missing artifacts exit 1; without streamlit it exits 1 with the
    one-shot CLI's command line; with it, streamlit serves the port's
    demo module on port 8501, this package on ``PYTHONPATH``."""
    monkeypatch.chdir(tmp_path)
    assert RA.main(["--device", "cpu"]) == 1
    assert "Missing artifacts" in capsys.readouterr().out
    os.makedirs("saved_models")
    for p in RA.REQUIRED:
        open(p, "w").close()
    monkeypatch.setattr(RA.importlib.util, "find_spec", lambda name: None)
    assert RA.main(["--device", "cpu"]) == 1
    assert RA.CLI_DEMO in capsys.readouterr().out
    runs = []
    monkeypatch.setattr(RA.importlib.util, "find_spec", lambda name: object())
    monkeypatch.setattr(RA.subprocess, "run",
                        lambda argv, env=None: runs.append((argv, env)))
    assert RA.main(["--device", "cpu"]) == 0
    (argv, env), = runs
    assert argv == [sys.executable, "-m", "streamlit", "run", APP.__file__,
                    "--server.port", "8501", "--", "--device", "cpu"]
    assert env["PYTHONPATH"].split(os.pathsep)[0] == RP.PACKAGE_PARENT


# ---------------------------------------------------------------------------
# The demo
# ---------------------------------------------------------------------------


@pytest.fixture()
def app(monkeypatch, tmp_path):
    """The demo module over a tiny random teacher checkpoint and its
    vocabulary, written by the port."""
    vocab = Vocabulary(freq_threshold=1)
    vocab.build_vocabulary(["a dog runs fast", "a cat sits still"])
    vocab.save(str(tmp_path / "vocab.json"))
    cfg = TeacherConfig(vocab_size=len(vocab), **TEACHER)
    save_checkpoint(str(tmp_path / "teacher.npz"), dict(
        model_state_dict=dict(params=teacher_init(0, cfg)),
        vocab_size=len(vocab), model_config=TEACHER))
    monkeypatch.setattr(APP, "DEFAULT_CKPT", str(tmp_path / "teacher.npz"))
    monkeypatch.setattr(APP, "DEFAULT_VOCAB", str(tmp_path / "vocab.json"))
    return APP


def _ppm(tmp_path, size=40):
    path = str(tmp_path / "image.ppm")
    write_ppm(path, np.random.default_rng(1).integers(
        0, 256, (size, size + 8, 3), dtype=np.uint8))
    return path


def _student_checkpoint(tmp_path, vocab_size):
    cfg = compact_student_config(vocab_size, embed_size=16, hidden_size=16,
                                 dropout=0.0)
    p, s = student_init(1, cfg)
    path = str(tmp_path / "student.npz")
    save_checkpoint(path, dict(
        student_state_dict=dict(params=p, model_state=s),
        vocab_size=vocab_size,
        model_config=dict(embed_size=16, hidden_size=16, num_layers=1,
                          dropout=0.0, use_attention_refinement=False,
                          model_type="compact")))
    return path


def _run(st):
    sys.modules["streamlit"] = st
    try:
        with few_threads():
            APP.streamlit_main(device="cpu")
        return None
    except Rerun:
        return "rerun"
    finally:
        sys.modules.pop("streamlit", None)


def test_demo_caption_at_temperature_one_is_the_beam_caption(app, tmp_path,
                                                             monkeypatch):
    """The teacher column at T=1.0 is the port's ``beam_search_teacher``
    caption of the image as the demo reads it (a PPM read and resized by
    numpy, with PIL made unimportable); with a real student checkpoint
    the student column is that student's, and its T=1.0 caption is its
    greedy decode."""
    path = _ppm(tmp_path)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with few_threads():
        out = app.demo_caption_image(path, checkpoint_path=app.DEFAULT_CKPT,
                                     vocab_path=app.DEFAULT_VOCAB,
                                     device="cpu")
    teacher, cfg = load_teacher(app.DEFAULT_CKPT, "cpu")
    vocab = Vocabulary.load(app.DEFAULT_VOCAB)
    from imagecaptioner_tpu_torch.data.dataset import (read_ppm,
                                                       resize_bilinear)
    u8 = resize_bilinear(read_ppm(path), 32, 32)
    with torch.inference_mode():
        memory = teacher.encode_image(T.normalize(torch.from_numpy(u8)[None]))
        seqs, scores, _ = D.beam_search_teacher(teacher, memory,
                                                max_length=25)
    want = D.beam_result_to_captions(seqs, scores, vocab, 1)
    assert out["teacher"] == (want[0] if want else "")
    assert isinstance(out["student"], str)

    s_ckpt = _student_checkpoint(tmp_path, len(vocab))
    with few_threads():
        out2 = app.demo_caption_image(path, checkpoint_path=app.DEFAULT_CKPT,
                                      vocab_path=app.DEFAULT_VOCAB,
                                      device="cpu", student_checkpoint=s_ckpt)
    assert out2["teacher"] == out["teacher"]
    student = load_student(s_ckpt, "cpu")
    image = app.preprocess_image(u8, 32)
    greedy = app.generate_caption_with_temperature(student, image, vocab,
                                                   max_length=6)
    with torch.inference_mode():
        _, refined = student[0].encode_image(image)
        toks = D.best_greedy_decode_student(student[0], refined, student[1],
                                            max_length=6)
    assert greedy == D.tokens_to_caption(toks[0].numpy(), vocab)
    assert any("compact student" in line
               for line in app._model_info_lines("student", student))


def test_one_shot_cli_and_the_hint_without_streamlit(app, tmp_path, capsys):
    path = _ppm(tmp_path)
    with few_threads():
        assert app.main([path, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Teacher (beam):" in out and "Student (T=1.1 sample):" in out
    assert app.main(["--device", "cpu"]) == 1          # no streamlit here
    assert "streamlit is not installed" in capsys.readouterr().out


def test_state_machine_full_flow(app, tmp_path, monkeypatch):
    """generate_both -> the teacher column generates and reruns -> the
    student column generates and reruns -> both results replayed -> Clear
    resets every key.  Each column generates for real (the teacher's beam
    search at T=1.0, its sampling at T=1.1, on the uploaded PNG through
    PIL); the caption shown is tagged with its temperature, so that an
    empty caption from random weights cannot stop the flow."""
    upload = str(tmp_path / "up.png")
    Image.fromarray(np.full((40, 40, 3), 128, np.uint8)).save(upload)
    real, made = app.generate_caption_with_temperature, []

    def tagged(model, img, vocab, temperature=1.0, **k):
        made.append(real(model, img, vocab, temperature=temperature, **k))
        return f"{made[-1]} [T={temperature}]"
    monkeypatch.setattr(app, "generate_caption_with_temperature", tagged)

    st = FakeSt(uploaded=upload, clicks={"🔮 Generate Captions"})
    assert _run(st) == "rerun"
    assert st.session_state["generate_both"] is True
    assert st.session_state["teacher_done"] is False
    st2 = FakeSt(uploaded=upload)
    st2.session_state = SessionState(st.session_state)
    assert _run(st2) == "rerun"
    assert st2.session_state["teacher_done"] is True
    assert st2.session_state["teacher_caption_result"].endswith("[T=1.0]")
    st3 = FakeSt(uploaded=upload)
    st3.session_state = SessionState(st2.session_state)
    assert _run(st3) == "rerun"
    assert st3.session_state["student_done"] is True
    assert st3.session_state["student_caption_result"].endswith("[T=1.1]")
    assert len(made) == 2 and all(isinstance(c, str) for c in made)
    st4 = FakeSt(uploaded=upload)
    st4.session_state = SessionState(st3.session_state)
    assert _run(st4) is None and len(made) == 2
    shown = " ".join(str(a) for name, a in st4.calls if name == "markdown")
    assert "[T=1.0]" in shown and "[T=1.1]" in shown
    assert any(name == "success" and "cpu" in str(a)
               for name, a in st4.calls)
    st5 = FakeSt(uploaded=upload, clicks={"🗑️ Clear Image"})
    st5.session_state = SessionState(st4.session_state)
    assert _run(st5) == "rerun"
    for key in ("generate_both", "teacher_done", "student_done",
                "teacher_caption_result", "student_caption_result"):
        assert key not in st5.session_state


def test_no_models_shows_error(app, monkeypatch):
    monkeypatch.setattr(app, "DEFAULT_CKPT", "/nonexistent.npz")
    st = FakeSt()
    assert _run(st) is None
    assert any(name == "error" for name, _ in st.calls)


def test_runners_default_to_the_card(dataset_dir, monkeypatch):
    """Every runner takes ``--device``, default ``cuda``: without a card
    each raises before it touches a file."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    root, teacher = dataset_dir
    calls = _record_runs(monkeypatch, [])
    for main in (RP.main, RO.main, RA.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--data-root", root] if main is not RA.main else [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        APP.main([_ppm_dir(root)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        APP.load_models_and_vocab(teacher, "v.json")
    assert calls == []


def _ppm_dir(root):
    path = os.path.join(root, "Images", "a.ppm")
    write_ppm(path, np.zeros((8, 8, 3), np.uint8))
    return path
