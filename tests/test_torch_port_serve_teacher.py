"""The port's teacher serving (``eval/serve.py --model teacher``) against the
JAX CLI on one tiny teacher checkpoint written in the JAX format: E=32, 4
heads, 2 decoder layers, 32x32 PNG files, K=3, float32 on the CPU.

The teacher is sharpened as in ``test_torch_port_teacher_decode.py`` (the
images matter, END is likely), so the captions differ between images and end
at different lengths: equal JSONL is then a real check."""

import json

import jax
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core.config import TeacherConfig as JTeacherConfig
from imagecaptioner_tpu.data.vocabulary import Vocabulary as JVocabulary
from imagecaptioner_tpu.eval import serve as jserve
from imagecaptioner_tpu.models import teacher as JTM
from imagecaptioner_tpu.utils import checkpoint as JCKPT
from imagecaptioner_tpu_torch.core.config import TeacherConfig
from imagecaptioner_tpu_torch.data.vocabulary import END
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.train import train_student_kd as TK

KW = dict(embed_size=32, num_heads=4, num_decoder_layers=2, dropout=0.0,
          encoder_dim=24, encoder_depth=2, encoder_heads=3, patch_size=16,
          image_size=32)
V, T, K = 40, 8, 3


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("serve_teacher")
    vocab = JVocabulary(freq_threshold=1)
    vocab.build_vocabulary([" ".join(f"w{i}" for i in range(V - 4))])
    vocab.save(str(root / "vocab.json"))
    p = jax.tree.map(lambda a: np.array(a, copy=True), JTM.teacher_init(
        jax.random.PRNGKey(0), JTeacherConfig(vocab_size=V, **KW)))
    for layer in p["decoder"]:
        layer["multihead_attn"]["out_proj"]["weight"] *= 16.0
        layer["multihead_attn"]["in_proj_weight"] *= 2.0
    p["fc_out"]["bias"][END] += 2.0
    JCKPT.save_checkpoint(str(root / "teacher.npz"), dict(
        model_state_dict=dict(params=p, model_state={}), vocab_size=V,
        model_config=KW))
    (root / "imgs").mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):   # batch 4 leaves a trailing partial batch
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
                        ).save(root / "imgs" / f"im{i}.png")
    return root


def _args(root, out, *extra):
    return ["--model", "teacher", "--checkpoint", str(root / "teacher.npz"),
            "--vocab", str(root / "vocab.json"), "--images",
            str(root / "imgs"), "--out", str(out), "--batch", "4",
            "--max-length", str(T), "--beam-size", str(K), *extra]


def test_teacher_cli_writes_the_jax_cli_captions(artifacts):
    ref, got = artifacts / "jax.jsonl", artifacts / "port.jsonl"
    assert jserve.main(_args(artifacts, ref)) == 0
    assert serve.main(_args(artifacts, got, "--device", "cpu")) == 0
    rows = [json.loads(line) for line in got.read_text().splitlines()]
    assert rows == [json.loads(line) for line in ref.read_text().splitlines()]
    assert [r["image"] for r in rows] == [f"im{i}.png" for i in range(5)]
    captions = [r["caption"] for r in rows]
    # power: the images give different captions of different lengths
    assert len(set(captions)) >= 3
    assert len({len(c.split()) for c in captions}) >= 2


def test_teacher_cli_default_device_raises_without_a_card(artifacts):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = artifacts / "none.jsonl"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(_args(artifacts, out))
    assert not out.exists()


@pytest.mark.parametrize("extra", [["--int8"], ["--int8-full"],
                                   ["--int8", "--int8-calibrate", "2"],
                                   ["--data-parallel"]])
def test_unported_teacher_flags_exit(artifacts, extra, monkeypatch):
    """Data parallelism with more than one card visible splits each batch
    over the cards, and a ``--batch`` that does not divide by them exits
    with the JAX CLI's message before any card is used (on one device it is
    a no-op).  The int8 flags are ported:
    with each, the port's CLI writes the JAX CLI's captions (the encoder
    quantized, or encoder and decoder, dynamically or with static scales
    calibrated on the first two images)."""
    if extra == ["--data-parallel"]:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        args = _args(artifacts, artifacts / "x.jsonl", *extra) + [
            "--batch", "3"]
        with pytest.raises(SystemExit, match="must divide") as e:
            serve.main(args)
        assert "mesh data axis (2)" in str(e.value)
        assert not (artifacts / "x.jsonl").exists()
        return
    tag = "_".join(a.strip("-") for a in extra)
    ref, got = artifacts / f"jax_{tag}.jsonl", artifacts / f"port_{tag}.jsonl"
    assert jserve.main(_args(artifacts, ref, *extra)) == 0
    assert serve.main(_args(artifacts, got, "--device", "cpu", *extra)) == 0
    rows = [json.loads(line) for line in got.read_text().splitlines()]
    assert len(rows) == 5
    assert rows == [json.loads(line) for line in ref.read_text().splitlines()]


def test_data_parallel_is_a_no_op_on_one_device(artifacts):
    """On the CPU (one device) ``--data-parallel`` serves exactly as
    without it, as the reference does on one device."""
    plain, dp = artifacts / "plain.jsonl", artifacts / "dp.jsonl"
    assert serve.main(_args(artifacts, plain, "--device", "cpu")) == 0
    assert serve.main(_args(artifacts, dp, "--device", "cpu",
                            "--data-parallel")) == 0
    assert dp.read_text() == plain.read_text()
    assert len(plain.read_text().splitlines()) == 5


def test_load_teacher_and_beam_captioner_contract(artifacts):
    """The loader takes the vocabulary size and architecture from the
    checkpoint; the captioner maps uint8 arrays to numpy (seqs, scores,
    lens) in the parameters' dtype; the KD trainer's loader is the same
    code plus its vocabulary check."""
    teacher, cfg = serve.load_teacher(str(artifacts / "teacher.npz"), "cpu")
    assert cfg == TeacherConfig(vocab_size=V, **KW) and not teacher.training
    assert next(teacher.parameters()).dtype == torch.float32
    images = np.random.default_rng(3).integers(0, 256, (2, 32, 32, 3),
                                               dtype=np.uint8)
    seqs, scores, lens = serve.make_beam_captioner(
        teacher, cfg, "cpu", max_length=T, beam_size=K)(images)
    assert seqs.shape == (2, K, T + 1) and seqs.dtype == np.int32
    assert scores.shape == (2, K) and scores.dtype == np.float32
    assert lens.shape == (2, K) and lens.dtype == np.int32
    fin = np.isfinite(scores)
    assert fin[:, 0].all() and (np.diff(np.where(fin, scores, -1e30)) <= 0).all()
    half, _ = serve.load_teacher(str(artifacts / "teacher.npz"), "cpu",
                                 torch.bfloat16)
    assert next(half.parameters()).dtype == torch.bfloat16
    assert half.pe.dtype == torch.float32
    s16, sc16, _ = serve.make_beam_captioner(half, cfg, "cpu", max_length=T,
                                             beam_size=K)(images)
    assert s16.shape == seqs.shape and np.isfinite(sc16[:, 0]).all()
    same, same_cfg = TK.load_teacher(str(artifacts / "teacher.npz"), V, "cpu")
    assert same_cfg == cfg
    for (n1, a), (n2, b) in zip(teacher.state_dict().items(),
                                same.state_dict().items()):
        assert n1 == n2 and torch.equal(a, b)
    with pytest.raises(ValueError, match="vocabulary"):
        TK.load_teacher(str(artifacts / "teacher.npz"), V + 1, "cpu")
