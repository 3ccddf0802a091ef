"""The whole ported slice against the JAX full student: parameter
conversion, encoder features, one decoder step, captions, checkpoints and
the serve path, at float32 on the CPU with small widths (V=50, E=16, H=24,
64x64 images; ResNet-50's channel widths are fixed, so the images shrink
instead)."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core.config import full_student_config
from imagecaptioner_tpu.data import transforms as JT
from imagecaptioner_tpu.models import student as SM
from imagecaptioner_tpu.ops import decode as JD
from imagecaptioner_tpu.utils import checkpoint as JCKPT
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.ops import attention as A
from imagecaptioner_tpu_torch.ops import greedy as G
from imagecaptioner_tpu_torch.ops.decode import best_greedy_decode_student
from imagecaptioner_tpu_torch.utils import checkpoint as PCKPT
from imagecaptioner_tpu_torch.utils.convert import jax_student_to_state_dict

REPO = Path(__file__).resolve().parent.parent
V, E, H, B, T = 50, 16, 24, 2, 8
MODEL_CONFIG = dict(embed_size=E, hidden_size=H, num_layers=2, dropout=0.2,
                    use_attention_refinement=True, model_type="full")


@pytest.fixture(scope="module")
def jax_student():
    cfg = full_student_config(V, embed_size=E, hidden_size=H)
    p, s = SM.student_init(jax.random.PRNGKey(0), cfg)
    return cfg, jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, s)


@pytest.fixture(scope="module")
def port_student(jax_student):
    cfg, p, s = jax_student
    pcfg = PC.full_student_config(V, embed_size=E, hidden_size=H)
    model = Student(pcfg)
    model.load_state_dict(jax_student_to_state_dict(p, s, pcfg), strict=True)
    return pcfg, model.eval()


@pytest.fixture(scope="module")
def images_u8():
    return np.random.default_rng(7).integers(0, 256, (B, 64, 64, 3),
                                             dtype=np.uint8)


def _jax_captions(cfg, p, s, images_u8):
    imgs = JT.normalize(jnp.asarray(images_u8))
    raw, refined, _ = jax.jit(lambda *a: SM.encode_image(*a, cfg))(p, s, imgs)
    toks = JD.best_greedy_decode_student(p, refined, cfg, max_length=T)
    return raw, refined, np.asarray(toks)


def test_normalize_matches_jax(images_u8):
    ref = JT.normalize(jnp.asarray(images_u8))
    got = PT.normalize(torch.from_numpy(images_u8))
    assert got.shape == (B, 3, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_features_and_captions_match_jax(jax_student, port_student, images_u8):
    cfg, p, s = jax_student
    pcfg, model = port_student
    raw, refined, toks = _jax_captions(cfg, p, s, images_u8)
    with torch.inference_mode():
        x = PT.normalize(torch.from_numpy(images_u8))
        p_raw, p_ref = model.encode_image(x)
        p_toks = best_greedy_decode_student(model, p_ref, pcfg, max_length=T)
    assert p_raw.shape == (B, 49, E)
    np.testing.assert_allclose(p_raw.numpy(), np.asarray(raw), atol=1e-4)
    np.testing.assert_allclose(p_ref.numpy(), np.asarray(refined), atol=1e-4)
    np.testing.assert_array_equal(p_toks.numpy(), toks)
    assert A.launches == 0 and G.launches == 0


def test_decoder_step_matches_jax(jax_student, port_student):
    cfg, p, _ = jax_student
    _, model = port_student
    rng = np.random.default_rng(3)
    emb = rng.standard_normal((B, E)).astype(np.float32)
    h, c = (rng.standard_normal((2, B, H)).astype(np.float32) * 0.5
            for _ in range(2))
    feats = rng.standard_normal((B, 49, E)).astype(np.float32)
    ref_logits, (ref_h, ref_c), ref_attn = SM.decoder_step(
        p, jnp.asarray(emb), (jnp.asarray(h), jnp.asarray(c)),
        jnp.asarray(feats), cfg)
    with torch.inference_mode():
        logits, (h2, c2), attn = model.decoder_step(
            torch.from_numpy(emb), (torch.from_numpy(h), torch.from_numpy(c)),
            torch.from_numpy(feats))
    for got, ref in ((logits, ref_logits), (h2, ref_h), (c2, ref_c),
                     (attn, ref_attn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_numpy_init_has_the_jax_tree_layout(jax_student):
    _, p, s = jax_student
    pcfg = PC.full_student_config(V, embed_size=E, hidden_size=H)
    p2, s2 = student_init(0, pcfg)
    shapes = lambda t: jax.tree.map(np.shape, t)  # noqa: E731
    assert jax.tree.structure(p2) == jax.tree.structure(p)
    assert shapes(p2) == shapes(p) and shapes(s2) == shapes(s)
    sd = jax_student_to_state_dict(p2, s2, pcfg)
    Student(pcfg).load_state_dict(sd, strict=True)
    assert "encoder.resnet.layer1.0.downsample.bn.running_var" in sd
    assert "decoder.lstm.1.weight_hh" in sd


def test_jax_checkpoint_serves_through_the_port(jax_student, images_u8,
                                                tmp_path):
    cfg, p, s = jax_student
    path = str(tmp_path / "student.npz")
    JCKPT.save_checkpoint(path, {
        "student_state_dict": {"params": p, "model_state": s},
        "vocab_size": V, "model_config": MODEL_CONFIG, "epoch": 3})
    model, pcfg = serve.load_student(path, "cpu")
    assert pcfg == PC.full_student_config(V, embed_size=E, hidden_size=H)
    caption = serve.make_greedy_captioner(model, pcfg, "cpu", max_length=T)
    _, _, toks = _jax_captions(cfg, p, s, images_u8)
    np.testing.assert_array_equal(caption(images_u8), toks)


def test_port_checkpoint_reads_back_in_jax(tmp_path):
    tree = {"student_state_dict": {"params": {"w": np.arange(6.0).reshape(2, 3),
                                              "lst": [np.ones(2), None]}},
            "vocab_size": 7, "name": "x", "flag": True, "lr": 0.5,
            "pair": (1, 2)}
    path = str(tmp_path / "c.npz")
    PCKPT.save_checkpoint(path, tree)
    back = JCKPT.load_checkpoint(path)
    again = PCKPT.load_checkpoint(path)
    for t in (back, again):
        np.testing.assert_array_equal(t["student_state_dict"]["params"]["w"],
                                      tree["student_state_dict"]["params"]["w"])
        assert t["student_state_dict"]["params"]["lst"][1] is None
        assert (t["vocab_size"], t["name"], t["flag"], t["lr"], t["pair"]) == \
            (7, "x", True, 0.5, (1, 2))


def test_unported_variants_and_flags_raise(tmp_path, monkeypatch, capsys):
    """All three variants build; what no kernel takes raises: a layer count
    other than the variant's, an unknown variant or ``model_type``; the
    int8 flags (ported) exit with the JAX CLI's two parse errors where they
    do not apply; data parallelism over several cards needs a ``--batch``
    that divides by them, as the JAX CLI's mesh does."""
    for variant, layers in (("full", 2), ("compact", 1), ("enhanced", 3)):
        cfg = PC.STUDENT_CONFIGS[variant](V, embed_size=E, hidden_size=H)
        assert cfg.variant == variant and cfg.num_layers == layers
        assert Student(cfg).cfg is cfg
        with pytest.raises(NotImplementedError, match="LSTM layers"):
            Student(PC.replace(cfg, num_layers=layers + 1))
    with pytest.raises(ValueError, match="unknown student variant"):
        Student(PC.StudentConfig(variant="tiny"))
    path = str(tmp_path / "c.npz")
    PCKPT.save_checkpoint(path, {
        "student_state_dict": {"params": {}, "model_state": {}},
        "vocab_size": 5, "model_config": {"model_type": "enhanced"}})
    _, cfg, _ = PCKPT.load_student_checkpoint(path)
    assert cfg == PC.enhanced_student_config(5)
    PCKPT.save_checkpoint(path, {"student_state_dict": {}, "vocab_size": 5,
                                 "model_config": {"model_type": "tiny"}})
    with pytest.raises(ValueError, match="unknown student model_type"):
        PCKPT.load_student_checkpoint(path)
    base = ["--checkpoint", "c", "--vocab", "v", "--images", "i"]
    for extra, msg in (
            (["--model", "student", "--int8-full", "--device", "cpu"],
             "--int8-full applies to the teacher's transformer decoder"),
            (["--model", "teacher", "--int8-calibrate", "2", "--device",
              "cpu"], "--int8-calibrate requires --int8 or --int8-full")):
        with pytest.raises(SystemExit) as e:
            serve.main(base + extra)
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert msg in err
    # data parallelism is a no-op on one device and splits each batch over
    # several, which --batch must divide
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(SystemExit, match=r"--batch 3 must divide by the "
                       r"mesh data axis \(2\)"):
        serve.main(base + ["--model", "student", "--data-parallel",
                           "--batch", "3"])


def test_serve_cli_end_to_end(jax_student, tmp_path):
    """The CLI on two PNG files (PIL is available here, not on the card)."""
    from PIL import Image

    from imagecaptioner_tpu.data.vocabulary import Vocabulary as JVocabulary

    cfg, p, s = jax_student
    ckpt = str(tmp_path / "student.npz")
    JCKPT.save_checkpoint(ckpt, {
        "student_state_dict": {"params": p, "model_state": s},
        "vocab_size": V, "model_config": MODEL_CONFIG})
    vocab = JVocabulary(freq_threshold=1)
    vocab.build_vocabulary([" ".join(f"w{i}" for i in range(V - 4))])
    vocab.save(str(tmp_path / "vocab.json"))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    rng = np.random.default_rng(1)
    for name in ("a.png", "b.png", "c.png"):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)
                        ).save(img_dir / name)
    out = tmp_path / "captions.jsonl"
    rc = serve.main(["--model", "student", "--checkpoint", ckpt, "--vocab",
                     str(tmp_path / "vocab.json"), "--images", str(img_dir),
                     "--out", str(out), "--batch", "2", "--max-length", "5",
                     "--device", "cpu"])
    lines = out.read_text().splitlines()
    assert rc == 0 and len(lines) == 3
    words = set(vocab.itos.values())
    assert all(w in words for line in lines
               for w in json.loads(line)["caption"].split())
    # one device: --data-parallel serves exactly as without it
    dp = tmp_path / "dp.jsonl"
    assert serve.main(["--model", "student", "--checkpoint", ckpt, "--vocab",
                       str(tmp_path / "vocab.json"), "--images", str(img_dir),
                       "--out", str(dp), "--batch", "2", "--max-length", "5",
                       "--device", "cpu", "--data-parallel"]) == 0
    assert dp.read_text() == out.read_text()


def test_serve_cli_default_device_raises_without_a_card(tmp_path):
    """The CLI defaults to the card and never picks the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = tmp_path / "captions.jsonl"
    with pytest.raises((SystemExit, RuntimeError), match="no CUDA device"):
        serve.main(["--model", "student", "--checkpoint", "c", "--vocab", "v",
                    "--images", "i", "--out", str(out)])
    assert not out.exists()


def test_student_forward_matches_jax_student_apply(jax_student, port_student,
                                                   images_u8):
    """``Student.forward`` in eval mode against ``student_apply``: the
    4-tuple with the unrefined feature tap (atol 1e-4 as for the features
    above)."""
    cfg, p, s = jax_student
    _, model = port_student
    caps = np.random.default_rng(9).integers(0, V, (T, B)).astype(np.int32)
    imgs = JT.normalize(jnp.asarray(images_u8))
    (logits, raw, hid, attn), _ = jax.jit(
        lambda *a: SM.student_apply(*a, cfg))(p, s, imgs, jnp.asarray(caps))
    with torch.inference_mode():
        got = model(PT.normalize(torch.from_numpy(images_u8)),
                    torch.from_numpy(caps).long())
    for g, r in zip(got, (logits, raw, hid, attn)):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4)
    _, refined = model.encode_image(PT.normalize(torch.from_numpy(images_u8)))
    assert not torch.equal(refined, got[1])         # the tap is unrefined


def test_trainable_mask_matches_jax(jax_student, port_student):
    from imagecaptioner_tpu_torch.models.student import student_trainable_mask
    from imagecaptioner_tpu_torch.utils.convert import tree_to_state_dict
    cfg, p, _ = jax_student
    pcfg, model = port_student
    ref = tree_to_state_dict(jax.tree.map(
        lambda b: np.float32(b), SM.student_trainable_mask(p, cfg)))
    got = student_trainable_mask(model, pcfg)
    assert {k: bool(v) for k, v in ref.items()} == got
    assert not got["encoder.resnet.layer2.3.bn3.weight"]
    assert got["encoder.resnet.layer3.0.conv1.weight"]
    assert all(student_trainable_mask(
        model, PC.full_student_config(V, freeze_backbone=False)).values())


def test_port_imports_no_jax():
    subprocess.run(
        [sys.executable, "-c",
         "import imagecaptioner_tpu_torch.eval.serve, sys; "
         "import imagecaptioner_tpu_torch.train.train_student_kd; "
         "assert 'jax' not in sys.modules; "
         "assert 'imagecaptioner_tpu' not in sys.modules"],
        check=True, timeout=120, cwd=REPO)
