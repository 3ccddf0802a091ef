"""The KD trainer of the port end to end on the CPU at tiny widths: the
in-memory grid data, a handful of optimizer steps, the checkpoint and
history it writes, the options that are not ported yet and the device rule.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.data.synthetic import make_synthetic_dataset
from imagecaptioner_tpu.data.vocabulary import Vocabulary as JVocabulary
from imagecaptioner_tpu.utils import checkpoint as JCKPT
from imagecaptioner_tpu_torch.core.config import KDTrainConfig, TeacherConfig
from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.data import synthetic as PSY
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.models.teacher import teacher_init
from imagecaptioner_tpu_torch.train import common, train_student_kd as TK
from imagecaptioner_tpu_torch.utils.checkpoint import save_checkpoint

S, MAXLEN = 64, 12
TEACHER = dict(embed_size=32, num_heads=2, num_decoder_layers=1, dropout=0.1,
               encoder_dim=32, encoder_depth=1, encoder_heads=2,
               patch_size=16, image_size=S)


@pytest.fixture(scope="module")
def grid():
    return PSY.make_grid_loaders(32, image_size=S, seed=0, batch_size=4,
                                 max_caption_len=MAXLEN, freq_threshold=1)


@pytest.fixture(scope="module")
def teacher_ckpt(grid, tmp_path_factory):
    _, _, vocab = grid
    path = str(tmp_path_factory.mktemp("teacher") / "teacher.npz")
    cfg = TeacherConfig(vocab_size=len(vocab), **TEACHER)
    save_checkpoint(path, {"model_state_dict": {"params": teacher_init(0, cfg)},
                           "vocab_size": len(vocab), "model_config": TEACHER})
    return path


@pytest.fixture(scope="module")
def trained(grid, teacher_ckpt, tmp_path_factory):
    train_loader, val_loader, vocab = grid
    out = str(tmp_path_factory.mktemp("kd_out"))
    state, s_cfg, _ = TK.train_student_with_kd(
        train_loader, val_loader, vocab, teacher_ckpt, out, num_epochs=3,
        train_cfg=KDTrainConfig(learning_rate=1e-3, validate_every=2),
        compute_dtype=torch.float32, seed=0, device="cpu", verbose=False,
        student_cfg_overrides=dict(embed_size=32, hidden_size=32))
    return out, state, s_cfg


def test_grid_captions_and_vocabulary_match_the_jax_generator(tmp_path):
    """One seed gives the captions the JAX package writes to its CSV, and
    the same vocabulary; the pixels are the ones it stores as JPEG (lossy,
    so compared to a mean absolute error of 6 grey levels)."""
    csv = make_synthetic_dataset(str(tmp_path), n_images=12, image_size=S,
                                 seed=3, learnable=True, task="grid")
    rows = [line.split(",", 1)[1] for line in
            open(csv).read().splitlines()[1:]]
    images, captions = PSY.make_grid_dataset(12, image_size=S, seed=3)
    assert captions == rows
    jv, pv = JVocabulary(2), PSY.Vocabulary(2)
    jv.build_vocabulary(rows)
    pv.build_vocabulary(captions)
    assert pv.itos == jv.itos and len(pv) > 8
    assert pv.encode_caption(captions[0]) == jv.encode_caption(rows[0])
    from PIL import Image
    jpg = np.asarray(Image.open(os.path.join(str(tmp_path), "Images",
                                             "img_0005.jpg")).convert("RGB"))
    assert images.dtype == np.uint8 and images.shape == (12, S, S, 3)
    assert np.abs(jpg.astype(np.float32) - images[5]).mean() < 6.0


def test_grid_loader_layout(grid):
    train_loader, val_loader, vocab = grid
    assert len(train_loader) == 8 and train_loader.batch_size == 4
    b = next(iter(val_loader))
    assert b["images"].shape == (4, S, S, 3) and b["images"].dtype == np.uint8
    assert b["captions"].shape == (MAXLEN, 4) and b["captions"].dtype == np.int32
    assert (b["captions"][0] == 1).all()
    for j, n in enumerate(b["lengths"]):
        assert b["captions"][n - 1, j] == 2 and (b["captions"][n:, j] == 0).all()
    stacks = list(common.stacked_batches(train_loader, 3))
    assert len(stacks) == 2 and stacks[0]["images"].shape == (3, 4, S, S, 3)
    assert stacks[0]["captions"].shape == (3, MAXLEN, 4)
    big = PSY.GridLoader(np.zeros((40, 8, 8, 3), np.uint8), ["red dot"] * 40,
                         vocab, batch_size=32)
    assert big.batch_size == 16          # the reference's silent cap


def test_loss_falls_and_history_is_written(trained):
    out, state, _ = trained
    hist = json.load(open(os.path.join(out, "student_training_history.json")))
    assert len(hist["train_losses"]) == 3 and len(hist["val_losses"]) == 2
    assert all(np.isfinite(hist["train_losses"]))
    assert hist["train_losses"][-1] < hist["train_losses"][0]
    assert set(hist["loss_components"]) == set(common.LOSS_NAMES)
    assert hist["hyperparameters"]["alpha"] == 0.7
    assert state.opt_state.step == 3 * 4      # 8 batches / accumulation 2
    assert os.path.exists(os.path.join(out, "vocab.json"))


def test_checkpoint_reads_in_jax_and_serves_through_the_port(trained, grid):
    out, state, s_cfg = trained
    _, val_loader, vocab = grid
    for name in ("best_student_model.npz", "final_student_model.npz"):
        ck = JCKPT.load_checkpoint(os.path.join(out, name))
        assert {"epoch", "student_state_dict", "projectors_state_dict",
                "optimizer_state_dict", "scheduler_state_dict", "vocab_size",
                "model_config", "distillation_config"} <= set(ck)
        assert ck["vocab_size"] == len(vocab)
        assert ck["model_config"]["model_type"] == "full"
    assert int(ck["optimizer_state_dict"]["step"]) == 12
    params = ck["student_state_dict"]["params"]
    mu = ck["optimizer_state_dict"]["mu"]
    assert jax.tree.structure(mu["student"]) == jax.tree.structure(params)
    assert "downsample_bn" in ck["student_state_dict"]["model_state"][
        "resnet"]["layer1"][0]
    w = state.student.decoder.lstm[1].weight_hh.detach().numpy()
    np.testing.assert_array_equal(params["decoder"]["lstm"][1]["weight_hh"], w)
    assert ck["train_losses"] and "loss_components" in ck
    # the JAX package builds its student from this file's config and params
    from imagecaptioner_tpu.core.config import full_student_config as j_full
    from imagecaptioner_tpu.models import student as JSM
    mc = dict(ck["model_config"])
    mc.pop("model_type")
    jcfg = j_full(ck["vocab_size"], **mc)
    init_p, init_s = JSM.student_init(jax.random.PRNGKey(0), jcfg)
    assert jax.tree.map(np.shape, init_p) == jax.tree.map(np.shape, params)
    assert jax.tree.map(np.shape, init_s) == jax.tree.map(
        np.shape, ck["student_state_dict"]["model_state"])
    # and the port serves it
    model, cfg = serve.load_student(os.path.join(out, "final_student_model.npz"),
                                    "cpu")
    assert cfg == s_cfg
    toks = serve.make_greedy_captioner(model, cfg, "cpu", max_length=6)(
        next(iter(val_loader))["images"])
    assert toks.shape == (4, 6) and toks.max() < len(vocab)


@pytest.mark.parametrize("kw,match", [
    (dict(resume_from="x.npz"), "item 4"),
    (dict(data_parallel=True), "item 13"),
    (dict(device_dataset=True), "item 11"),
    (dict(metrics_jsonl="m.jsonl"), "item 14"),
    (dict(student_variant="compact"), "items 7"),
])
def test_unported_options_exit_with_their_roadmap_item(grid, kw, match):
    train_loader, val_loader, vocab = grid
    with pytest.raises(SystemExit, match="not ported yet") as e:
        TK.train_student_with_kd(train_loader, val_loader, vocab, "t.npz",
                                 "out", device="cpu", **kw)
    assert match in str(e.value)


def test_cli_arguments(tmp_path):
    with pytest.raises(SystemExit, match="not ported yet"):
        TK.main(["--data-root", "data/flickr8k", "--device", "cpu"])
    with pytest.raises(SystemExit, match="synthetic-grid"):
        TK.main(["--device", "cpu"])


def test_default_device_without_a_card_raises(grid, teacher_ckpt, tmp_path):
    """Every entry point runs on the card unless the caller asks for the
    CPU; without a card the default raises instead of carrying on."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    train_loader, val_loader, vocab = grid
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    out = tmp_path / "out"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TK.train_student_with_kd(train_loader, val_loader, vocab,
                                 teacher_ckpt, str(out), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TK.main(["--synthetic-grid", "8", "--output-dir", str(out)])
    assert not out.exists()
