"""The KD trainer of the port end to end on the CPU at tiny widths: the
in-memory grid data and a CSV/JPEG dataset on disk, a handful of optimizer
steps, the checkpoint, history and per-step log it writes, resuming from a
checkpoint of either package, the options that are not ported yet and the
device rule.
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
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core.config import KDTrainConfig, TeacherConfig
from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.data import synthetic as PSY
from imagecaptioner_tpu_torch.data.dataset import CaptionDataset
from imagecaptioner_tpu_torch.data.loader import BatchLoader
from imagecaptioner_tpu_torch.distill.projector import \
    create_feature_projectors
from imagecaptioner_tpu_torch.eval import serve
from imagecaptioner_tpu_torch.models.student import student_init
from imagecaptioner_tpu_torch.models.teacher import teacher_init
from imagecaptioner_tpu_torch.train import common, train_student_kd as TK
from imagecaptioner_tpu_torch.utils import convert as CV
from imagecaptioner_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_port_compact import few_threads

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
    # two intra-op threads: with a thread per core in each of the suite's
    # workers the machine is oversubscribed and this run takes minutes
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        state, s_cfg, _ = TK.train_student_with_kd_on_loaders(
            train_loader, val_loader, vocab, teacher_ckpt, out, num_epochs=3,
            train_cfg=KDTrainConfig(learning_rate=1e-3, validate_every=2),
            compute_dtype=torch.float32, seed=0, device="cpu", verbose=False,
            student_cfg_overrides=dict(embed_size=32, hidden_size=32),
            data_parallel=True)  # the default: a no-op on one device
    finally:
        torch.set_num_threads(threads)
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
    big = BatchLoader(PSY.GridDataset(np.zeros((40, 8, 8, 3), np.uint8),
                                      ["red dot"] * 40, vocab), batch_size=32)
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
    init_p, init_s = jax.eval_shape(lambda k: JSM.student_init(k, jcfg),
                                    jax.random.PRNGKey(0))  # layout only
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
    (dict(data_parallel=True, device="cuda"), "one process per card: 2"),
    # a CPU run has one device: past data parallelism to the next check;
    # the device-resident dataset is accepted and the trainer goes on to
    # read its data (a missing CSV or teacher checkpoint here)
    pytest.param(dict(data_parallel=True, device_dataset=True), "No such file",
                 id="kw1-item 11"),
    pytest.param(dict(device_dataset=True), "No such file", id="kw2-item 11"),
    (dict(student_variant="tiny"), "unknown student_variant"),
])
def test_unported_options_exit_with_their_roadmap_item(grid, kw, match,
                                                      monkeypatch):
    """The three student variants are all ported, and an unknown one
    raises.  Data parallelism is on by default and a no-op on one device,
    as the reference's ``maybe_mesh`` makes it: on the card with two cards
    visible both entry points start one process per card
    (``common.run_per_card``, recorded here) before any data or card is
    used.  ``device_dataset`` is ported: it passes the checks, and the
    trainers go on to read the teacher checkpoint or the CSV."""
    train_loader, val_loader, vocab = grid
    if "data_parallel" in kw:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)

        def per_card(fn, n, kwargs):
            assert fn in (TK.train_student_with_kd,
                          TK.train_student_with_kd_on_loaders)
            assert kwargs["device"] == "cuda"
            raise SystemExit(f"one process per card: {n}")
        monkeypatch.setattr(common, "run_per_card", per_card)
    unknown = "student_variant" in kw
    accepted = "device_dataset" in kw
    err = (ValueError if unknown else FileNotFoundError if accepted
           else SystemExit)
    for train in (lambda **k: TK.train_student_with_kd_on_loaders(
                      train_loader, val_loader, vocab, "t.npz", "out", **k),
                  lambda **k: TK.train_student_with_kd("no/data", None,
                                                       "t.npz", "out", **k)):
        with pytest.raises(err, match=match) as e:
            train(**{"device": "cpu", **kw})      # before any data is read
        assert match in str(e.value)


def test_cli_arguments(tmp_path, monkeypatch):
    """``--data-root`` defaults to the reference's ``data/flickr8k`` and
    is read; ``--synthetic-grid N`` trains on the in-memory grid task."""
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError,
                       match="data/flickr8k/captions_clean.csv"):
        TK.main(["--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="elsewhere/c.csv"):
        TK.main(["--data-root", "x", "--captions-file", "elsewhere/c.csv",
                 "--device", "cpu"])
    with pytest.raises(FileNotFoundError, match="t.npz"):
        TK.main(["--synthetic-grid", "4", "--image-size", "32",
                 "--teacher-checkpoint", "t.npz", "--device", "cpu"])


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
        TK.train_student_with_kd_on_loaders(train_loader, val_loader, vocab,
                                            teacher_ckpt, str(out),
                                            verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TK.train_student_with_kd("no/data", None, teacher_ckpt, str(out))
    for data in (["--synthetic-grid", "8"], ["--data-root", "no/data"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TK.main(data + ["--output-dir", str(out)])
    assert not out.exists()


# ---------------------------------------------------------------------------
# Training from a CSV/JPEG dataset on disk, and resuming
# ---------------------------------------------------------------------------

SMALL = dict(embed_size=32, hidden_size=32)
RECORD_KEYS = {"t", "epoch", "step", "grad_norm", "lr", *common.LOSS_NAMES}


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """16 grid images with two caption rows each (two batches of 16, one
    optimizer step an epoch) as JPEGs and a CSV, and a tiny teacher over
    the vocabulary the trainer builds from it (threshold 5)."""
    root = tmp_path_factory.mktemp("disk")
    data = str(root / "data")
    PSY.make_synthetic_dataset(data, n_images=16, captions_per_image=2,
                               image_size=S, seed=0, learnable=True,
                               task="grid")
    V = len(CaptionDataset(data, os.path.join(data, "captions_clean.csv"))
            .vocab)
    t_path = str(root / "teacher.npz")
    cfg = TeacherConfig(vocab_size=V, **TEACHER)
    save_checkpoint(t_path, {"model_state_dict": {"params": teacher_init(0, cfg)},
                             "vocab_size": V, "model_config": TEACHER})
    return root, data, t_path, V


@pytest.fixture(scope="module")
def trained_from_disk(disk):
    root, data, t_path, _ = disk
    out = str(root / "out")
    with few_threads():
        state, s_cfg, vocab = TK.train_student_with_kd(
            data, None, t_path, out, image_size=S, max_caption_len=MAXLEN,
            compute_dtype=torch.float32, device="cpu", verbose=False,
            metrics_jsonl=os.path.join(out, "metrics.jsonl"),
            student_cfg_overrides=SMALL)
    return out, state, s_cfg, vocab


def _records(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


def test_trainer_from_disk_writes_checkpoints_history_and_metrics(
        trained_from_disk, disk):
    out, state, s_cfg, vocab = trained_from_disk
    _, data, _, V = disk
    assert len(vocab) == V and s_cfg.embed_size == 32
    assert state.opt_state.step == 1             # 2 batches / accumulation 2
    for name in ("best_student_model.npz", "final_student_model.npz",
                 "vocab.json", "student_training_history.json"):
        assert os.path.exists(os.path.join(out, name))
    hist = json.load(open(os.path.join(out, "student_training_history.json")))
    assert len(hist["train_losses"]) == len(hist["val_losses"]) == 1
    assert np.isfinite(hist["train_losses"] + hist["val_losses"]).all()
    recs = _records(os.path.join(out, "metrics.jsonl"))
    assert len(recs) == 1 and set(recs[0]) == RECORD_KEYS
    assert recs[0]["epoch"] == 0 and recs[0]["step"] == 0
    assert recs[0]["total_loss"] == pytest.approx(hist["train_losses"][0])
    assert JCKPT.load_checkpoint(os.path.join(out, "best_student_model.npz"))[
        "epoch"] == 0


def test_cli_trains_from_disk(disk, tmp_path):
    """The CLI at the full student's width on the 64x64 disk data."""
    _, data, t_path, _ = disk
    out = tmp_path / "cli"
    with few_threads():
        assert TK.main(["--data-root", data, "--teacher-checkpoint", t_path,
                        "--output-dir", str(out), "--image-size", str(S),
                        "--metrics-jsonl", str(out / "m.jsonl"),
                        "--device", "cpu"]) == 0
    ck = JCKPT.load_checkpoint(str(out / "final_student_model.npz"))
    assert ck["model_config"]["embed_size"] == 256
    assert int(ck["optimizer_state_dict"]["step"]) == 1
    assert [set(r) for r in _records(out / "m.jsonl")] == [RECORD_KEYS]
    assert (out / "best_student_model.npz").exists()


def _jax_format_kd_checkpoint(path, V):
    """A KD checkpoint as the JAX trainer writes it, with moments that are
    not zero: trees in the layout of the JAX ``student_init`` and
    ``create_feature_projectors`` (checked by ``jax.eval_shape``), numpy
    values from the port's initialisers, written by the JAX package's
    checkpoint writer."""
    import jax.numpy as jnp

    from imagecaptioner_tpu.core.config import full_student_config as j_full
    from imagecaptioner_tpu.distill.projector import \
        create_feature_projectors as j_projectors
    from imagecaptioner_tpu.models import student as JSM

    cfg = PC.full_student_config(V, dropout=0.3, **SMALL)
    jcfg = j_full(V, dropout=0.3, **SMALL)
    p, s = student_init(5, cfg)
    proj, _ = create_feature_projectors(
        6, teacher_embed=32, student_embed=32, student_hidden=32,
        teacher_seq_len=TeacherConfig(**TEACHER).num_tokens)
    lay_p, lay_s = jax.eval_shape(lambda k: JSM.student_init(k, jcfg),
                                  jax.random.PRNGKey(0))
    lay_proj, _ = jax.eval_shape(lambda k: j_projectors(
        k, teacher_embed=32, student_embed=32, student_hidden=32,
        teacher_seq_len=TeacherConfig(**TEACHER).num_tokens),
        jax.random.PRNGKey(0))
    for tree, layout in ((p, lay_p), (s, lay_s), (proj, lay_proj)):
        assert jax.tree.structure(tree) == jax.tree.structure(layout)
        assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, layout)
    params = {"student": p, "projectors": proj}
    rng = np.random.default_rng(7)
    mu = jax.tree.map(lambda a: rng.standard_normal(a.shape, np.float32), params)
    nu = jax.tree.map(lambda a: rng.random(a.shape, np.float32), params)
    as_jax = lambda t: jax.tree.map(jnp.asarray, t)  # noqa: E731
    JCKPT.save_checkpoint(path, dict(
        epoch=0, student_state_dict=as_jax(dict(params=p, model_state=s)),
        projectors_state_dict=as_jax(proj),
        optimizer_state_dict=as_jax(dict(step=np.int32(5), mu=mu, nu=nu)),
        vocab_size=V, model_config=dict(model_type="full", **SMALL)))
    return cfg, p, s, proj, mu, nu


def test_resume_from_a_jax_checkpoint(disk, tmp_path, capsys):
    """Parameters, batch-norm state, the AdamW step and moments of a
    JAX-format checkpoint land in the port's state, and training starts at
    the epoch after the checkpoint's (here the last: no step is taken)."""
    _, data, t_path, V = disk
    ck = str(tmp_path / "jax_kd.npz")
    cfg, p, s, proj, mu, nu = _jax_format_kd_checkpoint(ck, V)
    with few_threads():
        state, s_cfg, _ = TK.train_student_with_kd(
            data, None, t_path, str(tmp_path / "out"), image_size=S,
            max_caption_len=MAXLEN, num_epochs=1, resume_from=ck,
            compute_dtype=torch.float32, device="cpu",
            student_cfg_overrides=SMALL)
    assert f"Resumed from {ck} at epoch 1" in capsys.readouterr().out
    assert s_cfg == cfg
    want = CV.jax_student_to_state_dict(p, s, cfg)
    got = state.student.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    for k, v in CV.jax_projectors_to_state_dict(proj).items():
        np.testing.assert_array_equal(state.projectors.state_dict()[k].numpy(),
                                      v.numpy())
    assert state.opt_state.step == 5
    for tree, got in ((mu, state.opt_state.mu), (nu, state.opt_state.nu)):
        want = CV.tree_to_state_dict(tree)
        assert set(got) == set(want) == set(state.named_parameters())
        for k, v in want.items():
            np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
    hist = json.load(open(tmp_path / "out" / "student_training_history.json"))
    assert hist["train_losses"] == []


def test_resume_goes_on_from_the_checkpoint(trained_from_disk, disk,
                                            tmp_path):
    """The port's best checkpoint (epoch 0, one step) resumed for a second
    epoch: the step count goes on and the log's records carry epoch 1."""
    out, _, _, _ = trained_from_disk
    _, data, t_path, _ = disk
    log = tmp_path / "m.jsonl"
    with few_threads():
        state, _, _ = TK.train_student_with_kd(
            data, None, t_path, str(tmp_path / "out"), image_size=S,
            max_caption_len=MAXLEN, num_epochs=2,
            resume_from=os.path.join(out, "best_student_model.npz"),
            metrics_jsonl=str(log), compute_dtype=torch.float32,
            device="cpu", verbose=False, student_cfg_overrides=SMALL)
    assert state.opt_state.step == 2
    assert [(r["epoch"], r["step"]) for r in _records(log)] == [(1, 1)]


def test_port_checkpoint_coerces_into_the_jax_optimizer(trained_from_disk):
    """A checkpoint the port wrote goes through the JAX trainer's resume:
    ``FlatAdamW.coerce_state_tree`` and ``jax.tree.map(jnp.asarray, ...)``
    give the port's state back."""
    import jax.numpy as jnp

    from imagecaptioner_tpu.core.config import KDTrainConfig as JKD
    from imagecaptioner_tpu.core.config import full_student_config as j_full
    from imagecaptioner_tpu.train import steps as JS

    out, state, s_cfg, vocab = trained_from_disk
    ck = JCKPT.load_checkpoint(os.path.join(out, "best_student_model.npz"))
    params = {"student": jax.tree.map(jnp.asarray,
                                      ck["student_state_dict"]["params"]),
              "projectors": jax.tree.map(jnp.asarray,
                                         ck["projectors_state_dict"])}
    mstate = jax.tree.map(jnp.asarray, ck["student_state_dict"]["model_state"])
    jcfg = j_full(len(vocab), dropout=s_cfg.dropout, **SMALL)
    opt = JS.make_kd_opt(params, jcfg, JKD()).coerce_state_tree(
        ck["optimizer_state_dict"])
    assert int(opt.step) == state.opt_state.step == 1
    for tree, named in ((opt.mu, state.opt_state.mu),
                        (opt.nu, state.opt_state.nu),
                        (params, state.named_parameters())):
        assert jax.tree.structure(tree) == jax.tree.structure(params)
        flat = CV.tree_to_state_dict(jax.tree.map(np.asarray, tree))
        assert set(flat) == set(named)
        for k, v in flat.items():
            np.testing.assert_array_equal(v.numpy(), named[k].detach().numpy(),
                                          err_msg=k)
    buffers = CV.jax_student_to_state_dict(
        ck["student_state_dict"]["params"], jax.tree.map(np.asarray, mstate),
        s_cfg)
    for k, v in state.student.state_dict().items():
        np.testing.assert_array_equal(buffers[k].numpy(), v.numpy(), err_msg=k)
