"""The device-resident data path of the port against the JAX package on the
CPU: ``data/device_cache.py`` (arrays, budget, epoch indices, the on-device
gather), ``train/steps.make_device_data_step`` (a chain of K=2 steps against
two direct steps of the port and against JAX's chained step), the trainer's
``--device-dataset --stream-steps`` CLI, and ``data/loader.device_prefetch``.

The dataset is the trainers' own: 16 grid images with two caption rows each
as JPEGs and a CSV (the first image's file removed, so both packages give it
the black placeholder), at 64x64.  The chained KD steps run the full
student at narrow widths (E=16, H=24) with augmentation and dropout off, as
``test_torch_port_kd_step.py`` does, at A=2 x B=2.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imagecaptioner_tpu.core import modules as JM
from imagecaptioner_tpu.core.config import (DistillConfig as JDistillConfig,
                                            KDTrainConfig as JKDTrainConfig,
                                            TeacherConfig as JTeacherConfig,
                                            full_student_config as j_full)
from imagecaptioner_tpu.data import device_cache as JDC
from imagecaptioner_tpu.data import transforms as JT
from imagecaptioner_tpu.data.dataset import CaptionDataset as JCaptionDataset
from imagecaptioner_tpu.distill.projector import \
    create_feature_projectors as j_projectors
from imagecaptioner_tpu.models import student as JSM
from imagecaptioner_tpu.models import teacher as JTM
from imagecaptioner_tpu.train import optim as JO
from imagecaptioner_tpu.train import steps as JS
from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core import modules as PM
from imagecaptioner_tpu_torch.data import device_cache as PDC
from imagecaptioner_tpu_torch.data import synthetic as PSY
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.data.dataset import CaptionDataset
from imagecaptioner_tpu_torch.data.loader import BatchLoader, device_prefetch
from imagecaptioner_tpu_torch.distill.losses import LOSS_NAMES
from imagecaptioner_tpu_torch.distill.projector import make_projectors
from imagecaptioner_tpu_torch.models.student import Student
from imagecaptioner_tpu_torch.models.teacher import Teacher, teacher_init
from imagecaptioner_tpu_torch.train import steps as PS
from imagecaptioner_tpu_torch.train import train_student_kd as TK
from imagecaptioner_tpu_torch.utils import convert as CV
from imagecaptioner_tpu_torch.utils.checkpoint import save_checkpoint
from test_torch_port_compact import few_threads

S, MAXLEN, E, H = 64, 12, 16, 24
TEACHER = dict(embed_size=32, num_heads=2, num_decoder_layers=1, dropout=0.15,
               encoder_dim=24, encoder_depth=1, encoder_heads=2,
               patch_size=16, image_size=S)
A, B, K = 2, 2, 2
T0, DT = 0.25, 1.0 / 3.0          # the chain's schedule points, float32
# the chained steps' learning rate: small enough that step 2 runs on the
# weights step 1 ran on (to float32 noise), so the two packages' second
# steps are compared where the ResNet's ill-conditioning at B=2 (see
# test_torch_port_kd_step.py) has not yet amplified step 1's noise; the
# schedule still scales it, so the chain's schedule points are checked
LR = 1e-9


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    root = tmp_path_factory.mktemp("devdata")
    data = str(root / "data")
    csv = PSY.make_synthetic_dataset(data, n_images=16, captions_per_image=2,
                                     image_size=S, seed=0, learnable=True,
                                     task="grid")
    first = open(csv).read().splitlines()[1].split(",", 1)[0]
    os.remove(os.path.join(data, "Images", first))   # -> black placeholder
    pds = CaptionDataset(data, csv, image_size=S)
    jds = JCaptionDataset(data, csv, image_size=S)
    return root, data, csv, pds, jds


@pytest.fixture(scope="module")
def resident(disk):
    _, _, _, pds, jds = disk
    return (PDC.DeviceDataset(pds, max_caption_len=MAXLEN, device="cpu"),
            JDC.DeviceDataset(jds, max_caption_len=MAXLEN))


def test_resident_arrays_equal_jax(resident):
    """Rows decoded once are JAX's bit for bit, the placeholder included;
    their dtypes and shapes are JAX's."""
    pdd, jdd = resident
    assert pdd.n == jdd.n == 32
    for k in ("images", "captions", "lengths"):
        got, ref = pdd.arrays[k].numpy(), np.asarray(jdd.arrays[k])
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    assert not pdd.arrays["images"][0].any()       # the missing file
    assert pdd.arrays["images"][2].any()
    assert pdd.nbytes == 32 * (S * S * 3 + MAXLEN * 4 + 4)


def test_budget_refuses_what_does_not_fit(disk, monkeypatch):
    pds = disk[3]
    need = 32 * (S * S * 3 + MAXLEN * 4 + 4)
    with pytest.raises(ValueError, match="exceeds the .* budget"):
        PDC.DeviceDataset(pds, max_caption_len=MAXLEN, byte_budget=need - 1,
                          device="cpu")
    monkeypatch.setenv("IC_DEVICE_DATASET_BYTES", str(need - 1))
    with pytest.raises(ValueError, match="IC_DEVICE_DATASET_BYTES"):
        PDC.DeviceDataset(pds, max_caption_len=MAXLEN, device="cpu")
    assert PDC.DeviceDataset(pds, max_caption_len=MAXLEN, byte_budget=need,
                             device="cpu").n == 32


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_epoch_indices_are_jaxs(resident, seed):
    """Same draws for several batch sizes (the cap of 16 included) and
    accumulation steps, two epochs in a row; drop_last only."""
    pdd, jdd = resident
    for bs, acc in ((2, 2), (5, 1), (16, 2), (40, 1), (3, 4), (8, 5)):
        pdd.seed(seed)
        jdd.seed(seed)
        for _ in range(2):
            got = pdd.epoch_indices(batch_size=bs, accumulation_steps=acc)
            ref = jdd.epoch_indices(batch_size=bs, accumulation_steps=acc)
            assert got.dtype == np.int32 and got.shape == ref.shape
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="drop_last"):
        pdd.epoch_indices(batch_size=2, drop_last=False)


def test_gather_batch_is_jaxs_and_the_loaders(resident, disk):
    """The on-device gather gives JAX's batch, and the host loader's
    batches for the same seed."""
    pdd, jdd = resident
    pdd.seed(4)
    idx = pdd.epoch_indices(batch_size=4, accumulation_steps=2)
    got = PDC.gather_batch(pdd.arrays, torch.from_numpy(idx[1]))
    ref = JDC.gather_batch(jdd.arrays, jnp.asarray(idx[1]))
    for k in ("images", "captions", "lengths"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]))
    assert got["captions"].shape == (2, MAXLEN, 4)
    loader = BatchLoader(disk[3], batch_size=4, max_caption_len=MAXLEN,
                         seed=4)
    pdd.seed(4)
    flat = pdd.epoch_indices(batch_size=4).reshape(-1, 4)
    for i, batch in enumerate(loader):
        b = PDC.gather_batch(pdd.arrays, torch.from_numpy(flat[i:i + 1]))
        for k in ("images", "captions", "lengths"):
            np.testing.assert_array_equal(b[k][0].numpy(), batch[k])


def _np_tree(t):
    return jax.tree.map(lambda x: np.array(x, copy=True), t)


def _port_state(t0, p0, s0, t_cfg, s_cfg):
    teacher = Teacher(t_cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(t0), strict=True)
    student = Student(s_cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(
        p0["student"], s0, s_cfg), strict=True)
    projectors = make_projectors(32, E, H)
    projectors.load_state_dict(CV.jax_projectors_to_state_dict(
        p0["projectors"]), strict=True)
    return teacher.eval(), PS.init_train_state(student, projectors, s_cfg)


@pytest.fixture(scope="module")
def chain(resident, disk):
    """JAX's chained step (one jit program) and the port's, from one start,
    on the same indices; and the port's two direct steps."""
    pdd, jdd = resident
    V = len(disk[3].vocab)
    pdd.seed(1)
    idx = pdd.epoch_indices(batch_size=B, accumulation_steps=A)[:K]
    mp = pytest.MonkeyPatch()
    mp.setattr(JM, "dropout", lambda rng, x, rate, train: x)
    try:
        jt_cfg = JTeacherConfig(vocab_size=V, **TEACHER)
        js_cfg = j_full(V, embed_size=E, hidden_size=H, dropout=0.0)
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        t_params = JTM.teacher_init(k1, jt_cfg)
        s_params, s_state = JSM.student_init(k2, js_cfg)
        proj, _ = j_projectors(k3, teacher_embed=32, student_embed=E,
                               student_hidden=H, student_seq_len=49,
                               teacher_seq_len=jt_cfg.num_tokens)
        params = {"student": s_params, "projectors": proj}
        start = _np_tree((t_params, params, s_state))
        jstep = JS.make_kd_train_step(jt_cfg, js_cfg, JDistillConfig(),
                                      JKDTrainConfig(dropout=0.0,
                                                     learning_rate=LR),
                                      aug=JT.AugmentConfig(),
                                      compute_dtype=jnp.float32)
        chained = JS.make_device_data_step(jstep, K)
        jstate = JS.TrainState(params, jax.jit(JO.adamw_init)(params),
                               s_state)
        jstate, jms = chained(jstate, t_params, jdd.arrays, jnp.asarray(idx),
                              jnp.float32(T0), jnp.float32(DT), jnp.int32(0),
                              jax.random.PRNGKey(1))
        jax_side = dict(metrics={k: np.asarray(v) for k, v in jms.items()},
                        mu=_np_tree(jstate.opt_state.mu),
                        step=int(jstate.opt_state.step))
    finally:
        mp.undo()

    t0, p0, s0 = start
    t_cfg = PC.TeacherConfig(vocab_size=V, **TEACHER)
    s_cfg = PC.full_student_config(V, embed_size=E, hidden_size=H,
                                   dropout=0.0)
    runs = {}
    for how in ("chain", "direct"):
        teacher, state = _port_state(t0, p0, s0, t_cfg, s_cfg)
        step = PS.make_kd_train_step(teacher, t_cfg, s_cfg,
                                     PC.DistillConfig(),
                                     PC.KDTrainConfig(dropout=0.0,
                                                      learning_rate=LR),
                                     aug=PT.AugmentConfig(),
                                     compute_dtype=torch.float32)
        with PM.no_dropout(), few_threads():
            if how == "chain":
                ms = PS.make_device_data_step(step, K)(
                    state, pdd.arrays, idx, np.float32(T0), np.float32(DT),
                    0, None)
            else:
                ts = np.float32(T0) + np.float32(DT) * np.arange(
                    K, dtype=np.float32)
                ms = [step(state, PS.batch_to_device(
                    PDC.gather_batch(pdd.arrays, torch.from_numpy(idx[i])),
                    "cpu"), float(ts[i]), None) for i in range(K)]
                ms = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
        runs[how] = (state, ms)
    return dict(jax=jax_side, port=runs, idx=idx)


def test_chain_equals_two_direct_steps(chain):
    """K=2 chained steps of the port are its two direct steps: metrics and
    every parameter to 1e-6 (the same operations in the same order)."""
    (sc, mc), (sd, md) = chain["port"]["chain"], chain["port"]["direct"]
    assert set(mc) == set(md) and all(v.shape == (K,) for v in mc.values())
    for k in mc:
        np.testing.assert_allclose(mc[k].numpy(), md[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    pd = sd.named_parameters()
    for k, p in sc.named_parameters().items():
        np.testing.assert_allclose(p.detach().numpy(),
                                   pd[k].detach().numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    assert sc.opt_state.step == sd.opt_state.step == K


def test_chain_matches_jax_chained_step(chain):
    """Against JAX's ``make_device_data_step`` on the same weights and
    indices, at a learning rate of 1e-9 (``LR``).  Each step's
    cross-entropy and token terms agree to 1e-4 relative, the schedule's
    learning rates to 1e-5 (JAX computes them in float32).  The feature
    term reads the ResNet's features, ill-conditioned at B=2 (see
    ``test_torch_port_kd_step.py``; the first image is the black
    placeholder, and step 1 draws its rows 0 and 1): 1e-3 relative
    (measured 2.0e-4), and so the total; the gradient norm to 5e-3, as
    there.  AdamW's first moment after the two steps (0.09 x the first
    clipped gradient + 0.1 x the second) agrees to 10% in L2 in the
    ResNet's leaves and to 2e-4 of each other leaf's largest entry, that
    file's convention, except the encoder's projection, which the ResNet's
    features feed directly: 1e-3 (measured 6.8e-4)."""
    ref = chain["jax"]["metrics"]
    _, got = chain["port"]["chain"]
    for k in LOSS_NAMES:
        rtol = 1e-3 if k in ("feature_kd_loss", "total_loss") else 1e-4
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=rtol,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(got["lr"].numpy(), ref["lr"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"].numpy(), ref["grad_norm"],
                               rtol=5e-3)
    state, _ = chain["port"]["chain"]
    assert state.opt_state.step == chain["jax"]["step"] == K
    ref_mu = {k: v.numpy() for k, v in
              CV.tree_to_state_dict(chain["jax"]["mu"]).items()}
    assert set(state.opt_state.mu) == set(ref_mu)
    for k, r in ref_mu.items():
        g = state.opt_state.mu[k].numpy()
        if ".resnet." in k:
            assert (np.linalg.norm(g - r) <= 0.1 * np.linalg.norm(r)
                    + 1e-9), k
        else:
            tol = 1e-3 if k.startswith("student.encoder.projection.") \
                else 2e-4
            np.testing.assert_allclose(g, r, atol=tol * np.abs(r).max()
                                       + 1e-9, rtol=0, err_msg=k)


def test_cli_device_dataset_logs_every_step(disk, tmp_path):
    """``--device-dataset --stream-steps 3`` over 4 optimizer steps an epoch
    (32 images with 4 caption rows each: 128 rows, batches of 16,
    accumulation 2; the compact student, the cheapest at full width): one
    chunk of 3, then the trailing step alone, one metrics line a step,
    numbered in order."""
    data = str(tmp_path / "data")
    PSY.make_synthetic_dataset(data, n_images=32, captions_per_image=4,
                               image_size=S, seed=2, learnable=True,
                               task="grid")
    V = len(CaptionDataset(data, os.path.join(data, "captions_clean.csv"))
            .vocab)
    t_path = str(tmp_path / "teacher.npz")
    cfg = PC.TeacherConfig(vocab_size=V, **TEACHER)
    save_checkpoint(t_path, {"model_state_dict": {"params": teacher_init(0,
                                                                        cfg)},
                             "vocab_size": V, "model_config": TEACHER})
    out = str(tmp_path / "out")
    jsonl = os.path.join(out, "metrics.jsonl")
    calls = []
    real = PS.make_device_data_step

    def counting(step, k, mesh=None):
        fn = real(step, k, mesh)

        def wrapped(*a):
            calls.append(k)
            return fn(*a)
        return wrapped

    mp = pytest.MonkeyPatch()
    mp.setattr(PS, "make_device_data_step", counting)
    try:
        with few_threads():
            assert TK.main(["--data-root", data, "--teacher-checkpoint",
                            t_path, "--output-dir", out, "--image-size",
                            str(S), "--epochs", "1", "--device-dataset",
                            "--stream-steps", "3", "--metrics-jsonl", jsonl,
                            "--student", "compact",
                            "--device", "cpu"]) == 0
    finally:
        mp.undo()
    recs = [json.loads(line) for line in open(jsonl).read().splitlines()]
    assert calls == [3, 1]
    assert [r["step"] for r in recs] == list(range(4))
    assert all(np.isfinite(r["total_loss"]) for r in recs)
    assert len({r["lr"] for r in recs}) == 4      # the schedule advanced


def test_device_prefetch_keeps_order_on_the_cpu(disk):
    """On the CPU the batches come through in the loader's order, as
    tensors with the loader's values and dtypes; ``size`` only bounds what
    is in flight."""
    loader = BatchLoader(disk[3], batch_size=4, max_caption_len=MAXLEN,
                         seed=2)
    ref = list(BatchLoader(disk[3], batch_size=4, max_caption_len=MAXLEN,
                           seed=2))
    for size in (1, 2, 5):
        loader._rng = np.random.default_rng(2)
        got = list(device_prefetch(loader, "cpu", size=size))
        assert len(got) == len(ref) == 8
        for g, r in zip(got, ref):
            for k in r:
                assert g[k].dtype == torch.from_numpy(r[k]).dtype
                np.testing.assert_array_equal(g[k].numpy(), r[k])


def test_resident_constants_serve_inference_and_autograd():
    """The step's constant tables (pooling matrices, normalization
    statistics) are uploaded once per device (``core/device.
    device_constant``); one first made under ``inference_mode`` (serving)
    must still serve a training step that autograd records."""
    x = torch.rand(2, 3, 5, 7)
    with torch.inference_mode():
        PM.adaptive_avg_pool2d(x, (3, 2))
        PT.normalize(torch.zeros(1, 5, 7, 3, dtype=torch.uint8))
    w = x.clone().requires_grad_(True)
    y = PM.adaptive_avg_pool2d(w, (3, 2)).sum() + PT._standardize(
        w.permute(0, 2, 3, 1), PT.IMAGENET_MEAN, PT.IMAGENET_STD,
        torch.float32).sum()
    y.backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
    assert PM._pool_matrix(5, 3, "cpu") is PM._pool_matrix(5, 3, "cpu")
