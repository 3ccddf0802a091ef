"""Data parallelism of the port over a ``torch.distributed`` world
(``core/mesh.py``, ``parallel/multihost.py``, ``train/common.py``'s mesh
helpers, the steps' global reductions, ``eval/serving.py``) against the
JAX package's semantics: a step on W ranks of B rows computes what one
process computes on the global batch of W·B rows.

The two-process tests run two gloo ranks on the CPU, joined over a file
store under ``tmp_path`` (never a TCP port, so they cannot meet the JAX
multihost test's rendezvous), with a 60 s timeout on their collectives and
a deadline of their own on the join.  One world computes everything the
tests compare (a KD step of the full student, a teacher step, the global
batch norm alone) and writes it to ``tmp_path``; the parent process runs
the same steps on the global batch.  Float32, dropout off on both sides,
augmentation off; the tolerances are stated where they are used.

The one-process reference runs twice: with the batch norm a single process
trains with (``F.batch_norm``), and with the data-parallel batch norm's
arithmetic (``modules._GlobalBatchNorm``) over its one process.  The
second isolates data parallelism (the blocks, the collectives, the
normalizers) from the batch norm's last-bit arithmetic: at this size (two
64x64 images a rank) the train-mode ResNet turns the two formulas' ~3e-7
output differences into gradients 1% apart in layer3 (measured: the two
formulas in one process differ as much as the world and ``F.batch_norm``
do, and the world equals the second reference to 4e-7).
"""

import types

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core import mesh as MS
from imagecaptioner_tpu_torch.core import modules as PM
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.data.vocabulary import END
from imagecaptioner_tpu_torch.distill.losses import LOSS_NAMES
from imagecaptioner_tpu_torch.distill.projector import (
    create_feature_projectors, make_projectors)
from imagecaptioner_tpu_torch.models import teacher as PTM
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.ops import attention as PA
from imagecaptioner_tpu_torch.ops import lstm_scan as PL
from imagecaptioner_tpu_torch.parallel import multihost as MH
from imagecaptioner_tpu_torch.train import common
from imagecaptioner_tpu_torch.train import steps as PS
from imagecaptioner_tpu_torch.utils import convert as CV

V, E, H = 30, 16, 24
A, BR, W, TCAP, S = 2, 2, 2, 8, 64        # B=2 rows a rank, 2 ranks
TKW = dict(vocab_size=V, embed_size=32, num_heads=2, num_decoder_layers=1,
           dropout=0.15, encoder_dim=24, encoder_depth=1, encoder_heads=2,
           patch_size=16, image_size=S)
SCHED_T = 0.25
JOIN_S = 240     # the join's own deadline: the suite's load slows the ranks


def _cfgs():
    return (PC.TeacherConfig(**TKW),
            PC.full_student_config(V, embed_size=E, hidden_size=H,
                                   dropout=0.0))


def _trees():
    """JAX-layout trees from the port's numpy initialisers."""
    t_cfg, s_cfg = _cfgs()
    proj, _ = create_feature_projectors(
        2, teacher_embed=32, student_embed=E, student_hidden=H,
        student_seq_len=49, teacher_seq_len=t_cfg.num_tokens)
    return (PTM.teacher_init(0, t_cfg),) + tuple(student_init(1, s_cfg)) \
        + (proj,)


def _global_batch():
    """A=2 micro-batches of 4 rows; rank 1's block holds the longest
    caption of each micro-batch, so a rank-local max(lengths) is wrong."""
    rng = np.random.default_rng(5)
    B = BR * W
    caps = np.zeros((A, TCAP, B), np.int32)
    lengths = np.array([[4, 5, 6, TCAP], [3, 5, TCAP, 4]], np.int32)
    for a in range(A):
        for b in range(B):
            n = lengths[a, b]
            caps[a, :n, b] = [1] + list(rng.integers(4, V, n - 2)) + [2]
    return {"images": rng.integers(0, 256, (A, B, S, S, 3), dtype=np.uint8),
            "captions": caps, "lengths": lengths}


def _models(trees):
    t_tree, s_params, s_state, proj = trees
    t_cfg, s_cfg = _cfgs()
    teacher = PTM.Teacher(t_cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(t_tree), strict=True)
    student = Student(s_cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(
        s_params, s_state, s_cfg), strict=True)
    projectors = make_projectors(32, E, H)
    projectors.load_state_dict(CV.jax_projectors_to_state_dict(proj),
                               strict=True)
    return teacher, student, projectors


def _run_steps(batch, dp_batch_norm=False):
    """One KD step and one teacher step from the seeded trees on ``batch``
    (this process's rows); everything the tests compare, as numpy.
    ``dp_batch_norm``: one process with the data-parallel batch norm's
    arithmetic (module docstring)."""
    if dp_batch_norm:
        real = PM.MS
        PM.MS = types.SimpleNamespace(data_size=lambda: 2,
                                      psum_over_data=lambda x: x)
        try:
            return _run_steps(batch)
        finally:
            PM.MS = real
    t_cfg, s_cfg = _cfgs()
    trees = _trees()
    teacher, student, projectors = _models(trees)
    state = PS.init_train_state(student, projectors, s_cfg)
    kd = PS.make_kd_train_step(teacher.eval(), t_cfg, s_cfg,
                               PC.DistillConfig(),
                               PC.KDTrainConfig(dropout=0.0),
                               aug=PT.AugmentConfig(),
                               compute_dtype=torch.float32)
    tt = PS.init_teacher_train_state(_models(trees)[0], t_cfg)
    ts = PS.make_teacher_train_step(t_cfg, PC.TeacherTrainConfig(),
                                    aug=PT.AugmentConfig())
    ev = PS.make_kd_eval_step(teacher, t_cfg, s_cfg, PC.DistillConfig())
    b = PS.batch_to_device(batch, "cpu")
    with PM.no_dropout():
        m = kd(state, b, SCHED_T, None)
        tm = ts(tt, b, SCHED_T, None)
        loss, ld, _, _ = ev(state, {k: v[0] for k, v in b.items()})
    out = {f"metric.{k}": float(v) for k, v in m.items()}
    out.update({f"teacher_metric.{k}": float(v) for k, v in tm.items()})
    out.update({f"eval.{k}": float(v) for k, v in ld.items()})
    out["eval_loss"] = float(loss)
    for n, p in state.named_parameters().items():
        out[f"param.{n}"] = p.detach().numpy().copy()
        out[f"mu.{n}"] = state.opt_state.mu[n].numpy().copy()
    for n, t in state.student.named_buffers():
        out[f"buffer.{n}"] = t.numpy().copy()
    for n, p in tt.named_parameters().items():
        if p.requires_grad:
            out[f"teacher_param.{n}"] = p.detach().numpy().copy()
            out[f"teacher_mu.{n}"] = tt.opt_state.mu[n].numpy().copy()
    return out


def _bn_inputs():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((BR * W, 3, 4, 5)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(x.shape).astype(np.float32)
    return x, g


def _bn(x, g, rank=0, size=1):
    """``modules.batch_norm`` in train mode on this rank's rows of x, the
    gradients of sum(y * g)."""
    b = x.shape[0] // size
    xt = torch.from_numpy(x[rank * b:(rank + 1) * b]).requires_grad_(True)
    w = torch.tensor([1.5, 0.5, 2.0], requires_grad=True)
    bias = torch.tensor([0.1, -0.2, 0.3], requires_grad=True)
    rm, rv = torch.zeros(3), torch.ones(3)
    y = PM.batch_norm(xt, w, bias, rm, rv, train=True)
    (y * torch.from_numpy(g[rank * b:(rank + 1) * b])).sum().backward()
    return dict(y=y.detach().numpy(), dx=xt.grad.numpy(), dw=w.grad.numpy(),
                db=bias.grad.numpy(), rm=rm.numpy(), rv=rv.numpy())


def _rank_main(out: str, device: str = "cpu"):
    """One rank of the world: its block of the global batch through the
    KD and teacher steps, the batch norm alone, and the batch sizes the
    kernels' wrappers saw."""
    torch.set_num_threads(2)
    mesh = MS.create_mesh(device)
    # this rank's block of each micro-batch, as the trainers take it when
    # the loader's batch is global
    local = common.put_global_batch(dataclasses.replace(mesh, split=True),
                                    _global_batch())
    seen = []
    real_attn, real_scan = PA.attention_core_plain, PL.decoder_scan_plain

    def attn(q, *a, **k):
        seen.append(("attention_core", q.shape[0]))
        return real_attn(q, *a, **k)

    def scan(*ops):
        seen.append(("decoder_scan", ops[2].shape[0]))
        return real_scan(*ops)

    PA.attention_core_plain, PL.decoder_scan_plain = attn, scan
    try:
        res = _run_steps(local)
    finally:
        PA.attention_core_plain, PL.decoder_scan_plain = real_attn, real_scan
    res.update({f"bn.{k}": v for k, v in _bn(*_bn_inputs(), mesh.rank,
                                             mesh.size).items()})
    res["seen"] = np.array([b for _, b in seen])
    res["seen_names"] = np.array([n for n, _ in seen])
    np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **res)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two ranks' results and one process's on the global batch."""
    tmp = tmp_path_factory.mktemp("world")
    MH.launch(_rank_main, ["cpu", "cpu"], kwargs=dict(out=str(tmp)),
              in_parent=False, timeout_s=60, join_timeout_s=JOIN_S,
              init_file=str(tmp / "store"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(W)]
    with common_threads():
        one = _run_steps(_global_batch())
        same = _run_steps(_global_batch(), dp_batch_norm=True)
    return ranks, one, same


class common_threads:
    """Two intra-op threads for the parent's heavy CPU section."""

    def __enter__(self):
        self.old = torch.get_num_threads()
        torch.set_num_threads(2)

    def __exit__(self, *exc):
        torch.set_num_threads(self.old)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


def test_host_shard_matches_jax():
    from imagecaptioner_tpu.parallel import multihost as JMH

    for n, count in ((41, 4), (10, 2), (7, 3), (16, 1), (5, 8)):
        shards = [MH.host_shard(n, process_index=i, process_count=count)
                  for i in range(count)]
        for i, got in enumerate(shards):
            np.testing.assert_array_equal(got, JMH.host_shard(
                n, process_index=i, process_count=count))
        assert len({len(s) for s in shards}) == 1
        flat = np.concatenate(shards)
        assert len(set(flat.tolist())) == len(flat) == n // count * count


def test_maybe_mesh_refusals_mirror_jax(monkeypatch):
    """As ``test_multihost.py``'s and ``test_sharding.py``'s refusals: a
    multi-process run refuses ``data_parallel=False``, and a global batch
    that does not divide over the world's devices; one process gets no
    mesh."""
    assert common.maybe_mesh(3, True, "cpu") is None
    assert common.maybe_mesh(3, False, "cpu") is None
    monkeypatch.setattr(MS, "world", lambda: (0, 2))
    with pytest.raises(ValueError, match="data parallelism"):
        common.maybe_mesh(16, enabled=False, device="cpu")
    monkeypatch.setattr(MH, "_SPLIT", True)   # the loader batch is global
    with pytest.raises(ValueError, match="multi-host"):
        common.maybe_mesh(3, device="cpu")
    mesh = common.maybe_mesh(4, device="cpu")
    assert (mesh.rank, mesh.size, mesh.device.type, mesh.split) == \
        (0, 2, "cpu", True)
    monkeypatch.setattr(MH, "_SPLIT", False)  # each process its own rows
    assert common.maybe_mesh(3, device="cpu").split is False
    with pytest.raises(ValueError, match="processes"):   # 2 x 2 != 2
        MS.create_mesh("cpu", shape=(2, 2))


def test_initialize_is_a_no_op_in_one_process(monkeypatch):
    """As ``test_multihost.py``'s: no arguments, one process, or no
    ``IC_COORDINATOR`` leave the process without a world."""
    monkeypatch.delenv("IC_COORDINATOR", raising=False)
    assert MH.initialize() is False
    assert MH.initialize("localhost:1", num_processes=1, process_id=0) \
        is False
    assert common.distributed_init_from_env("cpu") is False
    assert MS.world() == (0, 1) and MH.process_info() == {
        "process_index": 0, "process_count": 1}
    assert common.is_primary(None) and common.rank_seed(7, None) == 7
    with common.step_context(None):
        pass


def test_cards_to_spawn_only_on_cuda_with_several_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert common.cards_to_spawn(16, True, "cuda") == 2
    assert common.cards_to_spawn(3, True, "cuda") == 0   # runs on one card
    assert common.cards_to_spawn(16, False, "cuda") == 0
    assert common.cards_to_spawn(16, True, "cuda:1") == 0
    assert common.cards_to_spawn(16, True, "cpu") == 0
    monkeypatch.setenv("IC_COORDINATOR", "localhost:1")
    assert common.cards_to_spawn(16, True, "cuda") == 0
    monkeypatch.delenv("IC_COORDINATOR")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert common.cards_to_spawn(16, True, "cuda") == 0


def test_shard_batch_and_time_major_take_contiguous_blocks():
    """What ``P("data")`` gives device r: the contiguous block r of the
    batch axis (0 for images and lengths, 1 for time-major captions);
    ``put_global_batch`` takes it only when the loader's batch is
    global."""
    x = np.arange(8 * 3).reshape(8, 3)
    caps = np.arange(5 * 8).reshape(5, 8)
    for r in range(4):
        m = MS.Mesh(r, 4, torch.device("cpu"))
        np.testing.assert_array_equal(MS.shard_batch(m, {"x": x})["x"],
                                      x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(MS.shard_time_major(m, caps),
                                      caps[:, 2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="not divisible"):
        MS.shard_batch(MS.Mesh(0, 3, torch.device("cpu")), x)
    stk = {"images": np.arange(2 * 4 * 2).reshape(2, 4, 2).astype(np.uint8),
           "captions": np.arange(2 * 3 * 4).reshape(2, 3, 4),
           "lengths": np.arange(8).reshape(2, 4)}
    split = MS.Mesh(1, 2, torch.device("cpu"), split=True)
    got = common.put_global_batch(split, stk)
    np.testing.assert_array_equal(got["images"], stk["images"][:, 2:])
    np.testing.assert_array_equal(got["captions"], stk["captions"][:, :, 2:])
    np.testing.assert_array_equal(got["lengths"], stk["lengths"][:, 2:])
    assert got["captions"].dtype == torch.long
    own = common.put_global_batch(dataclasses.replace(split, split=False),
                                  stk)
    np.testing.assert_array_equal(own["images"], stk["images"])
    one = common.put_global_batch(split, {k: v[0] for k, v in stk.items()},
                                  stacked=False)
    np.testing.assert_array_equal(one["captions"], stk["captions"][0][:, 2:])
    blocks = list(common.stacked_batches(
        [{k: v[0] for k, v in stk.items()}] * 4, 2, mesh=split))
    assert len(blocks) == 2 and blocks[0]["images"].shape == (2, 2, 2)


def test_get_loader_host_shard_in_a_world_of_two(tmp_path, monkeypatch):
    """Each rank of a world of two gets its ``host_shard`` of the rows,
    with the vocabulary of all of them; global loader batches
    (``launch(split=True)``) and one process keep every row."""
    import torch.distributed as dist

    from imagecaptioner_tpu_torch.data.loader import get_loader

    csv = tmp_path / "caps.csv"
    csv.write_text("image,caption\n" + "".join(
        f"i{k}.jpg,a dog runs fast number{k % 3}\n" for k in range(9)))
    _, full = get_loader(str(tmp_path), str(csv), freq_threshold=2,
                         host_shard=True)
    assert len(full) == 9
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    shards = []
    for r in range(2):
        monkeypatch.setattr(dist, "get_rank", lambda r=r: r)
        loader, ds = get_loader(str(tmp_path), str(csv), batch_size=2,
                                freq_threshold=2, host_shard=True)
        assert ds.vocab.stoi == full.vocab.stoi
        assert ds.imgs == [full.imgs[i] for i in MH.host_shard(
            9, process_index=r, process_count=2)]
        assert len(ds) == 4 and len(loader) == 2
        shards.append(ds.imgs)
    assert not set(shards[0]) & set(shards[1])
    monkeypatch.setattr(MH, "_SPLIT", True)
    assert len(get_loader(str(tmp_path), str(csv), freq_threshold=2,
                          host_shard=True)[1]) == 9


def test_two_process_kd_step_matches_one_process(world):
    """The KD step's loss terms and gradient norm on two ranks equal one
    process's on the global batch to 1e-5 relative: the world's
    max(lengths), masked counts, global B and batch-norm statistics are in
    the losses, and the ranks' shares and gradients sum to the global
    ones; so does the eval step's loss on the first micro-batch after the
    update.  Against ``F.batch_norm``'s process the loss terms hold to
    5e-5 (the feature term reads the ResNet), the gradient norm, which the
    ResNet's layer3 dominates, to 5e-4, and the eval loss, which reads the
    updated ResNet, to 1e-4 (module docstring)."""
    ranks, one, same = world
    for r in ranks:
        for k in LOSS_NAMES + ("grad_norm", "lr"):
            np.testing.assert_allclose(r[f"metric.{k}"], same[f"metric.{k}"],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
            assert np.isfinite(r[f"metric.{k}"])
        for k in LOSS_NAMES:
            np.testing.assert_allclose(r[f"metric.{k}"], one[f"metric.{k}"],
                                       rtol=5e-5, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(r[f"eval.{k}"], same[f"eval.{k}"],
                                       rtol=1e-5, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(r[f"eval.{k}"], one[f"eval.{k}"],
                                       rtol=1e-4, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(r["metric.grad_norm"],
                                   one["metric.grad_norm"], rtol=5e-4)
    assert one["metric.token_kd_loss"] > 0 and one["metric.grad_norm"] > 1.0


def _noise_floor(mu, r_mu):
    """Entries of a gradient that is zero in exact arithmetic (a bias ahead
    of a train-mode batch norm; an attention's key bias, which softmax
    ignores) hold float noise, and AdamW's first step moves each by
    lr x sign(noise).  Such entries are those below 1e-6 of the leaf's
    largest gradient on both sides."""
    tiny = 1e-6 * max(np.abs(mu).max(), 1e-30)
    return (np.abs(mu) <= tiny) & (np.abs(r_mu) <= tiny)


def _params_match(r, ref, prefix, mu_prefix, lr):
    """Every updated parameter to 1e-5 relative in L2 over the entries
    with a real gradient; the noise entries (``_noise_floor``) within one
    AdamW step each."""
    names = [k for k in ref if k.startswith(prefix)]
    assert names
    for k in names:
        mk = mu_prefix + k[len(prefix):]
        if not ref[mk].any() and not r[mk].any():      # frozen: unmoved
            np.testing.assert_array_equal(r[k], ref[k], err_msg=k)
            continue
        noise = _noise_floor(ref[mk], r[mk])
        assert noise.mean() < 0.5, k
        assert _rel(r[k][~noise], ref[k][~noise]) <= 1e-5, \
            (k, _rel(r[k][~noise], ref[k][~noise]))
        assert np.abs(r[k][noise] - ref[k][noise]).max(initial=0) \
            <= 2.01 * lr, k
    return names


def test_two_process_kd_step_updates_every_parameter_alike(world):
    """Every updated parameter and every gradient (AdamW's first moment)
    of both ranks equals the one process's with the same batch-norm
    arithmetic to 1e-5 relative in L2 (noise-level gradients: see
    ``_noise_floor``).  Against ``F.batch_norm``'s process every leaf
    outside the ResNet agrees to 2e-4 of its largest gradient entry and
    each ResNet leaf to 10% in L2, ``test_torch_port_kd_step.py``'s
    tolerances (with an absolute floor of 1e-9 of the gradient's norm for
    the decoder's attention bias, whose gradient is 1e-6 of it)."""
    ranks, one, same = world
    lr = PC.KDTrainConfig().learning_rate
    for r in ranks:
        names = _params_match(r, same, "param.", "mu.", lr)
        assert any(".resnet.layer4." in k for k in names)
        for k in (k for k in same if k.startswith("mu.")):
            noise = _noise_floor(same[k], r[k])
            assert _rel(r[k][~noise], same[k][~noise]) <= 1e-5, k
            # each side's unclipped gradient: its moment times its norm
            g = r[k] * float(r["metric.grad_norm"])
            g_ref = one[k] * float(one["metric.grad_norm"])
            if ".resnet." in k:
                assert (np.linalg.norm(g - g_ref)
                        <= 0.1 * np.linalg.norm(g_ref) + 1e-12), k
            else:      # floor: 1e-9 of the whole gradient's norm
                np.testing.assert_allclose(
                    g, g_ref, atol=2e-4 * np.abs(g_ref).max()
                    + 1e-9 * float(one["metric.grad_norm"]), rtol=0,
                    err_msg=k)


def test_two_process_running_statistics_match(world):
    """Every batch norm's running mean and variance after the step (the
    global count's unbiased variance) equals the same-arithmetic process's
    to 1e-5 relative, and ``F.batch_norm``'s to 1e-4."""
    ranks, one, same = world
    names = [k for k in one if k.startswith("buffer.") and "running" in k]
    assert len(names) >= 2 * 53
    for r in ranks:
        for k in names:
            assert _rel(r[k], same[k]) <= 1e-5, (k, _rel(r[k], same[k]))
            assert _rel(r[k], one[k]) <= 1e-4, (k, _rel(r[k], one[k]))


def test_two_process_teacher_step_matches_one_process(world):
    """The teacher step's label-smoothing loss (global count and
    max(lengths)), gradient norm and updated parameters: 1e-5 relative
    (the teacher has no batch norm; noise-level gradients: see
    ``_noise_floor``)."""
    ranks, one, _ = world
    for r in ranks:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r[f"teacher_metric.{k}"],
                                       one[f"teacher_metric.{k}"], rtol=1e-5,
                                       err_msg=k)
        _params_match(r, one, "teacher_param.", "teacher_mu.",
                      PC.TeacherTrainConfig().learning_rate)


def test_global_batch_norm_forward_and_backward(world):
    """The batch norm alone: each rank's output and input gradient are its
    rows of one process's on the global batch, the weight's and bias's
    gradients sum over the ranks to one process's, and the running
    statistics take the global batch's (F.batch_norm); 1e-5."""
    ranks = world[0]
    x, g = _bn_inputs()
    ref = _bn(x, g)
    xt = torch.from_numpy(x)
    rm, rv = torch.zeros(3), torch.ones(3)
    F.batch_norm(xt, rm, rv, training=True, momentum=0.1)
    np.testing.assert_allclose(ref["rm"], rm.numpy(), rtol=1e-6)
    np.testing.assert_allclose(ref["rv"], rv.numpy(), rtol=1e-6)
    for r, res in enumerate(ranks):
        rows = slice(r * BR, (r + 1) * BR)
        for k in ("y", "dx"):
            np.testing.assert_allclose(res[f"bn.{k}"], ref[k][rows],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        for k in ("rm", "rv"):
            np.testing.assert_allclose(res[f"bn.{k}"], ref[k], rtol=1e-5,
                                       err_msg=k)
    for k in ("dw", "db"):
        np.testing.assert_allclose(sum(res[f"bn.{k}"] for res in ranks),
                                   ref[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_kernel_wrappers_see_half_the_rows(world):
    """Under a world of 2 the attention core (#2's wrapper) and the decoder
    recurrence (#4-#6's) are called on each rank's B/2 rows."""
    ranks = world[0]
    for res in ranks:
        names = set(res["seen_names"].tolist())
        assert names == {"attention_core", "decoder_scan"}
        assert set(res["seen"].tolist()) == {BR}


def test_two_process_kd_step_matches_jax_single_device(world):
    """Rank 0's step against the JAX package's single-device step on the
    global batch, with ``test_torch_port_kd_step.py``'s tolerances: loss
    terms 1e-5 absolute (the ResNet-fed feature term and the total 5e-5),
    the gradient norm 5e-3 relative, each leaf's gradient 2e-4 of its
    largest entry, the ResNet's ill-conditioned leaves 10% in L2."""
    import jax
    import jax.numpy as jnp

    from imagecaptioner_tpu.core import modules as JM
    from imagecaptioner_tpu.core.config import (
        DistillConfig as JDistillConfig, KDTrainConfig as JKDTrainConfig,
        TeacherConfig as JTeacherConfig, full_student_config as j_full)
    from imagecaptioner_tpu.data import transforms as JT
    from imagecaptioner_tpu.train import optim as JO
    from imagecaptioner_tpu.train import steps as JS

    ranks = world[0]
    t_tree, s_params, s_state, proj = _trees()
    mp = pytest.MonkeyPatch()
    mp.setattr(JM, "dropout", lambda rng, x, rate, train: x)
    try:
        jt_cfg = JTeacherConfig(**TKW)
        js_cfg = j_full(V, embed_size=E, hidden_size=H, dropout=0.0)
        tree = jax.tree.map(jnp.asarray, (t_tree, {
            "student": s_params, "projectors": proj}, s_state))
        params = tree[1]
        jstep = JS.make_kd_train_step(jt_cfg, js_cfg, JDistillConfig(),
                                      JKDTrainConfig(dropout=0.0),
                                      aug=JT.AugmentConfig(),
                                      compute_dtype=jnp.float32)
        jstate = JS.TrainState(params, jax.jit(JO.adamw_init)(params),
                               tree[2])
        jstate, jm = jstep(jstate, tree[0], {
            k: jnp.asarray(v) for k, v in _global_batch().items()},
            jnp.float32(SCHED_T), jnp.int32(0), jax.random.PRNGKey(1))
        mu = {f"mu.{k}": np.asarray(v) for k, v in CV.tree_to_state_dict(
            jax.tree.map(np.asarray, jstate.opt_state.mu)).items()}
        jm = {k: float(v) for k, v in jm.items()}
    finally:
        mp.undo()
    got = ranks[0]
    for k in LOSS_NAMES:
        # the feature term reads the ResNet's features: at this batch the
        # port's own one-process step is 2.4e-5 from JAX's there
        np.testing.assert_allclose(got[f"metric.{k}"], jm[k], rtol=0,
                                   atol=5e-5 if k in ("feature_kd_loss",
                                                      "total_loss") else 1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["metric.grad_norm"], jm["grad_norm"],
                               rtol=5e-3)
    n_ref, n_got = jm["grad_norm"], float(got["metric.grad_norm"])
    assert n_ref > 1.0 and n_got > 1.0                # both sides clipped
    assert set(mu) == {k for k in got if k.startswith("mu.")}
    for k, ref in mu.items():
        g_ref, g_got = ref * n_ref, got[k] * n_got
        if ".resnet." in k:
            assert (np.linalg.norm(g_got - g_ref)
                    <= 0.1 * np.linalg.norm(g_ref) + 1e-9), k
        else:
            np.testing.assert_allclose(
                g_got, g_ref, atol=2e-4 * np.abs(g_ref).max() + 1e-9, rtol=0,
                err_msg=k)


def test_trainer_over_a_world_whose_loader_batches_are_global(tmp_path):
    """The path a trainer takes over several cards with no world
    (``common.run_per_card``), on the CPU: ``launch(split=True)`` pickles
    the loaders to a second process, this process is rank 0, and each
    rank takes its contiguous block of every loader batch (4 rows: 2 a
    rank, in training and in validation).  Rank 0 returns the state and
    alone writes the checkpoints, the history and one finite metric
    record."""
    from imagecaptioner_tpu_torch.data.synthetic import make_grid_loaders
    from imagecaptioner_tpu_torch.train import train_student_kd as TK
    from imagecaptioner_tpu_torch.utils.checkpoint import save_checkpoint

    train_loader, val_loader, vocab = make_grid_loaders(
        16, image_size=S, seed=0, batch_size=4, max_caption_len=TCAP,
        freq_threshold=1)
    t_kw = {k: v for k, v in TKW.items() if k != "vocab_size"}
    t_path = str(tmp_path / "teacher.npz")
    save_checkpoint(t_path, {"model_state_dict": {"params": PTM.teacher_init(
        0, PC.TeacherConfig(vocab_size=len(vocab), **t_kw))},
        "vocab_size": len(vocab), "model_config": t_kw})
    out, log = tmp_path / "out", tmp_path / "metrics.jsonl"
    seen = []
    real = PA.attention_core_plain

    def attn(q, *a, **k):
        seen.append(q.shape[0])
        return real(q, *a, **k)

    PA.attention_core_plain = attn
    try:
        with common_threads():
            state, s_cfg, _ = MH.launch(
                TK.train_student_with_kd_on_loaders, ["cpu", "cpu"],
                kwargs=dict(train_loader=train_loader, val_loader=val_loader,
                            vocab=vocab, teacher_checkpoint=t_path,
                            output_dir=str(out), num_epochs=1,
                            max_steps_per_epoch=1,
                            compute_dtype=torch.float32,
                            metrics_jsonl=str(log), verbose=False,
                            student_cfg_overrides=dict(embed_size=E,
                                                       hidden_size=H)),
                split=True, timeout_s=60, join_timeout_s=JOIN_S,
                init_file=str(tmp_path / "store"))
    finally:
        PA.attention_core_plain = real
    assert not MS.world()[1] > 1                       # the world is gone
    assert s_cfg.embed_size == E and state.opt_state.step == 1
    assert set(seen) == {2}                            # 2 of 4 rows a call
    assert {p.name for p in out.iterdir()} >= {
        "best_student_model.npz", "final_student_model.npz", "vocab.json",
        "student_training_history.json"}
    recs = [json.loads(line) for line in log.read_text().splitlines()]
    assert len(recs) == 1 and np.isfinite(recs[0]["total_loss"])


# ---------------------------------------------------------------------------
# Data-parallel serving
# ---------------------------------------------------------------------------

SV_KW = dict(embed_size=E, hidden_size=H, dropout=0.0)


def _sharpened_student():
    """A full student whose greedy rows differ (the decoder's weights
    scaled as ``chip_smoke.sharpen_decoder`` scales them)."""
    cfg = PC.full_student_config(V, **SV_KW)
    p, s = student_init(3, cfg)
    dec = p["decoder"]
    for layer in dec["lstm"]:
        layer["weight_ih"] *= 2.0
        layer["weight_hh"] *= 2.0
    dec["attention"]["weight"] *= 4.0
    for fc in ("fc1", "fc2"):
        dec["output_projection"][fc]["weight"] *= 8.0
    model = Student(cfg)
    model.load_state_dict(CV.jax_student_to_state_dict(p, s, cfg),
                          strict=True)
    return model.eval(), cfg, p, s


def test_dp_greedy_captioner_matches_single_device_and_jax():
    """``make_dp_greedy_captioner(["cpu", "cpu"])`` is token-identical to
    the single-device captioner on the whole batch and to the JAX
    package's ``make_dp_greedy_captioner`` on a 1-device mesh; a batch the
    devices cannot split raises the JAX factory's message."""
    import jax
    import jax.numpy as jnp

    from imagecaptioner_tpu.core import mesh as JMS
    from imagecaptioner_tpu.core.config import full_student_config as j_full
    from imagecaptioner_tpu.data import transforms as JT
    from imagecaptioner_tpu.eval import serving as JSV

    from imagecaptioner_tpu_torch.eval import serve
    from imagecaptioner_tpu_torch.eval import serving as SV

    model, cfg, p, s = _sharpened_student()
    # noise with a dark or a bright band: a random ResNet gives noise
    # images alone near-identical features
    imgs = np.random.default_rng(4).integers(0, 256, (6, S, S, 3),
                                             dtype=np.uint8)
    imgs[:3, :S // 2] = 0
    imgs[3:, :, :S // 2] = 255
    with common_threads():
        one = serve.make_greedy_captioner(model, cfg, "cpu",
                                          max_length=6)(imgs)
        dp = SV.make_dp_greedy_captioner(model, cfg, ["cpu", "cpu"],
                                         max_length=6)
        got = dp(imgs)
        with pytest.raises(ValueError, match=r"batch 5 not divisible by the "
                           r"mesh's data axis \(2\)"):
            dp(imgs[:5])
    np.testing.assert_array_equal(got, one)
    assert got.shape == (6, 6) and got.dtype == np.int32
    assert len({tuple(r) for r in got}) > 1          # the rows differ
    jcfg = j_full(V, **SV_KW)
    jfn = JSV.make_dp_greedy_captioner(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s), jcfg,
        JMS.create_mesh(jax.devices()[:1]), max_length=6)
    np.testing.assert_array_equal(
        got, np.asarray(jfn(JT.normalize(jnp.asarray(imgs)))))


def test_dp_beam_captioner_matches_single_device():
    """``make_dp_beam_captioner`` over two CPU blocks, packed and
    pipelined, gives the single-device captioner's hypotheses, scores and
    lengths on the whole batch."""
    from imagecaptioner_tpu_torch.eval import serve
    from imagecaptioner_tpu_torch.eval import serving as SV

    t_cfg = PC.TeacherConfig(**dict(TKW, dropout=0.0))
    teacher = PTM.Teacher(t_cfg)
    tree = PTM.teacher_init(7, t_cfg)
    tree["fc_out"]["bias"][END] += 1.2                       # END occurs
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(tree), strict=True)
    teacher.eval()
    imgs = np.random.default_rng(8).integers(0, 256, (4, S, S, 3),
                                             dtype=np.uint8)
    with common_threads():
        ref = serve.make_beam_captioner(teacher, t_cfg, "cpu", max_length=6,
                                        beam_size=3)(imgs)
        for pack in (0, 2):
            got = SV.make_dp_beam_captioner(
                teacher, t_cfg, ["cpu", "cpu"], max_length=6, beam_size=3,
                pipelined_pack=pack)(imgs)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g, r)
    assert ref[0].shape == (4, 3, 7)
