"""Tensor and sequence parallelism of the port's frozen teacher over a
(data, model) ``torch.distributed`` world (``core/mesh.py``,
``parallel/tp.py``, ``parallel/sp.py``, the teacher's forwards, the KD
step) against the JAX package's semantics: a KD step on a (data, model)
world computes what one process computes on the global batch with the
unsharded teacher.

One world of four gloo ranks, a (2, 2) mesh, joined over a file store under
``tmp_path`` (never a TCP port), 60 s on its collectives and a deadline of
its own on the join, computes everything the world tests compare and
writes it to ``tmp_path``: the teacher's logits and memory under tensor
parallelism, sequence parallelism and both, at the JAX package's own test
configuration (``tests/test_sharding.py``: 3 ViT heads over a model axis of
2, so 2 + 1; 5 ViT tokens, 3 + 2), each rank on its data block of the
batch; and one KD step of a tiny full student with the teacher placed and
run inside the sequence policy.  The parent holds them against JAX's
replicated ``teacher_apply`` (JAX's 2e-5) and against one process on the
global batch and JAX's single-device step (the tolerances of
``tests/test_torch_port_data_parallel.py``, stated where used).  The port
has no jit cache, so JAX's test that the policy re-keys it
(``test_sequence_sharding_rekeys_jit_cache``) has no counterpart here:
the forwards read the policy when they run.
"""

import contextlib
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

from imagecaptioner_tpu_torch.core import config as PC
from imagecaptioner_tpu_torch.core import mesh as MS
from imagecaptioner_tpu_torch.core import modules as PM
from imagecaptioner_tpu_torch.data import transforms as PT
from imagecaptioner_tpu_torch.distill.losses import LOSS_NAMES
from imagecaptioner_tpu_torch.distill.projector import (
    create_feature_projectors, make_projectors)
from imagecaptioner_tpu_torch.distill.wrapper import (cast_teacher,
                                                      teacher_forward_for_kd)
from imagecaptioner_tpu_torch.models import teacher as PTM
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.ops import attention as PA
from imagecaptioner_tpu_torch.parallel import multihost as MH
from imagecaptioner_tpu_torch.parallel import sp, tp
from imagecaptioner_tpu_torch.train import common
from imagecaptioner_tpu_torch.train import steps as PS
from imagecaptioner_tpu_torch.utils import convert as CV

D, M = 2, 2                    # the mesh: data x model
JOIN_S = 240                   # the join's own deadline under the suite's load
# JAX's test configuration (tests/test_sharding.py:120-124), B=4, T=6
TCFG = dict(vocab_size=64, embed_size=32, num_heads=4, num_decoder_layers=2,
            dropout=0.0, encoder_dim=24, encoder_depth=2, encoder_heads=3,
            image_size=32, patch_size=16)
TB, TT = 4, 6
MODES = ("tp", "sp", "tpsp")
# the KD step: V=31 (16 + 15 over the model axis), 17 ViT tokens (9 + 8),
# 7 caption positions (4 + 3), 3 ViT heads (2 + 1); B=2 rows a data index
V, E, H, S, TCAP, BR = 31, 16, 24, 64, 8, 2
KCFG = dict(vocab_size=V, embed_size=32, num_heads=4, num_decoder_layers=1,
            dropout=0.15, encoder_dim=24, encoder_depth=1, encoder_heads=3,
            patch_size=16, image_size=S)
SCHED_T = 0.25


def _teacher(cfg_kw, seed=0):
    cfg = PC.TeacherConfig(**cfg_kw)
    teacher = PTM.Teacher(cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(
        PTM.teacher_init(seed, cfg)), strict=True)
    return teacher.eval(), cfg


def _teacher_inputs():
    rng = np.random.default_rng(1)
    return (rng.standard_normal((TB, 3, 32, 32)).astype(np.float32),
            rng.integers(0, TCFG["vocab_size"], (TT, TB)).astype(np.int64))


def _kd_cfgs():
    return (PC.TeacherConfig(**KCFG),
            PC.full_student_config(V, embed_size=E, hidden_size=H,
                                   dropout=0.0))


def _kd_trees():
    t_cfg, s_cfg = _kd_cfgs()
    proj, _ = create_feature_projectors(
        2, teacher_embed=32, student_embed=E, student_hidden=H,
        student_seq_len=49, teacher_seq_len=t_cfg.num_tokens)
    return (PTM.teacher_init(3, t_cfg),) + tuple(student_init(4, s_cfg)) \
        + (proj,)


def _kd_batch():
    """One micro-batch of 4 rows; the data blocks' longest captions
    differ, so a max(lengths) over the wrong group shows."""
    rng = np.random.default_rng(5)
    B = BR * D
    caps = np.zeros((1, TCAP, B), np.int32)
    lengths = np.array([[4, 5, TCAP, 6]], np.int32)
    for b in range(B):
        n = lengths[0, b]
        caps[0, :n, b] = [1] + list(rng.integers(4, V, n - 2)) + [2]
    return {"images": rng.integers(0, 256, (1, B, S, S, 3), dtype=np.uint8),
            "captions": caps, "lengths": lengths}


def _kd_step(batch, mesh=None, dp_batch_norm=False):
    """One KD step from the seeded trees on ``batch`` (this rank's rows),
    the teacher placed and run inside the sequence policy with a ``mesh``;
    everything the tests compare, as numpy.  ``dp_batch_norm``: one process
    with the data-parallel batch norm's arithmetic, as in
    ``tests/test_torch_port_data_parallel.py``."""
    if dp_batch_norm:
        real = PM.MS
        PM.MS = types.SimpleNamespace(data_size=lambda: D,
                                      psum_over_data=lambda x: x)
        try:
            return _kd_step(batch)
        finally:
            PM.MS = real
    t_cfg, s_cfg = _kd_cfgs()
    t_tree, s_params, s_state, proj = _kd_trees()
    teacher = PTM.Teacher(t_cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(t_tree), strict=True)
    student = Student(s_cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(
        s_params, s_state, s_cfg), strict=True)
    projectors = make_projectors(32, E, H)
    projectors.load_state_dict(CV.jax_projectors_to_state_dict(proj),
                               strict=True)
    teacher.eval()
    policy = contextlib.nullcontext()
    if mesh is not None:
        tp.place_teacher_tp(mesh, teacher, t_cfg)
        policy = sp.sequence_sharding(mesh)
    state = PS.init_train_state(student, projectors, s_cfg)
    out = {f"start.{n}": p.detach().numpy().copy()
           for n, p in state.named_parameters().items()}
    kd = PS.make_kd_train_step(teacher, t_cfg, s_cfg, PC.DistillConfig(),
                               PC.KDTrainConfig(dropout=0.0),
                               aug=PT.AugmentConfig(),
                               compute_dtype=torch.float32)
    with PM.no_dropout(), policy:
        m = kd(state, PS.batch_to_device(batch, "cpu"), SCHED_T, None)
    out.update({f"metric.{k}": float(v) for k, v in m.items()})
    for n, p in state.named_parameters().items():
        out[f"param.{n}"] = p.detach().numpy().copy()
        out[f"mu.{n}"] = state.opt_state.mu[n].numpy().copy()
    for n, t in state.student.named_buffers():
        out[f"buffer.{n}"] = t.numpy().copy()
    return out


def _rank_main(out: str, device: str = "cpu"):
    """One rank of the (2, 2) world: its data block through the teacher
    under TP, SP and both (float32, and the TP+SP teacher cast to bf16),
    the refusals of a frozen teacher's training use, the attention cores
    it called, and one KD step."""
    torch.set_num_threads(1)
    mesh = MS.create_mesh(device, shape=(D, M))
    res = {"index": np.array([mesh.data_index, mesh.model_index]),
           "seed": np.array([common.rank_seed(7, mesh)]),
           "host_shard": MH.host_shard(10),
           "data_size": np.array([MS.data_size()])}
    images, captions = _teacher_inputs()
    rows = slice(mesh.data_index * TB // D, (mesh.data_index + 1) * TB // D)
    img = torch.from_numpy(images[rows])
    cap = torch.from_numpy(captions[:, rows])
    seen = []
    real = PA.attention_core_plain

    def attn(q, k, v, **kw):
        seen.append(q.shape[2:3] + k.shape[1:3] + (kw.get("causal", False),
                                                   kw.get("q_offset", 0)))
        return real(q, k, v, **kw)

    PA.attention_core_plain = attn
    try:
        for mode in MODES:
            teacher, cfg = _teacher(TCFG)
            if "tp" in mode:
                tp.place_teacher_tp(mesh, teacher, cfg)
            policy = (sp.sequence_sharding(mesh) if "sp" in mode
                      else contextlib.nullcontext())
            seen.clear()
            with policy:
                got = teacher_forward_for_kd(teacher, img, cap)
                res[f"{mode}.logits"] = got["logits"].numpy()
                res[f"{mode}.memory"] = got["encoder_features"].numpy()
                res[f"{mode}.seen"] = np.array(seen)
                if mode == "tpsp":
                    got = teacher_forward_for_kd(
                        cast_teacher(teacher, torch.bfloat16), img, cap,
                        compute_dtype=torch.bfloat16)
                    res["bf16.logits"] = got["logits"].numpy()
                    refused = []
                    for how in ("grad", "train"):
                        try:
                            if how == "grad":
                                teacher(img, cap)
                            else:
                                with torch.no_grad():
                                    teacher.train()(img, cap)
                        except RuntimeError as e:
                            refused.append("frozen teacher" in str(e))
                        teacher.eval()
                    res["refused"] = np.array(refused)
    finally:
        PA.attention_core_plain = real
    local = common.put_global_batch(dataclasses.replace(mesh, split=True),
                                    _kd_batch())
    res.update(_kd_step({k: v.numpy() for k, v in local.items()}, mesh))
    np.savez(os.path.join(out, f"rank{mesh.rank}.npz"), **res)


class _threads:
    """Two intra-op threads for the parent's heavy CPU section."""

    def __enter__(self):
        self.old = torch.get_num_threads()
        torch.set_num_threads(2)

    def __exit__(self, *exc):
        torch.set_num_threads(self.old)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks' results, and one process's KD step on the global
    batch (stock, and with the data-parallel batch norm's arithmetic)."""
    tmp = tmp_path_factory.mktemp("tp_world")
    MH.launch(_rank_main, ["cpu"] * (D * M), kwargs=dict(out=str(tmp)),
              in_parent=False, timeout_s=60, join_timeout_s=JOIN_S,
              init_file=str(tmp / "store"))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(D * M)]
    with _threads():
        one = _kd_step(_kd_batch())
        same = _kd_step(_kd_batch(), dp_batch_norm=True)
    return ranks, one, same


@pytest.fixture(scope="module")
def jax_teacher():
    """JAX's replicated ``teacher_apply`` on the port's seeded tree: the
    logits and the memory."""
    import jax
    import jax.numpy as jnp

    from imagecaptioner_tpu.core.config import TeacherConfig as JTC
    from imagecaptioner_tpu.models import teacher as JTM

    cfg = JTC(**TCFG)
    params = jax.tree.map(jnp.asarray, PTM.teacher_init(0, PC.TeacherConfig(
        **TCFG)))
    images, captions = (jnp.asarray(a) for a in _teacher_inputs())
    logits, memory = jax.jit(lambda p: (
        JTM.teacher_apply(p, images, captions.astype(jnp.int32), cfg),
        JTM.encode_image(p, images, cfg)))(params)
    return np.asarray(logits), np.asarray(memory)


def _rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


@pytest.mark.parametrize("mode", MODES)
def test_teacher_matches_jax_replicated(world, jax_teacher, mode):
    """Each rank's logits (T, its rows, V) and memory (its rows, tokens, E)
    under TP, SP and both equal JAX's replicated teacher on those rows to
    JAX's own 2e-5 (``test_sharding.py``), with 3 ViT heads over a model
    axis of 2 and 5 ViT tokens cut 3 + 2."""
    logits, memory = jax_teacher
    for r in world[0]:
        rows = slice(r["index"][0] * TB // D, (r["index"][0] + 1) * TB // D)
        np.testing.assert_allclose(r[f"{mode}.logits"], logits[:, rows],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r[f"{mode}.memory"], memory[rows],
                                   rtol=2e-5, atol=2e-5)


def test_model_ranks_hold_the_same_whole_outputs(world):
    """The two model ranks of one data index get the same whole logits and
    memory, bit for bit, in every mode; a bf16 teacher (``cast_teacher`` of
    the placed one) stays within bf16's 2e-2 of the float32 logits."""
    ranks = world[0]
    for a, b in ((0, 1), (2, 3)):
        assert ranks[a]["index"][0] == ranks[b]["index"][0]
        for mode in MODES:
            for what in ("logits", "memory"):
                key = f"{mode}.{what}"
                assert ranks[a][key].shape == (
                    (TT, TB // D, TCFG["vocab_size"]) if what == "logits"
                    else (TB // D, 5, TCFG["embed_size"]))
                np.testing.assert_array_equal(ranks[a][key], ranks[b][key])
        np.testing.assert_array_equal(ranks[a]["bf16.logits"],
                                      ranks[b]["bf16.logits"])
    for r in ranks:
        ref = r["tpsp.logits"]
        assert np.abs(r["bf16.logits"] - ref).max() \
            <= 2e-2 * np.abs(ref).max()


def test_ranks_run_the_attention_core_at_their_shapes(world):
    """Kernel #2's calls on each rank (q rows, heads, keys, causal,
    q_offset): TP on the rank's heads (2 + 1 ViT heads, 2 decoder heads)
    over whole sequences; SP alone with all heads, the rank's rows against
    all keys, and the caption stream's causal form at the rank's offset
    (rows 0-2 of 6 at offset 0, rows 3-5 at offset 3)."""
    for r in world[0]:
        mi = r["index"][1]
        vit_heads = 2 if mi == 0 else 1
        vit_rows = 3 if mi == 0 else 2
        assert sorted(map(tuple, r["tp.seen"].tolist())) == sorted(
            [(5, vit_heads, 5, 0, 0)] * 2 + [(6, 2, 6, 1, 0)] * 2
            + [(6, 2, 5, 0, 0)] * 2)
        assert sorted(map(tuple, r["tpsp.seen"].tolist())) \
            == sorted(map(tuple, r["tp.seen"].tolist()))
        assert sorted(map(tuple, r["sp.seen"].tolist())) == sorted(
            [(vit_rows, 3, 5, 0, 0)] * 2 + [(3, 4, 6, 1, 3 * mi)] * 2
            + [(3, 4, 5, 0, 0)] * 2)


def test_placed_teacher_refuses_gradients_and_train_mode(world):
    """The placed teacher is the KD step's frozen teacher: a forward with
    gradients on, or in train mode, raises and says so."""
    for r in world[0]:
        assert r["refused"].tolist() == [True, True]


def test_world_layout_and_data_axis(world):
    """Rank r sits at (r // 2, r % 2); the data axis has 2 ranks; the model
    ranks of one data index share a seed and their ``host_shard`` rows."""
    for rank, r in enumerate(world[0]):
        assert r["index"].tolist() == [rank // M, rank % M]
        assert int(r["data_size"][0]) == D
        assert int(r["seed"][0]) == 7 + 1_000_003 * (rank // M)
        np.testing.assert_array_equal(r["host_shard"], MH.host_shard(
            10, process_index=rank // M, process_count=D))


def test_kd_step_matches_one_process(world):
    """The DP x TP x SP step's loss terms and gradient norm on every rank
    equal one process's with the unsharded teacher on the global batch, with
    the data-parallel batch norm's arithmetic and with ``F.batch_norm``'s:
    the loss terms to 5e-5 relative, the gradient norm to 5e-4
    (``test_torch_port_data_parallel.py``'s bounds across arithmetics: the
    teacher's row-parallel sums and gathers round otherwise than one
    product, and the feature term's squared difference and the train-mode
    ResNet amplify that; measured 3.6e-6 and 9.2e-6)."""
    ranks, one, same = world
    for r in ranks:
        for ref in (one, same):
            for k in LOSS_NAMES:
                np.testing.assert_allclose(r[f"metric.{k}"],
                                           ref[f"metric.{k}"], rtol=5e-5,
                                           atol=1e-7, err_msg=k)
            np.testing.assert_allclose(r["metric.grad_norm"],
                                       ref["metric.grad_norm"], rtol=5e-4)
            assert r["metric.lr"] == ref["metric.lr"]
    assert one["metric.token_kd_loss"] > 0 and one["metric.grad_norm"] > 1.0


def test_kd_step_updates_every_parameter_alike(world):
    """Every rank's step against the same-arithmetic process's, with the
    bounds ``chip_smoke.py``'s data-parallel phase sets for a step whose
    arithmetic differs: updated parameters that start non-zero 1e-4
    relative in L2 (the ResNet's 1e-3), those that start at zero within one
    AdamW step an entry, frozen ones unmoved; the gradients (first moment x
    gradient norm) outside the ResNet to 2e-4 of each leaf's largest
    entry, the ResNet's each 10% in L2 (``test_torch_port_data_parallel``);
    the running statistics 1e-4."""
    ranks, _, same = world
    lr = PC.KDTrainConfig().learning_rate
    names = [k[len("param."):] for k in same if k.startswith("param.")]
    assert any(".resnet.layer4." in k for k in names)
    for r in ranks:
        for n in names:
            p, ref, start = r[f"param.{n}"], same[f"param.{n}"], \
                same[f"start.{n}"]
            mu, mu_ref = r[f"mu.{n}"], same[f"mu.{n}"]
            np.testing.assert_array_equal(r[f"start.{n}"], start, err_msg=n)
            if not mu_ref.any() and not mu.any():  # frozen, or decay alone
                np.testing.assert_array_equal(p, ref, err_msg=n)
                continue
            if start.any():
                limit = 1e-3 if ".resnet." in n else 1e-4
                assert _rel(p, ref) <= limit, (n, _rel(p, ref))
            else:
                assert np.abs(p - ref).max() <= 2.01 * lr, n
            g = mu * float(r["metric.grad_norm"])
            g_ref = mu_ref * float(same["metric.grad_norm"])
            if ".resnet." in n:
                assert (np.linalg.norm(g - g_ref)
                        <= 0.1 * np.linalg.norm(g_ref) + 1e-12), n
            else:
                np.testing.assert_allclose(
                    g, g_ref, atol=2e-4 * np.abs(g_ref).max()
                    + 1e-9 * float(same["metric.grad_norm"]), rtol=0,
                    err_msg=n)
        for k in (k for k in same if k.startswith("buffer.")
                  and "running" in k):
            assert _rel(r[k], same[k]) <= 1e-4, k


def test_kd_step_replicas_are_identical_across_the_model_axis(world):
    """The student and projector replicas of one data index are bit for bit
    the same after the step: same rows, same draws, the same whole teacher
    outputs, gradients summed over the data group only."""
    ranks = world[0]
    keys = [k for k in ranks[0] if k.startswith(("param.", "mu.", "buffer.",
                                                 "metric."))]
    for a, b in ((0, 1), (2, 3)):
        for k in keys:
            np.testing.assert_array_equal(ranks[a][k], ranks[b][k],
                                          err_msg=k)
    assert sum(not np.array_equal(ranks[0][f"param.{n}"],
                                  ranks[0][f"start.{n}"])
               for n in (k[len("param."):] for k in keys
                         if k.startswith("param."))) > 100


def test_kd_step_matches_jax_single_device(world):
    """Rank 0's step against the JAX package's single-device step on the
    global batch, with ``test_torch_port_data_parallel.py``'s tolerances:
    loss terms 1e-5 absolute (the ResNet-fed feature term and the total
    5e-5), the gradient norm 5e-3 relative, each leaf's gradient 2e-4 of
    its largest entry with an absolute floor of 1e-9 of the gradient's
    norm (the decoder's attention, whose gradient is 1e-6 of it), the
    ResNet's leaves 10% in L2."""
    import jax
    import jax.numpy as jnp

    from imagecaptioner_tpu.core import modules as JM
    from imagecaptioner_tpu.core.config import (
        DistillConfig as JDistillConfig, KDTrainConfig as JKDTrainConfig,
        TeacherConfig as JTeacherConfig, full_student_config as j_full)
    from imagecaptioner_tpu.data import transforms as JT
    from imagecaptioner_tpu.train import optim as JO
    from imagecaptioner_tpu.train import steps as JS

    t_tree, s_params, s_state, proj = _kd_trees()
    mp = pytest.MonkeyPatch()
    mp.setattr(JM, "dropout", lambda rng, x, rate, train: x)
    try:
        tree = jax.tree.map(jnp.asarray, (t_tree, {
            "student": s_params, "projectors": proj}, s_state))
        params = tree[1]
        jstep = JS.make_kd_train_step(
            JTeacherConfig(**KCFG),
            j_full(V, embed_size=E, hidden_size=H, dropout=0.0),
            JDistillConfig(), JKDTrainConfig(dropout=0.0),
            aug=JT.AugmentConfig(), compute_dtype=jnp.float32)
        jstate = JS.TrainState(params, jax.jit(JO.adamw_init)(params),
                               tree[2])
        jstate, jm = jstep(jstate, tree[0], {
            k: jnp.asarray(v) for k, v in _kd_batch().items()},
            jnp.float32(SCHED_T), jnp.int32(0), jax.random.PRNGKey(1))
        mu = {f"mu.{k}": np.asarray(v) for k, v in CV.tree_to_state_dict(
            jax.tree.map(np.asarray, jstate.opt_state.mu)).items()}
        jm = {k: float(v) for k, v in jm.items()}
    finally:
        mp.undo()
    got = world[0][0]
    for k in LOSS_NAMES:
        np.testing.assert_allclose(got[f"metric.{k}"], jm[k], rtol=0,
                                   atol=5e-5 if k in ("feature_kd_loss",
                                                      "total_loss") else 1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(got["metric.grad_norm"], jm["grad_norm"],
                               rtol=5e-3)
    n_ref, n_got = jm["grad_norm"], float(got["metric.grad_norm"])
    assert n_ref > 1.0 and n_got > 1.0
    assert set(mu) == {k for k in got if k.startswith("mu.")}
    for k, ref in mu.items():
        g_ref, g_got = ref * n_ref, got[k] * n_got
        if ".resnet." in k:
            assert (np.linalg.norm(g_got - g_ref)
                    <= 0.1 * np.linalg.norm(g_ref) + 1e-9), k
        else:
            np.testing.assert_allclose(
                g_got, g_ref, atol=2e-4 * np.abs(g_ref).max() + 1e-9 * n_ref,
                rtol=0, err_msg=k)


# ---------------------------------------------------------------------------
# One process
# ---------------------------------------------------------------------------


def test_create_mesh_makes_each_rank_its_groups(monkeypatch):
    """A (2, 3) mesh in a monkeypatched world of 6: rank r at (r // 3,
    r % 3), as JAX's ``reshape(shape)`` lays devices out; every rank makes
    every group in one order (three data groups, then two model groups)
    and keeps its own; data x model off the world is refused."""
    import torch.distributed as dist

    made = []
    monkeypatch.setattr(dist, "new_group", lambda ranks: (made.append(ranks)
                                                          or tuple(ranks)))
    try:
        for rank in range(6):
            monkeypatch.setattr(MS, "world", lambda rank=rank: (rank, 6))
            made.clear()
            mesh = MS.create_mesh("cpu", shape=(2, 3))
            assert made == [[0, 3], [1, 4], [2, 5], [0, 1, 2], [3, 4, 5]]
            assert (mesh.data_index, mesh.model_index) == divmod(rank, 3)
            assert (mesh.data_size, mesh.model_size) == (2, 3)
            assert rank in mesh.data_group and rank in mesh.model_group
            assert len(mesh.data_group) == 2 and len(mesh.model_group) == 3
            assert MS.current_mesh() is mesh and MS.data_size() == 2
            assert MS.data_index() == rank // 3
        for shape in ((3, 3), (6, 2), (0, 6)):
            with pytest.raises(ValueError, match="processes"):
                MS.create_mesh("cpu", shape=shape)
        made.clear()
        assert MS.create_mesh("cpu").model_group is None and made == []
    finally:
        MS._MESH = None
    monkeypatch.undo()
    assert MS.current_mesh() is None and MS.data_size() == 1


def test_rank_seed_and_blocks_follow_the_data_index():
    """``rank_seed``, ``batch_block`` and ``put_global_batch`` read the
    data index: the model ranks of one data index draw and take alike."""
    x = np.arange(8 * 3).reshape(8, 3)
    for rank in range(6):
        mesh = MS.Mesh(rank, 6, torch.device("cpu"), split=True,
                       model_size=3)
        i = rank // 3
        assert common.rank_seed(5, mesh) == 5 + 1_000_003 * i
        assert common.is_primary(mesh) == (rank == 0)
        np.testing.assert_array_equal(MS.shard_batch(mesh, x),
                                      x[4 * i:4 * i + 4])
        got = common.put_global_batch(mesh, {"captions": x.T[None]})
        np.testing.assert_array_equal(got["captions"][0], x.T[:, 4 * i:
                                                              4 * i + 4])
    import copy

    assert copy.deepcopy({"m": mesh})["m"] is mesh


@pytest.mark.parametrize("n,m,sizes", [(197, 2, [99, 98]), (47, 2, [24, 23]),
                                       (5, 2, [3, 2]), (6, 4, [2, 2, 2, 0]),
                                       (7, 1, [7])])
def test_sequence_blocks(n, m, sizes):
    """A token axis of n cut into blocks of ceil(n / m), the last shorter
    or empty; ``shard_seq`` is the identity without a policy and the
    rank's block under it."""
    x = torch.arange(3 * n).reshape(3, n)
    assert sp.shard_seq(x, 1) is x and not sp.active()
    for j in range(m):
        mesh = MS.Mesh(j, m, torch.device("cpu"), model_size=m)
        assert sp.block_sizes(n, mesh) == sizes
        with sp.sequence_sharding(mesh):
            assert sp.active()
            first, rows = sp.local_rows(n)
            assert (first, rows) == (sum(sizes[:j]), sizes[j])
            np.testing.assert_array_equal(sp.shard_seq(x, 1),
                                          x[:, first:first + rows])
    assert not sp.active()
    with pytest.raises(ValueError, match="model"):
        with sp.sequence_sharding(mesh, axis="data"):
            pass


def test_packed_projections_split_by_whole_heads():
    """The q, k and v rows of each rank's heads (3 heads of 8 over 2 ranks:
    heads 0-1 and 2), never contiguous blocks of the packed rows; the
    table of splits is JAX's ``teacher_tp_shardings``."""
    dim = 24
    r0 = tp.packed_rows(dim, 3, MS.Mesh(0, 2, torch.device("cpu"),
                                        model_size=2))
    r1 = tp.packed_rows(dim, 3, MS.Mesh(1, 2, torch.device("cpu"),
                                        model_size=2))
    assert r0.tolist() == list(range(16)) + list(range(24, 40)) \
        + list(range(48, 64))
    assert r1.tolist() == list(range(16, 24)) + list(range(40, 48)) \
        + list(range(64, 72))
    assert MS.split_sizes(2994, 4) == [749, 749, 748, 748]


def test_tp_shardings_table_matches_jax():
    """Each leaf's split (output rows, input columns, vocabulary rows,
    replicated) is the one JAX's ``teacher_tp_shardings`` gives it."""
    import jax
    from jax.sharding import PartitionSpec as P

    from imagecaptioner_tpu.core import mesh as JMS
    from imagecaptioner_tpu.core.config import TeacherConfig as JTC
    from imagecaptioner_tpu.parallel import tp as JTP

    teacher, cfg = _teacher(TCFG)
    tree = PTM.teacher_init(0, cfg)
    mesh = JMS.create_mesh(jax.devices()[:4], shape=(2, 2))
    specs = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}.{i}")
        else:
            specs[path] = node.spec

    walk(JTP.teacher_tp_shardings(mesh, tree, JTC(**TCFG)), "")
    want = {P(): "replicated", P("model"): "out", P("model", None): "out",
            P(None, "model"): "in"}
    ours = tp.teacher_tp_shardings(teacher)
    assert set(ours) == set(specs)
    for name, spec in specs.items():
        how = want[spec]
        if name.startswith(("embedding.", "fc_out.")):
            how = "vocab"
        assert ours[name] == how, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Lq,Lk,o", [(24, 47, 0), (23, 47, 24), (3, 6, 3),
                                     (47, 47, 0), (1, 5, 4)])
def test_attention_core_q_offset_is_the_full_causal_rows(dtype, Lq, Lk, o):
    """The causal core of a block of query rows at offset o against all
    keys equals rows [o, o + Lq) of the full-length causal core, in the
    plain version and in the kernel's CPU mirror
    (``attention_core_two_pass``): the same masked sums, which the CPU's
    products may block otherwise for another row count, so within 1e-6
    (bf16: one bf16 step of 2^-7 relative, the probabilities' rounding).
    The kernel's rows are bit-identical on the card (``chip_smoke.py``
    17c), where a row's sums do not depend on the rows beside it."""
    g = torch.Generator().manual_seed(Lq * 100 + Lk)
    q, k, v = (torch.randn((2, 3, Lk, 64), generator=g).to(dtype)
               for _ in range(3))
    full = PA.attention_core_plain(q, k, v, causal=True, scale=0.125)
    part = PA.attention_core_plain(q[:, :, o:o + Lq], k, v, causal=True,
                                   scale=0.125, q_offset=o)
    tol = dict(atol=1e-6, rtol=1e-6) if dtype == torch.float32 else \
        dict(atol=2 ** -7, rtol=2 ** -7)
    torch.testing.assert_close(part, full[:, :, o:o + Lq], **tol)
    two = PA.attention_core_two_pass(q, k, v, causal=True, scale=0.125)
    part2 = PA.attention_core_two_pass(q[:, :, o:o + Lq], k, v, causal=True,
                                       scale=0.125, q_offset=o)
    torch.testing.assert_close(part2, two[:, :, o:o + Lq], **tol)
    torch.testing.assert_close(part2, part, **tol)
