"""Teacher and KD train and eval steps (``imagecaptioner_tpu/train/
steps.py:59-189, 192-388, 438-467``), the optimized trainer's too.

A teacher train step is the JAX per-leaf path that ``train_teacher.train``
runs (it passes no fused optimizer): for each of the A micro-batches,
augment and normalize, run the teacher in train mode on ``captions[:-1]``,
take the label-smoothing loss against ``captions[1:]`` and its gradient;
then the mean gradient over the trainable parameters, the global-norm clip,
and AdamW with two learning-rate groups (every parameter whose name starts
with ``encoder``, ``encoder_projection`` included, at ``encoder_lr_scale``;
the rest at 1), each on its own cosine-warm-restarts schedule.

One KD train step = for each of the A stacked micro-batches: augment and
normalize on the device, run the frozen teacher and the student, take the
distillation loss and its gradient; then the mean of the A gradients, the
global-norm clip, and AdamW with the three learning-rate groups (student
encoder x ``encoder_lr_scale``; decoder; the others, refinement and
projectors, x ``others_scale``).  Batch-norm statistics thread through the
micro-batches in order, as the JAX step threads its state tree.  The
frozen teacher runs in float32, or under ``teacher_bf16`` as a copy whose
parameters are rounded to bf16 once a step, as JAX casts its tree.  With
``optimized=True`` (the optimized trainer) the loss is
``optimized_distillation_loss`` at the step's epoch, the schedule is
OneCycle over the optimizer step, and the others may decay at their own
rate.  Under a profiler the step is the span ``kd.step``, holding
``kd.augment``, ``kd.teacher``, ``kd.student``, ``kd.loss`` and
``kd.backward`` for each micro-batch and ``kd.optimizer`` once;
``batch_to_device`` is ``kd.feed`` (``core/spans.py``).

Batch layout (stacked for accumulation):
  images   uint8 (A, B, S, S, 3)  NHWC
  captions int   (A, T, B)        time-major
  lengths  int   (A, B)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from imagecaptioner_tpu_torch.core import mesh as MS
from imagecaptioner_tpu_torch.core.config import (DistillConfig,
                                                  OptimizedDistillConfig,
                                                  StudentConfig,
                                                  TeacherConfig,
                                                  TeacherTrainConfig)
from imagecaptioner_tpu_torch.core.precision import as_dtype
from imagecaptioner_tpu_torch.core.spans import span
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.distill import losses as DL
from imagecaptioner_tpu_torch.distill.wrapper import (cast_teacher,
                                                      teacher_forward_for_kd)
from imagecaptioner_tpu_torch.models.student import Student, set_trainable
from imagecaptioner_tpu_torch.models import teacher as TM
from imagecaptioner_tpu_torch.models.teacher import Teacher
from imagecaptioner_tpu_torch.train import optim as O
from imagecaptioner_tpu_torch.utils import convert as CV


# ---------------------------------------------------------------------------
# Teacher training
# ---------------------------------------------------------------------------


@dataclass
class TeacherTrainState:
    """What a teacher step updates in place: the teacher and the optimizer
    state."""
    teacher: Teacher
    opt_state: O.AdamWState

    def named_parameters(self) -> Dict[str, nn.Parameter]:
        return dict(self.teacher.named_parameters())


def init_teacher_train_state(teacher: Teacher, t_cfg: TeacherConfig
                             ) -> TeacherTrainState:
    """Mark what trains (``teacher_trainable_mask``) and start AdamW from
    zero moments (frozen parameters keep theirs at zero)."""
    TM.set_trainable(teacher, t_cfg)
    return TeacherTrainState(
        teacher, O.adamw_init(dict(teacher.named_parameters())))


def restore_adamw(opt_tree: Dict, named: Dict[str, torch.Tensor], device,
                  where: str = "checkpoint") -> O.AdamWState:
    """A checkpoint's ``optimizer_state_dict`` (JAX layout: ``step``, and
    ``mu``/``nu`` trees shaped like the parameters) -> an ``AdamWState``
    keyed like ``named``, moments on ``device`` in each parameter's
    dtype."""
    step, mu, nu = CV.jax_adamw_to_state(opt_tree, named)
    for n, p in named.items():
        if mu[n].shape != p.shape or nu[n].shape != p.shape:
            raise ValueError(f"{where}: optimizer moments of {n} have shape "
                             f"{tuple(mu[n].shape)}, the parameter "
                             f"{tuple(p.shape)}")
    return O.AdamWState(
        step=step,
        mu={n: t.to(device=device, dtype=named[n].dtype) for n, t in mu.items()},
        nu={n: t.to(device=device, dtype=named[n].dtype) for n, t in nu.items()})


def teacher_group_scales(names, *, encoder_scale: float = 0.1
                         ) -> Dict[str, float]:
    """Learning-rate scale per parameter: ``encoder_scale`` for every name
    that starts with ``encoder`` (``encoder_projection`` too), else 1."""
    return {n: encoder_scale if n.startswith("encoder") else 1.0
            for n in names}


def _lr_fn(tr_cfg, sched_t: float):
    """The learning rate of a group with base scale ``s`` at epoch time
    ``sched_t``: cosine warm restarts from ``lr * s`` down to the unscaled
    ``eta_min``, as the JAX steps build their per-leaf rates."""
    def lr_fn(scale: float) -> float:
        return O.cosine_warm_restarts(
            sched_t, base_lr=tr_cfg.learning_rate * scale,
            t0=tr_cfg.sched_t0, t_mult=tr_cfg.sched_t_mult,
            eta_min=tr_cfg.sched_eta_min)
    return lr_fn


def _onecycle_lr_fn(tr_cfg, sched_t: float, total_steps: int):
    """The optimized trainer's rate of a group with scale ``s`` at optimizer
    step ``sched_t``: OneCycle at ``max_lr = lr * s``, so its initial and
    final rates scale with ``s`` too."""
    def lr_fn(scale: float) -> float:
        return O.onecycle_lr(sched_t, max_lr=tr_cfg.learning_rate * scale,
                             total_steps=total_steps, pct_start=0.1,
                             div_factor=10.0, final_div_factor=100.0)
    return lr_fn


def _teacher_loss(teacher: Teacher, t_cfg: TeacherConfig,
                  tr_cfg: TeacherTrainConfig, images: torch.Tensor,
                  captions: torch.Tensor, lengths: torch.Tensor, *,
                  generator) -> torch.Tensor:
    logits = teacher(images, captions[:-1], generator=generator)
    return O.label_smoothing_loss(
        logits, captions[1:], num_classes=t_cfg.vocab_size,
        smoothing=tr_cfg.label_smoothing, lengths=lengths)


def make_teacher_train_step(t_cfg: TeacherConfig,
                            tr_cfg: TeacherTrainConfig, *,
                            aug: T.AugmentConfig = T.TEACHER_TRAIN_AUG,
                            compute_dtype=torch.float32):
    """Returns ``step(state, batch, sched_t, generator) -> metrics``; the
    state is updated in place.  ``metrics`` holds ``loss`` (mean over the
    micro-batches), ``grad_norm`` (before clipping) and ``lr`` as 0-d
    tensors on the device."""
    compute_dtype = as_dtype(compute_dtype)

    def step(state: TeacherTrainState, batch: Dict, sched_t: float,
             generator: Optional[torch.Generator]) -> Dict[str, torch.Tensor]:
        lr_fn = _lr_fn(tr_cfg, sched_t)
        params = state.named_parameters()
        trainable = {n: p.requires_grad for n, p in params.items()}
        scales = teacher_group_scales(params,
                                      encoder_scale=tr_cfg.encoder_lr_scale)
        state.teacher.train()
        for p in params.values():
            p.grad = None
        A = batch["images"].shape[0]
        loss_sum = None
        for a in range(A):
            images = T.augment_and_normalize(batch["images"][a], aug,
                                             generator, dtype=compute_dtype)
            loss = _teacher_loss(state.teacher, t_cfg, tr_cfg, images,
                                 batch["captions"][a], batch["lengths"][a],
                                 generator=generator)
            loss.backward()                  # .grad holds the running sum
            loss_sum = loss.detach() if loss_sum is None \
                else loss_sum + loss.detach()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items() if trainable[n]}
        torch._foreach_div_(list(grads.values()), float(A))
        MS.psum_tensors_(list(grads.values()))
        gnorm = O.clip_by_global_norm(grads, tr_cfg.grad_clip)
        O.adamw_update(grads, state.opt_state, params, lr_fn=lr_fn,
                       lr_scale=scales, weight_decay=tr_cfg.weight_decay,
                       trainable=trainable)
        return {"loss": MS.psum_over_data(loss_sum / A), "grad_norm": gnorm,
                "lr": torch.tensor(lr_fn(1.0), device=gnorm.device)}

    return step


def make_teacher_eval_step(t_cfg: TeacherConfig, tr_cfg: TeacherTrainConfig,
                           *, compute_dtype=torch.float32):
    """Returns ``step(teacher, batch) -> loss`` (0-d tensor) on one
    un-stacked batch, in eval mode and without gradients."""
    compute_dtype = as_dtype(compute_dtype)

    @torch.no_grad()
    def step(teacher: Teacher, batch: Dict) -> torch.Tensor:
        teacher.eval()
        images = T.normalize(batch["images"], dtype=compute_dtype)
        return MS.psum_over_data(_teacher_loss(
            teacher, t_cfg, tr_cfg, images, batch["captions"],
            batch["lengths"], generator=None))

    return step


# ---------------------------------------------------------------------------
# KD training
# ---------------------------------------------------------------------------


@dataclass
class TrainState:
    """What a KD step updates in place: the student (parameters and
    batch-norm statistics), the projectors and the optimizer state."""
    student: Student
    projectors: nn.ModuleDict
    opt_state: O.AdamWState

    def named_parameters(self) -> Dict[str, nn.Parameter]:
        """``student.*`` then ``projectors.*``, the JAX params tree's order."""
        out = {f"student.{k}": p for k, p in self.student.named_parameters()}
        out.update({f"projectors.{k}": p
                    for k, p in self.projectors.named_parameters()})
        return out


def init_train_state(student: Student, projectors: nn.ModuleDict,
                     s_cfg: StudentConfig) -> TrainState:
    """Mark what trains (``student_trainable_mask``; every projector
    parameter) and start AdamW from zero moments."""
    set_trainable(student, s_cfg)
    for p in projectors.parameters():
        p.requires_grad_(True)
    state = TrainState(student, projectors, None)
    state.opt_state = O.adamw_init(state.named_parameters())
    return state


def kd_group_scales(names, *, encoder_scale: float = 0.1,
                    others_scale: float = 1.0) -> Dict[str, float]:
    """Learning-rate scale per parameter: the student's encoder ->
    ``encoder_scale``, its decoder -> 1.0, the others (the refinement and
    the projectors) -> ``others_scale`` (1.5 in the optimized trainer)."""
    return {n: encoder_scale if n.startswith("student.encoder.")
            else 1.0 if n.startswith("student.decoder.") else others_scale
            for n in names}


def kd_weight_decays(names, *, weight_decay: float,
                     others_wd: Optional[float] = None):
    """Weight decay per parameter: ``weight_decay`` for all, or with
    ``others_wd`` (the optimized trainer) the student's encoder and decoder
    at ``weight_decay`` and the others at ``others_wd``."""
    if others_wd is None:
        return weight_decay
    return {n: weight_decay if n.startswith(("student.encoder.",
                                             "student.decoder."))
            else others_wd for n in names}


def world_sums(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """0-d metrics summed over a data-parallel world in one all-reduce:
    each rank's loss terms are its shares of the global batch's
    (``distill/losses.py``), so their sums are the global batch's.  The
    metrics themselves with no world."""
    if MS.data_size() == 1:
        return metrics
    keys = list(metrics)
    tot = MS.psum_over_data(torch.stack([metrics[k].float() for k in keys]))
    return dict(zip(keys, tot.unbind()))


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A loader batch (numpy or torch) as tensors on ``device``; captions
    and lengths as int64."""
    def put(x, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(x)) \
            if isinstance(x, np.ndarray) else x
        return t.to(device=device, dtype=dtype)
    with span("kd.feed"):
        return {"images": put(batch["images"]),
                "captions": put(batch["captions"], torch.long),
                "lengths": put(batch["lengths"], torch.long)}


def _kd_forward(teacher: Teacher, t_cfg: TeacherConfig, state: TrainState,
                s_cfg: StudentConfig, images: torch.Tensor,
                captions_in: torch.Tensor, *, generator, teacher_dtype):
    with span("kd.teacher"):
        teacher_out = teacher_forward_for_kd(teacher, images, captions_in,
                                             compute_dtype=teacher_dtype)
    with span("kd.student"):
        s_logits, s_feats, s_hiddens, _ = state.student(
            images, captions_in, generator=generator)
        projected = state.projectors["encoder"](
            teacher_out["encoder_features"], teacher_seq_len=t_cfg.num_tokens,
            student_seq_len=s_cfg.feature_tokens, generator=generator)
    student_out = {"logits": s_logits, "encoder_features": s_feats,
                   "hidden_states": s_hiddens}
    teacher_out = dict(teacher_out, encoder_features=projected,
                       hidden_states=None)
    return student_out, teacher_out


def _kd_loss(optimized: bool, d_cfg, student_out, teacher_out, targets,
             lengths, epoch: int):
    if optimized:
        return DL.optimized_distillation_loss(student_out, teacher_out,
                                              targets, d_cfg, epoch,
                                              lengths=lengths)
    return DL.distillation_loss(student_out, teacher_out, targets, d_cfg,
                                lengths=lengths)


def make_kd_train_step(teacher: Teacher, t_cfg: TeacherConfig,
                       s_cfg: StudentConfig, d_cfg: DistillConfig,
                       tr_cfg, *,
                       aug: T.AugmentConfig = T.KD_TRAIN_AUG,
                       compute_dtype=torch.float32, optimized: bool = False,
                       od_cfg: Optional[OptimizedDistillConfig] = None,
                       onecycle_total_steps: Optional[int] = None,
                       others_scale: float = 1.0,
                       others_wd: Optional[float] = None):
    """Returns ``step(state, batch, sched_t, generator, epoch=0) ->
    metrics``; the state is updated in place.  ``metrics`` holds the loss
    terms (mean over the micro-batches) and ``grad_norm`` (before clipping)
    as 0-d tensors on the device (fetching them is the caller's
    synchronisation point), and ``lr`` (the rate at scale 1) as a 0-d
    tensor on the host, where it is computed (no upload a step).  ``tr_cfg`` is a
    ``KDTrainConfig``, or with ``optimized=True`` an
    ``OptimizedKDTrainConfig``; then ``sched_t`` is the optimizer step of
    a OneCycle over ``onecycle_total_steps`` and ``epoch`` drives the loss's
    warmup.

    On a (data, model) world (``core/mesh.create_mesh(shape=(d, m))``) the
    ``teacher`` may be placed by ``parallel/tp.place_teacher_tp`` and the
    step called inside ``parallel/sp.sequence_sharding(mesh)``, as JAX's
    ``dryrun_multichip`` runs its step.  The student and the projectors are
    replicated over the model axis: every model rank of one data index
    takes the same rows and draws (``train/common.rank_seed``), the
    gradients, the loss normalizers and the metrics are summed over the
    data group only, and model index 0's summed gradients go to the other
    replicas (``core/mesh.agree_over_model_``: the card's atomic backward
    algorithms would leave them apart in their last bits), so the replicas
    stay bit for bit one student."""
    compute_dtype = as_dtype(compute_dtype)
    teacher_dtype = (torch.bfloat16 if getattr(tr_cfg, "teacher_bf16", False)
                     else torch.float32)
    loss_cfg = od_cfg if optimized else d_cfg
    cast = None          # the bf16 copy of the teacher, refilled every step

    def step(state: TrainState, batch: Dict, sched_t: float,
             generator: Optional[torch.Generator], epoch: int = 0
             ) -> Dict[str, torch.Tensor]:
        nonlocal cast
        with span("kd.step"):
            lr_fn = (_onecycle_lr_fn(tr_cfg, sched_t, onecycle_total_steps)
                     if optimized else _lr_fn(tr_cfg, sched_t))
            params = state.named_parameters()
            trainable = {n: p.requires_grad for n, p in params.items()}
            scales = kd_group_scales(params,
                                     encoder_scale=tr_cfg.encoder_lr_scale,
                                     others_scale=others_scale)
            frozen_teacher = teacher
            if teacher_dtype != torch.float32:
                # once a step, outside the micro-batches, as JAX casts
                cast = cast_teacher(teacher, teacher_dtype, into=cast)
                frozen_teacher = cast
            state.student.train()
            state.projectors.train()
            for p in params.values():
                p.grad = None
            A = batch["images"].shape[0]
            ld_sum = None
            for a in range(A):
                with span("kd.augment"):
                    images = T.augment_and_normalize(batch["images"][a], aug,
                                                     generator,
                                                     dtype=compute_dtype)
                captions = batch["captions"][a]
                student_out, teacher_out = _kd_forward(
                    frozen_teacher, t_cfg, state, s_cfg, images,
                    captions[:-1], generator=generator,
                    teacher_dtype=teacher_dtype)
                with span("kd.loss"):
                    loss, ld = _kd_loss(optimized, loss_cfg, student_out,
                                        teacher_out, captions[1:],
                                        batch["lengths"][a], epoch)
                with span("kd.backward"):
                    loss.backward()              # .grad holds the running sum
                ld = {k: v.detach() for k, v in ld.items()}
                ld_sum = ld if ld_sum is None else {k: ld_sum[k] + v
                                                    for k, v in ld.items()}
            with span("kd.optimizer"):
                # a trainable parameter the loss never reached (the `hidden`
                # projector) has a zero gradient and still decays, as in JAX
                grads = {n: p.grad if p.grad is not None
                         else torch.zeros_like(p)
                         for n, p in params.items() if trainable[n]}
                torch._foreach_div_(list(grads.values()), float(A))
                MS.psum_tensors_(list(grads.values()))
                MS.agree_over_model_(list(grads.values()))
                gnorm = O.clip_by_global_norm(grads, tr_cfg.grad_clip)
                O.adamw_update(grads, state.opt_state, params, lr_fn=lr_fn,
                               lr_scale=scales,
                               weight_decay=kd_weight_decays(
                                   params, weight_decay=tr_cfg.weight_decay,
                                   others_wd=others_wd),
                               trainable=trainable)
            metrics = world_sums({k: v / A for k, v in ld_sum.items()})
            metrics["grad_norm"] = gnorm
            metrics["lr"] = torch.tensor(lr_fn(1.0))
            return metrics

    return step


def make_device_data_step(train_step, chain_steps: int = 1, mesh=None):
    """Wrap a KD train step to take its batches from a device-resident
    dataset (``data/device_cache.DeviceDataset``) and to run
    ``chain_steps`` optimizer steps back to back (JAX
    ``steps.make_device_data_step``).

    The returned ``chained(state, data, idx_k, sched_t0, dsched, epoch,
    generator) -> metrics`` takes the dataset's ``arrays`` and a (K, A, B)
    int32 array of row indices, uploaded once: the only host-to-device
    traffic of the chain.  Step i gathers its batch on the card and runs at
    schedule time ``sched_t0 + dsched * i``, computed in float32 as JAX
    computes it on the device.  Every metric comes back stacked (K,): the
    loss terms and ``grad_norm`` on the device, ``lr`` on the host; nothing
    inside the chain waits for the card.  Capturing the chain as one CUDA
    graph is a later speed change.  With a ``mesh`` each rank gathers its
    part of each index batch (``device_cache.gather_batch``) and the steps'
    reductions run over the world."""
    from imagecaptioner_tpu_torch.data.device_cache import gather_batch

    K = max(1, chain_steps)

    def chained(state: TrainState, data: Dict[str, torch.Tensor], idx_k,
                sched_t0, dsched, epoch: int,
                generator: Optional[torch.Generator]
                ) -> Dict[str, torch.Tensor]:
        idx = torch.as_tensor(np.ascontiguousarray(idx_k, np.int32))
        if idx.dim() != 3 or idx.shape[0] != K:
            raise ValueError(f"idx_k must be ({K}, A, B), got "
                             f"{tuple(idx.shape)}")
        idx = idx.to(data["images"].device, non_blocking=True)
        ts = np.float32(sched_t0) + np.float32(dsched) * np.arange(
            K, dtype=np.float32)
        ms = []
        for i in range(K):
            b = gather_batch(data, idx[i], mesh)
            ms.append(train_step(state, {
                "images": b["images"], "captions": b["captions"].long(),
                "lengths": b["lengths"].long()}, float(ts[i]), generator,
                epoch))
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    return chained


def make_kd_eval_step(teacher: Teacher, t_cfg: TeacherConfig,
                      s_cfg: StudentConfig, d_cfg: DistillConfig, *,
                      compute_dtype=torch.float32, optimized: bool = False,
                      od_cfg: Optional[OptimizedDistillConfig] = None):
    """Returns ``step(state, batch, epoch=0) -> (loss, loss_dict, preds,
    cap_tgt)`` on one un-stacked batch, in eval mode and without gradients;
    the teacher computes in float32, as in the JAX eval step.  With
    ``optimized=True`` the loss is the optimized one at ``epoch``."""
    compute_dtype = as_dtype(compute_dtype)
    loss_cfg = od_cfg if optimized else d_cfg

    @torch.no_grad()
    def step(state: TrainState, batch: Dict, epoch: int = 0):
        state.student.eval()
        state.projectors.eval()
        images = T.normalize(batch["images"], dtype=compute_dtype)
        cap_in, cap_tgt = batch["captions"][:-1], batch["captions"][1:]
        student_out, teacher_out = _kd_forward(
            teacher, t_cfg, state, s_cfg, images, cap_in, generator=None,
            teacher_dtype=torch.float32)
        loss, ld = _kd_loss(optimized, loss_cfg, student_out, teacher_out,
                            cap_tgt, batch["lengths"], epoch)
        ld = world_sums(ld)
        preds = student_out["logits"].float().argmax(-1)
        return ld["total_loss"], ld, preds, cap_tgt

    return step
