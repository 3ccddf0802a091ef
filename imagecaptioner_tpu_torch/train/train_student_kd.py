"""KD entry point of the port (``imagecaptioner_tpu/train/train_student_kd.py``).

Trains a CNN-LSTM student (``--student full|compact|enhanced``) against a
frozen teacher checkpoint with the multi-level distillation loss.
Reference behaviors preserved: the hardcoded defaults (lr 2e-4, batch 16,
accumulation 2, ``num_epochs=1``), the preflight
``validate_distillation_setup``, three parameter groups (encoder x0.1 /
decoder / others), clip 1.0 over student and projectors, cosine warm
restarts stepped fractionally, validation every 2 epochs with monitoring
BLEU, best (written in the background) and final checkpoints with the
reference's logical keys (npz files that both packages'
``utils/checkpoint.py`` read), ``student_training_history.json``, resuming
from a checkpoint of either package (``resume_from``) and a per-step JSONL
log (``metrics_jsonl``).

Runs on ``device`` (default ``cuda``): without a card it raises, and only a
caller that asks for ``cpu`` gets the CPU.

``train_student_with_kd`` reads a CSV/image dataset (``data/loader.py``);
``train_student_with_kd_on_loaders`` takes ready loaders, and the CLI's
``--synthetic-grid N`` feeds it the in-memory grid task:

  python -m imagecaptioner_tpu_torch.train.train_student_kd \\
      --data-root data/flickr8k --teacher-checkpoint saved_models/best_teacher_model.npz \\
      --output-dir saved_models [--epochs 1] [--student full|compact|enhanced] \\
      [--resume-from saved_models/best_student_model.npz] \\
      [--metrics-jsonl metrics.jsonl] [--device cuda|cpu]

Data parallelism is on by default, as in the reference, and a no-op on one
card (``--no-data-parallel`` turns it off).  Over several cards the trainer
runs one process per card (``train/common.py``): in a world that the
environment (``IC_COORDINATOR``, ``IC_NUM_PROCESSES``, ``IC_PROCESS_ID``)
or the caller made, each process trains on its own rows
(``get_loader(host_shard=True)``); with no world and several cards visible
it starts one process per card itself, and the loader's batch is the global
batch.  Gradients, batch-norm statistics and loss normalizers are the
global batch's, so a step equals one process's step on it; only rank 0
writes checkpoints, the metric log and the history, and a resume loads on
every rank.
``--device-dataset`` (``device_dataset=True``) decodes the training rows
once into a ``data/device_cache.DeviceDataset`` on the device, gathers each
batch there from uploaded row indices, and runs full chunks of
``--stream-steps`` optimizer steps through one chained step function
(``steps.make_device_data_step``), a trailing partial chunk one step at a
time, with the metrics fetched once an epoch, as the JAX trainer does; its
batches are the host loader's for the same seed.  On the card each
variant's teacher-forced recurrence is its kernel: the JAX trainer's table
of per-variant decoder implementations is a TPU measurement and is not
carried over.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import defaultdict
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from imagecaptioner_tpu_torch.core import mesh as MS
from imagecaptioner_tpu_torch.core.config import (STUDENT_CONFIGS,
                                                  DistillConfig,
                                                  KDTrainConfig)
from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.core.precision import as_dtype
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.data.loader import get_loader
from imagecaptioner_tpu_torch.distill.projector import (
    create_feature_projectors, make_projectors)
from imagecaptioner_tpu_torch.distill.validate import validate_distillation_setup
from imagecaptioner_tpu_torch.eval.metrics import monitoring_bleu
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.models import teacher as TM
from imagecaptioner_tpu_torch.train import common, steps
from imagecaptioner_tpu_torch.utils import checkpoint as CKPT
from imagecaptioner_tpu_torch.utils import convert as CV
from imagecaptioner_tpu_torch.utils.logging import MetricLogger


def check_options(*, student_variant: str) -> None:
    """Refuse a bad option before any data or card is touched."""
    if student_variant not in STUDENT_CONFIGS:
        raise ValueError(f"unknown student_variant {student_variant!r}")


def load_teacher(teacher_checkpoint: str, vocab_size: int, device):
    """``models.teacher.load_teacher`` for the KD step: float32, and the
    checkpoint's vocabulary must be the data's."""
    teacher, cfg = TM.load_teacher(teacher_checkpoint, device)
    if cfg.vocab_size != vocab_size:
        raise ValueError(f"teacher vocabulary {cfg.vocab_size} != data "
                         f"vocabulary {vocab_size}")
    return teacher, cfg


def validate_student(eval_step, state, val_loader, vocab, device, *,
                     max_batches: int = 50, mesh=None):
    """Loss over at most ``max_batches`` batches, and monitoring BLEU on 2
    samples of each of the first 5.  With a ``mesh`` each batch is this
    rank's part of a global batch, the eval step's loss is the global
    batch's, and BLEU reads this rank's rows (rank 0's are the global
    batch's first)."""
    losses, bleus, n = [], [], 0
    for bi, batch in enumerate(val_loader):
        if bi >= max_batches:
            break
        batch = (steps.batch_to_device(batch, device) if mesh is None
                 else common.put_global_batch(mesh, batch, stacked=False))
        loss, _, preds, cap_tgt = eval_step(state, batch)
        b = int(preds.shape[1])
        if mesh is not None:
            b *= mesh.data_size             # the global batch's rows
        losses.append(float(loss) * b)
        n += b
        if bi < 5:
            preds, cap_tgt = preds.cpu().numpy(), cap_tgt.cpu().numpy()
            for i in range(min(2, b)):
                bleus.append(monitoring_bleu(preds[:, i],
                                                    cap_tgt[:, i], vocab))
    return (sum(losses) / max(n, 1),
            float(np.mean(bleus)) if bleus else 0.0)


def train_student_with_kd(
    data_root: str = "data/flickr8k",
    captions_file: Optional[str] = None,
    teacher_checkpoint: str = "saved_models/best_teacher_model.npz",
    output_dir: str = "saved_models",
    *,
    train_cfg: Optional[KDTrainConfig] = None,
    distill_cfg: Optional[DistillConfig] = None,
    num_epochs: Optional[int] = None,
    max_caption_len: int = 48,
    image_size: int = 224,
    compute_dtype=torch.bfloat16,
    seed: int = 0,
    max_steps_per_epoch: Optional[int] = None,
    resume_from: Optional[str] = None,
    data_parallel: bool = True,
    metrics_jsonl: Optional[str] = None,
    freeze_backbone: bool = True,
    use_attention_refinement: Optional[bool] = None,
    student_variant: str = "full",
    student_cfg_overrides: Optional[dict] = None,
    aug=None,
    device_dataset: bool = False,
    stream_steps: int = 8,
    verbose: bool = True,
    device="cuda",
):
    """Train from a CSV/image dataset under ``data_root`` (``captions_file``
    defaults to ``<data_root>/captions_clean.csv``): the train loader
    shuffled with ``seed``, the validation loader over the same rows in
    order, with the train vocabulary.  Returns ``(state, s_cfg, vocab)``."""
    call = dict(locals())
    check_options(student_variant=student_variant)
    tr = train_cfg or KDTrainConfig()
    n_cards = common.cards_to_spawn(min(tr.batch_size, 16), data_parallel,
                                    device)
    if n_cards:
        return common.run_per_card(train_student_with_kd, n_cards, call)
    common.distributed_init_from_env(device)
    resolve_device(device)
    captions_file = captions_file or os.path.join(data_root,
                                                  "captions_clean.csv")
    train_loader, dataset = get_loader(
        data_root, captions_file, batch_size=tr.batch_size,
        max_caption_len=max_caption_len, shuffle=True, seed=seed,
        image_size=image_size, host_shard=True)
    val_loader, _ = get_loader(
        data_root, captions_file, batch_size=tr.batch_size,
        max_caption_len=max_caption_len, shuffle=False, vocab=dataset.vocab,
        image_size=image_size, host_shard=True)
    return train_student_with_kd_on_loaders(
        train_loader, val_loader, dataset.vocab, teacher_checkpoint,
        output_dir, train_cfg=tr, distill_cfg=distill_cfg,
        num_epochs=num_epochs, compute_dtype=compute_dtype, seed=seed,
        max_steps_per_epoch=max_steps_per_epoch, resume_from=resume_from,
        data_parallel=data_parallel, metrics_jsonl=metrics_jsonl,
        freeze_backbone=freeze_backbone,
        use_attention_refinement=use_attention_refinement,
        student_variant=student_variant,
        student_cfg_overrides=student_cfg_overrides, aug=aug,
        device_dataset=device_dataset, stream_steps=stream_steps,
        verbose=verbose, device=device)


def resume_train_state(state: steps.TrainState, path: str,
                       s_cfg, device) -> dict:
    """Load a KD checkpoint of either package into ``state`` in place: the
    student's parameters and batch-norm statistics, the projectors, the
    AdamW step and moments.  Returns the checkpoint (its ``epoch`` + 1 is
    the epoch to start from)."""
    ck = CKPT.load_checkpoint(path)
    sd = ck["student_state_dict"]
    state.student.load_state_dict(CV.jax_student_to_state_dict(
        sd["params"], sd["model_state"], s_cfg), strict=True)
    state.projectors.load_state_dict(
        CV.jax_projectors_to_state_dict(ck["projectors_state_dict"]),
        strict=True)
    state.opt_state = steps.restore_adamw(ck["optimizer_state_dict"],
                                          state.named_parameters(), device,
                                          path)
    return ck


def make_student_and_projectors(s_cfg, t_cfg, seed: int, device):
    """The student from ``student_init(seed)`` and the feature projectors
    from ``seed + 1``, both on ``device``, in the JAX trees' layouts."""
    s_params, s_state = student_init(seed, s_cfg)
    student = Student(s_cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(s_params, s_state,
                                                         s_cfg), strict=True)
    proj_params, _ = create_feature_projectors(
        seed + 1, teacher_embed=t_cfg.embed_size,
        student_embed=s_cfg.embed_size, student_hidden=s_cfg.hidden_size,
        student_seq_len=s_cfg.feature_tokens,
        teacher_seq_len=t_cfg.num_tokens)
    projectors = make_projectors(t_cfg.embed_size, s_cfg.embed_size,
                                 s_cfg.hidden_size)
    projectors.load_state_dict(CV.jax_projectors_to_state_dict(proj_params),
                               strict=True)
    return student.to(device), projectors.to(device)


def kd_checkpoint_tree(state: steps.TrainState, s_cfg, vocab_size: int,
                       epoch: int, d_cfg, **extra) -> dict:
    """A KD checkpoint in the JAX trainers' schema: the student's trees,
    the projectors, AdamW's step and moments as ``{"student",
    "projectors"}`` trees, the model and distillation configs, and
    ``extra`` (the scheduler's state, metrics)."""
    params, model_state = CV.student_to_jax_trees(state.student)
    names = list(state.projectors)

    def moments(m):
        sd = {n: m[n] for n in state.named_parameters()}
        pre = "projectors."
        return dict(CV.state_dict_to_tree(
            {n: v for n, v in sd.items() if not n.startswith(pre)}),
            projectors=CV.projectors_to_tree(
                {n[len(pre):]: v for n, v in sd.items()
                 if n.startswith(pre)}, names))

    return dict(
        epoch=epoch,
        student_state_dict=dict(params=params, model_state=model_state),
        projectors_state_dict=CV.projectors_to_tree(
            dict(state.projectors.named_parameters()), names),
        optimizer_state_dict=dict(
            step=np.asarray(state.opt_state.step, np.int32),
            mu=moments(state.opt_state.mu), nu=moments(state.opt_state.nu)),
        vocab_size=vocab_size,
        model_config=dict(
            embed_size=s_cfg.embed_size, hidden_size=s_cfg.hidden_size,
            num_layers=s_cfg.num_layers, dropout=s_cfg.dropout,
            use_attention_refinement=s_cfg.use_attention_refinement,
            model_type=s_cfg.variant),
        distillation_config=dict(alpha=d_cfg.alpha, beta=d_cfg.beta,
                                 gamma=d_cfg.gamma,
                                 temperature=d_cfg.temperature),
        **extra)


def make_device_dataset(train_loader, train_step, stream_steps: int,
                        seed: int, device, verbose: bool, mesh=None):
    """The train loader's rows on the device, seeded with ``seed``, and the
    chained step functions over it: ``(data, K-step, 1-step)``.  With a
    ``mesh`` each rank holds its loader's rows and gathers its part of each
    index batch (``device_cache.gather_batch``)."""
    from imagecaptioner_tpu_torch.data.device_cache import DeviceDataset

    dataset = getattr(train_loader, "dataset", None)
    if dataset is None:
        raise ValueError("device_dataset=True needs a train loader with a "
                         "dataset (data/loader.BatchLoader)")
    data = DeviceDataset(dataset, max_caption_len=train_loader.max_caption_len,
                         device=device)
    data.seed(seed)
    dd_step = steps.make_device_data_step(train_step, stream_steps, mesh)
    dd_step1 = (dd_step if stream_steps == 1
                else steps.make_device_data_step(train_step, 1, mesh))
    if verbose:
        print(f"[device-data] {data.n} rows resident on device; "
              f"{stream_steps} chained steps/dispatch")
    return data, dd_step, dd_step1


def run_device_epoch(data, dd_step, dd_step1, stream_steps: int, state,
                     batch_size: int, accumulation_steps: int,
                     max_steps_per_epoch: Optional[int], generator,
                     epoch: int, sched) -> list:
    """One epoch of the device-resident path: full chunks of
    ``stream_steps`` steps through ``dd_step``, a trailing partial chunk
    one step at a time through ``dd_step1``.  ``sched(s)`` gives the
    float32 ``(sched_t0, dsched)`` of the chunk starting at step ``s``.
    Returns the chunks' stacked metrics, unfetched."""
    idx_all = data.epoch_indices(batch_size=batch_size,
                                 accumulation_steps=accumulation_steps)
    n_steps = idx_all.shape[0]
    if max_steps_per_epoch is not None:
        n_steps = min(n_steps, max_steps_per_epoch)
    out, s = [], 0
    while s < n_steps:
        fn, span = ((dd_step, stream_steps)
                    if n_steps - s >= stream_steps else (dd_step1, 1))
        t0, dt = sched(s)
        out.append(fn(state, data.arrays, idx_all[s:s + span], t0, dt,
                      epoch, generator))
        s += span
    return out


def train_student_with_kd_on_loaders(
    train_loader,
    val_loader,
    vocab,
    teacher_checkpoint: str = "saved_models/best_teacher_model.npz",
    output_dir: str = "saved_models",
    *,
    train_cfg: Optional[KDTrainConfig] = None,
    distill_cfg: Optional[DistillConfig] = None,
    num_epochs: Optional[int] = None,
    compute_dtype=torch.bfloat16,
    seed: int = 0,
    max_steps_per_epoch: Optional[int] = None,
    resume_from: Optional[str] = None,
    data_parallel: bool = True,
    metrics_jsonl: Optional[str] = None,
    freeze_backbone: bool = True,
    use_attention_refinement: Optional[bool] = None,
    student_variant: str = "full",
    student_cfg_overrides: Optional[dict] = None,
    aug=None,
    device_dataset: bool = False,
    stream_steps: int = 8,
    verbose: bool = True,
    device="cuda",
):
    """``train_student_with_kd`` over ready loaders: ``train_loader``
    (re-iterable, with ``__len__`` and ``batch_size``; batches in the
    loader's layout) and ``val_loader``, tokens of ``vocab``.  With
    ``device_dataset`` the train loader's ``dataset`` goes to the device
    (``make_device_dataset``).  Under data parallelism (module
    docstring) the loaders are this process's, or global when this
    function started the processes.  Returns ``(state, s_cfg, vocab)``."""
    call = dict(locals())
    check_options(student_variant=student_variant)
    n_cards = common.cards_to_spawn(train_loader.batch_size, data_parallel,
                                    device)
    if n_cards:
        return common.run_per_card(train_student_with_kd_on_loaders,
                                   n_cards, call)
    common.distributed_init_from_env(device)
    mesh = common.maybe_mesh(train_loader.batch_size, data_parallel, device)
    device = resolve_device(device if mesh is None else mesh.device)
    primary = common.is_primary(mesh)
    verbose = verbose and primary
    compute_dtype = as_dtype(compute_dtype)
    tr = train_cfg or KDTrainConfig()
    if num_epochs is not None:
        tr = replace(tr, num_epochs=num_epochs)
    d_cfg = distill_cfg or DistillConfig()
    vocab_size = len(vocab)

    teacher, t_cfg = load_teacher(teacher_checkpoint, vocab_size, device)
    refine_kw = ({} if use_attention_refinement is None
                 else {"use_attention_refinement": use_attention_refinement})
    # tr.dropout is the reference trainer's knob for the full student only;
    # the other variants keep their own defaults
    if student_variant == "full":
        refine_kw["dropout"] = tr.dropout
    s_cfg = STUDENT_CONFIGS[student_variant](
        vocab_size, freeze_backbone=freeze_backbone, **refine_kw)
    if student_cfg_overrides:
        s_cfg = replace(s_cfg, **student_cfg_overrides)

    student, projectors = make_student_and_projectors(s_cfg, t_cfg, seed,
                                                      device)
    if verbose:
        print("Student parameters: "
              f"{sum(p.numel() for p in student.parameters()):,}")

    # preflight: one eval-mode forward of both models and the loss
    sample = steps.batch_to_device(next(iter(val_loader)), device)
    validate_distillation_setup(
        teacher, t_cfg, student, s_cfg, projectors,
        (T.normalize(sample["images"][:2]), sample["captions"][:, :2]),
        verbose=verbose)

    state = steps.init_train_state(student, projectors, s_cfg)
    MS.replicate(mesh, [state.student, state.projectors])
    start_epoch = 0
    if resume_from is not None:
        start_epoch = int(resume_train_state(state, resume_from, s_cfg,
                                             device)["epoch"]) + 1
        if verbose:
            print(f"Resumed from {resume_from} at epoch {start_epoch}")
    aug_kw = {} if aug is None else {"aug": aug}
    train_step = steps.make_kd_train_step(
        teacher, t_cfg, s_cfg, d_cfg, tr, compute_dtype=compute_dtype,
        **aug_kw)
    eval_step = steps.make_kd_eval_step(teacher, t_cfg, s_cfg, d_cfg,
                                        compute_dtype=compute_dtype)
    generator = torch.Generator(device=device).manual_seed(
        common.rank_seed(seed, mesh))

    if primary:
        os.makedirs(output_dir, exist_ok=True)
        vocab.save(os.path.join(output_dir, "vocab.json"))
    steps_per_epoch = max(len(train_loader) // tr.accumulation_steps, 1)
    device_data = None
    if device_dataset:
        device_data, dd_step, dd_step1 = make_device_dataset(
            train_loader, train_step, stream_steps, seed, device, verbose,
            mesh)
    stopper = common.EarlyStopping(tr.patience, mode="min")
    train_losses, val_losses, val_bleu_scores = [], [], []
    loss_components_history = defaultdict(list)
    best_val = float("inf")
    mlog = MetricLogger(metrics_jsonl if primary else None)

    def ckpt_tree(epoch, extra):
        return kd_checkpoint_tree(
            state, s_cfg, vocab_size, epoch, d_cfg,
            scheduler_state_dict=dict(last_epoch_time=float(epoch)), **extra)

    for epoch in range(start_epoch, tr.num_epochs):
        step_metrics = []  # device tensors; one host fetch per epoch
        if device_data is not None:
            step_metrics = run_device_epoch(
                device_data, dd_step, dd_step1, stream_steps, state,
                train_loader.batch_size, tr.accumulation_steps,
                max_steps_per_epoch, generator, epoch,
                lambda s: (np.float32(epoch + s / steps_per_epoch),
                           np.float32(1.0 / steps_per_epoch)))
        else:
            for idx, stacked in enumerate(common.stacked_batches(
                    train_loader, tr.accumulation_steps, mesh=mesh)):
                if (max_steps_per_epoch is not None
                        and idx >= max_steps_per_epoch):
                    break
                metrics = train_step(
                    state, steps.batch_to_device(stacked, device),
                    epoch + idx / steps_per_epoch, generator)
                step_metrics.append(metrics)
                if verbose and idx % 50 == 0:  # sync only at log boundaries
                    common.log_progress(epoch, idx, metrics,
                                        float(metrics["lr"]), steps_per_epoch)
        fetched = common.fetch_step_metrics(step_metrics)
        for si, m in enumerate(fetched):
            mlog.log_step(epoch * steps_per_epoch + si, m, epoch=epoch)
        nb = len(fetched)
        avg_train = (float(np.mean([m["total_loss"] for m in fetched]))
                     if fetched else float("nan"))
        train_losses.append(avg_train)
        for k in common.LOSS_NAMES:
            loss_components_history[k].append(
                sum(m[k] for m in fetched) / max(nb, 1))

        if epoch % tr.validate_every == 0:
            val_loss, val_bleu = validate_student(eval_step, state, val_loader,
                                                  vocab, device, mesh=mesh)
            val_losses.append(val_loss)
            val_bleu_scores.append(val_bleu)
            if verbose:
                print(f"\nEpoch {epoch+1}:")
                print(f"  Train Loss: {avg_train:.4f}")
                print(f"  Val Loss: {val_loss:.4f}")
                print(f"  Val BLEU-1: {val_bleu:.4f}")
            if stopper.update(val_loss):
                best_val = val_loss
                # the snapshot is taken now, the write is off the step's
                # path; wait_for_saves() below lands it before return
                if primary:
                    CKPT.save_checkpoint_async(
                        os.path.join(output_dir, "best_student_model.npz"),
                        ckpt_tree(epoch, dict(val_loss=val_loss,
                                              val_bleu=val_bleu)))
                if verbose:
                    print(f"  New best model saved! Val Loss: {val_loss:.4f}, "
                          f"BLEU: {val_bleu:.4f}")
            if stopper.should_stop:
                if verbose:
                    print(f"Early stopping triggered after {tr.patience} "
                          "epochs without improvement")
                break
        elif verbose:
            print(f"Epoch {epoch+1}: Train Loss: {avg_train:.4f}")

    CKPT.wait_for_saves()
    if primary:
        CKPT.save_checkpoint(
            os.path.join(output_dir, "final_student_model.npz"),
            ckpt_tree(tr.num_epochs, dict(
                train_losses=train_losses, val_losses=val_losses,
                val_bleu_scores=val_bleu_scores,
                loss_components=dict(loss_components_history))))
        common.write_history(
            os.path.join(output_dir, "student_training_history.json"),
            dict(train_losses=train_losses, val_losses=val_losses,
                 val_bleu_scores=val_bleu_scores,
                 loss_components=dict(loss_components_history),
                 hyperparameters=dict(
                     learning_rate=tr.learning_rate,
                     batch_size=tr.batch_size, embed_size=s_cfg.embed_size,
                     hidden_size=s_cfg.hidden_size, alpha=d_cfg.alpha,
                     beta=d_cfg.beta, gamma=d_cfg.gamma,
                     temperature=d_cfg.temperature)))
    mlog.close()
    if verbose:
        print("\nTraining completed!")
        print(f"Best validation loss: {best_val:.4f}")
    return state, s_cfg, vocab


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train the student with KD")
    ap.add_argument("--data-root", default="data/flickr8k")
    ap.add_argument("--captions-file", default=None)
    ap.add_argument("--synthetic-grid", type=int, default=0, metavar="N",
                    help="train on N in-memory synthetic grid images instead "
                         "of --data-root")
    ap.add_argument("--teacher-checkpoint",
                    default="saved_models/best_teacher_model.npz")
    ap.add_argument("--output-dir", default="saved_models")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append one JSON record per optimizer step")
    ap.add_argument("--student", default="full",
                    choices=["full", "compact", "enhanced"])
    ap.add_argument("--no-data-parallel", dest="data_parallel",
                    action="store_false",
                    help="force single-device training even with several "
                         "cards visible")
    ap.add_argument("--device-dataset", action="store_true")
    ap.add_argument("--stream-steps", type=int, default=8,
                    help="with --device-dataset: optimizer steps chained "
                         "per dispatch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    kw = dict(num_epochs=args.epochs, seed=args.seed,
              resume_from=args.resume_from, metrics_jsonl=args.metrics_jsonl,
              student_variant=args.student, data_parallel=args.data_parallel,
              device_dataset=args.device_dataset,
              stream_steps=args.stream_steps, device=args.device)
    if args.synthetic_grid <= 0:
        train_student_with_kd(
            args.data_root, args.captions_file, args.teacher_checkpoint,
            args.output_dir, image_size=args.image_size, **kw)
        return 0
    resolve_device(args.device)
    from imagecaptioner_tpu_torch.data.synthetic import make_grid_loaders

    tr = KDTrainConfig()
    train_loader, val_loader, vocab = make_grid_loaders(
        args.synthetic_grid, image_size=args.image_size, seed=args.seed,
        batch_size=tr.batch_size)
    train_student_with_kd_on_loaders(
        train_loader, val_loader, vocab, args.teacher_checkpoint,
        args.output_dir, **kw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
