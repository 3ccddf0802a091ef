"""The optimized KD trainer of the port
(``imagecaptioner_tpu/train/train_student_kd_optimized.py``).

Differences from the flagship KD trainer, as in the reference: the compact
MobileNetV2 student by default (256/256/1/0.1, no refinement; ``--student
full|enhanced`` are accepted), ``optimized_distillation_loss``
(warmup-adaptive 0.8/0.15/0.05, T=3, a focal hard loss, a cosine feature
loss), OneCycle stepped per optimizer update over three lr groups (encoder
x0.1, decoder, the others x1.5 at weight decay 0.005), heavier augmentation
(training images read at ``image_size + 32``, then a random crop to
``image_size`` and a rotation of up to 5 degrees on the device), a fast
validation every epoch (15 batches, BLEU on 2 samples of the first), early
stopping, the best checkpoint with its scheduler, training config and
performance metrics, and ``optimized_training_history.json``.

  python -m imagecaptioner_tpu_torch.train.train_student_kd_optimized \\
      --data-root data/flickr8k --teacher-checkpoint saved_models/best_teacher_model.npz \\
      --output-dir saved_models [--epochs 30] [--student compact|full|enhanced] \\
      [--resume-from saved_models/best_optimized_student_model.npz] \\
      [--device cuda|cpu]

Runs on ``device`` (default ``cuda``): without a card it raises.  Data
parallelism over several cards runs one process per card, as in the
flagship trainer (``train/common.py``).  ``--device-dataset``
keeps the training rows, stored at ``image_size + 32``, on the device and
chains ``--stream-steps`` optimizer steps as the flagship trainer does
(``train_student_kd.run_device_epoch``); the random crop to ``image_size``
and the augmentation run on the device either way, so its batches are the
host loader's, and OneCycle's step counter advances by one inside a chain.
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
                                                  OptimizedDistillConfig,
                                                  OptimizedKDTrainConfig)
from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.core.precision import as_dtype
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.data.loader import get_loader
from imagecaptioner_tpu_torch.distill.losses import OPTIMIZED_LOSS_NAMES
from imagecaptioner_tpu_torch.eval.metrics import monitoring_bleu
from imagecaptioner_tpu_torch.train import common, steps
from imagecaptioner_tpu_torch.train.train_student_kd import (
    check_options, kd_checkpoint_tree, load_teacher, make_device_dataset,
    make_student_and_projectors, resume_train_state, run_device_epoch)
from imagecaptioner_tpu_torch.utils import checkpoint as CKPT

BEST = "best_optimized_student_model.npz"
HISTORY = "optimized_training_history.json"


def validate_fast(eval_step, state, val_loader, vocab, device, epoch: int, *,
                  max_batches: int = 15, mesh=None):
    """Loss over at most ``max_batches`` batches at ``epoch``'s loss
    weights, and monitoring BLEU on 2 samples of the first batch (with a
    ``mesh``, as ``train_student_kd.validate_student``)."""
    losses, bleus, n = [], [], 0
    for bi, batch in enumerate(val_loader):
        if bi >= max_batches:
            break
        batch = (steps.batch_to_device(batch, device) if mesh is None
                 else common.put_global_batch(mesh, batch, stacked=False))
        loss, _, preds, cap_tgt = eval_step(state, batch, epoch)
        b = int(preds.shape[1])
        if mesh is not None:
            b *= mesh.data_size             # the global batch's rows
        losses.append(float(loss) * b)
        n += b
        if bi == 0:
            preds, cap_tgt = preds.cpu().numpy(), cap_tgt.cpu().numpy()
            for i in range(min(2, b)):
                bleus.append(monitoring_bleu(preds[:, i], cap_tgt[:, i],
                                             vocab))
    return (sum(losses) / max(n, 1),
            float(np.mean(bleus)) if bleus else 0.0)


def train_student_with_kd_optimized(
    data_root: str = "data/flickr8k",
    captions_file: Optional[str] = None,
    teacher_checkpoint: str = "saved_models/best_teacher_model.npz",
    output_dir: str = "saved_models",
    *,
    train_cfg: Optional[OptimizedKDTrainConfig] = None,
    distill_cfg: Optional[OptimizedDistillConfig] = None,
    num_epochs: Optional[int] = None,
    max_caption_len: int = 48,
    image_size: int = 224,
    compute_dtype=torch.bfloat16,
    seed: int = 0,
    max_steps_per_epoch: Optional[int] = None,
    data_parallel: bool = True,
    resume_from: Optional[str] = None,
    device_dataset: bool = False,
    stream_steps: int = 8,
    student_variant: str = "compact",
    student_cfg_overrides: Optional[dict] = None,
    aug=None,
    verbose: bool = True,
    device="cuda",
):
    """Train from a CSV/image dataset under ``data_root``: the train loader
    shuffled with ``seed`` at ``image_size + 32`` (``image_size`` when a
    custom ``aug`` does not crop), the validation loader in order at
    ``image_size``, with the train vocabulary.  ``resume_from`` takes a
    checkpoint of either package and goes on from its epoch and
    ``global_step``.  Returns ``(state, s_cfg, vocab)``."""
    call = dict(locals())
    check_options(student_variant=student_variant)
    compute_dtype = as_dtype(compute_dtype)
    tr = train_cfg or OptimizedKDTrainConfig()
    n_cards = common.cards_to_spawn(min(tr.batch_size, 16), data_parallel,
                                    device)
    if n_cards:
        return common.run_per_card(train_student_with_kd_optimized, n_cards,
                                   call)
    common.distributed_init_from_env(device)
    device = resolve_device(device)
    if num_epochs is not None:
        tr = replace(tr, num_epochs=num_epochs)
    od_cfg = distill_cfg or OptimizedDistillConfig()
    captions_file = captions_file or os.path.join(data_root,
                                                  "captions_clean.csv")
    # the model's position tables are sized for image_size: only a crop
    # brings the larger training images back to it
    host_size = (image_size + 32 if aug is None or aug.random_crop
                 else image_size)
    train_loader, dataset = get_loader(
        data_root, captions_file, batch_size=tr.batch_size,
        max_caption_len=max_caption_len, shuffle=True, seed=seed,
        image_size=host_size, host_shard=True)
    val_loader, _ = get_loader(
        data_root, captions_file, batch_size=tr.batch_size,
        max_caption_len=max_caption_len, shuffle=False, vocab=dataset.vocab,
        image_size=image_size, host_shard=True)
    vocab = dataset.vocab
    vocab_size = len(vocab)
    mesh = common.maybe_mesh(train_loader.batch_size, data_parallel, device)
    if mesh is not None:
        device = mesh.device
    primary = common.is_primary(mesh)
    verbose = verbose and primary

    teacher, t_cfg = load_teacher(teacher_checkpoint, vocab_size, device)
    s_cfg = STUDENT_CONFIGS[student_variant](vocab_size)
    if student_cfg_overrides:
        s_cfg = replace(s_cfg, **student_cfg_overrides)
    student, projectors = make_student_and_projectors(s_cfg, t_cfg, seed,
                                                      device)
    if verbose:
        n = sum(p.numel() for p in student.parameters())
        print(f"{s_cfg.variant.capitalize()} student parameters: {n:,} "
              f"(compression vs 25M teacher: {25e6 / n:.2f}x)")
    state = steps.init_train_state(student, projectors, s_cfg)
    MS.replicate(mesh, [state.student, state.projectors])

    steps_per_epoch = max(len(train_loader) // tr.accumulation_steps, 1)
    total_opt_steps = steps_per_epoch * tr.num_epochs
    start_epoch, global_step = 0, 0
    if resume_from is not None:
        ck = resume_train_state(state, resume_from, s_cfg, device)
        start_epoch = int(ck["epoch"]) + 1
        global_step = int(ck.get("scheduler_state_dict", {}).get(
            "global_step", 0))
        if verbose:
            print(f"Resumed from {resume_from} at epoch {start_epoch}")
    if aug is None:
        aug = replace(T.OPTIMIZED_KD_AUG, out_size=image_size)
    train_step = steps.make_kd_train_step(
        teacher, t_cfg, s_cfg, None, tr, aug=aug, compute_dtype=compute_dtype,
        optimized=True, od_cfg=od_cfg, onecycle_total_steps=total_opt_steps,
        others_scale=tr.others_lr_scale, others_wd=tr.others_weight_decay)
    eval_step = steps.make_kd_eval_step(teacher, t_cfg, s_cfg, None,
                                        compute_dtype=compute_dtype,
                                        optimized=True, od_cfg=od_cfg)
    generator = torch.Generator(device=device).manual_seed(
        common.rank_seed(seed, mesh))

    if primary:
        os.makedirs(output_dir, exist_ok=True)
        vocab.save(os.path.join(output_dir, "vocab.json"))
    device_data = None
    if device_dataset:
        device_data, dd_step, dd_step1 = make_device_dataset(
            train_loader, train_step, stream_steps, seed, device, verbose,
            mesh)
    stopper = common.EarlyStopping(tr.patience, mode="min")
    train_losses, val_losses, val_bleu_scores, epoch_times = [], [], [], []
    loss_components_history = defaultdict(list)
    best_val = float("inf")
    timer = common.Timer()

    def ckpt_tree(epoch, extra):
        return kd_checkpoint_tree(
            state, s_cfg, vocab_size, epoch, od_cfg,
            scheduler_state_dict=dict(global_step=global_step),
            training_config=dict(learning_rate=tr.learning_rate,
                                 batch_size=tr.batch_size,
                                 accumulation_steps=tr.accumulation_steps,
                                 num_epochs=tr.num_epochs),
            **extra)

    for epoch in range(start_epoch, tr.num_epochs):
        ep_timer = common.Timer()
        step_metrics = []  # device tensors; one host fetch per epoch
        if device_data is not None:
            # OneCycle is stepped per optimizer update: sched_t is the
            # global step counter, advancing by 1 inside the chain
            step_metrics = run_device_epoch(
                device_data, dd_step, dd_step1, stream_steps, state,
                train_loader.batch_size, tr.accumulation_steps,
                max_steps_per_epoch, generator, epoch,
                lambda s: (np.float32(global_step + s), np.float32(1.0)))
            global_step += sum(len(m["lr"]) for m in step_metrics)
        else:
            for idx, stacked in enumerate(common.stacked_batches(
                    train_loader, tr.accumulation_steps, mesh=mesh)):
                if (max_steps_per_epoch is not None
                        and idx >= max_steps_per_epoch):
                    break
                step_metrics.append(train_step(
                    state, steps.batch_to_device(stacked, device),
                    global_step, generator, epoch))
                global_step += 1
        fetched = common.fetch_step_metrics(step_metrics)
        nb = len(fetched)
        avg_train = (float(np.mean([m["total_loss"] for m in fetched]))
                     if fetched else float("nan"))
        train_losses.append(avg_train)
        epoch_times.append(ep_timer.elapsed())
        for k in OPTIMIZED_LOSS_NAMES:
            loss_components_history[k].append(
                sum(m[k] for m in fetched) / max(nb, 1))

        val_loss, val_bleu = validate_fast(eval_step, state, val_loader,
                                           vocab, device, epoch, mesh=mesh)
        val_losses.append(val_loss)
        val_bleu_scores.append(val_bleu)
        if verbose:
            print(f"Epoch {epoch+1}/{tr.num_epochs}: train {avg_train:.4f}, "
                  f"val {val_loss:.4f}, BLEU {val_bleu:.4f}, "
                  f"{epoch_times[-1]:.1f}s")
        if stopper.update(val_loss):
            best_val = val_loss
            # the snapshot is taken now, the write is off the step's path
            if primary:
                CKPT.save_checkpoint_async(
                    os.path.join(output_dir, BEST),
                    ckpt_tree(epoch, dict(
                        val_loss=val_loss, val_bleu=val_bleu,
                        performance_metrics=dict(
                            epoch_time=epoch_times[-1],
                            total_time=timer.elapsed()))))
        if stopper.should_stop:
            if verbose:
                print("Early stopping triggered")
            break

    total_time = timer.elapsed()
    CKPT.wait_for_saves()
    if primary:
        common.write_history(
            os.path.join(output_dir, HISTORY),
            dict(train_losses=train_losses, val_losses=val_losses,
                 val_bleu_scores=val_bleu_scores,
                 loss_components=dict(loss_components_history),
                 epoch_times=epoch_times, total_training_time=total_time,
                 avg_epoch_time=(float(np.mean(epoch_times)) if epoch_times
                                 else 0.0),
                 hyperparameters=dict(
                     learning_rate=tr.learning_rate, batch_size=tr.batch_size,
                     alpha=od_cfg.alpha, beta=od_cfg.beta, gamma=od_cfg.gamma,
                     temperature=od_cfg.temperature)))
    if verbose:
        print(f"Training completed in {total_time:.1f}s. "
              f"Best validation loss: {best_val:.4f}")
    return state, s_cfg, vocab


def main(argv=None):
    ap = argparse.ArgumentParser(description="Optimized student KD training")
    ap.add_argument("--data-root", default="data/flickr8k")
    ap.add_argument("--captions-file", default=None)
    ap.add_argument("--teacher-checkpoint",
                    default="saved_models/best_teacher_model.npz")
    ap.add_argument("--output-dir", default="saved_models")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--student", default="compact",
                    choices=["compact", "full", "enhanced"])
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
    train_student_with_kd_optimized(
        args.data_root, args.captions_file, args.teacher_checkpoint,
        args.output_dir, num_epochs=args.epochs, seed=args.seed,
        image_size=args.image_size, resume_from=args.resume_from,
        student_variant=args.student, data_parallel=args.data_parallel,
        device_dataset=args.device_dataset, stream_steps=args.stream_steps,
        device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
