"""KD entry point of the port (``imagecaptioner_tpu/train/train_student_kd.py``).

Trains the full CNN-LSTM student against a frozen teacher checkpoint with
the multi-level distillation loss.  Reference behaviors preserved: the
hardcoded defaults (lr 2e-4, batch 16, accumulation 2, ``num_epochs=1``),
the preflight ``validate_distillation_setup``, three parameter groups
(encoder x0.1 / decoder / others), clip 1.0 over student and projectors,
cosine warm restarts stepped fractionally, validation every 2 epochs with
monitoring BLEU, best and final checkpoints with the reference's logical
keys (npz files that both packages' ``utils/checkpoint.py`` read), and
``student_training_history.json``.

Runs on ``device`` (default ``cuda``): without a card it raises, and only a
caller that asks for ``cpu`` gets the CPU.

Data comes from re-iterable loaders of batches in the loader's layout.  The
CLI builds them from the in-memory synthetic grid task:

  python -m imagecaptioner_tpu_torch.train.train_student_kd \\
      --synthetic-grid 256 --teacher-checkpoint saved_models/best_teacher_model.npz \\
      --output-dir saved_models [--epochs 1] [--device cuda|cpu]

Not ported yet, each exiting with its roadmap item: the CSV/JPEG loader
(``--data-root``), ``resume_from``, ``data_parallel``, ``device_dataset`` /
``stream_steps``, ``metrics_jsonl``, and the compact and enhanced students.
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

from imagecaptioner_tpu_torch.core.config import (DistillConfig,
                                                  KDTrainConfig, TeacherConfig,
                                                  full_student_config)
from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.core.precision import as_dtype
from imagecaptioner_tpu_torch.data import transforms as T
from imagecaptioner_tpu_torch.distill.projector import (
    create_feature_projectors, make_projectors)
from imagecaptioner_tpu_torch.distill.validate import validate_distillation_setup
from imagecaptioner_tpu_torch.models.student import Student, student_init
from imagecaptioner_tpu_torch.models.teacher import Teacher
from imagecaptioner_tpu_torch.train import common, steps
from imagecaptioner_tpu_torch.utils import checkpoint as CKPT
from imagecaptioner_tpu_torch.utils import convert as CV


def not_ported(what: str, item: str) -> SystemExit:
    return SystemExit(f"{what} is not ported yet (ROADMAP Queue 1 {item}); "
                      "use python -m imagecaptioner_tpu.train.train_student_kd")


def load_teacher(teacher_checkpoint: str, vocab_size: int, device):
    """A teacher checkpoint written by the teacher trainer -> ``(Teacher in
    eval mode on device, cfg)``; its ``model_config`` rebuilds the
    architecture."""
    ckpt = CKPT.load_checkpoint(teacher_checkpoint)
    cfg = TeacherConfig(vocab_size=int(ckpt["vocab_size"]),
                        **dict(ckpt.get("model_config", {})))
    if cfg.vocab_size != vocab_size:
        raise ValueError(f"teacher vocabulary {cfg.vocab_size} != data "
                         f"vocabulary {vocab_size}")
    teacher = Teacher(cfg)
    teacher.load_state_dict(
        CV.jax_teacher_to_state_dict(ckpt["model_state_dict"]["params"]),
        strict=True)
    return teacher.to(device).eval(), cfg


def validate_student(eval_step, state, val_loader, vocab, device, *,
                     max_batches: int = 50):
    """Loss over at most ``max_batches`` batches, and monitoring BLEU on 2
    samples of each of the first 5."""
    losses, bleus, n = [], [], 0
    for bi, batch in enumerate(val_loader):
        if bi >= max_batches:
            break
        loss, _, preds, cap_tgt = eval_step(
            state, steps.batch_to_device(batch, device))
        b = int(preds.shape[1])
        losses.append(float(loss) * b)
        n += b
        if bi < 5:
            preds, cap_tgt = preds.cpu().numpy(), cap_tgt.cpu().numpy()
            for i in range(min(2, b)):
                bleus.append(common.monitoring_bleu(preds[:, i],
                                                    cap_tgt[:, i], vocab))
    return (sum(losses) / max(n, 1),
            float(np.mean(bleus)) if bleus else 0.0)


def train_student_with_kd(
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
    data_parallel: bool = False,
    metrics_jsonl: Optional[str] = None,
    freeze_backbone: bool = True,
    use_attention_refinement: Optional[bool] = None,
    student_variant: str = "full",
    student_cfg_overrides: Optional[dict] = None,
    aug=None,
    device_dataset: bool = False,
    verbose: bool = True,
    device="cuda",
):
    """Train over ``train_loader`` (re-iterable, with ``__len__`` and
    ``batch_size``; batches in the loader's layout), validate on
    ``val_loader``.  Returns ``(state, s_cfg, vocab)``."""
    if resume_from is not None:
        raise not_ported("resuming a KD run", "item 4, still open")
    if data_parallel:
        raise not_ported("data-parallel KD training", "item 13")
    if device_dataset:
        raise not_ported("the device-resident dataset", "item 11")
    if metrics_jsonl is not None:
        raise not_ported("the per-step metrics log", "item 14")
    if student_variant != "full":
        raise not_ported(f"the {student_variant} student",
                         "items 7 (compact) and 8 (enhanced)")
    device = resolve_device(device)
    compute_dtype = as_dtype(compute_dtype)
    tr = train_cfg or KDTrainConfig()
    if num_epochs is not None:
        tr = replace(tr, num_epochs=num_epochs)
    d_cfg = distill_cfg or DistillConfig()
    vocab_size = len(vocab)

    teacher, t_cfg = load_teacher(teacher_checkpoint, vocab_size, device)
    refine_kw = ({} if use_attention_refinement is None
                 else {"use_attention_refinement": use_attention_refinement})
    s_cfg = full_student_config(vocab_size, dropout=tr.dropout,
                                freeze_backbone=freeze_backbone, **refine_kw)
    if student_cfg_overrides:
        s_cfg = replace(s_cfg, **student_cfg_overrides)

    s_params, s_state = student_init(seed, s_cfg)
    student = Student(s_cfg)
    student.load_state_dict(CV.jax_student_to_state_dict(s_params, s_state,
                                                         s_cfg), strict=True)
    student.to(device)
    if verbose:
        print("Student parameters: "
              f"{sum(p.numel() for p in student.parameters()):,}")
    proj_params, _ = create_feature_projectors(
        seed + 1, teacher_embed=t_cfg.embed_size,
        student_embed=s_cfg.embed_size, student_hidden=s_cfg.hidden_size,
        student_seq_len=s_cfg.feature_tokens,
        teacher_seq_len=t_cfg.num_tokens)
    projectors = make_projectors(t_cfg.embed_size, s_cfg.embed_size,
                                 s_cfg.hidden_size)
    projectors.load_state_dict(CV.jax_projectors_to_state_dict(proj_params),
                               strict=True)
    projectors.to(device)

    # preflight: one eval-mode forward of both models and the loss
    sample = steps.batch_to_device(next(iter(val_loader)), device)
    validate_distillation_setup(
        teacher, t_cfg, student, s_cfg, projectors,
        (T.normalize(sample["images"][:2]), sample["captions"][:, :2]),
        verbose=verbose)

    state = steps.init_train_state(student, projectors, s_cfg)
    aug_kw = {} if aug is None else {"aug": aug}
    train_step = steps.make_kd_train_step(
        teacher, t_cfg, s_cfg, d_cfg, tr, compute_dtype=compute_dtype,
        **aug_kw)
    eval_step = steps.make_kd_eval_step(teacher, t_cfg, s_cfg, d_cfg,
                                        compute_dtype=compute_dtype)
    generator = torch.Generator(device=device).manual_seed(seed)

    os.makedirs(output_dir, exist_ok=True)
    vocab.save(os.path.join(output_dir, "vocab.json"))
    steps_per_epoch = max(len(train_loader) // tr.accumulation_steps, 1)
    stopper = common.EarlyStopping(tr.patience, mode="min")
    train_losses, val_losses, val_bleu_scores = [], [], []
    loss_components_history = defaultdict(list)
    best_val = float("inf")

    def ckpt_tree(epoch, extra):
        params, model_state = CV.student_to_jax_trees(state.student)
        named = state.named_parameters()
        moments = lambda m: CV.state_dict_to_tree(  # noqa: E731
            {n: m[n] for n in named})
        return dict(
            epoch=epoch,
            student_state_dict=dict(params=params, model_state=model_state),
            projectors_state_dict=CV.state_dict_to_tree(
                dict(state.projectors.named_parameters())),
            optimizer_state_dict=dict(
                step=np.asarray(state.opt_state.step, np.int32),
                mu=moments(state.opt_state.mu),
                nu=moments(state.opt_state.nu)),
            scheduler_state_dict=dict(last_epoch_time=float(epoch)),
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

    for epoch in range(tr.num_epochs):
        step_metrics = []  # device tensors; one host fetch per epoch
        for idx, stacked in enumerate(
                common.stacked_batches(train_loader, tr.accumulation_steps)):
            if max_steps_per_epoch is not None and idx >= max_steps_per_epoch:
                break
            metrics = train_step(
                state, steps.batch_to_device(stacked, device),
                epoch + idx / steps_per_epoch, generator)
            step_metrics.append(metrics)
            if verbose and idx % 50 == 0:  # sync only at log boundaries
                common.log_progress(epoch, idx, metrics, float(metrics["lr"]),
                                    steps_per_epoch)
        fetched = [{k: float(v) for k, v in m.items()} for m in step_metrics]
        nb = len(fetched)
        avg_train = (float(np.mean([m["total_loss"] for m in fetched]))
                     if fetched else float("nan"))
        train_losses.append(avg_train)
        for k in common.LOSS_NAMES:
            loss_components_history[k].append(
                sum(m[k] for m in fetched) / max(nb, 1))

        if epoch % tr.validate_every == 0:
            val_loss, val_bleu = validate_student(eval_step, state, val_loader,
                                                  vocab, device)
            val_losses.append(val_loss)
            val_bleu_scores.append(val_bleu)
            if verbose:
                print(f"\nEpoch {epoch+1}:")
                print(f"  Train Loss: {avg_train:.4f}")
                print(f"  Val Loss: {val_loss:.4f}")
                print(f"  Val BLEU-1: {val_bleu:.4f}")
            if stopper.update(val_loss):
                best_val = val_loss
                CKPT.save_checkpoint(
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
                 learning_rate=tr.learning_rate, batch_size=tr.batch_size,
                 embed_size=s_cfg.embed_size, hidden_size=s_cfg.hidden_size,
                 alpha=d_cfg.alpha, beta=d_cfg.beta, gamma=d_cfg.gamma,
                 temperature=d_cfg.temperature)))
    if verbose:
        print("\nTraining completed!")
        print(f"Best validation loss: {best_val:.4f}")
    return state, s_cfg, vocab


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train the student with KD")
    ap.add_argument("--data-root", default=None,
                    help="CSV/JPEG dataset directory (not ported yet)")
    ap.add_argument("--captions-file", default=None)
    ap.add_argument("--synthetic-grid", type=int, default=0, metavar="N",
                    help="train on N in-memory synthetic grid images")
    ap.add_argument("--teacher-checkpoint",
                    default="saved_models/best_teacher_model.npz")
    ap.add_argument("--output-dir", default="saved_models")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--student", default="full",
                    choices=["full", "compact", "enhanced"])
    ap.add_argument("--data-parallel", action="store_true")
    ap.add_argument("--device-dataset", action="store_true")
    ap.add_argument("--stream-steps", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    if args.data_root is not None or args.captions_file is not None:
        raise not_ported("the CSV/JPEG loader", "item 4, still open")
    if args.synthetic_grid <= 0:
        raise SystemExit("give --synthetic-grid N: the in-memory grid task is "
                         "the only data source ported so far")
    device = resolve_device(args.device)

    from imagecaptioner_tpu_torch.data.synthetic import make_grid_loaders

    tr = KDTrainConfig()
    train_loader, val_loader, vocab = make_grid_loaders(
        args.synthetic_grid, image_size=args.image_size, seed=args.seed,
        batch_size=tr.batch_size)
    train_student_with_kd(
        train_loader, val_loader, vocab, args.teacher_checkpoint,
        args.output_dir, num_epochs=args.epochs, seed=args.seed,
        resume_from=args.resume_from, student_variant=args.student,
        data_parallel=args.data_parallel, device_dataset=args.device_dataset,
        device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
