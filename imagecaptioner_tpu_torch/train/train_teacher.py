"""Teacher entry point of the port (``imagecaptioner_tpu/train/train_teacher.py``).

Trains the ViT-S/16 + transformer-decoder captioning teacher with label
smoothing.  Reference behaviors preserved: the hardcoded defaults (batch 12,
accumulation 3, lr 1e-4, 25 epochs, clip 0.5, label smoothing 0.1, encoder
lr x0.1, cosine warm restarts stepped fractionally per batch), the ViT
partly frozen (its last 4 blocks and every norm train), the validation
loader over the same full CSV unshuffled (no real split), validation every
2 epochs, early stopping with patience 5 on the validation loss, best
(written in the background) and final checkpoints with the reference's
logical keys (npz files that both packages' ``utils/checkpoint.py`` read),
``vocab.json`` and ``training_history.json``.  ``resume_from`` takes a
checkpoint of either package.

Runs on ``device`` (default ``cuda``): without a card it raises, and only a
caller that asks for ``cpu`` gets the CPU.

  python -m imagecaptioner_tpu_torch.train.train_teacher \\
      --data-root data/flickr8k --output-dir saved_models [--epochs 25] \\
      [--resume-from saved_models/best_teacher_model.npz] [--device cuda|cpu]

Data parallelism is on by default, as in the reference, and a no-op on one
card.  Over several cards it runs one process per card as the KD trainer
does (``train/common.py``): each process loads its own rows in a world
made by the environment or the caller, or reads the global batch and takes
its block when the trainer started the processes itself; gradients and
the loss's normalizers are the global batch's, and only rank 0 writes
files.
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from imagecaptioner_tpu_torch.core import mesh as MS
from imagecaptioner_tpu_torch.core.config import (TeacherConfig,
                                                  TeacherTrainConfig)
from imagecaptioner_tpu_torch.core.device import resolve_device
from imagecaptioner_tpu_torch.core.precision import as_dtype
from imagecaptioner_tpu_torch.data.loader import get_loader
from imagecaptioner_tpu_torch.models import teacher as TM
from imagecaptioner_tpu_torch.train import common, steps
from imagecaptioner_tpu_torch.utils import checkpoint as CKPT
from imagecaptioner_tpu_torch.utils import convert as CV


def resume_teacher_state(state: steps.TeacherTrainState, path: str,
                         device) -> int:
    """Load a teacher checkpoint of either package into ``state`` in place:
    the parameters, the AdamW step and moments.  Returns the epoch to start
    from."""
    ck = CKPT.load_checkpoint(path)
    state.teacher.load_state_dict(
        CV.jax_teacher_to_state_dict(ck["model_state_dict"]["params"]),
        strict=True)
    state.opt_state = steps.restore_adamw(ck["optimizer_state_dict"],
                                          state.named_parameters(), device,
                                          path)
    return int(ck["epoch"]) + 1


def train(
    data_root: str = "data/flickr8k",
    captions_file: Optional[str] = None,
    output_dir: str = "saved_models",
    *,
    train_cfg: Optional[TeacherTrainConfig] = None,
    teacher_cfg_overrides: Optional[dict] = None,
    num_epochs: Optional[int] = None,
    max_caption_len: int = 48,
    image_size: int = 224,
    aug=None,
    compute_dtype=torch.bfloat16,
    seed: int = 0,
    max_steps_per_epoch: Optional[int] = None,
    resume_from: Optional[str] = None,
    data_parallel: bool = True,
    verbose: bool = True,
    device="cuda",
):
    """Train from a CSV/image dataset under ``data_root`` (``captions_file``
    defaults to ``<data_root>/captions_clean.csv``).  ``aug=None`` keeps
    ``TEACHER_TRAIN_AUG``.  Returns ``(state, t_cfg, vocab)``."""
    call = dict(locals())
    compute_dtype = as_dtype(compute_dtype)
    tr = train_cfg or TeacherTrainConfig()
    n_cards = common.cards_to_spawn(min(tr.batch_size, 16), data_parallel,
                                    device)
    if n_cards:
        return common.run_per_card(train, n_cards, call)
    common.distributed_init_from_env(device)
    device = resolve_device(device)
    if num_epochs is not None:
        tr = replace(tr, num_epochs=num_epochs)
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
    vocab = dataset.vocab
    vocab_size = len(vocab)
    mesh = common.maybe_mesh(train_loader.batch_size, data_parallel, device)
    device = resolve_device(device if mesh is None else mesh.device)
    primary = common.is_primary(mesh)
    verbose = verbose and primary
    if verbose:
        print(f"Vocabulary size: {vocab_size}")

    overrides = dict(teacher_cfg_overrides or {})
    overrides.setdefault("image_size", image_size)
    t_cfg = TeacherConfig(vocab_size=vocab_size, **overrides)
    teacher = TM.Teacher(t_cfg)
    teacher.load_state_dict(CV.jax_teacher_to_state_dict(
        TM.teacher_init(seed, t_cfg)), strict=True)
    teacher.to(device)
    if verbose:
        print(f"Total parameters: {TM.count_parameters(teacher):,}")
    state = steps.init_teacher_train_state(teacher, t_cfg)
    MS.replicate(mesh, state.teacher)
    start_epoch = 0
    if resume_from is not None:
        start_epoch = resume_teacher_state(state, resume_from, device)
        if verbose:
            print(f"Resumed from {resume_from} at epoch {start_epoch}")
    aug_kw = {} if aug is None else {"aug": aug}
    train_step = steps.make_teacher_train_step(
        t_cfg, tr, compute_dtype=compute_dtype, **aug_kw)
    eval_step = steps.make_teacher_eval_step(t_cfg, tr,
                                             compute_dtype=compute_dtype)
    generator = torch.Generator(device=device).manual_seed(
        common.rank_seed(seed, mesh))

    if primary:
        os.makedirs(output_dir, exist_ok=True)
        vocab.save(os.path.join(output_dir, "vocab.json"))
    steps_per_epoch = max(len(train_loader) // tr.accumulation_steps, 1)
    stopper = common.EarlyStopping(tr.patience, mode="min")
    train_losses, val_losses = [], []
    best_val = float("inf")

    def validate() -> float:
        losses = [eval_step(state.teacher, (
            steps.batch_to_device(b, device) if mesh is None
            else common.put_global_batch(mesh, b, stacked=False)))
                  for b in val_loader]
        return (float(torch.stack(losses).mean()) if losses
                else float("nan"))

    def ckpt_tree(epoch, extra):
        named = state.named_parameters()
        opt = state.opt_state
        return dict(
            epoch=epoch,
            model_state_dict=dict(params=CV.state_dict_to_tree(named),
                                  model_state={}),
            optimizer_state_dict=dict(
                step=np.asarray(opt.step, np.int32),
                mu=CV.state_dict_to_tree({n: opt.mu[n] for n in named}),
                nu=CV.state_dict_to_tree({n: opt.nu[n] for n in named})),
            scheduler_state_dict=dict(last_epoch_time=float(epoch)),
            vocab_size=vocab_size,
            model_config=dict(
                embed_size=t_cfg.embed_size, num_heads=t_cfg.num_heads,
                num_decoder_layers=t_cfg.num_decoder_layers,
                dropout=t_cfg.dropout, encoder_dim=t_cfg.encoder_dim,
                encoder_depth=t_cfg.encoder_depth,
                encoder_heads=t_cfg.encoder_heads,
                encoder_mlp_ratio=t_cfg.encoder_mlp_ratio,
                patch_size=t_cfg.patch_size, image_size=t_cfg.image_size),
            **extra)

    for epoch in range(start_epoch, tr.num_epochs):
        epoch_losses = []  # device tensors; one host fetch per epoch
        for idx, stacked in enumerate(
                common.stacked_batches(train_loader, tr.accumulation_steps,
                                       mesh=mesh)):
            if max_steps_per_epoch is not None and idx >= max_steps_per_epoch:
                break
            metrics = train_step(state, steps.batch_to_device(stacked, device),
                                 epoch + idx / steps_per_epoch, generator)
            epoch_losses.append(metrics["loss"])
        avg_train = (float(torch.stack(epoch_losses).mean()) if epoch_losses
                     else float("nan"))
        train_losses.append(avg_train)

        if epoch % tr.validate_every == 0:
            val_loss = validate()
            val_losses.append(val_loss)
            if verbose:
                print(f"Epoch {epoch+1}: Train Loss: {avg_train:.4f}, "
                      f"Val Loss: {val_loss:.4f}")
            if stopper.update(val_loss):
                best_val = val_loss
                # the snapshot is taken now, the write is off the step's
                # path; wait_for_saves() below lands it before return
                if primary:
                    CKPT.save_checkpoint_async(
                        os.path.join(output_dir, "best_teacher_model.npz"),
                        ckpt_tree(epoch, dict(val_loss=val_loss)))
                if verbose:
                    print(f"New best model saved with validation loss: "
                          f"{val_loss:.4f}")
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
            os.path.join(output_dir, "final_teacher_model.npz"),
            ckpt_tree(tr.num_epochs, dict(train_losses=train_losses,
                                          val_losses=val_losses)))
        common.write_history(
            os.path.join(output_dir, "training_history.json"),
            dict(train_losses=train_losses, val_losses=val_losses))
    if verbose:
        print("Training completed. Final model saved.")
        print(f"Best validation loss: {best_val:.4f}")
    return state, t_cfg, vocab


def main(argv=None):
    ap = argparse.ArgumentParser(description="Train the ViT captioning teacher")
    ap.add_argument("--data-root", default="data/flickr8k")
    ap.add_argument("--captions-file", default=None)
    ap.add_argument("--output-dir", default="saved_models")
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume-from", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    train(args.data_root, args.captions_file, args.output_dir,
          num_epochs=args.epochs, seed=args.seed,
          resume_from=args.resume_from, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
