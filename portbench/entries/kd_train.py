"""Knowledge-distillation training of the full student from the frozen
teacher: the port's ``train/steps.make_kd_train_step``, each step fed by
``steps.batch_to_device`` from a stacked host batch and its metrics fetched
at the end, as ``train/train_student_kd.py``'s host-loader epoch runs it.

Traffic (``workloads/*.json``): ``accumulation`` micro-batches of ``batch``
rows a step, captions of ``T`` positions, ``aug`` the colour jitter and
flip, ``batches`` distinct stacked batches cycled in order from a seeded
pool.  Set-up builds one train state and drives it through the first
``checked_steps`` steps (which compile); the window continues it.  The
check follows those steps with the float32 reference
(``reference/kd.py``), handed the draws the program's generator made:
each step's loss, the first gradient as AdamW took it (from its first
moments after one step), the parameters' change after the checked steps,
and the direction of the feature projector's first gradient (the leaves
that take no gradient through the bf16 recurrence, whose chaos hides a
step over half the batch from the others).
"""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, List

import numpy as np
import torch

from portbench import traffic as TF
from portbench import weights as WT
from portbench.reference import kd as RK
from portbench.entries.greedy import student_weights
from portbench.reference.precision import ROUNDINGS

B1 = 0.9         # AdamW's first-moment rate in train/optim.py
PROJECTOR = "projectors."                  # the feature projector's leaves


class DrawRecorder:
    """Records what the step's generator draws, a group a micro-batch:
    the jitter factors (``transforms._uniform``), the flips (read back from
    ``random_hflip``'s output) and the dropout keep masks
    (``dropout_keep_mask``, looked up in two modules)."""

    def __init__(self):
        self.groups: List[dict] = []

    @contextlib.contextmanager
    def active(self):
        from imagecaptioner_tpu_torch.core import modules as M
        from imagecaptioner_tpu_torch.data import transforms as T
        from imagecaptioner_tpu_torch.models import lstm as L
        rec = self
        orig = {"aug": T.augment_and_normalize, "uni": T._uniform,
                "flip": T.random_hflip, "mask": M.dropout_keep_mask}

        def aug(*a, **k):
            rec.groups.append({"uniform": [], "flip": None, "masks": []})
            return orig["aug"](*a, **k)

        def uni(*a, **k):
            u = orig["uni"](*a, **k)
            rec.groups[-1]["uniform"].append(u.detach().clone())
            return u

        def flip(x, *a, **k):
            out = orig["flip"](x, *a, **k)
            rec.groups[-1]["flip"] = (out != x).flatten(1).any(1)
            return out

        def mask(*a, **k):
            m = orig["mask"](*a, **k)
            rec.groups[-1]["masks"].append(m.clone())
            return m
        T.augment_and_normalize, T._uniform, T.random_hflip = aug, uni, flip
        M.dropout_keep_mask = L.dropout_keep_mask = mask
        try:
            yield
        finally:
            T.augment_and_normalize, T._uniform = orig["aug"], orig["uni"]
            T.random_hflip = orig["flip"]
            M.dropout_keep_mask = L.dropout_keep_mask = orig["mask"]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              leaves: List[str]) -> Dict[str, float]:
    """Each leaf's gap between the program's and the reference's norm, over
    the reference's norm of that leaf or of the median leaf, whichever is
    larger; a norm that is not finite reads infinite."""
    med = statistics.median(ref[n] for n in leaves)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med)
            if math.isfinite(prog[n]) else math.inf for n in leaves}


def rel_gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if math.isfinite(a) else math.inf


def unit_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The distance between the two tensors scaled to unit norm (0 alike,
    2 opposed); a program tensor of norm 0 or not finite reads infinite."""
    got, ref = got.float().cpu(), ref.float().cpu()
    g = float(got.norm())
    if not math.isfinite(g) or g == 0.0:
        return math.inf
    return float((got / g - ref / ref.norm()).norm())


class KDTrain:
    def __init__(self, ctx):
        from imagecaptioner_tpu_torch.core.config import (DistillConfig,
                                                          KDTrainConfig,
                                                          StudentConfig,
                                                          TeacherConfig)
        from imagecaptioner_tpu_torch.data.transforms import AugmentConfig
        from imagecaptioner_tpu_torch.distill.projector import make_projectors
        from imagecaptioner_tpu_torch.models.student import Student
        from imagecaptioner_tpu_torch.models.teacher import Teacher
        from imagecaptioner_tpu_torch.ops import _build
        from imagecaptioner_tpu_torch.train import steps
        self.ctx, self.steps_mod = ctx, steps
        tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
        tcfg_d = ctx.configs[cfg["teacher_config"]]
        self.A, self.B, self.T = int(tr["accumulation"]), int(tr["batch"]), \
            int(tr["T"])
        self.tr_cfg = KDTrainConfig(batch_size=self.B,
                                    accumulation_steps=self.A)
        self.scfg = StudentConfig(**{**cfg["student"],
                                     "dropout": self.tr_cfg.dropout})
        self.tcfg = TeacherConfig(**tcfg_d["teacher"])
        if dev.type == "cuda":
            with ctx.phase("kernels"):
                _build.build_all(tr["kernels"])
        with ctx.phase("weights"):
            with torch.device(dev):
                student = Student(self.scfg)
                projectors = make_projectors(self.tcfg.embed_size,
                                             self.scfg.embed_size,
                                             self.scfg.hidden_size)
                teacher = Teacher(self.tcfg)
            s = int(ctx.seed)
            W = {"student": student_weights(WT.shapes_of(student), cfg, s,
                                            dev, torch.float32),
                 "projectors": WT.draw(WT.shapes_of(projectors), cfg["init"],
                                       s + 1, dev),
                 "teacher": WT.draw(WT.shapes_of(teacher), tcfg_d["init"],
                                    s + 2, dev)}
            for part, mod in (("student", student), ("projectors", projectors),
                              ("teacher", teacher)):
                WT.load_into(mod.to(dev), W[part])
            # the reference's copy, on the host
            self.W = {p: {k: v.cpu() for k, v in w.items()}
                      for p, w in W.items()}
            del W
            teacher = teacher.to(dev).eval()
            self.state = steps.init_train_state(student.to(dev),
                                                projectors.to(dev), self.scfg)
            self.step = steps.make_kd_train_step(
                teacher, self.tcfg, self.scfg, DistillConfig(), self.tr_cfg,
                aug=AugmentConfig(**tr["aug"]),
                compute_dtype=getattr(torch, cfg["compute_dtype"]))
            self.gen = torch.Generator(device=dev).manual_seed(
                int(ctx.seed) % (1 << 63))
        with ctx.phase("pool"):
            rng = np.random.default_rng(ctx.seed)
            n = int(tr["batches"])
            size = self.scfg.image_size
            imgs = TF.images(n * self.A * self.B, size, ctx.seed + 1, dev)
            caps, lens = TF.captions(n * self.A * self.B, self.T,
                                     self.scfg.vocab_size, rng,
                                     **tr["captions"])
            self.batches = [{
                "images": imgs[i * self.A * self.B:(i + 1) * self.A * self.B
                               ].reshape(self.A, self.B, size, size, 3),
                "captions": np.ascontiguousarray(
                    caps[:, i * self.A * self.B:(i + 1) * self.A * self.B]
                    .reshape(self.T, self.A, self.B).transpose(1, 0, 2)),
                "lengths": lens[i * self.A * self.B:(i + 1) * self.A * self.B
                                ].reshape(self.A, self.B)}
                for i in range(n)]
        with ctx.phase("warm-up"):
            self.checked = self.run_checked(int(tr["checked_steps"]))
        self.count = len(self.checked["losses"])
        self.metrics: List[dict] = []
        self.failed = 0

    def sched_t(self, k: int) -> float:
        return k / float(self.ctx.traffic["steps_per_epoch"])

    def run_step(self, k: int):
        batch = self.steps_mod.batch_to_device(
            self.batches[k % len(self.batches)], self.ctx.device)
        return self.step(self.state, batch, self.sched_t(k), self.gen)

    def trainable(self) -> Dict[str, torch.Tensor]:
        return {n: p for n, p in self.state.named_parameters().items()
                if p.requires_grad}

    def run_checked(self, n: int) -> dict:
        """The first ``n`` steps, through the window's own call and feed,
        with their draws recorded, and what the check compares."""
        rec = DrawRecorder()
        p0 = {k: p.detach().clone() for k, p in self.trainable().items()}
        losses, grad1 = [], {}
        for k in range(n):
            with rec.active():
                m = self.run_step(k)
            losses.append(float(m["total_loss"]))
            if k == 0:
                g1 = {name: self.state.opt_state.mu[name].float().cpu()
                      / (1.0 - B1) for name in p0}
                grad1 = {name: float(g.norm()) for name, g in g1.items()}
        change = {k: (p.detach() - p0[k]).float().cpu()
                  for k, p in self.trainable().items()}
        return {"losses": losses, "grad1": grad1, "g1": g1, "change": change,
                "groups": rec.groups}

    def call(self, i: int) -> int:
        self.metrics.append(self.run_step(self.count + i))
        return self.A * self.B

    def finish(self) -> None:
        for m in self.metrics:
            if not np.isfinite(float(m["total_loss"])):
                self.failed += 1
        self.metrics = []

    def release(self) -> None:
        self.state = self.step = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def ref_readings(self, r_student: str = "float32",
                     r_teacher: str = "float32") -> dict:
        """The reference's losses, first gradient and change over the
        checked steps, on their batches and recorded draws, from the
        weights the program was given; products rounded as named (the
        controls)."""
        dev = self.ctx.device
        tcfg_d = self.ctx.configs[self.ctx.config["teacher_config"]]
        W = {p: {k: v.to(dev) for k, v in w.items()}
             for p, w in self.W.items()}
        ref = RK.KDReference(
            W["student"], W["projectors"], W["teacher"], tcfg_d["teacher"],
            self.scfg.feature_tokens, lr=self.tr_cfg.learning_rate,
            encoder_scale=self.tr_cfg.encoder_lr_scale,
            weight_decay=self.tr_cfg.weight_decay,
            clip=self.tr_cfg.grad_clip, dropout=self.tr_cfg.dropout,
            r_student=ROUNDINGS[r_student], r_teacher=ROUNDINGS[r_teacher])
        W0 = {n: ref.P[n].detach().clone() for n in ref.trainable}
        draws = [RK.Draws(g["uniform"], g["flip"], g["masks"])
                 for g in self.checked["groups"]]
        losses, grad1 = [], {}
        for k in range(len(self.checked["losses"])):
            b = self.batches[k % len(self.batches)]
            batch = {"images": torch.from_numpy(b["images"]).to(dev),
                     "captions": torch.from_numpy(b["captions"]).long().to(dev),
                     "lengths": torch.from_numpy(b["lengths"]).long().to(dev)}
            loss, grads = ref.step(batch, draws[k * self.A:(k + 1) * self.A],
                                   self.sched_t(k))
            losses.append(loss)
            if k == 0:
                g1 = grads
        change = {n: (ref.P[n].detach() - W0[n]).cpu() for n in ref.trainable}
        return {"losses": losses, "change": change, "g1": g1,
                "grad1": {n: float(g.norm()) for n, g in g1.items()}}

    def compare(self, got: dict, ref: dict) -> dict:
        """Each step's loss and the first's, the worst and the median leaf
        of the first gradient and of the change, the worst direction of
        the projector's first gradient, each beside its limit
        (None: read, not compared).  Left out, by the reference's first
        gradient: a leaf whose norm is under a thousandth of the median
        leaf's, and from the change an element whose gradient is under a
        thousandth of the median leaf's root mean square (a key's bias
        under softmax, a slice of the packed in-projection bias: Adam moves
        it by round-off alone)."""
        g1 = ref["g1"]
        med = statistics.median(ref["grad1"].values())
        leaves = [n for n, g in ref["grad1"].items() if g >= 1e-3 * med]
        rms = statistics.median(float(g1[n].norm()) / math.sqrt(g1[n].numel())
                                for n in leaves)
        keep = {n: (g1[n].abs() >= 1e-3 * rms).cpu() for n in leaves}
        norm = {k: {n: float(t[n][keep[n]].norm()) for n in leaves}
                for k, t in (("got", got["change"]), ("ref", ref["change"]))}
        losses = [rel_gap(a, b) for a, b in zip(got["losses"], ref["losses"])]
        grad = leaf_gaps(got["grad1"], ref["grad1"], leaves)
        change = leaf_gaps(norm["got"], norm["ref"], leaves)
        # the first gradient's difference, leaf by leaf: what separates a
        # step over half the batch (a gap of norms reads sampling noise)
        diff = {n: float((got["g1"][n].cpu() - g1[n].cpu()).norm())
                / max(ref["grad1"][n], 1e-30) for n in leaves}
        # the direction of each leaf's first gradient (unit norm: the clip's
        # scale, set by the whole gradient, drops out); the projector's
        # leaves take no gradient through the recurrence
        direction = {n: unit_gap(got["g1"][n], g1[n]) for n in leaves}
        proj = [n for n in leaves if n.startswith(PROJECTOR)]
        got = dict(got, change=norm["got"])
        ref = dict(ref, change=norm["ref"])
        self.worst = {k: sorted(((round(v, 5), n, got[k][n], ref[k][n])
                                 for n, v in g.items()), reverse=True)[:4]
                      for k, g in (("grad1", grad), ("change", change))}
        self.worst["direction"] = {n: round(v, 5)
                                   for n, v in direction.items()}
        lim = self.ctx.traffic["limits"]
        out = {"loss_gap": max(losses), "loss_gap_first": losses[0],
               "proj_dir_gap": max(direction[n] for n in proj)
               if proj else math.inf,
               "grad_gap": max(grad.values()),
               "grad_gap_median": statistics.median(grad.values()),
               "grad_diff_median": statistics.median(diff.values()),
               "grad_diff": math.sqrt(sum(
                   (diff[n] * ref["grad1"][n]) ** 2 for n in leaves)
                   / sum(ref["grad1"][n] ** 2 for n in leaves)),
               "change_gap": max(change.values()),
               "change_gap_median": statistics.median(change.values())}
        return {k: (v, lim.get(k)) for k, v in out.items()}

    def check(self) -> dict:
        self.release()
        return self.compare(self.checked, self.ref_readings())


def build(ctx):
    return KDTrain(ctx)


def control(unit, calls: int) -> dict:
    """The control: the reference in the program's place with the
    student's products in fp8 (below its bf16) and the teacher's in TF32
    (below its float32), against the float32 reference."""
    unit.release()
    return unit.compare(unit.ref_readings("fp8", "tf32"), unit.ref_readings())
