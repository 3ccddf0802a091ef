"""Greedy serving of a CNN-LSTM student: the port's
``eval/serve.make_greedy_captioner`` called on host uint8 batches, tokens
back on the host.

Traffic (``workloads/*.json``): ``batch`` distinct images a call, drawn
from a seeded pool of ``pool`` images (``pool / batch`` fixed batches,
called in a seeded order, one caller, closed loop), ``max_length`` greedy
steps.  The check: ``check_images`` served images, slot by slot of the
batch (each slot's call drawn from the seed), the longest caption among
them; each served token's gap below the float32 reference's best logit at
its position (``reference/student.greedy_gaps``), the mean over all the
served tokens.  Read, not compared: the largest of the images' own means,
and the widest single gap.  On sound runs both swing with the rows whose
bf16 recurrence drifts from float32, and the int8 control's least reading
of each is under three times the program's largest (``PERF.md``).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as TF
from portbench import weights as WT
from portbench.reference import student as RS


def student_weights(shapes, cfg: dict, seed: int, dev, dtype):
    """The student's weights from the seed (``weights.draw``), its batch
    norms' running statistics calibrated on ``init.calibrate_bn`` seeded
    images (``reference/student.calibrate_bn``)."""
    W = WT.draw(shapes, cfg["init"], seed, dev, dtype)
    n = cfg["init"].get("calibrate_bn")
    if n:
        size = cfg["student"]["image_size"]
        RS.calibrate_bn(W, torch.from_numpy(
            TF.images(int(n), size, seed + 3, dev)).to(dev))
    return W


class Greedy:
    def __init__(self, ctx):
        from imagecaptioner_tpu_torch.core.config import StudentConfig
        from imagecaptioner_tpu_torch.core.modules import cast_parameters
        from imagecaptioner_tpu_torch.eval import serve
        from imagecaptioner_tpu_torch.models.student import Student
        from imagecaptioner_tpu_torch.ops import _build
        self.ctx = ctx
        tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
        self.scfg = StudentConfig(**cfg["student"])
        self.dtype = getattr(torch, cfg["compute_dtype"])
        self.B, self.T = int(tr["batch"]), int(tr["max_length"])
        if dev.type == "cuda":
            with ctx.phase("kernels"):
                _build.build_all(tr["kernels"])
        with ctx.phase("weights"):
            with torch.device(dev):
                model = Student(self.scfg)
            model = model.to(dev).eval()
            self.W = student_weights(WT.shapes_of(model), cfg, ctx.seed, dev,
                                     self.dtype)
            WT.load_into(model, self.W)
            self.W = {k: v.cpu() for k, v in self.W.items()}  # the reference's
            cast_parameters(model, self.dtype)
            self.model = model
        with ctx.phase("pool"):
            size = self.scfg.image_size
            pool = TF.images(int(tr["pool"]), size, ctx.seed + 1, dev)
            self.batches = pool.reshape(-1, self.B, size, size, 3)
            rng = np.random.default_rng(ctx.seed)
            self.order = rng.permutation(len(self.batches))
        self.caption = serve.make_greedy_captioner(
            model, self.scfg, dev, max_length=self.T)
        with ctx.phase("warm-up"):
            for _ in range(int(tr.get("warm_calls", 2))):
                self.caption(self.batches[0])
        self.out = {}
        self.failed = 0
        self.steps = []          # decode steps the last call's rows needed

    def call(self, i: int) -> int:
        k = int(self.order[i % len(self.order)])
        toks = self.caption(self.batches[k])
        if toks.shape != (self.B, self.T) or toks.min() < 0 \
                or toks.max() >= self.scfg.vocab_size:
            self.failed += 1
        self.out[k] = toks
        self.steps.append(self.needed_steps(toks))
        return self.B

    def needed_steps(self, toks: np.ndarray) -> int:
        """Steps until the last row emits END (all ``T`` if one never does)."""
        pad = toks == RS.PAD
        ends = np.where(pad.any(1), pad.argmax(1) + 1, self.T)
        return int(ends.max())

    def finish(self) -> None:
        pass

    def release(self) -> None:
        self.model = self.caption = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """(images, tokens) of ``check_images`` served images, slot by slot
        of the batch, each slot's call drawn from the seed; the image with
        the longest caption takes its slot's place."""
        keys = sorted(self.out)
        n = int(self.ctx.traffic["check_images"])
        rng = np.random.default_rng(self.ctx.seed + 2)
        pairs = {(int(keys[rng.integers(len(keys))]), j % self.B)
                 for j in range(n)}
        lengths = {(k, j): int(v) for k in keys
                   for j, v in enumerate((self.out[k] != RS.PAD).sum(1))}
        top = max(sorted(lengths), key=lengths.get)
        pairs = sorted({p for p in pairs if p[1] != top[1]} | {top})
        return (np.stack([self.batches[k][j] for k, j in pairs]),
                np.stack([self.out[k][j] for k, j in pairs]))

    def check(self) -> dict:
        imgs, toks = self.sample()
        self.release()
        dev = self.ctx.device
        W = {k: v.to(dev) for k, v in self.W.items()}
        gaps = RS.greedy_gaps(W, torch.from_numpy(imgs).to(dev),
                              torch.from_numpy(toks).to(dev))
        return self.compare(gaps)

    def compare(self, gaps: torch.Tensor) -> dict:
        """gaps (N, T), -inf where nothing was served."""
        lim = self.ctx.traffic["limits"]
        ok = torch.isfinite(gaps)
        row = torch.where(ok, gaps, 0.0).sum(1) / ok.sum(1).clamp(min=1)
        return {"token_gap_mean": (float(gaps[ok].mean()),
                                   lim["token_gap_mean"]),
                "row_gap_max": (float(row.max()), lim.get("row_gap_max"))}


def build(ctx):
    return Greedy(ctx)


def control(unit, calls: int) -> dict:
    """The control: the port's own lower-precision path, int8 encoders
    (``serve.int8_serving_copy(int8=True)``, kernels #11 and #12), served
    and checked as the cell serves and checks."""
    from imagecaptioner_tpu_torch.eval import serve
    unit.model = serve.int8_serving_copy(unit.model, "student", int8=True,
                                         verbose=False)
    unit.caption = serve.make_greedy_captioner(
        unit.model, unit.scfg, unit.ctx.device, max_length=unit.T)
    unit.out = {}
    for i in range(calls):
        unit.call(i)
    return unit.check()
