"""Beam serving of the teacher: the port's ``eval/serve.make_beam_captioner``
called on host uint8 batches, hypotheses back on the host.

Traffic (``workloads/*.json``): ``batch`` distinct images a call from a
seeded pool of ``pool`` images (fixed batches called in a seeded order,
one caller, closed loop), ``beam_size`` beams, ``max_length`` steps.  The
check: for ``check_images`` served images drawn from the seed, each
returned hypothesis's score against the length-normalized log-probability
that the float32 reference gives its tokens (``reference/teacher``), the
score of the hypothesis returned first against the best that the
reference's own beam search finds, and that every finished hypothesis ends
in END; over every stored call, that each image's hypotheses come in order
of score.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as TF
from portbench import weights as WT
from portbench.reference import teacher as RT
from portbench.reference.precision import ROUNDINGS


class Beam:
    def __init__(self, ctx):
        from imagecaptioner_tpu_torch.core.config import TeacherConfig
        from imagecaptioner_tpu_torch.eval import serve
        from imagecaptioner_tpu_torch.models.teacher import Teacher
        from imagecaptioner_tpu_torch.ops import _build
        self.ctx = ctx
        tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
        self.tcfg = TeacherConfig(**cfg["teacher"])
        self.dtype = getattr(torch, cfg["compute_dtype"])
        self.B, self.K = int(tr["batch"]), int(tr["beam_size"])
        self.T = int(tr["max_length"])
        if dev.type == "cuda":
            with ctx.phase("kernels"):
                _build.build_all(tr["kernels"])
        with ctx.phase("weights"):
            with torch.device(dev):
                model = Teacher(self.tcfg)
            model = model.to(dev).eval()
            W = WT.draw(WT.shapes_of(model), cfg["init"], ctx.seed, dev,
                        self.dtype)
            WT.load_into(model, W)
            self.W = {k: v.cpu() for k, v in W.items()}  # the reference's
            self.model = model.to(self.dtype)
        with ctx.phase("pool"):
            size = self.tcfg.image_size
            pool = TF.images(int(tr["pool"]), size, ctx.seed + 1, dev)
            self.batches = pool.reshape(-1, self.B, size, size, 3)
            self.order = np.random.default_rng(ctx.seed).permutation(
                len(self.batches))
        self.caption = serve.make_beam_captioner(
            self.model, self.tcfg, dev, max_length=self.T,
            beam_size=self.K)
        with ctx.phase("warm-up"):
            for _ in range(int(tr.get("warm_calls", 2))):
                self.caption(self.batches[0])
        self.out = {}
        self.failed = 0
        self.steps = []

    def call(self, i: int) -> int:
        k = int(self.order[i % len(self.order)])
        seqs, scores, lens = self.caption(self.batches[k])
        S = self.T + 1
        if seqs.shape != (self.B, self.K, S) or lens.shape != (self.B, self.K) \
                or not np.isfinite(scores[:, 0]).all():
            self.failed += 1
        self.out[k] = (seqs, scores, lens)
        self.steps.append(int(lens.max()) - 1)
        return self.B

    def finish(self) -> None:
        pass

    def release(self) -> None:
        self.model = self.caption = None
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        keys = sorted(self.out)
        imgs = np.concatenate([self.batches[k] for k in keys])
        seqs, scores, lens = (np.concatenate([self.out[k][j] for k in keys])
                              for j in range(3))
        n = min(int(self.ctx.traffic["check_images"]), len(seqs))
        rng = np.random.default_rng(self.ctx.seed + 2)
        pick = rng.choice(len(seqs), n, replace=False)
        pick[0] = int(lens.max(1).argmax())
        pick = np.unique(pick)
        return imgs[pick], seqs[pick], scores[pick], lens[pick]

    def ref_scores(self, imgs, seqs, lens, rounding: str = "float32"):
        """The reference's scores of the hypotheses (weights drawn again)."""
        dev = self.ctx.device
        W = {k: v.to(dev) for k, v in self.W.items()}
        return RT.beam_scores(W, self.ctx.config["teacher"],
                              torch.from_numpy(imgs).to(dev),
                              torch.from_numpy(seqs).to(dev),
                              torch.from_numpy(lens).to(dev),
                              ROUNDINGS[rounding]).cpu().numpy()

    def ref_best(self, imgs, rounding: str = "float32") -> np.ndarray:
        """The best score of the reference's own beam search."""
        dev = self.ctx.device
        W = {k: v.to(dev) for k, v in self.W.items()}
        return RT.beam_search(W, self.ctx.config["teacher"],
                              torch.from_numpy(imgs).to(dev), self.K, self.T,
                              ROUNDINGS[rounding]).numpy()

    def unordered(self) -> int:
        """Served images whose hypotheses' scores rise somewhere."""
        bad = 0
        for _, scores, _ in self.out.values():
            s = np.where(np.isfinite(scores), scores, -np.inf)
            bad += int((s[:, 1:] > s[:, :-1]).any(1).sum())
        return bad

    def compare(self, seqs, scores, lens, ref, best, ref_best,
                unordered: int) -> dict:
        """``best``: the score the searcher put first; ``ref_best``: the
        reference search's best; the shortfall is read in the reference's
        favour only (a searcher may find a better beam at a near tie)."""
        fin = np.isfinite(scores)
        # a hypothesis shorter than S has finished, so it ends in END
        end = RT.ended(torch.from_numpy(seqs), torch.from_numpy(lens)).numpy()
        bad_end = fin & (lens < self.T + 1) & ~end
        gap = np.abs(scores[fin] - ref[fin])
        gap = float(gap.max()) if gap.size and np.isfinite(ref[fin]).all() \
            else float("inf")
        short = np.asarray(ref_best, np.float64) - np.asarray(best,
                                                              np.float64)
        short = float(max(0.0, short.max())) if np.isfinite(short).all() \
            else float("inf")
        lim = self.ctx.traffic["limits"]
        return {"score_gap": (gap, lim["score_gap"]),
                "best_shortfall": (short, lim.get("best_shortfall")),
                "unended": (float(bad_end.sum()), lim["unended"]),
                "unordered": (float(unordered), lim["unordered"])}

    def check(self) -> dict:
        imgs, seqs, scores, lens = self.sample()
        unordered = self.unordered()
        self.release()
        return self.compare(seqs, scores, lens,
                            self.ref_scores(imgs, seqs, lens), scores[:, 0],
                            self.ref_best(imgs), unordered)


def build(ctx):
    return Beam(ctx)


def control(unit, calls: int) -> dict:
    """The control: the reference in TF32 in the program's place, its
    scores of the served hypotheses and its own search's best against the
    float32 reference's."""
    for i in range(calls):
        unit.call(i)
    imgs, seqs, _, lens = unit.sample()
    unit.release()
    return unit.compare(seqs, unit.ref_scores(imgs, seqs, lens, "tf32"), lens,
                        unit.ref_scores(imgs, seqs, lens),
                        unit.ref_best(imgs, "tf32"), unit.ref_best(imgs), 0)
