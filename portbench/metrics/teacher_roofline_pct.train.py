"""The frozen float32 teacher's forward for KD (ViT, projection, the
teacher-forced decoder and head) against its float32 roofline."""

from portbench.readers import roofline_pct
from portbench.work import teacher_decoder, vit

WRAP = ["imagecaptioner_tpu_torch.train.steps:teacher_forward_for_kd"]


def read(run):
    if run.trace is None:
        return None
    t = run.ctx.configs[run.ctx.config["teacher_config"]]["teacher"]
    u = run.unit
    ops, nbytes = vit.encode(t, u.B)
    ops += 2.0 * u.B * teacher_decoder.forced_macs(t, u.T - 1)
    n = run.trace.calls * u.A
    return roofline_pct(run, n * ops, n * nbytes, "float32", WRAP)
