"""The teacher's encode_image (ViT-S/16 and the projection) against its
float32 roofline."""

from portbench.readers import roofline_pct
from portbench.work import vit

WRAP = ["imagecaptioner_tpu_torch.models.teacher:Teacher.encode_image"]


def read(run):
    if run.trace is None:
        return None
    ops, nbytes = vit.encode(run.ctx.config["teacher"], run.unit.B)
    n = run.trace.calls
    return roofline_pct(run, n * ops, n * nbytes, "float32", WRAP)
