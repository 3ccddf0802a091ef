"""The student's encode_image (ResNet-50, projection, refinement) against
its bf16 roofline."""

from portbench.readers import roofline_pct
from portbench.work import resnet50, student

WRAP = ["imagecaptioner_tpu_torch.models.student:Student.encode_image"]


def read(run):
    s, B = run.ctx.config["student"], run.unit.B
    ops, nbytes = resnet50.forward(B, s["image_size"])
    ops += 2.0 * B * student.encoder_head_macs(s)
    nbytes += 2.0 * (B * s["feature_tokens"] * s["embed_size"]
                     + student.head_params(s))
    n = run.trace.calls if run.trace else 0
    return roofline_pct(run, n * ops, n * nbytes, "bfloat16", WRAP)
