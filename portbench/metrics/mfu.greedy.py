"""Model operations of the images captioned in the window (ResNet-50, the
projection and refinement, the decode steps each batch needed) over its
seconds and the bf16 peak."""

import statistics

from portbench.readers import mfu_pct
from portbench.work import resnet50, student


def read(run):
    s = run.ctx.config["student"]
    steps = statistics.mean(run.unit.steps)
    per_image = (2.0 * (resnet50.macs(s["image_size"])
                        + student.encoder_head_macs(s))
                 + student.decode(s, 1, steps)[0])
    return mfu_pct(run, per_image)
