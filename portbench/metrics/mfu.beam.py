"""Model operations of the images captioned in the window (ViT-S/16, the
projection, the memory's K/V, every beam row of the steps each batch ran)
over its seconds and the bf16 peak."""

import statistics

from portbench.readers import mfu_pct
from portbench.work import teacher_decoder, vit


def read(run):
    t = run.ctx.config["teacher"]
    u = run.unit
    steps = round(statistics.mean(u.steps))
    per_image = (vit.encode(t, 1)[0]
                 + 2.0 * teacher_decoder.memory_kv_macs(t)
                 + 2.0 * u.K * sum(teacher_decoder.beam_step_macs(t, p)
                                   for p in range(steps)))
    return mfu_pct(run, per_image)
