"""Model operations of the images trained in the window over its seconds
and the bf16 peak: the teacher's forward, the student's forward, and the
backward of the trained layers at twice their forward."""

from portbench.readers import mfu_pct
from portbench.work import resnet50, student, teacher_decoder, vit


def read(run):
    s = run.ctx.config["student"]
    t = run.ctx.configs[run.ctx.config["teacher_config"]]["teacher"]
    T = run.unit.T - 1
    L, E = s["feature_tokens"], s["embed_size"]
    teacher = vit.encode(t, 1)[0] + 2.0 * teacher_decoder.forced_macs(t, T)
    head = student.encoder_head_macs(s) + L * E * E + T * student.step_macs(s)
    projector = vit.tokens(t) * t["embed_size"] * E
    fwd = resnet50.macs(s["image_size"]) + head + projector
    trained = resnet50.trained_macs(s["image_size"]) + head + projector
    return mfu_pct(run, teacher + 2.0 * fwd + 4.0 * trained)
