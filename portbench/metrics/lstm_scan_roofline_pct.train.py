"""The teacher-forced recurrence (#4/#5 forward) and its reverse chain (#6,
launched by the autograd node of ``ops/lstm_scan._DecoderScan``) against
their bf16 roofline."""

from portbench.readers import roofline_pct
from portbench.work import student

WRAP = ["imagecaptioner_tpu_torch.models.lstm:decoder_scan"]
OPS = ["_DecoderScanBackward"]


def read(run):
    if run.trace is None:
        return None
    u = run.unit
    ops, nbytes = student.scan(run.ctx.config["student"], u.B, u.T - 1, True)
    n = run.trace.calls * u.A
    return roofline_pct(run, n * ops, n * nbytes, "bfloat16", WRAP, OPS)
