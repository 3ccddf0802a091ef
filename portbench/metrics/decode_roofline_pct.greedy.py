"""The greedy decode (feature projection and the steps the batch needed)
against its bf16 roofline."""

from portbench.readers import roofline_pct
from portbench.work import student

WRAP = ["imagecaptioner_tpu_torch.eval.serve:best_greedy_decode_student"]


def read(run):
    if run.trace is None:
        return None
    s = run.ctx.config["student"]
    work = [student.decode(s, run.unit.B, k)
            for k in run.unit.steps[:run.trace.calls]]
    return roofline_pct(run, sum(w[0] for w in work),
                        sum(w[1] for w in work), "bfloat16", WRAP)
