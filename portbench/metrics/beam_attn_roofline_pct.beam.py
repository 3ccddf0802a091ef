"""The beam step's two attention cores (#9 over the ancestry, #10 over the
memory) against their float32 roofline; the steps run are counted from
the traced ranges, four layers a step."""

from portbench.readers import roofline_pct
from portbench.work import teacher_decoder

SELF = "imagecaptioner_tpu_torch.models.transformer:beam_self_attention"
WRAP = [SELF, "imagecaptioner_tpu_torch.models.transformer:beam_cross_attention"]


def read(run):
    if run.trace is None:
        return None
    t = run.ctx.config["teacher"]
    u = run.unit
    spans = run.trace.within([SELF])["spans"]
    steps = spans // (t["num_decoder_layers"] * run.trace.calls)
    work = [teacher_decoder.beam_attention(t, u.B * u.K, u.B, p)
            for p in range(steps)]
    n = run.trace.calls
    return roofline_pct(run, n * sum(w[0] for w in work),
                        n * sum(w[1] for w in work), "float32", WRAP)
