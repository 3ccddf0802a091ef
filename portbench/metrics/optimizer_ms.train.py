"""Device ms a step of the global-norm clip and AdamW."""

from portbench.readers import per_call_ms

WRAP = ["imagecaptioner_tpu_torch.train.optim:clip_by_global_norm",
        "imagecaptioner_tpu_torch.train.optim:adamw_update"]


def read(run):
    return per_call_ms(run, WRAP)
