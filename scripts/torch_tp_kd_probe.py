#!/usr/bin/env python3
"""What moves a KD step on a (data, model) world away from one process, on
one NVIDIA GPU.

    python3 scripts/torch_tp_kd_probe.py

Runs ``chip_smoke.tp_kd_step`` (one float32 KD step of the full student,
A=1 x B=8 a data index, global 16, T=47, V=2994) on a (2, 2) world (the
teacher placed by ``parallel.tp`` and run inside ``parallel.sp``'s policy)
and on a (2, 1) world (data parallelism alone, the teacher unsharded), four
and two ranks sharing the card over gloo, and holds rank 0 of each against
one process on the global batch twice: with the stock batch norm and with
the data-parallel batch norm's arithmetic over its one process.  Prints
``chip_smoke.compare_step``'s worst updated parameter and gradient outside
the ResNet, the ResNet's gradients together, and the gradient norms: if
both worlds sit equally far from the stock process and close to the other,
the batch norm's formula, not the model axis, is what moves them.  Prints
the card's ``nvidia-smi`` name and power limit; exits non-zero without a
card.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402
from imagecaptioner_tpu_torch.core import mesh as MS  # noqa: E402
from imagecaptioner_tpu_torch.parallel import multihost as MH  # noqa: E402


def rank(out, shape, device="cuda:0"):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    mesh = MS.create_mesh(dev, shape=tuple(shape))
    np.savez(os.path.join(out, f"rank{mesh.rank}.npz"),
             **CS.tp_kd_step(dev, mesh))


def report(tag, r, ref):
    lr = CS.KDTrainConfig().learning_rate
    c = CS.compare_step(dict(r, grad_norm=float(r["grad_norm"])),
                        dict(ref, grad_norm=float(ref["grad_norm"])),
                        "kd.", lr)
    print(f"{tag}: parameters {c['params'][0]:.3e} ({c['params'][1]}), "
          f"gradients {c['grads'][0]:.3e} ({c['grads'][1]}), the ResNet's "
          f"{c['resnet_grads']:.3e}; grad norm {float(r['grad_norm']):.7f} "
          f"against {float(ref['grad_norm']):.7f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}")
    CS._build.build_all()
    stock = CS.tp_kd_step(dev)
    same = CS.tp_kd_step(dev, dp_batch_norm=True)
    for shape in ((2, 2), (2, 1)):
        n = shape[0] * shape[1]
        with tempfile.TemporaryDirectory() as tmp:
            MH.launch(rank, ["cuda:0"] * n, backend="gloo", in_parent=False,
                      kwargs=dict(out=tmp, shape=shape), timeout_s=300,
                      init_file=os.path.join(tmp, "store"))
            r = dict(np.load(os.path.join(tmp, "rank0.npz")))
        report(f"{shape} world vs the stock process", r, stock)
        report(f"{shape} world vs the data-parallel batch norm's process",
               r, same)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
