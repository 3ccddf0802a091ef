#!/usr/bin/env python3
"""Kernel #2 (``csrc/attention_core.cu``) of this tree against another
tree's, on one NVIDIA GPU.

    python3 scripts/torch_attention_ab.py --against OTHER_CSRC_DIR

Builds ``OTHER_CSRC_DIR/attention_core.cu`` (another checkout's
``csrc/``, e.g. a ``git archive`` of the parent commit) into a temporary
directory beside this tree's library, then at every shape where a main
path launches #2 (``chip_smoke.ATTN_PATH_SHAPES``: full-length, causal
with Lq == Lk, and cross-attention) checks that both trees' outputs are
bit-identical and times both per call and queued in turns (other, this,
this, other).  An interface without ``q_offset`` (the form before the
offset) is called without it.  Prints the card's ``nvidia-smi`` name and
power limit; exits non-zero without a card or on any difference.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402
from imagecaptioner_tpu_torch.ops import _build  # noqa: E402
from imagecaptioner_tpu_torch.ops import attention as A  # noqa: E402


def other_kernel(csrc: Path, tmp: str):
    """The other tree's entry point, and whether it takes ``q_offset``."""
    src = csrc / "attention_core.cu"
    lib = Path(tmp) / "libattention_core_other.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).ic_attention_core
    with_offset = "q_offset" in src.read_text()
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_int]
                   + [ctypes.c_int] * with_offset + [ctypes.c_void_p])
    return fn, with_offset


def main() -> int:
    if not torch.cuda.is_available() or "--against" not in sys.argv:
        print(__doc__, file=sys.stderr)
        return 2
    csrc = Path(sys.argv[sys.argv.index("--against") + 1])
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {smi}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    bad = 0
    with tempfile.TemporaryDirectory() as tmp:
        fn, with_offset = other_kernel(csrc, tmp)
        codes = {torch.float32: 0, torch.bfloat16: 1}
        for name, (B, H, lq, lk, d, causal, dt) in \
                CS.ATTN_PATH_SHAPES.items():
            q = torch.randn((B, H, lq, d), device=dev, generator=gen).to(dt)
            k, v = (torch.randn((B, H, lk, d), device=dev, generator=gen
                                ).to(dt) for _ in range(2))
            sc = d ** -0.5

            def other():
                out = torch.empty_like(q)
                args = [codes[dt], codes[dt], q.data_ptr(), k.data_ptr(),
                        v.data_ptr(), out.data_ptr(), B * H, lq, lk, d, sc,
                        int(causal)] + [0] * with_offset
                err = _build.call_on(dev, fn, *args)
                if err:
                    raise RuntimeError(f"other kernel: CUDA error {err}")
                return out

            def this():
                return A.attention_core_cuda(q, k, v, causal=causal, scale=sc)

            same = torch.equal(other(), this())
            bad += not same
            t = {}
            for tag, f in (("other", other), ("this", this), ("this2", this),
                           ("other2", other)):
                t[tag] = (CS.median_ms(f, 100), CS.queued_ms(f, 100))
            print(f"{name} ({B},{H},{lq}x{lk},{d}) {str(dt)[6:]} "
                  f"causal={causal}: bit-identical {same}; per call / queued "
                  f"ms other {t['other'][0]:.4f} / {t['other'][1]:.4f}, this "
                  f"{t['this'][0]:.4f} / {t['this'][1]:.4f}, this "
                  f"{t['this2'][0]:.4f} / {t['this2'][1]:.4f}, other "
                  f"{t['other2'][0]:.4f} / {t['other2'][1]:.4f}", flush=True)
    print(f"{smi}: {len(CS.ATTN_PATH_SHAPES) - bad} of "
          f"{len(CS.ATTN_PATH_SHAPES)} shapes bit-identical")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
