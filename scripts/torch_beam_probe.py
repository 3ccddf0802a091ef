#!/usr/bin/env python3
"""Where the time of the beam self-attention kernel (#9) goes, on one
NVIDIA GPU.

    python3 scripts/torch_beam_probe.py [--against OTHER_CSRC_DIR ...]

1. Builds a copy of ``csrc/`` in which thread 0 of every block of
   ``beam_self_kernel`` (``beam_attention.cu``) reads its SM's clock at the
   kernel's phase boundaries, runs the kernel once at the beam path's shape
   (N=16 images, K=5 beams, 8 heads, pos=19) in float32 and bf16, and
   prints the median over the blocks of the cycles of each phase: barrier
   set-up and the bulk copies' issue, q and the first wait for the whole
   block, k landing, scores and softmax, v landing, P.V; then each block's
   span (%globaltimer), the kernel's span and the spread of the blocks'
   starts.  The copy is a temporary directory and builds a library of its
   own hash; the repository's sources are not touched.
2. Times #9 queued (``chip_smoke.queued_ms``) and per call, with its
   largest difference from the plain version, from this tree and from each
   ``--against`` directory (another checkout's ``csrc/``, whose
   ``ic_beam_self_attention`` has the same interface) in turns: others,
   this, this, others.
3. Prints the queued time of one tiny PyTorch kernel (the floor of any
   launch in that measurement) and the card's ``nvidia-smi`` name, power
   limit and SM clock.

Exits non-zero without a card.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402
from imagecaptioner_tpu_torch.ops import _build  # noqa: E402
from imagecaptioner_tpu_torch.ops import beam_attn as BA  # noqa: E402

STAMPS = 8  # clock slots a block
HEADER = ("__device__ unsigned long long probe_clk[4096 * 8];\n"
          "__device__ unsigned long long probe_ns[4096 * 2];\n")
READER = ('extern "C" int ic_probe_read(unsigned long long* c, '
          "unsigned long long* g) {\n"
          "  cudaMemcpyFromSymbol(c, probe_clk, sizeof(probe_clk));\n"
          "  return (int)cudaMemcpyFromSymbol(g, probe_ns, sizeof(probe_ns));\n}\n")
PHASES = ("barriers and copies issued", "q and the block's wait", "k landed",
          "scores and softmax", "v landed", "P.V")


def clock(k: int) -> str:
    return ("if (threadIdx.x == 0) probe_clk[blockIdx.x * 8 + %d] = clock64(); "
            % k)


def wall(k: int) -> str:
    return ("if (threadIdx.x == 0) { unsigned long long t_; asm volatile("
            "\"mov.u64 %%0, %%%%globaltimer;\" : \"=l\"(t_)); "
            "probe_ns[blockIdx.x * 2 + %d] = t_; } " % k)


# (line of beam_self_kernel, what goes after it)
MARKS = [
    ("  const bool live = warp < K - g0;  // the last group may have fewer beams "
     "than warps\n", wall(0) + clock(0) + "\n"),
    ("  if (live) copy2(q_s", None),  # clock 1 goes before this line
    ("  __syncthreads();  // every beam's q is in place\n", clock(2) + "\n"),
    ("    bulk_wait(&bar[t & 1], (t >> 1) & 1);  // stage t has landed\n",
     "if (t == 0) { " + clock(3) + "} if (t == 1) { " + clock(5) + "}\n"),
    ("        x[1] = to_f(from_f<T>(e1 / sum));\n", clock(4) + "\n"),
    ("  if (live) store2(out + (size_t)r * out_stride + h * D + 2 * lane, a0, "
     "a1);\n", None),  # clock 6 before, the wall clock after
]


def stamped_copy() -> Path:
    """csrc/ with the clock reads of ``MARKS`` in beam_self_kernel."""
    tmp = Path(tempfile.mkdtemp(prefix="ic_beam_probe_"))
    for f in _build.CSRC.glob("*.cu*"):
        shutil.copy(f, tmp)
    path = tmp / "beam_attention.cu"
    src = path.read_text().replace("namespace {\n", "namespace {\n" + HEADER, 1)
    for i, (line, after) in enumerate(MARKS):
        if src.count(line) != 1:
            raise SystemExit(f"probe: line not found once in beam_attention.cu: "
                             f"{line!r}")
        if i == 1:
            src = src.replace(line, clock(1) + "\n" + line)
        elif i == len(MARKS) - 1:
            src = src.replace(line, clock(6) + "\n" + line + wall(1) + "\n")
        else:
            src = src.replace(line, line + after)
    path.write_text(src + READER)
    return tmp


def operands(dev, dtype):
    o = CS.beam_operands(dev, CS.BEAM_B, dtype, CS.MAX_LEN - 1, CS.SEED + 30)
    run = lambda: BA.beam_self_attention_cuda(  # noqa: E731
        o["q"], o["kv"], o["anc"], o["pos"], num_heads=CS.BEAM_H)
    return o, run


def phases(dev) -> None:
    real = _build.CSRC
    tmp = stamped_copy()
    CS.forget_libraries()
    _build.CSRC = tmp
    try:
        for dtype in (torch.float32, torch.bfloat16):
            _, run = operands(dev, dtype)
            for _ in range(5):
                run()
            torch.cuda.synchronize()
            run()
            torch.cuda.synchronize()
            lib = _build.library("beam_attention")
            clk = (ctypes.c_ulonglong * (4096 * STAMPS))()
            ns = (ctypes.c_ulonglong * (4096 * 2))()
            lib.ic_probe_read.argtypes = [ctypes.c_void_p] * 2
            lib.ic_probe_read(ctypes.byref(clk), ctypes.byref(ns))
            nb = CS.BEAM_B * CS.BEAM_H
            c = np.array(clk[:nb * STAMPS], dtype=np.int64).reshape(nb, STAMPS)
            g = np.array(ns[:nb * 2], dtype=np.int64).reshape(nb, 2)
            d = np.diff(c[:, :7], axis=1)
            print(f"#9 {str(dtype)[6:]} N={CS.BEAM_B} K={CS.BEAM_K} "
                  f"pos={CS.MAX_LEN - 1}, cycles a phase (median of {nb} "
                  "blocks): " + ", ".join(
                      f"{name} {int(np.median(d[:, i]))}"
                      for i, name in enumerate(PHASES))
                  + f"; a block {int(np.median(c[:, 6] - c[:, 0]))} cycles, "
                  f"{int(np.median(g[:, 1] - g[:, 0]))} ns; the kernel "
                  f"{int(g[:, 1].max() - g[:, 0].min())} ns, starts spread "
                  f"over {int(g[:, 0].max() - g[:, 0].min())} ns", flush=True)
    finally:
        _build.CSRC = real
        CS.forget_libraries()
        shutil.rmtree(tmp, ignore_errors=True)


def in_turns(dev, others) -> None:
    real = _build.CSRC
    try:
        for d in others + [real, real] + others[::-1]:
            CS.forget_libraries()
            _build.CSRC = type(real)(d)
            for dtype in (torch.float32, torch.bfloat16):
                o, run = operands(dev, dtype)
                err = (run().float() - BA.beam_self_attention_plain(
                    o["q"], o["kv"], o["anc"], o["pos"],
                    num_heads=CS.BEAM_H).float()).abs().max().item()
                print(f"#9 from {d} {str(dtype)[6:]}: queued "
                      f"{CS.queued_ms(run):.5f} ms, per call "
                      f"{CS.median_ms(run, 200):.5f} ms, max_abs_err {err:.3e}",
                      flush=True)
    finally:
        _build.CSRC = real
        CS.forget_libraries()


def main() -> int:
    if not torch.cuda.is_available():
        CS.fail("torch.cuda.is_available() is false: this script runs on the card")
    dev = torch.device("cuda", 0)
    others = [Path(a) for i, a in enumerate(sys.argv)
              if i > 0 and sys.argv[i - 1] == "--against"]
    phases(dev)
    in_turns(dev, others)
    x = torch.zeros(1, device=dev)
    print(f"queued floor (one tiny PyTorch kernel): "
          f"{CS.queued_ms(lambda: x.add_(1)):.5f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
