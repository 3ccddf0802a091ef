#!/usr/bin/env python3
"""Where the time of the cooperative step chains goes, on one NVIDIA GPU.

    python3 scripts/torch_chain_probe.py [--against OTHER_CSRC_DIR]

1. Builds a copy of ``csrc/`` in which block 0 of ``greedy_decode.cu`` (#1),
   ``decoder_scan.cu`` (#4/#5), ``enhanced_scan.cu`` (#8),
   ``greedy_decode_compact.cu`` (#3) and ``compact_scan.cu`` (#7) reads
   %globaltimer after every grid barrier, runs each once at the main path's
   shapes in bf16 (the greedy loops: B=32, T=20; the scans: T=47, B=16,
   with masks and residuals where they take them), and prints the median
   time from one barrier to the next for each phase of a step (five for #1
   and #4/#5, eight for #8, three for #3 and #7: the slowest block's work
   in that phase plus the barrier) and which phase sets the pace.  The
   copy is a temporary directory and builds libraries of their own hash;
   the repository's sources are not touched.
2. With ``--against``, the ``csrc/`` directory of another checkout: runs
   #6 (``decoder_scan_bwd.cu``, whose interface is unchanged since it was
   written) from both trees on the same residuals, float32 and bf16, says
   whether all eleven gradients are bit-identical, and times the reverse
   chain in turns (other, this, this, other).

Prints the card's ``nvidia-smi`` name and power limit.  Exits non-zero
without a card.
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402
from imagecaptioner_tpu_torch.ops import _build  # noqa: E402
from imagecaptioner_tpu_torch.ops import enhanced_scan as ES  # noqa: E402
from imagecaptioner_tpu_torch.ops import greedy as G  # noqa: E402
from imagecaptioner_tpu_torch.ops import lstm_scan as S  # noqa: E402

STAMP = ("if (blockIdx.x == 0 && threadIdx.x == 0 && probe_n < 16384) { "
         "unsigned long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" "
         ": \"=l\"(t_)); probe_t[probe_n++] = t_; }")
READER = ('extern "C" int ic_probe_read(unsigned long long* t, int* n) {\n'
          "  cudaMemcpyFromSymbol(n, probe_n, sizeof(int));\n"
          "  cudaMemcpyFromSymbol(t, probe_t, sizeof(probe_t));\n"
          "  const int zero = 0;\n"
          "  return (int)cudaMemcpyToSymbol(probe_n, &zero, sizeof(int));\n}\n")
PHASES = ("1 h products", "2 attention (and logits)", "3 x0 (and token)",
          "4 layer 0", "5 layer 1")
ENH_PHASES = ("1 h2, highway, q, W_hh2", "2 qh, W_hh0", "3 attention, W_hh1",
              "4 ctx, attn", "5 gate, x0", "6 layer 0", "7 layer 1",
              "8 layer 2")
COMPACT_PHASES = ("1 h products (and logits)", "2 attention (and token)",
                  "3 gates and cell")
CHAINS = ("greedy_decode.cu", "decoder_scan.cu", "enhanced_scan.cu",
          "greedy_decode_compact.cu", "compact_scan.cu")


def stamped_copy() -> Path:
    """csrc/ with a %globaltimer stamp after every grid barrier of the
    forward chains."""
    tmp = Path(tempfile.mkdtemp(prefix="ic_probe_"))
    for f in _build.CSRC.glob("*.cu*"):
        shutil.copy(f, tmp)
    for name in CHAINS:
        src = (tmp / name).read_text()
        src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long "
                          "probe_t[16384];\n__device__ int probe_n;\n", 1)
        src = src.replace("grid_barrier(a.bar, nblk);",
                          "grid_barrier(a.bar, nblk); " + STAMP)
        (tmp / name).write_text(src + READER)
    return tmp


def phase_medians(lib, run, steps: int, n_phases: int = 5) -> list:
    t = (ctypes.c_ulonglong * 16384)()
    n = ctypes.c_int()
    lib.ic_probe_read(t, ctypes.byref(n))
    run()
    torch.cuda.synchronize()
    lib.ic_probe_read(t, ctypes.byref(n))
    stamps = list(t)[:n.value]
    gaps = [(b - a) / 1e3 for a, b in zip(stamps, stamps[1:])]
    # gaps[0] runs from the barrier after phase 1 of step 0 to the one after
    # phase 2; from gap P - 1 on, gap P - 1 + i is phase i % P + 1 (step 0
    # and the tail left out)
    P, by_phase = n_phases, {}
    for i, g in enumerate(gaps[P - 1:P * (steps - 1) + P - 1]):
        by_phase.setdefault(i % P, []).append(g)
    return [statistics.median(by_phase[p]) for p in range(P)]


def show(what: str, names, med) -> None:
    slow = max(range(len(med)), key=med.__getitem__)
    print(f"{what}, median us a phase: " + ", ".join(
        f"{p} {m:.2f}" for p, m in zip(names, med))
        + f"; a step {sum(med):.2f}; the pace is set by phase {names[slow]} "
        f"({100 * med[slow] / sum(med):.0f}% of a step)", flush=True)


def probe_phases(dev) -> None:
    real, tmp = _build.CSRC, stamped_copy()
    try:
        CS.forget_libraries()
        _build.CSRC = tmp
        decoder, feats32 = CS.greedy_inputs(dev)
        feats = feats32.to(torch.bfloat16).contiguous()
        w = G.greedy_operands(decoder, torch.bfloat16)
        f_proj = G.attention_feature_projection(w, feats)
        with torch.inference_mode():
            run = lambda: G.greedy_decode_cuda(w, feats, f_proj,  # noqa: E731
                                               max_length=CS.MAX_LEN)
            run()
            med = phase_medians(_build.library("greedy_decode"), run, CS.MAX_LEN)
        show(f"#1 greedy_decode B={CS.BATCH} T={CS.MAX_LEN} bf16", PHASES, med)
        ops = CS.scan_operands(CS.make_decoder(dev), dev, torch.bfloat16,
                               CS.SEED + 5)
        with torch.no_grad():
            run = lambda: S.decoder_scan_cuda(*ops, residuals=True)  # noqa: E731
            run()
            med = phase_medians(_build.library("decoder_scan"), run, CS.KD_T)
        show(f"#4/#5 decoder_scan T={CS.KD_T} B={CS.KD_B} bf16 train form",
             PHASES, med)
        ops = CS.enhanced_scan_operands(CS.make_variant_decoder(
            "enhanced", dev), dev, torch.bfloat16, CS.SEED + 13, True)
        with torch.no_grad():
            run = lambda: ES.enhanced_scan_cuda(*ops)  # noqa: E731
            run()
            med = phase_medians(_build.library("enhanced_scan"), run, CS.KD_T,
                                len(ENH_PHASES))
        show(f"#8 enhanced_scan T={CS.KD_T} B={CS.KD_B} bf16 with masks",
             ENH_PHASES, med)
        c_decoder, c_feats32 = CS.compact_greedy_inputs(dev)
        feats = c_feats32.to(torch.bfloat16).contiguous()
        w = G.greedy_compact_operands(c_decoder, torch.bfloat16)
        with torch.inference_mode():
            run = lambda: G.greedy_decode_compact_cuda(  # noqa: E731
                w, feats, max_length=CS.MAX_LEN)
            run()
            med = phase_medians(_build.library("greedy_decode_compact"), run,
                                CS.MAX_LEN, len(COMPACT_PHASES))
        show(f"#3 greedy_decode_compact B={CS.BATCH} T={CS.MAX_LEN} bf16",
             COMPACT_PHASES, med)
        ops = CS.compact_scan_operands(CS.make_variant_decoder(
            "compact", dev), dev, torch.bfloat16, CS.SEED + 12)
        with torch.no_grad():
            run = lambda: S.compact_scan_cuda(*ops)  # noqa: E731
            run()
            med = phase_medians(_build.library("compact_scan"), run, CS.KD_T,
                                len(COMPACT_PHASES))
        show(f"#7 compact_scan T={CS.KD_T} B={CS.KD_B} bf16", COMPACT_PHASES,
             med)
    finally:
        _build.CSRC = real
        CS.forget_libraries()
        shutil.rmtree(tmp, ignore_errors=True)


def against(dev, other: Path) -> None:
    real = _build.CSRC
    decoder = CS.make_decoder(dev)
    try:
        for dtype in (torch.float32, torch.bfloat16):
            ops = CS.scan_operands(decoder, dev, dtype, CS.SEED + 5)
            with torch.no_grad():
                ref = S.decoder_scan_plain(*ops, residuals=True)
            rng = np.random.default_rng(CS.SEED + 6)
            dh = torch.from_numpy(rng.standard_normal(ref[0].shape).astype(
                np.float32)).to(dev).to(dtype)
            da = torch.from_numpy(rng.standard_normal(ref[1].shape).astype(
                np.float32)).to(dev)
            res = ops + tuple(ref)
            grads, chains = {}, {}
            for tag, src in (("other", other), ("this", real), ("this", real),
                             ("other", other)):
                CS.forget_libraries()
                _build.CSRC = src
                with torch.no_grad():
                    g = S.decoder_scan_bwd_cuda(res, dh, da)
                    bufs = iter([S.decoder_scan_bwd_buffers(res, dh, da)
                                 for _ in range(28)])
                    chains.setdefault(tag, []).append(CS.median_ms(
                        lambda: S.decoder_scan_bwd_stage_cuda(next(bufs), 1),
                        20, 3))
                torch.cuda.synchronize()
                grads.setdefault(tag, g)
            same = all(torch.equal(x, y) for x, y in zip(grads["other"],
                                                         grads["this"]))
            print(f"#6 decoder_scan_bwd {str(dtype)[6:]}: all eleven gradients "
                  f"bit-identical to the other tree's: {same}; reverse chain ms "
                  f"other {chains['other'][0]:.4f}, this {chains['this'][0]:.4f}, "
                  f"this {chains['this'][1]:.4f}, other {chains['other'][1]:.4f}",
                  flush=True)
    finally:
        _build.CSRC = real
        CS.forget_libraries()


def main() -> int:
    if not torch.cuda.is_available():
        CS.fail("torch.cuda.is_available() is false: this script runs on the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    probe_phases(dev)
    if "--against" in sys.argv:
        other = Path(sys.argv[sys.argv.index("--against") + 1]).resolve()
        if not (other / "decoder_scan_bwd.cu").is_file():
            CS.fail(f"--against {other}: no decoder_scan_bwd.cu there")
        against(dev, other)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
