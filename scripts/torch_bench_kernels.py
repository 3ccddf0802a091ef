#!/usr/bin/env python3
"""Check and time hand-written kernels alone on one NVIDIA GPU, with the
checks and timers of ``chip_smoke.py``: #2 (the attention core), #1 (the
cooperative greedy loop), #4/#5 and #6 (the decoder scan's forward and its
reverse-time backward), #9 and #10 (the beam step's attention cores) and #8
(the enhanced recurrence).  Faster than the whole smoke run when only these
kernels change.

    python3 scripts/torch_bench_kernels.py \
        [--only attention|greedy|scan|beam|enhanced[,...]]

Prints ptxas' register and spill lines for the sources, each check, the
timings (the scan's forward forms beside its backward by stage), the chain
floor of each cooperative kernel (the median empty grid barrier at its grid
times the barriers a run crosses), and the card's ``nvidia-smi`` name and
power limit.  Exits non-zero on a failed check or without a card.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402
from imagecaptioner_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        CS.fail("torch.cuda.is_available() is false: this script runs on the card")
    only = sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv else None
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi}",
          flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sources = {"attention": ["attention_core"], "greedy": ["greedy_decode"],
               "scan": ["decoder_scan", "decoder_scan_bwd"],
               "beam": ["beam_attention"], "enhanced": ["enhanced_scan"]}
    chains = {"greedy": ["greedy_decode"],
              "scan": ["decoder_scan", "decoder_scan_bwd"],
              "enhanced": ["enhanced_scan"]}
    picked = only.split(",") if only else list(sources)
    names = sum((sources[p] for p in picked), [])
    floors = sum((chains.get(p, []) for p in picked), [])
    if floors:
        names.append(CS.PROBE)  # the chain floors' barrier probe
    print(f"built {names} in {_build.build_all(names):.1f} s", flush=True)
    for src in names:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {src}: {line.strip()}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(CS.SEED)
    if "attention" in picked:
        CS.check_attention(dev, gen)
        CS.check_attention_kd(dev, gen)
        CS.check_attention_48(dev, gen)
        CS.time_attention(dev, gen)
    if "greedy" in picked:
        decoder, feats32 = CS.greedy_inputs(dev)
        with torch.inference_mode():
            _, rows, kms, pms = CS.check_greedy(decoder, feats32)
        print(f"greedy_decode B={CS.BATCH} T={CS.MAX_LEN} bf16: kernel "
              f"{kms:.4f} ms, plain {pms:.4f} ms; bf16 rows identical "
              f"{rows}/{CS.BATCH}", flush=True)
    if "scan" in picked:
        kept = CS.check_scan(CS.make_decoder(dev), dev)
        CS.print_scan_times(CS.time_scan(kept), CS.scan_bounds(kept))
    if "beam" in picked:
        CS.check_beam_attention(dev)
        print(f"  beam_attention ptxas: "
              f"{CS.ptxas_usage('beam_attention', 'beam_self_kernel')} (self), "
              f"{CS.ptxas_usage('beam_attention', 'beam_cross_kernel')} "
              f"(cross)", flush=True)
        for tag, t in CS.time_beam_attention(dev).items():
            print(f"beam attention N={CS.BEAM_B} {tag}: self {t['self_ms']:.4f}"
                  f" ms per call, {t['self_queued_ms']:.4f} queued (all-slots "
                  f"SDPA {t['self_sdpa_ms']:.4f}, {t['self_sdpa_queued_ms']:.4f}"
                  f"; plain {t['self_plain_ms']:.4f}; bound "
                  f"{t['bounds']['self'][0]:.5f}); cross "
                  f"{t['cross_ms']:.4f} per call, {t['cross_queued_ms']:.4f} "
                  f"queued (SDPA {t['cross_sdpa_ms']:.4f}, "
                  f"{t['cross_sdpa_queued_ms']:.4f}; plain "
                  f"{t['cross_plain_ms']:.4f}; bound "
                  f"{t['bounds']['cross'][0]:.5f})", flush=True)
    if "enhanced" in picked:
        decoder = CS.make_variant_decoder("enhanced", dev)
        kept = CS.time_enhanced_scan(CS.check_enhanced_scan(decoder, dev))
        CS.check_enhanced_batches(decoder, dev)
        print(f"enhanced_scan T={CS.KD_T} B={CS.KD_B} bf16: kernel "
              f"{kept['ms']:.4f} ms (float32 {kept['f32_ms']:.4f}), plain "
              f"{kept['plain_ms']:.4f}, bound {kept['bound'][0]:.5f} by "
              f"{kept['bound'][1]}; ptxas "
              f"{CS.ptxas_usage('enhanced_scan', 'enhanced_scan_kernel')}",
              flush=True)
    if floors:
        CS.chain_floors(dev, floors)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
