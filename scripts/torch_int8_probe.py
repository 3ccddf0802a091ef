#!/usr/bin/env python3
"""Where the time of the int8 product kernel (#11, ``csrc/int8_conv.cu``)
goes inside a block, on one NVIDIA GPU.

    python3 scripts/torch_int8_probe.py

Builds a copy of ``csrc/`` in which block 0 of ``int8_gemm_kernel`` reads
%globaltimer at the edges of its phases: in the producer (thread 0) after
each wait for an empty stage, after each stage's loads are issued and after
each stage is signalled full; in the first consumer warpgroup (its thread
0) at each tile's start, after each wait for a full stage, after the
tile's last products, after the epilogue's first barrier, after the
staging and after the tile's stores.  It runs the kernel at four shapes of
a ResNet-50 serving batch (B=32, bf16 out) and prints, per tile of block
0, the median time of each consumer phase and of each producer wait: which
side sets the pace.  The copy is a temporary directory and builds a
library of its own hash; the repository's sources are not touched.  Then
it times the unmodified kernel at the same shapes (queued, CUDA events).

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

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as CS  # noqa: E402
from imagecaptioner_tpu_torch.ops import _build  # noqa: E402
from imagecaptioner_tpu_torch.ops import int8 as I8  # noqa: E402

N_EVENTS = 1 << 16
STAMP = ("if (blockIdx.x == 0) {{ unsigned long long t_; asm volatile("
         "\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); const int i_ = "
         "atomicAdd(&probe_n, 1); if (i_ < {n}) {{ probe_t[i_] = t_; "
         "probe_c[i_] = {code}; }} }}")
HEADER = ("__device__ unsigned long long probe_t[{n}];\n"
          "__device__ int probe_c[{n}];\n__device__ int probe_n;\n")
READER = ('extern "C" int ic_probe_read(unsigned long long* t, int* c, '
          'int* n) {\n'
          "  cudaMemcpyFromSymbol(n, probe_n, sizeof(int));\n"
          "  cudaMemcpyFromSymbol(t, probe_t, sizeof(probe_t));\n"
          "  cudaMemcpyFromSymbol(c, probe_c, sizeof(probe_c));\n"
          "  const int zero = 0;\n"
          "  return (int)cudaMemcpyToSymbol(probe_n, &zero, sizeof(int));\n}\n")
# (anchor line in int8_conv.cu, event code, who stamps: p = producer thread
# 0, c = consumer thread 0)
POINTS = [
    ("      mbar_wait(ring.empty(s), ((uint32_t)(it / S) & 1u) ^ 1u);\n",
     1, "p"),
    ("      cp_async_commit();\n", 2, "p"),
    ("        mbar_arrive(ring.full((it - LAG) % S));\n", 3, "p"),
    ("    const TileConsts consts(c, w, lt, rin);\n", 10, "c"),
    ("      mbar_wait(ring.full(s), (uint32_t)(it / S) & 1u);\n", 11, "c"),
    ("    wgmma_wait<0>();\n", 12, "c"),
    ("  warpgroup_sync(wg);      // and its rows have left: the staging area "
     "is free\n", 13, "c"),
    ("  warpgroup_sync(wg);\n  const bool vec", 14, "c"),
    ("    epilogue_tile(c, ring, w, acc, consts, wg, lt, rin, cin);\n", 15,
     "c"),
]
SHAPES = {
    "1x1 64->256 @56": ((32, 56, 56, 64), (256, 64, 1, 1), 1, 0, 1, False),
    "3x3 64 @56": ((32, 56, 56, 64), (64, 64, 3, 3), 1, 1, 1, False),
    "3x3 512 @7": ((32, 7, 7, 512), (512, 512, 3, 3), 1, 1, 1, False),
    "stem 7x7/2": ((32, 224, 224, 3), (64, 3, 7, 7), 2, 3, 1, False),
}


def stamped_copy() -> Path:
    """csrc/ with the stamps of POINTS in int8_conv.cu."""
    tmp = Path(tempfile.mkdtemp(prefix="ic_int8_probe_"))
    for f in _build.CSRC.glob("*.cu*"):
        shutil.copy(f, tmp)
    path = tmp / "int8_conv.cu"
    src = path.read_text()
    for anchor, code, who in POINTS:
        if src.count(anchor) != 1:
            raise SystemExit(f"stamp anchor not found once: {anchor!r}")
        cond = ("threadIdx.x == 0" if who == "p"
                else "threadIdx.x == PRODUCERS")
        stamp = STAMP.format(n=N_EVENTS, code=code).replace(
            "if (blockIdx.x == 0)", f"if (blockIdx.x == 0 && {cond})")
        if anchor.startswith("  warpgroup_sync(wg);\n  const bool"):
            src = src.replace(anchor, "  warpgroup_sync(wg);\n  " + stamp
                              + "\n  const bool vec")
        else:
            src = src.replace(anchor, anchor + stamp + "\n")
    src = src.replace("namespace {\n", HEADER.format(n=N_EVENTS)
                      + "namespace {\n", 1)
    path.write_text(src + READER)
    return tmp


def events(lib) -> list:
    t = (ctypes.c_ulonglong * N_EVENTS)()
    c = (ctypes.c_int * N_EVENTS)()
    n = ctypes.c_int()
    lib.ic_probe_read.restype = ctypes.c_int
    lib.ic_probe_read(t, c, ctypes.byref(n))
    return sorted((t[i], c[i]) for i in range(min(n.value, N_EVENTS)))


def med_us(xs) -> str:
    return f"{statistics.median(xs) / 1e3:.3f}" if xs else "-"


def report(name: str, ev: list) -> None:
    """Per tile of block 0: the consumer's phases, and the producer's waits
    in the same window."""
    tiles, cur = [], None
    for t, code in ev:
        if code == 10:
            cur = {"start": t, "full": [], "p": []}
            tiles.append(cur)
        elif cur is not None and code in (11, 12, 13, 14, 15):
            if code == 11:
                cur["full"].append(t)
            else:
                cur[code] = t
    phases = {"wait for the first stage": [], "products (all stages)": [],
              "epilogue: constants, barrier": [], "epilogue: staging": [],
              "epilogue: stores": [], "tile, start to start": []}
    for a, b in zip(tiles, tiles[1:] + [None]):
        if not a["full"] or any(k not in a for k in (12, 13, 14, 15)):
            continue
        phases["wait for the first stage"].append(a["full"][0] - a["start"])
        phases["products (all stages)"].append(a[12] - a["full"][0])
        phases["epilogue: constants, barrier"].append(a[13] - a[12])
        phases["epilogue: staging"].append(a[14] - a[13])
        phases["epilogue: stores"].append(a[15] - a[14])
        if b is not None:
            phases["tile, start to start"].append(b["start"] - a["start"])
    last = {}
    waits = {"empty": [], "issue": [], "signal": []}
    for t, code in ev:
        if code == 1:
            waits["empty"].append(t - last.get(3, last.get(2, t)))
            last[1] = t
        elif code == 2 and 1 in last:
            waits["issue"].append(t - last[1])
            last[2] = t
        elif code == 3 and 2 in last:
            waits["signal"].append(t - last[2])
            last[3] = t
    print(f"{name}: block 0, {len(tiles)} tiles; medians in us: "
          + "; ".join(f"{k} {med_us(v)}" for k, v in phases.items())
          + f" | producer a stage: wait for an empty slot "
          f"{med_us(waits['empty'])}, issue the loads "
          f"{med_us(waits['issue'])}, wait to signal "
          f"{med_us(waits['signal'])}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("this script runs on a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    real, tmp = _build.CSRC, stamped_copy()
    try:
        _build.CSRC = tmp
        CS.forget_libraries()
        for name, shape in SHAPES.items():
            x_q, w_q, s_x, w_scale, b, kw = CS.int8_operands(shape, dev, 0)
            n, h, w, _ = x_q.shape
            o, _, kh, kw_ = w_q.shape
            rows = (I8.out_size(h, kh, kw["stride"], kw["padding"])
                    * I8.out_size(w, kw_, kw["stride"], kw["padding"]))
            packed = I8.pack_weight(w_q)
            for _ in range(2):   # the second run's stamps are read
                lib = _build.library("int8_conv")
                events(lib)
                I8.int8_conv_cuda(x_q, w_q, s_x, w_scale, b, packed=packed,
                                  out_dtype=torch.bfloat16,
                                  rows_per_scale=rows, **kw)
                torch.cuda.synchronize()
            report(name, events(lib))
    finally:
        _build.CSRC = real
        CS.forget_libraries()
        shutil.rmtree(tmp, ignore_errors=True)
    for name, shape in SHAPES.items():
        x_q, w_q, s_x, w_scale, b, kw = CS.int8_operands(shape, dev, 0)
        n, h, w, _ = x_q.shape
        o, _, kh, kw_ = w_q.shape
        rows = (I8.out_size(h, kh, kw["stride"], kw["padding"])
                * I8.out_size(w, kw_, kw["stride"], kw["padding"]))
        packed = I8.pack_weight(w_q)
        ms = CS.queued_ms(lambda: I8.int8_conv_cuda(
            x_q, w_q, s_x, w_scale, b, packed=packed,
            out_dtype=torch.bfloat16, rows_per_scale=rows, **kw), 20)
        print(f"{name}: the unmodified kernel {ms:.4f} ms queued", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
