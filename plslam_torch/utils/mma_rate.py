"""Measure on an H100 the issue rate of the tensor-core instructions for a
256-bit Hamming block (``csrc/mma_rate.cu``): ``mma.sync`` m16n8k256
``.b1 .xor.popc`` (two BMMA on sm_90a) and ``.b1 .and.popc`` (the one
``csrc/hamming_top2.cu`` uses); and the fp32 min/max rate that the FAST
kernel's arc minima need (``chip_smoke.py``'s ``MINMAX_OPS_S``).

    python -m plslam_torch.utils.mma_rate

Prints, per instruction, the instructions per second and the
pair-distances per second it gives for 256-bit descriptors (one
instruction gives 128 distances, or the AND counts that give them), then
the fp32 min/max results per second and per SM and clock (at the 1.98 GHz
boost clock), and the card's name and power limit. Needs a CUDA GPU and
nvcc.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from ..ops import cuda_build

WARPS_PER_BLOCK = 4
CHAINS = 8
SMS, BOOST_HZ = 132, 1.98e9  # H100 SXM
MMA_KINDS = ("b1_xor_popc_m16n8k256", "b1_and_popc_m16n8k256")


def measure(blocks: int = 132 * 8, iters: int = 4096) -> dict:
    fn = cuda_build.function("mma_rate", "mma_rate_launch",
                             [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    res = {}
    for kind, name in enumerate([*MMA_KINDS, "fp32_min_max"]):
        for _ in range(2):  # warm-up
            if fn(kind, blocks, 64, sink.data_ptr(), stream):
                raise RuntimeError(f"mma_rate launch failed for {name}")
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        if fn(kind, blocks, iters, sink.data_ptr(), stream):
            raise RuntimeError(f"mma_rate launch failed for {name}")
        end.record()
        torch.cuda.synchronize()
        s = start.elapsed_time(end) * 1e-3
        instr = blocks * WARPS_PER_BLOCK * iters * CHAINS
        if name == "fp32_min_max":  # 2 per chain and step, 32 lanes a warp
            ops = 2 * 32 * instr / s
            res[name] = dict(seconds=s, results_per_s=ops,
                             per_sm_per_clock=ops / SMS / BOOST_HZ)
        else:
            res[name] = dict(seconds=s, instr_per_s=instr / s,
                             distances_per_s=instr / s * 128)
    return res


def main():
    if not torch.cuda.is_available():
        raise SystemExit("mma_rate: needs a CUDA GPU")
    res = measure()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps(res))
    print(smi)


if __name__ == "__main__":
    main()
