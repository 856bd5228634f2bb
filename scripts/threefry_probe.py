"""What one Threefry-2x32 call (``csrc/kernel_prng.cuh::threefry2x32``, the
port's counter-based generator) costs the card: its instructions by pipe,
from the SASS that ``nvcc`` gives for ``sm_90a``, and the rate at which the
card computes it.

    python3 scripts/threefry_probe.py [--reps 64]

Writes a probe kernel into ``eeyore_tpu_torch/ops/_build/threefry_probe/``:
each thread folds ``N`` calls (key (seed, thread), counter (ctr + r, j), as
the kernels draw their words) into one word by xor, ``reps`` times over, and
stores it. It compiles the kernel at N = 8 and N = 16 to a cubin, reads
``cuobjdump -sass``, and divides the difference of the two instruction counts
by 8: the instructions of one call in a loop of calls, opcode by opcode,
with the one 3-input LOP3 that folds a call's two words into the word. The
pipes: IMAD (also IMAD.MOV, IMAD.IADD, IMAD.SHL) and IMUL issue to the FMA
pipe; IADD3, LOP3, SHF, ISETP, SEL, PRMT, LEA, MOV and the like to the ALU
(integer) pipe, both at 64 results a clock an SM on compute capability 9.0;
any other opcode is counted as "other". Then it launches the N = 16 kernel
over the whole card (8 blocks of 256 threads an SM) and times it with CUDA
events, the median of 5 launches after a warm-up, so that the calls a
second it reaches stand beside the rate the count predicts (the busier
pipe's count at 64 a clock an SM, and all instructions at one warp
instruction a clock a scheduler, 128 a clock an SM).

It prints the card's name and power limit, then one JSON line: the counts
by opcode and by pipe, the predicted and measured calls a second, and the
SM clock that ``nvidia-smi`` read after the timing (``clocks.sm`` and
``clocks.max.sm``).
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "eeyore_tpu_torch" / "ops" / "csrc"
BUILD = ROOT / "eeyore_tpu_torch" / "ops" / "_build" / "threefry_probe"
NVCC = "/usr/local/cuda/bin/nvcc"
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
SOURCE = r"""
#include "kernel_prng.cuh"

// Each thread folds N calls, counter (ctr + r, j), into one word, reps times.
template <int N>
__global__ void threefry_probe(unsigned seed, unsigned ctr, int reps, unsigned* out) {
  const unsigned c = blockIdx.x * blockDim.x + threadIdx.x;
  unsigned acc = 0u;
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint2 w = kernel_prng::threefry2x32(seed, c, ctr + static_cast<unsigned>(r),
                                                static_cast<unsigned>(j));
      acc ^= w.x ^ w.y;
    }
  }
  out[c] = acc;
}

template __global__ void threefry_probe<8>(unsigned, unsigned, int, unsigned*);
template __global__ void threefry_probe<16>(unsigned, unsigned, int, unsigned*);

extern "C" int threefry_probe_launch(int blocks, int threads, unsigned seed, int reps,
                                     unsigned* out) {
  threefry_probe<16><<<blocks, threads>>>(seed, 7u, reps, out);
  return static_cast<int>(cudaGetLastError());
}
"""
# opcodes (before the first dot) of the FMA pipe and of the ALU pipe
FMA_PIPE = ("IMAD", "IMUL")
ALU_PIPE = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "PRMT", "LEA", "MOV", "IMNMX", "IABS",
            "SGXT", "BMSK", "LOP", "IADD", "SHL", "SHR")
PER_CLOCK_PER_SM = 64
ISSUE_PER_CLOCK_PER_SM = 128
CALLS_A_THREAD = 16


def sass_counts(cubin):
    """{function name: Counter of opcodes (without predicates and modifiers
    after the first dot)} of ``cuobjdump -sass``."""
    text = subprocess.run([CUOBJDUMP, "-sass", str(cubin)], capture_output=True, text=True,
                          check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            counts[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None:
            counts[name][m.group(2)] += 1
    return counts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--reps", type=int, default=64)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("threefry_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    BUILD.mkdir(parents=True, exist_ok=True)
    source = BUILD / "threefry_probe.cu"
    source.write_text(SOURCE)
    cubin, library = BUILD / "threefry_probe.cubin", BUILD / "threefry_probe.so"
    common = [NVCC, "-O3", "-std=c++17", ARCH, f"-I{CSRC}", str(source)]
    subprocess.run(common + ["-cubin", "-o", str(cubin)], check=True)
    subprocess.run(common + ["-shared", "-Xcompiler", "-fPIC", "-o", str(library)], check=True)

    counts = sass_counts(cubin)
    by_n = {}
    for name, c in counts.items():
        m = re.search(r"threefry_probeILi(\d+)E", name)
        if m:
            by_n[int(m.group(1))] = c
    per_call = {}
    for op in set(by_n[16]) | set(by_n[8]):
        d = (by_n[16][op] - by_n[8][op]) / 8
        if d:
            per_call[op] = d
    pipes = Counter()
    for op, d in per_call.items():
        base = op.split(".")[0]
        pipes["fma" if base in FMA_PIPE else "alu" if base in ALU_PIPE else "other"] += d
    total = sum(per_call.values())

    props = torch.cuda.get_device_properties(0)
    sms = props.multi_processor_count
    lib = ctypes.CDLL(str(library))
    lib.threefry_probe_launch.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                                          ctypes.c_int, ctypes.c_void_p]
    threads, blocks = 256, 8 * sms
    out = torch.zeros(threads * blocks, dtype=torch.int32, device="cuda")

    def launch():
        err = lib.threefry_probe_launch(blocks, threads, 1234, args.reps, out.data_ptr())
        if err:
            raise RuntimeError(f"threefry_probe: CUDA error {err}")

    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        launch()
        end.record()
        torch.cuda.synchronize()
        times.append(begin.elapsed_time(end))
    clocks = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader,nounits"], capture_output=True, text=True,
                            check=True).stdout.strip()
    sm_mhz, max_mhz = (float(v) for v in clocks.split(","))
    ms = sorted(times)[len(times) // 2]
    calls = threads * blocks * args.reps * CALLS_A_THREAD

    def predicted(mhz):  # calls a second at the busier pipe's rate and the issue rate
        per_clock = min(PER_CLOCK_PER_SM / max(pipes["alu"], pipes["fma"]),
                        ISSUE_PER_CLOCK_PER_SM / total)
        return sms * mhz * 1e6 * per_clock

    print(json.dumps({
        "per_call_by_opcode": dict(sorted(per_call.items())), "per_call_by_pipe": dict(pipes),
        "per_call_total": total, "function_totals": {n: sum(c.values()) for n, c in by_n.items()},
        "sms": sms, "threads": threads * blocks, "calls": calls, "ms": ms, "ms_runs": times,
        "calls_per_s": calls / (ms * 1e-3), "sm_clock_mhz_after": sm_mhz,
        "max_sm_clock_mhz": max_mhz, "predicted_calls_per_s_at_max_clock": predicted(max_mhz),
        "measured_share_of_predicted": calls / (ms * 1e-3) / predicted(max_mhz),
        "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
