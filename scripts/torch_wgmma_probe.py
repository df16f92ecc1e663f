"""Check the wgmma building blocks of K1's persistent route on one NVIDIA
Hopper GPU, apart from the kernel: the weight chunks' layout
(``ops/cuda_taylor.py::wg_prepare``), the matrix descriptors, and the A
fragments chained from a product's accumulator (``csrc/wgmma.cuh``:
``wg_chunk``).

    python3 scripts/torch_wgmma_probe.py [--out probe/wgmma_probe.npz]

One warpgroup takes a 64 x NP matrix A into registers in the accumulator
layout (as a layer's output lies there), runs ``wg_chunk`` over every
chunk of one NP x NP layer W prepared by ``wg_prepare`` and copied into
shared memory, and writes the product D back from the accumulator layout.
D is held against A W in float64: scale-relative 1e-5 for the tf32 flavor
(3xTF32, about 2^-20 per product) and against bf16(A) bf16(W) for the bf16
flavor (exact products, f32 sums).  For NP = 64 and 128, both flavors.
With ``--out`` it saves A, W and D of every case, to read a layout fault
off them.  Exit code 1 if any case disagrees.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PROBE = r'''
#include "wgmma.cuh"

template <bool BF, int NP>
__global__ void __launch_bounds__(128) probe(const float* A, const char* B,
                                             float* D, int bytes) {
  extern __shared__ __align__(128) char sm[];
  constexpr int NR = NP / 2, KC = BF ? NP : 64;
  for (int e = threadIdx.x; e < bytes / 16; e += 128)
    reinterpret_cast<int4*>(sm)[e] = reinterpret_cast<const int4*>(B)[e];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float h[NR], d[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * t + (i & 1);
    h[i] = A[r * NP + c];
  }
  const unsigned base = smem_addr(sm);
#pragma unroll
  for (int c = 0; c < NP / KC; ++c)
    wg_chunk<BF, NP, KC>(d, h, c, base + c * (bytes / (NP / KC)), c == 0);
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int r = 16 * warp + g + 8 * ((i >> 1) & 1);
    const int c = 8 * (i >> 2) + 2 * t + (i & 1);
    D[r * NP + c] = d[i];
  }
}

template <bool BF, int NP>
static int run(const float* A, const char* B, float* D, int bytes) {
  cudaError_t e = cudaFuncSetAttribute(
      probe<BF, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  probe<BF, NP><<<1, 128, bytes>>>(A, B, D, bytes);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

extern "C" int probe_run(int bf16, int np, const float* A, const char* B,
                         float* D, int bytes) {
  if (bf16) return np == 64 ? run<true, 64>(A, B, D, bytes)
                            : run<true, 128>(A, B, D, bytes);
  return np == 64 ? run<false, 64>(A, B, D, bytes)
                  : run<false, 128>(A, B, D, bytes);
}
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("FAILED: no CUDA device")
    from tensordiffeq_tpu_torch.ops import cuda_taylor as ct

    work = os.path.join(ct.BUILD_DIR, "wgmma_probe")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "probe.cu")
    with open(src, "w") as fh:
        fh.write(PROBE)
    so = os.path.join(work, "probe.so")
    res = subprocess.run(
        [ct.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
         "-Xptxas", "-v", "-I", ct.CSRC, "-o", so, src],
        capture_output=True, text=True)
    print(res.stderr[-3000:], flush=True)
    if res.returncode != 0:
        sys.exit(f"FAILED: nvcc ({res.returncode})")
    lib = ctypes.CDLL(so)
    lib.probe_run.argtypes = [ctypes.c_int, ctypes.c_int] + \
        [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.probe_run.restype = ctypes.c_int

    rng = np.random.RandomState(0)
    saved, bad = {}, 0
    for bf16 in (False, True):
        for NP in (64, 128):
            KC = NP if bf16 else 64
            P = NP // KC
            stage = NP * KC * (2 if bf16 else 8)
            wp = ct.WgPlan(NP, 4, KC, P, P, 1, stage, 1, 1, 0)
            A = rng.randn(64, NP).astype(np.float32)
            W = (rng.randn(NP, NP) / NP ** 0.5).astype(np.float32)
            flat = [torch.zeros(2, NP), torch.zeros(NP), torch.from_numpy(W),
                    torch.zeros(NP), torch.zeros(NP, 1), torch.zeros(1)]
            B = ct.wg_prepare(flat, wp, bf16).cuda()
            Ad = torch.from_numpy(A).cuda()
            D = torch.zeros(64, NP, device="cuda")
            err = lib.probe_run(int(bf16), NP, Ad.data_ptr(), B.data_ptr(),
                                D.data_ptr(), B.numel())
            if err:
                sys.exit(f"FAILED: CUDA error {err} (bf16={bf16}, NP={NP})")
            Dn = D.cpu().numpy()
            if bf16:
                a = torch.from_numpy(A).to(torch.bfloat16).double().numpy()
                w = torch.from_numpy(W).to(torch.bfloat16).double().numpy()
            else:
                a, w = A.astype(np.float64), W.astype(np.float64)
            ref = a @ w
            rel = float(np.abs(Dn - ref).max() / np.abs(ref).max())
            ok = rel <= 1e-5
            bad += not ok
            tag = f"{'bf16' if bf16 else 'tf32'}-{NP}"
            print(f"[wgmma probe {tag}] scale_rel_err {rel:.3e} "
                  f"{'ok' if ok else 'WRONG'}", flush=True)
            saved.update({f"{tag}_A": A, f"{tag}_W": W, f"{tag}_D": Dn})
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        np.savez(args.out, **saved)
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
