// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
//   h_t[b, c] = a_t[b, c] * h_{t-1}[b, c] + b_t[b, c]      (h_all = every h_t)
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (Pallas body _rglru_kernel).
//
// What bounds it on an H100: bytes in principle.  At the serving bucket
// (B=1, S=2,080, D=2,560, bf16) it reads a and b and writes h_all once:
// 3 x 2,080 x 2,560 x 2 B = 31.9 MB, 9.5 us at 3.35 TB/s, and one FMA per
// element.  In practice the latency of the sequential walk over time bounds
// this version: the recurrence is one dependent FMA per step, and at batch 1
// there are only D = 2,560 independent chains, 20 blocks of 128 threads on
// 132 SMs.  A two-pass scan, chunked over time, would fill the card; that is
// a later version's work.
//
// Design:
// * one thread per (batch, channel), walking time; the grid is
//   (ceil(D / block_c), B).  The TPU kernel kept a [T, block_c] tile in VMEM;
//   here each thread keeps h in a float32 register for the whole sequence.
// * time advances in chunks of TC steps, with two register buffers in
//   turn: the raw loads of chunk k + 1 (a and b do not depend on h) are
//   issued before the recurrence of chunk k runs, and nothing touches them
//   (no conversion, no copy) until chunk k + 1 runs, so a chunk's load
//   latency overlaps the previous chunk's recurrence.  (A first version
//   converted each value where it was loaded and copied the buffers: every
//   chunk then waited out a full memory latency, 0.54 ms at the serving
//   shape on an H100.)  Neighbouring threads read and write neighbouring
//   channels: each step is one coalesced segment per warp.
// * S and D need not be multiples of anything: loads past S re-read step
//   S - 1 (in bounds, never used) and those steps are skipped; threads
//   past D return at once (no block-level synchronisation or shuffles
//   follow).
// * precision as the TPU kernel: a and b are read in their type, h is
//   float32, h_all is stored in a's type and h_final in float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// raw values of a and b at steps [t0, t0 + TC) of channel ch (steps past S
// re-read step S - 1)
template <typename T, int TC>
__device__ __forceinline__ void load_chunk(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           size_t row0, int t0, int S, int D,
                                           int ch, T (&ar)[TC], T (&br)[TC]) {
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const size_t at = (row0 + min(t0 + j, S - 1)) * D + ch;
    ar[j] = a[at];
    br[j] = b[at];
  }
}

// the recurrence over steps [t0, t0 + TC), storing every h_t
template <typename T, int TC>
__device__ __forceinline__ float run_chunk(float h, const T (&ar)[TC],
                                           const T (&br)[TC],
                                           T* __restrict__ h_all, size_t row0,
                                           int t0, int S, int D, int ch) {
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    if (t0 + j < S) {
      h = fmaf(to_f(ar[j]), h, to_f(br[j]));
      h_all[(row0 + t0 + j) * D + ch] = from_f<T>(h);
    }
  }
  return h;
}

template <typename T, int TC>
__global__ void __launch_bounds__(MAX_THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ h_all,
                  float* __restrict__ hf, int S, int D) {
  const int bi = blockIdx.y;
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= D) return;
  const size_t row0 = static_cast<size_t>(bi) * S;
  float h = h0[static_cast<size_t>(bi) * D + ch];

  T a0[TC], b0[TC], a1[TC], b1[TC];
  load_chunk<T, TC>(a, b, row0, 0, S, D, ch, a0, b0);
  for (int t0 = 0; t0 < S; t0 += 2 * TC) {
    load_chunk<T, TC>(a, b, row0, t0 + TC, S, D, ch, a1, b1);
    h = run_chunk<T, TC>(h, a0, b0, h_all, row0, t0, S, D, ch);
    load_chunk<T, TC>(a, b, row0, t0 + 2 * TC, S, D, ch, a0, b0);
    h = run_chunk<T, TC>(h, a1, b1, h_all, row0, t0 + TC, S, D, ch);
  }
  hf[static_cast<size_t>(bi) * D + ch] = h;
}

template <int TC>
int launch_tc(const void* a, const void* b, const void* h0, void* h_all,
              void* hf, int B, int S, int D, int block_c, int bf16,
              cudaStream_t stream) {
  const dim3 grid((D + block_c - 1) / block_c, B);
  if (bf16) {
    using T = __nv_bfloat16;
    rglru_scan_kernel<T, TC><<<grid, block_c, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b),
        static_cast<const float*>(h0), static_cast<T*>(h_all),
        static_cast<float*>(hf), S, D);
  } else {
    rglru_scan_kernel<float, TC><<<grid, block_c, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(h0), static_cast<float*>(h_all),
        static_cast<float*>(hf), S, D);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int TC>
cudaError_t attributes_tc(int bf16, cudaFuncAttributes* attr) {
  return bf16 ? cudaFuncGetAttributes(attr, rglru_scan_kernel<__nv_bfloat16, TC>)
              : cudaFuncGetAttributes(attr, rglru_scan_kernel<float, TC>);
}

}  // namespace

extern "C" {

// a, b, h_all: contiguous [B, S, D] of one type (bf16 when bf16 != 0, else
// float32); h0, hf: contiguous float32 [B, D].  block_c threads per block
// (a multiple of 32, at most 256); time_chunk in {8, 16, 32}.
int rglru_scan_launch(const void* a, const void* b, const void* h0,
                      void* h_all, void* hf, int B, int S, int D, int block_c,
                      int time_chunk, int bf16, void* stream) {
  if (block_c <= 0 || block_c % 32 != 0 || block_c > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (time_chunk) {
    case 8: return launch_tc<8>(a, b, h0, h_all, hf, B, S, D, block_c, bf16, s);
    case 16: return launch_tc<16>(a, b, h0, h_all, hf, B, S, D, block_c, bf16, s);
    case 32: return launch_tc<32>(a, b, h0, h_all, hf, B, S, D, block_c, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int rglru_scan_attributes(int time_chunk, int bf16, int* regs,
                          int* static_smem, int* max_threads) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (time_chunk) {
    case 8: e = attributes_tc<8>(bf16, &attr); break;
    case 16: e = attributes_tc<16>(bf16, &attr); break;
    case 32: e = attributes_tc<32>(bf16, &attr); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *static_smem = static_cast<int>(attr.sharedSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return 0;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
