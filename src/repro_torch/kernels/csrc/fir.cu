// Causal complex FIR filter bank for Hopper (sm_90a).
//
//   y[m, n] = sum_{k < K} h[m, k] * x[m, n - k],   x[m, n - k] = 0 for n < k
//
// Replaces the TPU kernel src/repro/kernels/fir.py::fir_filter_bank (Pallas
// body _fir_kernel).
//
// What bounds it on an H100: 8*M*N*K flops of FP32 FMA work against
// (2*M*N + M*K) complex64 values of traffic.  At HPEC set 1 (M=64, N=4096,
// K=128) that is 268 MFLOP (~4 us at the 67 TFLOP/s FP32 peak) and 4.3 MB
// (~1.3 us at 3.35 TB/s): the work is FP32-arithmetic bound, and so small
// that the launch and the ramp-up of 512 blocks are a large share of it.
//
// Design:
// * complex64 is read as interleaved float2 (the tensor's own layout); the
//   TPU kernel split re and im into planes only because the TPU has no
//   complex vector unit.
// * grid = (output tiles of block_n samples, banks).  Each block stages its
//   bank's K taps and the block_n + K - 1 halo window of x in shared memory,
//   so every x and h value is read from device memory once per tile; the
//   causal zeros are masked loads, not a padded copy.  block_n divides n
//   (the wrapper clamps it so, as the TPU kernel does), so no tile is
//   ragged.  The kernel computes its own offsets: the TPU's
//   pl.Element / whole-row BlockSpec arrangement has no counterpart.
// * each thread owns outputs tid, tid + FIR_THREADS, ... of the tile and
//   accumulates re and im in registers over the tap loop (4 FMAs per tap).
//   Neighbouring threads read neighbouring float2 words of the window, and
//   the tap is a shared-memory broadcast.
// * the tap loop is unrolled by TAP_UNROLL, the paper's unroll knob b; the
//   wrapper only passes an unroll that divides K.
#include <cuda_runtime.h>

constexpr int FIR_THREADS = 128;

template <int TAP_UNROLL>
__global__ void __launch_bounds__(FIR_THREADS)
fir_kernel(const float2* __restrict__ x, const float2* __restrict__ h,
           float2* __restrict__ y, int n, int k, int block_n) {
  extern __shared__ float2 smem[];
  float2* hs = smem;          // [k] taps of this bank
  float2* xs = smem + k;      // [block_n + k - 1] window x[n0 - k + 1, n0 + block_n)
  const int n0 = blockIdx.x * block_n;
  const float2* xrow = x + static_cast<size_t>(blockIdx.y) * n;
  const float2* hrow = h + static_cast<size_t>(blockIdx.y) * k;
  for (int t = threadIdx.x; t < k; t += FIR_THREADS) hs[t] = hrow[t];
  const int window = block_n + k - 1;
  for (int t = threadIdx.x; t < window; t += FIR_THREADS) {
    const int src = n0 - (k - 1) + t;
    xs[t] = src >= 0 ? xrow[src] : make_float2(0.f, 0.f);
  }
  __syncthreads();
  float2* yrow = y + static_cast<size_t>(blockIdx.y) * n + n0;
  for (int o = threadIdx.x; o < block_n; o += FIR_THREADS) {
    const float2* xw = xs + o + k - 1;     // xw[-j] = x[n0 + o - j]
    float ar = 0.f, ai = 0.f;
    for (int j = 0; j < k; j += TAP_UNROLL) {
#pragma unroll
      for (int u = 0; u < TAP_UNROLL; ++u) {
        const float2 hv = hs[j + u];
        const float2 xv = xw[-(j + u)];
        ar = fmaf(hv.x, xv.x, ar);
        ar = fmaf(-hv.y, xv.y, ar);
        ai = fmaf(hv.x, xv.y, ai);
        ai = fmaf(hv.y, xv.x, ai);
      }
    }
    yrow[o] = make_float2(ar, ai);
  }
}

template <int TAP_UNROLL>
static int launch(const float2* x, const float2* h, float2* y, int m, int n,
                  int k, int block_n, cudaStream_t stream) {
  const size_t smem = sizeof(float2) * static_cast<size_t>(block_n + 2 * k - 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fir_kernel<TAP_UNROLL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n / block_n, m);
  fir_kernel<TAP_UNROLL><<<grid, FIR_THREADS, smem, stream>>>(x, h, y, n, k,
                                                              block_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int fir_threads() { return FIR_THREADS; }

// x, h, y: contiguous complex64 [m, n], [m, k], [m, n] on the current device;
// block_n divides n.
int fir_filter_bank_launch(const void* x, const void* h, void* y, int m, int n,
                           int k, int block_n, int tap_unroll, void* stream) {
  const auto* xp = static_cast<const float2*>(x);
  const auto* hp = static_cast<const float2*>(h);
  auto* yp = static_cast<float2*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  switch (tap_unroll) {
    case 1: return launch<1>(xp, hp, yp, m, n, k, block_n, s);
    case 2: return launch<2>(xp, hp, yp, m, n, k, block_n, s);
    case 4: return launch<4>(xp, hp, yp, m, n, k, block_n, s);
    case 8: return launch<8>(xp, hp, yp, m, n, k, block_n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int fir_filter_bank_attributes(int tap_unroll, int* regs, int* static_smem,
                               int* max_threads) {
  cudaFuncAttributes a;
  cudaError_t e;
  switch (tap_unroll) {
    case 1: e = cudaFuncGetAttributes(&a, fir_kernel<1>); break;
    case 2: e = cudaFuncGetAttributes(&a, fir_kernel<2>); break;
    case 4: e = cudaFuncGetAttributes(&a, fir_kernel<4>); break;
    case 8: e = cudaFuncGetAttributes(&a, fir_kernel<8>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = a.numRegs;
  *static_smem = static_cast<int>(a.sharedSizeBytes);
  *max_threads = a.maxThreadsPerBlock;
  return 0;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
