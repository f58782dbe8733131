// Causal complex FIR filter bank for Hopper (sm_90a).
//
//   y[m, n] = sum_{k < K} h[m, k] * x[m, n - k],   x[m, n - k] = 0 for n < k
//
// Replaces the TPU kernel src/repro/kernels/fir.py::fir_filter_bank (Pallas
// body _fir_kernel).
//
// What bounds it on an H100: 8*M*N*K flops of FP32 FMA work against
// (2*M*N + M*K) complex64 values of traffic.  At HPEC set 1 (M=64, N=4096,
// K=128) that is 268 MFLOP (3.94 us at the 67 TFLOP/s FP32 peak) and 4.3 MB
// (1.3 us at 3.35 TB/s): FP32 arithmetic bounds it.  The first version
// (each thread owned outputs tid, tid + 128, ...; every tap cost two
// shared-memory loads, the broadcast tap and the x word, for 4 FMAs) took
// 0.0148 ms there as a CUDA-graph replay on an NVIDIA H100 80GB HBM3 at
// 700 W, 27% of the bound: a warp's x load is 256 B per 4 FFMAs, twice what
// the SM's 128 B/clk of shared memory feeds at the FMA rate.  This version:
// 0.0073-0.0074 ms (53-54% of the bound) the same way (chip_smoke.py phase
// 3; PERF.md); staging the window and storing the outputs alone take about
// 2 us of it (tools/probe_kernels.py).
//
// Design: register blocking, with the first version's arithmetic.
// * grid = (output tiles of block_n samples, banks); each block stages its
//   bank's K taps and the x window x[n0 - K, n0 + R * threads) in shared
//   memory with cp.async (the causal zeros and the samples past N are the
//   copies' zero fill), so every x and h value is read from device memory
//   once per tile.  complex64 is read as interleaved float2, the tensor's
//   own layout.
// * each thread owns R = 8 consecutive outputs and keeps the 8 x values
//   they need at the current tap in registers, a window that slides by one
//   sample per tap: each tap loads one new x value (8 B) and the tap (two
//   taps per 16-byte broadcast), then issues 32 FMAs into 16 independent
//   accumulators.  Shared-memory traffic per FMA falls about 8x.
// * the window rotates through its 8 registers every 8 taps, so the tap
//   loop is unrolled by max(TAP_UNROLL, 8) where that divides K (a smaller
//   unroll would copy the window at every tap), and the new samples sit at
//   constant offsets from one address per 8 taps (no index arithmetic per
//   tap).
// * a thread's window starts 8 samples after its neighbour's, so the
//   window is stored with one float2 of padding after every 8: the 16 lanes
//   of a half-warp then hit distinct banks.  The outputs go back through
//   the same padded shared memory, so that a warp stores 256 contiguous
//   bytes (stored straight from the registers, each warp store touched 32
//   sectors 64 bytes apart).
// * block_n need not be a multiple of R: ceil(block_n / R) threads, and
//   the outputs past block_n are not stored.  block_n divides n (the
//   wrapper clamps it so, as the TPU kernel does).
// * each output sums its taps in float32 in the order k = 0 ... K - 1, with
//   the first version's FMAs.  TAP_UNROLL is the paper's unroll knob b;
//   the wrapper only passes an unroll that divides K.
#include <cuda_runtime.h>

constexpr int FIR_R = 8;               // consecutive outputs per thread
constexpr int FIR_MAX_THREADS = 256;   // block_n <= 2,048

// staged position of window element e (one float2 of padding after every
// FIR_R)
__host__ __device__ constexpr int fir_pad(int e) { return e + e / FIR_R; }

__device__ __forceinline__ void copy8(void* dst, const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

// STEP taps j0 ... j0 + STEP - 1 of a thread's FIR_R outputs, STEP | k and
// j0 a multiple of STEP.  The samples entering the window at these taps,
// x[n0 + o - j0 - 1 - u], are elements c - u of xo with c = k - 1 - j0 =
// STEP - 1 mod STEP, so they sit at fir_pad(c) - u - u / FIR_R: constant
// offsets (STEP and FIR_R are powers of 2).
template <int STEP>
__device__ __forceinline__ void tap_block(const float2* hs, const float2* xo,
                                          int k, int j0, float2 (&win)[FIR_R],
                                          float (&ar)[FIR_R],
                                          float (&ai)[FIR_R]) {
  const float2* xq = xo + fir_pad(k - 1 - j0);
  float2 taps[STEP];
  if constexpr (STEP == 1) {
    taps[0] = hs[j0];
  } else {
#pragma unroll
    for (int u = 0; u < STEP; u += 2) {   // two taps per 16-byte broadcast
      const float4 pair = reinterpret_cast<const float4*>(hs)[(j0 + u) >> 1];
      taps[u] = make_float2(pair.x, pair.y);
      taps[u + 1] = make_float2(pair.z, pair.w);
    }
  }
#pragma unroll
  for (int u = 0; u < STEP; ++u) {
    const float2 hv = taps[u];
    const float2 next = xq[-(u + u / FIR_R)];
#pragma unroll
    for (int i = 0; i < FIR_R; ++i) {
      ar[i] = fmaf(hv.x, win[i].x, ar[i]);
      ar[i] = fmaf(-hv.y, win[i].y, ar[i]);
      ai[i] = fmaf(hv.x, win[i].y, ai[i]);
      ai[i] = fmaf(hv.y, win[i].x, ai[i]);
    }
#pragma unroll
    for (int i = FIR_R - 1; i > 0; --i) win[i] = win[i - 1];
    win[0] = next;
  }
}

template <int TAP_UNROLL>
__global__ void __launch_bounds__(FIR_MAX_THREADS)
fir_kernel(const float2* __restrict__ x, const float2* __restrict__ h,
           float2* __restrict__ y, int n, int k, int block_n) {
  extern __shared__ float4 smem[];
  const int kpad = (k + 1) & ~1;
  float2* hs = reinterpret_cast<float2*>(smem);   // [kpad] taps, 16-byte aligned
  float2* xs = hs + kpad;                         // xs[fir_pad(e)] = x[n0 - k + e]
  const int n0 = blockIdx.x * block_n;
  const float2* xrow = x + static_cast<size_t>(blockIdx.y) * n;
  const float2* hrow = h + static_cast<size_t>(blockIdx.y) * k;
  const int window = blockDim.x * FIR_R + k;
  for (int t = threadIdx.x; t < kpad; t += blockDim.x)
    copy8(hs + t, hrow + min(t, k - 1), t < k);
  for (int e = threadIdx.x; e < window; e += blockDim.x) {
    const int src = n0 - k + e;
    const bool ok = src >= 0 && src < n;
    copy8(xs + fir_pad(e), xrow + (ok ? src : 0), ok);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // at tap j, win[i] = x[n0 + o + i - j], window element o + i - j + k.  o
  // is a multiple of FIR_R, so fir_pad(o + c) = fir_pad(o) + fir_pad(c)
  const int o = threadIdx.x * FIR_R;
  float2* xo = xs + fir_pad(o);
  float2 win[FIR_R];
#pragma unroll
  for (int i = 0; i < FIR_R; ++i) win[i] = xo[fir_pad(i + k)];
  float ar[FIR_R], ai[FIR_R];
#pragma unroll
  for (int i = 0; i < FIR_R; ++i) ar[i] = 0.f, ai[i] = 0.f;
  // the window rotates through its FIR_R registers every FIR_R taps, so
  // the loop is unrolled by at least FIR_R where that divides k (a smaller
  // unroll would copy the window at every tap)
  constexpr int STEP = TAP_UNROLL > FIR_R ? TAP_UNROLL : FIR_R;
  if (k % STEP == 0) {
    for (int j0 = 0; j0 < k; j0 += STEP)
      tap_block<STEP>(hs, xo, k, j0, win, ar, ai);
  } else {
    for (int j0 = 0; j0 < k; j0 += TAP_UNROLL)
      tap_block<TAP_UNROLL>(hs, xo, k, j0, win, ar, ai);
  }
  // the outputs go out through shared memory (the window's place, with
  // its padding), so that a warp stores 256 contiguous bytes
  __syncthreads();
#pragma unroll
  for (int i = 0; i < FIR_R; ++i) xo[i] = make_float2(ar[i], ai[i]);
  __syncthreads();
  float2* yrow = y + static_cast<size_t>(blockIdx.y) * n + n0;
  for (int t = threadIdx.x; t < block_n; t += blockDim.x)
    yrow[t] = xs[fir_pad(t)];
}

static int fir_block_threads(int block_n) { return (block_n + FIR_R - 1) / FIR_R; }

static size_t fir_smem(int block_n, int k) {
  const int window = fir_block_threads(block_n) * FIR_R + k;
  return sizeof(float2) * static_cast<size_t>(((k + 1) & ~1) + fir_pad(window - 1) + 1);
}

template <int TAP_UNROLL>
static int launch(const float2* x, const float2* h, float2* y, int m, int n,
                  int k, int block_n, cudaStream_t stream) {
  const int threads = fir_block_threads(block_n);
  if (threads > FIR_MAX_THREADS || k % TAP_UNROLL != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fir_smem(block_n, k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fir_kernel<TAP_UNROLL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(n / block_n, m);
  fir_kernel<TAP_UNROLL><<<grid, threads, smem, stream>>>(x, h, y, n, k,
                                                          block_n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" {

int fir_outputs_per_thread() { return FIR_R; }

int fir_max_threads() { return FIR_MAX_THREADS; }

// Dynamic shared memory of one block for (block_n, k).
int fir_smem_bytes(int block_n, int k) {
  return static_cast<int>(fir_smem(block_n, k));
}

// x, h, y: contiguous complex64 [m, n], [m, k], [m, n] on the current device;
// block_n divides n and is at most FIR_R * FIR_MAX_THREADS; tap_unroll in
// {1, 2, 4, 8} divides k.
int fir_filter_bank_launch(const void* x, const void* h, void* y, int m, int n,
                           int k, int block_n, int tap_unroll, void* stream) {
  const auto* xp = static_cast<const float2*>(x);
  const auto* hp = static_cast<const float2*>(h);
  auto* yp = static_cast<float2*>(y);
  auto s = static_cast<cudaStream_t>(stream);
  if (block_n <= 0 || n % block_n != 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
