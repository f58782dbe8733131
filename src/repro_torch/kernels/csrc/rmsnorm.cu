// RMSNorm for Hopper (sm_90a).
//
//   out[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * (1 + w)
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm (Pallas body
// _rmsnorm_kernel).
//
// What bounds it on an H100: bytes.  It does ~4 flops per element against
// 2 x 2 bytes moved in bf16 (1 flop per byte, the card's bf16 ridge is ~295),
// so at Mistral-NeMo's prefill rows ([2,048, 5,120] bf16) the least time is
// 41.9 MB read + written at 3.35 TB/s, 12.5 us.
//
// Design:
// * one block per row.  The TPU kernel kept a [256, D] tile in VMEM and
//   reduced it there; here a row is reduced by its own block: a float32 sum
//   of squares per thread, then warp shuffles, then one float per warp in
//   shared memory and a last shuffle in the first warp.  One block per row
//   at every width keeps one code path: the prefill rows (5,120 wide,
//   thousands of rows) fill the card with small blocks, and a decode step's
//   few rows take a few microseconds whatever the layout.  (A warp per row
//   would skip the shared-memory step for D <= 1,024, where no served model
//   has its rows.)
// * a block has ceil(vectors / VPT) threads in whole warps (32 to 256), and
//   each thread issues its VPT 16-byte loads (8 bf16 or 4 float32 values)
//   at once and keeps them in registers for the second pass, so x is read
//   once: 160 threads for a 5,120-wide bf16 row.  Rows longer than 256 * VPT
//   vectors (8,192 bf16 values) re-read x from L1/L2 in the second pass
//   instead.  (The first version read every row twice, one load in flight
//   per thread: 51 us at Mistral-NeMo's prefill rows, 4.1x the bound.)
// * vector loads and stores where the row of x and of out start on a
//   16-byte boundary, then a scalar tail, so any D works; a row that starts
//   off the boundary (D = 300 in bf16: 600 B rows) takes the scalar path
//   whole.
// * precision as the TPU kernel: x and w are read in their own types (an
//   f32 w may scale a bf16 x), everything inside is float32, and the output
//   is rounded once to x's type.  Rows may be strided (row_stride >= D);
//   the output rows are contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int VPT = 4;        // 16-byte vectors a thread keeps in registers

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

// 16 bytes of T: a raw register (uint4) and its N values as floats
template <typename T>
struct Pack;

template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[N]) {
    v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[N]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void unpack(const uint4& r, float (&v)[N]) {
    const unsigned words[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      __nv_bfloat162 h;
      memcpy(&h, &words[k], sizeof(h));
      const float2 f = __bfloat1622float2(h);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float (&v)[N]) {
    unsigned words[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      memcpy(&words[k], &h, sizeof(h));
    }
    return make_uint4(words[0], words[1], words[2], words[3]);
  }
};

template <typename T>
__device__ __forceinline__ uint4 load16(const T* p) {
  return *reinterpret_cast<const uint4*>(p);
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const uint4& r) {
  *reinterpret_cast<uint4*>(p) = r;
}

// x * inv * (1 + w) for the N values of vector i, packed back to T
template <typename T, typename W>
__device__ __forceinline__ uint4 scale16(const uint4& r, const W* __restrict__ w,
                                         int i, float inv) {
  constexpr int N = Pack<T>::N;
  float v[N];
  Pack<T>::unpack(r, v);
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = v[j] * inv * (1.f + to_f(w[i * N + j]));
  return Pack<T>::pack(v);
}

template <typename T>
__device__ __forceinline__ float sum_sq16(const uint4& r, float ss) {
  constexpr int N = Pack<T>::N;
  float v[N];
  Pack<T>::unpack(r, v);
#pragma unroll
  for (int j = 0; j < N; ++j) ss = fmaf(v[j], v[j], ss);
  return ss;
}

template <typename T, typename W>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ out, int d, int row_stride, float eps) {
  constexpr int N = Pack<T>::N;
  const long long row = blockIdx.x;
  const T* xr = x + row * row_stride;
  T* outr = out + row * d;
  const bool aligned = ((reinterpret_cast<uintptr_t>(xr) |
                         reinterpret_cast<uintptr_t>(outr)) % 16) == 0;
  const int nvec = aligned ? d / N : 0;
  const int tail = nvec * N;
  const int nt = blockDim.x;
  // the row fits the block's registers (the wrapper sizes blocks so that
  // it does up to VPT * 256 vectors): one read of x
  const bool in_regs = nvec <= VPT * nt;

  // pass 1: float32 sum of squares of the row
  float ss = 0.f;
  uint4 raw[VPT];
  if (in_regs) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * nt;
      if (i < nvec) raw[k] = load16(xr + i * N);
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k)
      if (threadIdx.x + k * nt < nvec) ss = sum_sq16<T>(raw[k], ss);
  } else {
    for (int i = threadIdx.x; i < nvec; i += nt) ss = sum_sq16<T>(load16(xr + i * N), ss);
  }
  for (int c = tail + threadIdx.x; c < d; c += nt) {
    const float v = to_f(xr[c]);
    ss = fmaf(v, v, ss);
  }
  __shared__ float partial[MAX_WARPS];
  __shared__ float total;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nt / 32 ? partial[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) total = t;
  }
  __syncthreads();
  const float inv = rsqrtf(total / static_cast<float>(d) + eps);

  // pass 2: scale and store in x's type
  if (in_regs) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = threadIdx.x + k * nt;
      if (i < nvec) store16(outr + i * N, scale16<T, W>(raw[k], w, i, inv));
    }
  } else {
    for (int i = threadIdx.x; i < nvec; i += nt)
      store16(outr + i * N, scale16<T, W>(load16(xr + i * N), w, i, inv));
  }
  for (int c = tail + threadIdx.x; c < d; c += nt)
    outr[c] = from_f<T>(to_f(xr[c]) * inv * (1.f + to_f(w[c])));
}

template <typename T, typename W>
int launch_typed(const void* x, const void* w, void* out, int rows, int d,
                 int row_stride, float eps, int threads, cudaStream_t stream) {
  rmsnorm_kernel<T, W><<<rows, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const W*>(w), static_cast<T*>(out),
      d, row_stride, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
cudaError_t attributes_typed(int w_bf16, cudaFuncAttributes* attr) {
  return w_bf16 ? cudaFuncGetAttributes(attr, rmsnorm_kernel<T, __nv_bfloat16>)
                : cudaFuncGetAttributes(attr, rmsnorm_kernel<T, float>);
}

}  // namespace

extern "C" {

// x: rows of D values of one type (bf16 when x_bf16 != 0, else float32), row
// r at x + r * row_stride; w: contiguous [D] (bf16 when w_bf16 != 0, else
// float32); out: contiguous [rows, D] of x's type.  threads: a multiple of
// 32, at most 256.
int rmsnorm_launch(const void* x, const void* w, void* out, long long rows,
                   int d, int row_stride, float eps, int x_bf16, int w_bf16,
                   int threads, void* stream) {
  if (rows <= 0 || rows > 2147483647LL || d <= 0 || row_stride < d ||
      threads <= 0 || threads % 32 != 0 || threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int r = static_cast<int>(rows);
  auto s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (x_bf16)
    return w_bf16 ? launch_typed<bf, bf>(x, w, out, r, d, row_stride, eps, threads, s)
                  : launch_typed<bf, float>(x, w, out, r, d, row_stride, eps, threads, s);
  return w_bf16 ? launch_typed<float, bf>(x, w, out, r, d, row_stride, eps, threads, s)
                : launch_typed<float, float>(x, w, out, r, d, row_stride, eps, threads, s);
}

int rmsnorm_attributes(int x_bf16, int w_bf16, int* regs, int* static_smem,
                       int* max_threads) {
  cudaFuncAttributes attr;
  const cudaError_t e = x_bf16 ? attributes_typed<__nv_bfloat16>(w_bf16, &attr)
                               : attributes_typed<float>(w_bf16, &attr);
  if (e != cudaSuccess) return static_cast<int>(e);
  *regs = attr.numRegs;
  *static_smem = static_cast<int>(attr.sharedSizeBytes);
  *max_threads = attr.maxThreadsPerBlock;
  return 0;
}

int rmsnorm_max_threads() { return MAX_THREADS; }

int rmsnorm_vectors_per_thread() { return VPT; }

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
