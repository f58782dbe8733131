// Mamba-1 selective scan for Hopper (sm_90a).
//
//   h_t[b, c, n] = a_t[b, c, n] * h_{t-1}[b, c, n] + bx_t[b, c, n]
//   y_t[b, c]    = sum_n h_t[b, c, n] * c_t[b, n]
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan (Pallas
// body _ssm_kernel).
//
// What bounds it on an H100: bytes.  At the serving bucket (B=1, S=2,080,
// D=8,192, N=16, bf16) it reads a and bx once (2 x 545 MB) and c, and
// writes y (34 MB): ~1.12 GB, 0.336 ms at 3.35 TB/s.  Its arithmetic is two
// FMAs per element of a (~0.5 GFLOP, 8 us of FP32 issue), and the time
// recurrence is sequential per (channel, state): the kernel has to keep
// enough loads in flight that the recurrence never waits on memory.
//
// Design:
// * one thread per (batch, channel, pair of states): N / 2 lanes hold a
//   channel, and a block holds block_c whole channels (block_c * N / 2
//   threads, a multiple of the warp); the grid is (ceil(D / block_c), B),
//   512 blocks of 128 threads at the serving shape.  The TPU kernel kept a
//   [block_c, N] state tile in VMEM and walked time inside one grid step;
//   here each thread keeps its two h in float32 registers for the whole
//   sequence and nothing is carried between blocks.
// * a thread reads its two states of a, bx and c_t as one 4-byte (bf16) or
//   8-byte (float32) load each: a warp's loads at one step are one 128-byte
//   (bf16) line of a and of bx.  One state per thread, as a first version
//   had it, spent about as many instructions per element (address, load,
//   convert, four shuffles, store) as the card issues in the time the
//   bytes take: 0.80-0.85 ms at the serving shape on an H100.
// * time advances in chunks of TC steps, with two register buffers in
//   turn: the raw loads of chunk k + 1 (none depends on h) are issued
//   before the recurrence of chunk k runs, and nothing touches them (no
//   conversion, no copy) until chunk k + 1 runs, so 3 * TC loads per
//   thread are in flight while the previous chunk is consumed.  Nothing is
//   staged in shared memory and the block never synchronises.
// * y_t[c] is the sum of each lane's two products over the N / 2 lanes of
//   the channel's group: log2(N / 2) xor-shuffles inside the warp; the
//   group's lane 0 stores it in a's type.
// * S and D need not be multiples of anything: loads past S re-read step
//   S - 1 (in bounds, never used) and those steps are skipped; threads of
//   channels past D read channel 0's elements, take part in the shuffles
//   of their own (equally idle) group and store nothing.
// * precision as the TPU kernel: a, bx and c are read in their type (bf16 in
//   the model), h and the sum over N are float32, y is stored in a's type,
//   h_final in float32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;

// two neighbouring elements of type T, as loaded, and as float32
template <typename T>
struct Pair;
template <>
struct Pair<float> {
  using type = float2;
  static __device__ __forceinline__ float2 to_f(float2 v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ float2 to_f(__nv_bfloat162 v) {
    return __bfloat1622float2(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// raw pairs of a and bx (pair g of each step's row) and of c_t (pair n2) at
// steps [t0, t0 + TC) (steps past S re-read step S - 1)
template <typename P, int N, int TC>
__device__ __forceinline__ void load_chunk(const P* __restrict__ a,
                                           const P* __restrict__ bx,
                                           const P* __restrict__ c,
                                           size_t row0, int t0, int S,
                                           size_t dn2, size_t g, int n2,
                                           P (&ar)[TC], P (&br)[TC],
                                           P (&cr)[TC]) {
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const size_t row = row0 + min(t0 + j, S - 1);
    ar[j] = a[row * dn2 + g];
    br[j] = bx[row * dn2 + g];
    cr[j] = c[row * (N / 2) + n2];
  }
}

// the recurrence over steps [t0, t0 + TC), storing y_t from lane 0 of each
// channel's group
template <typename T, int N, int TC>
__device__ __forceinline__ float2 run_chunk(
    float2 h, const typename Pair<T>::type (&ar)[TC],
    const typename Pair<T>::type (&br)[TC],
    const typename Pair<T>::type (&cr)[TC], T* __restrict__ y, size_t row0,
    int t0, int S, int D, int ch, bool store) {
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    if (t0 + j < S) {          // the same for every thread of the block
      const float2 av = Pair<T>::to_f(ar[j]), bv = Pair<T>::to_f(br[j]);
      const float2 cv = Pair<T>::to_f(cr[j]);
      h.x = fmaf(av.x, h.x, bv.x);
      h.y = fmaf(av.y, h.y, bv.y);
      float p = fmaf(h.y, cv.y, h.x * cv.x);
#pragma unroll
      for (int o = N / 4; o > 0; o >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, o);
      if (store) y[(row0 + t0 + j) * D + ch] = Pair<T>::store(p);
    }
  }
  return h;
}

template <typename T, int N, int TC>
__global__ void __launch_bounds__(MAX_THREADS)
ssm_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                const T* __restrict__ c, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hf, int S, int D) {
  using P = typename Pair<T>::type;
  constexpr int LANES = N / 2;                           // lanes per channel
  const int b = blockIdx.y;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;   // pair in the row
  const int ch = g / LANES, n2 = g % LANES;
  const bool valid = ch < D;
  const bool store = valid && n2 == 0;
  const size_t dn2 = static_cast<size_t>(D) * LANES;
  const size_t gl = valid ? g : 0;                        // the pair loaded
  const size_t row0 = static_cast<size_t>(b) * S;        // first time row
  const auto* a2 = reinterpret_cast<const P*>(a);
  const auto* bx2 = reinterpret_cast<const P*>(bx);
  const auto* c2 = reinterpret_cast<const P*>(c);
  float2 h = valid ? reinterpret_cast<const float2*>(h0)[b * dn2 + g]
                   : make_float2(0.f, 0.f);

  P a0[TC], b0[TC], c0[TC], a1[TC], b1[TC], c1[TC];
  load_chunk<P, N, TC>(a2, bx2, c2, row0, 0, S, dn2, gl, n2, a0, b0, c0);
  for (int t0 = 0; t0 < S; t0 += 2 * TC) {
    load_chunk<P, N, TC>(a2, bx2, c2, row0, t0 + TC, S, dn2, gl, n2, a1, b1,
                         c1);
    h = run_chunk<T, N, TC>(h, a0, b0, c0, y, row0, t0, S, D, ch, store);
    load_chunk<P, N, TC>(a2, bx2, c2, row0, t0 + 2 * TC, S, dn2, gl, n2, a0,
                         b0, c0);
    h = run_chunk<T, N, TC>(h, a1, b1, c1, y, row0, t0 + TC, S, D, ch, store);
  }
  if (valid) reinterpret_cast<float2*>(hf)[b * dn2 + g] = h;
}

template <int N, int TC>
int launch_typed(const void* a, const void* bx, const void* c, const void* h0,
                 void* y, void* hf, int B, int S, int D, int block_c, int bf16,
                 cudaStream_t stream) {
  const dim3 grid((D + block_c - 1) / block_c, B);
  const int threads = block_c * N / 2;
  if (bf16) {
    using T = __nv_bfloat16;
    ssm_scan_kernel<T, N, TC><<<grid, threads, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(bx),
        static_cast<const T*>(c), static_cast<const float*>(h0),
        static_cast<T*>(y), static_cast<float*>(hf), S, D);
  } else {
    ssm_scan_kernel<float, N, TC><<<grid, threads, 0, stream>>>(
        static_cast<const float*>(a), static_cast<const float*>(bx),
        static_cast<const float*>(c), static_cast<const float*>(h0),
        static_cast<float*>(y), static_cast<float*>(hf), S, D);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_n(int time_chunk, const void* a, const void* bx, const void* c,
             const void* h0, void* y, void* hf, int B, int S, int D,
             int block_c, int bf16, cudaStream_t s) {
  switch (time_chunk) {
    case 8: return launch_typed<N, 8>(a, bx, c, h0, y, hf, B, S, D, block_c, bf16, s);
    case 16: return launch_typed<N, 16>(a, bx, c, h0, y, hf, B, S, D, block_c, bf16, s);
    case 32: return launch_typed<N, 32>(a, bx, c, h0, y, hf, B, S, D, block_c, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int N, int TC>
cudaError_t attributes_typed(int bf16, cudaFuncAttributes* attr) {
  return bf16 ? cudaFuncGetAttributes(attr, ssm_scan_kernel<__nv_bfloat16, N, TC>)
              : cudaFuncGetAttributes(attr, ssm_scan_kernel<float, N, TC>);
}

template <int N>
cudaError_t attributes_n(int time_chunk, int bf16, cudaFuncAttributes* attr) {
  switch (time_chunk) {
    case 8: return attributes_typed<N, 8>(bf16, attr);
    case 16: return attributes_typed<N, 16>(bf16, attr);
    case 32: return attributes_typed<N, 32>(bf16, attr);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// a, bx: contiguous [B, S, D, N]; c: contiguous [B, S, N], all of one type
// (bf16 when bf16 != 0, else float32); h0, hf: contiguous float32 [B, D, N];
// y: contiguous [B, S, D] in a's type; every pointer 8-byte aligned.
// n in {2, 4, 8, 16, 32}; time_chunk in {8, 16, 32}; block_c * n / 2 a
// multiple of 32, at most 256.
int ssm_scan_launch(const void* a, const void* bx, const void* c,
                    const void* h0, void* y, void* hf, int B, int S, int D,
                    int n, int block_c, int time_chunk, int bf16,
                    void* stream) {
  const int threads = block_c * n / 2;
  if (block_c <= 0 || threads % 32 != 0 || threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 2: return launch_n<2>(time_chunk, a, bx, c, h0, y, hf, B, S, D, block_c, bf16, s);
    case 4: return launch_n<4>(time_chunk, a, bx, c, h0, y, hf, B, S, D, block_c, bf16, s);
    case 8: return launch_n<8>(time_chunk, a, bx, c, h0, y, hf, B, S, D, block_c, bf16, s);
    case 16: return launch_n<16>(time_chunk, a, bx, c, h0, y, hf, B, S, D, block_c, bf16, s);
    case 32: return launch_n<32>(time_chunk, a, bx, c, h0, y, hf, B, S, D, block_c, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int ssm_scan_attributes(int n, int time_chunk, int bf16, int* regs,
                        int* static_smem, int* max_threads) {
  cudaFuncAttributes attr;
  cudaError_t e;
  switch (n) {
    case 2: e = attributes_n<2>(time_chunk, bf16, &attr); break;
    case 4: e = attributes_n<4>(time_chunk, bf16, &attr); break;
    case 8: e = attributes_n<8>(time_chunk, bf16, &attr); break;
    case 16: e = attributes_n<16>(time_chunk, bf16, &attr); break;
    case 32: e = attributes_n<32>(time_chunk, bf16, &attr); break;
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
