// Causal or sliding-window prefill attention with GQA, for Hopper (sm_90a).
//
//   o[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h / G, j] / sqrt(D)) v[b, h / G, j]
//   over the keys j the mask admits: j < S, j <= i (causal), j > i - window
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (Pallas body _flash_kernel).
//
// What bounds it on an H100: at the serving shape (B=1, Hq=32, Hkv=8, D=128,
// S=2,048, causal) it does ~34 GFLOP of products (35 us at the 989 TFLOP/s
// bf16 tensor-core rate) and moves ~42 MB of q/k/v/o (12.5 us at 3.35 TB/s):
// the operations bound it.  This first version runs the products as scalar
// FP32 FMAs (67 TFLOP/s peak, ~0.5 ms for that work), so the FMA pipe and
// the shared-memory loads that feed it bound it, not the tensor cores;
// mma.sync / wgmma and TMA are for a later version.
//
// Design:
// * grid = (query tiles of block_q rows, B * Hq).  The kv head is
//   qh / (Hq / Hkv) from blockIdx: GQA lives in the index arithmetic, as it
//   lived in the TPU kernel's BlockSpec index map.
// * the TPU kernel held the whole [S, D] K and V rows of one head in VMEM;
//   at S = 2,080 and D = 128 that is over 1 MB.  Here K and V stream
//   through shared memory in tiles of BK keys inside the block's loop over
//   kv tiles, with the online softmax (running max m, sum l, accumulator)
//   in registers.
// * causal block skip as in the TPU kernel: only kv tiles below
//   ceil((q0 + block_q) / BK) are visited.  With a window, tiles wholly
//   below every row's window are skipped as well; a tile that is masked
//   for a row still gives the TPU kernel's result, because NEG_INF is
//   finite (-1e30): the row then adds exp(0) = 1 per masked key, and the
//   first real score wipes it with alpha = exp(-1e30 - m) = 0.
// * S need not be a multiple of any tile: the last query tile and the
//   last kv tile are ragged, loaded as zeros and masked (keys j >= S get
//   NEG_INF; rows i >= S are not stored).
// * each thread owns 4 query rows (ty + TY * r) and BK / TX keys
//   (tx + TX * c) of the score tile, then the same 4 rows and D / TX output
//   columns (tx + TX * c) of the accumulator.  TX = 8 threads share a row
//   group up to D = 128, and TX = 16 at D = 256, so each thread still holds
//   4 x 16 accumulators there (4 x 32 would spill: at D = 128 the kernel
//   already takes 222-254 registers); a block then has 4 * block_q threads
//   instead of 2 * block_q, and block_q <= 64.  The TX threads of a row
//   group are neighbouring lanes, so row max and row sum are log2(TX)
//   shuffles.  Rows of q, k and v in shared memory are D + 4 floats apart,
//   which keeps float4 loads aligned and puts neighbouring rows on
//   different banks.
// * precision as the TPU kernel: q is scaled in float32, QK^T accumulates
//   in float32, p is rounded to v's type before P.V (bf16 inputs), the sum
//   l uses the unrounded p, and o = acc / max(l, 1e-30) in q's type.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int ROWS = 4;     // query rows per thread
constexpr int PAD = 4;          // floats of padding per shared-memory row
constexpr int LOAD_BATCH = 8;   // 16-byte loads in flight per thread
constexpr int MAX_THREADS = 256;

// rows [r0, r0 + nrows) of a [S, D] matrix at element offset `base`, as
// float32 times `scale`, into dst (row stride D + PAD); rows >= S are zeros.
// Each thread issues LOAD_BATCH 16-byte loads before it uses any, so a
// tile's loads are in flight together instead of one per thread at a time.
__device__ __forceinline__ void load_rows(float* dst, const void* src,
                                          size_t base, int r0, int nrows,
                                          int S, int D, bool bf16, float scale) {
  const int ld = D + PAD;
  const int step = blockDim.x;
  if (bf16) {
    const int vpr = D / 8, total = nrows * vpr;
    const auto* p = static_cast<const __nv_bfloat16*>(src) + base;
    for (int i0 = threadIdx.x; i0 < total; i0 += LOAD_BATCH * step) {
      uint4 u[LOAD_BATCH];
#pragma unroll
      for (int j = 0; j < LOAD_BATCH; ++j) {
        const int i = i0 + j * step;
        const int r = i / vpr, c = (i % vpr) * 8;
        u[j] = (i < total && r0 + r < S)
                   ? *reinterpret_cast<const uint4*>(p + static_cast<size_t>(r0 + r) * D + c)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < LOAD_BATCH; ++j) {
        const int i = i0 + j * step;
        if (i >= total) break;
        const int r = i / vpr, c = (i % vpr) * 8;
        const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u[j]);
        float f[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 t = __bfloat1622float2(h[e]);
          f[2 * e] = t.x * scale;
          f[2 * e + 1] = t.y * scale;
        }
        auto* d4 = reinterpret_cast<float4*>(dst + r * ld + c);
        d4[0] = make_float4(f[0], f[1], f[2], f[3]);
        d4[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  } else {
    const int vpr = D / 4, total = nrows * vpr;
    const auto* p = static_cast<const float*>(src) + base;
    for (int i0 = threadIdx.x; i0 < total; i0 += LOAD_BATCH * step) {
      float4 t[LOAD_BATCH];
#pragma unroll
      for (int j = 0; j < LOAD_BATCH; ++j) {
        const int i = i0 + j * step;
        const int r = i / vpr, c = (i % vpr) * 4;
        t[j] = (i < total && r0 + r < S)
                   ? *reinterpret_cast<const float4*>(p + static_cast<size_t>(r0 + r) * D + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < LOAD_BATCH; ++j) {
        const int i = i0 + j * step;
        if (i >= total) break;
        const int r = i / vpr, c = (i % vpr) * 4;
        *reinterpret_cast<float4*>(dst + r * ld + c) =
            make_float4(t[j].x * scale, t[j].y * scale, t[j].z * scale, t[j].w * scale);
      }
    }
  }
}

// threads per row group at head width D
__host__ __device__ constexpr int threads_per_row(int d) { return d >= 256 ? 16 : 8; }

template <int TX>
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int TX>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < TX; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int BK, int D>
__global__ void __launch_bounds__(MAX_THREADS)
flash_kernel(const void* __restrict__ q, const void* __restrict__ k,
             const void* __restrict__ v, void* __restrict__ o, int S, int Hq,
             int Hkv, int block_q, int causal, int window, float scale,
             int bf16) {
  constexpr int TX = threads_per_row(D);
  constexpr int LD = D + PAD;
  constexpr int LDP = BK + 1;
  constexpr int CK = BK / TX;     // keys per thread
  constexpr int CD = D / TX;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                       // [block_q][LD], q * scale
  float* ks = qs + block_q * LD;          // [BK][LD]
  float* vs = ks + BK * LD;               // [BK][LD]
  float* ps = vs + BK * LD;               // [block_q][LDP]

  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  const int TY = block_q / ROWS;
  const int bh = blockIdx.y;              // b * Hq + qh
  const int b = bh / Hq, qh = bh % Hq;
  const int kvh = qh / (Hq / Hkv);
  const size_t q_base = static_cast<size_t>(bh) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + kvh) * S * D;
  const int q0 = blockIdx.x * block_q;

  load_rows(qs, q, q_base, q0, block_q, S, D, bf16, scale);

  float m[ROWS], l[ROWS], acc[ROWS][CD];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int n_tiles = (S + BK - 1) / BK;
  const int kt_end = causal ? min(n_tiles, (q0 + block_q + BK - 1) / BK)
                            : n_tiles;
  int kt_begin = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_begin = (q0 - window + 1) / BK;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * BK;
    load_rows(ks, k, kv_base, k0, BK, S, D, bf16, 1.f);
    load_rows(vs, v, kv_base, k0, BK, S, D, bf16, 1.f);
    __syncthreads();

    float s[ROWS][CK];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int c = 0; c < CK; ++c) s[i][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (ty + TY * i) * LD + d);
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float4 kv = *reinterpret_cast<const float4*>(ks + (tx + TX * c) * LD + d);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          s[i][c] = fmaf(qv[i].x, kv.x, s[i][c]);
          s[i][c] = fmaf(qv[i].y, kv.y, s[i][c]);
          s[i][c] = fmaf(qv[i].z, kv.z, s[i][c]);
          s[i][c] = fmaf(qv[i].w, kv.w, s[i][c]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = ty + TY * i;
      const int qi = q0 + row;
      float mt = NEG_INF;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const int kj = k0 + tx + TX * c;
        const bool ok = kj < S && (!causal || kj <= qi) &&
                        (window <= 0 || kj > qi - window);
        s[i][c] = ok ? s[i][c] : NEG_INF;
        mt = fmaxf(mt, s[i][c]);
      }
      const float mn = fmaxf(m[i], row_max<TX>(mt));
      const float alpha = expf(m[i] - mn);
      float lt = 0.f;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = expf(s[i][c] - mn);
        lt += p;
        ps[row * LDP + tx + TX * c] =
            bf16 ? __bfloat162float(__float2bfloat16_rn(p)) : p;
      }
      l[i] = l[i] * alpha + row_sum<TX>(lt);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) pv[i] = ps[(ty + TY * i) * LDP + j];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float vv = vs[j * LD + tx + TX * c];
#pragma unroll
        for (int i = 0; i < ROWS; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int qi = q0 + ty + TY * i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    const size_t row = q_base + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const float val = acc[i][c] / den;
      const size_t at = row + tx + TX * c;
      if (bf16)
        static_cast<__nv_bfloat16*>(o)[at] = __float2bfloat16_rn(val);
      else
        static_cast<float*>(o)[at] = val;
    }
  }
}

size_t smem_bytes(int block_q, int block_k, int d) {
  return sizeof(float) * (static_cast<size_t>(block_q) * (d + PAD) +
                          2 * static_cast<size_t>(block_k) * (d + PAD) +
                          static_cast<size_t>(block_q) * (block_k + 1));
}

template <int BK, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int S, int block_q, int causal, int window,
           float scale, int bf16, cudaStream_t stream) {
  const int threads = block_q / ROWS * threads_per_row(D);
  if (block_q % ROWS != 0 || threads % 32 != 0 || threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(block_q, BK, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<BK, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + block_q - 1) / block_q, B * Hq);
  flash_kernel<BK, D><<<grid, threads, smem, stream>>>(
      q, k, v, o, S, Hq, Hkv, block_q, causal, window, scale, bf16);
  return static_cast<int>(cudaGetLastError());
}

template <int BK>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int B, int Hq, int Hkv, int S, int block_q, int causal,
             int window, float scale, int bf16, cudaStream_t s) {
  switch (d) {
    case 16: return launch<BK, 16>(q, k, v, o, B, Hq, Hkv, S, block_q, causal, window, scale, bf16, s);
    case 32: return launch<BK, 32>(q, k, v, o, B, Hq, Hkv, S, block_q, causal, window, scale, bf16, s);
    case 64: return launch<BK, 64>(q, k, v, o, B, Hq, Hkv, S, block_q, causal, window, scale, bf16, s);
    case 128: return launch<BK, 128>(q, k, v, o, B, Hq, Hkv, S, block_q, causal, window, scale, bf16, s);
    case 256: return launch<BK, 256>(q, k, v, o, B, Hq, Hkv, S, block_q, causal, window, scale, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int BK>
cudaError_t attributes_d(int d, cudaFuncAttributes* a) {
  switch (d) {
    case 16: return cudaFuncGetAttributes(a, flash_kernel<BK, 16>);
    case 32: return cudaFuncGetAttributes(a, flash_kernel<BK, 32>);
    case 64: return cudaFuncGetAttributes(a, flash_kernel<BK, 64>);
    case 128: return cudaFuncGetAttributes(a, flash_kernel<BK, 128>);
    case 256: return cudaFuncGetAttributes(a, flash_kernel<BK, 256>);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int flash_attention_max_threads() { return MAX_THREADS; }

long long flash_attention_smem_bytes(int block_q, int block_k, int d) {
  return static_cast<long long>(smem_bytes(block_q, block_k, d));
}

// q, o: contiguous [B, Hq, S, D]; k, v: contiguous [B, Hkv, S, D]; all of
// one type (bf16 when bf16 != 0, else float32), 16-byte aligned.
// block_q in {32, 64, 128} (at most 64 at d = 256: 4 * block_q threads);
// block_k in {32, 64, 128}; d in {16, 32, 64, 128, 256}.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Hq, int Hkv, int S, int d,
                           int block_q, int block_k, int causal, int window,
                           float scale, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (block_k) {
    case 32: return launch_d<32>(d, q, k, v, o, B, Hq, Hkv, S, block_q, causal, window, scale, bf16, s);
    case 64: return launch_d<64>(d, q, k, v, o, B, Hq, Hkv, S, block_q, causal, window, scale, bf16, s);
    case 128: return launch_d<128>(d, q, k, v, o, B, Hq, Hkv, S, block_q, causal, window, scale, bf16, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_attributes(int block_k, int d, int* regs, int* static_smem,
                               int* max_threads) {
  cudaFuncAttributes a;
  cudaError_t e;
  switch (block_k) {
    case 32: e = attributes_d<32>(d, &a); break;
    case 64: e = attributes_d<64>(d, &a); break;
    case 128: e = attributes_d<128>(d, &a); break;
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
