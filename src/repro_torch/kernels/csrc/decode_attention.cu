// Decode attention for Hopper (sm_90a): one query token per sequence
// against its KV cache, G = Hq / Hkv query heads per cache read.
//
//   o[b, h] = sum_s softmax_s(q[b, h] . k[b, h / G, s] / sqrt(D)) v[b, h / G, s]
//   over the slots s whose slot_pos[b, s] is >= 0 (not empty), <= cur_pos[b]
//   and, with a window, > cur_pos[b] - window
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (Pallas body _decode_kernel).
//
// What bounds it on an H100: the cache.  At the serving shape (4 sequences,
// Hkv = 8, S = 2,080, D = 128, bf16) one call reads 34 MB of k and v
// (10.2 us at 3.35 TB/s) for ~17 MFLOP: bytes bound it, by far.
//
// Design:
// * the TPU kernel carried m / l / acc in VMEM scratch across a sequential
//   grid axis over cache blocks (pl.when for init and finish).  Hopper
//   blocks run in no order, so here one block per (b, kv head) loops over
//   the cache itself, block_k slots at a time, keeping m and l in shared
//   memory and the accumulator in registers.
// * every k and v element is read from device memory once, for all G query
//   heads of its kv head: the GQA sharing the kernel exists for.
// * the ragged tail is masked here; the TPU wrapper padded the cache with
//   jnp.pad, which in PyTorch would copy the whole cache on every call.
//   Slots past S take no part in the softmax (score -inf); masked slots
//   get the finite NEG_INF = -1e30, as in the reference.
// * precision as the TPU kernel: k and v go to float32, q is scaled in
//   float32, p stays float32 for P.V, o = acc / max(l, 1e-30) in q's type.
// * what holds it back: one block per (b, kv head) is only 32 blocks at the
//   serving shape, on 132 SMs, so a quarter of the SMs pull the whole cache
//   and each block loads a tile, waits, computes, with no copy in flight
//   during the compute.  Splitting S across blocks with a combine pass
//   (split-K) and cp.async / TMA double buffering are the next steps.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int MAX_OUT = 8;      // outputs (head, column) per thread: G * D <= 1024
constexpr int PAD = 4;          // floats of padding per shared-memory row
constexpr int LOAD_BATCH = 8;   // 16-byte loads in flight per thread

// rows [r0, r0 + nrows) of a [S, D] matrix at element offset `base`, as
// float32, into dst (row stride D + PAD); rows >= S are zeros.
// Each thread issues LOAD_BATCH 16-byte loads before it uses any, so a
// tile's loads are in flight together instead of one per thread at a time.
__device__ __forceinline__ void load_rows(float* dst, const void* src,
                                          size_t base, int r0, int nrows,
                                          int S, int D, bool bf16) {
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
          f[2 * e] = t.x;
          f[2 * e + 1] = t.y;
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
            make_float4(t[j].x, t[j].y, t[j].z, t[j].w);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS)
decode_kernel(const void* __restrict__ q, const void* __restrict__ k,
              const void* __restrict__ v, const int* __restrict__ slot_pos,
              const int* __restrict__ cur_pos, void* __restrict__ o, int S,
              int Hkv, int G, int D, int block_k, int window, float scale,
              int bf16) {
  extern __shared__ float smem[];
  const int ld = D + PAD;
  float* ks = smem;                   // [block_k][ld]
  float* vs = ks + block_k * ld;      // [block_k][ld]
  float* qs = vs + block_k * ld;      // [G][D], q * scale
  float* ps = qs + G * D;             // [G][block_k] scores, then p
  float* ms = ps + G * block_k;       // [G] running max
  float* ls = ms + G;                 // [G] running sum
  float* as = ls + G;                 // [G] this tile's rescale factor
  int* sps = reinterpret_cast<int*>(as + G);   // [block_k] slot positions

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;          // b * Hkv + kv head
  const int b = bh / Hkv;
  const int pos = cur_pos[b];
  // q is [B, Hkv * G, 1, D]: the G heads of kv head kvh start at bh * G
  const size_t q_base = static_cast<size_t>(bh) * G * D;
  const size_t kv_base = static_cast<size_t>(bh) * S * D;

  for (int i = tid; i < G * D; i += THREADS) {
    const float qv = bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(q)[q_base + i])
                          : static_cast<const float*>(q)[q_base + i];
    qs[i] = qv * scale;
  }
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = NEG_INF;
    ls[g] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int u = 0; u < MAX_OUT; ++u) acc[u] = 0.f;

  for (int k0 = 0; k0 < S; k0 += block_k) {
    load_rows(ks, k, kv_base, k0, block_k, S, D, bf16);
    load_rows(vs, v, kv_base, k0, block_k, S, D, bf16);
    for (int i = tid; i < block_k; i += THREADS)
      sps[i] = k0 + i < S ? slot_pos[static_cast<size_t>(b) * S + k0 + i] : -1;
    __syncthreads();

    // scores: thread per (head, slot)
    for (int idx = tid; idx < G * block_k; idx += THREADS) {
      const int g = idx / block_k, c = idx % block_k;
      const int sp = sps[c];
      float sc = -INFINITY;                    // past S: no part in the softmax
      if (k0 + c < S) {
        sc = NEG_INF;
        if (sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window)) {
          const float* qr = qs + g * D;
          const float* kr = ks + c * ld;
          float dot = 0.f;
          for (int d = 0; d < D; d += 4) {
            const float4 kv = *reinterpret_cast<const float4*>(kr + d);
            dot = fmaf(qr[d], kv.x, dot);
            dot = fmaf(qr[d + 1], kv.y, dot);
            dot = fmaf(qr[d + 2], kv.z, dot);
            dot = fmaf(qr[d + 3], kv.w, dot);
          }
          sc = dot;
        }
      }
      ps[g * block_k + c] = sc;
    }
    __syncthreads();

    // online softmax: one warp per head
    for (int g = warp; g < G; g += THREADS / 32) {
      float* row = ps + g * block_k;
      float mt = -INFINITY;
      for (int c = lane; c < block_k; c += 32) mt = fmaxf(mt, row[c]);
      for (int off = 16; off > 0; off /= 2)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mo = ms[g];
      const float mn = fmaxf(mo, mt);
      float sum = 0.f;
      for (int c = lane; c < block_k; c += 32) {
        const float p = expf(row[c] - mn);
        row[c] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(mo - mn);
        as[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = mn;
      }
    }
    __syncthreads();

    // P.V: thread per (head, column) output
#pragma unroll
    for (int u = 0; u < MAX_OUT; ++u) {
      const int idx = tid + THREADS * u;
      if (idx < G * D) {
        const int g = idx / D, d = idx % D;
        const float* prow = ps + g * block_k;
        float a = acc[u] * as[g];
        for (int c = 0; c < block_k; ++c) a = fmaf(prow[c], vs[c * ld + d], a);
        acc[u] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < MAX_OUT; ++u) {
    const int idx = tid + THREADS * u;
    if (idx < G * D) {
      const float val = acc[u] / fmaxf(ls[idx / D], 1e-30f);
      if (bf16)
        static_cast<__nv_bfloat16*>(o)[q_base + idx] = __float2bfloat16_rn(val);
      else
        static_cast<float*>(o)[q_base + idx] = val;
    }
  }
}

size_t smem_bytes(int g, int d, int block_k) {
  return sizeof(float) * (2 * static_cast<size_t>(block_k) * (d + PAD) +
                          static_cast<size_t>(g) * d +
                          static_cast<size_t>(g) * block_k + 3 * g) +
         sizeof(int) * static_cast<size_t>(block_k);
}

}  // namespace

extern "C" {

int decode_attention_threads() { return THREADS; }
int decode_attention_max_out() { return MAX_OUT; }

long long decode_attention_smem_bytes(int g, int d, int block_k) {
  return static_cast<long long>(smem_bytes(g, d, block_k));
}

// q, o: contiguous [B, Hkv * G, 1, D]; k, v: contiguous [B, Hkv, S, D]; all
// of one type (bf16 when bf16 != 0, else float32), 16-byte aligned;
// slot_pos: int32 [B, S]; cur_pos: int32 [B].  d % 8 == 0 (bf16) or
// d % 4 == 0 (float32), G * d <= THREADS * MAX_OUT, block_k % 32 == 0.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* slot_pos, const void* cur_pos,
                            void* o, int B, int Hkv, int G, int S, int d,
                            int block_k, int window, float scale, int bf16,
                            void* stream) {
  if (G * d > THREADS * MAX_OUT || block_k % 32 != 0 || d % (bf16 ? 8 : 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(G, d, block_k);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  decode_kernel<<<B * Hkv, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      q, k, v, static_cast<const int*>(slot_pos),
      static_cast<const int*>(cur_pos), o, S, Hkv, G, d, block_k, window,
      scale, bf16);
  return static_cast<int>(cudaGetLastError());
}

int decode_attention_attributes(int* regs, int* static_smem, int* max_threads) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, decode_kernel);
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
