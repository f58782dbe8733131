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
// (10.2 us at 3.35 TB/s) for ~17 MFLOP: bytes bound it, by far.  So the
// design keeps every SM pulling the cache with copies in flight.
//
// Design:
// * split-K.  The TPU kernel carried m / l / acc in VMEM scratch across a
//   sequential grid axis over cache blocks.  Here the grid is (splits,
//   B * Hkv): each block takes a contiguous range of whole block_k tiles of
//   one (b, kv head), so that the grid has at least TARGET_BLOCKS blocks
//   (2 per SM of the H100) wherever the cache has that many tiles; no range
//   is empty (split_tiles / split_count, mirrored by the wrapper's
//   decode_splits).  Each block writes its float32 partial (m, l,
//   acc[G, D]) to scratch the wrapper allocates, and decode_combine_kernel
//   merges the partials of each (b, q head) and writes o in q's type; it is
//   launched as a programmatic dependent (its launch overlaps the split
//   kernel's tail, and griddepcontrol.wait orders its reads).  The slot
//   positions of a tile are loaded before its copy is awaited, and the
//   masks applied in the softmax step, so their latency is hidden.
// * copies.  Thread 0 streams the range through a ring of STAGES stages in
//   shared memory: a k or v tile [s0:s1, :] of one head is contiguous, so
//   each is one 1-D bulk copy (cp.async.bulk) completing on its own
//   mbarrier; k is reloaded as soon as the scores have read it, v after
//   P.V, so copies are in flight while the block computes.  Tiles stay in
//   the cache's type in shared memory; the ragged last tile copies only its
//   rows.  All of the SM's L1 is asked for as shared memory, so that three
//   blocks are resident at the serving shape.
// * every k and v element is read from device memory once, for all G query
//   heads of its kv head: the GQA sharing the kernel exists for.  A lane
//   holds 16 bytes of a cache row and the same columns of the G scaled
//   query rows; LPR = D / (16 / elem) lanes share a row.  Their partial
//   dots for RS row steps are summed by a butterfly over the row's lanes
//   (each level halves the values a lane holds), about 2 shuffles a row
//   instead of log2(LPR) * G.  The kernel is built for each (type, G, D),
//   so that every register array has constant indices: indexed at run
//   time it would live in local memory.
// * precision as the TPU kernel: k and v go to float32, q is scaled in
//   float32, q.k, p and P.V stay float32, o = acc / max(l, 1e-30) in q's
//   type.  Masked slots get the finite NEG_INF = -1e30, so a row with every
//   slot masked averages v uniformly, as in the reference, and a split
//   whose slots are all masked drops out of the combine (its weight is
//   exp(-1e30 - M) = 0) unless every split's are.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int STAGES = 2;           // cache tiles in flight per block
constexpr int MAX_GROUP = 8;        // query heads per kv head
constexpr int TARGET_BLOCKS = 2 * 132;    // two blocks per SM of an H100
constexpr int BARRIER_BYTES = 32;   // a k and a v mbarrier per stage
constexpr int MAX_BLOCK_K = 256;    // slots per tile (the wrapper's largest)

// tiles per split: the most that still give TARGET_BLOCKS blocks over bkv
// (b, kv head) pairs, one where the cache has fewer tiles than that
int split_tiles(int bkv, int s, int block_k) {
  const int n_tiles = (s + block_k - 1) / block_k;
  const int want = (TARGET_BLOCKS + bkv - 1) / bkv;
  return n_tiles / want > 1 ? n_tiles / want : 1;
}

// splits of [0, s): each covers split_tiles tiles, the last the rest, none empty
int split_count(int bkv, int s, int block_k) {
  const int n_tiles = (s + block_k - 1) / block_k;
  const int tps = split_tiles(bkv, s, block_k);
  return (n_tiles + tps - 1) / tps;
}

size_t smem_bytes(int g, int d, int block_k, int elem) {
  return BARRIER_BYTES + 2 * STAGES * static_cast<size_t>(block_k) * d * elem +
         sizeof(float) * (static_cast<size_t>(g) * block_k +
                          static_cast<size_t>(WARPS) * g * d + 3 * g);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// one 1-D bulk copy of `bytes` (a multiple of 16) from device memory into
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 16 bytes at p, as float32
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const auto* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 t = __bfloat1622float2(h[e]);
    f[2 * e] = t.x;
    f[2 * e + 1] = t.y;
  }
}

__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  f[0] = t.x;
  f[1] = t.y;
  f[2] = t.z;
  f[3] = t.w;
}

// butterfly over the lanes of a cache row: at offset O a lane keeps one
// half (HALF values) of its partial dots, hands the other to lane ^ O and
// adds what it receives; recursion keeps every index a constant, so the
// values stay in registers
template <int HALF, int O, int NP>
__device__ __forceinline__ void reduce_dots(float (&dot)[NP], int vc) {
  if constexpr (O > 0) {
    const bool hi = vc & O;
#pragma unroll
    for (int i = 0; i < HALF; ++i) {
      const float send = hi ? dot[i] : dot[i + HALF];
      const float keep = hi ? dot[i + HALF] : dot[i];
      dot[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    reduce_dots<HALF / 2, O / 2, NP>(dot, vc);
  }
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

template <typename T, int G, int D>
__global__ void __launch_bounds__(THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ slot_pos,
                    const int* __restrict__ cur_pos, float* __restrict__ part,
                    int S, int Hkv, int block_k, int tps, int splits,
                    int window, float scale) {
  constexpr int VEC = 16 / sizeof(T);  // elements of one 16-byte vector
  constexpr int LPR = D / VEC;         // lanes per cache row
  constexpr int RPW = 32 / LPR;        // cache rows per warp step
  // the scores of RS steps are reduced over the row's LPR lanes together:
  // NP partial dots a lane, halved at each of log2(LPR) butterfly levels,
  // leave OUT = NP / LPR finished dots in each lane
  constexpr int RS = LPR > G ? LPR / G : 1;
  constexpr int NP = RS * G, OUT = NP / LPR;
  constexpr int LOG2_LPR = LPR >= 32 ? 5 : LPR >= 16 ? 4 : LPR >= 8 ? 3 : LPR >= 4 ? 2 : LPR >= 2 ? 1 : 0;

  static_assert(D % VEC == 0 && 32 % LPR == 0, "16-byte lanes tile a row");
  extern __shared__ __align__(16) uint8_t smem[];
  auto* k_full = reinterpret_cast<uint64_t*>(smem);          // [STAGES]
  uint64_t* v_full = k_full + STAGES;                        // [STAGES]
  T* ring = reinterpret_cast<T*>(smem + BARRIER_BYTES);      // [STAGES][k, v][block_k][D]
  float* sc = reinterpret_cast<float*>(ring + 2 * STAGES * block_k * D);  // [G][block_k]
  float* red = sc + G * block_k;       // [WARPS][G][D]
  float* ms = red + WARPS * G * D;     // [G] running max
  float* ls = ms + G;                  // [G] running sum
  float* as = ls + G;                  // [G] this tile's rescale factor

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = lane / LPR, vc = lane % LPR;
  const int split = blockIdx.x, bh = blockIdx.y;    // bh = b * Hkv + kv head
  const int b = bh / Hkv;
  const int pos = cur_pos[b];
  const int s_begin = split * tps * block_k;
  const int s_end = min(S, s_begin + tps * block_k);
  const int n = (s_end - s_begin + block_k - 1) / block_k;
  const size_t kv_base = static_cast<size_t>(bh) * S * D;
  const int tile = block_k * D;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // thread 0: the k (half 0) or v (half 1) rows of tile t of the range into
  // stage t % STAGES; k is reloaded as soon as the scores have read it
  auto issue = [&](int t, int half) {
    const int s0 = s_begin + t * block_k;
    const uint32_t bytes = min(block_k, s_end - s0) * D * sizeof(T);
    uint64_t* bar = half ? &v_full[t % STAGES] : &k_full[t % STAGES];
    mbar_expect_tx(bar, bytes);
    bulk_load(ring + (t % STAGES) * 2 * tile + half * tile,
              (half ? v : k) + kv_base + static_cast<size_t>(s0) * D, bytes, bar);
  };
  if (tid == 0)
    for (int t = 0; t < STAGES && t < n; ++t) {
      issue(t, 0);
      issue(t, 1);
    }

  // this lane's VEC columns of the G query rows, times scale, in float32
  float qr[G][VEC], acc[G][VEC];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec(q + (static_cast<size_t>(bh) * G + g) * D + vc * VEC, qr[g]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      qr[g][e] *= scale;
      acc[g][e] = 0.f;
    }
  }
  if (tid < G) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }

  for (int t = 0; t < n; ++t) {
    const int s0 = s_begin + t * block_k, rows = min(block_k, s_end - s0);
    const T* kt = ring + (t % STAGES) * 2 * tile;
    const T* vt = kt + tile;
    // the slot positions of the rows this lane takes in the softmax step
    // (lane + 32 j), loaded before the wait so that their latency hides
    // behind the copy and the scores
    int spr[MAX_BLOCK_K / 32];
#pragma unroll
    for (int j = 0; j < MAX_BLOCK_K / 32; ++j) {
      const int c = lane + 32 * j;
      spr[j] = c < rows ? slot_pos[static_cast<size_t>(b) * S + s0 + c] : -1;
    }
    mbar_wait(&k_full[t % STAGES], (t / STAGES) & 1);

    // scores: RPW rows per warp step, LPR lanes per row, RS steps a round;
    // lane vc ends with the dots of (step, head) = divmod(vc * OUT + i, G)
    for (int base = warp * RPW; base < rows; base += RS * WARPS * RPW) {
      float dot[NP];
#pragma unroll
      for (int st = 0; st < RS; ++st) {
        const int row = base + st * WARPS * RPW + r;
        float kf[VEC];
        if (row < rows) {
          load_vec(kt + row * D + vc * VEC, kf);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[e] = 0.f;
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float acc_dot = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc_dot = fmaf(qr[g][e], kf[e], acc_dot);
          dot[st * G + g] = acc_dot;
        }
      }
      reduce_dots<NP / 2, LPR / 2>(dot, vc);
#pragma unroll
      for (int i = 0; i < OUT; ++i) {
        const int idx = vc * OUT + i;
        const int row = base + idx / G * WARPS * RPW + r;
        if (row < rows) sc[idx % G * block_k + row] = dot[i];
      }
    }
    __syncthreads();                   // k of this stage is free
    if (tid == 0 && t + STAGES < n) issue(t + STAGES, 0);

    // masks and online softmax: one warp per head
    for (int g = warp; g < G; g += WARPS) {
      float* srow = sc + g * block_k;
      float x[MAX_BLOCK_K / 32];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < MAX_BLOCK_K / 32; ++j) {
        const int c = lane + 32 * j, sp = spr[j];
        const bool ok = sp >= 0 && sp <= pos && (window <= 0 || sp > pos - window);
        x[j] = c < rows ? (ok ? srow[c] : NEG_INF) : NEG_INF;
        mt = fmaxf(mt, x[j]);
      }
      for (int off = 16; off > 0; off /= 2)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mo = ms[g];
      const float mn = fmaxf(mo, mt);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < MAX_BLOCK_K / 32; ++j) {
        const int c = lane + 32 * j;
        if (c < rows) {
          const float p = expf(x[j] - mn);
          srow[c] = p;
          sum += p;
        }
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

    // P.V: the same rows and columns as the scores
    mbar_wait(&v_full[t % STAGES], (t / STAGES) & 1);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float alpha = as[g];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] *= alpha;
    }
    for (int row = warp * RPW + r; row < rows; row += WARPS * RPW) {
      float vf[VEC];
      load_vec(vt + row * D + vc * VEC, vf);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = sc[g * block_k + row];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
    __syncthreads();                   // v of this stage and the scores are free
    if (tid == 0 && t + STAGES < n) issue(t + STAGES, 1);
  }

  // sum acc over the warp's row groups, then over the warps
#pragma unroll
  for (int lv = LOG2_LPR; lv < 5; ++lv)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], 1 << lv);
  if (r == 0)
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) red[(warp * G + g) * D + vc * VEC + e] = acc[g][e];
  __syncthreads();

  // partial of q row bh * G + g: (m, l) at part[row][split], acc after all
  // the (m, l) pairs
  const size_t rows_q = static_cast<size_t>(gridDim.y) * G;
  float* pacc = part + 2 * rows_q * splits;
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += red[(w * G + g) * D + d];
    pacc[((static_cast<size_t>(bh) * G + g) * splits + split) * D + d] = sum;
  }
  if (tid < G) {
    float* ml = part + ((static_cast<size_t>(bh) * G + tid) * splits + split) * 2;
    ml[0] = ms[tid];
    ml[1] = ls[tid];
  }
  // the combine kernel may start launching (it waits for this grid's writes)
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// o[row] = sum_i acc_i exp(m_i - M) / max(sum_i l_i exp(m_i - M), 1e-30);
// each thread issues the loads of its column's partials before it needs
// them, so that their latency overlaps the (m, l) reduction
constexpr int COMBINE_REGS = 16;    // partials a thread holds in registers

template <typename T>
__global__ void __launch_bounds__(THREADS)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ o,
                      int rows_q, int splits, int D) {
  __shared__ float weight[2 * TARGET_BLOCKS];     // splits < 2 TARGET_BLOCKS
  __shared__ float lsum[2 * TARGET_BLOCKS];
  __shared__ float red[WARPS];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");   // the partials
  const int row = blockIdx.x;          // b * Hq + q head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* ml = part + static_cast<size_t>(row) * splits * 2;
  const float* pacc =
      part + 2 * static_cast<size_t>(rows_q) * splits + static_cast<size_t>(row) * splits * D;
  const int d0 = threadIdx.x;          // the first column of this thread
  float a0[COMBINE_REGS];
#pragma unroll
  for (int i = 0; i < COMBINE_REGS; ++i)
    a0[i] = i < splits && d0 < D ? pacc[static_cast<size_t>(i) * D + d0] : 0.f;
  float mx = NEG_INF;
  for (int i = threadIdx.x; i < splits; i += THREADS) {
    weight[i] = ml[2 * i];
    lsum[i] = ml[2 * i + 1];
    mx = fmaxf(mx, weight[i]);
  }
  for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, red[w]);
  for (int i = threadIdx.x; i < splits; i += THREADS) {
    weight[i] = expf(weight[i] - mx);
    lsum[i] *= weight[i];
  }
  __syncthreads();
  float l = 0.f;
  for (int i = 0; i < splits; ++i) l += lsum[i];
  const float den = fmaxf(l, 1e-30f);
  for (int d = d0; d < D; d += THREADS) {
    float a = 0.f;
    if (d == d0) {
#pragma unroll
      for (int i = 0; i < COMBINE_REGS; ++i)
        if (i < splits) a = fmaf(a0[i], weight[i], a);
    } else {
#pragma unroll 8
      for (int i = 0; i < min(splits, COMBINE_REGS); ++i)
        a = fmaf(pacc[static_cast<size_t>(i) * D + d], weight[i], a);
    }
#pragma unroll 8
    for (int i = COMBINE_REGS; i < splits; ++i)
      a = fmaf(pacc[static_cast<size_t>(i) * D + d], weight[i], a);
    store(o + static_cast<size_t>(row) * D + d, a / den);
  }
}

// the split kernel's attributes: all of the SM's unified L1 as shared
// memory, so that as many blocks as fit are resident (three at the serving
// shape)
template <typename T, int G, int D>
cudaError_t prepare(int block_k) {
  cudaError_t e = cudaFuncSetAttribute(
      decode_split_kernel<T, G, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(G, D, block_k, sizeof(T))));
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(decode_split_kernel<T, G, D>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  return e;
}

template <typename T, int G, int D>
int launch(const void* q, const void* k, const void* v, const int* slot_pos,
           const int* cur_pos, void* o, float* part, int B, int Hkv, int S,
           int block_k, int splits, int window, float scale,
           cudaStream_t stream) {
  cudaError_t e = prepare<T, G, D>(block_k);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(splits, B * Hkv);
  decode_split_kernel<T, G, D>
      <<<grid, THREADS, smem_bytes(G, D, block_k, sizeof(T)), stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), slot_pos, cur_pos, part, S, Hkv, block_k,
          split_tiles(B * Hkv, S, block_k), splits, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // launched as a programmatic dependent of the split kernel, so that its
  // launch overlaps the split kernel's tail
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * Hkv * G);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>,
                         static_cast<const float*>(part), static_cast<T*>(o),
                         B * Hkv * G, splits, D);
  return static_cast<int>(e);
}

// every (type, G, D) the split kernel is built for: G a power of two up to
// MAX_GROUP, a cache row of 32 to 512 bytes
#define DECODE_INSTANCES(X)                                                 \
  X(__nv_bfloat16, 1, 16) X(__nv_bfloat16, 1, 32) X(__nv_bfloat16, 1, 64)   \
  X(__nv_bfloat16, 1, 128) X(__nv_bfloat16, 1, 256)                         \
  X(__nv_bfloat16, 2, 16) X(__nv_bfloat16, 2, 32) X(__nv_bfloat16, 2, 64)   \
  X(__nv_bfloat16, 2, 128) X(__nv_bfloat16, 2, 256)                         \
  X(__nv_bfloat16, 4, 16) X(__nv_bfloat16, 4, 32) X(__nv_bfloat16, 4, 64)   \
  X(__nv_bfloat16, 4, 128) X(__nv_bfloat16, 4, 256)                         \
  X(__nv_bfloat16, 8, 16) X(__nv_bfloat16, 8, 32) X(__nv_bfloat16, 8, 64)   \
  X(__nv_bfloat16, 8, 128) X(__nv_bfloat16, 8, 256)                         \
  X(float, 1, 16) X(float, 1, 32) X(float, 1, 64) X(float, 1, 128)         \
  X(float, 2, 16) X(float, 2, 32) X(float, 2, 64) X(float, 2, 128)         \
  X(float, 4, 16) X(float, 4, 32) X(float, 4, 64) X(float, 4, 128)         \
  X(float, 8, 16) X(float, 8, 32) X(float, 8, 64) X(float, 8, 128)

template <typename T>
constexpr bool is_bf16() { return sizeof(T) == 2; }

}  // namespace

extern "C" {

int decode_attention_threads() { return THREADS; }
int decode_attention_max_group() { return MAX_GROUP; }
int decode_attention_stages() { return STAGES; }

int decode_attention_splits(int bkv, int s, int block_k) {
  return split_count(bkv, s, block_k);
}

// dynamic shared memory of one split block, or -1 where no kernel is built
long long decode_attention_smem_bytes(int g, int d, int block_k, int bf16) {
#define X(T_, G_, D_)                                                 \
  if (bf16 == is_bf16<T_>() && g == G_ && d == D_)                     \
    return static_cast<long long>(smem_bytes(G_, D_, block_k, sizeof(T_)));
  DECODE_INSTANCES(X)
#undef X
  return -1;
}

// q, o: contiguous [B, Hkv * G, 1, D]; k, v: contiguous [B, Hkv, S, D]; all
// of one type (bf16 when bf16 != 0, else float32), 16-byte aligned;
// slot_pos: int32 [B, S]; cur_pos: int32 [B]; part: float32 scratch of
// B * Hkv * G * splits * (D + 2) elements.  (type, G, D) one of
// DECODE_INSTANCES, block_k <= MAX_BLOCK_K, splits ==
// decode_attention_splits(B * Hkv, S, block_k).  Launches the split
// kernel, then the combine kernel.
int decode_attention_launch(const void* q, const void* k, const void* v,
                            const void* slot_pos, const void* cur_pos,
                            void* o, void* part, int B, int Hkv, int G, int S,
                            int d, int block_k, int splits, int window,
                            float scale, int bf16, void* stream) {
  if (block_k < 1 || block_k > MAX_BLOCK_K || S < 1 ||
      splits != split_count(B * Hkv, S, block_k) || splits > 2 * TARGET_BLOCKS)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto* sp = static_cast<const int*>(slot_pos);
  auto* cp = static_cast<const int*>(cur_pos);
  auto* pf = static_cast<float*>(part);
#define X(T_, G_, D_)                                                          \
  if (bf16 == is_bf16<T_>() && G == G_ && d == D_)                             \
    return launch<T_, G_, D_>(q, k, v, sp, cp, o, pf, B, Hkv, S, block_k,      \
                              splits, window, scale, s);
  DECODE_INSTANCES(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

// resident split blocks per SM at this block_k
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, after the attributes the
// launch sets), or -1 where no kernel is built
int decode_attention_occupancy(int g, int d, int block_k, int bf16) {
  int n = -1;
#define X(T_, G_, D_)                                                         \
  if (bf16 == is_bf16<T_>() && g == G_ && d == D_ &&                          \
      prepare<T_, G_, D_>(block_k) == cudaSuccess)                            \
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(                            \
        &n, decode_split_kernel<T_, G_, D_>, THREADS,                         \
        smem_bytes(G_, D_, block_k, sizeof(T_)));
  DECODE_INSTANCES(X)
#undef X
  return n;
}

// cudaFuncGetAttributes of the split kernel for (G, D, type)
int decode_attention_attributes(int g, int d, int bf16, int* regs,
                                int* static_smem, int* max_threads) {
  cudaFuncAttributes a;
  cudaError_t e = cudaErrorInvalidValue;
#define X(T_, G_, D_)                                          \
  if (bf16 == is_bf16<T_>() && g == G_ && d == D_)              \
    e = cudaFuncGetAttributes(&a, decode_split_kernel<T_, G_, D_>);
  DECODE_INSTANCES(X)
#undef X
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
