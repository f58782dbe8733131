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
// the operations bound it, so bf16 runs on the tensor cores.
//
// bf16: flash_wgmma_kernel, tensor cores fed by TMA.
// * a block has one producer warpgroup (one thread of it issues every load)
//   and BQ / 64 consumer warpgroups, each of which owns 64 query rows.
//   grid = (query tiles, B * Hq), the q tiles with the most kv tiles first
//   (blockIdx.x reversed), so that the causal triangle's long rows do not
//   finish last.  The kv head is qh / (Hq / Hkv).
// * the producer loads the Q tile once, then streams K and V tiles of BK
//   keys through a ring of STAGES stages in shared memory with
//   cp.async.bulk.tensor (TMA) over 3-D tensor maps [B * H, S, D], so that
//   a box never crosses a head and rows >= S arrive as zeros.  K runs one
//   tile ahead of V; "full" mbarriers carry the bytes, and "empty" ones
//   (one for K, one for V per stage) return each slot as soon as its
//   product has read it.  Tiles stay bf16 in the swizzled layout wgmma
//   reads: 128-byte swizzle in boxes of 64 columns (D >= 64), 64-byte at
//   D = 32, 32-byte at D = 16.
// * S = Q.K^T is wgmma m64n{BK}k16 with both operands in shared memory
//   (K-major).  The softmax scale (times log2 e, for exp2) is applied to
//   the float32 accumulator after the product; the TPU kernel scales q in
//   float32 first and its float32 jnp.dot runs at the TPU's default
//   precision.  The two orders differ by float32 rounding only, far inside
//   the bf16 tolerance of 2e-2.
// * the online softmax runs on the accumulator fragments in registers: a
//   thread holds two rows, each spread over the 4 lanes of a quad, so a
//   row max is 2 shuffles; the row sum stays per thread until the end, and
//   each score costs one FFMA and one ex2.  Only tiles that cross the
//   causal diagonal, the window's edge or S are masked, with the TPU
//   kernel's finite NEG_INF = -1e30: a row whose keys so far are all
//   masked adds exp(0) = 1 per key, and the first real score wipes that
//   with alpha = exp(-1e30 - m) = 0.  Tiles above the diagonal and tiles
//   wholly below every row's window are never loaded.
// * O += P.V is a second wgmma, m64n{D}k16: P, rounded to bf16, is the
//   register A operand (for 16-bit types the f32 accumulator layout of
//   Q.K^T is the A-fragment layout), V the shared-memory B operand,
//   MN-major with the transpose bit set.  The row sum l is taken over the
//   unrounded p, and o = acc / max(l, 1e-30) in bf16, rows >= S not stored.
// * overlap: a consumer issues S of tile i + 1 and P.V of tile i, then runs
//   the softmax of tile i + 1 while P.V is in flight.  Each product is its
//   own wgmma stage (a wgmma.fence of its own): within one stage ptxas
//   would serialize every wgmma, since the softmax reads S meanwhile.  Two
//   consumer warpgroups take turns issuing (named barriers 1 and 2), so
//   that one's softmax runs while the other's products hold the tensor
//   cores.
// * with two consumer warpgroups (384 threads, 168 registers each at
//   launch), setmaxnreg moves registers from the producer warpgroup (24) to
//   the consumers (240) at D >= 128, where S, P and the output accumulator
//   take 160-192 registers a thread.  setmaxnreg acts on whole warpgroups:
//   a lone producer warp waits in it for three warps that do not exist.
//
// float32: flash_kernel, scalar FP32 FMAs.  TF32 tensor cores keep about 10
// mantissa bits, which cannot hold the float32 tolerance of 2e-5, and
// float32 attention is on no served path, so it stays on CUDA cores:
// * grid = (query tiles of block_q rows, B * Hq); K and V stream through
//   shared memory in tiles of BK keys, with the online softmax (running
//   max m, sum l, accumulator) in registers, and the same tile skips and
//   masks as the bf16 kernel.
// * each thread owns 4 query rows (ty + TY * r) and BK / TX keys
//   (tx + TX * c) of the score tile, then the same 4 rows and D / TX output
//   columns (tx + TX * c) of the accumulator.  TX = 8 threads share a row
//   group up to D = 128, and TX = 16 at D = 256 (so block_q <= 64 there).
//   Rows of q, k and v in shared memory are D + 4 floats apart, which keeps
//   float4 loads aligned and puts neighbouring rows on different banks.
// * q is scaled in float32, as in the TPU kernel.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: scalar body
// ---------------------------------------------------------------------------
constexpr int ROWS = 4;         // query rows per thread
constexpr int PAD = 4;          // floats of padding per shared-memory row
constexpr int LOAD_BATCH = 8;   // 16-byte loads in flight per thread
constexpr int MAX_THREADS = 256;

// rows [r0, r0 + nrows) of a [S, D] matrix at element offset `base`, times
// `scale`, into dst (row stride D + PAD); rows >= S are zeros.  Each thread
// issues LOAD_BATCH 16-byte loads before it uses any.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          size_t base, int r0, int nrows,
                                          int S, int D, float scale) {
  const int ld = D + PAD;
  const int step = blockDim.x;
  const int vpr = D / 4, total = nrows * vpr;
  const float* p = src + base;
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
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int S, int Hq,
             int Hkv, int block_q, int causal, int window, float scale) {
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

  load_rows(qs, q, q_base, q0, block_q, S, D, scale);

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
    load_rows(ks, k, kv_base, k0, BK, S, D, 1.f);
    load_rows(vs, v, kv_base, k0, BK, S, D, 1.f);
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
        ps[row * LDP + tx + TX * c] = p;
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
    for (int c = 0; c < CD; ++c) o[row + tx + TX * c] = acc[i][c] / den;
  }
}

size_t scalar_smem_bytes(int block_q, int block_k, int d) {
  return sizeof(float) * (static_cast<size_t>(block_q) * (d + PAD) +
                          2 * static_cast<size_t>(block_k) * (d + PAD) +
                          static_cast<size_t>(block_q) * (block_k + 1));
}

template <int BK, int D>
int launch_scalar(const void* q, const void* k, const void* v, void* o, int B,
                  int Hq, int Hkv, int S, int block_q, int causal, int window,
                  float scale, cudaStream_t stream) {
  const int threads = block_q / ROWS * threads_per_row(D);
  if (block_q % ROWS != 0 || threads % 32 != 0 || threads > MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scalar_smem_bytes(block_q, BK, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel<BK, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S + block_q - 1) / block_q, B * Hq);
  flash_kernel<BK, D><<<grid, threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Hq, Hkv,
      block_q, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------
constexpr int STAGES = 2;           // K/V ring depth
constexpr int SMEM_ALIGN = 1024;    // the 128-byte swizzle repeats every 1 KB
constexpr int BARRIER_BYTES = 128;  // q_full and k/v full/empty per stage

// bytes of dynamic shared memory: the Q tile and STAGES K and V tiles, all
// bf16, the barriers, and room to align the tiles to 1 KB
constexpr size_t wgmma_smem_bytes(int bq, int bk, int d) {
  return 2 * static_cast<size_t>(d) * (bq + 2 * STAGES * bk) + SMEM_ALIGN +
         BARRIER_BYTES;
}

constexpr int PRODUCER_THREADS = 128;   // the producer warpgroup
constexpr int wgmma_threads(int bq) { return bq / 64 * 128 + PRODUCER_THREADS; }

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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
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

// TMA: the box at (c0, c1, c2) of `map` into dst, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (stored in 16-byte units), swizzle (1: 128 B, 2: 64 B, 3: 32 B)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint32_t swizzle) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// named barriers of the two consumer warpgroups' turns (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// wait until at most N committed groups of products are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory (K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 16] += A[64 x 16] B[16 x 16], A from registers, B from shared
// memory (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7 "
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B from shared
// memory (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 "
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from shared
// memory (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B from shared
// memory (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256], A from registers, B from shared
// memory (MN-major: the transpose bit set)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(N == 64 || N == 128, "S tile width");
  if constexpr (N == 64) wgmma_ss_n64(d, da, db, accumulate);
  else wgmma_ss_n128(d, da, db, accumulate);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128 || N == 256,
                "head width");
  if constexpr (N == 16) wgmma_rs_n16(d, a, db);
  else if constexpr (N == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// S = Q K^T for one warpgroup's 64 rows: D / 16 steps of 16 columns, both
// operands K-major in shared memory (Q rows at q_wg, K rows at k_st)
template <int D, int BQ, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2],
                                         const __nv_bfloat16* q_wg,
                                         const __nv_bfloat16* k_st) {
  constexpr int CW = D < 64 ? D : 64;
  constexpr uint32_t SWZ = CW == 64 ? 1 : CW == 32 ? 2 : 3;
  constexpr uint32_t SBO = 16 * CW;            // 8 rows of 2 * CW bytes
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = kk * 16 / CW * CW, col = kk * 16 % CW;
    wgmma_ss<BK>(s, smem_desc(q_wg + off * BQ + col, 16, SBO, SWZ),
                 smem_desc(k_st + off * BK + col, 16, SBO, SWZ), kk > 0);
  }
}

// O += P V: BK / 16 steps of 16 keys, P in registers, V MN-major in shared
// memory (its column boxes BK rows apart)
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         const __nv_bfloat16* v_st) {
  constexpr int CW = D < 64 ? D : 64;
  constexpr uint32_t SWZ = CW == 64 ? 1 : CW == 32 ? 2 : 3;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(acc, pa[kk],
                smem_desc(v_st + kk * 16 * CW, 2 * BK * CW, 16 * CW, SWZ));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// one tile's online-softmax step on the S fragments of a thread's two rows
// (qi0, qi0 + 8), in log2 units (scale_log2 = log2(e) / sqrt(D)): fold the
// row max into m and return alpha = exp2(m_old - m_new), and turn s into
// p = exp2(s * scale_log2 - m), its float32 sum folded into l.  A tile on an
// edge is scaled and masked first (NEG_INF); elsewhere the scale rides in
// one FFMA per score (the row max of s times the positive scale is the row
// max of the scaled scores).
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool edge, int k0, int qi0, int cq,
                                             int S, int causal, int window,
                                             float scale_log2) {
  float scale = scale_log2;
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 2; ++j) {
      const int kj = k0 + 8 * (j / 4) + cq + (j & 1);
      const int qi = qi0 + (j & 2 ? 8 : 0);
      const bool ok = kj < S && (!causal || kj <= qi) &&
                      (window <= 0 || kj > qi - window);
      s[j] = ok ? s[j] * scale_log2 : NEG_INF;
    }
    scale = 1.f;
  }
  float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) mt[(j >> 1) & 1] = fmaxf(mt[(j >> 1) & 1], s[j]);
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
    const float mn = fmaxf(m[r], mt[r] * scale);
    alpha[r] = fast_exp2(m[r] - mn);
    m[r] = mn;
    l[r] *= alpha[r];
    neg_m[r] = -mn;
  }
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) {
    s[j] = fast_exp2(fmaf(s[j], scale, neg_m[(j >> 1) & 1]));
    l[(j >> 1) & 1] += s[j];
  }
}

// p (float32 accumulator layout) as the bf16 A fragments of P.V
template <int BK>
__device__ __forceinline__ void pack_p(const float (&p)[BK / 2],
                                       uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
  for (int j = 0; j < BK / 2; j += 2) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p[j], p[j + 1]);
    pa[j / 8][j % 8 / 2] = *reinterpret_cast<const uint32_t*>(&h);
  }
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(wgmma_threads(BQ), 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int S, int Hq, int Hkv,
                   int causal, int window, float scale_log2) {
  constexpr int NWG = BQ / 64;                 // consumer warpgroups
  constexpr int CW = D < 64 ? D : 64;          // columns of one swizzle row
  constexpr int Q_ELEMS = BQ * D, KV_ELEMS = BK * D;
  constexpr bool MOVE_REGS = NWG == 2 && D >= 128;   // setmaxnreg

  // [Q: D / CW boxes of BQ x CW][K: STAGES x D / CW boxes of BK x CW][V: same]
  extern __shared__ uint8_t smem_raw[];
  const uintptr_t base =
      (reinterpret_cast<uintptr_t>(smem_raw) + SMEM_ALIGN - 1) &
      ~static_cast<uintptr_t>(SMEM_ALIGN - 1);
  auto* qs = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* ks = qs + Q_ELEMS;
  __nv_bfloat16* vs = ks + STAGES * KV_ELEMS;
  auto* q_full = reinterpret_cast<uint64_t*>(vs + STAGES * KV_ELEMS);
  uint64_t* k_full = q_full + 1;               // [STAGES] each
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_empty = v_full + STAGES;
  uint64_t* v_empty = k_empty + STAGES;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y;                   // b * Hq + qh
  const int b = bh / Hq, qh = bh % Hq;
  const int kv_bh = b * Hkv + qh / (Hq / Hkv);
  const int n_tiles = (S + BK - 1) / BK;
  const int kt_end = causal ? min(n_tiles, (q0 + BQ + BK - 1) / BK) : n_tiles;
  const int kt_begin =
      window > 0 && q0 - window + 1 > 0 ? (q0 - window + 1) / BK : 0;
  const int n_visit = kt_end - kt_begin;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], NWG * 4);         // lane 0 of each consumer warp
      mbar_init(&v_empty[s], NWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= NWG * 4) {
    // ---- producer: one thread issues every TMA load, K one tile ahead of
    // V (Q.K^T of tile i + 1 runs beside P.V of tile i) ----
    if constexpr (MOVE_REGS) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == NWG * 4 && lane == 0) {
      auto load_k = [&](int i) {
        const int st = i % STAGES;
        mbar_wait(&k_empty[st], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&k_full[st], 2 * KV_ELEMS);
#pragma unroll
        for (int c = 0; c < D / CW; ++c)
          tma_load_3d(ks + st * KV_ELEMS + c * BK * CW, &tm_k, &k_full[st],
                      c * CW, (kt_begin + i) * BK, kv_bh);
      };
      mbar_expect_tx(q_full, 2 * Q_ELEMS);
#pragma unroll
      for (int c = 0; c < D / CW; ++c)
        tma_load_3d(qs + c * BQ * CW, &tm_q, q_full, c * CW, q0, bh);
      load_k(0);
      for (int i = 0; i < n_visit; ++i) {
        if (i + 1 < n_visit) load_k(i + 1);
        const int st = i % STAGES;
        mbar_wait(&v_empty[st], ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(&v_full[st], 2 * KV_ELEMS);
#pragma unroll
        for (int c = 0; c < D / CW; ++c)
          tma_load_3d(vs + st * KV_ELEMS + c * BK * CW, &tm_v, &v_full[st],
                      c * CW, (kt_begin + i) * BK, kv_bh);
      }
    }
  } else {
    // ---- consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64) ----
    if constexpr (MOVE_REGS) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4;
    const int row_lo = q0 + 64 * wg;
    // this thread's rows (qi0, qi0 + 8) and first column of each 8-column block
    const int qi0 = row_lo + 16 * (warp % 4) + lane / 4;
    const int cq = 2 * (lane % 4);
    const __nv_bfloat16* q_wg = qs + 64 * wg * CW;
    // whether tile kt has a key the mask removes for one of these 64 rows
    auto edge = [&](int k0) {
      return k0 + BK > S || (causal && k0 + BK - 1 > row_lo) ||
             (window > 0 && k0 <= row_lo + 63 - window);
    };
    // with two consumer warpgroups, they take turns issuing their products
    // (named barriers 1 and 2), so that one's softmax runs while the other's
    // products hold the tensor cores; warpgroup 1 lets warpgroup 0 go first
    // and skips its last hand-over, so every arrival is awaited
    auto turn_begin = [&]() {
      if constexpr (NWG == 2) bar_sync(1 + wg, 256);
    };
    auto turn_end = [&](bool last) {
      if constexpr (NWG == 2)
        if (!(last && wg == 1)) bar_arrive(2 - wg, 256);
    };
    if (NWG == 2 && wg == 1) bar_arrive(1, 256);

    float acc[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, alpha[2];
    float s[BK / 2];
    uint32_t pa[BK / 16][4];

    // tile 0: S, then p
    mbar_wait(q_full, 0);
    mbar_wait(&k_full[0], 0);
    turn_begin();
    fence_regs(s);
    wgmma_fence();
    issue_qk<D, BQ, BK>(s, q_wg, ks);
    wgmma_commit();
    turn_end(false);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(&k_empty[0]);
    softmax_tile<BK>(s, m, l, alpha, edge(kt_begin * BK), kt_begin * BK, qi0,
                     cq, S, causal, window, scale_log2);
    pack_p<BK>(s, pa);

    // tile i < last: issue S of tile i + 1, then O += P V of tile i, each
    // product its own wgmma stage (a fence of its own), so that the softmax
    // of tile i + 1 runs on S while P V is in flight
    for (int i = 0; i + 1 < n_visit; ++i) {
      const int st = i % STAGES, sn = (i + 1) % STAGES;
      const int k0n = (kt_begin + i + 1) * BK;
      mbar_wait(&k_full[sn], ((i + 1) / STAGES) & 1);
      mbar_wait(&v_full[st], (i / STAGES) & 1);
      turn_begin();
      fence_regs(s);
      wgmma_fence();
      issue_qk<D, BQ, BK>(s, q_wg, ks + sn * KV_ELEMS);
      wgmma_commit();
      fence_regs(s);
      fence_regs(acc);
      wgmma_fence();
      issue_pv<D, BK>(acc, pa, vs + st * KV_ELEMS);
      wgmma_commit();
      fence_regs(acc);
      turn_end(false);
      wgmma_wait<1>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(&k_empty[sn]);
      softmax_tile<BK>(s, m, l, alpha, edge(k0n), k0n, qi0, cq, S, causal,
                       window, scale_log2);
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&v_empty[st]);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) acc[j] *= alpha[(j >> 1) & 1];
      pack_p<BK>(s, pa);
    }
    // the last tile's P V
    {
      const int st = (n_visit - 1) % STAGES;
      mbar_wait(&v_full[st], ((n_visit - 1) / STAGES) & 1);
      turn_begin();
      fence_regs(acc);
      wgmma_fence();
      issue_pv<D, BK>(acc, pa, vs + st * KV_ELEMS);
      wgmma_commit();
      turn_end(true);
      wgmma_wait<0>();
      fence_regs(acc);
    }

    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int r = (j >> 1) & 1;
      const int qi = qi0 + 8 * r;
      if (qi < S) {
        const size_t at = (static_cast<size_t>(bh) * S + qi) * D + 8 * (j / 4) + cq;
        *reinterpret_cast<__nv_bfloat162*>(o + at) =
            __floats2bfloat162_rn(acc[j] / den[r], acc[j + 1] / den[r]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a bf16 [heads, S, d] tensor in boxes of `rows` rows by min(d, 64) columns,
// swizzled as wgmma reads them
int make_map(CUtensorMap* map, const void* ptr, int heads, int S, int d,
             int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const int cw = d < 64 ? d : 64;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {2ull * d, 2ull * d * S};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(cw),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int D, int BQ, int BK>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int Hq, int Hkv, int S, int causal, int window, float scale,
                 cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int e = make_map(&tq, q, B * Hq, S, D, BQ);
  if (e == 0) e = make_map(&tk, k, B * Hkv, S, D, BK);
  if (e == 0) e = make_map(&tv, v, B * Hkv, S, D, BK);
  if (e != 0) return e;
  constexpr size_t smem = wgmma_smem_bytes(BQ, BK, D);
  const cudaError_t a = cudaFuncSetAttribute(
      flash_wgmma_kernel<D, BQ, BK>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (a != cudaSuccess) return static_cast<int>(a);
  const dim3 grid((S + BQ - 1) / BQ, B * Hq);
  flash_wgmma_kernel<D, BQ, BK><<<grid, wgmma_threads(BQ), smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), S, Hq, Hkv, causal, window,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// every (head width, block_q, block_k) the bf16 kernel is built for: block_q
// and block_k in {64, 128} where the tiles fit (not D = 256 with block_k 128)
#define WGMMA_INSTANCES(X)                                           \
  X(16, 64, 64) X(16, 64, 128) X(16, 128, 64) X(16, 128, 128)        \
  X(32, 64, 64) X(32, 64, 128) X(32, 128, 64) X(32, 128, 128)        \
  X(64, 64, 64) X(64, 64, 128) X(64, 128, 64) X(64, 128, 128)        \
  X(128, 64, 64) X(128, 64, 128) X(128, 128, 64) X(128, 128, 128)    \
  X(256, 64, 64) X(256, 128, 64)

#define SCALAR_DIMS(X) X(16) X(32) X(64) X(128) X(256)

bool wgmma_instance(int d, int bq, int bk) {
#define X(D_, BQ_, BK_) if (d == D_ && bq == BQ_ && bk == BK_) return true;
  WGMMA_INSTANCES(X)
#undef X
  return false;
}

bool scalar_instance(int d, int bk) {
  if (bk != 32 && bk != 64 && bk != 128) return false;
#define X(D_) if (d == D_) return true;
  SCALAR_DIMS(X)
#undef X
  return false;
}

}  // namespace

extern "C" {

// threads of one block (bf16: the consumer warpgroups and the producer
// warp), or -1 where no kernel is built for the point
int flash_attention_threads(int block_q, int block_k, int d, int bf16) {
  if (bf16) return wgmma_instance(d, block_q, block_k) ? wgmma_threads(block_q) : -1;
  return scalar_instance(d, block_k) ? block_q / ROWS * threads_per_row(d) : -1;
}

// dynamic shared memory of one block, or -1 where no kernel is built
long long flash_attention_smem_bytes(int block_q, int block_k, int d, int bf16) {
  if (bf16)
    return wgmma_instance(d, block_q, block_k)
               ? static_cast<long long>(wgmma_smem_bytes(block_q, block_k, d))
               : -1;
  return scalar_instance(d, block_k)
             ? static_cast<long long>(scalar_smem_bytes(block_q, block_k, d))
             : -1;
}

// q, o: contiguous [B, Hq, S, D]; k, v: contiguous [B, Hkv, S, D]; all of
// one type (bf16 when bf16 != 0, else float32), 16-byte aligned.
// bf16: (d, block_q, block_k) one of WGMMA_INSTANCES.  float32: block_q in
// {32, 64, 128} (at most 64 at d = 256: 4 * block_q threads), block_k in
// {32, 64, 128}, d in {16, 32, 64, 128, 256}.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int B, int Hq, int Hkv, int S, int d,
                           int block_q, int block_k, int causal, int window,
                           float scale, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (bf16) {
#define X(D_, BQ_, BK_)                                                    \
    if (d == D_ && block_q == BQ_ && block_k == BK_)                       \
      return launch_wgmma<D_, BQ_, BK_>(q, k, v, o, B, Hq, Hkv, S, causal, \
                                        window, scale, s);
    WGMMA_INSTANCES(X)
#undef X
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define X(D_)                                                                 \
  if (d == D_) {                                                              \
    switch (block_k) {                                                        \
      case 32: return launch_scalar<32, D_>(q, k, v, o, B, Hq, Hkv, S,        \
                                            block_q, causal, window, scale, s); \
      case 64: return launch_scalar<64, D_>(q, k, v, o, B, Hq, Hkv, S,        \
                                            block_q, causal, window, scale, s); \
      case 128: return launch_scalar<128, D_>(q, k, v, o, B, Hq, Hkv, S,      \
                                              block_q, causal, window, scale, s); \
    }                                                                         \
  }
  SCALAR_DIMS(X)
#undef X
  return static_cast<int>(cudaErrorInvalidValue);
}

// cudaFuncGetAttributes of the instance that runs (block_q, block_k, d) in
// the given type
int flash_attention_attributes(int block_q, int block_k, int d, int bf16,
                               int* regs, int* static_smem, int* max_threads) {
  cudaFuncAttributes a;
  cudaError_t e = cudaErrorInvalidValue;
  if (bf16) {
#define X(D_, BQ_, BK_)                                   \
    if (d == D_ && block_q == BQ_ && block_k == BK_)      \
      e = cudaFuncGetAttributes(&a, flash_wgmma_kernel<D_, BQ_, BK_>);
    WGMMA_INSTANCES(X)
#undef X
  } else {
#define X(D_)                                                                 \
    if (d == D_) {                                                            \
      if (block_k == 32) e = cudaFuncGetAttributes(&a, flash_kernel<32, D_>); \
      if (block_k == 64) e = cudaFuncGetAttributes(&a, flash_kernel<64, D_>); \
      if (block_k == 128) e = cudaFuncGetAttributes(&a, flash_kernel<128, D_>); \
    }
    SCALAR_DIMS(X)
#undef X
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
