// Flash attention over a whole prompt, for Hopper.
//
// For query row i of (batch row b, head h) and the keys j of the same
// batch row:
//
//   out[b, i, h] = sum_j softmax_j(s[i, j]) v[b, j, h // group],
//   s[i, j] = (q[b, i, h] . k[b, j, h // group]) * d^-0.5
//
// masked to j <= i when causal (both indices count from the start of
// their sequences). q is (B, Sq, H, d) and k, v are (B, Sk, Hkv, d), all
// fp32 or all bf16, contiguous; group = H / Hkv, so query head h reads
// KV head h / group by index: no repeat, no transpose. Output (B, Sq, H,
// d) in q's dtype. d is 64 or 128; Sq and Sk are any lengths.
//
// Replaces repro/kernels/flash_attention.py:flash_attention_p (Pallas,
// TPU; body _flash_kernel). There the grid (B*H, Sq/128, Sk/128) walks
// the KV axis in order and keeps the online-softmax state (m, l, acc) in
// VMEM scratch across grid steps; the heads are pre-folded into rows and
// the KV heads repeated per group by ops.py, and S % 128 == 0 is
// asserted. Here thread blocks run in parallel and carry nothing between
// them, so the KV walk is a loop inside one block. Two kernels, routed
// by dtype (flash_attention_launch):
//
// bf16: flash_tc_kernel, on Hopper's tensor cores.
//   * one CTA per (128 query rows, head, batch row), issued heaviest
//     query tile first (causal tiles near the end of the prompt walk the
//     most keys), of three warpgroups: a producer whose one thread keeps
//     TMA loads in flight, and two consumers of 64 query rows each;
//     setmaxnreg moves the producer's registers to the consumers;
//   * q, K and V are (B, S, heads, d) tensor maps (cuTensorMapEncodeTiled
//     through cudaGetDriverEntryPoint, so the library needs no -lcuda)
//     loaded as 64 x 64 bf16 boxes with 128-byte swizzle, a 128-wide head
//     dim as two boxes; TMA's out-of-bounds zero fill pads the ragged Sq
//     and Sk edges; K and V stream through a 3-stage ring of mbarriers
//     (full per K and per V tile, empty per stage);
//   * S = Q . K^T by wgmma m64n64k16 (bf16 in, fp32 accumulate, both
//     operands from shared memory), the scale applied after the dot as
//     the reference does (d^-0.5 is not a power of two at d = 128);
//     row max and sum by quad shuffles; p = exp(s - m) in fp32 by
//     __expf (ex2.approx: about 2^-20 relative, far inside the one-bf16-
//     ulp check, and 7% faster than expf at the served shape), l over
//     the unrounded p; O += P . V by wgmma m64n{d}k16 with P from
//     registers and V from shared memory (MN-major). The reference keeps
//     p in fp32, so P goes in as two bf16 terms, p_hi = bf16(p) and
//     p_lo = bf16(p - p_hi), into one fp32 accumulator: about 2^-17
//     relative representation error where one bf16 P would leave 2^-9;
//   * tile kt + 1's Q . K^T is issued before tile kt's P . V, and its
//     softmax runs while P . V is on the tensor cores;
//   * when causal, KV tiles wholly above the CTA's diagonal are not
//     loaded, and a warpgroup skips the math of those above its own; only
//     the diagonal tile and the Sk edge are masked;
//   * the bf16 output tile goes back through the warpgroup's q buffer
//     and one TMA store (which drops rows past Sq).
//
// fp32: flash_kernel, on the CUDA cores (fp32 inputs do not fit bf16
// tensor cores):
//   * one thread block (256 threads) per (64 query rows, head, batch
//     row); it stages its q tile in shared memory once, then walks the
//     KV tiles of 64 keys, staging K, computing the 64 x 64 scores, the
//     row max and the probabilities, then staging V over K's buffer and
//     adding P.V into the accumulator;
//   * a thread owns 4 query rows x 4 keys of the scores (keys tx + 16j:
//     16-byte shared-memory reads without bank conflicts) and the same
//     4 rows x d/16 output dimensions; the 16 threads of a row reduce
//     its max and sum with shuffles; the accumulator lives in registers.
//
// Both compute _flash_kernel's numbers: q, k, v widened to fp32 (bf16
// products are exact in fp32), fp32 dot products with the scale after
// the sum, masked scores the finite -1e30, fp32 p, l = l * corr +
// sum(p), out = acc / max(l, 1e-30) rounded once to q's dtype. The
// ragged edge is masked where the Pallas kernel asserts: keys past Sk
// score -1e30 and read zeros, rows past Sq are not written; when causal,
// KV tiles wholly above the diagonal are skipped
// (flash_attention.py:56-58).
//
// What bounds it on an H100: the function must read q, k, v and write
// out once (42 MB in bf16 at qwen1.5-4b's 4 x 512-token prefill, 12.5 us
// at 3.35 TB/s) and do 4 * Sq * Sk * d flops per head (halved when
// causal: 5.4 GFLOP there, 5.4 us on bf16 tensor cores; 8.1 GFLOP with
// the two-term P . V, 8.2 us), so the bound is memory. The bf16 kernel
// is latency-bound at that size (each CTA walks 2-8 KV tiles); the fp32
// kernel is bound by fp32 FMA issue on the CUDA cores.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;          // threads per block
constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per KV tile
constexpr int PAD = 4;           // floats of padding per shared row
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Shared memory: q tile (BQ, D + PAD), one K-or-V tile (BK, D + PAD),
// probabilities (BQ, BK + PAD), all fp32.
size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)BQ * (d + PAD) + (size_t)BK * (d + PAD) +
                          (size_t)BQ * (BK + PAD));
}

// Stage rows [r0, r0 + rows) of a (B, S, heads, D) tensor's head `hh`
// into dst (rows, D + PAD) as fp32; rows at or past S read zeros.
template <typename T, int D>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int b, int r0, int S, int heads,
                                      int hh, int rows) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < rows * C4; i += NT) {
    const int r = i / C4, c = (i % C4) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S)
      val = load4(src + (((size_t)b * S + r0 + r) * heads + hh) * D + c);
    store4(dst + r * (D + PAD) + c, val);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int Sq, int Sk,
             int H, int Hkv, float scale, int causal) {
  constexpr int DP = D + PAD, PP = BK + PAD;
  constexpr int DC = D / 64;     // 4-wide column groups a thread owns
  extern __shared__ float sm[];
  float* qs = sm;                          // (BQ, DP)
  float* kv = qs + BQ * DP;                // (BK, DP): K, then V
  float* ps = kv + BK * DP;                // (BQ, PP)

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  stage<T, D>(qs, q, b, q0, Sq, H, h, BQ);

  float m[4], l[4], acc[4][DC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DC * 4; ++e) acc[i][e] = 0.f;
  }

  const int last_q = min(q0 + BQ, Sq) - 1;
  int nk = (Sk + BK - 1) / BK;
  if (causal) nk = min(nk, last_q / BK + 1);   // tiles above the diagonal

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();             // q staged / previous V consumed
    stage<T, D>(kv, k, b, k0, Sk, Hkv, hk, BK);
    __syncthreads();

    // scores: rows ty*4 + i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = load4(qs + (ty * 4 + i) * DP + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = load4(kv + (tx + 16 * j) * DP + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
        }
    }

    // mask, online softmax; a row's 16 threads are lanes of one half-warp
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        const bool ok = kj < Sk && (!causal || kj <= qi);
        s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();             // scores done with K; P complete

    stage<T, D>(kv, v, b, k0, Sk, Hkv, hk, BK);
    __syncthreads();

    // acc = acc * corr + P.V: rows ty*4 + i, dims c*64 + tx*4 + e
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < DC * 4; ++e) acc[i][e] *= corr[i];
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = load4(ps + (ty * 4 + i) * PP + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float4 vv = load4(kv + (kk + u) * DP + c * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pr[i].x : u == 1 ? pr[i].y
                          : u == 2 ? pr[i].z : pr[i].w;
            acc[i][c * 4 + 0] = fmaf(p, vv.x, acc[i][c * 4 + 0]);
            acc[i][c * 4 + 1] = fmaf(p, vv.y, acc[i][c * 4 + 1]);
            acc[i][c * 4 + 2] = fmaf(p, vv.z, acc[i][c * 4 + 2]);
            acc[i][c * 4 + 3] = fmaf(p, vv.w, acc[i][c * 4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const float4 o4 = make_float4(
          acc[i][c * 4 + 0] / li, acc[i][c * 4 + 1] / li,
          acc[i][c * 4 + 2] / li, acc[i][c * 4 + 3] / li);
      store4(out + (((size_t)b * Sq + qi) * H + h) * D + c * 64 + tx * 4,
             o4);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Sk, int H, int Hkv, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Sk, H, Hkv, scale,
      causal);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 on Hopper's tensor cores: wgmma fed by TMA, warp-specialised.

constexpr int TQ = 128;          // query rows per CTA: 2 warpgroups of 64
constexpr int TK = 64;           // keys per KV tile
constexpr int TSTAGES = 3;       // K/V ring depth
constexpr int TTHREADS = 384;    // 2 consumer warpgroups + 1 producer
constexpr int BOX = 64 * 64 * 2; // one TMA box: 64 rows x 64 bf16 (128 B)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// wait until the phase of parity `parity` has completed; a phase that
// never completes (a lost load) traps after ~2^35 cycles instead of
// hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (!t0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 35)) __trap();
  }
}
// one box of a 4-D (d, head, row, batch) tensor map into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// one box of shared memory into a 4-D tensor map (rows past the map's
// bounds are dropped); committed as a bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading (LBO) and stride (SBO) byte offsets, all in 16-byte units
__device__ __forceinline__ uint64_t sdesc(const void* p, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 64, fp32) (+)= A (64 x 16) . B (64 x 16)^T, A and B K-major in
// shared memory; acc = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, fp32) (+)= A (64 x 16, registers) . B (16 x 64, MN-major
// in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// d (64 x 128, fp32) (+)= A (64 x 16, registers) . B (16 x 128, MN-major
// in shared memory)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

// Shared memory: 1 KB of alignment slack (swizzled tiles sit on 1024-byte
// boundaries), q (2 warpgroups x D/64 boxes), the K and V rings, then the
// barriers: q full, K full x stages, V full x stages, empty x stages.
size_t tc_smem_bytes(int d) {
  const size_t tile = (size_t)(d / 64) * BOX;
  return 1024 + 2 * tile + 2 * TSTAGES * tile + 8 * (1 + 3 * TSTAGES);
}

// The online-softmax state of a thread's two rows (a: lane / 4, b: + 8)
// and the correction factor of the last tile folded in.
struct Softmax {
  float ma, mb, la, lb, ca, cb;
};

// Scores of a 64-key tile in sc (wgmma m64n64 layout: element i is row
// a (i & 2 == 0) or b, key 8 (i / 4) + cq + (i & 1)) -> p = exp(s - m) in
// place: the scale after the dot, the Sk edge and the diagonal masked to
// -1e30, m and l (of the unrounded p) updated, corr = exp(m_old - m).
__device__ __forceinline__ void online_softmax(float (&sc)[32], Softmax& st,
                                               int k0, int Sk, int causal,
                                               int row0, int ra, int rb,
                                               int cq, float scale) {
  const bool edge = k0 + TK > Sk || (causal && k0 + TK - 1 > row0);
  float mxa = NEG_INF, mxb = NEG_INF;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int kj = k0 + 8 * (i / 4) + cq + (i & 1);
    const int qi = (i & 2) ? rb : ra;
    float x = sc[i] * scale;
    if (edge && (kj >= Sk || (causal && kj > qi))) x = NEG_INF;
    sc[i] = x;
    if (i & 2) mxb = fmaxf(mxb, x);
    else mxa = fmaxf(mxa, x);
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
    mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
  }
  const float na = fmaxf(st.ma, mxa), nb = fmaxf(st.mb, mxb);
  st.ca = __expf(st.ma - na);
  st.cb = __expf(st.mb - nb);
  st.ma = na;
  st.mb = nb;
  float suma = 0.f, sumb = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = __expf(sc[i] - ((i & 2) ? nb : na));
    if (i & 2) sumb += sc[i];
    else suma += sc[i];
  }
  st.la = st.la * st.ca + suma;
  st.lb = st.lb * st.cb + sumb;
}

// Wait for tile kt's K and issue S = Q . K^T into sc (D/16 k-steps of
// 16, 32 bytes apart in a 128-byte swizzled box); committed, not waited.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[32],
                                         const unsigned char* qw,
                                         const unsigned char* sk,
                                         uint64_t* full_k, int kt) {
  bar_wait(full_k + kt % TSTAGES, (kt / TSTAGES) & 1);
  const unsigned char* kb = sk + (kt % TSTAGES) * (D / 64) * BOX;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_ss_n64(sc, sdesc(qw + off, 16, 1024), sdesc(kb + off, 16, 1024),
                 kk > 0);
  }
  wgmma_commit();
}

// sc holds a tile's p: rescale O by the tile's corr and split p into
// the A fragments of P . V, p = p_hi + p_lo (both bf16; m64n64 layout:
// k-step kk takes elements 8 kk .. 8 kk + 7).
template <int NO>
__device__ __forceinline__ void rescale_and_split(float (&o)[NO],
                                                  const float (&sc)[32],
                                                  const Softmax& st,
                                                  uint32_t (&phi)[4][4],
                                                  uint32_t (&plo)[4][4]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] *= (i & 2) ? st.cb : st.ca;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      // one packed conversion for p_hi; its two floats are its bits
      // shifted into place (conversions share a slow pipe with exp)
      const float x0 = sc[8 * kk + 2 * r], x1 = sc[8 * kk + 2 * r + 1];
      const uint32_t hi = pack_bf16(x0, x1);
      phi[kk][r] = hi;
      plo[kk][r] = pack_bf16(x0 - __uint_as_float(hi << 16),
                             x1 - __uint_as_float(hi & 0xffff0000u));
    }
}

// Wait for tile kt's V and issue O += P_hi . V + P_lo . V (V MN-major,
// 16 keys = 2 KB a k-step, its two 64-wide boxes BOX bytes apart);
// committed, not waited.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&phi)[4][4],
                                         const uint32_t (&plo)[4][4],
                                         const unsigned char* sv,
                                         uint64_t* full_v, int kt) {
  bar_wait(full_v + kt % TSTAGES, (kt / TSTAGES) & 1);
  const unsigned char* vb = sv + (kt % TSTAGES) * (D / 64) * BOX;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dv = sdesc(vb + kk * 2048, BOX, 1024);
    if constexpr (D == 128) {
      wgmma_rs_n128(o, phi[kk], dv, 1);
      wgmma_rs_n128(o, plo[kk], dv, 1);
    } else {
      wgmma_rs_n64(o, phi[kk], dv, 1);
      wgmma_rs_n64(o, plo[kk], dv, 1);
    }
  }
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(TTHREADS, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap to, int Sq, int Sk,
                int H, int Hkv, float scale, int causal) {
  constexpr int DB = D / 64;                 // 64-wide boxes of a row
  constexpr int TILE = DB * BOX;             // bytes of a 64-row tile
  constexpr int NO = D / 2;                  // O accumulators a thread
  extern __shared__ unsigned char fsm_raw[];
  unsigned char* fsm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(fsm_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* sq = fsm;                           // 2 x TILE
  unsigned char* sk = sq + 2 * TILE;                 // TSTAGES x TILE
  unsigned char* sv = sk + TSTAGES * TILE;           // TSTAGES x TILE
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sv + TSTAGES * TILE);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + TSTAGES;
  uint64_t* empty = full_v + TSTAGES;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * TQ;  // heaviest tiles first
  const int hk = h / (H / Hkv);
  const int last_q = min(q0 + TQ, Sq) - 1;
  int nk = (Sk + TK - 1) / TK;
  if (causal) nk = min(nk, last_q / TK + 1);         // above the diagonal
  const int nwg = q0 + 64 < Sq ? 2 : 1;              // warpgroups with rows
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < TSTAGES; ++s) {
      bar_init(full_k + s, 1);
      bar_init(full_v + s, 1);
      bar_init(empty + s, 8);                        // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: one thread keeps the ring's TMA loads in
    // flight; the group gives its registers to the consumers (setmaxnreg
    // moves registers between the warpgroups of a CTA only: 128 x (168 -
    // 24) released = 256 x (240 - 168) taken, at 168 a thread on entry)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == 8 && lane == 0) {
      bar_expect_tx(bar_q, nwg * TILE);
      for (int w = 0; w < nwg; ++w)
        for (int db = 0; db < DB; ++db)
          tma_load(sq + w * TILE + db * BOX, &tq, bar_q, db * 64, h,
                   q0 + w * 64, b);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % TSTAGES;
        if (kt >= TSTAGES) bar_wait(empty + s, (kt / TSTAGES - 1) & 1);
        bar_expect_tx(full_k + s, TILE);
        for (int db = 0; db < DB; ++db)
          tma_load(sk + s * TILE + db * BOX, &tk, full_k + s, db * 64, hk,
                   kt * TK, b);
        bar_expect_tx(full_v + s, TILE);
        for (int db = 0; db < DB; ++db)
          tma_load(sv + s * TILE + db * BOX, &tv, full_v + s, db * 64, hk,
                   kt * TK, b);
      }
    }
  } else {
    // consumers: warpgroup w owns query rows q0 + 64 w .. + 63. Tile kt's
    // P . V runs on the tensor cores while the warpgroup turns tile
    // kt + 1's scores into probabilities.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int w = warp / 4, wl = warp % 4;
    const int row0 = q0 + 64 * w;                    // warpgroup's first row
    const int ra = row0 + 16 * wl + lane / 4, rb = ra + 8;
    const int cq = 2 * (lane % 4);
    // tiles with work: none without rows; when causal none wholly above
    // the warpgroup's diagonal (they would add exactly 0)
    int nw = w < nwg ? nk : 0;
    if (causal) nw = min(nw, (row0 + 63) / TK + 1);
    const unsigned char* qw = sq + w * TILE;
    float o[NO], sc[32];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    Softmax sm{NEG_INF, NEG_INF, 0.f, 0.f, 0.f, 0.f};
    if (nw > 0) {
      bar_wait(bar_q, 0);
      issue_qk<D>(sc, qw, sk, full_k, 0);
      wgmma_wait<0>();
      online_softmax(sc, sm, 0, Sk, causal, row0, ra, rb, cq, scale);
    }
    // tiles 0 .. nw - 2 issue the next tile's Q . K^T unconditionally
    // (a branch around it would make ptxas serialise the wgmmas); the
    // last tile runs alone
    for (int kt = 0; kt + 1 < nw; ++kt) {
      uint32_t phi[4][4], plo[4][4];
      rescale_and_split<NO>(o, sc, sm, phi, plo);
      issue_qk<D>(sc, qw, sk, full_k, kt + 1);
      issue_pv<D>(o, phi, plo, sv, full_v, kt);
      wgmma_wait<1>();                               // the scores of kt + 1
      online_softmax(sc, sm, (kt + 1) * TK, Sk, causal, row0, ra, rb, cq,
                     scale);
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) bar_arrive(empty + kt % TSTAGES);
    }
    if (nw > 0) {
      uint32_t phi[4][4], plo[4][4];
      rescale_and_split<NO>(o, sc, sm, phi, plo);
      issue_pv<D>(o, phi, plo, sv, full_v, nw - 1);
      wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) bar_arrive(empty + (nw - 1) % TSTAGES);
    }
    // the remaining tiles: wait for them and release them, so the ring
    // turns for the other warpgroup
    for (int kt = nw; kt < nk; ++kt) {
      const int s = kt % TSTAGES, ph = (kt / TSTAGES) & 1;
      bar_wait(full_k + s, ph);
      bar_wait(full_v + s, ph);
      __syncwarp();
      if (lane == 0) bar_arrive(empty + s);
    }
    float la = sm.la, lb = sm.lb;

    // out = acc / max(l, 1e-30), rounded once to bf16
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, off);
      lb += __shfl_xor_sync(0xffffffffu, lb, off);
    }
    // one reciprocal a row (64 divisions would queue on the slow pipe;
    // the product is within an fp32 ulp of the quotient); the bf16 tile
    // goes into the warpgroup's q buffer (free once its last Q . K^T is
    // done) in the same swizzled layout, then out by TMA, which drops
    // the rows past Sq
    if (nw > 0) {
      const float ia = 1.f / fmaxf(la, 1e-30f), ib = 1.f / fmaxf(lb, 1e-30f);
      unsigned char* ow = sq + w * TILE;
      const int r0 = 16 * wl + lane / 4;              // rows r0 and r0 + 8
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        unsigned char* box = ow + (j / 8) * BOX + 2 * cq;
        *reinterpret_cast<uint32_t*>(box + r0 * 128 +
                                     (((j % 8) ^ (r0 % 8)) * 16)) =
            pack_bf16(o[4 * j] * ia, o[4 * j + 1] * ia);
        *reinterpret_cast<uint32_t*>(box + (r0 + 8) * 128 +
                                     (((j % 8) ^ (r0 % 8)) * 16)) =
            pack_bf16(o[4 * j + 2] * ib, o[4 * j + 3] * ib);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
      if (wl == 0 && lane == 0) {
        for (int db = 0; db < DB; ++db)
          tma_store(&to, ow + db * BOX, db * 64, h, row0, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled through the runtime, so the library
// links against the runtime only (no -lcuda).
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (B, S, heads, D) bf16 tensor as a 4-D map of 64 x 64 boxes (d fastest)
// with 128-byte swizzle; rows past S read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int D) {
  EncodeTiled enc = encode_fn();
  if (!enc) return false;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                           (cuuint64_t)S * heads * D * 2};
  cuuint32_t box[4] = {64, 1, 64, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out, int B,
              int Sq, int Sk, int H, int Hkv, float scale, int causal,
              cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (!make_map(&mq, q, B, Sq, H, D) || !make_map(&mk, k, B, Sk, Hkv, D) ||
      !make_map(&mv, v, B, Sk, Hkv, D) || !make_map(&mo, out, B, Sq, H, D))
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the setmaxnreg split balances only at 168 registers a thread on
  // entry; at any other count the consumers would wait for registers
  // forever, so refuse the launch instead
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, flash_tc_kernel<D>);
  if (err != cudaSuccess) return (int)err;
  if (attr.numRegs != 168) return (int)cudaErrorInvalidConfiguration;
  dim3 grid(H, B, (Sq + TQ - 1) / TQ);
  flash_tc_kernel<D><<<grid, TTHREADS, smem, stream>>>(
      mq, mk, mv, mo, Sq, Sk, H, Hkv, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// shared memory of the kernel that `dtype` (0 = fp32, 1 = bf16) takes
size_t flash_attention_smem_bytes(int d, int dtype) {
  return dtype == 1 ? tc_smem_bytes(d) : smem_bytes(d);
}

// dtype: 0 = fp32, 1 = bf16 (q, k, v and out); d: 64 or 128. Returns the
// cudaError_t of the launch (0 on success); launches on `stream` and does
// not synchronise.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int H, int Hkv,
                           int d, float scale, int causal, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv || B < 1 || Sq < 1 || Sk < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && d == 64)
    return launch<float, 64>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal,
                             s);
  if (dtype == 0 && d == 128)
    return launch<float, 128>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal,
                              s);
  if (dtype == 1 && d == 64)
    return launch_tc<64>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal, s);
  if (dtype == 1 && d == 128)
    return launch_tc<128>(q, k, v, out, B, Sq, Sk, H, Hkv, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
