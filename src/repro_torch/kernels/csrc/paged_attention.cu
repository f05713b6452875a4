// Paged GQA attention straight from the KV block arena, for Hopper.
//
// For query row r of (batch row b, KV head h) at position tq:
//
//   out[r] = sum_p softmax_p(s[r, p]) v[p],  s[r, p] = (q[r] . k[p]) * scale
//
// over every cached position p of the row's blocks, masked to
// pos[p] >= 0, pos[p] <= tq and (window > 0) pos[p] > tq - window.
// q is (B, C, H, hd) fp32 or bf16; the arenas k and v are (n_blocks,
// block_len, Hkv, hd) in fp32, bf16, fp8 e4m3 or int8 (then with fp32
// scale arenas (n_blocks, block_len, Hkv)); pos is (B, T * block_len)
// int32, t (B, C) int32 and the block table (B, T) int32 with -1 for an
// unassigned block. The C query tokens of a row and the `group` query
// heads of a KV head fold into R = C * group query rows, row c * group +
// g reading head h * group + g of token c, each with its own position
// t[b, c]. Output (B, C, H, hd) in q's dtype. C == 1 is the decode tick
// (one launch per layer), C > 1 the chunked prefill of a mixed tick.
//
// Replaces repro/kernels/paged_attention.py:gqa_paged_p (C == 1) and
// gqa_paged_chunk_p (C > 1) (Pallas, TPU). There the block table is
// scalar-prefetched, the grid (B, Hkv, T) walks the row's table entries
// in order, each step DMAs one arena block into VMEM, and the online-
// softmax state lives in VMEM scratch across grid steps. Here blocks
// run in parallel and carry nothing between them, so the walk over the
// table is a loop inside one thread block:
//
//   * one thread block per (batch row, KV head, tile of up to 16 query
//     rows); it reads its own table row, skips -1 entries, and stages
//     one arena block of K and V (block_len x hd, converted to the
//     compute dtype) and its positions in shared memory;
//   * scores, the running max m, the running sum l and the rescaled
//     accumulator are fp32; the accumulator lives in registers, the
//     scores and per-row stats in shared memory;
//   * the rounding mirrors the reference exactly: the compute dtype is
//     bf16 for 1-byte arenas (fp8, int8) and the arena's dtype otherwise
//     (fp32, bf16, fp16); q is rounded to it; int8 is dequantized as fp32
//     value * scale, then rounded to bf16; p is rounded to it before the
//     PV product; l sums the unrounded p; out = acc / max(l, 1e-30);
//   * masked scores are the reference's finite -1e30, so a tile with
//     every position masked gives exp(0) = 1: finite garbage that the
//     correction factor erases once a valid block arrives (-inf would
//     give NaN). Rows with no valid position at all (pad rows, t < 0)
//     are garbage, as in the reference.
//
// That kernel, gqa_paged_kernel, serves fp32 arenas and head dims the
// tensor-core kernel does not take. Every other launch -- the C == 1
// decode and C > 1 chunks alike, over bf16-compute arenas (bf16, fp8,
// int8) and fp16 arenas -- takes gqa_chunk_tc_kernel, whose comment below
// says how it tiles and splits the walk; at C == 1 the `group` query rows
// of a KV head fill part of one m16 tile. The wrapper routes by dtype and
// shape (paged_attention.py:decode_route and chunk_route).
//
// What bounds it on an H100: the function must read each valid block's
// K and V once (2 * block_len * Hkv * hd * bytes per block) plus q and
// out; its flops (4 * R * hd per cached position) are far below the
// tensor-core rate, so the bound is memory. gqa_paged_kernel issues one
// thread block per (b, h, 16 rows) -- 80 blocks for a qwen1.5-4b tick at
// 4 slots, fewer than the 132 SMs -- and walks the blocks serially with
// four barriers each, so it is latency-bound far above that bound; the
// tensor-core kernel splits the walk across warps and CTAs and keeps
// every step's copies in flight at the served lengths, so its floor is a
// few memory round trips and its launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NT = 128;          // threads per block
constexpr int RT = 16;           // query rows per block (at most)
constexpr int MAXACC = 32;       // accumulators per thread: rt*hd <= NT*MAXACC
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);          // exact in bf16 too
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
// compute dtype codes: 0 = fp32 (no rounding), 1 = bf16, 2 = fp16
__device__ __forceinline__ float cdt_round(float v, int cdt) {
  if (cdt == 1) return bf16_round(v);
  if (cdt == 2) return __half2float(__float2half_rn(v));
  return v;
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory of one block: q (rt, hd+1), K (bl, hd+1), V (bl, hd),
// scores/probs (rt, bl), m/l/corr (rt) as fp32; query and cached
// positions as int32. The +1 pads keep the per-thread dot products off
// a single bank.
size_t smem_bytes(int rt, int bl, int hd) {
  return sizeof(float) * ((size_t)rt * (hd + 1) + (size_t)bl * (hd + 1) +
                          (size_t)bl * hd + (size_t)rt * bl + 3 * rt) +
         sizeof(int) * ((size_t)rt + bl);
}

template <typename Q, typename KV, bool QUANT>
__global__ void __launch_bounds__(NT)
gqa_paged_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
                 const KV* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ pos,
                 const int* __restrict__ t, const int* __restrict__ table,
                 Q* __restrict__ out, int C, int H, int Hkv, int hd, int bl,
                 int T, int window, float scale, int cdt, int rt) {
  extern __shared__ float sm[];
  const int hdp = hd + 1;
  float* qs = sm;                          // (rt, hdp)
  float* ksm = qs + (size_t)rt * hdp;      // (bl, hdp)
  float* vsm = ksm + (size_t)bl * hdp;     // (bl, hd)
  float* ps = vsm + (size_t)bl * hd;       // (rt, bl)
  float* mrow = ps + (size_t)rt * bl;      // (rt)
  float* lrow = mrow + rt;
  float* crow = lrow + rt;
  int* tr = reinterpret_cast<int*>(crow + rt);   // (rt) query positions
  int* pk = tr + rt;                              // (bl) cached positions

  const int group = H / Hkv;
  const int R = C * group;
  const int r0 = blockIdx.x * rt;
  const int nr = min(rt, R - r0);
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;

  // query rows, rounded to the compute dtype; row r = c * group + g
  for (int i = tid; i < rt * hd; i += NT) {
    const int rr = i / hd, d = i % hd;
    float val = 0.f;
    if (rr < nr) {
      const int r = r0 + rr, c = r / group, g = r % group;
      val = to_f(q[(((size_t)b * C + c) * H + h * group + g) * hd + d]);
      val = cdt_round(val, cdt);
    }
    qs[rr * hdp + d] = val;
  }
  for (int rr = tid; rr < rt; rr += NT) {
    mrow[rr] = NEG_INF;
    lrow[rr] = 0.f;
    tr[rr] = rr < nr ? t[(size_t)b * C + (r0 + rr) / group] : -1;
  }

  float acc[MAXACC];
#pragma unroll
  for (int j = 0; j < MAXACC; ++j) acc[j] = 0.f;

  for (int jb = 0; jb < T; ++jb) {
    const int blk = table[(size_t)b * T + jb];   // same for every thread
    if (blk < 0) continue;                       // unassigned: skip
    __syncthreads();             // init done / previous block consumed
    for (int i = tid; i < bl * hd; i += NT) {
      const int p = i / hd, d = i % hd;
      const size_t row = ((size_t)blk * bl + p) * Hkv + h;
      float kv = to_f(k[row * hd + d]), vv = to_f(v[row * hd + d]);
      if (QUANT) {               // dequantize_kv: fp32 multiply, then bf16
        kv = bf16_round(kv * ks[row]);
        vv = bf16_round(vv * vs[row]);
      }
      ksm[p * hdp + d] = kv;
      vsm[p * hd + d] = vv;
    }
    for (int p = tid; p < bl; p += NT)
      pk[p] = pos[((size_t)b * T + jb) * bl + p];
    __syncthreads();

    for (int i = tid; i < rt * bl; i += NT) {
      const int rr = i / bl, p = i % bl;
      float s = 0.f;
      for (int d = 0; d < hd; ++d)
        s = fmaf(qs[rr * hdp + d], ksm[p * hdp + d], s);
      s *= scale;
      const int tq = tr[rr], pp = pk[p];
      bool valid = pp >= 0 && pp <= tq;
      if (window > 0) valid = valid && pp > tq - window;
      ps[i] = valid ? s : NEG_INF;
    }
    __syncthreads();

    for (int rr = tid; rr < rt; rr += NT) {
      const float m_prev = mrow[rr];
      float m_new = m_prev;
      for (int p = 0; p < bl; ++p) m_new = fmaxf(m_new, ps[rr * bl + p]);
      float sum = 0.f;
      for (int p = 0; p < bl; ++p) {
        const float e = expf(ps[rr * bl + p] - m_new);
        sum += e;
        ps[rr * bl + p] = cdt_round(e, cdt);
      }
      const float corr = expf(m_prev - m_new);
      lrow[rr] = lrow[rr] * corr + sum;
      mrow[rr] = m_new;
      crow[rr] = corr;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < MAXACC; ++j) {
      const int idx = tid + j * NT;
      if (idx < rt * hd) {
        const int rr = idx / hd, d = idx % hd;
        float pv = 0.f;
        for (int p = 0; p < bl; ++p)
          pv = fmaf(ps[rr * bl + p], vsm[p * hd + d], pv);
        acc[j] = acc[j] * crow[rr] + pv;
      }
    }
  }
  __syncthreads();               // lrow final (also when no block ran)

#pragma unroll
  for (int j = 0; j < MAXACC; ++j) {
    const int idx = tid + j * NT;
    if (idx < rt * hd) {
      const int rr = idx / hd, d = idx % hd;
      if (rr < nr) {
        const int r = r0 + rr, c = r / group, g = r % group;
        store_f(out + (((size_t)b * C + c) * H + h * group + g) * hd + d,
                acc[j] / fmaxf(lrow[rr], 1e-30f));
      }
    }
  }
}

template <typename Q, typename KV, bool QUANT>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* pos, const int* t, const int* table,
           void* out, int B, int C, int H, int Hkv, int hd, int bl, int T,
           int window, float scale, int cdt, cudaStream_t stream) {
  const int R = C * (H / Hkv);
  const int rt = R < RT ? R : RT;
  const size_t smem = smem_bytes(rt, bl, hd);
  cudaError_t err = cudaFuncSetAttribute(
      gqa_paged_kernel<Q, KV, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + rt - 1) / rt, Hkv, B);
  gqa_paged_kernel<Q, KV, QUANT><<<grid, NT, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, pos, t, table, static_cast<Q*>(out),
      C, H, Hkv, hd, bl, T, window, scale, cdt, rt);
  return (int)cudaGetLastError();
}

template <typename Q>
int launch_kv(int kv_dtype, const void* q, const void* k, const void* v,
              const float* ks, const float* vs, const int* pos, const int* t,
              const int* table, void* out, int B, int C, int H, int Hkv,
              int hd, int bl, int T, int window, float scale,
              cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch<Q, float, false>(q, k, v, ks, vs, pos, t, table, out, B,
                                     C, H, Hkv, hd, bl, T, window, scale, 0,
                                     s);
    case 1:
      return launch<Q, __nv_bfloat16, false>(q, k, v, ks, vs, pos, t, table,
                                             out, B, C, H, Hkv, hd, bl, T,
                                             window, scale, 1, s);
    case 2:
      return launch<Q, __nv_fp8_e4m3, false>(q, k, v, ks, vs, pos, t, table,
                                             out, B, C, H, Hkv, hd, bl, T,
                                             window, scale, 1, s);
    case 3:
      return launch<Q, int8_t, true>(q, k, v, ks, vs, pos, t, table, out, B,
                                     C, H, Hkv, hd, bl, T, window, scale, 1,
                                     s);
    case 4:
      return launch<Q, __half, false>(q, k, v, ks, vs, pos, t, table, out, B,
                                      C, H, Hkv, hd, bl, T, window, scale, 2,
                                      s);
  }
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// The tensor-core kernel (the C == 1 decode and C > 1 chunks; bf16
// compute over bf16, fp8 e4m3 and int8 arenas, fp16 compute over fp16
// arenas). A warp owns one 16-row tile of the R = C * group query rows
// (at C == 1, the group rows of one KV head, padded to 16) and walks its
// share of the row's cached positions in steps of 16 with
// mma.sync.m16n8k16 (bf16 or fp16 in, fp32 accumulate):
//
//   * q is rounded to the compute dtype once and held as the A fragments
//     of Q.K^T; K comes from shared memory by ldmatrix, V by
//     ldmatrix.trans (16-bit elements either way), and the score
//     fragment, rounded to the compute dtype, is PV's A fragment in
//     registers (the reference rounds p to the compute dtype too), so the
//     tensor cores compute exactly the reference's products; l sums the
//     unrounded p;
//   * a step's 16 positions are 16 logical positions of the row's table
//     (one block at block_len 16, several at smaller block_len, part of
//     one at larger); positions of a -1 entry are masked and not read,
//     and a step with no assigned block is skipped;
//   * split KV walk: the CTA (b, KV head, row tile, split) takes a
//     contiguous range of steps; its 4 warps take every 4th step, each
//     with its own (m, l, acc) and a cp.async ring of 16-byte copies
//     (1-byte arenas land raw and are converted to bf16 in shared
//     memory: int8 as fp32 value * scale, then bf16).
//     chunk_split_plan (paged_attention.py) keeps a short table in one
//     CTA a row tile with all its copies in flight (a ring of up to 4)
//     and splits a long one across CTAs (a ring of 2) to fill the card;
//   * the warps' partials combine through shared memory weighted by
//     exp(m_i - M) (a share whose positions were all masked has m =
//     -1e30 and weight 0); with more than one split per row tile the
//     CTAs' fp32 partials go to a workspace that gqa_chunk_combine
//     reduces the same way, in the same launch call;
//   * the table entries and positions of the CTA's steps are read once,
//     into shared memory, before the walk.

constexpr int TC_WARPS = 4;
constexpr int TC_MAX_STAGES = 4;      // cp.async ring depth a warp (at most)
constexpr int TC_STEP = 16;           // positions per mma step
constexpr int TC_MAX_STEPS = 64;      // steps per CTA (positions staged)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// lo, hi rounded to the compute dtype (fp16 when F16, else bf16), packed
template <bool F16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return F16 ? pack_f16(lo, hi) : pack_bf16(lo, hi);
}
// q[d], q[d + 1] (d even) rounded to the compute dtype and packed, in one
// load (a bf16 q into bf16 compute is taken as it is)
template <bool F16>
__device__ __forceinline__ uint32_t q_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return pack2<F16>(v.x, v.y);
}
template <bool F16>
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* p) {
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
  if (!F16) return raw;
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&raw);
  return pack_f16(__low2float(v), __high2float(v));
}
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a (16x16, row) . b (16x8, col), bf16 (or, F16, fp16) in, fp32
// accumulate
template <bool F16>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1) {
  if (F16)
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
  else
    asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                 "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                 : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0),
                   "r"(b1));
}

// Shared memory of one warp: `stages` stages, then (1-byte arenas) the
// bf16 tiles they convert into. A bf16 stage is K and V as bf16 (16,
// hd + 8); a 1-byte stage is raw K and V (16, hd) and their 16 + 16
// fp32 scales. The + 8 pad keeps ldmatrix's 8 row reads on distinct
// banks.
__host__ __device__ inline size_t tc_tile_bytes(int hd) {
  return (size_t)TC_STEP * (hd + 8) * 2;
}
__host__ __device__ inline size_t tc_stage_bytes(int hd, int kv_size) {
  return kv_size == 2 ? 2 * tc_tile_bytes(hd)
                      : 2 * (size_t)TC_STEP * hd + 2 * TC_STEP * 4;
}
__host__ __device__ inline size_t tc_warp_bytes(int hd, int kv_size,
                                                int stages) {
  return stages * tc_stage_bytes(hd, kv_size) +
         (kv_size == 2 ? 0 : 2 * tc_tile_bytes(hd));
}
// warps' regions (reused for the combine: (warps, 16, hd + 8) fp32),
// then m and l (warps, 16, 2), the combine weights (warps, 16) and the
// combined M and L (16 each), fp32, then row offsets and positions of
// the CTA's steps (int32 each)
__host__ __device__ inline size_t tc_front_bytes(int hd, int kv_size,
                                                 int stages) {
  const size_t w = TC_WARPS * tc_warp_bytes(hd, kv_size, stages);
  const size_t c = (size_t)TC_WARPS * TC_STEP * (hd + 8) * 4;
  return w > c ? w : c;
}
// m, l (warps, 16, 2), weights (warps, 16), M and L (16 each), then the
// 16 output row offsets (int64, as 32 floats' room)
constexpr int TC_ML_FLOATS = TC_WARPS * TC_STEP * 3 + 4 * TC_STEP;
size_t tc_smem_bytes(int hd, int kv_size, int steps_per_split, int stages) {
  return tc_front_bytes(hd, kv_size, stages) + TC_ML_FLOATS * 4 +
         (size_t)steps_per_split * TC_STEP * 2 * 4;
}

template <typename Q, typename KV, bool QUANT, int HDMAX>
__global__ void __launch_bounds__(TC_WARPS * 32)
gqa_chunk_tc_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v, const float* __restrict__ ks,
                    const float* __restrict__ vs, const int* __restrict__ pos,
                    const int* __restrict__ t, const int* __restrict__ table,
                    Q* __restrict__ out, float* __restrict__ ws, int C,
                    int H, int Hkv, int hd, int bl, int T, int window,
                    float scale, int splits, int per, int stages) {
  constexpr int KB = HDMAX / 16;       // 16-wide k chunks of q . k
  constexpr int NB = HDMAX / 8;        // n8 tiles of the output
  constexpr int KVS = (int)sizeof(KV);
  constexpr bool F16 = std::is_same<KV, __half>::value;   // fp16 compute
  extern __shared__ __align__(16) unsigned char tsm[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = H / Hkv, R = C * group;
  const int row_tiles = (R + 15) / 16;
  const int rt = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = rt * 16;
  const int Ltot = T * bl;
  const int n_steps = (Ltot + TC_STEP - 1) / TC_STEP;
  const int s_begin = sp * per;
  const int s_cnt = max(0, min(n_steps, s_begin + per) - s_begin);
  const int hdp = hd + 8;

  const size_t wbytes = tc_warp_bytes(hd, KVS, stages);
  float* sml = reinterpret_cast<float*>(tsm + tc_front_bytes(hd, KVS, stages));
  int* srow = reinterpret_cast<int*>(sml + TC_ML_FLOATS);
  int* spos = srow + (size_t)per * TC_STEP;

  // the CTA's table entries and positions, read once: the arena row of
  // each logical position (-1 where its entry is unassigned or past the
  // table) and its cached position (-1, never valid, where unassigned);
  // every load of a thread is issued before the first is used
  constexpr int PER_THREAD = TC_MAX_STEPS * TC_STEP / (TC_WARPS * 32);
  {
    int blk[PER_THREAD], cached[PER_THREAD];
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = threadIdx.x + j * TC_WARPS * 32;
      const int L = s_begin * TC_STEP + i;
      blk[j] = -1;
      cached[j] = -1;
      if (i < s_cnt * TC_STEP && L < Ltot) {
        blk[j] = table[(size_t)b * T + L / bl];
        cached[j] = pos[(size_t)b * Ltot + L];
      }
    }
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int i = threadIdx.x + j * TC_WARPS * 32;
      const int L = s_begin * TC_STEP + i;
      if (i < s_cnt * TC_STEP) {
        srow[i] = blk[j] >= 0 ? (blk[j] * bl + L % bl) * Hkv + h : -1;
        spos[i] = blk[j] >= 0 ? cached[j] : -1;
      }
    }
  }

  // q rows r0 + qr and r0 + qr + 8 as A fragments, rounded to the
  // compute dtype
  const int qr = lane >> 2, qc = (lane & 3) * 2;
  const int ra = r0 + qr, rb = r0 + qr + 8;
  const Q* qa_row = nullptr;
  const Q* qb_row = nullptr;
  int tqa = -1, tqb = -1;
  if (ra < R) {
    qa_row = q + (((size_t)b * C + ra / group) * H + h * group + ra % group) *
                     hd;
    tqa = t[(size_t)b * C + ra / group];
  }
  if (rb < R) {
    qb_row = q + (((size_t)b * C + rb / group) * H + h * group + rb % group) *
                     hd;
    tqb = t[(size_t)b * C + rb / group];
  }
  uint32_t qf[KB][4];
#pragma unroll
  for (int kk = 0; kk < KB; ++kk) {
    const int d0 = kk * 16 + qc;
    const bool in = kk * 16 < hd;
    qf[kk][0] = in && qa_row ? q_pair<F16>(qa_row + d0) : 0u;
    qf[kk][1] = in && qb_row ? q_pair<F16>(qb_row + d0) : 0u;
    qf[kk][2] = in && qa_row ? q_pair<F16>(qa_row + d0 + 8) : 0u;
    qf[kk][3] = in && qb_row ? q_pair<F16>(qb_row + d0 + 8) : 0u;
  }
  __syncthreads();               // srow / spos staged

  unsigned char* wb = tsm + warp * wbytes;
  const int nmine = warp < s_cnt ? (s_cnt - warp + TC_WARPS - 1) / TC_WARPS
                                 : 0;
  // local step index of this warp's i-th step
  auto local = [&](int i) { return warp + i * TC_WARPS; };
  // a step's copies: 16 rows of cpr 16-byte chunks (cpr <= 32); lane
  // takes chunk lc of row lr + rpi * j, with no division in the loop
  const int cpr = hd * KVS / 16, rpi = 32 / cpr;
  const int lr = lane / cpr, lc = lane % cpr;
  auto live = [&](int i) {
    const int r = lane < TC_STEP ? srow[local(i) * TC_STEP + lane] : -1;
    return __any_sync(0xffffffffu, r >= 0);
  };
  auto issue = [&](int i) {
    if (i >= nmine || !live(i)) return;
    unsigned char* st = wb + (i % stages) * tc_stage_bytes(hd, KVS);
    const int* rows = srow + local(i) * TC_STEP;
    const size_t vdst = KVS == 2 ? tc_tile_bytes(hd) : (size_t)TC_STEP * hd;
    if (lr < rpi) {
      for (int p = lr; p < TC_STEP; p += rpi) {
        const int row = rows[p];
        const size_t src = (size_t)(row < 0 ? 0 : row) * hd * KVS + lc * 16;
        const size_t dst = KVS == 2 ? (size_t)p * hdp * 2 + lc * 16
                                    : (size_t)p * hd + lc * 16;
        const int n = row < 0 ? 0 : 16;
        cp_async16(smem_u32(st + dst),
                   reinterpret_cast<const unsigned char*>(k) + src, n);
        cp_async16(smem_u32(st + vdst + dst),
                   reinterpret_cast<const unsigned char*>(v) + src, n);
      }
    }
    if (QUANT && lane < TC_STEP) {
      const int row = rows[lane];
      float* sc = reinterpret_cast<float*>(st + 2 * (size_t)TC_STEP * hd);
      const int n = row < 0 ? 0 : 4;
      cp_async4(smem_u32(sc + lane), ks + (row < 0 ? 0 : row), n);
      cp_async4(smem_u32(sc + TC_STEP + lane), vs + (row < 0 ? 0 : row), n);
    }
  };

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  // a ring of `stages`: the first stages - 1 steps' copies in flight
  // before the walk, one more issued as each step starts
  for (int i = 0; i + 1 < stages; ++i) {
    issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < nmine; ++i) {
    issue(i + stages - 1);
    cp_async_commit();
    switch (stages) {              // step i's group done; later ones may fly
      case 1: cp_async_wait<0>(); break;
      case 2: cp_async_wait<1>(); break;
      case 3: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __syncwarp();
    if (!live(i)) continue;
    unsigned char* st = wb + (i % stages) * tc_stage_bytes(hd, KVS);
    // 16-bit tiles (bf16, or fp16 when F16): only their addresses are used
    const __nv_bfloat16* kt;
    const __nv_bfloat16* vt;
    if (KVS == 2) {
      kt = reinterpret_cast<const __nv_bfloat16*>(st);
      vt = reinterpret_cast<const __nv_bfloat16*>(st + tc_tile_bytes(hd));
    } else {
      // 1-byte arena: raw stage -> bf16 tiles (int8: fp32 value * scale,
      // then bf16, as dequantize_kv; fp8: exact)
      __nv_bfloat16* kc = reinterpret_cast<__nv_bfloat16*>(
          wb + stages * tc_stage_bytes(hd, KVS));
      __nv_bfloat16* vc = kc + TC_STEP * hdp;
      const KV* rk = reinterpret_cast<const KV*>(st);
      const KV* rv = rk + TC_STEP * hd;
      const float* sc = reinterpret_cast<const float*>(
          st + 2 * (size_t)TC_STEP * hd);
      for (int p = 0; p < TC_STEP; ++p)
        for (int d = lane * 2; d < hd; d += 64) {
          const int e = p * hd + d;
          float k0 = to_f(rk[e]), k1 = to_f(rk[e + 1]);
          float v0 = to_f(rv[e]), v1 = to_f(rv[e + 1]);
          if (QUANT) {
            k0 *= sc[p]; k1 *= sc[p];
            v0 *= sc[TC_STEP + p]; v1 *= sc[TC_STEP + p];
          }
          *reinterpret_cast<uint32_t*>(kc + p * hdp + d) = pack_bf16(k0, k1);
          *reinterpret_cast<uint32_t*>(vc + p * hdp + d) = pack_bf16(v0, v1);
        }
      __syncwarp();
      kt = kc;
      vt = vc;
    }

    // S = Q . K^T over the 16 positions (two n8 tiles)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int mi = lane >> 3;
      const uint32_t kaddr = smem_u32(
          kt + (8 * (mi >> 1) + (lane & 7)) * hdp + 8 * (mi & 1));
#pragma unroll
      for (int kk = 0; kk < KB; ++kk) {
        if (kk * 16 < hd) {
          uint32_t bk[4];
          ldsm_x4(kaddr + kk * 32, bk);
          mma16<F16>(s[0], qf[kk], bk[0], bk[1]);
          mma16<F16>(s[1], qf[kk], bk[2], bk[3]);
        }
      }
    }
    // mask, online softmax (rows qr: e = 0, 1; qr + 8: e = 2, 3)
    const int* pp = spos + local(i) * TC_STEP;
    float mxa = NEG_INF, mxb = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cpos = pp[8 * nt + qc + (e & 1)];
        const int tq = e < 2 ? tqa : tqb;
        bool ok = cpos >= 0 && cpos <= tq;
        if (window > 0) ok = ok && cpos > tq - window;
        s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
        if (e < 2) mxa = fmaxf(mxa, s[nt][e]);
        else mxb = fmaxf(mxb, s[nt][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
      mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
    }
    const float mna = fmaxf(m0, mxa), mnb = fmaxf(m1, mxb);
    // __expf (ex2.approx, ~2^-21 relative): p is rounded to the compute
    // dtype next
    const float ca = __expf(m0 - mna), cb = __expf(m1 - mnb);
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = __expf(s[nt][e] - (e < 2 ? mna : mnb));
        if (e < 2) suma += s[nt][e];
        else sumb += s[nt][e];
      }
    l0 = l0 * ca + suma;
    l1 = l1 * cb + sumb;
    m0 = mna;
    m1 = mnb;
    uint32_t pf[4] = {pack2<F16>(s[0][0], s[0][1]),
                      pack2<F16>(s[0][2], s[0][3]),
                      pack2<F16>(s[1][0], s[1][1]),
                      pack2<F16>(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      o[j][0] *= ca; o[j][1] *= ca; o[j][2] *= cb; o[j][3] *= cb;
    }
    // O += P . V (V by ldmatrix.trans: 16 positions x 16 dims per x4)
    {
      const int mi = lane >> 3;
      const uint32_t vaddr = smem_u32(
          vt + (8 * (mi & 1) + (lane & 7)) * hdp + 8 * (mi >> 1));
#pragma unroll
      for (int np = 0; np < NB / 2; ++np) {
        if (np * 16 < hd) {
          uint32_t bv[4];
          ldsm_x4_t(vaddr + np * 32, bv);
          mma16<F16>(o[2 * np], pf, bv[0], bv[1]);
          mma16<F16>(o[2 * np + 1], pf, bv[2], bv[3]);
        }
      }
    }
    __syncwarp();                // stage and tiles free for reuse
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();               // every warp done with its stages

  // combine the warps' partials: weights exp(m_w - M), computed once
  // per (warp, row); rows padded by 8 floats against bank conflicts
  const int ap = hd + 8;
  float* sacc = reinterpret_cast<float*>(tsm);          // (warps, 16, ap)
  if ((lane & 3) == 0) {
    sml[(warp * 16 + qr) * 2] = m0;
    sml[(warp * 16 + qr) * 2 + 1] = l0;
    sml[(warp * 16 + qr + 8) * 2] = m1;
    sml[(warp * 16 + qr + 8) * 2 + 1] = l1;
  }
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (j * 8 < hd) {
      float* ra_ = sacc + ((size_t)warp * 16 + qr) * ap + j * 8 + qc;
      float* rb_ = ra_ + 8 * ap;
      ra_[0] = o[j][0]; ra_[1] = o[j][1];
      rb_[0] = o[j][2]; rb_[1] = o[j][3];
    }
  }
  __syncthreads();
  float* swt = sml + TC_WARPS * TC_STEP * 2;   // (warps, 16) weights, then
  float* sL = swt + TC_WARPS * TC_STEP;        // (16) M, (16) L
  // output row offsets of the tile's 16 rows (-1: past R), once
  long long* sout = reinterpret_cast<long long*>(sL + 2 * TC_STEP);
  if (threadIdx.x < TC_STEP) {
    const int row = threadIdx.x, r = r0 + row;
    sout[row] = r < R ? (((long long)b * C + r / group) * H + h * group +
                         r % group) * hd
                      : -1;
    float M = NEG_INF, L = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) M = fmaxf(M, sml[(w * 16 + row) * 2]);
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) {
      const float wt = expf(sml[(w * 16 + row) * 2] - M);
      swt[w * 16 + row] = wt;
      L += wt * sml[(w * 16 + row) * 2 + 1];
    }
    sL[row] = M;
    sL[16 + row] = L;
  }
  __syncthreads();
  const size_t wsblk = (((size_t)b * Hkv + h) * row_tiles + rt) * splits + sp;
  for (int row = warp; row < TC_STEP; row += TC_WARPS) {   // no division
    const float M = sL[row], L = sL[16 + row];
    for (int d = lane; d < hd; d += 32) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < TC_WARPS; ++w)
        acc += swt[w * 16 + row] * sacc[((size_t)w * 16 + row) * ap + d];
      if (splits == 1) {
        if (sout[row] >= 0)
          store_f(out + sout[row] + d, acc / fmaxf(L, 1e-30f));
      } else {
        float* wsb = ws + wsblk * 16 * (hd + 2);
        wsb[row * hd + d] = acc;
        if (d == 0) {
          wsb[16 * hd + row] = M;
          wsb[16 * hd + 16 + row] = L;
        }
      }
    }
  }
}

// Combine the splits' partials of each (b, KV head, row tile): the same
// exp(m_s - M) weights, out = acc / max(l, 1e-30) in q's dtype. One
// block per query row and one thread per head dim, so every load of a
// thread is independent of the others (one memory round trip).
template <typename Q>
__global__ void __launch_bounds__(256)
gqa_chunk_combine(const float* __restrict__ ws, Q* __restrict__ out, int C,
                  int H, int Hkv, int hd, int splits) {
  const int group = H / Hkv, R = C * group;
  const int row_tiles = (R + 15) / 16;
  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  if (r >= R || d >= hd) return;
  const int rt = r / 16, row = r % 16;
  const size_t stride = (size_t)16 * (hd + 2);
  const float* wsb =
      ws + ((((size_t)b * Hkv + h) * row_tiles + rt) * splits) * stride;
  float M = NEG_INF;
  for (int s = 0; s < splits; ++s)
    M = fmaxf(M, wsb[s * stride + 16 * hd + row]);
  float acc = 0.f, L = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float wt = expf(wsb[s * stride + 16 * hd + row] - M);
    acc += wt * wsb[s * stride + row * hd + d];
    L += wt * wsb[s * stride + 16 * hd + 16 + row];
  }
  store_f(out + (((size_t)b * C + r / group) * H + h * group + r % group) *
                    hd + d,
          acc / fmaxf(L, 1e-30f));
}

template <typename Q, typename KV, bool QUANT, int HDMAX>
int launch_tc(const void* q, const void* k, const void* v, const float* ks,
              const float* vs, const int* pos, const int* t,
              const int* table, void* out, float* ws, int B, int C, int H,
              int Hkv, int hd, int bl, int T, int window, float scale,
              int splits, int per, int stages, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(hd, (int)sizeof(KV), per, stages);
  auto kern = gqa_chunk_tc_kernel<Q, KV, QUANT, HDMAX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int R = C * (H / Hkv), row_tiles = (R + 15) / 16;
  dim3 grid(row_tiles * splits, Hkv, B);
  kern<<<grid, TC_WARPS * 32, smem, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), ks, vs, pos, t, table, static_cast<Q*>(out),
      ws, C, H, Hkv, hd, bl, T, window, scale, splits, per, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  gqa_chunk_combine<Q><<<dim3(R, Hkv, B), hd, 0, stream>>>(
      ws, static_cast<Q*>(out), C, H, Hkv, hd, splits);
  return (int)cudaGetLastError();
}

template <typename Q, typename KV, bool QUANT>
int launch_tc_hd(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* pos,
                 const int* t, const int* table, void* out, float* ws, int B,
                 int C, int H, int Hkv, int hd, int bl, int T, int window,
                 float scale, int splits, int per, int stages,
                 cudaStream_t s) {
  if (hd <= 64)
    return launch_tc<Q, KV, QUANT, 64>(q, k, v, ks, vs, pos, t, table, out,
                                       ws, B, C, H, Hkv, hd, bl, T, window,
                                       scale, splits, per, stages, s);
  if (hd <= 128)
    return launch_tc<Q, KV, QUANT, 128>(q, k, v, ks, vs, pos, t, table, out,
                                        ws, B, C, H, Hkv, hd, bl, T, window,
                                        scale, splits, per, stages, s);
  return launch_tc<Q, KV, QUANT, 256>(q, k, v, ks, vs, pos, t, table, out,
                                      ws, B, C, H, Hkv, hd, bl, T, window,
                                      scale, splits, per, stages, s);
}

template <typename Q>
int launch_tc_kv(int kv_dtype, const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const int* pos,
                 const int* t, const int* table, void* out, float* ws, int B,
                 int C, int H, int Hkv, int hd, int bl, int T, int window,
                 float scale, int splits, int per, int stages,
                 cudaStream_t s) {
  switch (kv_dtype) {
    case 1:
      return launch_tc_hd<Q, __nv_bfloat16, false>(
          q, k, v, ks, vs, pos, t, table, out, ws, B, C, H, Hkv, hd, bl, T,
          window, scale, splits, per, stages, s);
    case 2:
      return launch_tc_hd<Q, __nv_fp8_e4m3, false>(
          q, k, v, ks, vs, pos, t, table, out, ws, B, C, H, Hkv, hd, bl, T,
          window, scale, splits, per, stages, s);
    case 3:
      return launch_tc_hd<Q, int8_t, true>(
          q, k, v, ks, vs, pos, t, table, out, ws, B, C, H, Hkv, hd, bl, T,
          window, scale, splits, per, stages, s);
    case 4:
      return launch_tc_hd<Q, __half, false>(
          q, k, v, ks, vs, pos, t, table, out, ws, B, C, H, Hkv, hd, bl, T,
          window, scale, splits, per, stages, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

size_t gqa_paged_smem_bytes(int rows, int bl, int hd) {
  return smem_bytes(rows < RT ? rows : RT, bl, hd);
}

int gqa_paged_max_head_dim() { return NT * MAXACC / RT; }

// q_dtype: 0 = fp32, 1 = bf16 (q and out); kv_dtype: 0 = fp32, 1 = bf16,
// 2 = fp8 e4m3, 3 = int8 (then ks/vs are the fp32 scale arenas), 4 = fp16
// (fp16 compute). Returns
// the cudaError_t of the launch (0 on success); launches on `stream` and
// does not synchronise.
int gqa_paged_launch(const void* q, const void* k, const void* v,
                     const void* ks, const void* vs, const void* pos,
                     const void* t, const void* table, void* out, int B,
                     int C, int H, int Hkv, int hd, int bl, int T,
                     int window, float scale, int q_dtype, int kv_dtype,
                     void* stream) {
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* p = static_cast<const int*>(pos);
  const int* tt = static_cast<const int*>(t);
  const int* tb = static_cast<const int*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv || hd > NT * MAXACC / RT)
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return launch_kv<float>(kv_dtype, q, k, v, ksf, vsf, p, tt, tb, out, B,
                            C, H, Hkv, hd, bl, T, window, scale, s);
  if (q_dtype == 1)
    return launch_kv<__nv_bfloat16>(kv_dtype, q, k, v, ksf, vsf, p, tt, tb,
                                    out, B, C, H, Hkv, hd, bl, T, window,
                                    scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core chunk kernel's shared memory for head dim `hd`, arena
// element size `kv_size` (2 or 1), `per` steps of 16 positions a CTA and
// a ring of `stages` a warp.
size_t gqa_paged_chunk_tc_smem_bytes(int hd, int kv_size, int per,
                                     int stages) {
  return tc_smem_bytes(hd, kv_size, per, stages);
}

int gqa_paged_chunk_tc_max_steps() { return TC_MAX_STEPS; }

// On tensor cores, any C (R = C * group rows in 16-row tiles): kv_dtype
// 1 = bf16, 2 = fp8 e4m3, 3 = int8 (bf16 compute), 4 = fp16 (fp16
// compute); hd a multiple of 16 up to 256; the split plan (splits CTAs
// of `per` steps for each row tile, a ring of `stages` copies a warp)
// from chunk_split_plan; ws: fp32
// workspace of B * Hkv * row_tiles * splits * 16 * (hd + 2) floats when
// splits > 1. Launches the kernel (and, for splits > 1, the combine) on
// `stream`; returns the cudaError_t (0 on success).
int gqa_paged_chunk_tc_launch(const void* q, const void* k, const void* v,
                              const void* ks, const void* vs,
                              const void* pos, const void* t,
                              const void* table, void* out, void* ws, int B,
                              int C, int H, int Hkv, int hd, int bl, int T,
                              int window, float scale, int q_dtype,
                              int kv_dtype, int splits, int per,
                              int stages, void* stream) {
  const float* ksf = static_cast<const float*>(ks);
  const float* vsf = static_cast<const float*>(vs);
  const int* p = static_cast<const int*>(pos);
  const int* tt = static_cast<const int*>(t);
  const int* tb = static_cast<const int*>(table);
  float* w = static_cast<float*>(ws);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv < 1 || H % Hkv || hd < 16 || hd > 256 || hd % 16 || splits < 1 ||
      per < 1 || per > TC_MAX_STEPS || stages < 1 ||
      stages > TC_MAX_STAGES || (splits > 1 && !w))
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return launch_tc_kv<float>(kv_dtype, q, k, v, ksf, vsf, p, tt, tb, out,
                               w, B, C, H, Hkv, hd, bl, T, window, scale,
                               splits, per, stages, s);
  if (q_dtype == 1)
    return launch_tc_kv<__nv_bfloat16>(kv_dtype, q, k, v, ksf, vsf, p, tt,
                                       tb, out, w, B, C, H, Hkv, hd, bl, T,
                                       window, scale, splits, per, stages, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
