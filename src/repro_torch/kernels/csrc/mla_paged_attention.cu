// Paged absorbed-MLA attention straight from the latent block arena, for
// Hopper.
//
// For query row r of batch row b at position tq (DeepSeek-V3's Multi-head
// Latent Attention in its absorbed form, every head reading one shared
// latent per cached position):
//
//   o_lat[r] = sum_p softmax_p(s[r, p]) c[p],
//   s[r, p]  = (q_abs[r] . c[p] + q_rope[r] . kr[p]) * scale
//
// over every cached position p of the row's blocks, masked to
// pos[p] >= 0 and pos[p] <= tq. q_abs is (B, C, H, kvr) and q_rope
// (B, C, H, rope) in fp32 or bf16 (both the same type); the arenas c
// (n_blocks, block_len, kvr) and kr (n_blocks, block_len, rope) are
// fp32, bf16, fp16, fp8 e4m3 or int8 (then with fp32 per-token scale
// arenas (n_blocks, block_len)); pos is (B, T * block_len) int32, t (B,
// C) int32 and the block table (B, T) int32 with -1 for an unassigned
// block. The C tokens and H heads of a row fold into R = C * H query
// rows, row c * H + h with position t[b, c]. Output o_lat (B, C, H, kvr)
// fp32. C == 1 is the decode tick, C > 1 the chunked prefill of a mixed
// tick: two counted wrappers over the same two kernels.
//
// Replaces repro/kernels/paged_attention.py:mla_paged_p (C == 1) and
// mla_paged_chunk_p (C > 1) (Pallas, TPU). There the grid (B, T) walks
// the row's table entries in order, each step DMAs one arena block into
// VMEM, every query row of the batch row (all C * H of them in the chunk
// kernel, a 4 MB accumulator at C = 16) shares that block, and the
// online-softmax state lives in VMEM scratch across grid steps. Both
// kernels here compute its numbers: the compute dtype cdt is the arena's
// own (fp8 included) and bf16 for int8, whose rows are dequantized as
// fp32 value * scale, then rounded to bf16; q_abs and q_rope are rounded
// to cdt; the products accumulate in fp32 and are scaled after; p is
// rounded to cdt before the PV product while l sums the unrounded p; o =
// acc / max(l, 1e-30); masked scores are the finite -1e30 (a row with no
// valid position, a pad row t < 0, is finite garbage, as there); a -1
// table entry leaves the state unchanged.
//
// What bounds it on an H100: its flops (2 * (2 kvr + rope) per query row
// and cached position, 2.8 GFLOP in deepseek-v3's C = 16 chunk over 160
// positions: 2.9 us on bf16 tensor cores) sit below its bytes. The chunk
// must read q (9.4 MB in bf16 at B = 4, C = 16, H = 128) and write the
// fp32 o_lat (16.8 MB) against 0.74 MB of latent: 8 us at 3.35 TB/s.
// The decode must read the latent, 1.2 KB per cached position in bf16
// (9.4 MB at 4 rows of 2048), beside 0.6 MB of q and 1 MB of o_lat.
//
// Two kernels, routed by the wrapper (paged_attention.py:mla_route):
//
// mla_tc_kernel, bf16, fp16, fp8 and int8 arenas at kvr a multiple of 64
// and rope a multiple of 16, kvr + rope <= 576 (every served arena); on
// the tensor cores with mma.sync.m16n8k16 (bf16 in, or fp16 for fp16
// arenas; fp32 accumulate). Because the reference rounds q and p to cdt
// itself, the tensor cores form its products exactly: fp8 values, and q
// and p rounded to e4m3, are exact in bf16. The design (the layout of
// DeepSeek's FlashMLA, sized for mma.sync):
//
//   * the latent is both K and V: one staged tile of 32 cached positions
//     holds each position's c and kr side by side (32 x (kvr + rope)
//     bf16, rows padded by 16 bytes for conflict-free ldmatrix), so a
//     score is one (kvr + rope)-deep product chain and the same tile is
//     P . V's operand. A step's 32 positions are 32 logical positions of
//     the row's table: two arena blocks at block_len 16, eight at 4,
//     half of one at 64; the CTA reads its table entries and positions
//     once, into shared memory, and gathers each position's rows with
//     16-byte cp.async copies into a 3- or 2-stage ring. Positions of a
//     -1 entry or past the table are zero-filled and masked, so a masked p
//     never multiplies unread memory; a step with no assigned position
//     is not loaded or computed. 1-byte arenas land raw (with the int8
//     scales) and one pass converts the tile to bf16;
//   * a row group of 16 query rows is 4 warps. The 128 KB fp32
//     accumulator of 64 rows x 512 latent columns cannot live in one
//     warp's registers, so warp w owns output columns [w kvr/4, (w+1)
//     kvr/4) (64 registers a thread) and the same slice of the score's
//     depth (its latent columns and every 4th 16-wide rope chunk). The
//     4 warps' partial scores meet in shared memory and each warp adds
//     them in the same order, so all 4 hold the same S, m, l and P
//     (rounded to cdt in registers, P . V's A fragment) with no second
//     exchange; q comes from a shared tile by ldmatrix each step;
//   * the online softmax updates once a step. fp8 arenas keep the
//     reference's walk instead, one update per arena block (block_len 16
//     or 32) and no split, and take p's exp from expf: p rounded to e4m3
//     (3 mantissa bits) depends on the running max it is taken against,
//     and an ulp of difference moves it by a whole e4m3 step now and
//     then (mla_split_plan's `exact`);
//   * a CTA is 2 or 4 row groups (32 or 64 query rows) sharing every
//     staged tile. The chunk (C = 16, R = 2048) is 32 row tiles of 64 x
//     4 batch rows = 128 CTAs, one wave, each walking the whole table:
//     its bound is q and o_lat, and a split would write and re-read
//     fp32 partials of o_lat's size, so it never splits (unless its
//     table outgrows the staged positions). The decode (R = 128) has 8
//     or 16 row tiles, so mla_split_plan (paged_attention.py) splits the
//     walk over up to 8 CTAs of one thread block cluster: each split's
//     (m, l, acc) go to its shared memory and the cluster's CTAs combine
//     interleaved rows through distributed shared memory, weighting
//     split s by exp(m_s - M) in split order (a split whose positions
//     are all masked has m = -1e30 and weighs 0). No workspace, no
//     second launch, no atomics: the sum is the same run to run;
//   * what holds it back (per-phase clock64 counts of a development
//     build): a step is a serial chain in each warp (issue the next
//     copies, ldmatrix and mma for S, the exchange and its barrier, the
//     softmax, ldmatrix and mma for P . c) through shared memory: every
//     warp re-reads its q, K and V fragments (K and V once per row
//     group of 16) and the exchange adds a third as much again, ~128 KB
//     per 16 rows and 32 positions. A step takes a little longer with
//     16 warps an SM than with 8, however many CTAs run, and one bulk
//     copy per cached row in place of the 16-byte cp.async copies
//     changed nothing. wgmma, reading K and V from shared memory once
//     per 64 rows, is the next step.
//
// mla_paged_kernel, fp32 arenas and widths the tensor-core kernel does
// not take; on the CUDA cores:
//
//   * one thread block per (batch row, tile of 8 query rows), one warp
//     per query row; the walk over the table is a loop inside the block,
//     which reads its own table row, skips -1 entries, and stages one
//     arena block (c, kr, converted to fp32 values of the compute dtype,
//     and the positions) in shared memory for its 8 rows;
//   * a warp keeps its row's q_abs / q_rope, the running max m and sum l,
//     and the fp32 accumulator (kvr / 32 values a lane) in registers;
//     a score is the warp's sum of the lanes' 20-long partial dot
//     products (xor shuffles);
//   * it re-stages each arena block for every tile of 8 rows (16 tiles at
//     H = 128), runs the dots on CUDA cores and walks the blocks serially
//     with two barriers each; it stays the route of fp32 arenas, as
//     every kernel of the port keeps its fp32 CUDA-core kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int NW = 8;              // warps per block = query rows per block
constexpr int NT = NW * 32;        // threads per block
constexpr int KVR_MAX = 512;       // latent width the registers hold
constexpr int ROPE_MAX = 128;      // rope width the registers hold
constexpr int GL = KVR_MAX / 128;  // latent float4 groups per lane
constexpr int GR = ROPE_MAX / 128; // rope float4 groups per lane
constexpr int PG = 8;              // positions scored per pass
constexpr int SU = 4;              // 16-byte staging loads in flight
constexpr int BL_MAX = 64;         // block_len: positions a lane owns <= 2
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Rounding to the compute dtype of an arena of type KV: the arena's own
// type for float arenas, bf16 for int8 (dequantized to bf16).
template <typename KV> struct Cdt;
template <> struct Cdt<float> {
  static __device__ __forceinline__ float round(float v) { return v; }
};
template <> struct Cdt<__nv_bfloat16> {
  static __device__ __forceinline__ float round(float v) {
    return bf16_round(v);
  }
};
template <> struct Cdt<__nv_fp8_e4m3> {
  static __device__ __forceinline__ float round(float v) {
    return static_cast<float>(__nv_fp8_e4m3(v));
  }
};
template <> struct Cdt<__half> {
  static __device__ __forceinline__ float round(float v) {
    return __half2float(__float2half_rn(v));
  }
};
template <> struct Cdt<int8_t> {
  static __device__ __forceinline__ float round(float v) {
    return bf16_round(v);
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Stages the n elements of one arena block (rows of `width`) into dst as
// fp32 values of the compute dtype (int8: fp32 value * its row's scale,
// rounded to bf16). Where rows are whole 16-byte vectors, each thread
// issues SU 16-byte loads before it converts any; otherwise one element
// a load.
template <typename KV, bool QUANT>
__device__ __forceinline__ void stage(const KV* __restrict__ src,
                                      const float* __restrict__ scale,
                                      float* __restrict__ dst, int n,
                                      int width) {
  constexpr int VEC = 16 / sizeof(KV);
  if (width % VEC == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const uint4* src4 = reinterpret_cast<const uint4*>(src);
    const int nv = n / VEC;
    for (int i0 = threadIdx.x; i0 < nv; i0 += NT * SU) {
      uint4 raw[SU];
      float sc[SU];
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int i = i0 + u * NT;
        if (i < nv) {
          raw[u] = src4[i];
          if (QUANT) sc[u] = scale[i * VEC / width];   // one row a vector
        }
      }
#pragma unroll
      for (int u = 0; u < SU; ++u) {
        const int i = i0 + u * NT;
        if (i < nv) {
          const KV* e = reinterpret_cast<const KV*>(&raw[u]);
          float4* d4 = reinterpret_cast<float4*>(dst + (size_t)i * VEC);
#pragma unroll
          for (int k = 0; k < VEC; k += 4) {
            float f[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              f[q] = to_f(e[k + q]);
              if (QUANT) f[q] = bf16_round(f[q] * sc[u]);
            }
            d4[k / 4] = make_float4(f[0], f[1], f[2], f[3]);
          }
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < n; i += NT) {
      float f = to_f(src[i]);
      if (QUANT) f = bf16_round(f * scale[i / width]);
      dst[i] = f;
    }
  }
}

// Staged rows of one arena block: a multiple of PG, so a scoring pass
// never reads past the buffer (rows past block_len are never used).
__host__ __device__ inline int staged_rows(int bl) {
  return (bl + PG - 1) / PG * PG;
}

// Shared memory of one block: c (rows, kvr), kr (rows, rope) and the
// per-warp scores (NW, bl) as fp32; the block's positions as int32.
size_t smem_bytes(int bl, int kvr, int rd) {
  return sizeof(float) * ((size_t)staged_rows(bl) * (kvr + rd) +
                          (size_t)NW * bl) +
         sizeof(int) * (size_t)bl;
}

// Lane `lane` owns dims 128 g + 4 lane .. + 3 of each 128-wide group g:
// shared-memory reads are 16-byte vectors, conflict-free across a warp.
template <typename Q, typename KV, bool QUANT>
__global__ void __launch_bounds__(NT)
mla_paged_kernel(const Q* __restrict__ qa, const Q* __restrict__ qr,
                 const KV* __restrict__ c, const KV* __restrict__ kr,
                 const float* __restrict__ cs, const float* __restrict__ krs,
                 const int* __restrict__ pos, const int* __restrict__ t,
                 const int* __restrict__ table, float* __restrict__ out,
                 int C, int H, int kvr, int rd, int bl, int T, float scale) {
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  const int rows = staged_rows(bl);
  float* c_s = sm;                              // (rows, kvr)
  float* kr_s = c_s + (size_t)rows * kvr;       // (rows, rd)
  float* sw_all = kr_s + (size_t)rows * rd;     // (NW, bl)
  int* pk = reinterpret_cast<int*>(sw_all + (size_t)NW * bl);   // (bl)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int R = C * H;
  const int r = blockIdx.x * NW + warp;
  const bool live = r < R;          // warp-uniform; idle warps still sync
  float* sw = sw_all + (size_t)warp * bl;

  // the warp's query row, rounded to the compute dtype
  float4 qa_r[GL], qr_r[GR], acc[GL];
#pragma unroll
  for (int g = 0; g < GL; ++g) {
    const int d = 128 * g + 4 * lane;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (live && d < kvr) {
      const Q* src = qa + ((size_t)b * R + r) * kvr + d;
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = Cdt<KV>::round(to_f(src[k]));
    }
    qa_r[g] = make_float4(f[0], f[1], f[2], f[3]);
    acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int g = 0; g < GR; ++g) {
    const int d = 128 * g + 4 * lane;
    float f[4] = {0.f, 0.f, 0.f, 0.f};
    if (live && d < rd) {
      const Q* src = qr + ((size_t)b * R + r) * rd + d;
#pragma unroll
      for (int k = 0; k < 4; ++k) f[k] = Cdt<KV>::round(to_f(src[k]));
    }
    qr_r[g] = make_float4(f[0], f[1], f[2], f[3]);
  }
  const int tq = live ? t[(size_t)b * C + r / H] : -1;
  float m_run = NEG_INF, l_run = 0.f;

  for (int jb = 0; jb < T; ++jb) {
    const int blk = table[(size_t)b * T + jb];   // same for every thread
    if (blk < 0) continue;                       // unassigned: skip
    __syncthreads();             // the previous block is consumed
    const size_t base = (size_t)blk * bl;
    for (int p = tid; p < bl; p += NT)
      pk[p] = pos[((size_t)b * T + jb) * bl + p];
    stage<KV, QUANT>(c + base * kvr, cs + (QUANT ? base : 0), c_s,
                     bl * kvr, kvr);
    stage<KV, QUANT>(kr + base * rd, krs + (QUANT ? base : 0), kr_s,
                     bl * rd, rd);
    __syncthreads();
    if (!live) continue;

    // scores, PG positions a pass: each lane's partial dot products over
    // its dims, summed over the warp
    for (int p0 = 0; p0 < bl; p0 += PG) {
      float part[PG];
#pragma unroll
      for (int j = 0; j < PG; ++j) part[j] = 0.f;
#pragma unroll
      for (int g = 0; g < GL; ++g) {
        const int d = 128 * g + 4 * lane;
        if (d < kvr) {
#pragma unroll
          for (int j = 0; j < PG; ++j)
            part[j] = dot4(qa_r[g], *reinterpret_cast<const float4*>(
                                        c_s + (p0 + j) * kvr + d),
                           part[j]);
        }
      }
#pragma unroll
      for (int g = 0; g < GR; ++g) {
        const int d = 128 * g + 4 * lane;
        if (d < rd) {
#pragma unroll
          for (int j = 0; j < PG; ++j)
            part[j] = dot4(qr_r[g], *reinterpret_cast<const float4*>(
                                        kr_s + (p0 + j) * rd + d),
                           part[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < PG; ++j) part[j] = warp_sum(part[j]);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < PG; ++j) {
          const int p = p0 + j;
          if (p < bl) {
            const int pp = pk[p];
            sw[p] = (pp >= 0 && pp <= tq) ? part[j] * scale : NEG_INF;
          }
        }
      }
    }
    __syncwarp();

    // online softmax over the block: lane j owns positions j, j + 32
    float s_own[BL_MAX / 32], m_blk = NEG_INF;
#pragma unroll
    for (int k = 0; k < BL_MAX / 32; ++k) {
      const int p = lane + 32 * k;
      s_own[k] = p < bl ? sw[p] : NEG_INF;
      m_blk = fmaxf(m_blk, s_own[k]);
    }
    const float m_new = fmaxf(m_run, warp_max(m_blk));
    float psum = 0.f;
#pragma unroll
    for (int k = 0; k < BL_MAX / 32; ++k) {
      const int p = lane + 32 * k;
      if (p < bl) {
        const float e = expf(s_own[k] - m_new);
        psum += e;
        sw[p] = Cdt<KV>::round(e);
      }
    }
    psum = warp_sum(psum);
    const float corr = expf(m_run - m_new);
    l_run = l_run * corr + psum;
    m_run = m_new;
    __syncwarp();

    float4 pv[GL];
#pragma unroll
    for (int g = 0; g < GL; ++g) pv[g] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int p = 0; p < bl; ++p) {
      const float pr = sw[p];
#pragma unroll
      for (int g = 0; g < GL; ++g) {
        const int d = 128 * g + 4 * lane;
        if (d < kvr) {
          const float4 cv =
              *reinterpret_cast<const float4*>(c_s + p * kvr + d);
          pv[g].x = fmaf(pr, cv.x, pv[g].x);
          pv[g].y = fmaf(pr, cv.y, pv[g].y);
          pv[g].z = fmaf(pr, cv.z, pv[g].z);
          pv[g].w = fmaf(pr, cv.w, pv[g].w);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GL; ++g) {
      acc[g].x = acc[g].x * corr + pv[g].x;
      acc[g].y = acc[g].y * corr + pv[g].y;
      acc[g].z = acc[g].z * corr + pv[g].z;
      acc[g].w = acc[g].w * corr + pv[g].w;
    }
  }

  if (!live) return;
  const float l_safe = fmaxf(l_run, 1e-30f);
#pragma unroll
  for (int g = 0; g < GL; ++g) {
    const int d = 128 * g + 4 * lane;
    if (d < kvr)
      *reinterpret_cast<float4*>(out + ((size_t)b * R + r) * kvr + d) =
          make_float4(acc[g].x / l_safe, acc[g].y / l_safe,
                      acc[g].z / l_safe, acc[g].w / l_safe);
  }
}

template <typename Q, typename KV, bool QUANT>
int launch(const void* qa, const void* qr, const void* c, const void* kr,
           const float* cs, const float* krs, const int* pos, const int* t,
           const int* table, float* out, int B, int C, int H, int kvr,
           int rd, int bl, int T, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes(bl, kvr, rd);
  cudaError_t err = cudaFuncSetAttribute(
      mla_paged_kernel<Q, KV, QUANT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((C * H + NW - 1) / NW, B);
  mla_paged_kernel<Q, KV, QUANT><<<grid, NT, smem, stream>>>(
      static_cast<const Q*>(qa), static_cast<const Q*>(qr),
      static_cast<const KV*>(c), static_cast<const KV*>(kr), cs, krs, pos, t,
      table, out, C, H, kvr, rd, bl, T, scale);
  return (int)cudaGetLastError();
}

template <typename Q>
int launch_kv(int kv_dtype, const void* qa, const void* qr, const void* c,
              const void* kr, const float* cs, const float* krs,
              const int* pos, const int* t, const int* table, float* out,
              int B, int C, int H, int kvr, int rd, int bl, int T,
              float scale, cudaStream_t s) {
  switch (kv_dtype) {
    case 0:
      return launch<Q, float, false>(qa, qr, c, kr, cs, krs, pos, t, table,
                                     out, B, C, H, kvr, rd, bl, T, scale, s);
    case 1:
      return launch<Q, __nv_bfloat16, false>(qa, qr, c, kr, cs, krs, pos, t,
                                             table, out, B, C, H, kvr, rd,
                                             bl, T, scale, s);
    case 2:
      return launch<Q, __nv_fp8_e4m3, false>(qa, qr, c, kr, cs, krs, pos, t,
                                             table, out, B, C, H, kvr, rd,
                                             bl, T, scale, s);
    case 3:
      return launch<Q, int8_t, true>(qa, qr, c, kr, cs, krs, pos, t, table,
                                     out, B, C, H, kvr, rd, bl, T, scale, s);
    case 4:
      return launch<Q, __half, false>(qa, qr, c, kr, cs, krs, pos, t, table,
                                      out, B, C, H, kvr, rd, bl, T, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The tensor-core kernel (the C == 1 decode and C > 1 chunks over bf16,
// fp16, fp8 and int8 arenas); its design is in the note at the top.

constexpr int TC_STEP = 32;        // cached positions per step
constexpr int TC_GW = 4;           // warps of a row group of 16 query rows
constexpr int TC_MAX_STEPS = 64;   // steps a CTA stages the rows of (2048)
constexpr int TC_MAX_SPLITS = 8;   // CTAs of a cluster (portable size)
constexpr int TC_NB = 16;          // n8 tiles of a warp's output (128 cols)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// two values already rounded to the compute dtype of an arena of type KV,
// packed as the mma's 16-bit inputs: fp16 for fp16 arenas, else bf16
// (exact for bf16- and e4m3-rounded values)
template <typename KV>
__device__ __forceinline__ uint32_t pack_in(float lo, float hi) {
  return std::is_same<KV, __half>::value ? pack_f16(lo, hi)
                                         : pack_bf16(lo, hi);
}
// p rounded to the compute dtype, packed (fp8: e4m3 first, then bf16)
template <typename KV>
__device__ __forceinline__ uint32_t pack_p(float lo, float hi) {
  if (std::is_same<KV, __nv_fp8_e4m3>::value)
    return pack_bf16(Cdt<KV>::round(lo), Cdt<KV>::round(hi));
  return pack_in<KV>(lo, hi);
}
// exp for p and the correction: __expf (ex2.approx, ~2^-21 relative)
// where p is rounded to bf16 or fp16 next; expf for fp8, whose 3-bit
// rounding of p turns any difference from the reference's exp into a
// whole e4m3 step now and then
template <typename KV>
__device__ __forceinline__ float exp_p(float x) {
  return std::is_same<KV, __nv_fp8_e4m3>::value ? expf(x) : __expf(x);
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
// the 4 warps of one row group (named barrier `id`, 128 threads)
__device__ __forceinline__ void group_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}
// d += a (16x16, row) . b (16x8, col): bf16 in (fp16 when F16), fp32
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
// 8 consecutive q values as fp32
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p,
                                      float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = __bfloat162float(e[k]);
}

// Shared memory of one CTA of G row groups (bytes). Front: the q tile
// (16 G, kvr + rope + 8) as 16-bit values; the ring of `stages` steps
// (16-bit arenas: the tile itself, 32 x (kvr + rope + 8); 1-byte arenas:
// 32 x (kvr + rope) raw bytes and 32 + 32 fp32 scales); for 1-byte
// arenas the converted tile. The combine of a split walk reuses the
// front for the fp32 accumulators (16 G, kvr + 8) and each row's (m, l).
// Then the warps' partial scores (4 G, 16, 32) fp32, then the row and
// cached position of each of the CTA's `per` steps' positions (int32).
__host__ __device__ inline size_t tc_tile_bytes(int kvr, int rd) {
  return (size_t)TC_STEP * (kvr + rd + 8) * 2;
}
__host__ __device__ inline size_t tc_stage_bytes(int kvr, int rd, int kvs) {
  return kvs == 2 ? tc_tile_bytes(kvr, rd)
                  : (size_t)TC_STEP * (kvr + rd) + 2 * TC_STEP * 4;
}
__host__ __device__ inline size_t tc_front_bytes(int g, int kvr, int rd,
                                                 int kvs, int stages) {
  const size_t walk = (size_t)16 * g * (kvr + rd + 8) * 2 +
                      stages * tc_stage_bytes(kvr, rd, kvs) +
                      (kvs == 1 ? tc_tile_bytes(kvr, rd) : 0);
  const size_t comb = (size_t)16 * g * ((kvr + 8) + 2) * 4;
  return walk > comb ? walk : comb;
}
size_t tc_smem_bytes(int g, int kvr, int rd, int kvs, int per, int stages) {
  return tc_front_bytes(g, kvr, rd, kvs, stages) +
         (size_t)g * TC_GW * 16 * TC_STEP * 4 + (size_t)per * TC_STEP * 8;
}

template <typename Q, typename KV, bool QUANT, int G>
__global__ void __launch_bounds__(G * TC_GW * 32, 1)
mla_tc_kernel(const Q* __restrict__ qa, const Q* __restrict__ qr,
              const KV* __restrict__ c, const KV* __restrict__ kr,
              const float* __restrict__ cs, const float* __restrict__ krs,
              const int* __restrict__ pos, const int* __restrict__ t,
              const int* __restrict__ table, float* __restrict__ out, int C,
              int H, int kvr, int rd, int bl, int T, float scale, int splits,
              int per, int stages, int sub) {
  constexpr int NT = G * TC_GW * 32;
  constexpr int RT = 16 * G;                 // query rows of the CTA
  constexpr int KVS = (int)sizeof(KV);
  constexpr bool F16 = std::is_same<KV, __half>::value;
  extern __shared__ __align__(16) unsigned char tsm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp / TC_GW, wq = warp % TC_GW;
  const int R = C * H;
  const int rtile = blockIdx.x / splits, sp = blockIdx.x % splits;
  const int b = blockIdx.y;
  const int r0 = rtile * RT;
  const int Ltot = T * bl;
  const int n_steps = (Ltot + TC_STEP - 1) / TC_STEP;
  const int s_begin = sp * per;
  const int s_cnt = max(0, min(n_steps, s_begin + per) - s_begin);
  const int ts = kvr + rd + 8;               // 16-bit tile row (elements)
  const int cw = kvr / TC_GW;                // latent columns of a warp
  const size_t stb = tc_stage_bytes(kvr, rd, KVS);
  uint16_t* q_s = reinterpret_cast<uint16_t*>(tsm);              // (RT, ts)
  unsigned char* ring = tsm + (size_t)RT * ts * 2;
  uint16_t* conv = reinterpret_cast<uint16_t*>(ring + stages * stb);
  float* xs = reinterpret_cast<float*>(
      tsm + tc_front_bytes(G, kvr, rd, KVS, stages));  // (4G, 16, 32)
  int* srow = reinterpret_cast<int*>(xs + G * TC_GW * 16 * TC_STEP);
  int* spos = srow + per * TC_STEP;

  // the CTA's table entries and positions, read once: the arena row of
  // each logical position (-1 where its entry is unassigned or past the
  // table) and its cached position (-1, never valid, where unassigned);
  // every load of a thread is issued before the first is used
  {
    constexpr int PT = TC_MAX_STEPS * TC_STEP / NT;
    int blk[PT], cached[PT];
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int i = tid + j * NT;
      const int L = s_begin * TC_STEP + i;
      blk[j] = -1;
      cached[j] = -1;
      if (i < s_cnt * TC_STEP && L < Ltot) {
        blk[j] = table[(size_t)b * T + L / bl];
        cached[j] = pos[(size_t)b * Ltot + L];
      }
    }
#pragma unroll
    for (int j = 0; j < PT; ++j) {
      const int i = tid + j * NT;
      const int L = s_begin * TC_STEP + i;
      if (i < s_cnt * TC_STEP) {
        srow[i] = blk[j] >= 0 ? blk[j] * bl + L % bl : -1;
        spos[i] = blk[j] >= 0 ? cached[j] : -1;
      }
    }
  }
  __syncthreads();

  // a step is live when any of its positions is assigned (the same
  // answer in every warp)
  auto live = [&](int i) {
    return __any_sync(0xffffffffu, srow[i * TC_STEP + lane] >= 0);
  };
  // step i's copies into its stage: 16-byte copies, a position's c then
  // kr, zero-filled where unassigned
  auto issue = [&](int i) {
    if (i >= s_cnt || !live(i)) return;
    unsigned char* st = ring + (i % stages) * stb;
    const int* rows = srow + i * TC_STEP;
    const int vb = 16 / KVS;                  // elements a copy
    const int cc = kvr / vb, cpr = cc + rd / vb;
    for (int x = tid; x < TC_STEP * cpr; x += NT) {
      const int p = x / cpr, ch = x - p * cpr;
      const int row = rows[p];
      const size_t r = row < 0 ? 0 : (size_t)row;
      const KV* src = ch < cc ? c + r * kvr + ch * vb
                              : kr + r * rd + (ch - cc) * vb;
      const size_t dst = KVS == 2 ? ((size_t)p * ts + ch * vb) * 2
                                  : (size_t)p * (kvr + rd) + ch * 16;
      cp_async16(smem_u32(st + dst), src, row < 0 ? 0 : 16);
    }
    if (QUANT && tid < 2 * TC_STEP) {
      const int row = rows[tid % TC_STEP];
      float* sc = reinterpret_cast<float*>(st + (size_t)TC_STEP * (kvr + rd));
      cp_async4(smem_u32(sc + tid),
                (tid < TC_STEP ? cs : krs) + (row < 0 ? 0 : row),
                row < 0 ? 0 : 4);
    }
  };
  // 1-byte arena: the raw stage -> the bf16 tile (int8: fp32 value *
  // scale, then bf16, as dequantize_kv; fp8: exact)
  auto convert = [&](const unsigned char* st) {
    const int cc = kvr / 16, cpr = cc + rd / 16;
    const float* sc = reinterpret_cast<const float*>(
        st + (size_t)TC_STEP * (kvr + rd));
    for (int x = tid; x < TC_STEP * cpr; x += NT) {
      const int p = x / cpr, ch = x - p * cpr;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          st + (size_t)p * (kvr + rd) + ch * 16);
      const KV* e = reinterpret_cast<const KV*>(&raw);
      const float f = QUANT ? sc[(ch < cc ? 0 : TC_STEP) + p] : 1.f;
      uint32_t w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float v0 = to_f(e[2 * k]), v1 = to_f(e[2 * k + 1]);
        if (QUANT) {
          v0 *= f;
          v1 *= f;
        }
        w[k] = pack_bf16(v0, v1);
      }
      uint4* d = reinterpret_cast<uint4*>(conv + (size_t)p * ts + ch * 16);
      d[0] = make_uint4(w[0], w[1], w[2], w[3]);
      d[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
  };

  // the ring's first copies in flight before the q tile is formed
  for (int i = 0; i + 1 < stages; ++i) {
    issue(i);
    cp_async_commit();
  }
  // the q tile, rounded to the compute dtype (rows past R zero); a row
  // is q_abs then q_rope. A thread's QU chunks of 8 values are loaded
  // before the first is converted: one memory round trip, not QU
  {
    constexpr int QU = 4;
    const int qc = kvr / 8, qcpr = qc + rd / 8;
    for (int x0 = tid; x0 < RT * qcpr; x0 += QU * NT) {
      float f[QU][8];
#pragma unroll
      for (int u = 0; u < QU; ++u) {
        const int x = x0 + u * NT;
        const int rl = x / qcpr, ch = x - rl * qcpr, r = r0 + rl;
#pragma unroll
        for (int k = 0; k < 8; ++k) f[u][k] = 0.f;
        if (x < RT * qcpr && r < R)
          load8(ch < qc ? qa + ((size_t)b * R + r) * kvr + ch * 8
                        : qr + ((size_t)b * R + r) * rd + (ch - qc) * 8,
                f[u]);
      }
#pragma unroll
      for (int u = 0; u < QU; ++u) {
        const int x = x0 + u * NT;
        const int rl = x / qcpr, ch = x - rl * qcpr;
        if (x < RT * qcpr) {
#pragma unroll
          for (int k = 0; k < 8; ++k) f[u][k] = Cdt<KV>::round(f[u][k]);
          *reinterpret_cast<uint4*>(q_s + (size_t)rl * ts + ch * 8) =
              make_uint4(pack_in<KV>(f[u][0], f[u][1]),
                         pack_in<KV>(f[u][2], f[u][3]),
                         pack_in<KV>(f[u][4], f[u][5]),
                         pack_in<KV>(f[u][6], f[u][7]));
        }
      }
    }
  }

  // this lane's rows (qrow and qrow + 8 of its group) and positions
  const int qrow = lane >> 2, qc2 = (lane & 3) * 2;
  const int ra = r0 + 16 * grp + qrow, rb = ra + 8;
  const int tqa = ra < R ? t[(size_t)b * C + ra / H] : -1;
  const int tqb = rb < R ? t[(size_t)b * C + rb / H] : -1;
  const int mi = lane >> 3;
  // ldmatrix row addresses: q (A: rows 8 (mi & 1) + lane % 8, k 8 (mi >>
  // 1)), K (B: positions 8 (mi >> 1) + lane % 8, k 8 (mi & 1)), V (B,
  // transposed: positions 8 (mi & 1) + lane % 8, columns 8 (mi >> 1))
  const uint32_t qaddr = smem_u32(
      q_s + (size_t)(16 * grp + 8 * (mi & 1) + (lane & 7)) * ts +
      8 * (mi >> 1));
  const int koff = (8 * (mi >> 1) + (lane & 7)) * ts + 8 * (mi & 1);
  const int voff = (8 * (mi & 1) + (lane & 7)) * ts + wq * cw + 8 * (mi >> 1);
  float* xw = xs + (size_t)warp * 16 * TC_STEP;          // (16, 32) partial
  const float* xg = xs + (size_t)grp * TC_GW * 16 * TC_STEP;

  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float o[TC_NB][4];
#pragma unroll
  for (int j = 0; j < TC_NB; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int i = 0; i < s_cnt; ++i) {
    if (stages == 2) cp_async_wait<0>();   // step i's copies landed
    else cp_async_wait<1>();
    __syncthreads();     // ... for every thread; step i - 1 consumed
    issue(i + stages - 1);
    cp_async_commit();
    if (!live(i)) continue;
    const uint16_t* tile;
    if (KVS == 2) {
      tile = reinterpret_cast<const uint16_t*>(ring + (i % stages) * stb);
    } else {
      convert(ring + (i % stages) * stb);
      __syncthreads();
      tile = conv;
    }
    const uint32_t kaddr = smem_u32(tile + koff);

    // this warp's share of S = Q . [c | kr]^T over the step's 32
    // positions (four n8 tiles): its latent columns, every 4th rope chunk
    float s[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    auto chunk = [&](int col) {
      uint32_t a[4], b0[4], b1[4];
      ldsm_x4(qaddr + col * 2, a);
      ldsm_x4(kaddr + col * 2, b0);
      ldsm_x4(kaddr + (16 * ts + col) * 2, b1);
      mma16<F16>(s[0], a, b0[0], b0[1]);
      mma16<F16>(s[1], a, b0[2], b0[3]);
      mma16<F16>(s[2], a, b1[0], b1[1]);
      mma16<F16>(s[3], a, b1[2], b1[3]);
    };
#pragma unroll
    for (int kk = 0; kk < TC_NB / 2; ++kk)
      if (kk * 16 < cw) chunk(wq * cw + kk * 16);
    for (int j = wq; j < rd / 16; j += TC_GW) chunk(kvr + 16 * j);
    // the group's four partials, added in warp order by every warp
#pragma unroll
    for (int e = 0; e < 16; ++e) xw[e * 32 + lane] = s[e / 4][e % 4];
    group_sync(1 + grp);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float* x = xg + e * 32 + lane;
      s[e / 4][e % 4] = ((x[0] + x[512]) + x[1024]) + x[1536];
    }

    // mask (rows qrow: e = 0, 1; qrow + 8: e = 2, 3), then the online
    // softmax over n8 tiles [lo, hi): one update a step, or (sub == 16)
    // one a 16-position half, each followed by its P . c
    const int* pp = spos + i * TC_STEP;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cpos = pp[8 * n + qc2 + (e & 1)];
        const int tq = e < 2 ? tqa : tqb;
        s[n][e] = cpos >= 0 && cpos <= tq ? s[n][e] * scale : NEG_INF;
      }
    auto update = [&](int lo, int hi) {
      float mxa = NEG_INF, mxb = NEG_INF;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        if (n >= lo && n < hi) {
          mxa = fmaxf(mxa, fmaxf(s[n][0], s[n][1]));
          mxb = fmaxf(mxb, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mxa = fmaxf(mxa, __shfl_xor_sync(0xffffffffu, mxa, off));
        mxb = fmaxf(mxb, __shfl_xor_sync(0xffffffffu, mxb, off));
      }
      const float mna = fmaxf(m0, mxa), mnb = fmaxf(m1, mxb);
      const float ca = exp_p<KV>(m0 - mna), cb = exp_p<KV>(m1 - mnb);
      float suma = 0.f, sumb = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
        if (n >= lo && n < hi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[n][e] = exp_p<KV>(s[n][e] - (e < 2 ? mna : mnb));
            if (e < 2) suma += s[n][e];
            else sumb += s[n][e];
          }
        }
      l0 = l0 * ca + suma;
      l1 = l1 * cb + sumb;
      m0 = mna;
      m1 = mnb;
#pragma unroll
      for (int j = 0; j < TC_NB; ++j) {
        o[j][0] *= ca; o[j][1] *= ca; o[j][2] *= cb; o[j][3] *= cb;
      }
    };
    // O += P (rounded to cdt: the A fragment of positions 16 kc .. + 15)
    // . c over this warp's columns (c by ldmatrix.trans)
    const uint32_t vaddr = smem_u32(tile + voff);
    auto pv = [&](int kc) {
      const uint32_t pf[4] = {pack_p<KV>(s[2 * kc][0], s[2 * kc][1]),
                              pack_p<KV>(s[2 * kc][2], s[2 * kc][3]),
                              pack_p<KV>(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_p<KV>(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < TC_NB / 2; ++np) {
        if (np * 16 < cw) {
          uint32_t bv[4];
          ldsm_x4_t(vaddr + (kc * 16 * ts + np * 16) * 2, bv);
          mma16<F16>(o[2 * np], pf, bv[0], bv[1]);
          mma16<F16>(o[2 * np + 1], pf, bv[2], bv[3]);
        }
      }
    };
    if (sub == TC_STEP) {
      update(0, 4);
      pv(0);
      pv(1);
    } else {
      update(0, 2);
      pv(0);
      update(2, 4);
      pv(1);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  if (splits == 1) {            // straight from registers
    const float la = fmaxf(l0, 1e-30f), lb = fmaxf(l1, 1e-30f);
#pragma unroll
    for (int j = 0; j < TC_NB; ++j) {
      if (j * 8 < cw) {
        const int col = wq * cw + j * 8 + qc2;
        if (ra < R)
          *reinterpret_cast<float2*>(out + ((size_t)b * R + ra) * kvr + col) =
              make_float2(o[j][0] / la, o[j][1] / la);
        if (rb < R)
          *reinterpret_cast<float2*>(out + ((size_t)b * R + rb) * kvr + col) =
              make_float2(o[j][2] / lb, o[j][3] / lb);
      }
    }
    return;
  }

  // split walk: (m, l, acc) of every row into shared memory, then the
  // cluster's CTAs take interleaved rows and add the splits' partials,
  // weighted by exp(m_s - M), in split order through distributed shared
  // memory
  __syncthreads();              // every warp done with the q tile and ring
  const int as = kvr + 8;       // accumulator row (floats)
  float* accs = reinterpret_cast<float*>(tsm);           // (RT, as)
  float* mls = accs + (size_t)RT * as;                   // (RT, 2)
  const int wa = 16 * grp + qrow, wb = wa + 8;
#pragma unroll
  for (int j = 0; j < TC_NB; ++j) {
    if (j * 8 < cw) {
      const int col = wq * cw + j * 8 + qc2;
      *reinterpret_cast<float2*>(accs + (size_t)wa * as + col) =
          make_float2(o[j][0], o[j][1]);
      *reinterpret_cast<float2*>(accs + (size_t)wb * as + col) =
          make_float2(o[j][2], o[j][3]);
    }
  }
  if (wq == 0 && (lane & 3) == 0) {
    mls[wa * 2] = m0;
    mls[wa * 2 + 1] = l0;
    mls[wb * 2] = m1;
    mls[wb * 2 + 1] = l1;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();               // every split's partials are written
  for (int rl = sp + splits * warp; rl < RT; rl += splits * (NT / 32)) {
    if (r0 + rl >= R) continue;
    // every split's (m, l) of the row, all loads in flight at once
    float2 ml[TC_MAX_SPLITS];
#pragma unroll
    for (int q = 0; q < TC_MAX_SPLITS; ++q)
      ml[q] = q < splits ? *reinterpret_cast<const float2*>(
                               cluster.map_shared_rank(mls, q) + rl * 2)
                         : make_float2(NEG_INF, 0.f);
    float M = NEG_INF;
#pragma unroll
    for (int q = 0; q < TC_MAX_SPLITS; ++q) M = fmaxf(M, ml[q].x);
    float w[TC_MAX_SPLITS], L = 0.f;
#pragma unroll
    for (int q = 0; q < TC_MAX_SPLITS; ++q) {
      w[q] = q < splits ? expf(ml[q].x - M) : 0.f;
      L += w[q] * ml[q].y;
    }
    const float ls = fmaxf(L, 1e-30f);
    for (int c4 = lane; c4 < kvr / 4; c4 += 32) {
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < TC_MAX_SPLITS; ++q) {
        if (q < splits) {
          const float4 v = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(accs, q) + (size_t)rl * as + 4 * c4);
          a.x += w[q] * v.x;
          a.y += w[q] * v.y;
          a.z += w[q] * v.z;
          a.w += w[q] * v.w;
        }
      }
      *reinterpret_cast<float4*>(out + ((size_t)b * R + r0 + rl) * kvr +
                                 4 * c4) =
          make_float4(a.x / ls, a.y / ls, a.z / ls, a.w / ls);
    }
  }
  cluster.sync();               // no CTA leaves while its partials are read
}

template <typename Q, typename KV, bool QUANT, int G>
int launch_tc(const void* qa, const void* qr, const void* c, const void* kr,
              const float* cs, const float* krs, const int* pos, const int* t,
              const int* table, float* out, int B, int C, int H, int kvr,
              int rd, int bl, int T, float scale, int splits, int per,
              int stages, int sub, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(G, kvr, rd, (int)sizeof(KV), per, stages);
  auto kern = mla_tc_kernel<Q, KV, QUANT, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = (C * H + 16 * G - 1) / (16 * G);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(row_tiles * splits, B, 1);
  cfg.blockDim = dim3(G * TC_GW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const Q*>(qa),
                           static_cast<const Q*>(qr),
                           static_cast<const KV*>(c),
                           static_cast<const KV*>(kr), cs, krs, pos, t, table,
                           out, C, H, kvr, rd, bl, T, scale, splits, per,
                           stages, sub);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename Q, typename KV, bool QUANT>
int launch_tc_g(int groups, const void* qa, const void* qr, const void* c,
                const void* kr, const float* cs, const float* krs,
                const int* pos, const int* t, const int* table, float* out,
                int B, int C, int H, int kvr, int rd, int bl, int T,
                float scale, int splits, int per, int stages,
                int sub, cudaStream_t s) {
  if (groups == 2)
    return launch_tc<Q, KV, QUANT, 2>(qa, qr, c, kr, cs, krs, pos, t, table,
                                      out, B, C, H, kvr, rd, bl, T, scale,
                                      splits, per, stages, sub, s);
  return launch_tc<Q, KV, QUANT, 4>(qa, qr, c, kr, cs, krs, pos, t, table,
                                    out, B, C, H, kvr, rd, bl, T, scale,
                                    splits, per, stages, sub, s);
}

template <typename Q>
int launch_tc_kv(int kv_dtype, int groups, const void* qa, const void* qr,
                 const void* c, const void* kr, const float* cs,
                 const float* krs, const int* pos, const int* t,
                 const int* table, float* out, int B, int C, int H, int kvr,
                 int rd, int bl, int T, float scale, int splits, int per,
                 int stages, int sub, cudaStream_t s) {
  switch (kv_dtype) {
    case 1:
      return launch_tc_g<Q, __nv_bfloat16, false>(
          groups, qa, qr, c, kr, cs, krs, pos, t, table, out, B, C, H, kvr,
          rd, bl, T, scale, splits, per, stages, sub, s);
    case 2:
      return launch_tc_g<Q, __nv_fp8_e4m3, false>(
          groups, qa, qr, c, kr, cs, krs, pos, t, table, out, B, C, H, kvr,
          rd, bl, T, scale, splits, per, stages, sub, s);
    case 3:
      return launch_tc_g<Q, int8_t, true>(
          groups, qa, qr, c, kr, cs, krs, pos, t, table, out, B, C, H, kvr,
          rd, bl, T, scale, splits, per, stages, sub, s);
    case 4:
      return launch_tc_g<Q, __half, false>(
          groups, qa, qr, c, kr, cs, krs, pos, t, table, out, B, C, H, kvr,
          rd, bl, T, scale, splits, per, stages, sub, s);
  }
  return (int)cudaErrorInvalidValue;
}


}  // namespace

extern "C" {

size_t mla_paged_smem_bytes(int bl, int kvr, int rd) {
  return smem_bytes(bl, kvr, rd);
}

// Largest latent width, rope width and block_len the kernel takes (the
// widths must also be multiples of 4).
int mla_paged_max_kvr() { return KVR_MAX; }
int mla_paged_max_rope() { return ROPE_MAX; }
int mla_paged_max_block_len() { return BL_MAX; }

// q_dtype: 0 = fp32, 1 = bf16 (q_abs and q_rope); kv_dtype: 0 = fp32,
// 1 = bf16, 2 = fp8 e4m3, 3 = int8 (then cs/krs are the fp32 scale
// arenas), 4 = fp16. out is fp32. Returns the cudaError_t of the launch (0 on
// success); launches on `stream` and does not synchronise.
int mla_paged_launch(const void* qa, const void* qr, const void* c,
                     const void* kr, const void* cs, const void* krs,
                     const void* pos, const void* t, const void* table,
                     void* out, int B, int C, int H, int kvr, int rd, int bl,
                     int T, float scale, int q_dtype, int kv_dtype,
                     void* stream) {
  const float* csf = static_cast<const float*>(cs);
  const float* krsf = static_cast<const float*>(krs);
  const int* p = static_cast<const int*>(pos);
  const int* tt = static_cast<const int*>(t);
  const int* tb = static_cast<const int*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kvr < 4 || kvr > KVR_MAX || kvr % 4 || rd < 0 || rd > ROPE_MAX ||
      rd % 4 || bl < 1 || bl > BL_MAX)
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return launch_kv<float>(kv_dtype, qa, qr, c, kr, csf, krsf, p, tt, tb, o,
                            B, C, H, kvr, rd, bl, T, scale, s);
  if (q_dtype == 1)
    return launch_kv<__nv_bfloat16>(kv_dtype, qa, qr, c, kr, csf, krsf, p,
                                    tt, tb, o, B, C, H, kvr, rd, bl, T,
                                    scale, s);
  return (int)cudaErrorInvalidValue;
}

size_t mla_paged_tc_smem_bytes(int groups, int kvr, int rd, int kv_size,
                               int per, int stages) {
  return tc_smem_bytes(groups, kvr, rd, kv_size, per, stages);
}

// The tensor-core kernel: kv_dtype 1 = bf16, 2 = fp8 e4m3, 3 = int8 (cs /
// krs the fp32 scale arenas), 4 = fp16; kvr a multiple of 64 up to 512,
// rd a multiple of 16 from 16 to 128 (the wrapper keeps kvr + rd <= 576,
// what shared memory holds); `groups` (2 or 4) row groups of 16
// query rows a CTA; the walk split over `splits` CTAs of one cluster
// (1..8), each taking `per` consecutive steps (1..64) through a ring of
// `stages` (2 or 3), with one online-softmax update every `sub` (16 or
// 32) positions. The rest as mla_paged_launch.
int mla_paged_tc_launch(const void* qa, const void* qr, const void* c,
                        const void* kr, const void* cs, const void* krs,
                        const void* pos, const void* t, const void* table,
                        void* out, int B, int C, int H, int kvr, int rd,
                        int bl, int T, float scale, int q_dtype, int kv_dtype,
                        int groups, int splits, int per, int stages, int sub,
                        void* stream) {
  const float* csf = static_cast<const float*>(cs);
  const float* krsf = static_cast<const float*>(krs);
  const int* p = static_cast<const int*>(pos);
  const int* tt = static_cast<const int*>(t);
  const int* tb = static_cast<const int*>(table);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kvr < 64 || kvr > KVR_MAX || kvr % 64 || rd < 16 || rd > ROPE_MAX ||
      rd % 16 || bl < 1 || (groups != 2 && groups != 4) || splits < 1 ||
      splits > TC_MAX_SPLITS || per < 1 || per > TC_MAX_STEPS ||
      (stages != 2 && stages != 3) || (sub != 16 && sub != TC_STEP) ||
      splits * per < (T * bl + TC_STEP - 1) / TC_STEP)
    return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return launch_tc_kv<float>(kv_dtype, groups, qa, qr, c, kr, csf, krsf, p,
                               tt, tb, o, B, C, H, kvr, rd, bl, T, scale,
                               splits, per, stages, sub, s);
  if (q_dtype == 1)
    return launch_tc_kv<__nv_bfloat16>(kv_dtype, groups, qa, qr, c, kr, csf,
                                       krsf, p, tt, tb, o, B, C, H, kvr, rd,
                                       bl, T, scale, splits, per, stages,
                                       sub, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
