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
// tick: one kernel, two counted wrappers.
//
// Replaces repro/kernels/paged_attention.py:mla_paged_p (C == 1) and
// mla_paged_chunk_p (C > 1) (Pallas, TPU). There the grid (B, T) walks
// the row's table entries in order, each step DMAs one arena block into
// VMEM, every head of the row (all C * H of them in the chunk kernel, a
// 4 MB accumulator at C = 16) shares that block, and the online-softmax
// state lives in VMEM scratch across grid steps. Here blocks run in
// parallel and carry nothing between them, so:
//
//   * one thread block per (batch row, tile of 8 query rows), one warp
//     per query row; the walk over the table is a loop inside the block,
//     which reads its own table row, skips -1 entries, and stages one
//     arena block (c, kr, converted to fp32 values of the compute dtype,
//     and the positions) in shared memory for its 8 rows, with 16-byte
//     loads several in flight per thread;
//   * a warp keeps its row's q_abs / q_rope, the running max m and sum l,
//     and the fp32 accumulator (kvr / 32 values a lane) in registers;
//     lane j owns 4 contiguous dims of each 128-wide group, read from
//     shared memory as one 16-byte vector; a score is the warp's sum of
//     the lanes' 20-long partial dot products (xor shuffles), so no
//     576-long dependent chain runs on one thread;
//   * the rounding mirrors _mla_kernel exactly: the compute dtype is the
//     arena's own (fp8 included) and bf16 for int8, whose rows are
//     dequantized as fp32 value * scale, then rounded to bf16; q_abs and
//     q_rope are rounded to it; the two dot products accumulate in fp32
//     (here as one sum over the lanes) and are scaled after; p is rounded
//     to the compute dtype before the PV product while l sums the
//     unrounded p; o = acc / max(l, 1e-30);
//   * masked scores are the reference's finite -1e30, so a block with
//     every position masked gives exp(0) = 1: finite garbage that the
//     correction factor erases once a valid block arrives. Rows with no
//     valid position (pad rows, t < 0) are garbage, as in the reference.
//
// What bounds it on an H100: the function must read each valid block's
// latent and rope rows once (block_len * (kvr + rope) * bytes) plus q and
// the fp32 o_lat; its flops (4 * R * (kvr + rope) per cached position,
// about 2 * R * kvr for PV) are far below the tensor cores' rate, so the
// bound is memory. This design re-stages each arena block for every tile
// of 8 rows (16 tiles at H = 128: L2 absorbs the repeats), runs the dots
// on CUDA cores, and walks the blocks serially with two barriers each; a
// decode at 4 slots issues 64 thread blocks for 132 SMs. Splitting the
// walk across blocks and the chunk's 2048 rows onto tensor cores are the
// next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

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

}  // extern "C"
