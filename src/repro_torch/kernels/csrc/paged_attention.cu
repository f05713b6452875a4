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
//     bf16 for 1-byte arenas (fp8, int8) and the arena's dtype
//     otherwise; q is rounded to it; int8 is dequantized as fp32
//     value * scale, then rounded to bf16; p is rounded to it before
//     the PV product; l sums the unrounded p; out = acc / max(l, 1e-30);
//   * masked scores are the reference's finite -1e30, so a tile with
//     every position masked gives exp(0) = 1: finite garbage that the
//     correction factor erases once a valid block arrives (-inf would
//     give NaN). Rows with no valid position at all (pad rows, t < 0)
//     are garbage, as in the reference.
//
// What bounds it on an H100: the function must read each valid block's
// K and V once (2 * block_len * Hkv * hd * bytes per block) plus q and
// out; its flops (4 * R * hd per cached position) are far below the
// tensor-core rate, so the bound is memory. This design issues one
// thread block per (b, h) -- 80 blocks for a qwen1.5-4b decode tick at
// 4 slots, fewer than the 132 SMs -- and walks the blocks serially with
// four barriers each, so it is latency-bound far above that bound;
// splitting the KV walk across blocks (a split-KV combine) is the
// next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <stdint.h>

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
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
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
                 int T, int window, float scale, int cdt_bf16, int rt) {
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
      if (cdt_bf16) val = bf16_round(val);
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
        ps[rr * bl + p] = cdt_bf16 ? bf16_round(e) : e;
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
           int window, float scale, int cdt_bf16, cudaStream_t stream) {
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
      C, H, Hkv, hd, bl, T, window, scale, cdt_bf16, rt);
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
// 2 = fp8 e4m3, 3 = int8 (then ks/vs are the fp32 scale arenas). Returns
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

}  // extern "C"
