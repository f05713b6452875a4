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
// them, so the KV walk is a loop inside one block:
//
//   * one thread block (256 threads) per (64 query rows, head, batch
//     row); it stages its q tile in shared memory once, then walks the
//     KV tiles of 64 keys, staging K, computing the 64 x 64 scores, the
//     row max and the probabilities, then staging V over K's buffer and
//     adding P.V into the accumulator;
//   * a thread owns 4 query rows x 4 keys of the scores (keys tx + 16j:
//     16-byte shared-memory reads without bank conflicts) and the same
//     4 rows x d/16 output dimensions; the 16 threads of a row reduce
//     its max and sum with shuffles; the accumulator lives in registers;
//   * the numbers are _flash_kernel's: q, k, v widened to fp32, fp32
//     dot products with the scale after the sum, masked scores the
//     finite -1e30, fp32 p (not rounded), l = l * corr + sum(p), out =
//     acc / max(l, 1e-30) rounded once to q's dtype;
//   * the ragged edge is masked here where the Pallas kernel asserts:
//     keys past Sk score -1e30 and read zeros, rows past Sq are not
//     written; when causal, KV tiles wholly above the diagonal are
//     skipped (flash_attention.py:56-58).
//
// What bounds it on an H100: the function must read q, k, v and write
// out once (42 MB in bf16 at qwen1.5-4b's 4 x 512-token prefill, 12.5 us
// at 3.35 TB/s) and do 4 * Sq * Sk * d flops per head (halved when
// causal: 5.4 GFLOP there, 5.4 us on bf16 tensor cores), so the bound is
// memory. This first kernel does every product as an fp32 FMA on the
// CUDA cores (67 TFLOP/s, not the tensor cores' 989), so the arithmetic
// bounds it far above that; QK and PV on tensor cores (mma/wgmma, bf16
// inputs, fp32 accumulation; P split into two bf16 terms to keep the
// reference's fp32 p) and pipelined tile loads are the next steps.

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
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
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

}  // namespace

extern "C" {

size_t flash_attention_smem_bytes(int d) { return smem_bytes(d); }

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
    return launch<__nv_bfloat16, 64>(q, k, v, out, B, Sq, Sk, H, Hkv, scale,
                                     causal, s);
  if (dtype == 1 && d == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, B, Sq, Sk, H, Hkv, scale,
                                      causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
