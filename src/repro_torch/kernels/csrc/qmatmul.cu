// Weight-only quantized matmul for Hopper: y = (x @ w_q) * scale.
//
//   y[m, n] = round_to_x_dtype((sum_k x[m, k] * w_q[k, n]) * scale[n])
//
// x is (M, K) fp32 or bf16; w_q is (K, N) int8 (bits = 8) or (ceil(K/2),
// N) int8 holding two sign-extended nibbles per byte (bits = 4: packed
// row r holds rows 2r in the low nibble and 2r + 1 in the high one; for
// an odd K the last high nibble is a zero pad row); scale is (N,) fp32.
// The weights are dequantized in registers, the sum is fp32, each
// column's scale is applied once after the K loop, and the output is
// rounded once to x's dtype.
//
// Replaces repro/kernels/qmatmul.py:qmatmul_p (Pallas, TPU), whose grid
// walks (M/128, N/128, K/128) tiles with an fp32 VMEM accumulator and
// the K steps in order. On the serving path M is small (4 rows on a
// decode tick, at most slots x prefill chunk on a mixed tick), so this
// is a weight-streaming skinny GEMM, not a tiled square GEMM:
//
//   * one thread block per (128-column tile of N, K split): K is split
//     across blocks so that even N = 2560 fills the card's 132 SMs; the
//     block stages its (K split x 128) weight tile in shared memory with
//     16-byte coalesced loads, once;
//   * the M rows of x are walked in passes of MT rows; each pass stages
//     those rows' K split in shared memory (as fp32) and 8 warps split
//     the split's weight rows, each lane owning 4 columns (one 32-bit
//     word of int8) and an fp32 accumulator per (row, column) in
//     registers; the warps' partial sums are added in a fixed order
//     through shared memory;
//   * with one split the block applies the scale and writes y; with
//     several, each writes fp32 partials to a workspace and a second,
//     elementwise kernel adds them in split order, scales and rounds --
//     no atomics, so the result does not change from run to run.
//
// What bounds it on an H100: at M = 4 the function reads K*N weight
// bytes (6.6 MB at 2560 x 2560, 389 MB for the 2560 x 151936 head) and
// does 2*M*K*N flops, so it is memory-bound by a factor of ~150; the
// least time is the weight bytes over 3.35 TB/s. This design keeps one
// pass over the weights at any M; what it lacks against the bound is
// deeper load pipelining (cp.async/TMA instead of loads staged through
// registers) and, at larger M, tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;            // columns per block: 32 lanes x 4
constexpr int NW = 8;              // warps per block, split the K rows
constexpr int NT = NW * 32;
constexpr int MT = 8;              // rows of x per pass

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory of one block: weight tile (kr or kr/2 rows of BN
// bytes), x tile (MT, kr) fp32, warp partials (NW, MT, BN) fp32.
size_t smem_bytes(int kr, int bits) {
  const size_t wrows = bits == 8 ? kr : kr / 2;
  return wrows * BN + sizeof(float) * ((size_t)MT * kr +
                                       (size_t)NW * MT * BN);
}

template <typename T, int BITS>
__global__ void __launch_bounds__(NT)
qmatmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
               const float* __restrict__ scale, T* __restrict__ out,
               float* __restrict__ part, int M, int N, int K, int kr,
               int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int wrows_max = BITS == 8 ? kr : kr / 2;
  uint32_t* ws = reinterpret_cast<uint32_t*>(smem);        // (rows, BN/4)
  float* xs = reinterpret_cast<float*>(smem + (size_t)wrows_max * BN);
  float* red = xs + (size_t)MT * kr;                       // (NW, MT, BN)

  const int split = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int k0 = split * kr;                   // kr is even: k0 too
  const int nk = min(K, k0 + kr) - k0;         // x columns of this split
  const int wrow0 = BITS == 8 ? k0 : k0 / 2;   // first stored weight row
  const int wrows = BITS == 8 ? nk : (nk + 1) / 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // ---- the block's weight tile, once ----
  if (vec) {                                   // N % 16 == 0, aligned
    for (int i = threadIdx.x; i < wrows * (BN / 16); i += NT) {
      const int r = i / (BN / 16), n = n0 + (i % (BN / 16)) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n < N)
        v = __ldg(reinterpret_cast<const uint4*>(
            w + (size_t)(wrow0 + r) * N + n));
      reinterpret_cast<uint4*>(ws)[i] = v;
    }
  } else {
    int8_t* wb = reinterpret_cast<int8_t*>(ws);
    for (int i = threadIdx.x; i < wrows * BN; i += NT) {
      const int r = i / BN, n = n0 + i % BN;
      wb[i] = n < N ? w[(size_t)(wrow0 + r) * N + n] : (int8_t)0;
    }
  }

  for (int m0 = 0; m0 < M; m0 += MT) {
    __syncthreads();                 // ws written / previous pass done
    for (int i = threadIdx.x; i < MT * kr; i += NT) {
      const int mm = i / kr, kk = i % kr;
      xs[i] = (m0 + mm < M && kk < nk)
                  ? load_f(x + (size_t)(m0 + mm) * K + k0 + kk) : 0.f;
    }
    __syncthreads();

    float acc[MT][4];
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mm][j] = 0.f;

    for (int r = warp; r < wrows; r += NW) {
      const uint32_t wv = ws[r * (BN / 4) + lane];
      if (BITS == 8) {
        float wf[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wf[j] = (float)(int8_t)((wv >> (8 * j)) & 0xFFu);
#pragma unroll
        for (int mm = 0; mm < MT; ++mm) {
          const float xv = xs[mm * kr + r];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[mm][j] = fmaf(xv, wf[j], acc[mm][j]);
        }
      } else {
        float lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t byte = (wv >> (8 * j)) & 0xFFu;
          lo[j] = (float)((int)(byte << 28) >> 28);   // sign-extended
          hi[j] = (float)((int)(byte << 24) >> 28);
        }
#pragma unroll
        for (int mm = 0; mm < MT; ++mm) {
          const float x0 = xs[mm * kr + 2 * r], x1 = xs[mm * kr + 2 * r + 1];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[mm][j] = fmaf(x1, hi[j], fmaf(x0, lo[j], acc[mm][j]));
        }
      }
    }

#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
      reinterpret_cast<float4*>(red + ((size_t)warp * MT + mm) * BN)[lane] =
          make_float4(acc[mm][0], acc[mm][1], acc[mm][2], acc[mm][3]);
    __syncthreads();
    for (int i = threadIdx.x; i < MT * BN; i += NT) {
      const int mm = i / BN, c = i % BN;
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < NW; ++q) s += red[((size_t)q * MT + mm) * BN + c];
      const int m = m0 + mm, n = n0 + c;
      if (m < M && n < N) {
        if (gridDim.y == 1)
          store_f(out + (size_t)m * N + n, s * scale[n]);
        else
          part[((size_t)split * M + m) * N + n] = s;
      }
    }
  }
}

template <typename T>
__global__ void qmatmul_finish(const float* __restrict__ part,
                               const float* __restrict__ scale,
                               T* __restrict__ out, int M, int N,
                               int splits) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t mn = (size_t)M * N;
  if (i >= mn) return;
  float s = 0.f;
  for (int q = 0; q < splits; ++q) s += part[q * mn + i];
  store_f(out + i, s * scale[i % N]);
}

template <typename T, int BITS>
int launch(const void* x, const int8_t* w, const float* scale, void* out,
           float* part, int M, int N, int K, int kr, int splits, int vec,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(kr, BITS);
  cudaError_t err = cudaFuncSetAttribute(
      qmatmul_kernel<T, BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + BN - 1) / BN, splits);
  qmatmul_kernel<T, BITS><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), w, scale, static_cast<T*>(out), part, M, N,
      K, kr, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t mn = (size_t)M * N;
  qmatmul_finish<T><<<(unsigned)((mn + 255) / 256), 256, 0, stream>>>(
      part, scale, static_cast<T*>(out), M, N, splits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t qmatmul_smem_bytes(int kr, int bits) { return smem_bytes(kr, bits); }

// dtype: 0 = fp32, 1 = bf16 (x and out); bits: 8 or 4. `kr` (even) is
// the x columns per K split and `splits` = ceil(K / kr); with more than
// one split `part` is an fp32 (splits, M, N) workspace. `vec` says that
// N % 16 == 0 and w is 16-byte aligned. Returns the cudaError_t of the
// launches (0 on success); launches on `stream` and does not synchronise.
int qmatmul_launch(const void* x, const void* w, const void* scale,
                   void* out, void* part, int M, int N, int K, int bits,
                   int kr, int splits, int vec, int dtype, void* stream) {
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  float* p = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kr < 2 || kr % 2 || splits < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && bits == 8)
    return launch<float, 8>(x, wq, s, out, p, M, N, K, kr, splits, vec, st);
  if (dtype == 0 && bits == 4)
    return launch<float, 4>(x, wq, s, out, p, M, N, K, kr, splits, vec, st);
  if (dtype == 1 && bits == 8)
    return launch<__nv_bfloat16, 8>(x, wq, s, out, p, M, N, K, kr, splits,
                                    vec, st);
  if (dtype == 1 && bits == 4)
    return launch<__nv_bfloat16, 4>(x, wq, s, out, p, M, N, K, kr, splits,
                                    vec, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
