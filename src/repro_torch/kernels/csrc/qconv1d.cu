// Fused quantized separable conv-1D block (RUBICALL's layer) for Hopper.
//
//   y[b, t, d] = act((sum_c acc[b, t, c] * pw_q[c, d]) * pw_s[d] * gamma[d]
//                    + beta[d]),
//   acc[b, t, c] = sum_i x[b, t + i, c] * dw_q[i, c] * dw_s[c]
//
// x is (B, T + k - 1, C), pre-padded with the (k - 1)-row halo; dw_q is
// (k, C) int8, pw_q (C, C) int8; dw_s, pw_s, gamma, beta are (C,) fp32
// (BatchNorm folded into gamma/beta); act is ReLU when `relu` is set.
// Output is (B, T, C) in x's dtype (fp32 or bf16); all math is fp32.
//
// Replaces repro/kernels/qconv1d.py:qconv1d_block_p (Pallas, TPU). That
// kernel keeps one whole (T + k - 1, C) chunk resident in VMEM per grid
// step. A RUBICALL serving window (2574 x 344) is ~3.5 MB in fp32,
// against 227 KB of shared memory per block here, so this kernel tiles
// time instead:
//
//   * one thread block per (batch row, tile of TT output frames);
//   * depthwise: the block walks C in slabs of CS channels, staging the
//     slab's TT + k - 1 input rows and its k dequantized taps in shared
//     memory, and accumulates the k-tap FMAs in fp32 on CUDA cores into a
//     shared acc (TT, C) tile;
//   * pointwise: acc @ pw_q with pw read as int8 from global memory (L2
//     resident: 344 x 344 bytes), the per-column scale pw_s applied once
//     after the C loop, then gamma, beta and the optional ReLU;
//   * ragged edges (C = 344 is not a multiple of 32; T is not a multiple
//     of TT) are masked on load and on store.
//
// What bounds it on an H100 (B=4, T=2500, C=344, k=75, bf16): the
// function moves ~14.1 MB (x read once, y written once; weights are
// negligible), ~4.2 us at 3.35 TB/s, and does 2.9 GFLOP, ~2.9 us on bf16
// tensor cores. So the card's bound is memory. This design runs every
// FLOP on fp32 CUDA cores (~43 us at 67 TFLOP/s), so it is bound by
// compute; moving the pointwise product to tensor cores (wgmma) and
// pipelining the x loads (TMA) is the work of a later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TT = 32;        // output frames per block
constexpr int CS = 32;        // channels per depthwise slab
constexpr int NT = 256;       // threads per block (8 warps)
constexpr int RPW = TT / (NT / 32);   // output rows per warp (4)
constexpr int CPT = 4;        // 32-column groups per pointwise pass

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(NT)
qconv1d_block_kernel(const T* __restrict__ x, const int8_t* __restrict__ dw,
                     const int8_t* __restrict__ pw,
                     const float* __restrict__ dw_s,
                     const float* __restrict__ pw_s,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ out,
                     int n_t, int C, int k, int relu) {
  extern __shared__ float smem[];
  const int rows = TT + k - 1;
  float* acc = smem;                   // (TT, C)
  float* xs = acc + TT * C;            // (rows, CS)
  float* ws = xs + rows * CS;          // (k, CS)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int n_tp = n_t + k - 1;
  const T* xb = x + (size_t)b * n_tp * C;

  // ---- depthwise: k-tap FMAs per channel slab into acc ----
  for (int c0 = 0; c0 < C; c0 += CS) {
    __syncthreads();                   // previous slab done with xs/ws
    for (int i = threadIdx.x; i < rows * CS; i += NT) {
      const int r = i / CS, c = c0 + i % CS, t = t0 + r;
      xs[i] = (c < C && t < n_tp) ? load_f(xb + (size_t)t * C + c) : 0.f;
    }
    for (int i = threadIdx.x; i < k * CS; i += NT) {
      const int tap = i / CS, c = c0 + i % CS;
      ws[i] = c < C ? (float)dw[tap * C + c] * dw_s[c] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < TT * CS; i += NT) {
      const int t = i / CS, cc = i % CS;
      float s = 0.f;
      for (int tap = 0; tap < k; ++tap)
        s = fmaf(xs[(t + tap) * CS + cc], ws[tap * CS + cc], s);
      if (c0 + cc < C) acc[t * C + c0 + cc] = s;
    }
  }
  __syncthreads();

  // ---- pointwise + folded BN + ReLU: warp w owns rows RPW*w.., lane
  // owns columns lane + 32*q of each 32*CPT-column pass ----
  const int lane = threadIdx.x % 32;
  const int r0 = (threadIdx.x / 32) * RPW;
  for (int d0 = 0; d0 < C; d0 += 32 * CPT) {
    float o[RPW][CPT];
#pragma unroll
    for (int j = 0; j < RPW; ++j)
#pragma unroll
      for (int q = 0; q < CPT; ++q) o[j][q] = 0.f;
    for (int c = 0; c < C; ++c) {
      float a[RPW];
#pragma unroll
      for (int j = 0; j < RPW; ++j) a[j] = acc[(r0 + j) * C + c];
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int d = d0 + 32 * q + lane;
        const float w = d < C ? (float)__ldg(pw + (size_t)c * C + d) : 0.f;
#pragma unroll
        for (int j = 0; j < RPW; ++j) o[j][q] = fmaf(a[j], w, o[j][q]);
      }
    }
#pragma unroll
    for (int q = 0; q < CPT; ++q) {
      const int d = d0 + 32 * q + lane;
      if (d >= C) continue;
      const float s = pw_s[d], g = gamma[d], bt = beta[d];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const int t = t0 + r0 + j;
        if (t >= n_t) continue;
        float y = o[j][q] * s * g + bt;
        if (relu) y = fmaxf(y, 0.f);
        store_f(out + ((size_t)b * n_t + t) * C + d, y);
      }
    }
  }
}

// Dynamic shared memory one block needs: acc (TT, C) + x slab
// (TT + k - 1, CS) + tap slab (k, CS), all fp32.
size_t smem_bytes(int C, int k) {
  return sizeof(float) * ((size_t)TT * C + (size_t)(TT + k - 1) * CS +
                          (size_t)k * CS);
}

template <typename T>
int launch(const void* x, const int8_t* dw, const int8_t* pw,
           const float* dw_s, const float* pw_s, const float* gamma,
           const float* beta, void* out, int B, int n_t, int C, int k,
           int relu, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, k);
  cudaError_t err = cudaFuncSetAttribute(
      qconv1d_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_t + TT - 1) / TT, B);
  qconv1d_block_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), dw, pw, dw_s, pw_s, gamma, beta,
      static_cast<T*>(out), n_t, C, k, relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t qconv1d_smem_bytes(int C, int k) { return smem_bytes(C, k); }

// dtype: 0 = fp32, 1 = bf16 (x and out). Returns the cudaError_t of the
// launch (0 on success). Launches on `stream`; does not synchronise.
int qconv1d_block_launch(const void* x, const void* dw, const void* pw,
                         const void* dw_s, const void* pw_s,
                         const void* gamma, const void* beta, void* out,
                         int B, int n_t, int C, int k, int relu, int dtype,
                         void* stream) {
  const int8_t* dwq = static_cast<const int8_t*>(dw);
  const int8_t* pwq = static_cast<const int8_t*>(pw);
  const float* ds = static_cast<const float*>(dw_s);
  const float* ps = static_cast<const float*>(pw_s);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dwq, pwq, ds, ps, g, bt, out, B, n_t, C, k,
                         relu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dwq, pwq, ds, ps, g, bt, out, B, n_t,
                                 C, k, relu, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
