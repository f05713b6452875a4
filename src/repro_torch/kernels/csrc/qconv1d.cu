// Fused quantized separable conv-1D block (RUBICALL's layer) for Hopper.
//
//   y[b, t, d] = act((sum_c acc[b, t, c] * pw_q[c, d]) * pw_s[d] * gamma[d]
//                    + beta[d]),
//   acc[b, t, c] = sum_i x[b, t + i - pad, c] * dw_q[i, c] * dw_s[c]
//
// x is (B, T, C), unpadded: frames outside [0, T) read as zero, so the
// kernel makes the non-causal halo (pad = (k - 1) / 2 frames on the left,
// k - 1 - pad on the right) itself. dw_q is (k, C) int8, pw_q (C, C)
// int8; dw_s, pw_s, gamma, beta are (C,) fp32 (BatchNorm folded into
// gamma/beta); act is ReLU when `relu` is set. Output is (B, T, C) in
// x's dtype (fp32 or bf16); the depthwise sum and the pointwise
// accumulation are fp32.
//
// Replaces repro/kernels/qconv1d.py:qconv1d_block_p (Pallas, TPU). That
// kernel keeps one whole halo-padded (T + k - 1, C) window resident in
// VMEM per grid step and runs the pointwise product as one MXU matmul. A
// RUBICALL serving window (2500 x 344) is 1.7 MB in bf16, against 227 KB
// of shared memory per block here, so both kernels below tile time.
//
// Two kernels, routed by dtype and shape (qconv1d.py:route):
//
// qconv1d_tc_kernel -- bf16 x, C a multiple of 8 up to 352 (the served
// path). Persistent CTAs (one per SM, 8 warps) walk tiles of TM = 32
// output frames of one batch row:
//
//   * pw stays in shared memory as int8 for the whole walk, in its own
//     row-major layout (118,336 B at C = 344; as bf16 it would be 236,672
//     B, more than a block may hold): one contiguous block, copied once per
//     CTA by 16-byte cp.async in the prologue. A lane's mma B fragment
//     (k = 2j, 2j + 1, 2j + 8, 2j + 9 of one column) is 4 byte loads,
//     whose rows fall on distinct banks; int8 is exact in bf16, and the
//     bytes become the two bf16x2 B registers in registers;
//   * depthwise in fp32 on the CUDA cores: the tile's x rows (TM + k - 1
//     frames, rows outside [0, T) zero-filled by cp.async's src-size 0)
//     arrive in slabs of CS = 64 channels through a two-slab cp.async
//     ring, so slab s + 1's copies fly while slab s computes; slab s +
//     1's raw taps and scales are loaded into registers at the same time
//     and dequantized (dw_q * dw_s, once a slab) into shared fp32 after
//     slab s's depthwise; a warp owns 4 frames, a lane a channel pair,
//     and each x value loaded from shared memory feeds every frame of
//     that run that needs it (a window of 4 + 8 - 1 rows in registers,
//     8 taps at a time, in ascending tap order as the reference sums);
//   * the fp32 depthwise sum goes to shared memory as the pointwise A
//     tile in two bf16 terms, a_hi = bf16(acc) and a_lo = bf16(acc -
//     a_hi), ~16 significant bits: the product keeps the reference's
//     fp32 acc (one bf16 term would round each of the C terms of a
//     pointwise sum to 2^-9 of its size);
//   * pointwise on mma.sync.m16n8k16 (bf16 in, fp32 accumulate): a warp
//     owns C / 64 (5 or 6) n8 column tiles of both m16 row tiles, A by
//     ldmatrix, each B word converted once and used by 4 mma (2 row
//     tiles x 2 terms, the hi terms of all its tiles before the lo
//     terms); pw_s, gamma, beta (in shared memory) and ReLU in the
//     epilogue.
//
//   Shared memory at C = 344, k = 75: pw 352 x 344 = 121,088 B; A hi + lo
//   2 x 32 x 360 x 2 = 46,080 B; taps 75 x 64 x 4 = 19,200 B; ring 2 x
//   106 x 128 = 27,136 B; pw_s, gamma, beta 4,128 B; 217,632 B of the
//   232,448 a block may use (k up to 96, the kernel's limit, fits).
//
// qconv1d_block_kernel -- fp32 x (the reference test's 1e-3 is an fp32
// tolerance), and bf16 shapes the tensor-core kernel does not take: one
// block per (batch row, 32 frames), depthwise slabs staged in shared
// memory, the pointwise product on fp32 CUDA cores with pw read as int8
// from L2.
//
// What bounds the function on an H100 (B = 4, T = 2500, C = 344, k = 75,
// bf16): it moves ~13.8 MB (x read once, y written once; weights are
// negligible), 4.2 us at 3.35 TB/s, and does 2.88 GFLOP, 2.9 us on bf16
// tensor cores, so its bound is memory. The tensor-core design issues
// 4.7 GFLOP of mma (two terms) and 0.52 GFLOP of fp32 depthwise FMAs
// (7.7 us at 67 TFLOP/s), one after the other in each CTA, and measured
// 93 us at k = 75 and 61 us at k = 5 on an H100 80GB HBM3 at 700 W
// (chip_smoke.py, PERF.md): pw and the A tile fill shared memory, so one
// CTA of 8 warps runs per SM and every phase (copies, tap dequantization,
// the depthwise's ~1.6 instructions a FMA, the mma.sync rate of the two-
// term product) is bound by latency at 2 warps a scheduler; 316 tiles on
// 132 SMs put 3 on the busiest. The CUDA-core kernel measured 0.41 ms at
// k = 5 and 0.51 ms at k = 75 in fp32: every pointwise FMA on fp32 CUDA
// cores with two shared-memory loads and an L2 byte load beside it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// CUDA-core kernel (fp32; bf16 shapes the tensor-core kernel refuses)

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
                     int n_t, int C, int k, int pad, int relu) {
  extern __shared__ float smem[];
  const int rows = TT + k - 1;
  float* acc = smem;                   // (TT, C)
  float* xs = acc + TT * C;            // (rows, CS)
  float* ws = xs + rows * CS;          // (k, CS)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const T* xb = x + (size_t)b * n_t * C;

  // ---- depthwise: k-tap FMAs per channel slab into acc; slab row r is
  // frame t0 + r - pad (zero outside [0, n_t)) ----
  for (int c0 = 0; c0 < C; c0 += CS) {
    __syncthreads();                   // previous slab done with xs/ws
    for (int i = threadIdx.x; i < rows * CS; i += NT) {
      const int r = i / CS, c = c0 + i % CS, t = t0 + r - pad;
      xs[i] = (c < C && t >= 0 && t < n_t) ? load_f(xb + (size_t)t * C + c)
                                           : 0.f;
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
           int pad, int relu, cudaStream_t stream) {
  const size_t smem = smem_bytes(C, k);
  cudaError_t err = cudaFuncSetAttribute(
      qconv1d_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n_t + TT - 1) / TT, B);
  qconv1d_block_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), dw, pw, dw_s, pw_s, gamma, beta,
      static_cast<T*>(out), n_t, C, k, pad, relu);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16)

constexpr int TM = 32;                 // output frames per tile (2 x m16)
constexpr int TC_CS = 64;              // channels per depthwise slab
constexpr int TC_WARPS = 8;
constexpr int TC_NT = TC_WARPS * 32;
constexpr int FPW = TM / TC_WARPS;     // frames a warp's depthwise owns (4)
constexpr int KT = 8;                  // taps per register window
constexpr int TC_CMAX = 352;           // widest C (K rounded to 16)
constexpr int MAXN8 = (TC_CMAX / 8 + TC_WARPS - 1) / TC_WARPS;   // 6
constexpr int TC_KMAX = 96;            // most taps (TAP_W words a thread)
constexpr int TAP_W = TC_KMAX * TC_CS / 4 / TC_NT;               // 6

__host__ __device__ inline int k_pad(int C) { return (C + 15) / 16 * 16; }
// elements of one A row (bf16): K padded + 8, against bank conflicts
__host__ __device__ inline int a_stride(int C) { return k_pad(C) + 8; }
// one ring slab: the tile's x rows (TM + k - 1, TC_CS), bf16
__host__ __device__ inline size_t slab_bytes(int k) {
  return (size_t)(TM + k - 1) * TC_CS * 2;
}
// pw (K padded rows of C int8), A hi, A lo, the slab's fp32 taps, the
// two-slab ring, then pw_s, gamma and beta (fp32)
__host__ __device__ inline size_t tc_smem_bytes(int C, int k) {
  return (size_t)k_pad(C) * C + 2 * (size_t)TM * a_stride(C) * 2 +
         (size_t)k * TC_CS * 4 + 2 * slab_bytes(k) + 3 * (size_t)C * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `bytes` < 16 (here 0) zero-fills the rest of the 16
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate; a pure
// register operation, so not volatile: the compiler may interleave
// independent ones
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Two int8 values (sign-extended) -> bf16x2 (a, b), exactly: 1.5 * 2^23
// + v as an fp32 bit pattern, minus 1.5 * 2^23, is v; an integer of at
// most 8 significant bits keeps the low 16 bits of its fp32 pattern
// zero, so the high half is its bf16.
__device__ __forceinline__ uint32_t i8x2_to_bf16(int a, int b) {
  const float fa = __int_as_float(0x4B400000 + a) - 12582912.f;
  const float fb = __int_as_float(0x4B400000 + b) - 12582912.f;
  return __byte_perm(__float_as_uint(fa), __float_as_uint(fb), 0x7632);
}
__device__ __forceinline__ float2 bf2_to_f2(uint32_t raw) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}
__device__ __forceinline__ float i8_to_f(uint32_t w, int byte) {
  return (float)(int8_t)((w >> (8 * byte)) & 0xffu);
}

__global__ void __launch_bounds__(TC_NT, 1)
qconv1d_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ dw,
                  const int8_t* __restrict__ pw,
                  const float* __restrict__ dw_s,
                  const float* __restrict__ pw_s,
                  const float* __restrict__ gamma,
                  const float* __restrict__ beta,
                  __nv_bfloat16* __restrict__ out, int n_t, int C, int k,
                  int pad, int relu, int tiles_per_row, int n_tiles) {
  extern __shared__ __align__(16) unsigned char sm[];
  const int kp = k_pad(C), ap = a_stride(C);
  const int8_t* pwsm = reinterpret_cast<const int8_t*>(sm);  // (kp, C)
  __nv_bfloat16* a_hi =
      reinterpret_cast<__nv_bfloat16*>(sm + (size_t)kp * C);  // (TM, ap)
  __nv_bfloat16* a_lo = a_hi + TM * ap;
  float* taps = reinterpret_cast<float*>(a_lo + TM * ap);    // (k, TC_CS)
  unsigned char* ring = reinterpret_cast<unsigned char*>(taps + k * TC_CS);
  const size_t sbytes = slab_bytes(k);
  float* ep = reinterpret_cast<float*>(ring + 2 * sbytes);   // (3, C)
  const int rows = TM + k - 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_slabs = (C + TC_CS - 1) / TC_CS;
  const int n_mine = (n_tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
                     (int)gridDim.x;
  const int n_steps = n_mine * n_slabs;
  auto tile_of = [&](int q) { return (int)blockIdx.x + (q / n_slabs) *
                                     (int)gridDim.x; };

  // x rows of slab `q` of this CTA's walk (tile tile_of(q), channels
  // [c0, c0 + nc)) into ring buffer q % 2; rows outside [0, n_t) are
  // zero-filled
  auto issue = [&](int q) {
    if (q >= n_steps) return;
    const int tile = tile_of(q);
    const int c0 = (q % n_slabs) * TC_CS, nc = min(TC_CS, C - c0);
    const int b = tile / tiles_per_row;
    const int t0 = (tile - b * tiles_per_row) * TM;
    unsigned char* buf = ring + (q & 1) * sbytes;
    const int xc = nc / 8;                      // 16-byte chunks a row
    for (int e = tid; e < rows * xc; e += TC_NT) {
      const int r = e / xc, ch = e - r * xc, t = t0 + r - pad;
      const bool in = t >= 0 && t < n_t;
      const __nv_bfloat16* src =
          x + ((size_t)b * n_t + (in ? t : 0)) * C + c0 + ch * 8;
      cp_async16(smem_u32(buf + r * TC_CS * 2 + ch * 16), src, in ? 16 : 0);
    }
  };
  // the raw taps of slab `q` (4 channels of one tap a word) and their
  // scales, into registers: word i of a thread is tap row (tid + 256 i)
  // / 16, channels c0 + 4 (tid % 16) .. + 3. The loads are unconditional
  // (clamped to the slab) so that nothing waits on them until the
  // dequantization; channels past C are zeroed there
  uint32_t tap_raw[TAP_W];
  float4 tap_sc;
  int tap_nc = 0;
  auto tap_load = [&](int q) {
    if (q >= n_steps) return;
    const int c0 = (q % n_slabs) * TC_CS;
    tap_nc = min(TC_CS, C - c0);
    const int cq = min(4 * (tid & 15), tap_nc - 4);
    tap_sc = *reinterpret_cast<const float4*>(dw_s + c0 + cq);
#pragma unroll
    for (int i = 0; i < TAP_W; ++i) {
      const int row = min((tid >> 4) + i * (TC_NT / 16), k - 1);
      tap_raw[i] = *reinterpret_cast<const uint32_t*>(
          dw + (size_t)row * C + c0 + cq);
    }
  };
  // ... dequantized (fp32 dw_q * dw_s, as the reference) into `taps`
  auto tap_store = [&]() {
    const int cq = 4 * (tid & 15);
    const float4 sc = cq < tap_nc ? tap_sc : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < TAP_W; ++i) {
      const int row = (tid >> 4) + i * (TC_NT / 16);
      if (row < k)
        *reinterpret_cast<float4*>(taps + row * TC_CS + cq) = make_float4(
            i8_to_f(tap_raw[i], 0) * sc.x, i8_to_f(tap_raw[i], 1) * sc.y,
            i8_to_f(tap_raw[i], 2) * sc.z, i8_to_f(tap_raw[i], 3) * sc.w);
    }
  };

  // prologue: pw (row-major, one contiguous block in both memories;
  // rows past C are never read against a nonzero A column), slab 0's x
  // rows and the epilogue's pw_s, gamma, beta in flight; slab 0's taps
  // dequantized
  for (int e = tid; e < C * C / 16; e += TC_NT)
    cp_async16(smem_u32(sm + 16 * e), pw + 16 * e, 16);
  issue(0);
  for (int e = tid; e < 3 * C / 4; e += TC_NT) {
    const int v = e / (C / 4), i = e - v * (C / 4);
    const float* src = (v == 0 ? pw_s : v == 1 ? gamma : beta) + 4 * i;
    cp_async16(smem_u32(ep + v * C + 4 * i), src, 16);
  }
  cp_async_commit();
  tap_load(0);
  tap_store();

  // the pointwise split: warp w owns n8 column tiles [nbeg, nbeg + mine)
  const int n8s = C / 8, nks = kp / 16;
  const int mine = n8s / TC_WARPS + (warp < n8s % TC_WARPS);
  const int nbeg = warp * (n8s / TC_WARPS) + min(warp, n8s % TC_WARPS);

  for (int q = 0; q < n_steps; ++q) {
    cp_async_wait_all();
    // slab q's rows and taps are in; the buffer of slab q - 1, and A,
    // are free
    __syncthreads();
    issue(q + 1);
    cp_async_commit();
    tap_load(q + 1);                    // lands during the depthwise
    const int slab = q % n_slabs;
    const int c0 = slab * TC_CS, nc = min(TC_CS, C - c0);
    const unsigned char* buf = ring + (q & 1) * sbytes;

    // depthwise: warp -> frames f0..f0 + 3, lane -> channels c0 + 2 lane,
    // + 1; slab row r is frame t0 + r - pad. Each 8-tap window's x rows
    // are loaded while the window before it computes.
    {
      const int f0 = warp * FPW, c = c0 + 2 * lane;
      if (2 * lane < nc) {
        const uint32_t* xs = reinterpret_cast<const uint32_t*>(buf) + lane;
        const float2* tp = reinterpret_cast<const float2*>(taps) + lane;
        float2 acc[FPW];
#pragma unroll
        for (int f = 0; f < FPW; ++f) acc[f] = make_float2(0.f, 0.f);
        int i = 0;
        for (; i + KT <= k; i += KT) {
          float2 xw[FPW + KT - 1];
#pragma unroll
          for (int j = 0; j < FPW + KT - 1; ++j)
            xw[j] = bf2_to_f2(xs[(f0 + i + j) * (TC_CS / 2)]);
#pragma unroll
          for (int kt = 0; kt < KT; ++kt) {
            const float2 w = tp[(i + kt) * (TC_CS / 2)];
#pragma unroll
            for (int f = 0; f < FPW; ++f) {
              acc[f].x = fmaf(xw[f + kt].x, w.x, acc[f].x);
              acc[f].y = fmaf(xw[f + kt].y, w.y, acc[f].y);
            }
          }
        }
        for (; i < k; ++i) {
          const float2 w = tp[i * (TC_CS / 2)];
#pragma unroll
          for (int f = 0; f < FPW; ++f) {
            const float2 xv = bf2_to_f2(xs[(f0 + i + f) * (TC_CS / 2)]);
            acc[f].x = fmaf(xv.x, w.x, acc[f].x);
            acc[f].y = fmaf(xv.y, w.y, acc[f].y);
          }
        }
#pragma unroll
        for (int f = 0; f < FPW; ++f) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[f].x, acc[f].y);
          const float2 hf = __bfloat1622float2(hi);
          const __nv_bfloat162 lo =
              __floats2bfloat162_rn(acc[f].x - hf.x, acc[f].y - hf.y);
          *reinterpret_cast<__nv_bfloat162*>(a_hi + (f0 + f) * ap + c) = hi;
          *reinterpret_cast<__nv_bfloat162*>(a_lo + (f0 + f) * ap + c) = lo;
        }
      } else if (c < kp) {              // K padding past C: zero columns
        const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
#pragma unroll
        for (int f = 0; f < FPW; ++f) {
          *reinterpret_cast<__nv_bfloat162*>(a_hi + (f0 + f) * ap + c) = z;
          *reinterpret_cast<__nv_bfloat162*>(a_lo + (f0 + f) * ap + c) = z;
        }
      }
    }
    __syncthreads();          // every warp is done with taps(q); A's slab in
    tap_store();              // taps of slab q + 1
    if (slab != n_slabs - 1) continue;
    __syncthreads();          // the A tile is written

    // pointwise: (TM x kp) hi + lo  x  (kp x C) int8, fp32 accumulate
    float o[2][MAXN8][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < MAXN8; ++j)
        o[m][j][0] = o[m][j][1] = o[m][j][2] = o[m][j][3] = 0.f;
    const int g = lane >> 2, tg = lane & 3;
    const uint32_t hi_addr =
        smem_u32(a_hi + (lane & 15) * ap + (lane >> 4) * 8);
    const uint32_t lo_addr =
        smem_u32(a_lo + (lane & 15) * ap + (lane >> 4) * 8);
    const uint32_t m1 = 16 * ap * 2;    // bytes to the second row tile
    // a lane's B fragment of column tile j at k step ks: pw[k][n] for k =
    // 16 ks + 2 tg + {0, 1, 8, 9}, n = 8 (nbeg + j) + g. With C-byte rows
    // the 4 tg rows of a load fall on distinct banks (C = 344: 172 words
    // apart), the 8 g columns on one or two words of each.
    const int8_t* brow = pwsm + (size_t)(2 * tg) * C + nbeg * 8 + g;
    for (int ks = 0; ks < nks; ++ks) {
      uint32_t h0[4], h1[4], l0[4], l1[4], bw[MAXN8][2];
      ldsm_x4(hi_addr + ks * 32, h0);
      ldsm_x4(hi_addr + m1 + ks * 32, h1);
      ldsm_x4(lo_addr + ks * 32, l0);
      ldsm_x4(lo_addr + m1 + ks * 32, l1);
#pragma unroll
      for (int j = 0; j < MAXN8; ++j)
        if (j < mine) {
          const int8_t* b = brow + (size_t)ks * 16 * C + j * 8;
          bw[j][0] = i8x2_to_bf16(b[0], b[C]);
          bw[j][1] = i8x2_to_bf16(b[8 * C], b[9 * C]);
        }
      // the hi terms of every (row tile, column tile), then the lo
      // terms: no mma waits on the one just before it
#pragma unroll
      for (int j = 0; j < MAXN8; ++j)
        if (j < mine) {
          mma_bf16(o[0][j], h0, bw[j][0], bw[j][1]);
          mma_bf16(o[1][j], h1, bw[j][0], bw[j][1]);
        }
#pragma unroll
      for (int j = 0; j < MAXN8; ++j)
        if (j < mine) {
          mma_bf16(o[0][j], l0, bw[j][0], bw[j][1]);
          mma_bf16(o[1][j], l1, bw[j][0], bw[j][1]);
        }
    }

    // epilogue: rows m * 16 + g (+ 8), columns 8 (nbeg + j) + 2 tg (+ 1)
    const int tile = tile_of(q);
    const int b = tile / tiles_per_row;
    const int t0 = (tile - b * tiles_per_row) * TM;
#pragma unroll
    for (int j = 0; j < MAXN8; ++j) {
      if (j >= mine) continue;
      const int n = (nbeg + j) * 8 + 2 * tg;
      const float2 sc = *reinterpret_cast<const float2*>(ep + n);
      const float2 ga = *reinterpret_cast<const float2*>(ep + C + n);
      const float2 be = *reinterpret_cast<const float2*>(ep + 2 * C + n);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + m * 16 + g + 8 * h;
          if (t >= n_t) continue;
          float y0 = o[m][j][2 * h] * sc.x * ga.x + be.x;
          float y1 = o[m][j][2 * h + 1] * sc.y * ga.y + be.y;
          if (relu) {
            y0 = fmaxf(y0, 0.f);
            y1 = fmaxf(y1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              out + ((size_t)b * n_t + t) * C + n) =
              __floats2bfloat162_rn(y0, y1);
        }
    }
  }
  cp_async_wait_all();
}

int launch_tc(const void* x, const int8_t* dw, const int8_t* pw,
              const float* dw_s, const float* pw_s, const float* gamma,
              const float* beta, void* out, int B, int n_t, int C, int k,
              int pad, int relu, int n_ctas, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(C, k);
  cudaError_t err = cudaFuncSetAttribute(
      qconv1d_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_per_row = (n_t + TM - 1) / TM;
  const int n_tiles = B * tiles_per_row;
  const int grid = n_ctas < n_tiles ? n_ctas : n_tiles;
  qconv1d_tc_kernel<<<grid, TC_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), dw, pw, dw_s, pw_s, gamma, beta,
      static_cast<__nv_bfloat16*>(out), n_t, C, k, pad, relu, tiles_per_row,
      n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t qconv1d_smem_bytes(int C, int k) { return smem_bytes(C, k); }
size_t qconv1d_tc_smem_bytes(int C, int k) { return tc_smem_bytes(C, k); }

// The CUDA-core kernel. x (B, n_t, C) unpadded; pad: halo frames on the
// left ((k - 1) / 2). dtype: 0 = fp32, 1 = bf16 (x and out). Returns the
// cudaError_t of the launch (0 on success). Launches on `stream`; does
// not synchronise.
int qconv1d_block_launch(const void* x, const void* dw, const void* pw,
                         const void* dw_s, const void* pw_s,
                         const void* gamma, const void* beta, void* out,
                         int B, int n_t, int C, int k, int pad, int relu,
                         int dtype, void* stream) {
  const int8_t* dwq = static_cast<const int8_t*>(dw);
  const int8_t* pwq = static_cast<const int8_t*>(pw);
  const float* ds = static_cast<const float*>(dw_s);
  const float* ps = static_cast<const float*>(pw_s);
  const float* g = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dwq, pwq, ds, ps, g, bt, out, B, n_t, C, k, pad,
                         relu, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dwq, pwq, ds, ps, g, bt, out, B, n_t, C,
                                 k, pad, relu, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel: bf16 x (B, n_t, C) unpadded, C a multiple of 8
// up to 352, k up to 96, x, pw_q and the fp32 vectors 16-byte and dw_q
// 4-byte aligned; at most n_ctas
// persistent CTAs (one an SM). Returns the cudaError_t of the launch.
int qconv1d_tc_launch(const void* x, const void* dw, const void* pw,
                      const void* dw_s, const void* pw_s, const void* gamma,
                      const void* beta, void* out, int B, int n_t, int C,
                      int k, int pad, int relu, int n_ctas, void* stream) {
  if (C < 8 || C % 8 || C > TC_CMAX || k < 1 || k > TC_KMAX || n_t < 1 ||
      B < 1 || n_ctas < 1)
    return (int)cudaErrorInvalidValue;
  return launch_tc(x, static_cast<const int8_t*>(dw),
                   static_cast<const int8_t*>(pw),
                   static_cast<const float*>(dw_s),
                   static_cast<const float*>(pw_s),
                   static_cast<const float*>(gamma),
                   static_cast<const float*>(beta), out, B, n_t, C, k, pad,
                   relu, n_ctas, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
