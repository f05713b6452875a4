// The Mamba-2 SSD (state-space duality) scan over a whole prompt, for
// Hopper.
//
// Per batch row b and head h, with scalar decay rate A_h < 0 and the
// state h_t (hd x N):
//
//   h_t = exp(dt_t A_h) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D_h x_t
//
// computed chunk by chunk (the chunked "dual" form): inside a chunk of Q
// positions, with cum_t the running sum of dt A from the chunk's start,
//
//   y_t = sum_{s<=t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s      (intra)
//       + exp(cum_t) h_prev C_t + D x_t                           (inter)
//   h   = exp(cum_Q) h_prev + sum_s exp(cum_Q - cum_s) dt_s x_s B_s^T
//
// x is (B, S, nh, hd), dt (B, S, nh) fp32, A and D (nh,) fp32, B and C
// (B, S, N) shared by every head of a batch row; x, B and C all fp32 or
// all bf16, contiguous. Outputs y (B, S, nh, hd) in x's dtype and the
// state after the last position, (B, nh, hd, N) fp32, which the decode
// steps continue from. Any S; hd a multiple of 32, N a multiple of 4 up
// to 128.
//
// Replaces repro/kernels/ssd_scan.py:ssd_scan_p (Pallas, TPU; body
// _ssd_kernel). There the grid (B*nh, S/Q) walks the chunks in order,
// the state lives in VMEM scratch across grid steps and is dropped at
// the end, B and C are repeated per head by ops.py, and S % Q == 0 is
// asserted. Here thread blocks run in parallel and carry nothing between
// them. The chunk length only regroups an exact recurrence, so each
// kernel's own chunk gives the reference's result (the wrapper's
// `chunk`, 256 for mamba2, sets the plain version's). Any S: positions
// past S stage as zeros (dt 0: they add nothing and decay nothing). All
// arithmetic is fp32 as in _ssd_kernel (scores, decays, sums), y rounded
// once to x's dtype. Two routes, by dtype and shape (ssd_scan.py:route):
//
// Tensor-core route (bf16 x, B, C; head dim up to 64 and state up to 128,
// padded by the wrapper to 64 and 64 or 128), SSD's own two-pass
// decomposition in chunks of Q = 128 positions, two kernels:
//
//   * state pass, ssd_state_tc_kernel: one CTA (8 warps) per (64 state
//     columns, head, batch row), 192 at mamba2-130m's 4 x 24 heads, N =
//     128, two an SM. It walks the chunks in order with the state (64 x
//     64 fp32 per CTA) in mma accumulators: per chunk it writes the state
//     before the chunk as bf16 hi + lo (below; staged in shared memory
//     for 16-byte stores), then h = exp(total) h + (x w)^T B, w_s =
//     exp(total - cum_s) dt_s, on mma.sync.m16n8k16, x w (fp32) entering
//     as two bf16 terms hi + lo and B as the exact bf16 it is; the next
//     chunk's x, B and dt fly (cp.async) while one computes;
//   * chunk pass, ssd_chunk_tc_kernel: one CTA (8 warps, 16 positions
//     each) per (4 heads, chunk, batch row), 384 at mamba2's shape, all
//     chunks at once. G = C B^T (bf16 in, exact products, fp32 sum) is
//     formed once per CTA for its 4 heads, only its causal blocks, and
//     kept in registers; per head the intra term (G o exp(cum_t - cum_s)
//     dt_s)_{s<=t} x runs on mma with the masked M split into hi + lo in
//     registers (G's accumulator layout is the next mma's A layout), the
//     inter term exp(cum_t) C_t h_prev with h_prev's hi + lo from the
//     state pass, then + D x and one rounding to bf16 (y staged in shared
//     memory for 16-byte stores); the next head's x and h_prev copies fly
//     while one computes. The exponential is taken only for s <= t
//     (exp(cum_t - cum_s) overflows to inf for s > t once the dt A sums
//     are large, and inf x 0 is NaN).
//
//   Two fp32 bf16 terms carry ~16 significant bits, so each product keeps
//   fp32-level accuracy (no TF32). Bytes at mamba2-130m's 4 x 2048-token
//   prefill: the function's own ~58 MB (x, dt, B, C read, y and the final
//   state written), plus x read a second time (25 MB) and the states
//   before chunks 1..15 (4 x 15 x 24 x 64 x 128 x 4 B = 47 MB hi + lo)
//   written by the state pass and read by the chunk pass; Q = 64 would
//   double the states, Q = 256 would quadruple G and the intra products
//   and not fit a warp's registers.
//
// CUDA-core route, ssd_kernel (fp32, and shapes the tensor-core route does
// not take; hd a multiple of 32, N of 4 up to 128): the sequential walk
//
//   * one thread block (256 threads) per (32 state rows of a head, head,
//     batch row): 192 blocks at mamba2-130m's 4 x 24 heads of 64, two
//     resident on an SM, so every SM has work although only 96 (batch,
//     head) rows exist;
//   * the block walks the prompt in chunks of 64 positions, which keeps a
//     chunk's B, C and x (fp32), the masked decay matrix and the state in
//     109 KB of shared memory and quarters the intra-chunk work of a
//     256-position chunk;
//   * B and C are read by batch row, never repeated per head; the state
//     (32 x N fp32) stays in shared memory across the whole prompt and is
//     written once at the end;
//   * per chunk: stage B, C, x and dt; cum by warp scans; M[t, s] = (C_t .
//     B_s) exp(cum_t - cum_s) dt_s, with the exponential taken only for s
//     <= t and the rest selected to 0; y from M, the state and D; then the
//     state update, every product an fp32 FMA.
//
// What bounds it on an H100: the function must read x, dt, B, C and
// write y and the state once (~58 MB at mamba2-130m's 4 x 2048-token
// prefill in bf16, 17.5 us at 3.35 TB/s) and do ~13 GFLOP with C.B^T
// formed once per batch row and chunk (13 us on bf16 tensor cores), so
// the bound is memory. The CUDA-core walk measured 837.2 us a launch
// (PERF.md): every product an fp32 FMA and C.B^T formed again for every
// 32 state rows, with 96 (batch, head) rows to fill 132 SMs. The
// tensor-core route issues its products in two bf16 terms (twice the
// bound's flops) and moves ~130 MB. What holds it back (per-phase clock64
// counts in development builds, not kept): the state pass walks its 16
// chunks in sequence per CTA, each bound by the latency of its mma chain
// at 16 warps an SM; the chunk pass runs one 182 KB CTA an SM (2.9
// waves) whose mma.sync work, doubled by the hi + lo terms, is its
// largest phase; pairing light and heavy causal warps did not shorten it.
// The times are in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// ---------------------------------------------------------------------------
// CUDA-core route (fp32; shapes the tensor-core route does not take)

constexpr int NT = 256;          // threads per block
constexpr int Q = 64;            // chunk length
constexpr int PS = 32;           // state rows (of hd) per block
constexpr int MAXN = 128;        // largest state width N
constexpr int PAD = 4;           // floats of padding per shared row

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
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Shared memory (fp32): B and C chunks (Q, N + PAD), x chunk (Q, PS),
// state (PS, N + PAD), masked decay matrix (Q, Q + PAD), and cum,
// exp(cum), the state weights and dt (Q each), plus 4 scalars.
size_t smem_bytes(int n) {
  const size_t np = n + PAD;
  return sizeof(float) * (2 * Q * np + (size_t)Q * PS + PS * np +
                          (size_t)Q * (Q + PAD) + 4 * Q + 4);
}

template <typename T>
__global__ void __launch_bounds__(NT, 2)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ D,
           T* __restrict__ y, float* __restrict__ h_out, int S, int nh,
           int hd, int N) {
  const int NP = N + PAD, MP = Q + PAD;
  extern __shared__ float sm[];
  float* bs = sm;                      // (Q, NP)
  float* cs = bs + Q * NP;             // (Q, NP)
  float* xs = cs + Q * NP;             // (Q, PS)
  float* hs = xs + Q * PS;             // (PS, NP) the carried state
  float* ms = hs + PS * NP;            // (Q, MP)
  float* cum = ms + Q * MP;            // (Q)
  float* ecum = cum + Q;               // exp(cum_t)
  float* wst = ecum + Q;               // exp(cum_Q - cum_s) dt_s
  float* dts = wst + Q;                // dt_s (0 past S)
  float* red = dts + Q;                // [warp-0 total, exp(cum_Q)]

  const int p0 = blockIdx.x * PS;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  const int N4 = N / 4;
  const float Ah = A[h], Dh = D[h];

  for (int i = tid; i < PS * NP; i += NT) hs[i] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int L = min(Q, S - t0);
    __syncthreads();             // previous chunk's reads done
    // ---- stage B, C (by batch row), x (this head's 32 rows), dt
    for (int i = tid; i < Q * N4; i += NT) {
      const int r = i / N4, c = (i % N4) * 4;
      float4 bv = make_float4(0.f, 0.f, 0.f, 0.f), cv = bv;
      if (r < L) {
        const size_t off = ((size_t)b * S + t0 + r) * N + c;
        bv = load4(Bm + off);
        cv = load4(Cm + off);
      }
      *reinterpret_cast<float4*>(bs + r * NP + c) = bv;
      *reinterpret_cast<float4*>(cs + r * NP + c) = cv;
    }
    for (int i = tid; i < Q * (PS / 4); i += NT) {
      const int r = i / (PS / 4), c = (i % (PS / 4)) * 4;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < L)
        xv = load4(x + (((size_t)b * S + t0 + r) * nh + h) * hd + p0 + c);
      *reinterpret_cast<float4*>(xs + r * PS + c) = xv;
    }
    if (tid < Q)
      dts[tid] = tid < L ? dt[((size_t)b * S + t0 + tid) * nh + h] : 0.f;
    __syncthreads();

    // ---- cum = inclusive running sum of dt A (warps 0 and 1)
    float run = 0.f;
    if (tid < Q) {
      run = dts[tid] * Ah;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, run, o);
        if (lane >= o) run += up;
      }
      if (tid == 31) red[0] = run;
    }
    __syncthreads();
    if (tid < Q) {
      if (warp == 1) run += red[0];
      cum[tid] = run;
    }
    __syncthreads();
    if (tid < Q) {
      const float total = cum[Q - 1];
      ecum[tid] = expf(cum[tid]);
      wst[tid] = expf(total - cum[tid]) * dts[tid];
      if (tid == 0) red[1] = expf(total);
    }

    // ---- M[t, s] = (C_t . B_s) exp(cum_t - cum_s) dt_s for s <= t, else
    // 0. Thread: rows t = ty*4 + i, columns s = tx + 16 j. A warp's rows
    // are 8w .. 8w+7, so column groups j with 16 j > 8w + 7 are all above
    // the diagonal: skipped (warp-uniform) and written as zeros.
    {
      const int jmax = (8 * warp + 7) / 16 + 1;
      float g[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) g[i][j] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 ca[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = load4(cs + (ty * 4 + i) * NP + n);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < jmax) {
            const float4 bb = load4(bs + (tx + 16 * j) * NP + n);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              g[i][j] = fmaf(ca[i].x, bb.x, g[i][j]);
              g[i][j] = fmaf(ca[i].y, bb.y, g[i][j]);
              g[i][j] = fmaf(ca[i].z, bb.z, g[i][j]);
              g[i][j] = fmaf(ca[i].w, bb.w, g[i][j]);
            }
          }
        }
      }
      __syncthreads();           // cum, ecum, wst visible
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          float mv = 0.f;
          if (s <= t) mv = g[i][j] * expf(cum[t] - cum[s]) * dts[s];
          ms[t * MP + s] = mv;
        }
      }
    }
    __syncthreads();

    // ---- y: rows t = ty*4 + i, state rows p = tx + 16 e
    {
      float acc[4][2], inter[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) acc[i][e] = inter[i][e] = 0.f;
      // intra: s runs to the thread's last row, 4 at a time (M is 0 past
      // each row's diagonal)
      for (int s = 0; s <= ty * 4 + 3; s += 4) {
        float4 mr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) mr[i] = load4(ms + (ty * 4 + i) * MP + s);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float x0 = xs[(s + u) * PS + tx];
          const float x1 = xs[(s + u) * PS + tx + 16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float mv = u == 0 ? mr[i].x : u == 1 ? mr[i].y
                           : u == 2 ? mr[i].z : mr[i].w;
            acc[i][0] = fmaf(mv, x0, acc[i][0]);
            acc[i][1] = fmaf(mv, x1, acc[i][1]);
          }
        }
      }
      // inter: C_t . h_prev[p]
      for (int n = 0; n < N; n += 4) {
        float4 ca[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ca[i] = load4(cs + (ty * 4 + i) * NP + n);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4 hh = load4(hs + (tx + 16 * e) * NP + n);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            inter[i][e] = fmaf(ca[i].x, hh.x, inter[i][e]);
            inter[i][e] = fmaf(ca[i].y, hh.y, inter[i][e]);
            inter[i][e] = fmaf(ca[i].z, hh.z, inter[i][e]);
            inter[i][e] = fmaf(ca[i].w, hh.w, inter[i][e]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = ty * 4 + i;
        if (t >= L) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = tx + 16 * e;
          const float yv = acc[i][e] + inter[i][e] * ecum[t] +
                           Dh * xs[t * PS + p];
          store1(y + (((size_t)b * S + t0 + t) * nh + h) * hd + p0 + p, yv);
        }
      }
    }
    __syncthreads();             // the old state is read; update it

    // ---- h = exp(cum_Q) h + sum_s (wst_s x_s) B_s^T: thread owns state
    // rows p = warp*4 + i and columns n = lane*4 + j
    if (lane < N4) {
      float upd[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) upd[i][j] = 0.f;
      for (int s = 0; s < L; ++s) {
        const float w = wst[s];
        const float4 xv = load4(xs + s * PS + warp * 4);
        const float4 bb = load4(bs + s * NP + lane * 4);
        const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          upd[i][0] = fmaf(xw[i], bb.x, upd[i][0]);
          upd[i][1] = fmaf(xw[i], bb.y, upd[i][1]);
          upd[i][2] = fmaf(xw[i], bb.z, upd[i][2]);
          upd[i][3] = fmaf(xw[i], bb.w, upd[i][3]);
        }
      }
      const float et = red[1];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* row = hs + (warp * 4 + i) * NP + lane * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) row[j] = row[j] * et + upd[i][j];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < PS * N; i += NT) {
    const int p = i / N, n = i % N;
    h_out[(((size_t)b * nh + h) * hd + p0 + p) * N + n] = hs[p * NP + n];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* A, const void* Bm,
           const void* Cm, const float* D, void* y, float* h_out, int B,
           int S, int nh, int hd, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hd / PS, nh, B);
  ssd_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, static_cast<T*>(y), h_out, S, nh, hd, N);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// Tensor-core route (bf16 x, B, C): a state pass and a chunk pass

namespace tcs {

constexpr int Q = 128;          // chunk length of the route
constexpr int HD = 64;          // head dim (the wrapper pads to it)
constexpr int NB = 64;          // state columns per state-pass CTA
constexpr int HG = 4;           // heads per chunk-pass CTA
constexpr int NT1 = 256;        // state pass: 8 warps, 16 rows x 32 columns
constexpr int NT2 = 256;        // chunk pass: 8 warps x 16 positions
constexpr int XS = HD + 8;      // staged x row (elements; 144 B: ldmatrix
                                // rows on distinct banks)
constexpr int BS1 = NB + 8;     // staged B row of the state pass

// state pass: x, B (two chunks each), the state's hi and lo tiles on
// their way out, dt (two chunks), weights, decay
constexpr size_t smem1 = 2 * (size_t)Q * XS * 2 + 2 * (size_t)Q * BS1 * 2 +
                         2 * (size_t)HD * BS1 * 2 + 3 * Q * 4 + 16;

// chunk pass at state width np: C, B; x of two heads; the state before
// the chunk (hi, lo) of two heads; dt, cum * log2(e), exp(cum) per head
__host__ __device__ constexpr size_t smem2(int np) {
  return 2 * (size_t)Q * (np + 8) * 2 + 2 * (size_t)Q * XS * 2 +
         4 * (size_t)HD * (np + 8) * 2 + 3 * (size_t)HG * Q * 4;
}

}  // namespace tcs

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// `bytes` < 16 (here 0) zero-fills the rest of the 16
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, "
               "[%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
               "{%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ float2 bf2_to_f2(uint32_t raw) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
}
// fp32 (a, b) -> bf16x2 terms hi = bf16(v) and lo = bf16(v - hi): ~16
// significant bits, so a product with an exact bf16 keeps fp32 accuracy
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One head's inclusive running sum of dt * a over a chunk of Q = 128
// positions, by one warp (lane l owns positions 4l .. 4l + 3, whose dt
// are `dtv`): cum[i] for the lane's 4 positions and the chunk's total.
__device__ __forceinline__ float chunk_cum(const float (&dtv)[4], float a,
                                           int lane, float (&cum)[4]) {
  float run = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    run += dtv[i] * a;
    cum[i] = run;
  }
  float tot = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, tot, o);
    if (lane >= o) tot += up;
  }
  const float excl = tot - run;
#pragma unroll
  for (int i = 0; i < 4; ++i) cum[i] += excl;
  return __shfl_sync(0xffffffffu, tot, 31);
}

// State pass: one CTA per (64 state columns, head, batch row) walks the
// chunks in order, carrying the state h (64 x 64 fp32) in mma
// accumulators (warp w: rows 16 (w % 4) .. + 15, columns 32 (w / 4) ..
// + 31). Per chunk it writes the state before the chunk, split into bf16
// hi and lo and staged through shared memory into 16-byte stores, for
// the chunk pass, then h = exp(total) h + (x w)^T B on tensor cores, with
// w_s = exp(total - cum_s) dt_s and x w split into bf16 hi + lo. The
// next chunk's x, B and dt copies fly while this one computes; warp 0
// forms the chunk's weights while the other warps store the state.
__global__ void __launch_bounds__(tcs::NT1)
ssd_state_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    __nv_bfloat16* __restrict__ hp_hi,
                    __nv_bfloat16* __restrict__ hp_lo,
                    float* __restrict__ h_out, int S, int nh, int N) {
  using tcs::Q;
  using tcs::HD;
  using tcs::XS;
  using tcs::BS1;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  // [2][Q][XS]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* bs = xs + 2 * Q * XS;                         // [2][Q][BS1]
  __nv_bfloat16* hs = bs + 2 * Q * BS1;                        // [2][HD][BS1]
  float* dts = reinterpret_cast<float*>(hs + 2 * HD * BS1);    // [2][Q]
  float* wts = dts + 2 * Q;                                    // [Q]
  float* dec = wts + Q;                                        // exp(total)
  const int nb0 = blockIdx.x * tcs::NB, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, q8 = lane >> 3, r8 = lane & 7;
  const int p0 = (warp & 3) * 16, c0 = (warp >> 2) * 32;
  const int nch = (S + Q - 1) / Q;
  const float Ah = A[h];

  auto load = [&](int c, int buf) {
    const int t0 = c * Q;
    for (int i = tid; i < Q * 8; i += tcs::NT1) {
      const int r = i >> 3, ch = (i & 7) * 8;
      const bool in = t0 + r < S;
      const size_t row = (size_t)b * S + t0 + r;
      cp_async16(xs + (buf * Q + r) * XS + ch,
                 in ? x + (row * nh + h) * HD + ch : x, in ? 16 : 0);
      cp_async16(bs + (buf * Q + r) * BS1 + ch,
                 in ? Bm + row * N + nb0 + ch : Bm, in ? 16 : 0);
    }
    for (int i = tid; i < Q; i += tcs::NT1) {
      const bool in = t0 + i < S;
      cp_async4(dts + buf * Q + i,
                in ? dt + ((size_t)b * S + t0 + i) * nh + h : dt, in ? 4 : 0);
    }
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  load(0, 0);
  cp_async_commit();
  for (int c = 0; c < nch; ++c) {
    const int buf = c & 1;
    if (c + 1 < nch) load(c + 1, buf ^ 1);
    cp_async_commit();
    if (c > 0) {                 // the state before chunk c, staged
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int off = (p0 + g + 8 * half) * BS1 + c0 + j * 8 + 2 * t4;
          uint32_t hi, lo;
          split2(acc[j][2 * half], acc[j][2 * half + 1], hi, lo);
          *reinterpret_cast<uint32_t*>(hs + off) = hi;
          *reinterpret_cast<uint32_t*>(hs + HD * BS1 + off) = lo;
        }
    }
    cp_async_wait<1>();
    __syncthreads();             // chunk c staged; the state tiles too
    if (c > 0 && warp > 0) {     // 16-byte stores, while warp 0 scans
      const size_t base = (((size_t)b * nch + c) * nh + h) * HD;
      for (int i = tid - 32; i < 2 * HD * 8; i += tcs::NT1 - 32) {
        const int t = i / (HD * 8), r = (i / 8) % HD, ch = (i % 8) * 8;
        *reinterpret_cast<uint4*>((t ? hp_lo : hp_hi) + (base + r) * N +
                                  nb0 + ch) =
            *reinterpret_cast<const uint4*>(hs + (t * HD + r) * BS1 + ch);
      }
    }
    if (warp == 0) {
      float dtv[4], cum[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dtv[i] = dts[buf * Q + 4 * lane + i];
      const float total = chunk_cum(dtv, Ah, lane, cum);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wts[4 * lane + i] = expf(total - cum[i]) * dtv[i];
      if (lane == 0) dec[0] = expf(total);
    }
    __syncthreads();
    const float e = dec[0];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] *= e;
    const __nv_bfloat16* xb = xs + buf * Q * XS;
    const __nv_bfloat16* bb = bs + buf * Q * BS1;
#pragma unroll 2
    for (int s0 = 0; s0 < Q; s0 += 16) {
      // A = (x w)^T (rows p, k = s): x^T by a transposing ldmatrix; regs
      // 0, 1 hold s0 + 2t, +1 (rows g, g + 8), regs 2, 3 s0 + 8 + 2t, +1
      uint32_t xa[4], ah[4], al[4];
      ldsm_x4_t(xb + (s0 + (q8 >> 1) * 8 + r8) * XS + p0 + (q8 & 1) * 8,
                xa);
      const float w0 = wts[s0 + 2 * t4], w1 = wts[s0 + 2 * t4 + 1];
      const float w2 = wts[s0 + 8 + 2 * t4], w3 = wts[s0 + 9 + 2 * t4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = bf2_to_f2(xa[r]);
        split2(f.x * (r < 2 ? w0 : w2), f.y * (r < 2 ? w1 : w3), ah[r],
               al[r]);
      }
      // B = B_c (k = s, columns n) by a transposing ldmatrix, 2 n8 tiles
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bb + (s0 + (q8 & 1) * 8 + r8) * BS1 + c0 + np * 16 +
                      (q8 >> 1) * 8, bf);
        mma_bf16(acc[2 * np], ah, bf[0], bf[1]);
        mma_bf16(acc[2 * np], al, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], ah, bf[2], bf[3]);
        mma_bf16(acc[2 * np + 1], al, bf[2], bf[3]);
      }
    }
    __syncthreads();             // chunk c's buffers and weights are read
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + g + (i >> 1) * 8;
      const int n = nb0 + c0 + j * 8 + 2 * t4 + (i & 1);
      h_out[(((size_t)b * nh + h) * HD + p) * N + n] = acc[j][i];
    }
}

// One k16 step of the intra term for rows (t, t + 8), t = the lane's
// first row: s in [16 kk, 16 kk + 16) from the G tiles g0 (s tile 2 kk)
// and g1 (2 kk + 1). M = G exp(cum_t - cum_s) dt_s for s <= t (the
// exponential taken only there: exp overflows for s > t and inf x 0 is
// NaN), split into hi + lo, times x (64 columns) into acc. G's
// accumulator layout is the A fragment layout.
__device__ __forceinline__ void intra_step(
    float (&acc)[8][4], const float (&g0)[4], const float (&g1)[4], int kk,
    int t, const float* clh, const float* dth, const __nv_bfloat16* xb,
    int t4, int q8, int r8) {
  const float cla = clh[t], clb = clh[t + 8];
  uint32_t mh[4], ml[4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float(&gg)[4] = half ? g1 : g0;
    const int s = 16 * kk + 8 * half + 2 * t4;
    const float c0 = clh[s], c1 = clh[s + 1];
    const float d0 = dth[s], d1 = dth[s + 1];
    const float m00 = s <= t ? gg[0] * exp2f(cla - c0) * d0 : 0.f;
    const float m01 = s + 1 <= t ? gg[1] * exp2f(cla - c1) * d1 : 0.f;
    const float m10 = s <= t + 8 ? gg[2] * exp2f(clb - c0) * d0 : 0.f;
    const float m11 = s + 1 <= t + 8 ? gg[3] * exp2f(clb - c1) * d1 : 0.f;
    split2(m00, m01, mh[2 * half], ml[2 * half]);
    split2(m10, m11, mh[2 * half + 1], ml[2 * half + 1]);
  }
#pragma unroll
  for (int pp = 0; pp < 4; ++pp) {
    uint32_t bx[4];
    ldsm_x4_t(xb + (16 * kk + (q8 & 1) * 8 + r8) * tcs::XS + pp * 16 +
                  (q8 >> 1) * 8, bx);
    mma_bf16(acc[2 * pp], mh, bx[0], bx[1]);
    mma_bf16(acc[2 * pp], ml, bx[0], bx[1]);
    mma_bf16(acc[2 * pp + 1], mh, bx[2], bx[3]);
    mma_bf16(acc[2 * pp + 1], ml, bx[2], bx[3]);
  }
}

// Chunk pass: one CTA per (4 heads, chunk, batch row); warp w owns the
// chunk's positions t in [16w, 16w + 16). G = C B^T is formed once on
// tensor cores (rows of the warp, columns s < 16(w + 1): the causal
// part) and kept in registers for every head; per head
//
//   y = exp(cum_t) C_t . h_prev + (G o exp(cum_t - cum_s) dt_s)_{s<=t} . x
//       + D x
//
// with h_prev (the state pass's hi + lo) and the decay-masked M (split
// into hi + lo in registers: G's accumulator layout is the A fragment
// layout) on tensor cores, the exponential taken only for s <= t. The
// next head's x and h_prev copies fly while one head computes.
template <int NP>
__global__ void __launch_bounds__(tcs::NT2, 1)
ssd_chunk_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const __nv_bfloat16* __restrict__ Bm,
                    const __nv_bfloat16* __restrict__ Cm,
                    const float* __restrict__ D,
                    const __nv_bfloat16* __restrict__ hp_hi,
                    const __nv_bfloat16* __restrict__ hp_lo,
                    __nv_bfloat16* __restrict__ y, int S, int nh) {
  using tcs::Q;
  using tcs::HD;
  using tcs::XS;
  using tcs::HG;
  constexpr int CS = NP + 8;     // staged C, B and state rows (elements)
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char smem_tc[];
  // [Q][CS]
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem_tc);
  __nv_bfloat16* bs = cs + Q * CS;                             // [Q][CS]
  __nv_bfloat16* xs = bs + Q * CS;                             // [2][Q][XS]
  __nv_bfloat16* hh_s = xs + 2 * Q * XS;                       // [2][HD][CS]
  __nv_bfloat16* hl_s = hh_s + 2 * HD * CS;                    // [2][HD][CS]
  float* dts = reinterpret_cast<float*>(hl_s + 2 * HD * CS);   // [HG][Q]
  float* cl = dts + HG * Q;                                    // cum log2 e
  float* ec = cl + HG * Q;                                     // exp(cum)
  const int hg0 = blockIdx.x * HG, c = blockIdx.y, b = blockIdx.z;
  const int nch = gridDim.y;
  const int nheads = min(HG, nh - hg0);
  const int t0 = c * Q, L = min(Q, S - t0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, q8 = lane >> 3, r8 = lane & 7;

  auto load_head = [&](int hh, int buf) {
    const int h = hg0 + hh;
    for (int i = tid; i < Q * 8; i += tcs::NT2) {
      const int r = i >> 3, ch = (i & 7) * 8;
      const bool in = r < L;
      cp_async16(xs + (buf * Q + r) * XS + ch,
                 in ? x + (((size_t)b * S + t0 + r) * nh + h) * HD + ch : x,
                 in ? 16 : 0);
    }
    if (c > 0) {
      const size_t base = (((size_t)b * nch + c) * nh + h) * HD;
      for (int i = tid; i < HD * (NP / 8); i += tcs::NT2) {
        const int r = i / (NP / 8), ch = (i % (NP / 8)) * 8;
        const size_t off = (base + r) * NP + ch;
        cp_async16(hh_s + (buf * HD + r) * CS + ch, hp_hi + off, 16);
        cp_async16(hl_s + (buf * HD + r) * CS + ch, hp_lo + off, 16);
      }
    }
  };

  for (int i = tid; i < Q * (NP / 8); i += tcs::NT2) {
    const int r = i / (NP / 8), ch = (i % (NP / 8)) * 8;
    const bool in = r < L;
    const size_t off = ((size_t)b * S + t0 + r) * NP + ch;
    cp_async16(cs + r * CS + ch, in ? Cm + off : Cm, in ? 16 : 0);
    cp_async16(bs + r * CS + ch, in ? Bm + off : Bm, in ? 16 : 0);
  }
  for (int i = tid; i < HG * Q; i += tcs::NT2) {
    const int hh = i / Q, r = i % Q;
    const bool in = hh < nheads && r < L;
    cp_async4(dts + i,
              in ? dt + ((size_t)b * S + t0 + r) * nh + hg0 + hh : dt,
              in ? 4 : 0);
  }
  load_head(0, 0);
  cp_async_commit();
  if (nheads > 1) load_head(1, 1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();               // C, B, dt and head 0 staged

  if (warp < nheads) {
    float dtv[4], cum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) dtv[i] = dts[warp * Q + 4 * lane + i];
    chunk_cum(dtv, A[hg0 + warp], lane, cum);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cl[warp * Q + 4 * lane + i] = cum[i] * LOG2E;
      ec[warp * Q + 4 * lane + i] = expf(cum[i]);
    }
  }
  // G for rows 16w .. 16w + 15, s tiles 0 .. 2w + 1 (the causal part)
  float G[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) G[j][i] = 0.f;
#pragma unroll 2
  for (int k0 = 0; k0 < NP; k0 += 16) {
    uint32_t ca[4];
    ldsm_x4(cs + (warp * 16 + (q8 & 1) * 8 + r8) * CS + k0 + (q8 >> 1) * 8,
            ca);
#pragma unroll
    for (int jp = 0; jp < 8; ++jp) {
      if (jp <= warp) {
        uint32_t bf[4];
        ldsm_x4(bs + (jp * 16 + (q8 >> 1) * 8 + r8) * CS + k0 + (q8 & 1) * 8,
                bf);
        mma_bf16(G[2 * jp], ca, bf[0], bf[1]);
        mma_bf16(G[2 * jp + 1], ca, bf[2], bf[3]);
      }
    }
  }
  __syncthreads();               // cum visible

  const int ta = warp * 16 + g, tb = ta + 8;
  for (int hh = 0; hh < nheads; ++hh) {
    const int buf = hh & 1, h = hg0 + hh;
    if (hh > 0) {
      cp_async_wait<1>();
      __syncthreads();           // head hh staged
    }
    const __nv_bfloat16* xb = xs + buf * Q * XS;
    const float* clh = cl + hh * Q;
    const float* dth = dts + hh * Q;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
    if (c > 0) {                 // C_t . h_prev (hi + lo), then exp(cum_t)
      const __nv_bfloat16* hb = hh_s + buf * HD * CS;
      const __nv_bfloat16* lb = hl_s + buf * HD * CS;
#pragma unroll 2
      for (int k0 = 0; k0 < NP; k0 += 16) {
        uint32_t ca[4];
        ldsm_x4(cs + (warp * 16 + (q8 & 1) * 8 + r8) * CS + k0 +
                    (q8 >> 1) * 8, ca);
#pragma unroll
        for (int pp = 0; pp < 4; ++pp) {
          uint32_t bh[4], bl[4];
          const int off = (pp * 16 + (q8 >> 1) * 8 + r8) * CS + k0 +
                          (q8 & 1) * 8;
          ldsm_x4(hb + off, bh);
          ldsm_x4(lb + off, bl);
          mma_bf16(acc[2 * pp], ca, bh[0], bh[1]);
          mma_bf16(acc[2 * pp], ca, bl[0], bl[1]);
          mma_bf16(acc[2 * pp + 1], ca, bh[2], bh[3]);
          mma_bf16(acc[2 * pp + 1], ca, bl[2], bl[3]);
        }
      }
      const float e0 = ec[hh * Q + ta], e1 = ec[hh * Q + tb];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] *= e0;
        acc[j][1] *= e0;
        acc[j][2] *= e1;
        acc[j][3] *= e1;
      }
    }
    // intra: k16 steps 0 .. w of the causal M times x
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      if (kk <= warp)
        intra_step(acc, G[2 * kk], G[2 * kk + 1], kk, ta, clh, dth, xb, t4,
                   q8, r8);
    // + D x, one rounding; y takes the place of x in shared memory and
    // leaves in 16-byte stores
    const float Dh = D[h];
    uint32_t yo[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int t = half ? tb : ta, p = j * 8 + 2 * t4;
        const float2 xv = bf2_to_f2(
            *reinterpret_cast<const uint32_t*>(xb + t * XS + p));
        const __nv_bfloat162 o = __floats2bfloat162_rn(
            acc[j][2 * half] + Dh * xv.x, acc[j][2 * half + 1] + Dh * xv.y);
        yo[j][half] = *reinterpret_cast<const uint32_t*>(&o);
      }
    __syncthreads();             // every warp is done reading x
    __nv_bfloat16* yb = xs + buf * Q * XS;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<uint32_t*>(yb + (half ? tb : ta) * XS + j * 8 +
                                     2 * t4) = yo[j][half];
    __syncthreads();
    for (int i = tid; i < L * 8; i += tcs::NT2) {
      const int r = i >> 3, ch = (i & 7) * 8;
      *reinterpret_cast<uint4*>(y + (((size_t)b * S + t0 + r) * nh + h) * HD +
                                ch) =
          *reinterpret_cast<const uint4*>(yb + r * XS + ch);
    }
    __syncthreads();             // head hh's buffers are free
    if (hh + 2 < nheads) load_head(hh + 2, buf);
    cp_async_commit();
  }
}

template <int NP>
int launch_chunk(const __nv_bfloat16* x, const float* dt, const float* A,
                 const __nv_bfloat16* Bm, const __nv_bfloat16* Cm,
                 const float* D, const __nv_bfloat16* hp_hi,
                 const __nv_bfloat16* hp_lo, __nv_bfloat16* y, int B, int S,
                 int nh, cudaStream_t stream) {
  const size_t smem = tcs::smem2(NP);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_tc_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((nh + tcs::HG - 1) / tcs::HG, (S + tcs::Q - 1) / tcs::Q, B);
  ssd_chunk_tc_kernel<NP><<<grid, tcs::NT2, smem, stream>>>(
      x, dt, A, Bm, Cm, D, hp_hi, hp_lo, y, S, nh);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

size_t ssd_scan_smem_bytes(int n) { return smem_bytes(n); }

int ssd_scan_state_rows() { return PS; }

int ssd_scan_max_state() { return MAXN; }

size_t ssd_scan_tc_smem_bytes(int n) {
  const size_t s2 = tcs::smem2(n);
  return s2 > tcs::smem1 ? s2 : tcs::smem1;
}

// CUDA-core route. dtype: 0 = fp32, 1 = bf16 (x, B, C and y); dt, A, D
// and the state are fp32. Returns the cudaError_t of the launch (0 on
// success); launches on `stream` and does not synchronise.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, const void* D, void* y,
                    void* h_out, int B, int S, int nh, int hd, int N,
                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || nh < 1 || hd < PS || hd % PS || N < 4 || N % 4 ||
      N > MAXN)
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const float* Df = static_cast<const float*>(D);
  float* hf = static_cast<float*>(h_out);
  if (dtype == 0)
    return launch<float>(x, dtf, Af, Bm, Cm, Df, y, hf, B, S, nh, hd, N, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dtf, Af, Bm, Cm, Df, y, hf, B, S, nh, hd,
                                 N, s);
  return (int)cudaErrorInvalidValue;
}

// Tensor-core route: x, B, C and y bf16 with head dim 64 and state width
// N 64 or 128; dt, A, D and the state fp32. hp_hi / hp_lo are (B,
// ceil(S / 128), nh, 64, N) bf16 workspaces for the states before each
// chunk. Launches the state pass, then the chunk pass, on `stream` and
// does not synchronise; returns the first cudaError_t (0 on success).
int ssd_scan_tc_launch(const void* x, const void* dt, const void* A,
                       const void* Bm, const void* Cm, const void* D,
                       void* y, void* h_out, void* hp_hi, void* hp_lo, int B,
                       int S, int nh, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || S < 1 || nh < 1 || (N != 64 && N != 128))
    return (int)cudaErrorInvalidValue;
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  const __nv_bfloat16* bb = static_cast<const __nv_bfloat16*>(Bm);
  const __nv_bfloat16* cb = static_cast<const __nv_bfloat16*>(Cm);
  __nv_bfloat16* hh = static_cast<__nv_bfloat16*>(hp_hi);
  __nv_bfloat16* hl = static_cast<__nv_bfloat16*>(hp_lo);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_state_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)tcs::smem1);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(N / tcs::NB, nh, B);
  ssd_state_tc_kernel<<<grid, tcs::NT1, tcs::smem1, s>>>(
      xb, dtf, Af, bb, hh, hl, static_cast<float*>(h_out), S, nh, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* Df = static_cast<const float*>(D);
  __nv_bfloat16* yb = static_cast<__nv_bfloat16*>(y);
  if (N == 64)
    return launch_chunk<64>(xb, dtf, Af, bb, cb, Df, hh, hl, yb, B, S, nh, s);
  return launch_chunk<128>(xb, dtf, Af, bb, cb, Df, hh, hl, yb, B, S, nh, s);
}

}  // extern "C"
