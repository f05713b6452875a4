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
// them, so the chunk walk is a loop inside one block:
//
//   * one thread block (256 threads) per (32 state rows of a head, head,
//     batch row): 192 blocks at mamba2-130m's 4 x 24 heads of 64, two
//     resident on an SM, so every SM has work although only 96 (batch,
//     head) rows exist;
//   * the block walks the prompt in chunks of 64 positions. The chunk
//     length only regroups an exact recurrence, so the result is the
//     reference's at any chunk (the wrapper's `chunk`, 256 for mamba2,
//     sets the plain version's); 64 keeps a chunk's B, C and x (fp32),
//     the masked decay matrix and the state in 109 KB of shared memory,
//     and quarters the intra-chunk work of a 256-position chunk;
//   * B and C are read by batch row, never repeated per head; the state
//     (32 x N fp32) stays in shared memory across the whole prompt and is
//     written once at the end;
//   * per chunk: stage B, C, x and dt (zeros past S, so a ragged last
//     chunk adds nothing and decays nothing); cum by warp scans; M[t, s]
//     = (C_t . B_s) exp(cum_t - cum_s) dt_s, with the exponential taken
//     only for s <= t and the rest selected to 0 (exp(cum_t - cum_s)
//     overflows to inf for s > t once the dt A sums are large, and inf x
//     0 is NaN); y from M, the state and D; then the state update;
//   * fp32 throughout, from bf16 or fp32 inputs, as _ssd_kernel: scores,
//     decays and sums in fp32, y rounded once to x's dtype.
//
// What bounds it on an H100: the function must read x, dt, B, C and
// write y and the state once (~58 MB at mamba2-130m's 4 x 2048-token
// prefill in bf16, 17.5 us at 3.35 TB/s) and do ~13 GFLOP with C.B^T
// formed once per batch row and chunk (13 us on bf16 tensor cores), so
// the bound is memory. This first kernel does every product as an fp32
// FMA on the CUDA cores and forms C.B^T again for every 32 state rows, so
// the arithmetic bounds it far above that; the intra-chunk and state
// products on tensor cores are the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

}  // namespace

extern "C" {

size_t ssd_scan_smem_bytes(int n) { return smem_bytes(n); }

int ssd_scan_state_rows() { return PS; }

int ssd_scan_max_state() { return MAXN; }

// dtype: 0 = fp32, 1 = bf16 (x, B, C and y); dt, A, D and the state are
// fp32. Returns the cudaError_t of the launch (0 on success); launches on
// `stream` and does not synchronise.
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

}  // extern "C"
