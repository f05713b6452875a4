// Weight-only quantized matmul for Hopper: y = (x @ w_q) * scale.
//
//   y[m, n] = round_to_x_dtype((sum_k x[m, k] * w_q[k, n]) * scale[n])
//
// x is (M, K) fp32 or bf16; w_q is (K, N) int8 (bits = 8) or (ceil(K/2),
// N) int8 holding two sign-extended nibbles per byte (bits = 4: packed
// row r holds rows 2r in the low nibble and 2r + 1 in the high one; for
// an odd K the last high nibble is a zero pad row); scale is (N,) fp32.
// The weights are dequantized in registers, the sum is fp32, each
// column's scale is applied once after the K sum, and the output is
// rounded once to x's dtype.
//
// Replaces repro/kernels/qmatmul.py:qmatmul_p (Pallas, TPU), whose grid
// walks (M/128, N/128, K/128) tiles with an fp32 VMEM accumulator and
// the K steps in order. On the serving path M is small (4 rows on a
// decode tick, 64 = 4 slots x a 16-token prefill chunk on a mixed tick),
// so this is a weight-streaming skinny GEMM, not a tiled square GEMM.
//
// What bounds it on an H100: the function reads K*N weight bytes (17.7
// MB at K 2560, N 6912; 389 MB for qwen1.5-4b's 2560 x 151936 head) and
// does 2*M*K*N flops: 8 flops a weight byte at M = 4, 128 at M = 64,
// both under the card's ~295 flop/byte ridge, so it is memory-bound at
// every served M; the least time is the weight bytes over 3.35 TB/s (5.3
// us at K 2560, N 6912). The design goal is to stream the weights at
// close to that rate and hide the dequantization and the products under
// the stream. Two kernels, routed by x's dtype (qmatmul.py:route):
//
// qmatmul_tc_kernel -- bf16 x (the served path), on tensor cores:
//
//   * the product is taken transposed, y^T = w^T x^T: the weights are the
//     A operand (16 columns x 16 k per warp), x the B operand, so M = 4
//     pads only to 8 rows and every A fragment serves all of M's rows;
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate) up to 32 rows, and at
//     M = 64 (the mixed tick) wgmma.m64n64k16 with A from registers (the
//     4 warps of a warpgroup hold its 64 rows, in the mma.sync A layout)
//     and x^T from a 128-byte-swizzled shared tile;
//   * one CTA (8 warps: 4 along N x 32 columns, 2 taking alternate k16
//     steps) per (128-column tile of N, K split, 64 rows of M). The
//     weight tile and x's K slice stream through a cp.async ring
//     (16-byte copies, zero-filled past the edges): 8 stages of 64 k at
//     M <= 8, 3 stages of 128 k at M = 64, about 83 and 108 KB, two CTAs
//     an SM, so most of the ring is in flight while a stage is consumed;
//   * a lane's A fragment needs two k rows of one column per register,
//     while the rows lie contiguous along N: the lane reads one 32-bit
//     word (4 columns) from each of its 4 k rows (2t, 2t+1, 2t+8, 2t+9;
//     rows padded by 16 bytes so the 4 rows fall on distinct banks) and
//     its 4 columns become the rows g and g + 8 of two A fragments (a
//     column permutation under which a lane ends up holding 4 adjacent
//     columns of each output row). int4: the low and high nibble of one
//     byte are rows 2t and 2t + 1, so 2 words serve;
//   * int8 -> bf16 is exact (|v| <= 128 has at most 8 significant bits):
//     each byte, biased by 128, is put by one byte permute into the fp32
//     pattern 2^23 + u, and one fp32 subtract of 2^23 + 128 leaves v,
//     whose high half is its bf16; one more permute packs two. int4
//     nibbles are sign-extended by shifts first. bf16 x times an exact
//     bf16 weight is an exact fp32 product, so the result differs from
//     the plain version only in the order of the fp32 sum;
//   * the two k-step groups add through shared memory; with one K split
//     the lanes scale, round once and store 4 adjacent bf16 of a row
//     straight from registers. K splits are the CTAs of one thread block
//     cluster (at most 8): the cluster adds the splits' tiles in split
//     order through distributed shared memory. No partial goes to device
//     memory, no atomics, and the sum is the same run to run;
//   * the grid fills at most one wave of two CTAs an SM (qmatmul.py:
//     tc_plan): 20 x 8 at N = 2560, 54 x 4 at N = 6912, one split for the
//     1187 tiles of the head.
//
//   What holds it back (per-phase clock64 counts in development builds,
//   not kept): at M = 4 a CTA of the 2560 x 2560 projection spends less
//   time consuming its five stages than issuing its first copies or
//   waiting at the cluster barrier for the slowest split; at M = 64 the
//   stages (weight conversion, the copies' issue, and x, re-read from L2
//   by every column tile) take about twice as long, and the tensor cores
//   are not the limit: wgmma in place of mma.sync there moved it little.
//
// qmatmul_kernel -- fp32 x (the reference's fp32 sum over fp32 x; no
// TF32), on CUDA cores:
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
//   It was the only kernel until the tensor-core one: 0.161 ms at M = 64,
//   K 2560, N 6912 in bf16 (2.2x the library's dequantize + matmul) and
//   6.495 ms over a qwen1.5-4b decode tick (PERF.md): every product an
//   fp32 FMA, M walked in passes of 8 with a shared-memory reduction and
//   two barriers each, the weight tile loaded through registers before
//   any math, and (splits, M, N) fp32 partials through device memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// CUDA-core kernel (fp32 x)

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


// m8 tiles of x rows a tensor-core CTA takes (M above 64 walks grid z)
inline int tc_mtiles(int M) {
  return M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8;
}

// ---------------------------------------------------------------------------
// Tensor-core kernel (bf16 x)

namespace tc {

constexpr int NW = 8;              // warps per CTA
constexpr int NT = NW * 32;
constexpr int WN = 4;              // warps along N, 32 columns each
constexpr int BN = 32 * WN;        // columns per CTA
constexpr int KGRAN = 64;          // K splits hold whole multiples of this
constexpr int MMAX = 64;           // x rows per CTA (grid z walks M)
constexpr int MAX_SPLITS = 8;      // CTAs of a cluster (portable size)

// k rows per pipeline stage and the ring's depth, by the m8 tiles of x:
// a small x tile leaves room for more weight stages in flight (about 83
// KB of ring at M <= 32, 108 KB at M = 64: two CTAs an SM)
__host__ __device__ constexpr int ks_of(int mt) { return mt == 8 ? 128 : 64; }
__host__ __device__ constexpr int stages_of(int mt) {
  return mt == 1 ? 8 : mt == 2 ? 7 : mt == 4 ? 6 : 3;
}
__host__ __device__ constexpr int xstr(int mt) {
  return ks_of(mt) * 2 + 16;            // bytes per staged x row (padded)
}
__host__ __device__ constexpr int wstr(int bn, int bits) {
  return bn + (bits == 8 ? 16 : 32);    // 4 k rows on distinct banks
}
__host__ __device__ constexpr int wrows(int bits, int mt) {
  return bits == 8 ? ks_of(mt) : ks_of(mt) / 2;   // stored rows a stage
}
// x's part of a stage: at 64 rows (wgmma) two 64-k blocks of 64 rows x
// 128 B in the 128-byte swizzle, each 1024-byte aligned; else padded rows
__host__ __device__ constexpr int xbytes(int mt) {
  return mt == 8 ? 64 * ks_of(mt) * 2 : mt * 8 * xstr(mt);
}
__host__ __device__ constexpr int stage_bytes(int bn, int bits, int mt) {
  return wrows(bits, mt) * wstr(bn, bits) + xbytes(mt);
}
__host__ __device__ constexpr int pstr(int bn) { return bn + 4; }

// The ring (1024-byte aligned at 64 rows), reused after the K loop as the
// (mt * 8, bn) fp32 partial tile
size_t smem_bytes(int bn, int bits, int mt) {
  const size_t ring = (size_t)stages_of(mt) * stage_bytes(bn, bits, mt);
  const size_t part = (size_t)mt * 8 * pstr(bn) * sizeof(float);
  return (ring > part ? ring : part) + (mt == 8 ? 1024 : 0);
}

}  // namespace tc

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
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t (&r)[2]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, in 16-byte units
__device__ __forceinline__ uint64_t sdesc(const void* p, uint32_t lbo,
                                          uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// d (64 x 64 fp32) += A (64 x 16, registers: each warp's 16 rows in the
// mma.sync A layout) . B (16 x 64, K-major in shared memory)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
// d += a (16x16, row) . b (16x8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// Byte j of two words whose bytes hold v + 128 -> bf16x2 (v of `lo`, v of
// `hi`), exactly: the byte permuted into 0x4B0000uu is the fp32 2^23 + u,
// minus 2^23 + 128 is v, and an integer of at most 8 significant bits
// keeps its fp32's low 16 bits zero, so the high half is its bf16.
template <int J>
__device__ __forceinline__ uint32_t u8x2_to_bf16(uint32_t lo, uint32_t hi) {
  const float a =
      __uint_as_float(__byte_perm(lo, 0x4B000000u, 0x7540 | J)) - 8388736.f;
  const float b =
      __uint_as_float(__byte_perm(hi, 0x4B000000u, 0x7540 | J)) - 8388736.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}
// Byte j of a packed int4 word (low nibble row 2r, high nibble 2r + 1,
// each sign-extended) -> bf16x2 (low, high), exactly (1.5 * 2^23 + v)
template <int J>
__device__ __forceinline__ uint32_t i4x2_to_bf16(uint32_t w) {
  const int lo = (int)(w << (28 - 8 * J)) >> 28;
  const int hi = (int)(w << (24 - 8 * J)) >> 28;
  const float a = __int_as_float(0x4B400000 + lo) - 12582912.f;
  const float b = __int_as_float(0x4B400000 + hi) - 12582912.f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// A lane's two A fragments of one k16 step (stage rows kk ..): the
// warp's 32 columns from 4 words of 4 columns, one per k row 2t, 2t + 1,
// 2t + 8, 2t + 9 (int4: the low and high nibble are rows 2t and 2t + 1,
// so 2 words serve); fragment f holds columns 4g + 2f (rows g) and 4g +
// 2f + 1 (rows g + 8), as exact bf16.
template <int BITS, int WS>
__device__ __forceinline__ void weight_frags(const unsigned char* st, int kk,
                                             int wn, int g, int t4,
                                             uint32_t (&a)[2][4]) {
  if (BITS == 8) {
    const unsigned char* wp = st + (kk + 2 * t4) * WS + wn * 32 + 4 * g;
    const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wp) ^ 0x80808080u;
    const uint32_t w1 =
        *reinterpret_cast<const uint32_t*>(wp + WS) ^ 0x80808080u;
    const uint32_t w2 =
        *reinterpret_cast<const uint32_t*>(wp + 8 * WS) ^ 0x80808080u;
    const uint32_t w3 =
        *reinterpret_cast<const uint32_t*>(wp + 9 * WS) ^ 0x80808080u;
    a[0][0] = u8x2_to_bf16<0>(w0, w1);
    a[0][1] = u8x2_to_bf16<1>(w0, w1);
    a[0][2] = u8x2_to_bf16<0>(w2, w3);
    a[0][3] = u8x2_to_bf16<1>(w2, w3);
    a[1][0] = u8x2_to_bf16<2>(w0, w1);
    a[1][1] = u8x2_to_bf16<3>(w0, w1);
    a[1][2] = u8x2_to_bf16<2>(w2, w3);
    a[1][3] = u8x2_to_bf16<3>(w2, w3);
  } else {
    const unsigned char* wp = st + (kk / 2 + t4) * WS + wn * 32 + 4 * g;
    const uint32_t wa = *reinterpret_cast<const uint32_t*>(wp);
    const uint32_t wb = *reinterpret_cast<const uint32_t*>(wp + 4 * WS);
    a[0][0] = i4x2_to_bf16<0>(wa);
    a[0][1] = i4x2_to_bf16<1>(wa);
    a[0][2] = i4x2_to_bf16<0>(wb);
    a[0][3] = i4x2_to_bf16<1>(wb);
    a[1][0] = i4x2_to_bf16<2>(wa);
    a[1][1] = i4x2_to_bf16<3>(wa);
    a[1][2] = i4x2_to_bf16<2>(wb);
    a[1][3] = i4x2_to_bf16<3>(wb);
  }
}

// One x row's 4 adjacent columns, scaled and rounded once to bf16: an
// 8-byte store when `vec` (N % 16 == 0), else up to `left` elements
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v,
                                       const float (&sc)[4], int vec,
                                       int left) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x * sc[0], v.y * sc[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z * sc[2], v.w * sc[3]);
  if (vec) {
    uint2 pk;
    pk.x = *reinterpret_cast<const uint32_t*>(&lo);
    pk.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(o) = pk;
  } else {
    o[0] = lo.x;
    if (left > 1) o[1] = lo.y;
    if (left > 2) o[2] = hi.x;
    if (left > 3) o[3] = hi.y;
  }
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One CTA: columns [n0, n0 + BN) over k in [kbeg, kend) for x rows [m0,
// m0 + 64). MT: m8 tiles of x rows (8 * MT >= the rows it takes); WN
// warps along N (32 columns each), 8 / WN along the k16 steps of a stage.
// `vec`: N % 16 == 0, K % 8 == 0, x and w 16-byte aligned (16-byte
// copies); otherwise the stages are filled by element loads.
template <int BITS, int MT>
__global__ void __launch_bounds__(tc::NT, 2)
qmatmul_tc_kernel(const __nv_bfloat16* __restrict__ x,
                  const int8_t* __restrict__ w,
                  const float* __restrict__ scale,
                  __nv_bfloat16* __restrict__ out, int M, int N, int K,
                  int kr, int vec) {
  constexpr int BN = tc::BN, WN = tc::WN, WK = tc::NW / WN, MP = MT * 8;
  constexpr int KS = tc::ks_of(MT), STAGES = tc::stages_of(MT);
  constexpr int XSTR = tc::xstr(MT);
  constexpr int WR = tc::wrows(BITS, MT), WS = tc::wstr(BN, BITS);
  constexpr int SB = tc::stage_bytes(BN, BITS, MT);
  constexpr int STEPS = KS / 16 / WK;   // k16 steps of a warp per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the wgmma x tile's 128-byte swizzle repeats every 1024 bytes
  unsigned char* sm = MT == 8 ? smem_raw + ((1024 - (smem_u32(smem_raw) &
                                                      1023)) & 1023)
                              : smem_raw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wn = warp % WN, wk = warp / WN;
  const int n0 = blockIdx.x * BN;
  const int kbeg = blockIdx.y * kr;
  const int kend = min(K, kbeg + kr);
  const int m0 = blockIdx.z * tc::MMAX;
  const int nkb = (kend - kbeg + KS - 1) / KS;
  // stored weight rows [r0, rend) of the split
  const int wr0 = BITS == 8 ? kbeg : kbeg / 2;
  const int wrend = BITS == 8 ? kend : (kend + 1) / 2;

  // byte offset of x's (row r, column c) in a stage's x tile: at 64 rows
  // 64-column blocks of 64 rows x 128 B, 16-byte chunk j of row r at
  // chunk j ^ (r % 8) (the 128-byte swizzle); else padded rows
  auto xoff = [](int r, int c) {
    return MT == 8 ? (c / 64) * 8192 + r * 128 +
                         ((((c % 64) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2
                   : r * XSTR + c * 2;
  };
  auto load_stage = [&](int kb, int buf) {
    unsigned char* st = sm + (size_t)buf * SB;
    unsigned char* xs = st + WR * WS;
    const int k0 = kbeg + kb * KS, r0 = wr0 + kb * WR;
    if (vec) {
      for (int i = tid; i < WR * (BN / 16); i += tc::NT) {
        const int r = i / (BN / 16), c = (i % (BN / 16)) * 16;
        const bool in = r0 + r < wrend && n0 + c < N;
        cp_async16(smem_u32(st + r * WS + c),
                   in ? w + (size_t)(r0 + r) * N + n0 + c : w, in ? 16 : 0);
      }
      for (int i = tid; i < MP * (KS / 8); i += tc::NT) {
        const int r = i / (KS / 8), c = (i % (KS / 8)) * 8;
        const bool in = m0 + r < M && k0 + c < kend;
        cp_async16(smem_u32(xs + xoff(r, c)),
                   in ? x + (size_t)(m0 + r) * K + k0 + c : x, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < WR * BN; i += tc::NT) {
        const int r = i / BN, c = i % BN;
        st[r * WS + c] = (r0 + r < wrend && n0 + c < N)
            ? (unsigned char)w[(size_t)(r0 + r) * N + n0 + c] : 0;
      }
      for (int i = tid; i < MP * KS; i += tc::NT) {
        const int r = i / KS, c = i % KS;
        *reinterpret_cast<__nv_bfloat16*>(xs + xoff(r, c)) =
            (m0 + r < M && k0 + c < kend)
                ? x[(size_t)(m0 + r) * K + k0 + c] : __float2bfloat16(0.f);
      }
    }
  };

  float acc[2][MT][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[f][mt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nkb) load_stage(s, s);
    cp_async_commit();
  }
  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<STAGES - 2>();
    // the copies (generic proxy) before the wgmma reads (async proxy)
    if (MT == 8) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();               // stage kb landed; stage kb - 1 is free
    const int nxt = kb + STAGES - 1;
    if (nxt < nkb) load_stage(nxt, nxt % STAGES);
    cp_async_commit();
    const unsigned char* st = sm + (size_t)(kb % STAGES) * SB;
    const uint32_t xs = smem_u32(st + WR * WS);
    if constexpr (MT == 8) {
      // wgmma m64n64k16: the warpgroup (this k-step group's 4 warps) holds
      // A, 64 weight columns per fragment set f, in registers; B is x^T
      // from the swizzled tile. All steps' A first, then the 2 x STEPS
      // wgmma in one group, waited for before the stage is refilled.
      uint32_t a[STEPS][2][4];
#pragma unroll
      for (int q = 0; q < STEPS; ++q)
        weight_frags<BITS, WS>(st, (q * WK + wk) * 16, wn, g, t4, a[q]);
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < STEPS; ++q) {
        const int kk = (q * WK + wk) * 16;
        const uint64_t db =
            sdesc(st + WR * WS + (kk / 64) * 8192 + (kk % 64) * 2, 16, 1024);
#pragma unroll
        for (int f = 0; f < 2; ++f)
          wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&acc[f][0][0]),
                       a[q][f], db);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < STEPS; ++q)
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            asm volatile("" : "+r"(a[q][f][i]) :: "memory");
    } else {
#pragma unroll
      for (int q = 0; q < STEPS; ++q) {
        const int kk = (q * WK + wk) * 16;   // the step's first stage row
        uint32_t a[2][4];                    // two A fragments (columns)
        weight_frags<BITS, WS>(st, kk, wn, g, t4, a);
        if (MT == 1) {
          uint32_t b[2];
          ldsm_x2(xs + (lane & 7) * XSTR +
                      (kk + ((lane >> 3) & 1) * 8) * 2, b);
          mma_bf16(acc[0][0], a[0], b[0], b[1]);
          mma_bf16(acc[1][0], a[1], b[0], b[1]);
        } else {
#pragma unroll
          for (int mt = 0; mt < MT; mt += 2) {
            uint32_t b[4];
            const int q8 = lane >> 3;
            ldsm_x4(xs + ((mt + (q8 >> 1)) * 8 + (lane & 7)) * XSTR +
                        (kk + (q8 & 1) * 8) * 2, b);
            mma_bf16(acc[0][mt], a[0], b[0], b[1]);
            mma_bf16(acc[1][mt], a[1], b[0], b[1]);
            mma_bf16(acc[0][mt + 1], a[0], b[2], b[3]);
            mma_bf16(acc[1][mt + 1], a[1], b[2], b[3]);
          }
        }
      }
    }
  }

  // ---- the k-step groups' sums. A lane holds, per m8 tile, columns 4g
  // .. 4g + 3 of its warp's 32 (f = 0: D rows g, g + 8 are columns 4g, 4g
  // + 1; f = 1: 4g + 2, 4g + 3) for x rows 2t and 2t + 1 (D columns), so
  // each row's 4 columns are one float4 of the (MP, BN) fp32 tile P in
  // shared memory. Groups WK - 1 .. 1 add into P in turn, group 0 adds P
  // to its own sums: a fixed order.
  cp_async_wait<0>();
  __syncthreads();
  float* P = reinterpret_cast<float*>(sm);
  constexpr int PS = tc::pstr(BN);
  const int cl = wn * 32 + 4 * g;        // the lane's first column
  float4 o[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      o[mt][r] = make_float4(acc[0][mt][r], acc[0][mt][r + 2],
                             acc[1][mt][r], acc[1][mt][r + 2]);
#pragma unroll
  for (int q = WK - 1; q >= 1; --q) {
    if (wk == q) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float4* p = reinterpret_cast<float4*>(
              P + (mt * 8 + 2 * t4 + r) * PS + cl);
          *p = q == WK - 1 ? o[mt][r] : add4(*p, o[mt][r]);
        }
    }
    __syncthreads();
  }
  if (WK > 1 && wk == 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        o[mt][r] = add4(o[mt][r], *reinterpret_cast<const float4*>(
                                      P + (mt * 8 + 2 * t4 + r) * PS + cl));
  }

  const int splits = gridDim.y;
  if (splits == 1) {                     // scale, round once, store
    const int n = n0 + cl;
    if (wk == 0 && n < N) {
      float sc[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j] = n + j < N ? scale[n + j] : 0.f;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int m = m0 + mt * 8 + 2 * t4 + r;
          if (m < M) store4(out + (size_t)m * N + n, o[mt][r], sc, vec, N - n);
        }
    }
    return;
  }
  // ---- K splits: each CTA's tile in P, then the cluster's CTAs take
  // interleaved row sets, a thread 4 columns of a row, and add the splits'
  // tiles in split order through distributed shared memory
  if (wk == 0) {                         // the lanes' own P entries
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<float4*>(P + (mt * 8 + 2 * t4 + r) * PS + cl) =
            o[mt][r];
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();                        // every split's P is written
  const int rank = (int)cluster.block_rank();
  constexpr int CG = BN / 4, RPP = tc::NT / CG;
  const int c = (tid % CG) * 4, n = n0 + c;
  if (n < N) {
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = n + j < N ? scale[n + j] : 0.f;
    for (int m = tid / CG + rank * RPP; m < MP && m0 + m < M;
         m += splits * RPP) {
      const int off = m * PS + c;
      float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(P, 0) + off);
      for (int q = 1; q < splits; ++q)
        v = add4(v, *reinterpret_cast<const float4*>(
                        cluster.map_shared_rank(P, q) + off));
      store4(out + (size_t)(m0 + m) * N + n, v, sc, vec, N - n);
    }
  }
  cluster.sync();                        // no CTA leaves while read
}

template <int BITS, int MT>
int launch_tc(const void* x, const int8_t* w, const float* scale, void* out,
              int M, int N, int K, int kr, int splits, int vec,
              cudaStream_t stream) {
  auto kern = qmatmul_tc_kernel<BITS, MT>;
  const size_t smem = tc::smem_bytes(tc::BN, BITS, MT);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + tc::BN - 1) / tc::BN, splits,
                     (M + tc::MMAX - 1) / tc::MMAX);
  cfg.blockDim = dim3(tc::NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = splits;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern,
                           static_cast<const __nv_bfloat16*>(x), w, scale,
                           static_cast<__nv_bfloat16*>(out), M, N, K, kr,
                           vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BITS>
int launch_tc_m(const void* x, const int8_t* w, const float* scale,
                void* out, int M, int N, int K, int kr, int splits, int vec,
                cudaStream_t stream) {
  const int mt = tc_mtiles(M);
  if (mt == 1)
    return launch_tc<BITS, 1>(x, w, scale, out, M, N, K, kr, splits, vec,
                              stream);
  if (mt == 2)
    return launch_tc<BITS, 2>(x, w, scale, out, M, N, K, kr, splits, vec,
                              stream);
  if (mt == 4)
    return launch_tc<BITS, 4>(x, w, scale, out, M, N, K, kr, splits, vec,
                              stream);
  return launch_tc<BITS, 8>(x, w, scale, out, M, N, K, kr, splits, vec,
                            stream);
}

}  // namespace

extern "C" {

size_t qmatmul_smem_bytes(int kr, int bits) { return smem_bytes(kr, bits); }

size_t qmatmul_tc_smem_bytes(int bits, int M) {
  return tc::smem_bytes(tc::BN, bits, tc_mtiles(M));
}

// CUDA-core kernel. dtype: 0 = fp32, 1 = bf16 (x and out); bits: 8 or 4.
// `kr` (even) is the x columns per K split and `splits` = ceil(K / kr);
// with more than one split `part` is an fp32 (splits, M, N) workspace.
// `vec` says that N % 16 == 0 and w is 16-byte aligned. Returns the
// cudaError_t of the launches (0 on success); launches on `stream` and
// does not synchronise.
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

// Tensor-core kernel, bf16 x and out; bits: 8 or 4. `kr` (a multiple of
// 64) is the x columns per K split, `splits` = ceil(K / kr), at most 8
// (the CTAs of one cluster); `vec` says that N % 16 == 0, K % 8 == 0 and
// x and w are 16-byte aligned.
// Returns the cudaError_t of the launch (0 on success); launches on
// `stream` and does not synchronise.
int qmatmul_tc_launch(const void* x, const void* w, const void* scale,
                      void* out, int M, int N, int K, int bits, int kr,
                      int splits, int vec, void* stream) {
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1 || kr < tc::KGRAN || kr % tc::KGRAN ||
      splits < 1 || splits > tc::MAX_SPLITS ||
      (long long)kr * splits < K || (long long)kr * (splits - 1) >= K)
    return (int)cudaErrorInvalidValue;
  if (bits == 8)
    return launch_tc_m<8>(x, wq, s, out, M, N, K, kr, splits, vec, st);
  if (bits == 4)
    return launch_tc_m<4>(x, wq, s, out, M, N, K, kr, splits, vec, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
