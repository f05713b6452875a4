// Row scatter with dropped writes, for the paged KV arena's tick writes.
//
//   dst[i0[w], i1[w], :] = src[w, :]   for every write w in [0, n),
//
// except that a write whose i0 lies outside [0, n0) or whose i1 lies
// outside [0, n1) is dropped: the reference's `.at[i0, i1].set(v,
// mode="drop")` (repro/models/lm/attention.py, mla.py), where the index
// math (paged_indices) marks a pad token or an unassigned block with the
// out-of-range sentinel wblk == n_blocks and its position column with
// lw == Leff. The number of writes is the tick's fixed B * C, so the
// launch has one shape for every tick of a plan bucket and a CUDA graph
// can hold it.
//
// dst is a contiguous (n0, n1, row_bytes) table and src a contiguous
// (n, row_bytes) one; a row is raw bytes, so one kernel serves every
// arena dtype (bf16, fp16, fp8, int8), the fp32 int8 scales and the
// int32 positions. One CTA a write copies its row in the widest word
// (16, 8, 4, 2 or 1 bytes) that the row length and both base pointers
// allow; a dropped write's CTA returns before touching memory.
//
// Port-only kernel: the TPU reference scatters inside its jitted step
// (XLA's scatter), so it replaces no Pallas kernel.

#include <cuda_runtime.h>
#include <stdint.h>

template <typename W>
__global__ void scatter_rows_kernel(W* __restrict__ dst,
                                    const W* __restrict__ src,
                                    const int64_t* __restrict__ i0,
                                    const int64_t* __restrict__ i1,
                                    int64_t n0, int64_t n1,
                                    int64_t row_words) {
  const int64_t w = blockIdx.x;
  const int64_t a = i0[w];
  const int64_t b = i1[w];
  if (a < 0 || a >= n0 || b < 0 || b >= n1) return;     // dropped write
  W* d = dst + (a * n1 + b) * row_words;
  const W* s = src + w * row_words;
  for (int64_t j = threadIdx.x; j < row_words; j += blockDim.x) d[j] = s[j];
}

template <typename W>
static cudaError_t launch(void* dst, const void* src, const void* i0,
                          const void* i1, int n, int64_t n0, int64_t n1,
                          int64_t row_bytes, cudaStream_t s) {
  const int64_t words = row_bytes / static_cast<int64_t>(sizeof(W));
  int threads = 32;
  while (threads < 256 && threads < words) threads *= 2;
  scatter_rows_kernel<W><<<n, threads, 0, s>>>(
      static_cast<W*>(dst), static_cast<const W*>(src),
      static_cast<const int64_t*>(i0), static_cast<const int64_t*>(i1), n0,
      n1, words);
  return cudaGetLastError();
}

extern "C" {

// The word size a launch copies in: the widest of 16, 8, 4, 2, 1 bytes
// that divides row_bytes and both base addresses.
int scatter_rows_word(const void* dst, const void* src, int64_t row_bytes) {
  const uint64_t m = reinterpret_cast<uint64_t>(dst) |
                     reinterpret_cast<uint64_t>(src) |
                     static_cast<uint64_t>(row_bytes);
  for (int w = 16; w > 1; w /= 2)
    if (m % w == 0) return w;
  return 1;
}

// dst (n0, n1, row_bytes) and src (n, row_bytes) contiguous on the card;
// i0, i1 (n,) int64. Returns the cudaError_t of the launch (0 on
// success). Launches on `stream`; does not synchronise. n == 0 launches
// nothing.
int scatter_rows_launch(void* dst, const void* src, const void* i0,
                        const void* i1, int n, int64_t n0, int64_t n1,
                        int64_t row_bytes, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (scatter_rows_word(dst, src, row_bytes)) {
    case 16: return launch<uint4>(dst, src, i0, i1, n, n0, n1, row_bytes, s);
    case 8: return launch<uint2>(dst, src, i0, i1, n, n0, n1, row_bytes, s);
    case 4: return launch<uint32_t>(dst, src, i0, i1, n, n0, n1, row_bytes, s);
    case 2: return launch<uint16_t>(dst, src, i0, i1, n, n0, n1, row_bytes, s);
    default: return launch<uint8_t>(dst, src, i0, i1, n, n0, n1, row_bytes, s);
  }
}

}  // extern "C"
