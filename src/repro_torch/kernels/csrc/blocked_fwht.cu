// blocked_fwht.cu: the unnormalized Walsh-Hadamard transform H (signs * X).
//
// Replaces the Pallas TPU kernel src/repro/kernels/hadamard.py::blocked_fwht
// (bodies _stage1_kernel and _stage2_kernel). X is (d, ncols) with row
// stride ld, float32 or bf16; signs is (d,) float32; out is (dp, ncols)
// float32, contiguous, with dp = 2^log_dp >= d. Rows d..dp-1 of the input
// read as zero (a masked read, so the caller never pads a copy), and X may
// be a column slice of a wider matrix. H is the Sylvester Hadamard matrix.
//
// What bounds it on an H100: bytes. One read of X and one write of the
// output are 2 * dp * ncols * 4 bytes for float32 (15.6 ms at dp = 65,536
// and 100,000 columns at 3.35 TB/s), while the butterfly's dp * log2(dp)
// adds per column take a tenth of that at 67 TFLOP/s.
//
// Design: the TPU kernel multiplies by dense Hadamard tiles because the MXU
// makes that free; on SIMT cores that form would cost 2 * d * (a + b) FMAs
// per column, about 8e12 at the slice's shape. Here the transform is a
// butterfly, split as the Pallas kernel splits it, d = L_1 * L_2 * ...:
//  * Pass t transforms along one radix L_t = 2^l_t <= 256 of the row
//    index, whose elements lie s_t = L_1 ... L_{t-1} rows apart. A CTA owns
//    one group of L_t rows and 32 columns (one per lane, 128-byte runs of a
//    row), so every element is read once and written once per pass, with no
//    atomics: deterministic.
//  * Inside a CTA, each thread first holds R = 2^ceil(l/2) elements of its
//    column that lie next to each other in the radix and does the small
//    spans in registers; one exchange through shared memory regroups the
//    column so that each thread holds R elements L/R apart, and the large
//    spans are done in registers too.
//  * Pass 1 (stride 1, the Pallas kernel's stage 1) fuses the sign flip and
//    the zero rows past d into its read; later passes (stage 2) work in
//    place on the output, which is safe because a CTA reads all its
//    elements before it writes any and no two CTAs share one.
//  * d <= 256 is one pass (the Pallas kernel's a = 1); 65,536 is two
//    passes of 256; more rows take more passes.
//  * Butterfly spans go 1, 2, 4, ... in order, as in the plain butterfly, so
//    the float32 result equals the plain version's bit for bit.
// Not yet done: tensor cores, TMA, and keeping the intermediate on chip.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;          // columns per CTA: one per lane
constexpr int MAX_LOG_RADIX = 8;  // a pass transforms at most 256 rows

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int LOG_L>
struct Radix {
  static constexpr int L = 1 << LOG_L;
  static constexpr int LOG_R = (LOG_L + 1) / 2;
  static constexpr int R = 1 << LOG_R;  // elements a thread holds
  static constexpr int WARPS = L / R;   // never more than R
  static constexpr int THREADS = WARPS * 32;
};

template <int R>
__device__ __forceinline__ void butterflies(float (&v)[R], int first_span) {
#pragma unroll
  for (int h = first_span; h < R; h <<= 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if ((i & h) == 0) {
        const float a = v[i];
        const float b = v[i + h];
        v[i] = a + b;
        v[i + h] = a - b;
      }
    }
  }
}

// One radix-L pass. Row of element e of group g: hi * L * stride + e * stride
// + lo with lo = g % stride, hi = g / stride. FIRST reads X (ld_in, rows
// below d_valid, times signs); later passes read and write out in place.
template <int LOG_L, bool FIRST, typename Tin>
__global__ void __launch_bounds__(Radix<LOG_L>::THREADS)
fwht_pass(const Tin* in, int64_t ld_in, const float* __restrict__ signs,
          int64_t d_valid, float* out, int64_t ncols, int64_t stride,
          int64_t col_tiles) {
  using Rd = Radix<LOG_L>;
  constexpr int L = Rd::L;
  constexpr int R = Rd::R;
  constexpr int WARPS = Rd::WARPS;
  __shared__ float tile[L][COLS];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t group = blockIdx.x / col_tiles;
  const int64_t col = (blockIdx.x % col_tiles) * COLS + lane;
  const bool live = col < ncols;
  const int64_t base = (group / stride) * L * stride + group % stride;

  float v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t row = base + (int64_t)(w * R + i) * stride;
    float x = 0.f;
    if (FIRST) {
      if (live && row < d_valid) x = to_f32(in[row * ld_in + col]) * signs[row];
    } else if (live) {
      x = to_f32(in[row * ld_in + col]);
    }
    v[i] = x;
  }
  butterflies<R>(v, 1);  // spans 1 .. R/2 of the radix

  if constexpr (WARPS > 1) {
#pragma unroll
    for (int i = 0; i < R; ++i) tile[w * R + i][lane] = v[i];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) v[j] = tile[w + WARPS * j][lane];
    // element e = w + WARPS * j: a span of h in e is h / WARPS in j, and
    // spans R .. L/2 remain
    butterflies<R>(v, R / WARPS);
    if (live) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        out[(base + (int64_t)(w + WARPS * j) * stride) * ncols + col] = v[j];
    }
  } else {
    if (live) {
#pragma unroll
      for (int i = 0; i < R; ++i)
        out[(base + (int64_t)i * stride) * ncols + col] = v[i];
    }
  }
}

template <int LOG_L, bool FIRST, typename Tin>
int launch_radix(const Tin* in, int64_t ld_in, const float* signs,
                 int64_t d_valid, float* out, int64_t ncols, int64_t stride,
                 int64_t groups, cudaStream_t s) {
  const int64_t col_tiles = (ncols + COLS - 1) / COLS;
  const int64_t blocks = groups * col_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fwht_pass<LOG_L, FIRST, Tin><<<(unsigned)blocks, Radix<LOG_L>::THREADS, 0,
                                 s>>>(in, ld_in, signs, d_valid, out, ncols,
                                      stride, col_tiles);
  return (int)cudaGetLastError();
}

template <bool FIRST, typename Tin>
int launch_pass(int log_l, const Tin* in, int64_t ld_in, const float* signs,
                int64_t d_valid, float* out, int64_t ncols, int64_t stride,
                int64_t groups, cudaStream_t s) {
  switch (log_l) {
#define FWHT_CASE(n)                                                        \
  case n:                                                                   \
    return launch_radix<n, FIRST, Tin>(in, ld_in, signs, d_valid, out,      \
                                       ncols, stride, groups, s);
    FWHT_CASE(0) FWHT_CASE(1) FWHT_CASE(2) FWHT_CASE(3) FWHT_CASE(4)
    FWHT_CASE(5) FWHT_CASE(6) FWHT_CASE(7) FWHT_CASE(8)
#undef FWHT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Tin>
int run(const Tin* X, int64_t ld, const float* signs, int64_t d_valid,
        int64_t log_dp, float* out, int64_t ncols, void* stream) {
  if (log_dp < 0 || log_dp > 40) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int passes =
      log_dp == 0 ? 1 : (int)((log_dp + MAX_LOG_RADIX - 1) / MAX_LOG_RADIX);
  int done = 0;
  int64_t stride = 1;
  for (int p = 0; p < passes; ++p) {
    // split log_dp as evenly as the passes allow, larger radices first
    const int left = passes - p;
    const int log_l = ((int)log_dp - done + left - 1) / left;
    const int64_t groups = (int64_t)1 << (log_dp - log_l);
    const int err =
        p == 0 ? launch_pass<true, Tin>(log_l, X, ld, signs, d_valid, out,
                                        ncols, stride, groups, s)
               : launch_pass<false, float>(log_l, out, ncols, signs, d_valid,
                                           out, ncols, stride, groups, s);
    if (err) return err;
    done += log_l;
    stride <<= log_l;
  }
  return 0;
}

}  // namespace

// Plain C entry points for ctypes. Each returns the first cudaError_t of its
// launches (0 on success); it neither synchronises nor allocates.
extern "C" int blocked_fwht_f32(const float* X, int64_t ld,
                                const float* signs, int64_t d_valid,
                                int64_t log_dp, float* out, int64_t ncols,
                                void* stream) {
  return run<float>(X, ld, signs, d_valid, log_dp, out, ncols, stream);
}

extern "C" int blocked_fwht_bf16(const __nv_bfloat16* X, int64_t ld,
                                 const float* signs, int64_t d_valid,
                                 int64_t log_dp, float* out, int64_t ncols,
                                 void* stream) {
  return run<__nv_bfloat16>(X, ld, signs, d_valid, log_dp, out, ncols,
                            stream);
}
