// blocked_fwht.cu: the unnormalized Walsh-Hadamard transform H (signs * X),
// and the SRHT block mode that keeps only the k sampled rows of it.
//
// Replaces the Pallas TPU kernel src/repro/kernels/hadamard.py::blocked_fwht
// (bodies _stage1_kernel and _stage2_kernel). X is (d, ncols) with row
// stride ld, float32 or bf16; signs is (d,) float32; dp = 2^log_dp >= d.
// Rows d..dp-1 of the input read as zero (a masked read, so the caller
// never pads a copy), and X may be a column slice of a wider matrix. H is
// the Sylvester Hadamard matrix.
//
// Two entry points share the passes:
//  * full mode (blocked_fwht_*): the TPU kernel's function, the (dp, ncols)
//    float32 transform. Bound on an H100: bytes, one read of X and one
//    write of the output, 2 * dp * ncols * 4 bytes for float32 (15.6 ms at
//    dp = 65,536 and 100,000 columns at 3.35 TB/s); the butterfly's
//    dp * log2(dp) adds per column take a tenth of that at 67 TFLOP/s.
//  * SRHT block mode (srht_block_*): what the SRHT pass keeps of it, the k
//    sampled rows (H (signs * X))[rows] / sqrt(dp) * sqrt(dp / k), written
//    straight into a (k, .) sketch at a column offset, and X's column norms.
//    Bound: bytes, X and signs read once, k rows and ncols norms written
//    once, 4 * (d * ncols + d + k * ncols + ncols) bytes (0.494 ms at d =
//    50,000, 8,192 columns, k = 512).
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
//    place, which is safe because a CTA reads all its elements before it
//    writes any and no two CTAs share one.
//  * d <= 256 is one pass (the Pallas kernel's a = 1); 65,536 is two
//    passes of 256; more rows take more passes.
//  * Butterfly spans go 1, 2, 4, ... in order, as in the plain butterfly, so
//    the float32 result equals the plain version's bit for bit.
//  * Every pass skips what is zero: a group whose rows all lie past d, or
//    whose elements earlier passes made from such rows alone, reads and
//    writes nothing (at dp = 65,536 and d = 50,000, 23% of the
//    intermediate).
// The block mode adds two things to the same passes:
//  * its last pass runs the butterfly as the full mode does, puts the
//    group's results in shared memory and stores only the sampled rows,
//    rescaled with the plain composition's two IEEE roundings (__fdiv_rn,
//    __fmul_rn): the sketch equals the full transform's rows bit for bit.
//    A last-pass group that holds no sampled row reads nothing. Its (dp, w)
//    write becomes a (k, w) write.
//  * pass 1 adds the squares of the X it reads, a thread's in float32, the
//    CTA's in float64, per column (a fixed order, no atomics), into a
//    scratch buffer of (dp / L_1, ncols) partials; a last small kernel adds
//    each column's partials in group order and writes the square root:
//    deterministic.
// The intermediate still goes to device memory and back between the
// passes: taking the columns through all passes in chunks small enough for
// L2, and a persisting-L2 window on the scratch, were both slower at the
// call shape (variants in tools/blocked_fwht_probe.py).
// Not yet done: tensor cores, TMA, one launch for both passes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int COLS = 32;          // columns per CTA: one per lane
constexpr int MAX_LOG_RADIX = 8;  // a pass transforms at most 256 rows
// CTAs an SM that the launch bounds ask for: three CTAs of 512 threads
// (radix 256) cap a thread at 40 registers. The block mode's first pass,
// with its float64 sums, took 44 and ran two CTAs an SM; at three the
// block call is 6% faster, at four (32 registers) 3%
// (tools/blocked_fwht_probe.py).
constexpr int MIN_CTAS = 3;

// What a pass does besides its butterfly: bits of its MODE.
constexpr int READ_X = 1;   // read X: row stride ld, signs, rows >= d zero
constexpr int NORMS = 2;    // add X's squares into per-CTA float64 partials
constexpr int SAMPLED = 4;  // last pass: store only the sampled rows, scaled

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

struct PassArgs {
  const void* in;       // READ_X: X (Tin); else the float32 intermediate
  int64_t ld_in;
  const float* signs;   // READ_X
  int64_t d_valid;      // READ_X: rows at or past it read as zero
  float* out;           // without SAMPLED: (dp, ncols) with row stride ld_out
  int64_t ld_out;
  int64_t ncols;
  int64_t stride;       // rows between a group's elements
  int64_t col_tiles;
  double* partial;      // NORMS: (groups, .) sums, row stride ld_partial
  int64_t ld_partial;
  const int32_t* rows;  // SAMPLED: the k sampled rows, each in [0, dp)
  int64_t k;
  float root_dp;        // SAMPLED: sqrt(dp) and sqrt(dp / k), float32
  float root_dp_k;
  float* sketch;        // SAMPLED: sampled row j at sketch + j * ld_sketch
  int64_t ld_sketch;
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
// + lo with lo = g % stride, hi = g / stride. A SAMPLED pass is a last pass
// (hi = 0), so sampled row r lies in group r % stride, element r / stride.
template <int LOG_L, int MODE, typename Tin>
__global__ void __launch_bounds__(Radix<LOG_L>::THREADS, MIN_CTAS)
fwht_pass(const PassArgs a) {
  using Rd = Radix<LOG_L>;
  constexpr int L = Rd::L;
  constexpr int R = Rd::R;
  constexpr int WARPS = Rd::WARPS;
  __shared__ float tile[L][COLS];
  __shared__ double sums[(MODE & NORMS) ? WARPS : 1][COLS];

  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t group = blockIdx.x / a.col_tiles;
  const int64_t col0 = (blockIdx.x % a.col_tiles) * COLS;
  const int64_t col = col0 + lane;
  const bool live = col < a.ncols;
  const int64_t hi = group / a.stride;
  const int64_t base = hi * L * a.stride + group % a.stride;
  // Rows at or past d read as zero, and so does every block of stride rows
  // that the earlier passes made from such rows alone: element e of this
  // group is zero when its block, (hi * L + e) * stride, starts at or past
  // d. A group whose every element is zero reads and writes nothing (no
  // later pass reads its rows: they are zero to it by the same rule).
  if (hi * L * a.stride >= a.d_valid) return;  // uniform across the CTA

  if constexpr ((MODE & SAMPLED) != 0 && (MODE & NORMS) == 0) {
    bool mine = false;  // does this group hold a sampled row?
    for (int64_t j = threadIdx.x; j < a.k; j += Rd::THREADS)
      mine |= (a.rows[j] & (a.stride - 1)) == group;
    if (!__syncthreads_or(mine)) return;  // uniform across the CTA
  }

  float v[R];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t e = w * R + i;
    const int64_t row = base + e * a.stride;
    float x = 0.f;
    if constexpr ((MODE & READ_X) != 0) {
      if (live && row < a.d_valid) {
        const float xi =
            to_f32(static_cast<const Tin*>(a.in)[row * a.ld_in + col]);
        if constexpr ((MODE & NORMS) != 0) ss = fmaf(xi, xi, ss);
        x = xi * a.signs[row];
      }
    } else if (live && (hi * L + e) * a.stride < a.d_valid) {
      x = static_cast<const float*>(a.in)[row * a.ld_in + col];
    }
    v[i] = x;
  }

  if constexpr ((MODE & NORMS) != 0) {
    // a thread's R squares summed in float32, then the warps' sums in
    // order and (in norms_finish) the groups' in order in float64: a fixed
    // order, and the long sums without float32 rounding
    sums[w][lane] = ss;
    __syncthreads();
    if (w == 0 && live) {
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) s += sums[i][lane];
      a.partial[group * a.ld_partial + col] = s;
    }
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
  }

  if constexpr ((MODE & SAMPLED) != 0) {
    // the group's results by element, then each sampled row of the group
    // stored by one thread: a few per CTA
    if constexpr (WARPS > 1) {
      __syncthreads();  // every thread has read its exchange elements
#pragma unroll
      for (int j = 0; j < R; ++j) tile[w + WARPS * j][lane] = v[j];
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i) tile[i][lane] = v[i];
    }
    __syncthreads();
    const int width = a.ncols - col0 < COLS ? (int)(a.ncols - col0) : COLS;
    for (int64_t j = threadIdx.x; j < a.k; j += Rd::THREADS) {
      const int64_t row = a.rows[j];
      const int64_t e = row / a.stride;
      if ((row & (a.stride - 1)) != group || row < 0 || e >= L) continue;
      float* dst = a.sketch + j * a.ld_sketch + col0;
      for (int c = 0; c < width; ++c)
        dst[c] = __fmul_rn(__fdiv_rn(tile[e][c], a.root_dp), a.root_dp_k);
    }
  } else if (live) {
    if constexpr (WARPS > 1) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        a.out[(base + (int64_t)(w + WARPS * j) * a.stride) * a.ld_out + col] =
            v[j];
    } else {
#pragma unroll
      for (int i = 0; i < R; ++i)
        a.out[(base + (int64_t)i * a.stride) * a.ld_out + col] = v[i];
    }
  }
}

// Each column's partial sums of squares, added in group order; the norm is
// the square root of their float32 rounding.
__global__ void norms_finish(const double* __restrict__ partial,
                             int64_t groups, int64_t ncols,
                             float* __restrict__ norms) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= ncols) return;
  double s = 0.0;
  for (int64_t g = 0; g < groups; ++g) s += partial[g * ncols + col];
  norms[col] = sqrtf((float)s);
}

template <int LOG_L, int MODE, typename Tin>
int launch_radix(PassArgs a, int64_t groups, cudaStream_t s) {
  a.col_tiles = (a.ncols + COLS - 1) / COLS;
  const int64_t blocks = groups * a.col_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  fwht_pass<LOG_L, MODE, Tin>
      <<<(unsigned)blocks, Radix<LOG_L>::THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE, typename Tin>
int launch_pass(int log_l, const PassArgs& a, int64_t groups,
                cudaStream_t s) {
  switch (log_l) {
#define FWHT_CASE(n) \
  case n:            \
    return launch_radix<n, MODE, Tin>(a, groups, s);
    FWHT_CASE(0) FWHT_CASE(1) FWHT_CASE(2) FWHT_CASE(3) FWHT_CASE(4)
    FWHT_CASE(5) FWHT_CASE(6) FWHT_CASE(7) FWHT_CASE(8)
#undef FWHT_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// The passes' radices: log_dp split as evenly as the passes allow, larger
// radices first. Returns the number of passes.
int split(int64_t log_dp, int (&log_l)[8]) {
  const int passes =
      log_dp == 0 ? 1 : (int)((log_dp + MAX_LOG_RADIX - 1) / MAX_LOG_RADIX);
  int done = 0;
  for (int p = 0; p < passes; ++p) {
    const int left = passes - p;
    log_l[p] = ((int)log_dp - done + left - 1) / left;
    done += log_l[p];
  }
  return passes;
}

template <typename Tin>
int run(const Tin* X, int64_t ld, const float* signs, int64_t d_valid,
        int64_t log_dp, float* out, int64_t ncols, void* stream) {
  if (log_dp < 0 || log_dp > 40) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int log_l[8];
  const int passes = split(log_dp, log_l);
  PassArgs a = {};
  a.signs = signs;
  a.d_valid = d_valid;
  a.out = out;
  a.ld_out = ncols;
  a.ncols = ncols;
  a.stride = 1;
  for (int p = 0; p < passes; ++p) {
    const int64_t groups = (int64_t)1 << (log_dp - log_l[p]);
    int err;
    if (p == 0) {
      a.in = X;
      a.ld_in = ld;
      err = launch_pass<READ_X, Tin>(log_l[p], a, groups, s);
    } else {
      a.in = out;
      a.ld_in = ncols;
      err = launch_pass<0, float>(log_l[p], a, groups, s);
    }
    if (err) return err;
    a.stride <<= log_l[p];
  }
  return 0;
}

// The SRHT block mode over ncols columns, through scratch ((dp, ncols)
// float32; unused with one pass) and partial ((dp / L_1, ncols) float64).
template <typename Tin>
int run_block(const Tin* X, int64_t ld, const float* signs, int64_t d_valid,
              int64_t log_dp, const int32_t* rows, int64_t k, float root_dp,
              float root_dp_k, float* sketch, int64_t ld_sketch, float* norms,
              int64_t ncols, float* scratch, double* partial, void* stream) {
  if (log_dp < 0 || log_dp > 40) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int log_l[8];
  const int passes = split(log_dp, log_l);
  // pass-1 groups that hold a row below d (the others add nothing)
  const int64_t groups1 = (d_valid + (1 << log_l[0]) - 1) >> log_l[0];
  PassArgs a = {};
  a.signs = signs;
  a.d_valid = d_valid;
  a.ncols = ncols;
  a.out = scratch;
  a.ld_out = ncols;
  a.partial = partial;
  a.ld_partial = ncols;
  a.rows = rows;
  a.k = k;
  a.root_dp = root_dp;
  a.root_dp_k = root_dp_k;
  a.sketch = sketch;
  a.ld_sketch = ld_sketch;
  a.stride = 1;
  for (int p = 0; p < passes; ++p) {
    const int64_t groups = (int64_t)1 << (log_dp - log_l[p]);
    const bool last = p == passes - 1;
    int err;
    if (p == 0) {
      a.in = X;
      a.ld_in = ld;
      err = last ? launch_pass<READ_X | NORMS | SAMPLED, Tin>(log_l[p], a,
                                                              groups, s)
                 : launch_pass<READ_X | NORMS, Tin>(log_l[p], a, groups, s);
    } else {
      a.in = scratch;
      a.ld_in = ncols;
      err = last ? launch_pass<SAMPLED, float>(log_l[p], a, groups, s)
                 : launch_pass<0, float>(log_l[p], a, groups, s);
    }
    if (err) return err;
    a.stride <<= log_l[p];
  }
  norms_finish<<<(unsigned)((ncols + 255) / 256), 256, 0, s>>>(
      partial, groups1, ncols, norms);
  return (int)cudaGetLastError();
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

extern "C" int srht_block_f32(const float* X, int64_t ld, const float* signs,
                              int64_t d_valid, int64_t log_dp,
                              const int32_t* rows, int64_t k, float root_dp,
                              float root_dp_k, float* sketch,
                              int64_t ld_sketch, float* norms, int64_t ncols,
                              float* scratch, double* partial,
                              void* stream) {
  return run_block<float>(X, ld, signs, d_valid, log_dp, rows, k, root_dp,
                          root_dp_k, sketch, ld_sketch, norms, ncols, scratch,
                          partial, stream);
}

extern "C" int srht_block_bf16(const __nv_bfloat16* X, int64_t ld,
                               const float* signs, int64_t d_valid,
                               int64_t log_dp, const int32_t* rows, int64_t k,
                               float root_dp, float root_dp_k, float* sketch,
                               int64_t ld_sketch, float* norms, int64_t ncols,
                               float* scratch, double* partial,
                               void* stream) {
  return run_block<__nv_bfloat16>(X, ld, signs, d_valid, log_dp, rows, k,
                                  root_dp, root_dp_k, sketch, ld_sketch,
                                  norms, ncols, scratch, partial, stream);
}
