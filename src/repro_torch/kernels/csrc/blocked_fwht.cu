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
// The block mode takes one of two forms, by shape (``hadamard.block_plan``
// decides and the entry point's ``cluster`` argument says which):
//  * the cluster form (srht_cluster), where dp takes two passes (512 <= dp
//    <= 65,536) and the live intermediate fits on chip: one launch, and the
//    intermediate never goes to device memory. A thread block cluster of
//    CLUSTER_CTAS = N CTAs, one an SM, owns a strip of CLUSTER_COLS = C
//    columns; a persistent grid of as many clusters as the card holds (15
//    of 8 on an H100) walks the strips. Row lo of a pass-1 block of L1 rows
//    belongs to CTA lo % N, whose z holds it for every live block e'.
//    Phase 1: a producer thread streams CTA q's blocks e' = q, q + N, ...
//    (L1 rows by C columns each) from X by 2-D TMA copies into a
//    CLUSTER_STAGES-deep ring with full and empty mbarriers (rows past d
//    and columns past n come back zero); consumer warps, a thread R1 = 8
//    rows of one column, do the sign flip, the squares for the norms and
//    pass 1's spans 1 .. R1/2 in registers, release the slot and store each
//    row into its owner's z through distributed shared memory. No barrier
//    spans the CTA, so the stream, the arithmetic and the stores overlap.
//    After a cluster barrier, phase 2 works on chip in three loops of
//    independent tasks: pass 1's spans R1 .. L1/2 in place; pass 2's spans
//    over the first R2 blocks' bits, for the lo values that hold a sampled
//    row; and its last spans for the sampled rows alone, each stored
//    rescaled with the same two roundings. Blocks past the live ones read
//    as zero, as in the two-pass form, and the spans run in the plain
//    butterfly's order, so the sketch is the plain composition's bit for
//    bit. The norms: a thread's squares in float32, its blocks' sums, then
//    a warp's, the CTA's and the cluster's in float64 in a fixed order
//    (rank 0 reads the others' through distributed shared memory): no
//    scratch, no atomics, no second kernel. Where X's base or row stride is
//    not 16-byte aligned, the same kernel reads its tiles by element copies
//    in place of TMA. At d = 50,000, dp = 65,536 the strip's 196 live
//    blocks take 200,704 bytes a CTA of the 227 KB. Bank conflicts: the
//    first loads of a run go in an order rotated by t mod 4, and z's 32-byte
//    column groups are permuted by (t + e' + e' / 16) mod 4 (zcol).
//    What bounds it: X's 32-byte row pieces stream at about 1.7 TB/s
//    through TMA at this occupancy (tools/blocked_fwht_probe.py,
//    stream_only), the distributed shared memory stores of phase 1 and the
//    on-chip phase 2, during which the card reads only the next strip's
//    first tiles.
//  * the two-pass form (fwht_pass in block mode, then norms_finish), for
//    every other shape: the passes below, its intermediate through a
//    (dp, n) float32 scratch in device memory. Its last pass runs the
//    butterfly as the full mode does, puts the group's results in shared
//    memory and stores only the sampled rows, rescaled with the plain
//    composition's two IEEE roundings (__fdiv_rn, __fmul_rn); a last-pass
//    group that holds no sampled row reads nothing. Its pass 1 adds the
//    squares of the X it reads, a thread's in float32, the CTA's in
//    float64, per column, into (dp / L_1, n) partials, and norms_finish
//    adds each column's partials in group order and writes the root.
// The full mode still runs its passes through device memory. Taking the
// columns through all passes in L2-sized chunks, and a persisting-L2 window
// on the scratch, were both slower than the two-pass form at the call
// shape; the variants of both forms are in tools/blocked_fwht_probe.py.
// Not yet done: tensor cores, and the full mode in one launch.

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // cudaGetDriverEntryPoint, so libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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

// ---------------------------------------------------------------------------
// The cluster form of the block mode (see the header).

constexpr int CLUSTER_COLS = 8;        // C: a strip's columns
constexpr int CLUSTER_CTAS = 8;        // N: CTAs a cluster (the portable most)
constexpr int CLUSTER_THREADS = 512;   // threads a CTA
constexpr int CLUSTER_STAGES = 3;      // TMA tiles a CTA holds in its ring
constexpr int CLUSTER_LOG_RUN = 3;     // log2 of the most rows a phase-1
                                       // thread holds (R1)
constexpr bool CLUSTER_PERSISTENT = true;  // a grid of resident clusters
                                            // that walks the strips
constexpr int SMEM_MAX = 232448;       // dynamic shared memory a CTA may take
constexpr CUtensorMapL2promotion TMA_PROMOTION =
    CU_TENSOR_MAP_L2_PROMOTION_L2_256B;

constexpr int cmin(int a, int b) { return a < b ? a : b; }

// The cluster form's shapes at pass radices L1 = 2^LOG_L1 (pass 1, rows
// next to each other) and L2 = 2^LOG_L2 (pass 2, rows L1 apart).
template <typename Tin, int LOG_L1, int LOG_L2>
struct Cluster {
  static constexpr int L1 = 1 << LOG_L1;
  static constexpr int L2 = 1 << LOG_L2;
  static constexpr int C = CLUSTER_COLS;
  static constexpr int N = CLUSTER_CTAS;
  static constexpr int THREADS = CLUSTER_THREADS;
  static constexpr int S = CLUSTER_STAGES;
  // pass 1: a thread holds R1 rows of a column next to each other (spans
  // 1 .. R1/2 in phase 1); T1 such runs make a block, and spans R1 ..
  // L1/2 run over them in phase 2. Row lo of a block belongs to CTA lo % N
  // (N divides R1, so a thread's i-th row goes to CTA i % N), at
  // m = lo / N = t H + h with t = lo / R1 and h = (lo % R1) / N.
  static constexpr int R1 = cmin(Radix<LOG_L1>::R, 1 << CLUSTER_LOG_RUN);
  static constexpr int T1 = L1 / R1;
  static constexpr int H = R1 / N;
  static constexpr int LO = L1 / N;  // lo values a CTA owns: T1 H
  // pass 2 over e': blocks of R2 next to each other, then T2 such blocks
  static constexpr int R2 = Radix<LOG_L2>::R;
  static constexpr int T2 = L2 / R2;
  static constexpr int TILE_BYTES = L1 * C * (int)sizeof(Tin);
  static constexpr int Z_ROW = LO * C * 4;  // a block e' of a CTA's z
  static constexpr int W1 = T1 * C / 32;  // phase 1's consumer warps
  static constexpr int AREA = S * TILE_BYTES;  // the ring
  // the ring's mbarriers (full, empty), the norms' sums (the CTA's, its
  // warps'), the sampled rows' table: bucket starts and cursors by m, the
  // sampled m values, their count, one entry a row
  static constexpr int SMALL =
      16 * S + 8 * C + 8 * W1 * C + 4 * (3 * LO + 2);
  static size_t smem(int64_t e_live, int64_t k) {
    return AREA + (size_t)e_live * Z_ROW + SMALL + 4 * (size_t)k;
  }
  // the shapes the kernel takes: a thread's rows spread over the N CTAs,
  // four or more runs (the swizzle), at most 32 lo values a CTA and 256
  // blocks (a table entry packs (j, e', m) into 31 bits)
  static constexpr bool VALID = THREADS >= T1 * C + 32 && R1 % N == 0 &&
                                T1 >= 4 && THREADS % C == 0 && W1 >= 1 &&
                                LO <= 32 && THREADS % 32 == 0 &&
                                LOG_L2 <= 8 && R1 >= 4;
};

// The place of (t, h) in row e' of a CTA's z, in units of C floats: the
// low two bits of t, plus (e' + e' / 16) mod 4, pick the 32-byte group of a
// 128-byte line, so that four threads that differ in t (phase 1's stores)
// or in e' (phase 2's loads) fall on different banks.
template <int H>
__device__ __forceinline__ int zcol(int t, int h, int e) {
  return (t >> 2) * 4 * H + h * 4 + ((t + e + (e >> 4)) & 3);
}

struct ClusterArgs {
  const void* X;         // element copies (no TMA): X (Tin), row stride ld
  int64_t ld;
  const float* signs;
  int64_t d_valid;
  int64_t ncols;
  int64_t strips;        // ceil(ncols / C)
  const int32_t* rows;   // the k sampled rows, each in [0, dp)
  int64_t k;             // at most 65,536
  float root_dp;
  float root_dp_k;
  float* sketch;         // sampled row j at sketch + j * ld_sketch
  int64_t ld_sketch;
  float* norms;
  int e_live;            // E: pass-1 blocks that hold a row below d
  int tma;               // 1: tiles by TMA through the tensor map
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Wait for the phase of `bar` with this parity to complete. A wait that
// outlasts any transfer by far (about 2^24 tries) traps: a fault in place
// of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t tries = 0; !done; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (tries > (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// arrive on `bar`, which then also waits for `bytes` of transfers
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// tile (c0, r0) of the tensor map into dst; bar completes with its bytes
__device__ __forceinline__ void tma_tile(const CUtensorMap* map, uint64_t* bar,
                                         void* dst, int c0, int r0,
                                         uint32_t bytes) {
  mbar_expect(bar, bytes);
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0),
      "r"(smem_u32(bar))
      : "memory");
}

// the address of this CTA's shared-memory byte `addr` in CTA `rank`
__device__ __forceinline__ uint32_t cluster_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// v[i] = x(i) for i < R, the loads issued in an order rotated by s (0..3):
// neighbouring threads whose elements lie R rows apart then touch rows that
// differ mod 4, which spreads them over the banks.
template <int R, typename F>
__device__ __forceinline__ void rotated_load(float (&v)[R], int s, F x) {
  float a[R];
#pragma unroll
  for (int k = 0; k < R; ++k) a[k] = x((k + s) & (R - 1));
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float a1 = a[(i - 1) & (R - 1)], a2 = a[(i - 2) & (R - 1)],
                a3 = a[(i - 3) & (R - 1)];
    v[i] = s == 0 ? a[i] : s == 1 ? a1 : s == 2 ? a2 : a3;
  }
}

template <typename Tin, int LOG_L1, int LOG_L2>
__global__ void __launch_bounds__(CLUSTER_THREADS, 1)
srht_cluster(const __grid_constant__ CUtensorMap tmap, const ClusterArgs a) {
  using K = Cluster<Tin, LOG_L1, LOG_L2>;
  constexpr int L1 = K::L1, C = K::C, N = K::N, S = K::S, LO = K::LO;
  constexpr int R1 = K::R1, T1 = K::T1, H = K::H, R2 = K::R2, T2 = K::T2;
  constexpr int W1 = K::W1, THREADS = K::THREADS;
  constexpr int ROW = LO * C;  // floats of a block e' of z
  constexpr int PRODUCER = T1 * C;  // the thread that issues the TMA copies
  constexpr int64_t DP = (int64_t)L1 << LOG_L2;
  extern __shared__ __align__(128) unsigned char smem[];
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int E = a.e_live;
  const int NF = E / R2;  // pass 2's blocks of R2 rows that are all live

  unsigned char* ring = smem;
  float* z = reinterpret_cast<float*>(smem + K::AREA);  // [E][LO][C]
  unsigned char* small = smem + K::AREA + (size_t)E * K::Z_ROW;
  uint64_t* full = reinterpret_cast<uint64_t*>(small);
  uint64_t* empty = full + S;
  double* norm_part = reinterpret_cast<double*>(small + 16 * S);  // [C]
  double* red = norm_part + C;                                    // [W1][C]
  int* cur = reinterpret_cast<int*>(red + W1 * C);                // [LO]
  int* off = cur + LO;                                            // [LO + 1]
  int* m_list = off + LO + 1;                                     // [LO]
  int* n_m = m_list + LO;
  int* table = n_m + 1;  // [k]: (j << 13) | (e' << 5) | m, by m

  const int tiles = rank < E ? (E - rank + N - 1) / N : 0;  // e' = rank + N m
  const int64_t stride = CLUSTER_PERSISTENT ? gridDim.x / N : a.strips;
  int64_t strip = blockIdx.x / N;
  int64_t g = 0;  // tiles consumed, over every strip: the ring's position

  // tile m of strip st into the ring at position pos, once its slot's
  // last use is released
  auto issue = [&](int64_t pos, int64_t st, int m) {
    const int slot = (int)(pos % S);
    if (pos >= S) mbar_wait(&empty[slot], (uint32_t)((pos / S - 1) & 1));
    tma_tile(&tmap, &full[slot], ring + slot * K::TILE_BYTES, (int)(st * C),
             (rank + N * m) * L1, K::TILE_BYTES);
  };
  auto prologue = [&](int64_t st) {
    if (tid == PRODUCER && a.tma)
      for (int m = 0; m < S && m < tiles; ++m) issue(g + m, st, m);
  };

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (tid < LO) cur[tid] = 0;
  __syncthreads();
  cluster_arrive();  // this CTA runs: the others may write its z after wait
  if (strip < a.strips) prologue(strip);
  // this CTA's sampled rows (lo % N == rank), counted by m = lo / N, then
  // a table of them in m order (within an m in any order: each entry is one
  // output row, so the result does not depend on it)
  auto mine = [&](int64_t j, int& m) {
    const int r = a.rows[j];
    const int lo = r & (L1 - 1);
    m = lo / N;
    return r >= 0 && r < DP && lo % N == rank;
  };
  for (int64_t j = tid; j < a.k; j += THREADS) {
    int m;
    if (mine(j, m)) atomicAdd(&cur[m], 1);
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0, at = 0;
    for (int m = 0; m < LO; ++m) {
      off[m] = at;
      if (cur[m] > 0) m_list[n++] = m;
      at += cur[m];
      cur[m] = off[m];
    }
    off[LO] = at;
    *n_m = n;
  }
  __syncthreads();
  for (int64_t j = tid; j < a.k; j += THREADS) {
    int m;
    if (mine(j, m))
      table[atomicAdd(&cur[m], 1)] =
          (int)(j << 13) | ((a.rows[j] >> LOG_L1) << 5) | m;
  }
  uint32_t zr[N];  // every CTA's z, as shared::cluster addresses
#pragma unroll
  for (int q = 0; q < N; ++q) zr[q] = cluster_addr(smem_u32(z), q);
  cluster_wait();

  // phase 1's consumers: the first T1 C threads, a warp 4 runs t1 of 8
  // columns
  const int u1 = tid % C, t1 = tid / C, s1 = t1 & 3;
  const bool act1 = tid < T1 * C;
  // phase 2's tasks: this thread's column and its lane among the threads
  // of that column
  constexpr int CT = THREADS / C;
  const int c2 = tid % C, r2 = tid / C;

  for (; strip < a.strips; strip += stride) {
    const int64_t col0 = strip * C;
    // phase 1: spans 1 .. R1/2 of pass 1 on this CTA's blocks, each row
    // straight into its owner's z. With TMA the producer refills a slot as
    // soon as the consumer warps release it, and no barrier spans the CTA.
    double dsum = 0.0;
    float sg[R1];
    auto load_signs = [&](int m) {
      const int64_t row0 = (int64_t)(rank + N * m) * L1 + t1 * R1;
#pragma unroll
      for (int i = 0; i < R1; ++i)
        sg[i] = m < tiles && row0 + i < a.d_valid ? a.signs[row0 + i] : 0.f;
    };
    // block m from its tile: pass 1's first half, stored to the owners
    auto work = [&](int m, const Tin* tile, uint64_t* release) {
      const int eb = rank + N * m;
      const int64_t row0 = (int64_t)eb * L1 + t1 * R1;
      float v[R1];
      rotated_load<R1>(v, s1, [&](int i) {
        return to_f32(tile[(t1 * R1 + i) * C + u1]);
      });
      if (release != nullptr) {
        __syncwarp();
        if (tid % 32 == 0) mbar_arrive(release);
      }
      float ss = 0.f;
#pragma unroll
      for (int i = 0; i < R1; ++i) {
        ss = fmaf(v[i], v[i], ss);
        v[i] = row0 + i < a.d_valid ? v[i] * sg[i] : 0.f;
      }
      dsum += (double)ss;
      load_signs(m + 1);
      butterflies<R1>(v, 1);  // spans 1 .. R1/2
      // row i of the run goes to CTA i % N
      const uint32_t at = 4u * (eb * ROW + zcol<H>(t1, 0, eb) * C + u1);
#pragma unroll
      for (int i = 0; i < R1; ++i)
        st_cluster(zr[i % N] + at + 16u * (i / N) * C, v[i]);
    };
    if (a.tma) {
      if (tid == PRODUCER)
        for (int m = S; m < tiles; ++m) issue(g + m, strip, m);
      if (act1) {
        load_signs(0);
        for (int m = 0; m < tiles; ++m) {
          const int slot = (int)((g + m) % S);
          mbar_wait(&full[slot], (uint32_t)(((g + m) / S) & 1));
          work(m, reinterpret_cast<const Tin*>(ring + slot * K::TILE_BYTES),
               &empty[slot]);
        }
      }
    } else {
      const Tin* X = static_cast<const Tin*>(a.X);
      if (act1) load_signs(0);
      for (int m = 0; m < tiles; ++m) {
        Tin* tile = reinterpret_cast<Tin*>(ring + (m % S) * K::TILE_BYTES);
        __syncthreads();  // the slot's last block is read
        for (int idx = tid; idx < L1 * C; idx += THREADS) {
          const int64_t row = (int64_t)(rank + N * m) * L1 + idx / C;
          const int64_t col = col0 + idx % C;
          tile[idx] = row < a.d_valid && col < a.ncols ? X[row * a.ld + col]
                                                       : Tin{};
        }
        __syncthreads();
        if (act1) work(m, tile, nullptr);
      }
    }
    g += tiles;
    // the CTA's sums of squares per column: a warp's four runs, then the
    // warps', in a fixed order
    if (act1) {
#pragma unroll
      for (int o = C; o < 32; o <<= 1)
        dsum += __shfl_down_sync(0xffffffffu, dsum, o);
      if (tid % 32 < C) red[(tid / 32) * C + u1] = dsum;
    }
    __syncthreads();
    if (tid < C) {
      double s = 0.0;
      for (int w = 0; w < W1; ++w) s += red[w * C + tid];
      norm_part[tid] = s;
    }
    cluster_arrive();  // release: this CTA's stores into z and norm_part
    cluster_wait();    // acquire: every CTA's
    if (rank == 0 && tid < C && col0 + tid < a.ncols) {
      double s = 0.0;
      for (int q = 0; q < N; ++q)
        s += *cluster.map_shared_rank(norm_part + tid, q);
      a.norms[col0 + tid] = sqrtf((float)s);
    }
    // phase 2 leaves the ring alone: the next strip's first tiles come in
    if (CLUSTER_PERSISTENT && strip + stride < a.strips)
      prologue(strip + stride);

    // phase 2, on this CTA's z, each step a loop of independent tasks, a
    // thread's all in column c2; zcol's rotation takes four values, so a
    // task's addresses are four base pointers plus constants
    // (a) spans R1 .. L1/2 of pass 1, over t, in place
    for (int h = 0; h < H; ++h) {
#pragma unroll 2
      for (int e = r2; e < E; e += CT) {
        float* p[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          p[q] = z + e * ROW + zcol<H>(q, h, e) * C + c2;
        float w[T1];
#pragma unroll
        for (int t = 0; t < T1; ++t) w[t] = p[t & 3][(t >> 2) * 4 * H * C];
        butterflies<T1>(w, 1);
#pragma unroll
        for (int t = 0; t < T1; ++t) p[t & 3][(t >> 2) * 4 * H * C] = w[t];
      }
    }
    __syncthreads();
    // (b) spans 1 .. R2/2 of pass 2 over e' for each sampled m, in place,
    // on the NF blocks of R2 rows that are all live (step c redoes a last,
    // partial block)
    const int nm = *n_m;
    if (NF > 0) {
      int li = r2 / NF, b = r2 % NF;
#pragma unroll 2
      for (; li < nm; b += CT) {
        while (b >= NF) b -= NF, ++li;
        if (li >= nm) break;
        const int mm = m_list[li];
        const int t = mm / H, h = mm % H;
        float w[R2];
#pragma unroll
        for (int i = 0; i < R2; ++i) {
          const int e = b * R2 + i;
          w[i] = z[e * ROW + zcol<H>(t, h, e) * C + c2];
        }
        butterflies<R2>(w, 1);
#pragma unroll
        for (int i = 0; i < R2; ++i) {
          const int e = b * R2 + i;
          z[e * ROW + zcol<H>(t, h, e) * C + c2] = w[i];
        }
      }
    }
    __syncthreads();
    // (c) spans R2 .. L2/2 of pass 2 for the sampled rows alone: row e0
    // is element e0 / R2 of the transform over e' = R2 x + e0 % R2
    for (int i = r2; i < off[LO]; i += CT) {
      const int ent = table[i];
      const int mm = ent & 31, e0 = (ent >> 5) & 255;
      const int64_t j = (unsigned)ent >> 13;
      const int t = mm / H, h = mm % H, g0 = e0 % R2, x0 = e0 / R2;
      float w[T2];
#pragma unroll
      for (int x = 0; x < T2; ++x) {
        const int e = R2 * x + g0;
        w[x] = x < NF ? z[e * ROW + zcol<H>(t, h, e) * C + c2] : 0.f;
      }
      if (NF * R2 < E && NF < T2) {
        // the partial block NF: its first half here, element g0 of it
        float u[R2];
#pragma unroll
        for (int q = 0; q < R2; ++q) {
          const int e = NF * R2 + q;
          u[q] = e < E ? z[e * ROW + zcol<H>(t, h, e) * C + c2] : 0.f;
        }
        butterflies<R2>(u, 1);
        float y = u[0];
#pragma unroll
        for (int q = 1; q < R2; ++q) y = q == g0 ? u[q] : y;
#pragma unroll
        for (int x = 0; x < T2; ++x) w[x] = x == NF ? y : w[x];
      }
      butterflies<T2>(w, 1);
      float y = w[0];
#pragma unroll
      for (int x = 1; x < T2; ++x) y = x == x0 ? w[x] : y;
      if (col0 + c2 < a.ncols)
        a.sketch[j * a.ld_sketch + col0 + c2] =
            __fmul_rn(__fdiv_rn(y, a.root_dp), a.root_dp_k);
    }
    // rank 0 has read every norm_part, and z may be written again
    cluster_arrive();
    cluster_wait();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <typename Tin>
CUtensorMapDataType tma_type() {
  return sizeof(Tin) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The kernel's attributes and a launch config of one cluster (gridDim N).
template <typename Tin, int LOG_L1, int LOG_L2>
cudaError_t cluster_config(size_t smem, cudaStream_t s,
                           cudaLaunchAttribute (&attr)[1],
                           cudaLaunchConfig_t& cfg) {
  using K = Cluster<Tin, LOG_L1, LOG_L2>;
  auto kern = srht_cluster<Tin, LOG_L1, LOG_L2>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && K::N > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K::N;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)K::N);
  cfg.blockDim = dim3(K::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return err;
}

// Clusters of the form that the card holds at once, for d_valid rows.
template <typename Tin, int LOG_L1, int LOG_L2>
int slots_cluster(int64_t d_valid, int64_t k) {
  using K = Cluster<Tin, LOG_L1, LOG_L2>;
  if constexpr (!K::VALID) {
    return -(int)cudaErrorInvalidValue;
  } else {
    const size_t smem = K::smem((d_valid + K::L1 - 1) >> LOG_L1, k);
    if (smem > (size_t)SMEM_MAX) return -(int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = {};
    cudaError_t err = cluster_config<Tin, LOG_L1, LOG_L2>(smem, 0, attr, cfg);
    int active = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(
          &active, srht_cluster<Tin, LOG_L1, LOG_L2>, &cfg);
    return err == cudaSuccess ? active : -(int)err;
  }
}

template <typename Tin, int LOG_L1, int LOG_L2>
int launch_cluster(ClusterArgs a, cudaStream_t s) {
  using K = Cluster<Tin, LOG_L1, LOG_L2>;
  if constexpr (!K::VALID) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (a.k < 1 || a.k > 65536) return (int)cudaErrorInvalidValue;
    a.e_live = (int)((a.d_valid + K::L1 - 1) >> LOG_L1);
    a.strips = (a.ncols + K::C - 1) / K::C;
    const size_t smem = K::smem(a.e_live, a.k);
    if (smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
    CUtensorMap map;
    memset(&map, 0, sizeof map);
    a.tma = 0;
    if (reinterpret_cast<uintptr_t>(a.X) % 16 == 0 &&
        (a.ld * (int64_t)sizeof(Tin)) % 16 == 0 &&
        (K::C * sizeof(Tin)) % 16 == 0) {
      EncodeTiled encode = encoder();
      if (encode == nullptr) return (int)cudaErrorNotSupported;
      const cuuint64_t dims[2] = {(cuuint64_t)a.ncols, (cuuint64_t)a.d_valid};
      const cuuint64_t strides[1] = {(cuuint64_t)(a.ld * sizeof(Tin))};
      const cuuint32_t box[2] = {(cuuint32_t)K::C, (cuuint32_t)K::L1};
      const cuuint32_t unit[2] = {1, 1};
      if (encode(&map, tma_type<Tin>(), 2, const_cast<void*>(a.X), dims,
                 strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                 CU_TENSOR_MAP_SWIZZLE_NONE, TMA_PROMOTION,
                 CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
      a.tma = 1;
    }
    auto kern = srht_cluster<Tin, LOG_L1, LOG_L2>;
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = {};
    cudaError_t err = cluster_config<Tin, LOG_L1, LOG_L2>(smem, s, attr, cfg);
    if (err != cudaSuccess) return (int)err;
    int64_t clusters = a.strips;
    if (CLUSTER_PERSISTENT) {
      int active = 0;
      err = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (active < 1) return (int)cudaErrorInvalidConfiguration;
      if (clusters > active) clusters = active;
    }
    if (clusters * K::N > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    cfg.gridDim = dim3((unsigned)(clusters * K::N));
    err = cudaLaunchKernelEx(&cfg, kern, map, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
}

// The cluster form over ncols columns (dp = 2^log_dp, two passes).
template <typename Tin>
int run_cluster(const Tin* X, int64_t ld, const float* signs, int64_t d_valid,
                int64_t log_dp, const int32_t* rows, int64_t k, float root_dp,
                float root_dp_k, float* sketch, int64_t ld_sketch,
                float* norms, int64_t ncols, void* stream) {
  ClusterArgs a = {};
  a.X = X;
  a.ld = ld;
  a.signs = signs;
  a.d_valid = d_valid;
  a.ncols = ncols;
  a.rows = rows;
  a.k = k;
  a.root_dp = root_dp;
  a.root_dp_k = root_dp_k;
  a.sketch = sketch;
  a.ld_sketch = ld_sketch;
  a.norms = norms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (log_dp) {  // radices as split() cuts two passes, larger first
    case 9: return launch_cluster<Tin, 5, 4>(a, s);
    case 10: return launch_cluster<Tin, 5, 5>(a, s);
    case 11: return launch_cluster<Tin, 6, 5>(a, s);
    case 12: return launch_cluster<Tin, 6, 6>(a, s);
    case 13: return launch_cluster<Tin, 7, 6>(a, s);
    case 14: return launch_cluster<Tin, 7, 7>(a, s);
    case 15: return launch_cluster<Tin, 8, 7>(a, s);
    case 16: return launch_cluster<Tin, 8, 8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename Tin>
int cluster_slots(int64_t d_valid, int64_t log_dp, int64_t k) {
  switch (log_dp) {
    case 9: return slots_cluster<Tin, 5, 4>(d_valid, k);
    case 10: return slots_cluster<Tin, 5, 5>(d_valid, k);
    case 11: return slots_cluster<Tin, 6, 5>(d_valid, k);
    case 12: return slots_cluster<Tin, 6, 6>(d_valid, k);
    case 13: return slots_cluster<Tin, 7, 6>(d_valid, k);
    case 14: return slots_cluster<Tin, 7, 7>(d_valid, k);
    case 15: return slots_cluster<Tin, 8, 7>(d_valid, k);
    case 16: return slots_cluster<Tin, 8, 8>(d_valid, k);
  }
  return -(int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points for ctypes. Each returns the first cudaError_t of its
// launches (0 on success); it neither synchronises nor allocates. The block
// mode's ``cluster`` picks the form: nonzero, the cluster form (scratch and
// partial unused; an error where dp is not two passes or the strip does not
// fit); 0, the two-pass form.
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
                              int64_t cluster, float* scratch,
                              double* partial, void* stream) {
  if (cluster)
    return run_cluster<float>(X, ld, signs, d_valid, log_dp, rows, k, root_dp,
                              root_dp_k, sketch, ld_sketch, norms, ncols,
                              stream);
  return run_block<float>(X, ld, signs, d_valid, log_dp, rows, k, root_dp,
                          root_dp_k, sketch, ld_sketch, norms, ncols, scratch,
                          partial, stream);
}

extern "C" int srht_block_bf16(const __nv_bfloat16* X, int64_t ld,
                               const float* signs, int64_t d_valid,
                               int64_t log_dp, const int32_t* rows, int64_t k,
                               float root_dp, float root_dp_k, float* sketch,
                               int64_t ld_sketch, float* norms, int64_t ncols,
                               int64_t cluster, float* scratch,
                               double* partial, void* stream) {
  if (cluster)
    return run_cluster<__nv_bfloat16>(X, ld, signs, d_valid, log_dp, rows, k,
                                      root_dp, root_dp_k, sketch, ld_sketch,
                                      norms, ncols, stream);
  return run_block<__nv_bfloat16>(X, ld, signs, d_valid, log_dp, rows, k,
                                  root_dp, root_dp_k, sketch, ld_sketch,
                                  norms, ncols, scratch, partial, stream);
}

// The cluster form's clusters that the card holds at once at d_valid rows,
// dp = 2^log_dp and k sampled rows (cudaOccupancyMaxActiveClusters), or
// minus a cudaError_t.
extern "C" int srht_cluster_slots(int64_t d_valid, int64_t log_dp,
                                  int64_t k, int64_t bf16) {
  return bf16 ? cluster_slots<__nv_bfloat16>(d_valid, log_dp, k)
              : cluster_slots<float>(d_valid, log_dp, k);
}
