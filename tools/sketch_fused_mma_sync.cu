// sketch_fused_mma_sync.cu: the earlier float32 design of
// src/repro_torch/kernels/csrc/sketch_fused.cu, kept as a yardstick and
// not part of the port: chip_smoke.py (phase 6) and
// tools/sketch_fused_probe.py build it with nvcc and time it in turns with
// the kernel at the slice's shape. Its code is that design's, unchanged.
// Same function, same C entry (sketch_fused_f32, without the scratch
// argument of the current one): Pi @ A and the squared column norms of A,
// float32 in and out.
//
// float32 (sketch_fused_kernel<float, VEC>, entry sketch_fused_f32).
// What bounds it on an H100: operations. A float32-accurate product on the
// TF32 tensor cores takes three passes (below), 3 * 2*k*d*n FLOP at
// 495 TFLOP/s: 31.03 ms at k = 512, d = 50,000, n = 100,000. Its bytes,
// (k*d + d*n + k*n + n) * 4, take 6.06 ms at 3.35 TB/s; the same product on
// the float32 FMA units would take 76.57 ms at 67 TFLOP/s.
//  * Each CTA owns one BM x BN tile of the output at a time and loops over
//    all of d itself (the Pallas kernel's sequential d grid axis would race
//    on a GPU). The CTAs are persistent, one per SM, and walk the tiles
//    k-tile first, so the k/BM CTAs that read the same columns of A run side
//    by side and share them through L2.
//  * Tensor cores: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32. The
//    MMA's M is sketch rows, its K is d and its N is columns of A. 256
//    threads as 2 x 4 warps, each warp a 64 x 32 block of the output (4 x 4
//    MMA tiles), with up to 255 registers a thread. Each thread loads its
//    fragment values from shared memory itself, so the A tile keeps A's
//    row-major (N-major) layout.
//  * Three passes: each fragment value is split in registers as big = x
//    rounded to nearest TF32 (two integer operations) and small = x - big,
//    and small*big, big*small and big*big are issued; the dropped
//    small*small term and the low bits of small, which the MMA ignores, are
//    about 2^-21 relative, float32 class. One TF32 pass would be off by
//    about 5e-4 of a column's largest entry at d = 50,000.
//  * Two-level accumulation: the tensor cores add inside an MMA with
//    truncation, which over d = 50,000 (18,750 MMAs per output into one
//    accumulator) biases the sum toward zero by several 1e-4 of a column's
//    largest entry. Each stage's products go into a fresh fragment, which
//    is added to the float32 sum with an ordinary FADD.
//  * Copies: a ring of STAGES shared-memory stages filled by cp.async,
//    zero-filled past the d, k and n edges (src-size 0), one __syncthreads()
//    per stage. 16-byte copies where every row of Pi and A starts 16-byte
//    aligned; otherwise 4-byte copies.
//  * Fragments: the MMA is fed d in an order in which a thread's two values
//    of a k8 step are neighbours in d (one 8-byte load per row of Pi). Shared
//    pitches keep the loads off shared banks: Pi rows at BK + 8 elements, A
//    rows at BN + 16 bytes: 70,656 B a stage, three stages 211,968 B.
//  * The CTAs of k-tile 0 also add up the squared column norms from the A
//    tile they hold, in float32 FMAs on the exact loaded values.
// Not wgmma: its TF32 form takes B from shared memory only K-major, and a
// tile of row-major A is N-major, so every A tile would first have to be
// transposed in shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;   // sketch rows (rows of Pi) per CTA
constexpr int BN = 128;   // columns of A per CTA
constexpr int BK = 64;    // rows of A (the streamed dimension d) per stage
constexpr int STAGES = 3;
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;  // 256
constexpr int WM = BM / WARPS_M;                 // 64 output rows per warp
constexpr int WN = BN / WARPS_N;                 // 32 output columns per warp
constexpr int MT = WM / 16;                      // MMA tiles down a warp
constexpr int NT = WN / 8;                       // MMA tiles across a warp
constexpr int PI_PITCH = BK + 8;                 // elements per Pi-tile row
constexpr int MIN_BLOCKS = 1;  // one CTA per SM: up to 255 registers

template <typename T>
struct Layout {
  static constexpr int A_PITCH = BN + 16 / (int)sizeof(T);  // elements
  static constexpr int PI_ELEMS = BM * PI_PITCH;
  static constexpr int STAGE_ELEMS = PI_ELEMS + BK * A_PITCH;
  static constexpr int SMEM = STAGES * STAGE_ELEMS * (int)sizeof(T);
  static constexpr int PASSES = 3;  // split TF32 passes
};

__device__ __forceinline__ float to_f32(float x) { return x; }

// A value's TF32 operands, as the MMA reads them (the top 19 bits of a
// float32): big rounds x to nearest TF32 (the integer form of
// cvt.rna.tf32.f32, without its NaN guard), small = x - big is exact and
// the MMA ignores its low 13 bits.
template <int PASSES>
__device__ __forceinline__ void split(uint32_t x, uint32_t& big,
                                      uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// This warp's operands of one k8 step at column kk of the stage, as float32
// bit patterns: a[i] = (a0, a1, a2, a3) of m-tile i, b[j] = (b0, b1) of
// n-tile j. The MMA's k index t stands for d offset 2t and t + 4 for
// 2t + 1 (any order of k does, the same in A and B), so a thread's two
// values of a row of Pi, or of a column of A, are neighbours in d.
// float32: one 8-byte load per row of Pi, one 4-byte load per value of A.
__device__ __forceinline__ void load_frags(
    const float* ps, const float* as, int a_pitch, int kk, int wm, int wn,
    int lane, uint32_t (&a)[MT][4], uint32_t (&b)[NT][2]) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const float* p = ps + (wm + i * 16 + g) * PI_PITCH + kk + 2 * t;
    const float2 lo = *reinterpret_cast<const float2*>(p);  // row g
    const float2 hi = *reinterpret_cast<const float2*>(p + 8 * PI_PITCH);
    a[i][0] = __float_as_uint(lo.x);
    a[i][1] = __float_as_uint(hi.x);
    a[i][2] = __float_as_uint(lo.y);
    a[i][3] = __float_as_uint(hi.y);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float* p = as + (kk + 2 * t) * a_pitch + wn + j * 8 + g;
    b[j][0] = __float_as_uint(p[0]);
    b[j][1] = __float_as_uint(p[a_pitch]);
  }
}

// c += a * b on one m16n8k8 tile.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One asynchronous copy (cp.async) of VEC bytes, 16 or 4, the first
// src_bytes of them from gmem and the rest zeros.
template <int VEC>
__device__ __forceinline__ void copy(void* smem, const void* gmem,
                                     int src_bytes) {
  const unsigned dst = smem_addr(smem);
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(dst), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sketch_fused_kernel(const T* __restrict__ Pi, const T* __restrict__ A,
                    float* __restrict__ out, float* __restrict__ norm2,
                    int k, int64_t d, int n) {
  using L = Layout<T>;
  constexpr int PASSES = L::PASSES;
  constexpr int A_PITCH = L::A_PITCH;
  constexpr int EPC = VEC / (int)sizeof(T);  // elements per copy
  constexpr int PI_COPIES = BM * BK / EPC / THREADS;  // per thread per stage
  constexpr int A_COPIES = BK * BN / EPC / THREADS;
  constexpr int NORM_SPLIT = THREADS / BN;   // threads sharing a column norm
  constexpr int PI_ROW_STEP = THREADS / (BK / EPC);
  constexpr int A_ROW_STEP = THREADS / (BN / EPC);
  static_assert(EPC >= 1 && PI_COPIES * EPC * THREADS == BM * BK &&
                A_COPIES * EPC * THREADS == BK * BN &&
                THREADS % (BK / EPC) == 0 && THREADS % (BN / EPC) == 0,
                "copy split");
  static_assert(NORM_SPLIT * BN == THREADS && BK % NORM_SPLIT == 0,
                "norm split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  __shared__ float nrm_part[NORM_SPLIT - 1][BN];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int wm = (warp % WARPS_M) * WM;
  const int wn = (warp / WARPS_M) * WN;
  const int64_t n_steps = (d + BK - 1) / BK;
  const int pr = tid / (BK / EPC), pc = tid % (BK / EPC) * EPC;
  const int ar = tid / (BN / EPC), ac = tid % (BN / EPC) * EPC;
  // bytes of a copy with `left` elements before an edge
  auto edge_bytes = [](int64_t left) {
    return left >= EPC ? VEC : left > 0 ? (int)left * (int)sizeof(T) : 0;
  };
  const int k_tiles = (k + BM - 1) / BM;
  const int64_t tiles = (int64_t)k_tiles * ((n + BN - 1) / BN);

  // Persistent CTAs: tile, tile + gridDim.x, ... in k-tile-first order, so
  // the CTAs that read the same rows of Pi or columns of A walk d together
  // and share them through L2.
  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int kt = (int)(tile % k_tiles);
    const int k0 = kt * BM;
    const int n0 = (int)(tile / k_tiles) * BN;
    const bool do_norms = (kt == 0);
    __syncthreads();  // the last tile's reads of the stages are done

    // Stage slot s <- rows d0..d0+BK-1 of A and the same columns of Pi.
    // This thread's copies of a stage: rows pr + i * PI_ROW_STEP of the Pi
    // tile at columns pc.., rows ar + i * A_ROW_STEP of the A tile at
    // columns ac... Bytes past the k and n edges are fixed for the tile,
    // those past the d edge change only in the last stage.
    const T* const pi_src = Pi + (int64_t)(k0 + pr) * d + pc;
    const T* const a_src = A + (int64_t)ar * n + n0 + ac;
    const int a_bytes = edge_bytes((int64_t)n - (n0 + ac));
    auto load_stage = [&](int s, int64_t d0) {
      T* ps = smem + s * L::STAGE_ELEMS;
      T* as = ps + L::PI_ELEMS;
      const int pi_bytes = edge_bytes(d - (d0 + pc));
#pragma unroll
      for (int i = 0; i < PI_COPIES; ++i) {
        const int row = pr + i * PI_ROW_STEP;
        const int bytes = k0 + row < k ? pi_bytes : 0;
        copy<VEC>(ps + row * PI_PITCH + pc,
                  bytes ? pi_src + (int64_t)i * PI_ROW_STEP * d + d0 : Pi,
                  bytes);
      }
#pragma unroll
      for (int i = 0; i < A_COPIES; ++i) {
        const int row = ar + i * A_ROW_STEP;
        const int bytes = d0 + row < d ? a_bytes : 0;
        copy<VEC>(as + row * A_PITCH + ac,
                  bytes ? a_src + (d0 + row - ar) * (int64_t)n : A, bytes);
      }
    };

    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    float nrm = 0.f;

#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
      if (s < n_steps) load_stage(s, (int64_t)s * BK);
      cp_async_commit();
    }
    int slot = 0;
    for (int64_t step = 0; step < n_steps; ++step) {
      // this thread's copies of stage `step` have landed; after the barrier
      // everyone's have, and every warp is done with the slot refilled below
      cp_async_wait<STAGES - 2>();
      __syncthreads();
      const int64_t ahead = step + STAGES - 1;
      if (ahead < n_steps)
        load_stage(slot == 0 ? STAGES - 1 : slot - 1, ahead * BK);
      cp_async_commit();

      const T* ps = smem + slot * L::STAGE_ELEMS;
      const T* as = ps + L::PI_ELEMS;
      if (do_norms) {
        // column tid % BN, rows (tid / BN) * BK/NORM_SPLIT onward
        const T* col =
            as + (tid / BN) * (BK / NORM_SPLIT) * A_PITCH + tid % BN;
        float stage = 0.f;  // summed per stage, then into nrm
#pragma unroll
        for (int r = 0; r < BK / NORM_SPLIT; ++r) {
          const float v = to_f32(col[r * A_PITCH]);
          stage = fmaf(v, v, stage);
        }
        nrm += stage;
      }
      // The stage's products go into a fresh fragment, added to acc at the
      // end of the stage.
      float part[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 8) {
        uint32_t a[MT][4], b[NT][2];
        load_frags(ps, as, A_PITCH, kk, wm, wn, lane, a, b);
        uint32_t b_big[NT][2], b_small[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          split<PASSES>(b[j][0], b_big[j][0], b_small[j][0]);
          split<PASSES>(b[j][1], b_big[j][1], b_small[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t a_big[4], a_small[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split<PASSES>(a[i][e], a_big[e], a_small[e]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if constexpr (PASSES == 3) {
              mma(part[i][j], a_small, b_big[j][0], b_big[j][1]);
              mma(part[i][j], a_big, b_small[j][0], b_small[j][1]);
            }
            mma(part[i][j], a_big, b_big[j][0], b_big[j][1]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
      slot = slot == STAGES - 1 ? 0 : slot + 1;
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < MT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = k0 + wm + i * 16 + g + 8 * h;
        if (row >= k) continue;
        float* dst = out + (int64_t)row * n;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int col = n0 + wn + j * 8 + 2 * t;
          if (col < n) dst[col] = acc[i][j][2 * h];
          if (col + 1 < n) dst[col + 1] = acc[i][j][2 * h + 1];
        }
      }
    }
    if (do_norms) {
      if (tid >= BN) nrm_part[tid / BN - 1][tid % BN] = nrm;
      __syncthreads();
      if (tid < BN && n0 + tid < n) {
#pragma unroll
        for (int q = 0; q < NORM_SPLIT - 1; ++q) nrm += nrm_part[q][tid];
        norm2[n0 + tid] = nrm;
      }
    }
  }
}

template <typename T, int VEC>
int launch_vec(const T* Pi, const T* A, float* out, float* norm2, int64_t k,
               int64_t d, int64_t n, cudaStream_t stream) {
  // per launch: the attribute belongs to the current device
  cudaError_t err = cudaFuncSetAttribute(
      sketch_fused_kernel<T, VEC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<T>::SMEM);
  if (err != cudaSuccess) return (int)err;
  // as many CTAs as are resident at once, or fewer if there are fewer tiles
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sketch_fused_kernel<T, VEC>, THREADS, Layout<T>::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = ((k + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int64_t grid = tiles < (int64_t)sms * per_sm ? tiles
                                                      : (int64_t)sms * per_sm;
  sketch_fused_kernel<T, VEC><<<(unsigned)grid, THREADS, Layout<T>::SMEM,
                                stream>>>(Pi, A, out, norm2, (int)k, d,
                                          (int)n);
  return (int)cudaGetLastError();
}

// 16-byte copies when every row of Pi and A starts 16-byte aligned, else
// element copies.
template <typename T>
int launch(const T* Pi, const T* A, float* out, float* norm2, int64_t k,
           int64_t d, int64_t n, void* stream_) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const bool aligned = ((uintptr_t)Pi % 16 == 0) && ((uintptr_t)A % 16 == 0) &&
                       (d * (int64_t)sizeof(T)) % 16 == 0 &&
                       (n * (int64_t)sizeof(T)) % 16 == 0;
  if (aligned)
    return launch_vec<T, 16>(Pi, A, out, norm2, k, d, n, stream);
  return launch_vec<T, (int)sizeof(T)>(Pi, A, out, norm2, k, d, n, stream);
}

}  // namespace

// Plain C entry point for ctypes: returns the cudaError_t of the launch (0
// on success); it neither synchronises nor allocates.
extern "C" int sketch_fused_f32(const float* Pi, const float* A, float* out,
                                float* norm2, int64_t k, int64_t d, int64_t n,
                                void* stream) {
  return launch<float>(Pi, A, out, norm2, k, d, n, stream);
}
