// sketch_fused.cu: Pi @ A and the squared column norms of A, in one read of A,
// on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sketch_fused.py:50
// (sketch_fused, body _kernel). Pi is (k, d), A is (d, n), both row-major,
// float32 or bf16; out is (k, n) float32 and norm2 is (n,) float32. Each
// output element is written once, with no atomics: runs repeat bit for bit.
// Two instances with designs of their own, one per input type.
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
//
// bf16 (sketch_fused_bf16_kernel, entry sketch_fused_bf16). What bounds it:
// operations, 2*k*d*n FLOP at the bf16 tensor cores' 989 TFLOP/s, 5.18 ms
// at the shape above (its bytes, 2*(k*d + d*n) + 4*(k*n + n), take 3.09
// ms). A CTA that loads its own 128 x 128 tiles pulls 8 KiB from L2 per
// k16 step of 524,288 FLOP, 80 GB for the product, about 10.7 ms at the
// 7.5 TB/s the card reads L2 at; the cluster below cuts that to 50 GB.
// Measured, what is left is the shared memory's traffic and the consumers'
// work between the wgmma, not L2 (PERF.md). The design:
//  * wgmma.mma_async m64n128k16, bf16 in, float32 sums. Pi's tile is the A
//    operand, K-major from shared memory (its rows are contiguous in d); A's
//    tile is the B operand, MN-major from shared memory (transpose flag),
//    so both tiles lie in shared memory as they lie in device memory. Both
//    come by TMA (cp.async.bulk.tensor) with the 128-byte swizzle, which
//    the wgmma descriptors name: a Pi tile as one 128 x 64 box, an A tile
//    as eight 16-row boxes of 64 columns.
//  * Warp-specialised, 384 threads: one thread of warp 8 keeps a ring of
//    BF16_STAGES stages in flight on mbarriers (full: the stage's bytes
//    have landed; empty: every warp that reads the stage is done with it);
//    two consumer warpgroups each own 64 rows of the 128 x BN output tile;
//    warps 9 and 10 sum the norms (below); warp 11 idles.
//  * Thread block clusters along k: the min(ceil(k / BM), 4) CTAs whose row
//    blocks of Pi meet the same column tile of A form a cluster, and each
//    CTA loads a share of the A tile (its boxes b = rank, rank + cs, ...)
//    multicast into every CTA of the cluster (.multicast::cluster). A
//    CTA's A share from L2 drops to a quarter at k = 512: 102 FLOP a byte.
//    A stage is refilled only once every reader warp of every CTA of the
//    cluster has released it: each warp arrives on the stage's empty
//    barrier in every CTA (lane c of the warp in CTA c, a remote arrive
//    through mapa), and the producer waits for all 10 * cs arrivals before
//    its share overwrites the stage in all of them. Every CTA's full
//    barrier waits for every CTA's share, so no CTA runs a ring ahead of
//    another and an arrive always meets the phase it is for. Where k has
//    more row blocks than a cluster holds, a cluster walks groups of them;
//    a CTA whose row block lies past k loads no Pi tile and stores nothing
//    (its wgmma run on a stale tile: under a branch they would be
//    serialised), but loads its A share and releases its stages.
//  * The same two-level sum, in chains of CHAIN_STAGES stages (256 terms
//    of d): a chain's wgmma go into a fresh accumulator (scale-d 0 on its
//    first), which is then added to the float32 sum with an ordinary FADD.
//    Within a chain a stage is released as soon as the wgmma after it are
//    issued (wgmma.wait_group 1); the chain ends in a wait for all of them
//    and the adds. Warpgroup 1's chains are offset from warpgroup 0's by
//    half a chain, so one warpgroup's wgmma run while the other adds. At
//    d = 50,000 a column's error is 2.8e-6 of its largest entry for chains
//    of four stages and 3.2e-6 for one, 1.0e-4 with one chain over all of
//    d (PERF.md), against the 1e-4 the sketch is held to. Two 64-float
//    accumulators a consumer thread.
//  * Edges: TMA zero-fills boxes past the d, k and n edges. TMA needs
//    16-byte aligned bases and row strides that are multiples of 16 bytes:
//    this entry reads Pi's rows at a pitch of d rounded up to 8 elements and
//    A's at n rounded up to 8, from 16-byte aligned bases. The Python
//    wrapper (kernels/sketch_fused.py) makes such a zero-padded copy where
//    the caller's tensors are not so, and counts the copies.
//  * Persistent clusters, as many as the card holds, walk the units (row
//    group, column tile) row group first; the clusters that run at once
//    read neighbouring column tiles and the same rows of Pi, which L2
//    shares.
//  * Norms: in the CTA of row block 0, warps 9 and 10 add up the squares
//    from the A tile it holds (the swizzle undone, two columns a lane), in
//    float32 FMAs on the exact bf16 values, while the consumers' wgmma
//    run; they read every stage of every CTA and release it, summing or
//    not, so that every CTA's empty barriers count alike.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // cudaGetDriverEntryPoint, so libcuda is not linked
#include <cuda_bf16.h>
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

// ---------------------------------------------------------------------------
// The bf16 instance: TMA, wgmma and a cluster along k (see the header).

constexpr int BF16_STAGES = 6;
constexpr int BF16_CLUSTER_MAX = 4;     // CTAs a cluster, at most
constexpr int BF16_CONSUMER_WARPS = 8;  // two warpgroups: the wgmma
constexpr int PRODUCER_WARP = 8;        // its lane 0 issues the copies
constexpr int NORM_WARP = 9;            // and the next warp: the norms
constexpr int BF16_READER_WARPS = BF16_CONSUMER_WARPS + 2;  // of a stage
constexpr int BF16_THREADS = 32 * (BF16_CONSUMER_WARPS + 4);  // 384
// stages whose wgmma go into one fresh accumulator before it is added to
// the float32 sum: chains of 256 terms of d
constexpr int CHAIN_STAGES = 4;
constexpr int BOX_COLS = 64;   // columns of an A box: 128 bytes, the swizzle
constexpr int BOX_ROWS = 16;   // rows of d an A box holds
constexpr int BOXES_PER_HALF = BK / BOX_ROWS;                // 4
constexpr int A_BOXES = (BN / BOX_COLS) * BOXES_PER_HALF;    // 8
constexpr int PI_TILE_BYTES = BM * BK * 2;                   // 16,384
constexpr int A_HALF_BYTES = BK * BOX_COLS * 2;              // 8,192
constexpr int A_TILE_BYTES = BK * BN * 2;                    // 16,384
constexpr int BOX_BYTES = BOX_ROWS * BOX_COLS * 2;           // 2,048
constexpr int STAGE_BYTES = PI_TILE_BYTES + A_TILE_BYTES;
// the ring (on a 1,024-byte boundary), its full and empty barriers
constexpr int BF16_SMEM = 1024 + BF16_STAGES * STAGE_BYTES +
                          2 * 8 * BF16_STAGES;
static_assert(BK * 2 == 128 && BOX_COLS * 2 == 128,
              "a row of a tile is one 128-byte swizzle span");
static_assert(2 * 32 * 2 == BN, "two norm warps, two columns a lane");

struct Bf16Args {
  float* out;
  float* norm2;
  int k;
  int n;
  int64_t d;
  int cs;           // CTAs a cluster: row blocks of Pi that share A tiles
  int row_groups;   // groups of cs row blocks: ceil(ceil(k / BM) / cs)
  int64_t units;    // row_groups * ceil(n / BN), walked by the clusters
  int pairs;        // 1: out takes 8-byte stores of column pairs
};

__device__ __forceinline__ uint32_t special_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t special_clusterid() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t special_nclusters() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster: release, then acquire
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n\tbarrier.cluster.wait;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Wait for the phase of `bar` with this parity to complete. A wait that
// outlasts any transfer by far (2^24 tries) traps: a fault in place of a
// hung card. The loop lies inside the asm, so that the compiler sees no
// divergent path around the wgmma that follow (it would serialise them).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 tries;\n"
      "mov.u32 tries, 0;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "add.u32 tries, tries, 1;\n"
      "setp.gt.u32 p, tries, 16777216;\n"
      "@p trap;\n"
      "bra WAIT;\n"
      "DONE:\n}"
      :: "r"(smem_addr(bar)), "r"(parity)
      : "memory");
}

// arrive on `bar`, which then also waits for `bytes` of transfers
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// arrive on the barrier at this CTA's offset of `bar` in CTA `cta` of the
// cluster (release at CTA scope, the default: what it orders is this
// warp's reads of the stage, which the wgmma wait and the syncwarp have
// completed; a cluster-scope release costs a fence an arrive)
__device__ __forceinline__ void mbar_arrive_remote(uint64_t* bar,
                                                   uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}"
      :: "r"(smem_addr(bar)), "r"(cta) : "memory");
}

// box (c0, c1) of the tensor map into this CTA's shared memory at dst
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint64_t* bar,
                                         uint32_t dst, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_addr(bar))
      : "memory");
}

// the same into dst of every CTA in `mask`, each completing its own `bar`
__device__ __forceinline__ void tma_multicast(const CUtensorMap* map,
                                              uint64_t* bar, uint32_t dst,
                                              int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// A wgmma shared-memory matrix descriptor of a tile in the 128-byte
// swizzle: start address, leading and stride byte offsets.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

// d = (accumulate ? d : 0) + a * b for a 64 x 16 tile of Pi (K-major) and
// a 16 x 128 tile of A (MN-major: the transpose flag), bf16, float32 sums.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// keeps the compiler from moving reads or writes of v across this point
// (the wgmma writes them asynchronously)
__device__ __forceinline__ void reg_fence(float (&v)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(v[i])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

__global__ void __launch_bounds__(BF16_THREADS, 1)
sketch_fused_bf16_kernel(const __grid_constant__ CUtensorMap pi_map,
                         const __grid_constant__ CUtensorMap a_map,
                         const Bf16Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1,024 bytes: the ring starts on such a
  // boundary, at the same offset in every CTA of the cluster
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* const ring = smem_raw + (1024u - raw % 1024u) % 1024u;
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      ring + BF16_STAGES * STAGE_BYTES);
  uint64_t* const empty = full + BF16_STAGES;
  const uint32_t ring_s = smem_addr(ring);

  const int tid = threadIdx.x;
  // a shuffle tells the compiler the role is uniform across the warp
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int rank = (int)special_ctarank();
  const int64_t n_steps = (a.d + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < BF16_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], BF16_READER_WARPS * a.cs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers are set before a copy reaches them

  // unit u: row block (u % row_groups) * cs + rank of Pi, column tile
  // u / row_groups of A; the cluster's CTAs hold the same column tile
  auto unit_k0 = [&](int64_t u) {
    return ((int)(u % a.row_groups) * a.cs + rank) * BM;
  };
  auto unit_n0 = [&](int64_t u) { return (int)(u / a.row_groups) * BN; };
  // the ring's position, as every reader of it keeps it
  int slot = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++slot == BF16_STAGES) {
      slot = 0;
      phase ^= 1u;
    }
  };
  // this warp is done with slot s: release it in every CTA of the cluster
  // (lane c arrives in CTA c)
  auto release = [&](int s) {
    __syncwarp();
    if (lane < a.cs) mbar_arrive_remote(&empty[s], lane);
  };

  if (warp == PRODUCER_WARP) {
    // one thread keeps the ring full
    if (lane == 0) {
      const uint16_t mask = (uint16_t)((1u << a.cs) - 1u);
      for (int64_t u = special_clusterid(); u < a.units;
           u += special_nclusters()) {
        const int k0 = unit_k0(u), n0 = unit_n0(u);
        const bool active = k0 < a.k;
        // stage s <- rows d0.. of this CTA's Pi tile and of the cluster's
        // A tile, this CTA's boxes of it into every CTA
        auto issue = [&](int s, int d0) {
          const uint32_t stage = ring_s + s * STAGE_BYTES;
          mbar_expect(&full[s], (active ? PI_TILE_BYTES : 0) + A_TILE_BYTES);
          if (active) tma_load(&pi_map, &full[s], stage, d0, k0);
          for (int b = rank; b < A_BOXES; b += a.cs)
            tma_multicast(&a_map, &full[s],
                          stage + PI_TILE_BYTES +
                              (b / BOXES_PER_HALF) * A_HALF_BYTES +
                              (b % BOXES_PER_HALF) * BOX_BYTES,
                          n0 + (b / BOXES_PER_HALF) * BOX_COLS,
                          d0 + (b % BOXES_PER_HALF) * BOX_ROWS, mask);
        };
        for (int64_t step = 0; step < n_steps; ++step) {
          // every reader warp of the cluster is done with the slot
          mbar_wait(&empty[slot], phase ^ 1u);
          issue(slot, (int)(step * BK));
          advance();
        }
      }
    }
    __syncwarp();
  } else if (warp == NORM_WARP || warp == NORM_WARP + 1) {
    // the norm warps: columns 2 c and 2 c + 1 of each stage's A tile, all
    // BK rows (warp NORM_WARP + h reads whole 128-byte rows of half h);
    // they sum only in the CTA of row block 0, but release every stage
    const int c = (warp - NORM_WARP) * 32 + lane;
    const int chunk = (c % 32) / 4, pos = 4 * (c % 4);
    for (int64_t u = special_clusterid(); u < a.units;
         u += special_nclusters()) {
      const int n0 = unit_n0(u);
      const bool do_norms = unit_k0(u) == 0;
      float nrm0 = 0.f, nrm1 = 0.f;
      for (int64_t step = 0; step < n_steps; ++step) {
        mbar_wait(&full[slot], phase);
        if (do_norms) {
          // summed per stage, then into nrm
          const unsigned char* at = ring + slot * STAGE_BYTES +
                                    PI_TILE_BYTES + (c / 32) * A_HALF_BYTES;
          // even and odd rows in separate sums: two FMA chains a column
          float s0[2] = {0.f, 0.f}, s1[2] = {0.f, 0.f};
#pragma unroll 16
          for (int row = 0; row < BK; ++row) {
            const uint32_t w = *reinterpret_cast<const uint32_t*>(
                at + row * 128 + ((chunk ^ (row & 7)) << 4) + pos);
            const float lo = __uint_as_float(w << 16);
            const float hi = __uint_as_float(w & 0xffff0000u);
            s0[row % 2] = fmaf(lo, lo, s0[row % 2]);
            s1[row % 2] = fmaf(hi, hi, s1[row % 2]);
          }
          nrm0 += s0[0] + s0[1];
          nrm1 += s1[0] + s1[1];
        }
        release(slot);
        advance();
      }
      const int col = n0 + 2 * c;
      if (do_norms && col < a.n) a.norm2[col] = nrm0;
      if (do_norms && col + 1 < a.n) a.norm2[col + 1] = nrm1;
    }
  } else if (warp < BF16_CONSUMER_WARPS) {
    // the consumers: warpgroup wg owns rows 64 wg.. of the output tile
    const int wg = warp / 4;
    const int g = lane / 4, q = lane % 4;
    const int row0 = wg * 64 + (warp % 4) * 16 + g;  // and row0 + 8
    float acc[64], part[64];
    // wait for the next stage and run its wgmma into part (fresh where
    // first); returns its slot
    auto take = [&](bool first) {
      const int s = slot;
      mbar_wait(&full[s], phase);
      const uint32_t pi_s = ring_s + s * STAGE_BYTES + wg * 64 * BK * 2;
      const uint32_t a_s = ring_s + s * STAGE_BYTES + PI_TILE_BYTES;
      reg_fence(part);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n128k16(part, sw128_desc(pi_s + 32 * kk, 16, 1024),
                         sw128_desc(a_s + 16 * 128 * kk, A_HALF_BYTES, 1024),
                         kk > 0 || !first);
      wgmma_commit();
      reg_fence(part);
      advance();
      return s;
    };
    for (int64_t u = special_clusterid(); u < a.units;
         u += special_nclusters()) {
      const int k0 = unit_k0(u), n0 = unit_n0(u);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      // chains of CHAIN_STAGES stages, each into a fresh part that is then
      // added to acc; warpgroup 1's chains are offset by half a chain, so
      // that one warpgroup's wgmma run while the other adds
      int64_t c0 = 0;
      int len = wg ? (CHAIN_STAGES + 1) / 2 : CHAIN_STAGES;
      while (c0 < n_steps) {
        if (len > n_steps - c0) len = (int)(n_steps - c0);
        int prev = take(true);
        for (int j = 1; j < len; ++j) {
          const int s = take(false);
          wgmma_wait<1>();  // the stage before has been read
          release(prev);
          prev = s;
        }
        wgmma_wait<0>();
        release(prev);
        reg_fence(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
        c0 += len;
        len = CHAIN_STAGES;
      }
      // the accumulator's layout: register 4 j + 2 h + e holds row
      // row0 + 8 h, column 8 j + 2 q + e of the warp's block
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = k0 + row0 + 8 * h;
        if (row >= a.k) continue;
        float* dst = a.out + (int64_t)row * a.n;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * q;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (a.pairs && col + 1 < a.n) {
            *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
          } else {
            if (col < a.n) dst[col] = v0;
            if (col + 1 < a.n) dst[col + 1] = v1;
          }
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still arrive on it
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

// A bf16 matrix of `rows` x `cols` whose rows lie `pitch` elements apart,
// in boxes of box_rows x box_cols, 128-byte swizzle, zeros past its edges.
bool encode_bf16(CUtensorMap* map, const void* base, int64_t rows,
                 int64_t cols, int64_t pitch, int box_rows, int box_cols) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A launch config of one cluster of cs CTAs, and the clusters of that size
// the card holds at once.
cudaError_t bf16_config(int cs, cudaStream_t stream,
                        cudaLaunchAttribute (&attr)[1],
                        cudaLaunchConfig_t& cfg, int& active) {
  cudaError_t err = cudaFuncSetAttribute(
      sketch_fused_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BF16_SMEM);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)cs);
  cfg.blockDim = dim3(BF16_THREADS);
  cfg.dynamicSmemBytes = BF16_SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(&active, sketch_fused_bf16_kernel,
                                        &cfg);
}

// Pi's rows at a pitch of d rounded up to 8 elements, A's at n rounded up
// to 8, both from 16-byte aligned bases (TMA's rule; the wrapper copies
// where the caller's tensors are not so).
int launch_bf16(const __nv_bfloat16* Pi, const __nv_bfloat16* A, float* out,
                float* norm2, int64_t k, int64_t d, int64_t n,
                cudaStream_t stream) {
  if ((uintptr_t)Pi % 16 || (uintptr_t)A % 16 || d >= (1LL << 31) ||
      k >= (1LL << 31) || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  CUtensorMap pi_map, a_map;
  if (!encode_bf16(&pi_map, Pi, k, d, (d + 7) / 8 * 8, BM, BK) ||
      !encode_bf16(&a_map, A, d, n, (n + 7) / 8 * 8, BOX_ROWS, BOX_COLS))
    return (int)cudaErrorInvalidValue;
  const int64_t k_blocks = (k + BM - 1) / BM;
  Bf16Args a;
  a.out = out;
  a.norm2 = norm2;
  a.k = (int)k;
  a.n = (int)n;
  a.d = d;
  a.cs = (int)(k_blocks < BF16_CLUSTER_MAX ? k_blocks : BF16_CLUSTER_MAX);
  a.row_groups = (int)((k_blocks + a.cs - 1) / a.cs);
  a.units = (int64_t)a.row_groups * ((n + BN - 1) / BN);
  a.pairs = n % 2 == 0 && (uintptr_t)out % 8 == 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  int active = 0;
  cudaError_t err = bf16_config(a.cs, stream, attr, cfg, active);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  // as many clusters as are resident at once, or fewer if there are fewer
  // units
  const int64_t clusters = a.units < active ? a.units : active;
  cfg.gridDim = dim3((unsigned)(clusters * a.cs));
  err = cudaLaunchKernelEx(&cfg, sketch_fused_bf16_kernel, pi_map, a_map, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each returns the cudaError_t of the
// launch (0 on success); it neither synchronises nor allocates. The bf16
// entry reads rows at pitches rounded up to 8 elements (launch_bf16).
extern "C" int sketch_fused_f32(const float* Pi, const float* A, float* out,
                                float* norm2, int64_t k, int64_t d, int64_t n,
                                void* stream) {
  return launch<float>(Pi, A, out, norm2, k, d, n, stream);
}

extern "C" int sketch_fused_bf16(const __nv_bfloat16* Pi,
                                 const __nv_bfloat16* A, float* out,
                                 float* norm2, int64_t k, int64_t d, int64_t n,
                                 void* stream) {
  return launch_bf16(Pi, A, out, norm2, k, d, n,
                     static_cast<cudaStream_t>(stream));
}

// The clusters of the bf16 instance the card holds at once for k rows of
// Pi (a cluster of min(ceil(k / 128), 4) CTAs), or minus a cudaError_t.
extern "C" int sketch_fused_bf16_clusters(int64_t k) {
  const int64_t k_blocks = (k + BM - 1) / BM;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  int active = 0;
  const cudaError_t err = bf16_config(
      (int)(k_blocks < BF16_CLUSTER_MAX ? k_blocks : BF16_CLUSTER_MAX), 0,
      attr, cfg, active);
  return err == cudaSuccess ? active : -(int)err;
}
