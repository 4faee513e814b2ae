// sketch_fused.cu: Pi @ A and the squared column norms of A, in one read of A.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sketch_fused.py::sketch_fused
// (body _kernel). Pi is (k, d), A is (d, n), both row-major, float32 or bf16;
// out is (k, n) float32 and norm2 is (n,) float32. Accumulation is float32.
//
// What bounds it on an H100: operations. The product is 2*k*d*n FLOP on the
// float32 FMA units (67 TFLOP/s), while its bytes, (k*d + d*n + k*n)*4, take
// about a quarter of that time at 3.35 TB/s for k = 512.
//
// Design:
//  * The Pallas kernel walks d as a sequential grid axis and adds into an
//    output block it revisits; GPU blocks run in parallel and in no order, so
//    that would race. Here each CTA owns one BM x BN tile of the output and
//    loops over d itself, so every output element is written once, with no
//    atomics, and the result is deterministic.
//  * Classic register-tiled SIMT GEMM: per step, a BM x BK tile of Pi
//    (stored transposed) and a BK x BN tile of A go to shared memory, and
//    each of the 256 threads updates an 8 x 8 block of accumulators. Two
//    shared-memory stages: the next step's tiles are loaded into registers
//    while the current one multiplies, so one barrier per step suffices.
//  * Only the CTAs of k-tile 0 add up the column norms, from the A tile
//    already in shared memory; every other k-tile would count them again.
//  * Ragged d, k and n are masked (zeros past the edge), not padded.
//  * CTAs are numbered k-tile first, so the k/BM CTAs that read the same
//    columns of A run side by side and share them through L2.
// No tensor cores yet: wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // sketch rows (rows of Pi) per CTA
constexpr int BN = 128;  // columns of A per CTA
constexpr int BK = 16;   // rows of A (the streamed dimension d) per step
constexpr int TM = 8;    // accumulator rows per thread
constexpr int TN = 8;    // accumulator columns per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;   // keeps the transposed stores of Pi off one bank
// Two CTAs per SM cap a thread at 128 registers (a few bytes spill); with
// one CTA per SM the kernel has too few warps to hide its memory latency.
constexpr int MIN_BLOCKS = 2;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
sketch_fused_kernel(const T* __restrict__ Pi, const T* __restrict__ A,
                    float* __restrict__ out, float* __restrict__ norm2,
                    int k, int64_t d, int n) {
  // Two stages: threads fill one while they multiply out of the other.
  __shared__ __align__(16) float Ps[2][BK][BM + PAD];  // Ps[.][dd][kk] = Pi[kk][dd]
  __shared__ __align__(16) float As[2][BK][BN];        // As[.][dd][nn] = A[dd][nn]
  constexpr int PI_LOADS = BM * BK / THREADS;  // Pi values a thread loads per step
  constexpr int A_LOADS = BN * BK / THREADS;   // A values a thread loads per step
  constexpr int A_ROW_STEP = THREADS / BN;     // rows between a thread's A loads

  const int k_tiles = (k + BM - 1) / BM;
  const int kt = blockIdx.x % k_tiles;
  const int nt = blockIdx.x / k_tiles;
  const int k0 = kt * BM;
  const int n0 = nt * BN;
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // column group
  const int ty = tid / (BN / TN);  // row group
  const bool do_norms = (kt == 0);

  // This thread's share of a step: PI_LOADS consecutive d of one row of Pi,
  // and one column of A on A_LOADS rows A_ROW_STEP apart (neighbouring
  // threads on neighbouring columns, so the reads of A coalesce).
  const int pr = tid / (BK / PI_LOADS);
  const int pc = (tid % (BK / PI_LOADS)) * PI_LOADS;
  const int ar = tid / BN;
  const int ac = tid % BN;
  const bool pi_row_ok = k0 + pr < k;
  const bool a_col_ok = n0 + ac < n;
  const T* pi_ptr = Pi + (int64_t)(pi_row_ok ? k0 + pr : 0) * d + pc;
  const T* a_ptr = A + (int64_t)ar * n + (a_col_ok ? n0 + ac : 0);
  const int64_t a_row_step = (int64_t)A_ROW_STEP * n;

  float pi_reg[PI_LOADS];
  float a_reg[A_LOADS];
  // Global -> registers for the step starting at row d0 of A.
  auto load = [&](int64_t d0) {
#pragma unroll
    for (int i = 0; i < PI_LOADS; ++i)
      pi_reg[i] = (pi_row_ok && d0 + pc + i < d) ? to_f32(pi_ptr[d0 + i]) : 0.f;
    const T* a_row = a_ptr + d0 * n;
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i)
      a_reg[i] = (a_col_ok && d0 + ar + i * A_ROW_STEP < d)
                     ? to_f32(a_row[i * a_row_step]) : 0.f;
  };
  // Registers -> shared stage s (Pi transposed).
  auto store = [&](int s) {
#pragma unroll
    for (int i = 0; i < PI_LOADS; ++i) Ps[s][pc + i][pr] = pi_reg[i];
#pragma unroll
    for (int i = 0; i < A_LOADS; ++i) As[s][ar + i * A_ROW_STEP][ac] = a_reg[i];
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float nrm = 0.f;

  load(0);
  store(0);
  __syncthreads();
  int s = 0;
  for (int64_t d0 = 0; d0 < d; d0 += BK) {
    const bool more = d0 + BK < d;
    if (more) load(d0 + BK);  // in flight while this step multiplies

    if (do_norms && tid < BN) {
#pragma unroll
      for (int r = 0; r < BK; ++r) {
        const float v = As[s][r][tid];
        nrm = fmaf(v, v, nrm);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      // Thread rows ty*4..+3 and BM/2+ty*4..+3, columns likewise: each
      // float4 read by a quarter warp is one contiguous 256-byte run.
      const float4 a0 = *reinterpret_cast<const float4*>(&Ps[s][kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&Ps[s][kk][BM / 2 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&As[s][kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&As[s][kk][BN / 2 + tx * 4]);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) store(s ^ 1);  // the other stage: last read before the barrier
    __syncthreads();
    s ^= 1;
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = k0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + (i - 4));
    if (row >= k) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : BN / 2 + tx * 4 + (j - 4));
      if (col < n) out[(int64_t)row * n + col] = acc[i][j];
    }
  }
  if (do_norms && tid < BN && n0 + tid < n) norm2[n0 + tid] = nrm;
}

template <typename T>
int launch(const T* Pi, const T* A, float* out, float* norm2, int64_t k,
           int64_t d, int64_t n, void* stream) {
  const int64_t tiles = ((k + BM - 1) / BM) * ((n + BN - 1) / BN);
  sketch_fused_kernel<T><<<(unsigned)tiles, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      Pi, A, out, norm2, (int)k, d, (int)n);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each returns the cudaError_t of the
// launch (0 on success); it neither synchronises nor allocates.
extern "C" int sketch_fused_f32(const float* Pi, const float* A, float* out,
                                float* norm2, int64_t k, int64_t d, int64_t n,
                                void* stream) {
  return launch<float>(Pi, A, out, norm2, k, d, n, stream);
}

extern "C" int sketch_fused_bf16(const __nv_bfloat16* Pi,
                                 const __nv_bfloat16* A, float* out,
                                 float* norm2, int64_t k, int64_t d, int64_t n,
                                 void* stream) {
  return launch<__nv_bfloat16>(Pi, A, out, norm2, k, d, n, stream);
}
