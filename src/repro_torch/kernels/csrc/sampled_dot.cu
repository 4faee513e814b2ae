// sampled_dot.cu: the rescaled-JL estimates (Eq. 2) at m sampled entries.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/sampled_dot.py::sampled_rescaled_dot (body _kernel):
//
//   out[t] = nA[rows[t]] * nB[cols[t]] * <As[rows[t]], Bs[cols[t]]>
//            / max(|As[rows[t]]| * |Bs[cols[t]]|, 1e-12)
//
// As (n1, k) and Bs (n2, k) are the row-major sketches (float32 or bf16),
// nA and nB the exact column norms, rows and cols int32 (m,), out float32.
// Duplicate pairs are allowed; m = 0 is handled by the caller (no launch).
//
// What bounds it on an H100: counted once, its inputs are small, so the
// function's bound is its 2*m*k FLOP of dot products (each row's norm needs
// only 2*k more, once per row). But each sample gathers two k-float rows,
// about 2*k*4 bytes, from wherever they lie; the sketches are larger than
// the 50 MB L2, so the gather traffic, not the arithmetic, sets its time.
// That is also why the warp recomputes both row norms from the rows it has
// already loaded (6*m*k FLOP in all) rather than read them from elsewhere.
//
// Design: the TPU kernel's scalar prefetch and one-row-per-grid-step DMA
// have no counterpart here. One warp owns one sample: it loads its two
// indices, the 32 lanes read the two rows in coalesced 128-byte runs,
// accumulate the dot product and both squared norms in float32, and reduce
// the three sums with warp shuffles. Lane 0 applies the norms and the same
// max(., 1e-12) guard and writes the estimate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;  // samples per CTA
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
sampled_dot_kernel(const T* __restrict__ As, const T* __restrict__ Bs,
                   const float* __restrict__ nA, const float* __restrict__ nB,
                   const int32_t* __restrict__ rows,
                   const int32_t* __restrict__ cols, float* __restrict__ out,
                   int64_t m, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t t = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (t >= m) return;  // uniform across the warp
  const int32_t r = rows[t];
  const int32_t c = cols[t];
  const T* a = As + (int64_t)r * k;
  const T* b = Bs + (int64_t)c * k;
  float dot = 0.f, sa = 0.f, sb = 0.f;
#pragma unroll 4
  for (int i = lane; i < k; i += 32) {
    const float x = to_f32(a[i]);
    const float y = to_f32(b[i]);
    dot = fmaf(x, y, dot);
    sa = fmaf(x, x, sa);
    sb = fmaf(y, y, sb);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(FULL, dot, off);
    sa += __shfl_xor_sync(FULL, sa, off);
    sb += __shfl_xor_sync(FULL, sb, off);
  }
  if (lane == 0) {
    const float denom = fmaxf(sqrtf(sa) * sqrtf(sb), 1e-12f);
    out[t] = dot * nA[r] * nB[c] / denom;
  }
}

template <typename T>
int launch(const T* As, const T* Bs, const float* nA, const float* nB,
           const int32_t* rows, const int32_t* cols, float* out, int64_t m,
           int64_t k, void* stream) {
  const int64_t blocks = (m + WARPS - 1) / WARPS;
  sampled_dot_kernel<T><<<(unsigned)blocks, WARPS * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      As, Bs, nA, nB, rows, cols, out, m, (int)k);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each returns the cudaError_t of the
// launch (0 on success); it neither synchronises nor allocates.
extern "C" int sampled_dot_f32(const float* As, const float* Bs,
                               const float* nA, const float* nB,
                               const int32_t* rows, const int32_t* cols,
                               float* out, int64_t m, int64_t k,
                               void* stream) {
  return launch<float>(As, Bs, nA, nB, rows, cols, out, m, k, stream);
}

extern "C" int sampled_dot_bf16(const __nv_bfloat16* As,
                                const __nv_bfloat16* Bs, const float* nA,
                                const float* nB, const int32_t* rows,
                                const int32_t* cols, float* out, int64_t m,
                                int64_t k, void* stream) {
  return launch<__nv_bfloat16>(As, Bs, nA, nB, rows, cols, out, m, k, stream);
}
