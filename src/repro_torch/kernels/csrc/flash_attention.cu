// flash_attention.cu: forward softmax attention with the online softmax.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention (body _kernel) and
// the head expansion of its wrapper (src/repro/kernels/ops.py::_flash_call):
//
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] / sqrt(Dh)) v[b, j, g]
//
// with g = h / (H / Hkv) the KV head that query head h reads (GQA), keys
// j > i masked to -1e30 when causal, the scale applied to q before the
// product, float32 running max, denominator and accumulator, the
// denominator clamped at 1e-30, and the output in the input dtype. q is
// (B, S, H, Dh), k and v (B, S, Hkv, Dh), each read in place through its
// own strides (unit stride along Dh), so no repeated or folded copy exists;
// o is (B, S, H, Dh), contiguous. float32 or bf16 in; the arithmetic is
// float32 whatever the input, as the TPU kernel casts its tiles to f32.
//
// What bounds it on an H100: operations. Causal attention does 2 * S^2 * Dh
// FLOP per head (QK^T and PV, half the square each): 8.80e12 at S = 32,768
// with 32 heads of 128, 131 ms at 67 TFLOP/s on the float32 FMA units,
// against 0.4 ms for its bytes. Its S^2 / 2 exponentials per head go to
// the special-function units, about 4 ms.
//
// Design:
//  * The TPU grid walks the k-blocks in order and carries the running max,
//    denominator and accumulator in scratch from one grid step to the next.
//    Blocks on a GPU run in parallel and in no order, so here one CTA owns
//    one BQ x Dh query tile of one (b, h) and loops over the k-tiles
//    itself, with the running state in registers.
//  * The query tile, scaled, stays in shared memory; each k-tile of BK keys
//    and values is staged in shared memory. A thread owns 8 query rows
//    (ty + RG * i) and BK / 16 key columns (tx + 16 * j) of the scores, and
//    the same 8 rows by Dh / 16 columns of the accumulator: register-tiled
//    float32 FMAs, no tensor cores (a bf16 wgmma version would change the
//    numbers the kernel is held to).
//  * A row's 16 column threads are one half-warp, so its max is reduced
//    with shuffles; the denominator stays a per-thread partial sum, reduced
//    once at the end (every update scales all partials by the same factor).
//  * The probabilities go through shared memory (in the K tile's space,
//    which is free by then) to the PV product.
//  * Causal: the loop stops at the tile that holds the diagonal. That is
//    exact: a fully masked tile would add exp(-1e30 - m) = 0 to every sum,
//    and tile 0 holds an unmasked key for every row. CTAs are numbered
//    heaviest query tile first, so the short tiles fill the last wave.
//  * Shared-memory pitches: Q and K rows Dh + 4 floats (the K reads of 16
//    lanes on 16 rows fall in distinct banks), P rows BK + 16 (the two rows
//    of a warp land 16 banks apart).
//  * Tiles compiled: BQ in {64, 128} (128 or 256 threads), BK in
//    {32, 64, 128}, Dh in {32, 64, 128}; kernels/flash_attention.py holds
//    the same menu and refuses anything else before a launch.
// Not yet done: tensor cores, TMA, overlapping the next tile's loads with
// this tile's products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 16;   // column threads per query row: one half-warp
constexpr int RPT = 8;   // query rows per thread
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

template <int BQ, int BK, int DH>
struct Tile {
  static constexpr int RG = BQ / RPT;               // row groups
  static constexpr int THREADS = RG * TX;           // 128 or 256
  static constexpr int SC = BK / TX;                // score columns a thread
  static constexpr int OC = DH / TX;                // output columns a thread
  static constexpr int OV = OC < 4 ? OC : 4;        // their vector width
  static constexpr int LDQ = DH + 4;                // Q and K row pitch
  static constexpr int LDP = BK + 16;               // P row pitch
  static constexpr int LDV = DH;                    // V row pitch
  static constexpr int KP = BK * LDQ > BQ * LDP ? BK * LDQ : BQ * LDP;
  static constexpr int SMEM_FLOATS = BQ * LDQ + KP + BK * LDV;
};

struct Params {
  int64_t S, H, Hkv, BH;
  int64_t sqb, sqs, sqh, skb, sks, skh, svb, svs, svh;
  float scale;
  int causal;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// N consecutive floats of shared memory into registers.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float* dst) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    dst[0] = t.x; dst[1] = t.y;
  } else {
    dst[0] = p[0];
  }
}

template <int BQ, int BK, int DH, typename T>
__global__ void __launch_bounds__(Tile<BQ, BK, DH>::THREADS)
flash_fwd(const T* __restrict__ Q, const T* __restrict__ K,
          const T* __restrict__ V, T* __restrict__ O, Params p) {
  using Tl = Tile<BQ, BK, DH>;
  constexpr int RG = Tl::RG, SC = Tl::SC, OC = Tl::OC, OV = Tl::OV;
  constexpr int LDQ = Tl::LDQ, LDP = Tl::LDP, LDV = Tl::LDV;
  constexpr int THREADS = Tl::THREADS;
  constexpr int CH = DH / 4;  // 4-element chunks per row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // [BQ][LDQ], scaled
  float* KP = Qs + BQ * LDQ;   // K tile [BK][LDQ], then P [BQ][LDP]
  float* Vs = KP + Tl::KP;     // [BK][LDV]

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int64_t nqt = p.S / BQ;
  const int64_t qt = nqt - 1 - (int64_t)blockIdx.x / p.BH;  // heaviest first
  const int64_t bh = (int64_t)blockIdx.x % p.BH;
  const int64_t b = bh / p.H;
  const int64_t h = bh % p.H;
  const int64_t g = h / (p.H / p.Hkv);
  const int64_t q0 = qt * BQ;
  const T* Qb = Q + b * p.sqb + h * p.sqh;
  const T* Kb = K + b * p.skb + g * p.skh;
  const T* Vb = V + b * p.svb + g * p.svh;

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, d = (c % CH) * 4;
    float4 x = load4(Qb + (q0 + r) * p.sqs + d);
    x.x *= p.scale; x.y *= p.scale; x.z *= p.scale; x.w *= p.scale;
    *reinterpret_cast<float4*>(&Qs[r * LDQ + d]) = x;
  }

  float m[RPT], l[RPT], o[RPT][OC];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.f;
  }

  const int64_t n_kt = p.causal ? (q0 + BQ - 1) / BK + 1 : p.S / BK;
  for (int64_t kt = 0; kt < n_kt; ++kt) {
    const int64_t k0 = kt * BK;
    for (int c = tid; c < BK * CH; c += THREADS) {
      const int r = c / CH, d = (c % CH) * 4;
      *reinterpret_cast<float4*>(&KP[r * LDQ + d]) =
          load4(Kb + (k0 + r) * p.sks + d);
      *reinterpret_cast<float4*>(&Vs[r * LDV + d]) =
          load4(Vb + (k0 + r) * p.svs + d);
    }
    __syncthreads();

    // scores s = (scale q) k^T for 8 rows x SC columns
    float s[RPT][SC];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DH; d += 4) {
      float4 kv[SC];
#pragma unroll
      for (int j = 0; j < SC; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&KP[(tx + TX * j) * LDQ + d]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&Qs[(ty + RG * i) * LDQ + d]);
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    if (p.causal && k0 + BK - 1 > q0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < SC; ++j)
          if (k0 + tx + TX * j > q0 + ty + RG * i) s[i][j] = NEG;
    }

    // online softmax: new running max, rescale, probabilities
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float mx = s[i][0];
#pragma unroll
      for (int j = 1; j < SC; ++j) mx = fmaxf(mx, s[i][j]);
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float corr = expf(m[i] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        s[i][j] = expf(s[i][j] - mn);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < OC; ++c) o[i][c] *= corr;
      m[i] = mn;
    }
    __syncthreads();  // every thread is done reading the K tile
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < SC; ++j)
        KP[(ty + RG * i) * LDP + tx + TX * j] = s[i][j];
    __syncthreads();

    // o += P v
#pragma unroll 2
    for (int j = 0; j < BK; j += 4) {
      float4 pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&KP[(ty + RG * i) * LDP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[OC];
#pragma unroll
        for (int gq = 0; gq < OC / OV; ++gq)
          load_vec<OV>(&Vs[(j + jj) * LDV + gq * TX * OV + tx * OV],
                       &vv[gq * OV]);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const float pij = comp(pv[i], jj);
#pragma unroll
          for (int c = 0; c < OC; ++c) o[i][c] = fmaf(pij, vv[c], o[i][c]);
        }
      }
    }
    __syncthreads();  // before the next tile overwrites K/P and V
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      li += __shfl_xor_sync(FULL, li, off);
    const float denom = fmaxf(li, 1e-30f);
    const int64_t row = q0 + ty + RG * i;
    T* orow = O + ((b * p.S + row) * p.H + h) * DH;
#pragma unroll
    for (int gq = 0; gq < OC / OV; ++gq)
#pragma unroll
      for (int e = 0; e < OV; ++e)
        store1(orow + gq * TX * OV + tx * OV + e, o[i][gq * OV + e] / denom);
  }
}

template <int BQ, int BK, int DH, typename T>
int launch_tile(const T* q, const T* k, const T* v, T* o, const Params& p,
                cudaStream_t s) {
  using Tl = Tile<BQ, BK, DH>;
  constexpr int bytes = Tl::SMEM_FLOATS * (int)sizeof(float);
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<BQ, BK, DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (attr != cudaSuccess) return (int)attr;
  const int64_t blocks = (p.S / BQ) * p.BH;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd<BQ, BK, DH, T><<<(unsigned)blocks, Tl::THREADS, bytes, s>>>(
      q, k, v, o, p);
  return (int)cudaGetLastError();
}

template <int BQ, int BK, typename T>
int launch_dh(int64_t dh, const T* q, const T* k, const T* v, T* o,
              const Params& p, cudaStream_t s) {
  switch (dh) {
    case 32: return launch_tile<BQ, BK, 32, T>(q, k, v, o, p, s);
    case 64: return launch_tile<BQ, BK, 64, T>(q, k, v, o, p, s);
    case 128: return launch_tile<BQ, BK, 128, T>(q, k, v, o, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int BQ, typename T>
int launch_bk(int64_t bk, int64_t dh, const T* q, const T* k, const T* v,
              T* o, const Params& p, cudaStream_t s) {
  switch (bk) {
    case 32: return launch_dh<BQ, 32, T>(dh, q, k, v, o, p, s);
    case 64: return launch_dh<BQ, 64, T>(dh, q, k, v, o, p, s);
    case 128: return launch_dh<BQ, 128, T>(dh, q, k, v, o, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int run(const T* q, const T* k, const T* v, T* o, int64_t B, int64_t S,
        int64_t H, int64_t Hkv, int64_t Dh, const int64_t* strides, float scale,
        int64_t causal, int64_t bq, int64_t bk, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || Hkv <= 0 || bq <= 0 || bk <= 0 ||
      H % Hkv || S % bq || S % bk)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.S = S; p.H = H; p.Hkv = Hkv; p.BH = B * H;
  p.sqb = strides[0]; p.sqs = strides[1]; p.sqh = strides[2];
  p.skb = strides[3]; p.sks = strides[4]; p.skh = strides[5];
  p.svb = strides[6]; p.svs = strides[7]; p.svh = strides[8];
  p.scale = scale;
  p.causal = causal ? 1 : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bq) {
    case 64: return launch_bk<64, T>(bk, Dh, q, k, v, o, p, s);
    case 128: return launch_bk<128, T>(bk, Dh, q, k, v, o, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry points for ctypes. ``strides`` holds the (batch, sequence,
// head) strides of q, k and v in elements, nine int64 values on the host.
// Each returns the cudaError_t of its launch (0 on success, and
// cudaErrorInvalidValue for a shape or tile that is not compiled); it
// neither synchronises nor allocates.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int64_t B,
                                   int64_t S, int64_t H, int64_t Hkv,
                                   int64_t Dh, const int64_t* strides,
                                   float scale, int64_t causal, int64_t bq,
                                   int64_t bk, void* stream) {
  return run<float>(q, k, v, o, B, S, H, Hkv, Dh, strides, scale, causal, bq,
                    bk, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int64_t B, int64_t S, int64_t H,
                                    int64_t Hkv, int64_t Dh,
                                    const int64_t* strides, float scale,
                                    int64_t causal, int64_t bq, int64_t bk,
                                    void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, S, H, Hkv, Dh, strides, scale,
                            causal, bq, bk, stream);
}
