// sampled_dot.cu: the rescaled-JL estimates (Eq. 2) at m sampled entries.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/sampled_dot.py::sampled_rescaled_dot (body _kernel):
//
//   out[t] = nA[rows[t]] * nB[cols[t]] * <As[rows[t]], Bs[cols[t]]>
//            / max(|As[rows[t]]| * |Bs[cols[t]]|, 1e-12)
//
// As (n1, k) and Bs (n2, k) are the row-major sketches (float32 or bf16),
// nA and nB the exact column norms, rows and cols int32 (m,), out float32
// in sample order. Duplicate pairs are allowed; m = 0 is handled by the
// caller (no launch).
//
// What bounds it on an H100: counted once, its inputs are small, so the
// function's bound is its 2*m*k FLOP of dot products (each row's norm needs
// only 2*k more, once per row). But each sample needs one k-float row of
// each sketch, and the sketches are larger than the 50 MB L2: one warp per
// sample, the first design, gathered both rows from device memory, about
// 2*k*4 bytes a sample, and ran at the memory's rate on traffic it did not
// need (a row of the uniform side fetched some 288 times at the slice).
// Bucketed, one of the two rows a sample still comes from L2 (the other
// stays in registers), so m*k*4 bytes from L2 is this design's floor.
//
// Design: bucket the samples so that each sketch row crosses device memory
// a bounded number of times.
//  1. Bucket order. The bucket of sample t is (cols[t] / cblock, rows[t]),
//     column blocks first; cblock (chosen by the caller) makes a column
//     block of Bs a few MB, so that it stays in L2 while its buckets are
//     worked. The samples are put in bucket order by a least-significant-
//     digit radix sort of the bucket ids, 8 bits a pass: a per-tile digit
//     histogram, an exclusive integer scan of it (digit-major), and a
//     stable scatter that ranks a tile's samples in shared memory and
//     writes each digit's run contiguously. No atomics outside shared
//     memory, and a deterministic order. Indices out of range get a key no
//     bucket has and raise a flag the caller reads; the gather skips them.
//  2. Row norms. Each sketch row's squared norm, once (one warp a row),
//     where the first design recomputed both for every sample.
//  3. Gather pass. Warps take 32 consecutive samples of the bucket order,
//     so CTAs that run together share one column block of Bs. A warp holds
//     As[row] in registers (k / 32 floats a lane, up to k = 512; beyond,
//     the row is re-read from L1), and per sample gathers Bs[col] from L2
//     (or L1, for the hot columns), forms the dot product and writes
//     out[t]. A long bucket is cut into these 32-sample segments, each
//     reloading its A row.
// Each sample's arithmetic is that of the first design: the lane-strided
// fmaf over k, the same __shfl_xor_sync tree, the same final expression
// (the norms' chains and trees are the ones it ran per sample).
// A value therefore does not depend on which warp computes it: the output
// is the same bit for bit from run to run and equal to the
// one-warp-per-sample kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;           // warps per gather CTA
constexpr int SEG = 32;            // bucket-ordered samples a warp takes
constexpr int PACK_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 4;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
constexpr int RADIX_BITS = 8;
constexpr int BINS = 1 << RADIX_BITS;
constexpr int SORT_THREADS = BINS;  // one thread a digit in the tile scans
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int SORT_ITEMS = 8;
constexpr int SORT_TILE = SORT_THREADS * SORT_ITEMS;  // samples a sort CTA
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned NO_BUCKET = 0xffffffffu;  // the key of a bad index

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Each sample's bucket id and (t, col); NO_BUCKET and *flag = 1 when an
// index is out of range.
__global__ void __launch_bounds__(PACK_THREADS)
pack_kernel(const int32_t* __restrict__ rows, const int32_t* __restrict__ cols,
            int64_t m, int n1, int n2, int cblock, unsigned* __restrict__ keys,
            int2* __restrict__ vals, int32_t* flag) {
  const int64_t step = (int64_t)gridDim.x * PACK_THREADS;
  for (int64_t t = (int64_t)blockIdx.x * PACK_THREADS + threadIdx.x; t < m;
       t += step) {
    const int r = rows[t];
    const int c = cols[t];
    unsigned key = NO_BUCKET;
    if (r >= 0 && r < n1 && c >= 0 && c < n2)
      key = (unsigned)(c / cblock) * (unsigned)n1 + (unsigned)r;
    else
      *flag = 1;
    keys[t] = key;
    vals[t] = make_int2((int)t, c);
  }
}

// Exclusive scan of a thread's SCAN_ITEMS values across the CTA; returns
// the CTA's total. ws: 33 ints of shared memory.
__device__ __forceinline__ int block_exclusive_scan(int (&v)[SCAN_ITEMS],
                                                    int* ws) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  int s = 0;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) {
    const int x = v[i];
    v[i] = s;
    s += x;
  }
  int inc = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int own = ws[lane];  // SCAN_THREADS / 32 == 32 warps
    int winc = own;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, winc, off);
      if (lane >= off) winc += y;
    }
    ws[lane] = winc - own;
    if (lane == 31) ws[32] = winc;
  }
  __syncthreads();
  const int offset = ws[warp] + inc - s;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) v[i] += offset;
  const int total = ws[32];
  __syncthreads();  // ws may be reused
  return total;
}

__device__ __forceinline__ void load_tile(const int32_t* src, int64_t n,
                                          int64_t tile, int (&v)[SCAN_ITEMS]) {
  const int64_t i0 = tile * SCAN_TILE + (int64_t)threadIdx.x * SCAN_ITEMS;
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i) v[i] = i0 + i < n ? src[i0 + i] : 0;
}

// Scan step 1: each tile's total.
__global__ void __launch_bounds__(SCAN_THREADS)
tile_sums(const int32_t* __restrict__ in, int64_t n,
          int32_t* __restrict__ tsum) {
  __shared__ int ws[33];
  int v[SCAN_ITEMS];
  load_tile(in, n, blockIdx.x, v);
  const int total = block_exclusive_scan(v, ws);
  if (threadIdx.x == 0) tsum[blockIdx.x] = total;
}

// Scan step 2, one CTA: the tiles' totals into exclusive offsets, in place.
__global__ void __launch_bounds__(SCAN_THREADS)
tile_offsets(int32_t* tsum, int64_t ntiles) {
  __shared__ int ws[33];
  int carry = 0;
  for (int64_t t = 0; t * SCAN_TILE < ntiles; ++t) {
    int v[SCAN_ITEMS];
    load_tile(tsum, ntiles, t, v);
    const int total = block_exclusive_scan(v, ws);
    const int64_t i0 = t * SCAN_TILE + (int64_t)threadIdx.x * SCAN_ITEMS;
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i)
      if (i0 + i < ntiles) tsum[i0 + i] = v[i] + carry;
    carry += total;
    __syncthreads();
  }
}

// Scan step 3: out = the exclusive scan of in.
__global__ void __launch_bounds__(SCAN_THREADS)
tile_scan(const int32_t* __restrict__ in, int64_t n,
          const int32_t* __restrict__ toff, int32_t* __restrict__ out) {
  __shared__ int ws[33];
  int v[SCAN_ITEMS];
  load_tile(in, n, blockIdx.x, v);
  block_exclusive_scan(v, ws);
  const int64_t i0 =
      (int64_t)blockIdx.x * SCAN_TILE + (int64_t)threadIdx.x * SCAN_ITEMS;
  const int off = toff[blockIdx.x];
#pragma unroll
  for (int i = 0; i < SCAN_ITEMS; ++i)
    if (i0 + i < n) out[i0 + i] = v[i] + off;
}

__device__ __forceinline__ int digit_of(unsigned key, int shift) {
  return (int)((key >> shift) & (BINS - 1));
}

// Radix pass, step 1: hist[d * ntiles + tile] = the tile's samples whose
// digit is d.
__global__ void __launch_bounds__(SORT_THREADS)
digit_hist(const unsigned* __restrict__ keys, int64_t m, int shift,
           int64_t ntiles, int32_t* __restrict__ hist) {
  __shared__ int cnt[BINS];
  cnt[threadIdx.x] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * SORT_TILE;
#pragma unroll
  for (int j = 0; j < SORT_ITEMS; ++j) {
    const int64_t i = base + j * SORT_THREADS + threadIdx.x;
    if (i < m) atomicAdd(&cnt[digit_of(keys[i], shift)], 1);
  }
  __syncthreads();
  hist[threadIdx.x * ntiles + blockIdx.x] = cnt[threadIdx.x];
}

// Exclusive scan over the CTA's SORT_THREADS threads, one value each. ws:
// SORT_WARPS ints of shared memory.
__device__ __forceinline__ int sort_block_scan(int x, int* ws) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  int inc = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) ws[warp] = inc;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += ws[w];
  __syncthreads();  // ws may be reused
  return before + inc - x;
}

// Radix pass, step 2: the tile's samples in stable digit order. Samples
// are ranked in the order j * SORT_THREADS + thread, the order the tile
// was read in: within a warp by __match_any_sync, across warps and rounds
// by counters in shared memory. They are then staged in shared memory by
// digit, so that each digit's run goes out as contiguous stores at
// offs[d * ntiles + tile], the scanned histogram.
__global__ void __launch_bounds__(SORT_THREADS)
digit_scatter(const unsigned* __restrict__ kin, const int2* __restrict__ vin,
              int64_t m, int shift, int64_t ntiles,
              const int32_t* __restrict__ hist,
              const int32_t* __restrict__ offs, unsigned* __restrict__ kout,
              int2* __restrict__ vout) {
  __shared__ unsigned sk[SORT_TILE];
  __shared__ int2 sv[SORT_TILE];
  __shared__ int wcnt[SORT_WARPS][BINS];
  __shared__ int dstart[BINS];  // the digit's first place in the tile
  __shared__ int drun[BINS];    // the digit's samples ranked so far
  __shared__ int goff[BINS];    // the digit's first place in the output
  __shared__ int ws[SORT_WARPS];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid / 32;
  const int64_t base = (int64_t)blockIdx.x * SORT_TILE;
  const int n_tile = m - base < SORT_TILE ? (int)(m - base) : SORT_TILE;

  const int64_t slot = (int64_t)tid * ntiles + blockIdx.x;  // digit d = tid
  dstart[tid] = sort_block_scan(hist[slot], ws);
  goff[tid] = offs[slot];
  drun[tid] = 0;
#pragma unroll
  for (int w = 0; w < SORT_WARPS; ++w) wcnt[w][tid] = 0;
  __syncthreads();

  for (int j = 0; j < SORT_ITEMS; ++j) {
    const int i = j * SORT_THREADS + tid;
    const bool live = i < n_tile;
    unsigned key = 0;
    int2 val = make_int2(0, 0);
    if (live) {
      key = kin[base + i];
      val = vin[base + i];
    }
    const int d = live ? digit_of(key, shift) : BINS;  // BINS: no digit
    const unsigned peers = __match_any_sync(FULL, d);
    const int before = __popc(peers & ((1u << lane) - 1u));
    if (live && lane == __ffs(peers) - 1) wcnt[warp][d] = __popc(peers);
    __syncthreads();
    {  // thread tid: digit tid's counts by warp into running offsets
      int run = drun[tid];
#pragma unroll
      for (int w = 0; w < SORT_WARPS; ++w) {
        const int c = wcnt[w][tid];
        wcnt[w][tid] = run;
        run += c;
      }
      drun[tid] = run;
    }
    __syncthreads();
    if (live) {
      const int place = dstart[d] + wcnt[warp][d] + before;
      sk[place] = key;
      sv[place] = val;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < SORT_WARPS; ++w) wcnt[w][tid] = 0;
    __syncthreads();
  }

  for (int p = tid; p < n_tile; p += SORT_THREADS) {
    const int d = digit_of(sk[p], shift);
    const int64_t out = goff[d] + (p - dstart[d]);
    kout[out] = sk[p];
    vout[out] = sv[p];
  }
}

// Squared norm of each row of S (n, k), one warp a row, with the first
// design's per-sample arithmetic for it: the lane-strided fmaf chain and the
// __shfl_xor_sync tree.
template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
row_sumsq(const T* __restrict__ S, int64_t n, int k, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= n) return;  // uniform across the warp
  const T* x = S + row * k;
  float s = 0.f;
#pragma unroll 4
  for (int i = lane; i < k; i += 32) {
    const float v = to_f32(x[i]);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
  if (lane == 0) out[row] = s;
}

// Gather pass: warp w takes samples [32 w, 32 w + 32) of the bucket order.
// KPL > 0: As[row] held in KPL registers a lane (k <= 32 * KPL); KPL = 0:
// re-read from L1 per sample. sqA, sqB: the rows' squared norms.
template <int KPL, typename T>
__global__ void __launch_bounds__(WARPS * 32)
gather_kernel(const T* __restrict__ As, const T* __restrict__ Bs,
              const float* __restrict__ nA, const float* __restrict__ nB,
              const float* __restrict__ sqA, const float* __restrict__ sqB,
              const unsigned* __restrict__ keys,
              const int2* __restrict__ vals, int64_t m, int n1,
              float* __restrict__ out, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t p0 = ((int64_t)blockIdx.x * WARPS + threadIdx.x / 32) * SEG;
  if (p0 >= m) return;  // uniform across the warp
  const int cnt = m - p0 < SEG ? (int)(m - p0) : SEG;
  unsigned key = NO_BUCKET;
  int2 tc = make_int2(0, 0);
  if (lane < cnt) {
    key = keys[p0 + lane];
    tc = vals[p0 + lane];
  }

  float a[KPL > 0 ? KPL : 1];
  int cur = -1;
  const T* arow = As;
  for (int s = 0; s < cnt; ++s) {
    const unsigned bucket = __shfl_sync(FULL, key, s);
    if (bucket == NO_BUCKET) continue;  // uniform: a bad index, left out
    const int t = __shfl_sync(FULL, tc.x, s);
    const int c = __shfl_sync(FULL, tc.y, s);
    const int r = (int)(bucket % (unsigned)n1);
    if (r != cur) {  // uniform: a new A row
      cur = r;
      arow = As + (int64_t)r * k;
      if constexpr (KPL > 0) {
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int i = lane + 32 * j;
          a[j] = i < k ? to_f32(arow[i]) : 0.f;
        }
      }
    }
    const T* b = Bs + (int64_t)c * k;
    float dot = 0.f;
    if constexpr (KPL > 0) {
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int i = lane + 32 * j;
        if (i < k) dot = fmaf(a[j], to_f32(b[i]), dot);
      }
    } else {
#pragma unroll 4
      for (int i = lane; i < k; i += 32)
        dot = fmaf(to_f32(arow[i]), to_f32(b[i]), dot);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(FULL, dot, off);
    if (lane == 0) {
      const float denom = fmaxf(sqrtf(sqA[r]) * sqrtf(sqB[c]), 1e-12f);
      out[t] = dot * nA[r] * nB[c] / denom;
    }
  }
}

template <int KPL, typename T>
int launch_gather(const T* As, const T* Bs, const float* nA, const float* nB,
                  const float* sqA, const float* sqB, const unsigned* keys,
                  const int2* vals, int64_t m, int n1, float* out, int k,
                  cudaStream_t s) {
  const int64_t blocks = (m + WARPS * SEG - 1) / (WARPS * SEG);
  gather_kernel<KPL, T><<<(unsigned)blocks, WARPS * 32, 0, s>>>(
      As, Bs, nA, nB, sqA, sqB, keys, vals, m, n1, out, k);
  return (int)cudaGetLastError();
}

// The exclusive scan of in (n,) into out, through tsum (ceil(n / 4096),).
int scan(const int32_t* in, int64_t n, int32_t* tsum, int32_t* out,
         cudaStream_t s) {
  const int64_t tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  tile_sums<<<(unsigned)tiles, SCAN_THREADS, 0, s>>>(in, n, tsum);
  tile_offsets<<<1, SCAN_THREADS, 0, s>>>(tsum, tiles);
  tile_scan<<<(unsigned)tiles, SCAN_THREADS, 0, s>>>(in, n, tsum, out);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const T* As, const T* Bs, const float* nA, const float* nB,
        const int32_t* rows, const int32_t* cols, float* out, int64_t m,
        int64_t k, int64_t n1, int64_t n2, int64_t cblock, unsigned* keys,
        int2* vals, int32_t* hist, int32_t* offs, int32_t* tsum, float* sq,
        int32_t* flag, void* stream) {
  if (m <= 0 || m >= 0x7fffffffLL || n1 <= 0 || n1 > 0x7fffffffLL ||
      n2 <= 0 || n2 > 0x7fffffffLL || k < 0 || k > 0x7fffffffLL ||
      cblock <= 0 || cblock > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int64_t nb = (n2 + cblock - 1) / cblock * n1;
  const int64_t ntiles = (m + SORT_TILE - 1) / SORT_TILE;
  if (nb >= (int64_t)NO_BUCKET || ntiles * BINS >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = (int)cudaMemsetAsync(flag, 0, sizeof(int32_t), s);
  if (err) return err;
  // keys and vals hold two buffers each: the passes go back and forth
  unsigned* kbuf[2] = {keys, keys + m};
  int2* vbuf[2] = {vals, vals + m};
  int64_t pack_blocks = (m + PACK_THREADS - 1) / PACK_THREADS;
  if (pack_blocks > 16384) pack_blocks = 16384;
  pack_kernel<<<(unsigned)pack_blocks, PACK_THREADS, 0, s>>>(
      rows, cols, m, (int)n1, (int)n2, (int)cblock, kbuf[0], vbuf[0], flag);
  int bits = 0;  // bits of the largest bucket id
  while (bits < 32 && ((uint64_t)(nb - 1) >> bits) != 0) ++bits;
  int cur = 0;
  for (int shift = 0; shift < bits; shift += RADIX_BITS, cur ^= 1) {
    digit_hist<<<(unsigned)ntiles, SORT_THREADS, 0, s>>>(kbuf[cur], m, shift,
                                                        ntiles, hist);
    if ((err = scan(hist, ntiles * BINS, tsum, offs, s))) return err;
    digit_scatter<<<(unsigned)ntiles, SORT_THREADS, 0, s>>>(
        kbuf[cur], vbuf[cur], m, shift, ntiles, hist, offs, kbuf[cur ^ 1],
        vbuf[cur ^ 1]);
  }
  float* sqA = sq;
  float* sqB = sq + n1;
  row_sumsq<T><<<(unsigned)((n1 + WARPS - 1) / WARPS), WARPS * 32, 0, s>>>(
      As, n1, (int)k, sqA);
  row_sumsq<T><<<(unsigned)((n2 + WARPS - 1) / WARPS), WARPS * 32, 0, s>>>(
      Bs, n2, (int)k, sqB);
  if ((err = (int)cudaGetLastError())) return err;
  const int kpl = (int)((k + 31) / 32);
#define GATHER(KPL)                                                        \
  launch_gather<KPL, T>(As, Bs, nA, nB, sqA, sqB, kbuf[cur], vbuf[cur], m, \
                        (int)n1, out, (int)k, s)
  if (kpl <= 1) return GATHER(1);
  if (kpl <= 2) return GATHER(2);
  if (kpl <= 4) return GATHER(4);
  if (kpl <= 8) return GATHER(8);
  if (kpl <= 16) return GATHER(16);
  return GATHER(0);
#undef GATHER
}

}  // namespace

// Plain C entry points for ctypes. Each returns the first cudaError_t of its
// launches (0 on success); it neither synchronises nor allocates. Scratch:
// keys (2 m,) uint32, vals (2 m,) int2, hist and offs (256 ceil(m / 2048),)
// int32, tsum (ceil(256 ceil(m / 2048) / 4096),) int32, sq (n1 + n2,)
// float32, flag (1,) int32. *flag is 1 afterwards when an index was out of
// range (that sample is left out).
extern "C" int sampled_dot_f32(const float* As, const float* Bs,
                               const float* nA, const float* nB,
                               const int32_t* rows, const int32_t* cols,
                               float* out, int64_t m, int64_t k, int64_t n1,
                               int64_t n2, int64_t cblock, unsigned* keys,
                               int2* vals, int32_t* hist, int32_t* offs,
                               int32_t* tsum, float* sq, int32_t* flag,
                               void* stream) {
  return run<float>(As, Bs, nA, nB, rows, cols, out, m, k, n1, n2, cblock,
                    keys, vals, hist, offs, tsum, sq, flag, stream);
}

extern "C" int sampled_dot_bf16(const __nv_bfloat16* As,
                                const __nv_bfloat16* Bs, const float* nA,
                                const float* nB, const int32_t* rows,
                                const int32_t* cols, float* out, int64_t m,
                                int64_t k, int64_t n1, int64_t n2,
                                int64_t cblock, unsigned* keys, int2* vals,
                                int32_t* hist, int32_t* offs, int32_t* tsum,
                                float* sq, int32_t* flag, void* stream) {
  return run<__nv_bfloat16>(As, Bs, nA, nB, rows, cols, out, m, k, n1, n2,
                            cblock, keys, vals, hist, offs, tsum, sq, flag,
                            stream);
}
