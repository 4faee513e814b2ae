// flash_attention.cu: forward softmax attention with the online softmax, on
// Hopper's tensor cores.
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
// o is (B, S, H, Dh), contiguous. float32 or bf16 in; float32-accurate
// arithmetic whatever the input, as the TPU kernel casts its tiles to f32.
//
// What bounds it on an H100: operations. Causal attention does 2 * S^2 * Dh
// FLOP per head (QK^T and PV, half the square each): 8.80e12 at S = 32,768
// with 32 heads of 128. float32-accurate on the TF32 tensor cores that is
// three passes of each product (below), 26.4e12 FLOP, 53.3 ms at
// 495 TFLOP/s; bf16 inputs take two passes, 35.6 ms. Its bytes take 0.4 ms,
// its S^2 / 2 exponentials per head about 4 ms on the special-function
// units; the float32 FMA units alone would take 131 ms.
//
// Design:
//  * The TPU grid walks the k-blocks in order and carries the running max,
//    denominator and accumulator in scratch from one grid step to the next.
//    Blocks on a GPU run in parallel and in no order, so here one CTA owns
//    one BQ x Dh query tile of one (b, h) and loops over the k-tiles
//    itself, with the running state in registers.
//  * Tensor cores: mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 for
//    both products. Each warp owns 16 query rows (BQ / 16 warps; a pair of
//    warps at Dh 256, below). For S = (scale q) K^T the A operand is the
//    scaled Q tile, kept in shared memory as float32, and the B operand is
//    K read row-major, which is the MMA's .col layout. For O += P V each thread loads its own V values, so
//    V keeps its row-major layout too.
//  * Split passes: a float32 operand x becomes big = x rounded to nearest
//    TF32 and small = x - big, and small*big, big*small and big*big are
//    issued (about 2^-21 relative, float32 class). bf16 k and v are exact in
//    TF32, so with bf16 inputs each product takes two passes: q small and
//    big times k, p small and big times v. One TF32 pass misses the float32
//    tolerance (tests/test_torch_flash_attention.py emulates all three).
//  * P stays in registers. The accumulator fragment of S puts a thread's
//    scores at keys 2t and 2t + 1 of rows g and g + 8; the A fragment of
//    the PV MMA wants its k slots t and t + 4. The PV MMA is fed the keys of
//    each k8 step in the order in which slot t is key 2t and slot t + 4 is
//    key 2t + 1, and the thread loads V's B fragment from those same rows:
//    a sum over keys does not depend on their order. No shared-memory
//    round trip for P, no barrier for it. The QK^T MMA takes d in the same
//    order, so a thread's two values of a row of Q or K are neighbours.
//  * Two-level accumulation of O: an MMA adds with truncation, and over
//    S = 32,768 keys O's sum would drift toward zero. Each k-tile's PV
//    products go into a fresh fragment (per group of four 8-column tiles of
//    O, which keeps registers down; at Dh = 112 the last group holds the two
//    tiles left of 14), added to O with one FFMA that also applies the
//    softmax correction: o = o * corr + part. A warp's QK^T sums over at
//    most 128 columns of d, 16 k8 steps, straight into its fragment (at
//    Dh 256 each warp of a pair sums half of d: below).
//  * Online softmax in the fragment layout: the 4 threads of a quad share a
//    row, so its max takes two __shfl_xor_sync; the denominator stays a
//    per-thread partial, reduced once at the end (every update scales all
//    partials by the same factor).
//  * Copies: a ring of STAGES K/V tiles in shared memory filled by
//    cp.async (16-byte copies for float32, 8-byte for bf16: the wrapper
//    guarantees strides that are multiples of 4 elements), so the next
//    tile loads while this one computes; one __syncthreads() per tile. bf16
//    tiles stay bf16 in shared memory and are widened in registers, which
//    is exact. S is divisible by the tile, so no row is zero-filled.
//    Where a tile's 4-element chunks are not a multiple of the thread count
//    (BQ 128, BK 32, Dh 112: 896 chunks on 256 threads) the last round of
//    copies is guarded.
//  * Widths between compiled ones: the kernel runs only the compiled
//    widths. kernels/ops.py zero-pads a copy of q, k and v of any other
//    width up to the smallest compiled one above it, passes the scale of
//    the true width (``scale`` is a parameter), and slices O back. Zero
//    columns add exact zeros to QK^T and give O columns that are dropped,
//    so the result is the narrower attention, and the instances of the
//    compiled widths carry no code for another width.
//  * Causal: the loop stops at the tile that holds the diagonal. That is
//    exact: a fully masked tile would add exp(-1e30 - m) = 0 to every sum,
//    and tile 0 holds an unmasked key for every row. A warp skips the
//    products of a diagonal tile that lies wholly past its rows, for the
//    same reason. CTAs are numbered heaviest query tile first, so the short
//    tiles fill the last wave.
//  * Shared-memory pitches keep the fragment loads off shared banks: Q and
//    K rows Dh + 8 elements, V rows Dh + 16 bytes. At every compiled Dh a
//    float32 Q or K row starts 8 or 24 banks (mod 32) past the one before,
//    so a half warp's float2 loads from 4 rows hit 32 distinct banks; a
//    bf16 K row 4, 12, 20 or 28 banks (8 rows of one word each: 32 banks);
//    the V rows a thread reads, two apart, 8 or 24 banks, float32 or bf16.
//  * Dh 256, warp pairs: one warp holding 16 query rows and all 256 of O's
//    columns would need o[32][4], 128 registers for O beside S and P under
//    the 255 limit, and would run its QK^T over 32 k8 steps into one
//    truncating fragment. So at Dh 256 two warps own each 16 query rows
//    (SPLIT = 2; BQ 64: 8 warps, 256 threads). Warp half h of a pair owns
//    columns [128 h, 128 h + 128) of d and of O: it computes the partial
//    S over its 128 columns of d (16 k8 steps, the chain the fresh-fragment
//    analysis clears, as at Dh 128) and the PV products of its 128 columns
//    of O (o[16][4], 64 registers, as at Dh 128). The two partial S
//    fragments meet in shared memory: each warp writes its fragment (16 x
//    BK float32), the pair waits at a named barrier of its 64 threads
//    (bar.sync 1 + pair, 64), and each adds the other's with one FADD.
//    a + b == b + a in IEEE arithmetic, so both warps hold the same S bit
//    for bit and run the same online softmax: same running max,
//    denominator and P, with no MMA done twice. The exchange slot is
//    written again only after the next tile's __syncthreads(), which every
//    thread reaches after its read. Shared memory at (64, 32) float32: Q
//    67,584 bytes, two K/V stages 134,144, the exchange 16,384 (8 warps x 16
//    x 32 float32): 218,112 of 232,448.
//  * Tiles compiled: BQ in {64, 128} (128 or 256 threads), BK in {32, 64},
//    at Dh in {16, 32, 64, 96, 112, 128}; at Dh 256 (64, 32) only
//    (WIDE_BQ, WIDE_BK): (64, 64) takes 268,288 bytes of shared memory in
//    float32 before the exchange and 235,520 in bf16 with it, over 232,448,
//    and doubles S and P's registers, which already spill at BK 64 and
//    Dh 112;
//    BQ 128 would be 512 threads, 128 registers a thread, half of them O's.
//    kernels/flash_attention.py holds the same menu (``tiles``) and refuses
//    anything else before a launch. The largest Dh <= 128 tile, (128, 64,
//    128) float32, takes 206,848 bytes; BK = 128 with two float32 stages
//    and a 128-row Q tile would not fit in 227 KB. Dh > 256 (no config of
//    the repo has one) is not compiled. recurrentgemma-9b's attention at
//    Dh 256 is windowed, which neither this kernel nor the TPU kernel has:
//    its model path stays on the plain route; this kernel takes its head
//    layout unwindowed.
// Not wgmma or TMA: later work. PERF.md has the kernel's times against its
// bound and what holds it back (tools/flash_attention_probe.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int STAGES = 2;
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

// The tile compiled at Dh 256 (the header says why only this one).
constexpr int WIDE_BQ = 64, WIDE_BK = 32;

// Whether the source compiles tile (BQ, BK) at head width DH.
constexpr bool compiled(int BQ, int BK, int DH) {
  return DH <= 128 || (BQ == WIDE_BQ && BK == WIDE_BK);
}

template <int BQ, int BK, int DH, typename T>
struct Tile {
  // warps that share 16 query rows, each owning DH / SPLIT columns of d
  // and of O: two at Dh 256, else one
  static constexpr int SPLIT = DH > 128 ? 2 : 1;
  static constexpr int WD = DH / SPLIT;             // columns a warp
  static constexpr int WARPS = BQ / 16 * SPLIT;
  static constexpr int THREADS = 32 * WARPS;        // 128 or 256
  static constexpr int NT = BK / 8;                 // key tiles of S
  static constexpr int DT = WD / 8;                 // column tiles of O
  static constexpr int G = DT < 4 ? DT : 4;         // O tiles per fresh part
  static constexpr int LDQ = DH + 8;                // floats per Q row
  static constexpr int LDK = DH + 8;                // elements per K row
  static constexpr int LDV = DH + 16 / (int)sizeof(T);  // per V row
  static constexpr int STAGE_ELEMS = BK * (LDK + LDV);
  // the pairs' exchange of partial S: a warp's fragment, 16 x BK float32
  static constexpr int XCH_FLOATS = SPLIT > 1 ? WARPS * 16 * BK : 0;
  static constexpr int RING_OFFSET = BQ * LDQ * (int)sizeof(float);
  static constexpr int XCH_OFFSET =
      RING_OFFSET + STAGES * STAGE_ELEMS * (int)sizeof(T);
  static constexpr int SMEM =
      BQ * LDQ * (int)sizeof(float) + STAGES * STAGE_ELEMS * (int)sizeof(T)
      + XCH_FLOATS * (int)sizeof(float);
  // float32: three passes per product; bf16 k and v are exact in TF32: two
  static constexpr int PASSES = std::is_same<T, float>::value ? 3 : 2;
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

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// A value's TF32 operands, as the MMA reads them (the top 19 bits of a
// float32). float32: big rounds x to nearest TF32 (the integer form of
// cvt.rna.tf32.f32, without its NaN guard), small = x - big is exact and
// the MMA ignores its low 13 bits. A widened bf16 is a TF32 value already.
template <int PASSES>
__device__ __forceinline__ void split(uint32_t x, uint32_t& big,
                                      uint32_t& small) {
  if constexpr (PASSES == 3) {
    big = (x + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(__uint_as_float(x) - __uint_as_float(big));
  } else {
    big = x;
    small = 0u;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// c += a * b on one m16n8k8 tile.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One asynchronous copy of VEC bytes from gmem to smem.
template <int VEC>
__device__ __forceinline__ void copy(void* smem, const void* gmem) {
  const unsigned dst = smem_addr(smem);
  if constexpr (VEC == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(dst), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                 :: "r"(dst), "l"(gmem) : "memory");
}

// The two warps of a pair (64 threads) meet at named barrier ``id``.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" :: "r"(id) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// K's B fragment of one (k8 step, key tile): the thread's keys-row values
// at d offsets 2t and 2t + 1, which the MMA takes as its k slots t, t + 4.
__device__ __forceinline__ void k_pair(const float* p, uint32_t& b0,
                                       uint32_t& b1) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  b0 = __float_as_uint(x.x);
  b1 = __float_as_uint(x.y);
}
__device__ __forceinline__ void k_pair(const __nv_bfloat16* p, uint32_t& b0,
                                       uint32_t& b1) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  b0 = u << 16;             // the lower address holds d offset 2t
  b1 = u & 0xffff0000u;
}

// One V value as a float32 bit pattern.
__device__ __forceinline__ uint32_t v_bits(const float* p) {
  return __float_as_uint(*p);
}
__device__ __forceinline__ uint32_t v_bits(const __nv_bfloat16* p) {
  return (uint32_t)*reinterpret_cast<const uint16_t*>(p) << 16;
}

template <int BQ, int BK, int DH, typename T>
__global__ void __launch_bounds__(Tile<BQ, BK, DH, T>::THREADS, 1)
flash_fwd(const T* __restrict__ Q, const T* __restrict__ K,
          const T* __restrict__ V, T* __restrict__ O, Params p) {
  using Tl = Tile<BQ, BK, DH, T>;
  constexpr int THREADS = Tl::THREADS, NT = Tl::NT, DT = Tl::DT, G = Tl::G;
  constexpr int LDQ = Tl::LDQ, LDK = Tl::LDK, LDV = Tl::LDV;
  constexpr int PASSES = Tl::PASSES, SPLIT = Tl::SPLIT, WD = Tl::WD;
  constexpr int CH = DH / 4;                     // 4-element chunks a row
  constexpr int VEC = 4 * (int)sizeof(T);        // bytes a chunk
  constexpr int Q_COPIES = BQ * CH / THREADS;    // per thread
  // K/V: a ragged last round (BK * CH not a multiple of THREADS) is guarded
  constexpr int KV_CHUNKS = BK * CH;
  constexpr int KV_COPIES = (KV_CHUNKS + THREADS - 1) / THREADS;
  static_assert(DH % 8 == 0 && Q_COPIES * THREADS == BQ * CH &&
                KV_COPIES >= 1, "copy split");
  static_assert(Tl::RING_OFFSET % 16 == 0 && Tl::XCH_OFFSET % 16 == 0,
                "shared-memory alignment");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* const Qs = reinterpret_cast<float*>(smem_raw);      // [BQ][LDQ]
  T* const ring = reinterpret_cast<T*>(smem_raw + Tl::RING_OFFSET);
  // [WARPS][NT][32 lanes] float4: each lane's fragment of its warp's S
  float4* const xch = reinterpret_cast<float4*>(smem_raw + Tl::XCH_OFFSET);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int g = lane / 4;  // fragment row group
  const int t = lane % 4;  // thread in group
  const int pair = warp / SPLIT;      // this warp's 16 query rows
  const int c0 = warp % SPLIT * WD;   // and its first column of d and of O
  const int64_t nqt = p.S / BQ;
  const int64_t qt = nqt - 1 - (int64_t)blockIdx.x / p.BH;  // heaviest first
  const int64_t bh = (int64_t)blockIdx.x % p.BH;
  const int64_t b = bh / p.H;
  const int64_t h = bh % p.H;
  const int64_t kvh = h / (p.H / p.Hkv);
  const int64_t q0 = qt * BQ;
  const T* Qb = Q + b * p.sqb + h * p.sqh;
  const T* Kb = K + b * p.skb + kvh * p.skh;
  const T* Vb = V + b * p.svb + kvh * p.svh;

  // Slot s <- keys k0..k0+BK-1 of K and V.
  auto load_stage = [&](int slot, int64_t k0) {
    T* ks = ring + slot * Tl::STAGE_ELEMS;
    T* vs = ks + BK * LDK;
#pragma unroll
    for (int i = 0; i < KV_COPIES; ++i) {
      const int c = tid + i * THREADS;
      if (KV_CHUNKS % THREADS != 0 && c >= KV_CHUNKS) break;
      const int r = c / CH, d = (c % CH) * 4;
      copy<VEC>(ks + r * LDK + d, Kb + (k0 + r) * p.sks + d);
      copy<VEC>(vs + r * LDV + d, Vb + (k0 + r) * p.svs + d);
    }
  };
  load_stage(0, 0);
  cp_async_commit();

#pragma unroll
  for (int i = 0; i < Q_COPIES; ++i) {
    const int c = tid + i * THREADS;
    const int r = c / CH, d = (c % CH) * 4;
    float4 x = load4(Qb + (q0 + r) * p.sqs + d);
    x.x *= p.scale; x.y *= p.scale; x.z *= p.scale; x.w *= p.scale;
    *reinterpret_cast<float4*>(&Qs[r * LDQ + d]) = x;
  }

  // This thread's rows are r0 and r0 + 8 of the tile (h = 0, 1 below).
  const int r0 = pair * 16 + g;
  const int64_t warp_first = q0 + pair * 16;
  float o[DT][4], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  const int64_t n_kt = p.causal ? (q0 + BQ - 1) / BK + 1 : p.S / BK;
  for (int64_t kt = 0; kt < n_kt; ++kt) {
    // tile kt has landed for everyone, and every warp is done with the slot
    // refilled below
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < n_kt) load_stage((int)((kt + 1) % STAGES), (kt + 1) * BK);
    cp_async_commit();
    const int64_t k0 = kt * BK;
    if (p.causal && k0 > warp_first + 15) continue;  // all masked for this warp
    const T* ks = ring + (int)(kt % STAGES) * Tl::STAGE_ELEMS;
    const T* vs = ks + BK * LDK;

    // s = (scale q) k^T: 16 rows x BK keys, over this warp's WD columns
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < WD; kk += 8) {
      const float2 lo =
          *reinterpret_cast<const float2*>(&Qs[r0 * LDQ + c0 + kk + 2 * t]);
      const float2 hi = *reinterpret_cast<const float2*>(
          &Qs[(r0 + 8) * LDQ + c0 + kk + 2 * t]);
      const uint32_t a[4] = {__float_as_uint(lo.x), __float_as_uint(hi.x),
                             __float_as_uint(lo.y), __float_as_uint(hi.y)};
      uint32_t a_big[4], a_small[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split<3>(a[e], a_big[e], a_small[e]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b0, b1, b0_big, b0_small, b1_big, b1_small;
        k_pair(ks + (8 * j + g) * LDK + c0 + kk + 2 * t, b0, b1);
        split<PASSES>(b0, b0_big, b0_small);
        split<PASSES>(b1, b1_big, b1_small);
        mma(s[j], a_small, b0_big, b1_big);
        if constexpr (PASSES == 3) mma(s[j], a_big, b0_small, b1_small);
        mma(s[j], a_big, b0_big, b1_big);
      }
    }
    if constexpr (SPLIT == 2) {
      // the pair's partial scores over the two halves of d: write this
      // warp's, meet the partner, add the partner's (both warps then hold
      // the same S)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        xch[(warp * NT + j) * 32 + lane] =
            make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      pair_sync(1 + pair);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 x = xch[((warp ^ 1) * NT + j) * 32 + lane];
        s[j][0] += x.x; s[j][1] += x.y; s[j][2] += x.z; s[j][3] += x.w;
      }
    }
    if (p.causal && k0 + BK - 1 > warp_first) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * j + 2 * t + (e & 1) > q0 + r0 + 8 * (e >> 1))
            s[j][e] = NEG;
    }

    // online softmax: new running max, correction, probabilities
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = fmaxf(s[0][2 * hh], s[0][2 * hh + 1]);
#pragma unroll
      for (int j = 1; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float mn = fmaxf(m[hh], mx);
      corr[hh] = expf(m[hh] - mn);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        s[j][2 * hh] = expf(s[j][2 * hh] - mn);
        s[j][2 * hh + 1] = expf(s[j][2 * hh + 1] - mn);
        sum += s[j][2 * hh] + s[j][2 * hh + 1];
      }
      l[hh] = l[hh] * corr[hh] + sum;
      m[hh] = mn;
    }

    // P as the PV MMA's A operand, k8 step j = key tile j: slot t is key
    // 2t, slot t + 4 key 2t + 1, so (a0, a1, a2, a3) = (s0, s2, s1, s3)
    uint32_t p_big[NT][4], p_small[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      split<3>(__float_as_uint(s[j][0]), p_big[j][0], p_small[j][0]);
      split<3>(__float_as_uint(s[j][2]), p_big[j][1], p_small[j][1]);
      split<3>(__float_as_uint(s[j][1]), p_big[j][2], p_small[j][2]);
      split<3>(__float_as_uint(s[j][3]), p_big[j][3], p_small[j][3]);
    }

    // o = o * corr + P v, G column tiles of O at a time (the last group
    // holds what is left of DT), each tile's products of this k-tile in a
    // fresh fragment
#pragma unroll
    for (int jg = 0; jg < DT; jg += G) {
      float part[G][4];
#pragma unroll
      for (int jj = 0; jj < G; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[jj][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const T* vrow = vs + (8 * j + 2 * t) * LDV + c0 + g;
#pragma unroll
        for (int jj = 0; jj < G && jg + jj < DT; ++jj) {
          const int col = 8 * (jg + jj);
          uint32_t b0_big, b0_small, b1_big, b1_small;
          split<PASSES>(v_bits(vrow + col), b0_big, b0_small);
          split<PASSES>(v_bits(vrow + LDV + col), b1_big, b1_small);
          mma(part[jj], p_small[j], b0_big, b1_big);
          if constexpr (PASSES == 3)
            mma(part[jj], p_big[j], b0_small, b1_small);
          mma(part[jj], p_big[j], b0_big, b1_big);
        }
      }
#pragma unroll
      for (int jj = 0; jj < G && jg + jj < DT; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[jg + jj][e] = fmaf(o[jg + jj][e], corr[e >> 1], part[jj][e]);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float li = l[hh];
    li += __shfl_xor_sync(FULL, li, 1);
    li += __shfl_xor_sync(FULL, li, 2);
    const float denom = fmaxf(li, 1e-30f);
    const int64_t row = q0 + r0 + 8 * hh;
    T* orow = O + ((b * p.S + row) * p.H + h) * DH + c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      store2(orow + 8 * j, o[j][2 * hh] / denom, o[j][2 * hh + 1] / denom);
  }
}

template <int BQ, int BK, int DH, typename T>
int launch_tile(const T* q, const T* k, const T* v, T* o, const Params& p,
                cudaStream_t s) {
  using Tl = Tile<BQ, BK, DH, T>;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<BQ, BK, DH, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tl::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  const int64_t blocks = (p.S / BQ) * p.BH;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_fwd<BQ, BK, DH, T><<<(unsigned)blocks, Tl::THREADS, Tl::SMEM, s>>>(
      q, k, v, o, p);
  return (int)cudaGetLastError();
}

template <int BQ, int BK, int DH, typename T>
int launch_width(const T* q, const T* k, const T* v, T* o, const Params& p,
                 cudaStream_t s) {
  if constexpr (compiled(BQ, BK, DH))
    return launch_tile<BQ, BK, DH, T>(q, k, v, o, p, s);
  else
    return (int)cudaErrorInvalidValue;
}

template <int BQ, int BK, typename T>
int launch_dh(int64_t dh, const T* q, const T* k, const T* v, T* o,
              const Params& p, cudaStream_t s) {
  switch (dh) {
    case 16: return launch_width<BQ, BK, 16, T>(q, k, v, o, p, s);
    case 32: return launch_width<BQ, BK, 32, T>(q, k, v, o, p, s);
    case 64: return launch_width<BQ, BK, 64, T>(q, k, v, o, p, s);
    case 96: return launch_width<BQ, BK, 96, T>(q, k, v, o, p, s);
    case 112: return launch_width<BQ, BK, 112, T>(q, k, v, o, p, s);
    case 128: return launch_width<BQ, BK, 128, T>(q, k, v, o, p, s);
    case 256: return launch_width<BQ, BK, 256, T>(q, k, v, o, p, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int BQ, typename T>
int launch_bk(int64_t bk, int64_t dh, const T* q, const T* k, const T* v,
              T* o, const Params& p, cudaStream_t s) {
  switch (bk) {
    case 32: return launch_dh<BQ, 32, T>(dh, q, k, v, o, p, s);
    case 64: return launch_dh<BQ, 64, T>(dh, q, k, v, o, p, s);
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
// head) strides of q, k and v in elements, nine int64 values on the host;
// Dh is a compiled width, ``scale`` 1/sqrt of the width the caller's
// attention has (the wrapper's Dh before any zero padding). Each returns the cudaError_t of its launch (0 on success,
// and cudaErrorInvalidValue for a shape or tile that is not compiled); it
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
