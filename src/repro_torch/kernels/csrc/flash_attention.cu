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
// 495 TFLOP/s; bf16 inputs on the bf16 tensor cores take one pass on QK^T
// and two on PV (below), 13.3 ms at 989 TFLOP/s (the bound, one pass each,
// 8.9 ms). Its bytes take 0.4 ms, its S^2 / 2 exponentials per head about
// 4 ms on the special-function units; the float32 FMA units alone would
// take 131 ms.
//
// Design of the mma.sync instances (Dh 16, 32, 112 and 256, float32 and
// bf16; Dh 64, 96 and 128 have the wgmma designs at the end):
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
//  * Key length: a call may have fewer keys than S rows (kv_len, 1 to S).
//    kernels/ops.py runs an S below 128, which the compiled tiles do not
//    divide, on a copy of q, k and v zero-padded along S to a multiple of
//    the tile, with kv_len the true S, and slices O back. Every design stops
//    its key loop at the tile that holds key kv_len - 1 (key_tiles, beside
//    the causal stop), and on that tile alone, where kv_len is not a
//    multiple of BK, gives the keys from kv_len on the causal mask's -1e30:
//    a branch uniform over the CTA, never taken when kv_len == S. Key 0
//    is valid for every row, padded ones included, so no row is wholly
//    masked and its running sum stays positive; the padded V rows are
//    zeros, and their P is exactly 0. The mma.sync instances take the
//    branch at run time. The wgmma designs compile each width twice
//    (MASKED): the full-length instance, the design as it was, and a
//    masked twin that the calls with kv_len below S run. Any key-length
//    code in the full-length loop made ptxas serialise the float32 wgmma
//    (C7511) at some widths; bf16 is split the same way, so that every
//    full-length instance keeps its code. The float32 twin computes its
//    lane's limit before the key loop or in it, width by width
//    (limit_hoisted), the forms ptxas compiles without serialising
//    (tools/flash_attention_probe.py; PERF.md).
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
//    at Dh in {16, 32, 112} (Dh 64, 96 and 128: the wgmma instances' one
//    tile a dtype alone, below); at Dh 256 (64, 32) only
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
//  * float32 at Dh 64, 96 and 128 (every Dh 128 LM prefill: granite-3-8b,
//    moonshot-v1-16b-a3b, starcoder2-15b, llama-3.2-vision-11b; phi3-mini's
//    at Dh 96, whisper-small's at Dh 64; and the float32 widths padded to
//    them, 33 to 128 but 97 to 112) has its own design for Hopper,
//    flash_fwd_wgmma<Dh>, and no mma.sync instance; so has bf16 at those
//    widths (flash_fwd_wgmma_bf16<Dh>, the next bullet); the other
//    instances (float32 and bf16 at Dh 16, 32, 112 and 256) stay as above.
//    flash_attention_f32_wgmma is its entry, wgmma_width the widths.
//    - Products: wgmma.mma_async m64nNk8 .tf32, float32 sums. QK^T: A is
//      the scaled Q tile, K-major in shared memory; B is K's tile, K-major
//      as row-major K lies (N = BK = 32). PV: A is P from registers, B is
//      V^T's tile (N = Dh: m64n128k8, m64n96k8, m64n64k8). Three passes a
//      product (small*big, big*big, then big*small), one wgmma a pass and
//      k8 step: 3 Dh / 8 (48, 36, 24) into S's accumulator over Dh, 12 into
//      a fresh PV accumulator a k-tile.
//    - V^T: TF32 wgmma reads B from shared memory K-major only, and for PV
//      the K dimension is the keys: row-major V is N-major. A prologue
//      (flash_vt<Dh>) writes V once a call as (B, Hkv, Dh, S) into scratch
//      the wrapper allocates, each group of 8 keys in the order the P fragment
//      feeds the product (slot p: key 2p for p < 4, 2(p - 4) + 1 after),
//      so the S accumulator's registers are P's A fragment as they are
//      (a0..a3 = s0, s2, s1, s3). At granite's 8 KV heads and S = 32,768
//      the copy is 134 MB read and 134 MB written, about 0.08 ms at HBM
//      rate; the wrapper counts the prologue and the kernel as one call.
//    - TMA: K's (32, Dh) tile as Dh / 32 boxes of 32 columns of a 4-D map
//      over its strides (GQA read in place), V^T's (Dh, 32) as one box,
//      into a ring of WForm<Dh>::STAGES stages on mbarriers, 128-byte
//      swizzle (32 float32 a swizzle row); the wgmma descriptors name the
//      same swizzle.
//    - The split: a raw float32 operand is its own big part: the tensor
//      core reads its top 19 bits, which truncates it to TF32. small =
//      x - trunc(x) is exact in float32 and truncated again as it is read
//      (about 2^-20 relative; tests/test_torch_flash_attention.py emulates
//      it). So the landed K and V^T tiles serve as they are, the passes on
//      them start at once, and only the small parts are written.
//    - Warp specialisation, 384 threads: warpgroup 0 is the producer
//      (setmaxnreg 56): lane 0 of warp 0 issues the loads; warps 1-3 write
//      each landed tile's small part once a CTA into set kt % SETS (K's as
//      soon as both consumers have read the set's last K small part, then
//      V^T's once they have released the stage that last read the set).
//      Warpgroups 1 and 2 (setmaxnreg 224) own 64 query rows each (BQ 128)
//      and split their Q rows once. Every barrier takes one arrival a warp.
//      A consumer issues each product's passes on the raw tile, then waits
//      for the small part and issues the last pass. (Tried and slower on
//      the card, at granite's layer by tools/flash_attention_probe.py:
//      issuing the next tile's QK^T before this tile's softmax, 114.75 ms
//      against this design's 90.73; the two consumers taking turns at
//      issuing their QK^T through named barriers, 221.09; PERF.md.)
//    - Registers (a consumer thread): O Dh / 2, the fresh PV accumulator
//      Dh / 2, S 16, P's big and small parts 16 each (at Dh 128: 64 + 64 +
//      16 + 32).
//    - Shared memory (232,448 bytes a CTA; WTile<Dh>). Every float32
//      operand of a three-pass product needs its big and small part there:
//      Q's two parts 8 Dh x 128 bytes (131,072 at Dh 128), the ring (raw K
//      and V^T tiles) STAGES x 256 Dh bytes, one tile's small parts 256 Dh
//      (SETS sets), 1,024 to align the swizzle and the barriers. At Dh 128
//      two stages and one set take 230,456: BK 64, a third stage or a
//      second set of small parts would not fit, so there the splitters wait
//      for both consumers to release the last small part. Dh 96 and 64 have
//      room for more (WForm): Dh 96 keeps two stages and two sets of small
//      parts (197,712), so its splitters write tile kt's while the
//      consumers still read tile kt - 1's; Dh 64 three stages and one set
//      (132,168).
//  * bf16 at Dh 64, 96 and 128 (and the bf16 widths padded to them) has a
//    design of its own, flash_fwd_wgmma_bf16<Dh>, entry
//    flash_attention_bf16_wgmma: the float32 one's shape without its
//    splits, its small parts and its prologue.
//    - QK^T in one pass: wgmma.mma_async m64nBKk16 .bf16, float32 sums. A
//      is Q's tile, K-major as row-major Q lies, loaded once a CTA by TMA;
//      B is K's tile from the ring, K-major as row-major K lies. Products
//      of bf16 values are exact in float32, so no split is needed. The
//      scale goes on the float32 S (the TPU kernel scales q first: one
//      float32 rounding in another place).
//    - PV with P in two bf16 parts: hi = bf16(p), lo = bf16(p - hi) (p - hi
//      is exact), about 2^-18 relative on P, float32 class
//      (tests/test_torch_flash_attention.py emulates it against float64;
//      one part misses the float32 tolerance, a third is not needed): two
//      m64nDhk16 a k16 step, hi V and lo V, into a fresh accumulator a
//      k-tile, added to O with one FFMA, as above. P comes from registers:
//      the accumulator registers of 16 consecutive keys, packed into bf16
//      pairs, are a k16 step's A fragment as they stand, keys in their
//      natural order.
//    - V read MN-major, no prologue: bf16 wgmma reads B from shared memory
//      MN-major too (the transpose flag), so V's row-major (keys x Dh)
//      tile serves as it lands: its descriptor steps 64- or 32-column
//      chunks of Dh by the leading byte offset (BK rows of the swizzle a
//      chunk) and 8-key groups by the stride byte offset. No V^T scratch;
//      a call is one launch.
//    - TMA: Q's, K's and V's tiles as boxes of one swizzle row's columns
//      of 4-D maps over their strides (GQA read in place). The 128-byte
//      swizzle holds 64 bf16 columns a row: Dh 128 is two boxes, Dh 64
//      one. Dh 96 lies in the 64-byte swizzle, three boxes of 32 columns,
//      so every chunk is whole (BForm's SWIZZLE; the wgmma descriptors
//      name the same swizzle). K and V tiles fill a ring of
//      BForm<Dh>::STAGES stages of BForm<Dh>::BK keys on mbarriers.
//    - Warps, 384 threads: warpgroup 0 is the producer (setmaxnreg 40),
//      lane 0 of warp 0 issuing the loads, no splitters; warpgroups 1 and
//      2 (setmaxnreg 232) own 64 query rows each. The online softmax in
//      the fragment layout, the causal stop at the diagonal tile with the
//      mask in registers and the heaviest query tiles first are as above;
//      the output is rounded to bf16 once.
//    - Registers (a consumer thread): O Dh / 2, the fresh PV accumulator
//      Dh / 2, S BK / 2, P's two parts BK / 4 each (at Dh 128, BK 128: 64
//      + 64 + 64, S's dead once P is split, + 64).
//    - Shared memory (BTile): 1,024 bytes to align the swizzle, Q's tile
//      256 Dh bytes, each stage 4 BK Dh, two barriers a stage and Q's one:
//      at Dh 128, BK 128, three stages 230,456 bytes.
// The mma.sync instances: not wgmma or TMA yet. PERF.md has the kernel's
// times against its bound and what holds it back
// (tools/flash_attention_probe.py).

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through
                   // the runtime's entry-point query (no libcuda link)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
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
  // the keys a query sees, 1 to S: keys from kv_len on are masked (last,
  // so that the other fields keep their offsets)
  int64_t kv_len;
};

// Key tiles of BK keys a query tile at q0 of BQ rows runs: under causal,
// up to the tile that holds its diagonal; never past the tile that holds
// key kv_len - 1.
template <int BQ, int BK>
__device__ __forceinline__ int64_t key_tiles(const Params& p, int64_t q0) {
  const int64_t diag = p.causal ? (q0 + BQ - 1) / BK + 1 : p.S / BK;
  const int64_t keys = (p.kv_len + BK - 1) / BK;
  return diag < keys ? diag : keys;
}

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

  const int64_t n_kt = key_tiles<BQ, BK>(p, q0);
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
    if (k0 + BK > p.kv_len) {
      // the last key tile, where the keys end inside it: keys from kv_len
      // on are masked (at Dh 256 both warps of a pair, on the same S);
      // lim, this lane's first masked key less 8 j + e, is below BK
      const int lim = (int)(p.kv_len - k0) - 2 * t;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + (e & 1) >= lim) s[j][e] = NEG;
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

// ---------------------------------------------------------------------------
// The float32 instances at Dh 64, 96 and 128: TMA, TF32 wgmma, warp
// specialisation (see the header).

constexpr int W_BQ = 128, W_BK = 32;
constexpr int W_THREADS = 384;        // three warpgroups
constexpr int W_SPLITTERS = 96;       // warps 1-3: the K and V^T splits
constexpr int W_CONSUMERS = 256;      // warpgroups 1 and 2: 64 query rows each
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;  // setmaxnreg
constexpr int ROW_BYTES = 128;        // a row of the 128-byte swizzle
constexpr int Q_CHUNK = W_BQ * ROW_BYTES;     // 32 columns of Q's tile
constexpr int K_CHUNK = W_BK * ROW_BYTES;     // 32 columns of K's tile
// the prologue's tile of keys
constexpr int VT_KEYS = 64;

// The widths that run flash_fwd_wgmma, and each one's form: the stages of
// its TMA ring (K and V^T tiles) and its sets of small parts. Each form is
// the fastest of those ptxas compiles without serialising the wgmma
// (C7511, "insufficient register resources"; a serialised instance runs
// 1.75 to 1.85 x slower): at Dh 96 only two stages and two sets, at Dh 64
// three stages and one set or two, at Dh 128 the only one that fits
// (tools/flash_attention_probe.py times and reports each; PERF.md).
constexpr bool wgmma_width(int DH) {
  return DH == 64 || DH == 96 || DH == 128;
}
template <int DH> struct WForm;
template <> struct WForm<64> { static constexpr int STAGES = 3, SETS = 1; };
template <> struct WForm<96> { static constexpr int STAGES = 2, SETS = 2; };
template <> struct WForm<128> { static constexpr int STAGES = 2, SETS = 1; };
// A masked instance (a call with kv_len below S) computes its lane's key
// limit before the key loop at these widths and inside it at Dh 96: of
// the forms of its mask tried, the only ones ptxas compiles without
// serialising the wgmma, width by width (PERF.md).
__host__ __device__ constexpr bool limit_hoisted(int DH) { return DH != 96; }

// The shared-memory layout at width DH: offsets from the 1,024-byte
// boundary the swizzle repeats on.
template <int DH>
struct WTile {
  static constexpr int STAGES = WForm<DH>::STAGES, SETS = WForm<DH>::SETS;
  static constexpr int CHUNKS = DH / 32;             // 32-column chunks of d
  static constexpr int Q_BYTES = CHUNKS * Q_CHUNK;   // big, and small again
  static constexpr int K_BYTES = CHUNKS * K_CHUNK;
  static constexpr int VT_BYTES = DH * ROW_BYTES;    // DH rows of 32 keys
  static constexpr int STAGE = K_BYTES + VT_BYTES;   // a set of small parts too
  static constexpr int OFF_QBIG = 0;
  static constexpr int OFF_QSMALL = OFF_QBIG + Q_BYTES;
  static constexpr int OFF_RING = OFF_QSMALL + Q_BYTES;
  static constexpr int OFF_SMALL = OFF_RING + STAGES * STAGE;
  static constexpr int OFF_BARS = OFF_SMALL + SETS * STAGE;
  static constexpr int BARRIERS = 2 * STAGES + 3 * SETS;
  // Dh 128: 230,456; Dh 96: 197,712; Dh 64: 132,168
  static constexpr int SMEM = 1024 + OFF_BARS + 8 * BARRIERS;
  static_assert(W_BK * 4 == ROW_BYTES && DH % 32 == 0,
                "a K row is DH / 32 swizzle rows, a V^T row one");
  static_assert(SETS <= STAGES, "a set of small parts outlives its stage");
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

// Wait for the phase of `bar` with this parity to complete. A wait that
// outlasts any transfer by far (2^24 tries) traps: a fault in place of a
// hung card. The loop lies inside the asm, so that the compiler sees no
// divergent path around the wgmma that follow.
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_addr(bar)) : "memory");
}

// arrive on `bar`, which then also waits for `bytes` of transfers
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// this thread's shared-memory writes, made visible to the async proxy (the
// wgmma operand reads and TMA)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// box (c0, c1[, c2, c3]) of the tensor map into shared memory at dst
__device__ __forceinline__ void tma_load_2d(const CUtensorMap* map,
                                            uint64_t* bar, uint32_t dst,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(const CUtensorMap* map,
                                            uint64_t* bar, uint32_t dst,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// A wgmma shared-memory descriptor of a K-major tile in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart.
__device__ __forceinline__ uint64_t sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

// d = (accumulate ? d : 0) + a b: a 64 x 8 and b 8 x 32, float32 read as
// TF32 (the top 19 bits), both K-major in shared memory; float32 sums.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d = (accumulate ? d : 0) + a b: a the 64 x 8 A fragment in registers
// (TF32 bit patterns), b 8 x N K-major in shared memory; float32 sums. The
// PV product at N = Dh: 128, 96 or 64.
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                           const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n96(float (&d)[48],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  if constexpr (N == 128) wgmma_n128(d, a, b, accumulate);
  else if constexpr (N == 96) wgmma_n96(d, a, b, accumulate);
  else wgmma_n64(d, a, b, accumulate);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from moving reads or writes of v across this point
// (a wgmma writes its accumulator, and reads its A fragment, asynchronously)
template <int N>
__device__ __forceinline__ void reg_fence(float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(v[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(v[i])::"memory");
}

// x, opaque to the compiler from here on: a wgmma descriptor made from it
// is computed next to the wgmma that reads it (the asm statements keep
// their order), not hoisted out of the k-tile loop, where Q's Dh / 4
// descriptors would hold Dh / 2 registers across it (at Dh 128 ptxas then
// spilled 80 bytes).
__device__ __forceinline__ uint32_t pinned(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The wgmma instance's split: big is x itself, of which the tensor core
// reads the top 19 bits (it truncates), and small = x - trunc(x), exact in
// float32, of which it reads the top 19 bits again.
__device__ __forceinline__ float small_part(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
__device__ __forceinline__ float4 small_part(float4 x) {
  return make_float4(small_part(x.x), small_part(x.y), small_part(x.z),
                     small_part(x.w));
}

// all of a warp's lanes are done with what `bar` guards: one arrival
__device__ __forceinline__ void warp_arrive(uint64_t* bar) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar);
}

// small[i] = small_part(big[i]) for this splitter thread's float4s
template <int N>
__device__ __forceinline__ void split_tile(const float4* big, float4* small,
                                           int st) {
  constexpr int ROUNDS = (N + W_SPLITTERS - 1) / W_SPLITTERS;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int i = st + r * W_SPLITTERS;
    if (N % W_SPLITTERS == 0 || i < N) small[i] = small_part(big[i]);
  }
}

// The prologue: V (B, S, Hkv, DH) through its strides into V^T
// (B, Hkv, DH, S), contiguous, each group of 8 keys in the order the P
// fragment feeds the PV product: slot p holds key 2p for p < 4 and key
// 2(p - 4) + 1 for p >= 4. One CTA a (b, g) and VT_KEYS keys.
template <int DH>
__global__ void __launch_bounds__(256)
flash_vt(const float* __restrict__ V, float* __restrict__ Vt, Params p) {
  __shared__ float tile[VT_KEYS][DH + 1];
  const int tid = threadIdx.x;
  const int64_t bg = blockIdx.y;
  const int64_t s0 = (int64_t)blockIdx.x * VT_KEYS;
  const float* src = V + (bg / p.Hkv) * p.svb + (bg % p.Hkv) * p.svh +
                     s0 * p.svs;
  for (int i = tid; i < VT_KEYS * DH / 4; i += 256) {
    const int r = i / (DH / 4), c = 4 * (i % (DH / 4));
    const float4 x = load4(src + r * p.svs + c);
    tile[r][c] = x.x; tile[r][c + 1] = x.y;
    tile[r][c + 2] = x.z; tile[r][c + 3] = x.w;
  }
  __syncthreads();
  float* dst = Vt + bg * DH * p.S + s0;
  for (int i = tid; i < DH * VT_KEYS / 4; i += 256) {
    // float4 u of row d: slots 4 (u % 2) .. + 3 of key group u / 2, that
    // is its keys of parity u % 2
    const int d = i / (VT_KEYS / 4), u = i % (VT_KEYS / 4);
    const int key = 8 * (u / 2) + u % 2;
    *reinterpret_cast<float4*>(dst + d * p.S + 4 * u) =
        make_float4(tile[key][d], tile[key + 2][d], tile[key + 4][d],
                    tile[key + 6][d]);
  }
}

template <int DH, bool MASKED>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap k_map,
                const __grid_constant__ CUtensorMap vt_map,
                const float* __restrict__ Q, float* __restrict__ O,
                Params p) {
  using Wt = WTile<DH>;
  constexpr int STAGES = Wt::STAGES, SETS = Wt::SETS, STAGE = Wt::STAGE;
  constexpr int K_BYTES = Wt::K_BYTES, VT_BYTES = Wt::VT_BYTES;
  constexpr int ACC = DH / 2;   // a consumer thread's share of O, and of PV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* const base = smem_raw + (1024u - raw % 1024u) % 1024u;
  const uint32_t base_s = smem_addr(base);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(base + Wt::OFF_BARS);
  uint64_t* const full = bars;                 // a stage's tiles landed
  // the consumers are done with a stage, and so with the V^T small part
  // of its set
  uint64_t* const empty = bars + STAGES;
  // by set of small parts: K's written, K's read, V^T's written
  uint64_t* const k_ready = bars + 2 * STAGES;
  uint64_t* const k_free = k_ready + SETS;
  uint64_t* const v_ready = k_ready + 2 * SETS;

  const int tid = threadIdx.x;
  // a shuffle tells the compiler the role is uniform across the warp
  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int lane = tid % 32;
  const int64_t nqt = p.S / W_BQ;
  const int64_t qt = nqt - 1 - (int64_t)blockIdx.x / p.BH;  // heaviest first
  const int64_t bh = (int64_t)blockIdx.x % p.BH;
  const int64_t b = bh / p.H;
  const int64_t h = bh % p.H;
  const int64_t kvh = h / (p.H / p.Hkv);
  const int64_t q0 = qt * W_BQ;
  // MASKED: the instance of the calls with kv_len < S (key_tiles and the
  // mask below); the other is the full-length design as it was
  const int kv_last = (int)p.kv_len - 2 * (threadIdx.x % 4);
  const int64_t n_kt =
      MASKED ? key_tiles<W_BQ, W_BK>(p, q0)
             : p.causal ? (q0 + W_BQ - 1) / W_BK + 1 : p.S / W_BK;

  if (tid == 0) {
    // one arrival a warp: the splitters' 3, the consumers' 8
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W_CONSUMERS / 32);
    }
    for (int s = 0; s < SETS; ++s) {
      mbar_init(&k_ready[s], W_SPLITTERS / 32);
      mbar_init(&k_free[s], W_CONSUMERS / 32);
      mbar_init(&v_ready[s], W_SPLITTERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(PRODUCER_REGS));
    if (warp == 0) {
      // one thread keeps the ring full: K's tile as DH / 32 boxes of 32
      // columns, V^T's as one
      if (lane == 0) {
        const int row_vt = (int)((b * p.Hkv + kvh) * DH);
        for (int64_t kt = 0; kt < n_kt; ++kt) {
          const int slot = (int)(kt % STAGES);
          const uint32_t use = (uint32_t)(kt / STAGES);
          mbar_wait(&empty[slot], (use & 1u) ^ 1u);
          mbar_expect(&full[slot], STAGE);
          const uint32_t stage = base_s + Wt::OFF_RING + slot * STAGE;
          const int k0 = (int)(kt * W_BK);
#pragma unroll
          for (int c = 0; c < Wt::CHUNKS; ++c)
            tma_load_4d(&k_map, &full[slot], stage + c * K_CHUNK, 32 * c, k0,
                        (int)kvh, (int)b);
          tma_load_2d(&vt_map, &full[slot], stage + K_BYTES, k0, row_vt);
        }
      }
    } else {
      // the splitters: each landed tile's small part into set kt % SETS,
      // K's as soon as both consumers are done with the set's last one,
      // then V^T's once they have released the set's last stage. The raw
      // tile is the big part; the small part has its swizzled layout, so
      // the split goes float4 by float4.
      const int st = tid - 32;
      for (int64_t kt = 0; kt < n_kt; ++kt) {
        const int slot = (int)(kt % STAGES);
        const uint32_t use = (uint32_t)(kt / STAGES);
        const int set = (int)(kt % SETS);
        const uint32_t turn = (uint32_t)(kt / SETS) & 1u;
        float4* const k_small =
            reinterpret_cast<float4*>(base + Wt::OFF_SMALL + set * STAGE);
        const float4* const k_big = reinterpret_cast<const float4*>(
            base + Wt::OFF_RING + slot * STAGE);
        mbar_wait(&full[slot], use & 1u);
        mbar_wait(&k_free[set], turn ^ 1u);
        split_tile<K_BYTES / 16>(k_big, k_small, st);
        fence_proxy_async();
        warp_arrive(&k_ready[set]);
        if (kt >= SETS)
          mbar_wait(&empty[(kt - SETS) % STAGES],
                    (uint32_t)((kt - SETS) / STAGES) & 1u);
        split_tile<VT_BYTES / 16>(k_big + K_BYTES / 16, k_small + K_BYTES / 16,
                                  st);
        fence_proxy_async();
        warp_arrive(&v_ready[set]);
      }
    }
  } else {
    // the consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(CONSUMER_REGS));
    const int wg = warp / 4 - 1;
    const int ct = tid - 128 * (wg + 1);   // thread in the warpgroup
    const int g = lane / 4, t = lane % 4;
    // Q's rows, scaled, and their small parts, into the swizzled tiles
    {
      constexpr int ROW4 = DH / 4;           // float4s a row
      const float* Qb = Q + b * p.sqb + h * p.sqh + (q0 + 64 * wg) * p.sqs;
#pragma unroll 4
      for (int i = ct; i < 64 * ROW4; i += 128) {
        const int r = i / ROW4, c4 = i % ROW4;   // row, float4 along d
        float4 x = load4(Qb + r * p.sqs + 4 * c4);
        x.x *= p.scale; x.y *= p.scale; x.z *= p.scale; x.w *= p.scale;
        const int row = 64 * wg + r;
        const int off = (c4 / 8) * Q_CHUNK + row * ROW_BYTES +
                        (((c4 % 8) ^ (row % 8)) << 4);
        *reinterpret_cast<float4*>(base + Wt::OFF_QBIG + off) = x;
        *reinterpret_cast<float4*>(base + Wt::OFF_QSMALL + off) =
            small_part(x);
      }
      fence_proxy_async();
      asm volatile("bar.sync %0, 128;" :: "r"(1 + wg) : "memory");
    }
    const uint32_t q_big = base_s + Wt::OFF_QBIG + wg * 64 * ROW_BYTES;
    const uint32_t q_small = base_s + Wt::OFF_QSMALL + wg * 64 * ROW_BYTES;
    // this thread's rows: r0 and r0 + 8 of the tile (hh = 0, 1 below)
    const int r0 = 64 * wg + 16 * (warp % 4) + g;
    const int64_t warp_first = q0 + 64 * wg + 16 * (warp % 4);
    // the accumulators' layout: register 4 j + 2 hh + e holds row
    // r0 + 8 hh, column 8 j + 2 t + e
    float o[ACC], part[ACC], s[16], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < ACC; ++i) o[i] = 0.f;

    for (int64_t kt = 0; kt < n_kt; ++kt) {
      const int slot = (int)(kt % STAGES);
      const uint32_t use = (uint32_t)(kt / STAGES);
      const int set = (int)(kt % SETS);
      const uint32_t turn = (uint32_t)(kt / SETS) & 1u;
      const uint32_t k_big = base_s + Wt::OFF_RING + slot * STAGE;
      const uint32_t v_big = k_big + K_BYTES;
      const uint32_t k_small = base_s + Wt::OFF_SMALL + set * STAGE;
      const uint32_t v_small = k_small + K_BYTES;
      const int64_t k0 = kt * W_BK;

      // s = (scale q) k^T, DH / 8 k8 steps of d: the two passes on K's raw
      // tile as soon as it lands, the pass on its small part once split
      mbar_wait(&full[slot], use & 1u);
      reg_fence(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const uint32_t qo = (kk / 4) * Q_CHUNK + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * K_CHUNK + (kk % 4) * 32;
        wgmma_n32(s, sw128(pinned(q_small) + qo), sw128(k_big + ko), kk > 0);
        wgmma_n32(s, sw128(pinned(q_big) + qo), sw128(k_big + ko), 1);
      }
      mbar_wait(&k_ready[set], turn);
#pragma unroll
      for (int kk = 0; kk < DH / 8; ++kk) {
        const uint32_t qo = (kk / 4) * Q_CHUNK + (kk % 4) * 32;
        const uint32_t ko = (kk / 4) * K_CHUNK + (kk % 4) * 32;
        wgmma_n32(s, sw128(pinned(q_big) + qo), sw128(k_small + ko), 1);
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(s);
      warp_arrive(&k_free[set]);

      if (p.causal && k0 + W_BK - 1 > warp_first) {
#pragma unroll
        for (int j = 0; j < W_BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) > q0 + r0 + 8 * (e >> 1))
              s[4 * j + e] = NEG;
      }
      if constexpr (MASKED) {
        if (k0 + W_BK > p.kv_len) {
          // the last key tile, where the keys end inside it: keys from
          // kv_len on are masked, each register by its key (S's natural
          // order; P's slots are reordered after); lim as in flash_fwd,
          // from kv_last, the lane's limit before the loop, where hoisted
          const int lim = limit_hoisted(DH) ? kv_last - (int)k0
                                            : (int)(p.kv_len - k0) - 2 * t;
#pragma unroll
          for (int j = 0; j < W_BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * j + (e & 1) >= lim) s[4 * j + e] = NEG;
        }
      }
      // online softmax: new running max, correction, probabilities
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = fmaxf(s[2 * hh], s[2 * hh + 1]);
#pragma unroll
        for (int j = 1; j < W_BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float mn = fmaxf(m[hh], mx);
        corr[hh] = expf(m[hh] - mn);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < W_BK / 8; ++j) {
          s[4 * j + 2 * hh] = expf(s[4 * j + 2 * hh] - mn);
          s[4 * j + 2 * hh + 1] = expf(s[4 * j + 2 * hh + 1] - mn);
          sum += s[4 * j + 2 * hh] + s[4 * j + 2 * hh + 1];
        }
        l[hh] = l[hh] * corr[hh] + sum;
        m[hh] = mn;
      }
      // P as the PV product's A fragment, k8 step j = keys 8 j .. 8 j + 7:
      // slot t is key 2t, slot t + 4 key 2t + 1 (the order V^T's groups of
      // 8 keys are in), so (a0, a1, a2, a3) = (s0, s2, s1, s3); big is p
      uint32_t p_big[16], p_small[16];
#pragma unroll
      for (int j = 0; j < W_BK / 8; ++j) {
        const int from[4] = {0, 2, 1, 3};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p_big[4 * j + e] = __float_as_uint(s[4 * j + from[e]]);
          p_small[4 * j + e] = __float_as_uint(small_part(s[4 * j + from[e]]));
        }
      }

      // part = P V over this k-tile into a fresh accumulator, the passes
      // on V^T's raw tile first; then o = o * corr + part
      reg_fence(part);
      reg_fence(p_big);
      reg_fence(p_small);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < W_BK / 8; ++j) {
        const uint32_t a_big[4] = {p_big[4 * j], p_big[4 * j + 1],
                                   p_big[4 * j + 2], p_big[4 * j + 3]};
        const uint32_t a_small[4] = {p_small[4 * j], p_small[4 * j + 1],
                                     p_small[4 * j + 2], p_small[4 * j + 3]};
        wgmma_pv<DH>(part, a_small, sw128(v_big + 32 * j), j > 0);
        wgmma_pv<DH>(part, a_big, sw128(v_big + 32 * j), 1);
      }
      mbar_wait(&v_ready[set], turn);
#pragma unroll
      for (int j = 0; j < W_BK / 8; ++j) {
        const uint32_t a_big[4] = {p_big[4 * j], p_big[4 * j + 1],
                                   p_big[4 * j + 2], p_big[4 * j + 3]};
        wgmma_pv<DH>(part, a_big, sw128(v_small + 32 * j), 1);
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(part);
      reg_fence(p_big);
      reg_fence(p_small);
      warp_arrive(&empty[slot]);
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        o[i] = fmaf(o[i], corr[(i >> 1) & 1], part[i]);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float li = l[hh];
      li += __shfl_xor_sync(FULL, li, 1);
      li += __shfl_xor_sync(FULL, li, 2);
      const float denom = fmaxf(li, 1e-30f);
      const int64_t row = q0 + r0 + 8 * hh;
      float* orow = O + ((b * p.S + row) * p.H + h) * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        store2(orow + 8 * j, o[4 * j + 2 * hh] / denom,
               o[4 * j + 2 * hh + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 instances at Dh 64, 96 and 128: TMA, bf16 wgmma, warp
// specialisation (see the header).

constexpr int B_PRODUCER_REGS = 40, B_CONSUMER_REGS = 232;  // setmaxnreg

// Each bf16 width's form: the keys of its k-tile (BK, the N of QK^T), the
// stages of its TMA ring (a K and a V tile each) and the swizzle its tiles
// lie in, in bytes a swizzle row (128 holds 64 bf16 columns, 64 holds 32).
// ptxas compiles every form the probe tries without serialising the wgmma;
// each width takes its fastest in turns (tools/flash_attention_probe.py;
// PERF.md): BK 64 runs 8% to 19% slower at Dh 64 and 128; the stage
// counts lie within the noise of the forms below. Dh 96 lies in the
// 64-byte swizzle, whose 32 columns divide it, so a PV step is one wgmma
// (the 128-byte swizzle, chunks of 64 and 32 columns and a wgmma a chunk,
// measured no faster).
template <int DH> struct BForm;
template <> struct BForm<64> { static constexpr int BK = 128, STAGES = 4, SWIZZLE = 128; };
template <> struct BForm<96> { static constexpr int BK = 128, STAGES = 3, SWIZZLE = 64; };
template <> struct BForm<128> { static constexpr int BK = 128, STAGES = 3, SWIZZLE = 128; };

// The bf16 shared-memory layout at width DH: offsets from the 1,024-byte
// boundary the swizzle repeats on. Each tile lies in DH / COLS chunks of
// COLS columns, a chunk's rows SW bytes apart, as TMA writes a box of COLS
// columns: Q's 128 rows, then the ring of K and V tiles.
template <int DH>
struct BTile {
  static constexpr int BK = BForm<DH>::BK, STAGES = BForm<DH>::STAGES;
  static constexpr int SW = BForm<DH>::SWIZZLE;
  static constexpr int COLS = SW / 2;                // bf16 columns a chunk
  static constexpr int CHUNKS = DH / COLS;
  static constexpr int Q_CHUNK = W_BQ * SW;
  static constexpr int KV_CHUNK = BK * SW;
  static constexpr int Q_BYTES = CHUNKS * Q_CHUNK;
  static constexpr int K_BYTES = CHUNKS * KV_CHUNK;  // and V's
  static constexpr int STAGE = 2 * K_BYTES;
  static constexpr int OFF_Q = 0;
  static constexpr int OFF_RING = OFF_Q + Q_BYTES;
  static constexpr int OFF_BARS = OFF_RING + STAGES * STAGE;
  static constexpr int BARRIERS = 2 * STAGES + 1;
  static constexpr int SMEM = 1024 + OFF_BARS + 8 * BARRIERS;
  static_assert((SW == 128 || SW == 64) && DH % COLS == 0,
                "a row of a tile is CHUNKS whole swizzle rows");
  static_assert((BK == 64 || BK == 128) && W_BQ % 64 == 0,
                "QK^T is one m64nBKk16 a k16 step");
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};

// A wgmma descriptor of a tile in the SW-byte swizzle: rows of SW bytes,
// 8-row groups 8 SW bytes apart; ``lbo`` bytes between chunks of columns
// (an MN-major operand's N; a K-major one reads one chunk a wgmma).
template <int SW>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3ffffu) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(8 * SW >> 4) << 32 | (uint64_t)(SW == 128 ? 1 : 2) << 62;
}

// d = (accumulate ? d : 0) + a b: a 64 x 16 and b 16 x N, bf16, both
// K-major in shared memory; float32 sums. QK^T at N = BK.
template <int N>
__device__ __forceinline__ void wgmma_qk(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_qk<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_qk<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
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
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// d = (accumulate ? d : 0) + a b: a the 64 x 16 A fragment in registers
// (bf16 pairs), b 16 x N MN-major in shared memory (the transpose flag);
// float32 sums. PV at N = Dh.
template <int N>
__device__ __forceinline__ void wgmma_pv_bf16(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int accumulate);
template <>
__device__ __forceinline__ void wgmma_pv_bf16<64>(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_pv_bf16<96>(float (&d)[48],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
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
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_pv_bf16<128>(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// x and y rounded to the nearest bf16, x in the low half
__device__ __forceinline__ uint32_t bf16_pair(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int DH, bool MASKED>
__global__ void __launch_bounds__(W_THREADS, 1)
flash_fwd_wgmma_bf16(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     __nv_bfloat16* __restrict__ O, Params p) {
  using Bt = BTile<DH>;
  constexpr int BK = Bt::BK, STAGES = Bt::STAGES, STAGE = Bt::STAGE;
  constexpr int SW = Bt::SW, COLS = Bt::COLS, K_BYTES = Bt::K_BYTES;
  constexpr int ACC = DH / 2;   // a consumer thread's share of O, and of PV
  constexpr int S_ACC = BK / 2;  // and of S
  // its own name for the dynamic shared memory: a use of smem_raw here
  // changes the code the compiler emits for the float32 wgmma kernels,
  // which find their 1,024-byte boundary in it the same way
  extern __shared__ __align__(16) unsigned char smem_bf16[];
  const uint32_t raw = smem_addr(smem_bf16);
  unsigned char* const base = smem_bf16 + (1024u - raw % 1024u) % 1024u;
  const uint32_t base_s = smem_addr(base);
  uint64_t* const bars = reinterpret_cast<uint64_t*>(base + Bt::OFF_BARS);
  uint64_t* const full = bars;                  // a stage's tiles landed
  uint64_t* const empty = bars + STAGES;        // the consumers are done
  uint64_t* const q_full = bars + 2 * STAGES;   // Q's tile landed

  const int tid = threadIdx.x;
  // a shuffle tells the compiler the role is uniform across the warp
  const int warp = __shfl_sync(FULL, tid / 32, 0);
  const int lane = tid % 32;
  const int64_t nqt = p.S / W_BQ;
  const int64_t qt = nqt - 1 - (int64_t)blockIdx.x / p.BH;  // heaviest first
  const int64_t bh = (int64_t)blockIdx.x % p.BH;
  const int64_t b = bh / p.H;
  const int64_t h = bh % p.H;
  const int64_t kvh = h / (p.H / p.Hkv);
  const int64_t q0 = qt * W_BQ;
  // MASKED: as in flash_fwd_wgmma
  const int64_t n_kt =
      MASKED ? key_tiles<W_BQ, BK>(p, q0)
             : p.causal ? (q0 + W_BQ - 1) / BK + 1 : p.S / BK;

  if (tid == 0) {
    // one arrival a warp: the consumers' 8
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], W_CONSUMERS / 32);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // the producer warpgroup: one thread loads Q's tile once, then keeps
    // the ring full, each tile as DH / COLS boxes of COLS columns
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" :: "n"(B_PRODUCER_REGS));
    if (warp == 0) {
      if (lane == 0) {
        mbar_expect(q_full, Bt::Q_BYTES);
#pragma unroll
        for (int c = 0; c < Bt::CHUNKS; ++c)
          tma_load_4d(&q_map, q_full, base_s + Bt::OFF_Q + c * Bt::Q_CHUNK,
                      COLS * c, (int)q0, (int)h, (int)b);
        for (int64_t kt = 0; kt < n_kt; ++kt) {
          const int slot = (int)(kt % STAGES);
          const uint32_t use = (uint32_t)(kt / STAGES);
          mbar_wait(&empty[slot], (use & 1u) ^ 1u);
          mbar_expect(&full[slot], STAGE);
          const uint32_t stage = base_s + Bt::OFF_RING + slot * STAGE;
          const int k0 = (int)(kt * BK);
#pragma unroll
          for (int c = 0; c < Bt::CHUNKS; ++c) {
            tma_load_4d(&k_map, &full[slot], stage + c * Bt::KV_CHUNK,
                        COLS * c, k0, (int)kvh, (int)b);
            tma_load_4d(&v_map, &full[slot],
                        stage + K_BYTES + c * Bt::KV_CHUNK, COLS * c, k0,
                        (int)kvh, (int)b);
          }
        }
      }
    }
  } else {
    // the consumers: warpgroup wg owns query rows 64 wg .. 64 wg + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" :: "n"(B_CONSUMER_REGS));
    const int wg = warp / 4 - 1;
    const int g = lane / 4, t = lane % 4;
    const uint32_t q_s = base_s + Bt::OFF_Q + wg * 64 * SW;
    // this thread's rows: r0 and r0 + 8 of the tile (hh = 0, 1 below)
    const int r0 = 64 * wg + 16 * (warp % 4) + g;
    const int64_t warp_first = q0 + 64 * wg + 16 * (warp % 4);
    // the accumulators' layout: register 4 j + 2 hh + e holds row
    // r0 + 8 hh, column 8 j + 2 t + e
    float o[ACC], part[ACC], s[S_ACC], m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    // P's bf16 parts as the PV product's A fragments: k16 step j is
    // registers 4 j .. 4 j + 3
    uint32_t p_hi[S_ACC / 2], p_lo[S_ACC / 2];
#pragma unroll
    for (int i = 0; i < ACC; ++i) o[i] = 0.f;
    mbar_wait(q_full, 0u);

    // acc = q k^T of tile kt once it lands, DH / 16 k16 steps of d in one
    // bf16 pass (the products of bf16 values are exact in float32),
    // issued and committed
    auto issue_qk = [&](float (&acc)[S_ACC], int64_t kt) {
      const int slot = (int)(kt % STAGES);
      const uint32_t k_s = base_s + Bt::OFF_RING + slot * STAGE;
      mbar_wait(&full[slot], (uint32_t)(kt / STAGES) & 1u);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        // chunk c of d, 32 bytes a k16 step along its rows
        const int c = kk / (COLS / 16), off = (kk % (COLS / 16)) * 32;
        wgmma_qk<BK>(acc,
                     sw_desc<SW>(pinned(q_s) + c * Bt::Q_CHUNK + off, 16),
                     sw_desc<SW>(k_s + c * Bt::KV_CHUNK + off, 16), kk > 0);
      }
      wgmma_commit();
    };

    for (int64_t kt = 0; kt < n_kt; ++kt) {
      const int slot = (int)(kt % STAGES);
      const uint32_t v_s = base_s + Bt::OFF_RING + slot * STAGE + K_BYTES;
      const int64_t k0 = kt * BK;

      // s = q k^T, then the scale in float32
      issue_qk(s, kt);
      wgmma_wait();
      reg_fence(s);
#pragma unroll
      for (int i = 0; i < S_ACC; ++i) s[i] *= p.scale;

      if (p.causal && k0 + BK - 1 > warp_first) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + 8 * j + 2 * t + (e & 1) > q0 + r0 + 8 * (e >> 1))
              s[4 * j + e] = NEG;
      }
      if constexpr (MASKED) {
        if (k0 + BK > p.kv_len) {
          // the last key tile, where the keys end inside it: keys from
          // kv_len on are masked; lim as in flash_fwd
          const int lim = (int)(p.kv_len - k0) - 2 * t;
#pragma unroll
          for (int j = 0; j < BK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (8 * j + (e & 1) >= lim) s[4 * j + e] = NEG;
        }
      }
      // online softmax: new running max, correction, probabilities
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = fmaxf(s[2 * hh], s[2 * hh + 1]);
#pragma unroll
        for (int j = 1; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
        const float mn = fmaxf(m[hh], mx);
        corr[hh] = expf(m[hh] - mn);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          s[4 * j + 2 * hh] = expf(s[4 * j + 2 * hh] - mn);
          s[4 * j + 2 * hh + 1] = expf(s[4 * j + 2 * hh + 1] - mn);
          sum += s[4 * j + 2 * hh] + s[4 * j + 2 * hh + 1];
        }
        l[hh] = l[hh] * corr[hh] + sum;
        m[hh] = mn;
      }
      // P in two bf16 parts, hi = bf16(p) and lo = bf16(p - hi) (p - hi is
      // exact): the registers of 16 consecutive keys, paired, are a k16
      // step's A fragment as they stand
#pragma unroll
      for (int i = 0; i < S_ACC / 2; ++i) {
        p_hi[i] = bf16_pair(s[2 * i], s[2 * i + 1]);
        p_lo[i] = bf16_pair(s[2 * i] - __uint_as_float(p_hi[i] << 16),
                            s[2 * i + 1] -
                                __uint_as_float(p_hi[i] & 0xffff0000u));
      }

      // part = P V over this k-tile into a fresh accumulator, hi and lo on
      // the same V descriptor a k16 step; then o = o * corr + part
      reg_fence(part);
      reg_fence(p_hi);
      reg_fence(p_lo);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {
        const uint32_t a_hi[4] = {p_hi[4 * j], p_hi[4 * j + 1],
                                  p_hi[4 * j + 2], p_hi[4 * j + 3]};
        const uint32_t a_lo[4] = {p_lo[4 * j], p_lo[4 * j + 1],
                                  p_lo[4 * j + 2], p_lo[4 * j + 3]};
        const uint32_t v_j = v_s + j * 16 * SW;
        const uint64_t v_desc = sw_desc<SW>(v_j, Bt::KV_CHUNK);
        wgmma_pv_bf16<DH>(part, a_hi, v_desc, j > 0);
        wgmma_pv_bf16<DH>(part, a_lo, v_desc, 1);
      }
      wgmma_commit();
      wgmma_wait();
      reg_fence(part);
      reg_fence(p_hi);
      reg_fence(p_lo);
      warp_arrive(&empty[slot]);
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        o[i] = fmaf(o[i], corr[(i >> 1) & 1], part[i]);
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float li = l[hh];
      li += __shfl_xor_sync(FULL, li, 1);
      li += __shfl_xor_sync(FULL, li, 2);
      const float denom = fmaxf(li, 1e-30f);
      const int64_t row = q0 + r0 + 8 * hh;
      __nv_bfloat16* orow = O + ((b * p.S + row) * p.H + h) * DH + 2 * t;
#pragma unroll
      for (int j = 0; j < DH / 8; ++j)
        store2(orow + 8 * j, o[4 * j + 2 * hh] / denom,
               o[4 * j + 2 * hh + 1] / denom);
    }
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

// A float32 tensor of `rank` dimensions (dims[0] contiguous, the others
// `strides` bytes apart), in boxes of `box`, 128-byte swizzle.
bool encode_f32(CUtensorMap* map, const void* base, cuuint32_t rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The prologue: V (p's S, Hkv and V strides) into vt, B * Hkv * DH * S
// float32.
template <int DH>
int launch_vt(const float* v, float* vt, const Params& p, int64_t B,
              cudaStream_t s) {
  if (B <= 0 || p.Hkv <= 0 || p.S <= 0 || p.S % VT_KEYS ||
      B * p.Hkv > 65535 || p.S / VT_KEYS > 0x7fffffffLL ||
      (uintptr_t)v % 16 || (uintptr_t)vt % 16 || p.svb % 4 || p.svs % 4 ||
      p.svh % 4)
    return (int)cudaErrorInvalidValue;
  flash_vt<DH><<<dim3((unsigned)(p.S / VT_KEYS), (unsigned)(B * p.Hkv)), 256,
                 0, s>>>(v, vt, p);
  return (int)cudaGetLastError();
}

// The prologue, then the kernel. vt: the caller's scratch of B * Hkv * DH
// * S float32 for V^T.
template <int DH>
int run_wgmma(const float* q, const float* k, const float* v, float* vt,
              float* o, const Params& p, int64_t B, cudaStream_t s) {
  using Wt = WTile<DH>;
  if (p.S % W_BQ || p.S >= (1LL << 31) || B >= (1LL << 31) ||
      (uintptr_t)k % 16 || (uintptr_t)q % 16 || p.sks % 4 || p.skh % 4 ||
      p.skb % 4 || p.sqs % 4 || p.sqh % 4 || p.sqb % 4)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = (cudaError_t)launch_vt<DH>(v, vt, p, B, s);
  if (err != cudaSuccess) return (int)err;
  const int64_t kv_heads = B * p.Hkv;

  // K as (Dh, S, Hkv, B) through its strides (a stride of a dimension of
  // one is never stepped: a multiple of 16 bytes stands in for it); V^T as
  // (S, B Hkv Dh)
  CUtensorMap k_map, vt_map;
  const cuuint64_t k_dims[4] = {(cuuint64_t)DH, (cuuint64_t)p.S,
                                (cuuint64_t)p.Hkv, (cuuint64_t)B};
  const cuuint64_t k_strides[3] = {
      (cuuint64_t)p.sks * 4, (cuuint64_t)(p.Hkv > 1 ? p.skh : DH) * 4,
      (cuuint64_t)(B > 1 ? p.skb : p.S * p.sks) * 4};
  const cuuint32_t k_box[4] = {32, W_BK, 1, 1};
  const cuuint64_t vt_dims[2] = {(cuuint64_t)p.S,
                                 (cuuint64_t)(kv_heads * DH)};
  const cuuint64_t vt_strides[1] = {(cuuint64_t)p.S * 4};
  const cuuint32_t vt_box[2] = {W_BK, DH};
  if (!encode_f32(&k_map, k, 4, k_dims, k_strides, k_box) ||
      !encode_f32(&vt_map, vt, 2, vt_dims, vt_strides, vt_box))
    return (int)cudaErrorInvalidValue;
  // the masked instance only where the keys end before S
  const auto kernel = p.kv_len < p.S ? flash_fwd_wgmma<DH, true>
                                     : flash_fwd_wgmma<DH, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Wt::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (p.S / W_BQ) * p.BH;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, W_THREADS, Wt::SMEM, s>>>(k_map, vt_map, q, o,
                                                       p);
  return (int)cudaGetLastError();
}

// A bf16 tensor of four dimensions (dims[0] contiguous, the others
// `strides` bytes apart), in boxes of `box`, in the swizzle of `sw` bytes.
bool encode_bf16(CUtensorMap* map, const void* base, const cuuint64_t* dims,
                 const cuuint64_t* strides, const cuuint32_t* box, int sw) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 kernel at width DH: one launch, no prologue.
template <int DH>
int run_wgmma_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, const Params& p,
                   int64_t B, cudaStream_t s) {
  using Bt = BTile<DH>;
  if (p.S % W_BQ || p.S % Bt::BK || p.S >= (1LL << 31) || B >= (1LL << 31) ||
      p.H >= (1LL << 31) || (uintptr_t)q % 16 || (uintptr_t)k % 16 ||
      (uintptr_t)v % 16 || p.sqb % 8 || p.sqs % 8 || p.sqh % 8 ||
      p.skb % 8 || p.sks % 8 || p.skh % 8 || p.svb % 8 || p.svs % 8 ||
      p.svh % 8)
    return (int)cudaErrorInvalidValue;
  // q, k and v each as (Dh, S, heads, B) through its strides (a stride of
  // a dimension of one is never stepped: a multiple of 16 bytes stands in
  // for it), Q's tile as DH / COLS boxes of 128 rows, K's and V's of BK
  auto dims_of = [&](int64_t heads) {
    return std::array<cuuint64_t, 4>{(cuuint64_t)DH, (cuuint64_t)p.S,
                                     (cuuint64_t)heads, (cuuint64_t)B};
  };
  auto strides_of = [&](int64_t sb, int64_t ss, int64_t sh, int64_t heads) {
    return std::array<cuuint64_t, 3>{
        (cuuint64_t)ss * 2, (cuuint64_t)(heads > 1 ? sh : DH) * 2,
        (cuuint64_t)(B > 1 ? sb : p.S * ss) * 2};
  };
  const auto q_dims = dims_of(p.H), kv_dims = dims_of(p.Hkv);
  const auto q_strides = strides_of(p.sqb, p.sqs, p.sqh, p.H);
  const auto k_strides = strides_of(p.skb, p.sks, p.skh, p.Hkv);
  const auto v_strides = strides_of(p.svb, p.svs, p.svh, p.Hkv);
  const cuuint32_t q_box[4] = {Bt::COLS, W_BQ, 1, 1};
  const cuuint32_t kv_box[4] = {Bt::COLS, Bt::BK, 1, 1};
  CUtensorMap q_map, k_map, v_map;
  if (!encode_bf16(&q_map, q, q_dims.data(), q_strides.data(), q_box,
                   Bt::SW) ||
      !encode_bf16(&k_map, k, kv_dims.data(), k_strides.data(), kv_box,
                   Bt::SW) ||
      !encode_bf16(&v_map, v, kv_dims.data(), v_strides.data(), kv_box,
                   Bt::SW))
    return (int)cudaErrorInvalidValue;
  // the masked instance only where the keys end before S
  const auto kernel = p.kv_len < p.S ? flash_fwd_wgmma_bf16<DH, true>
                                     : flash_fwd_wgmma_bf16<DH, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Bt::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (p.S / W_BQ) * p.BH;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, W_THREADS, Bt::SMEM, s>>>(q_map, k_map, v_map, o,
                                                       p);
  return (int)cudaGetLastError();
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
  // the wgmma widths run flash_fwd_wgmma (flash_attention_f32_wgmma) and
  // flash_fwd_wgmma_bf16 (flash_attention_bf16_wgmma)
  if constexpr (compiled(BQ, BK, DH) && !wgmma_width(DH))
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

// The kernels' parameters: ``strides`` the (batch, sequence, head) strides
// of q, k and v in elements.
Params params(int64_t B, int64_t S, int64_t kv_len, int64_t H, int64_t Hkv,
              const int64_t* strides, float scale, int64_t causal) {
  Params p;
  p.S = S; p.H = H; p.Hkv = Hkv; p.BH = B * H;
  p.sqb = strides[0]; p.sqs = strides[1]; p.sqh = strides[2];
  p.skb = strides[3]; p.sks = strides[4]; p.skh = strides[5];
  p.svb = strides[6]; p.svs = strides[7]; p.svh = strides[8];
  p.scale = scale;
  p.causal = causal ? 1 : 0;
  p.kv_len = kv_len;
  return p;
}

template <typename T>
int run(const T* q, const T* k, const T* v, T* o, int64_t B, int64_t S,
        int64_t kv_len, int64_t H, int64_t Hkv, int64_t Dh,
        const int64_t* strides, float scale, int64_t causal, int64_t bq,
        int64_t bk, void* stream) {
  if (B <= 0 || S <= 0 || kv_len < 1 || kv_len > S || H <= 0 || Hkv <= 0 ||
      bq <= 0 || bk <= 0 || H % Hkv || S % bq || S % bk)
    return (int)cudaErrorInvalidValue;
  const Params p = params(B, S, kv_len, H, Hkv, strides, scale, causal);
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
// attention has (the wrapper's Dh before any zero padding); ``kv_len``,
// 1 to S, the keys every query sees (S but for a call the wrapper padded
// along S: there the rows past kv_len are zeros it adds and drops). Each
// returns the cudaError_t of its launch (0 on success, and
// cudaErrorInvalidValue for a shape or tile that is not compiled); it
// neither synchronises nor allocates.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int64_t B,
                                   int64_t S, int64_t kv_len, int64_t H,
                                   int64_t Hkv, int64_t Dh,
                                   const int64_t* strides, float scale,
                                   int64_t causal, int64_t bq, int64_t bk,
                                   void* stream) {
  return run<float>(q, k, v, o, B, S, kv_len, H, Hkv, Dh, strides, scale,
                    causal, bq, bk, stream);
}

// float32 at Dh 64, 96 or 128 (flash_fwd_wgmma), the arguments of
// flash_attention_f32 and ``vt``: scratch of B * Hkv * Dh * S float32,
// 16-byte aligned, which the prologue fills with V^T. S a multiple of 128,
// (bq, bk) = (128, 32), every stride a multiple of 4 elements and q, k, v
// 16-byte aligned.
extern "C" int flash_attention_f32_wgmma(const float* q, const float* k,
                                         const float* v, float* vt, float* o,
                                         int64_t B, int64_t S, int64_t kv_len,
                                         int64_t H, int64_t Hkv, int64_t Dh,
                                         const int64_t* strides, float scale,
                                         int64_t causal, int64_t bq,
                                         int64_t bk, void* stream) {
  if (B <= 0 || S <= 0 || kv_len < 1 || kv_len > S || H <= 0 || Hkv <= 0 ||
      H % Hkv || bq != W_BQ || bk != W_BK)
    return (int)cudaErrorInvalidValue;
  const Params p = params(B, S, kv_len, H, Hkv, strides, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return run_wgmma<64>(q, k, v, vt, o, p, B, s);
    case 96: return run_wgmma<96>(q, k, v, vt, o, p, B, s);
    case 128: return run_wgmma<128>(q, k, v, vt, o, p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The prologue alone (what flash_attention_f32_wgmma runs first): v
// (B, S, Hkv, Dh), Dh 64, 96 or 128, through its (batch, sequence, head)
// strides ``strides`` into vt (B, Hkv, Dh, S), S a multiple of 64.
extern "C" int flash_attention_vt(const float* v, float* vt, int64_t B,
                                  int64_t S, int64_t Hkv, int64_t Dh,
                                  const int64_t* strides, void* stream) {
  Params p = {};
  p.S = S; p.Hkv = Hkv;
  p.svb = strides[0]; p.svs = strides[1]; p.svh = strides[2];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64: return launch_vt<64>(v, vt, p, B, s);
    case 96: return launch_vt<96>(v, vt, p, B, s);
    case 128: return launch_vt<128>(v, vt, p, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int64_t B, int64_t S, int64_t kv_len,
                                    int64_t H, int64_t Hkv, int64_t Dh,
                                    const int64_t* strides, float scale,
                                    int64_t causal, int64_t bq, int64_t bk,
                                    void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, B, S, kv_len, H, Hkv, Dh, strides,
                            scale, causal, bq, bk, stream);
}

// bf16 at Dh 64, 96 or 128 (flash_fwd_wgmma_bf16), the arguments of
// flash_attention_bf16: one launch, no scratch. S a multiple of 128 and
// of the width's BK, (bq, bk) = (128, BK), every stride a multiple of 8
// elements and q, k, v 16-byte aligned.
extern "C" int flash_attention_bf16_wgmma(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    __nv_bfloat16* o, int64_t B, int64_t S, int64_t kv_len, int64_t H,
    int64_t Hkv, int64_t Dh, const int64_t* strides, float scale,
    int64_t causal, int64_t bq, int64_t bk, void* stream) {
  if (B <= 0 || S <= 0 || kv_len < 1 || kv_len > S || H <= 0 || Hkv <= 0 ||
      H % Hkv || bq != W_BQ)
    return (int)cudaErrorInvalidValue;
  const Params p = params(B, S, kv_len, H, Hkv, strides, scale, causal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      if (bk == BForm<64>::BK) return run_wgmma_bf16<64>(q, k, v, o, p, B, s);
      break;
    case 96:
      if (bk == BForm<96>::BK) return run_wgmma_bf16<96>(q, k, v, o, p, B, s);
      break;
    case 128:
      if (bk == BForm<128>::BK)
        return run_wgmma_bf16<128>(q, k, v, o, p, B, s);
      break;
  }
  return (int)cudaErrorInvalidValue;
}
