// sketch_fused.cu: Pi @ A and the squared column norms of A, in one read of A,
// on Hopper's tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sketch_fused.py:50
// (sketch_fused, body _kernel). Pi is (k, d), A is (d, n), both row-major,
// float32 or bf16; out is (k, n) float32 and norm2 is (n,) float32. Each
// output element is written once, with no atomics: runs repeat bit for bit.
// Two instances with designs of their own, one per input type, both on TMA,
// wgmma and thread block clusters.
//
// float32 (sketch_fused_f32_kernel, entry sketch_fused_f32). What bounds it
// on an H100: operations. A float32-accurate product on the TF32 tensor
// cores takes three passes (below), 3 * 2*k*d*n FLOP at 495 TFLOP/s: 31.03
// ms at k = 512, d = 50,000, n = 100,000. Its bytes, (k*d + d*n + k*n + n)
// * 4, take 6.06 ms at 3.35 TB/s; the same product on the float32 FMA units
// would take 76.57 ms at 67 TFLOP/s. The design:
//  * The transposed product, out^T = A^T Pi^T, so that both operands are
//    legal for TF32 wgmma, which reads a B operand from shared memory
//    K-major only and a tile of row-major A is N-major. wgmma.mma_async
//    m64n128k8 .tf32: M is 64 columns of A, N is 128 rows of Pi, K is 8
//    rows of d. B is Pi's tile, K-major as row-major Pi lies (its rows are
//    contiguous in d). A is A^T's fragment in registers: each consumer
//    thread loads its values from A's tile in shared memory, which does the
//    transpose. B reads 4 KiB of shared memory a 131,072-FLOP wgmma.
//  * The split: a raw float32 value is its own big part (the tensor core
//    reads its top 19 bits: it truncates), small = x - trunc(x) is exact in
//    float32 and truncated again as it is read (about 2^-20 relative).
//    Three passes a k8 step: A small x Pi big, A big x Pi big, A big x Pi
//    small. A's small part is made in registers; Pi's must lie in shared
//    memory, so a prologue (sketch_pi_small) writes Pi - trunc(Pi) once a
//    call into scratch the wrapper allocates (k*d*4 bytes), which TMA loads
//    beside Pi. One TF32 pass would be off by about 5e-4 of a column's
//    largest entry at d = 50,000.
//  * Two-level sum: the tensor cores add inside a wgmma with truncation,
//    which over d = 50,000 would bias a single accumulator toward zero by
//    about 1e-4 of a column's largest entry. A chain of F32_CHAIN_STAGES
//    stages (256 rows of d, 96 wgmma) goes into a fresh accumulator
//    (scale-d 0 on its first wgmma), which is then added to the float32 sum
//    with an ordinary FADD (tests/test_torch_sketch.py emulates both).
//    Warpgroup 1's chains are offset from warpgroup 0's by half a chain, so
//    one warpgroup's wgmma run while the other adds.
//  * Warp-specialised, 288 threads: one thread of warp 8 keeps a ring of
//    F32_STAGES stages in flight on mbarriers (full: the stage's bytes have
//    landed; empty: every consumer warp of the cluster is done with it).
//    Warpgroups 0 and 1 (warps 0-7) own 64 columns each of a CTA's 128. A
//    stage is Pi's 128 x 32 tile, its small part's, and A's 32 x 128 tile
//    as four 32-column boxes, all with the 128-byte swizzle (one 128-byte
//    row of 32 float32): 48 KiB, four stages 192 KiB.
//  * A stage at a time in each warpgroup: it waits for the stage, loads its
//    fragments, issues its 12 wgmma, waits for them and releases the stage
//    at once, while the other warpgroup's wgmma keep the tensor cores
//    busy. Measured in turns on the card (PERF.md), this beat loading the
//    next stage's fragments into a second set while a stage's wgmma run: a
//    consumer then holds two stages of the ring, and the copies run one
//    stage ahead. Loading each k8 step's fragments beside the step
//    before's wgmma gained nothing either.
//  * Registers: ptxas gives a thread 168 of them at 288 threads (three
//    warps share a quarter of the SM's file), and held the consumers to
//    168 at 384 threads with setmaxnreg 232 too, serialising their wgmma
//    (C7512); so do branches between a wgmma and the wait that retires it
//    while its A registers are live (C7518). The fresh accumulator (64), a
//    stage's fragments (32) and half the float32 sums (32) lie in
//    registers; the other half of the sums, the CTA's 128 x 64 of its 128 x
//    128 output tile, in shared memory (32 KiB), each thread's own values.
//    A chain's end adds the fresh accumulator into both halves.
//  * A's fragments: the wgmma's M index may map to the columns of A in any
//    order, which the store undoes. A thread's two M rows (g and g + 8 of
//    its warp) are two neighbouring columns, so a k8 step takes two 8-byte
//    loads (rows t and t + 4 of d); the two warps of a 32-column box take
//    alternate 16-byte chunks of its rows, so that the swizzle spreads a
//    load's lanes over all 32 banks. A stage's fragments, big and small, are
//    32 registers.
//  * Thread block clusters along n: the CTAs of F32_CLUSTER_N neighbouring
//    column tiles of A that meet the same row block of Pi form a cluster,
//    and each loads a share of the rows of Pi's tile and of its small
//    part's, multicast into every CTA of the cluster. A stage is refilled
//    once all 8 consumer warps of every CTA have released it (remote
//    arrives, lane c to CTA c). Clusters of 2 along n (66 of them fill the
//    132 SMs of an H100; a CTA reads 32 KiB of a 48 KiB stage from L2)
//    measured faster on the card than the bf16 instance's 4 along k
//    multicasting A's tile (30 clusters, 120 SMs, 36 KiB), 2 along k (66,
//    40 KiB), 2 x 2 and 4 along n (30 each) and 4 x 2 (15): PERF.md. The
//    code takes F32_CLUSTER_MAX CTAs along k as well (A's boxes multicast
//    among them); tools/sketch_fused_probe.py's along_k variant runs the
//    4-along-k layout. Where k has more row blocks than a cluster holds, a
//    cluster walks groups of them; a CTA whose row block lies past k loads
//    no Pi tile and stores nothing (its wgmma run on a stale tile), and one
//    whose column tile lies past n stores nothing. Persistent clusters, as
//    many as the card holds, walk the units (row group, column group) row
//    group first, so the clusters that run at once read the same rows of Pi
//    through L2.
//  * Norms: each A value of a stage reaches exactly one consumer thread's
//    fragment, so the consumers add up the squares of the exact loaded
//    float32 values in FMAs (each stage's into its own sum first), the
//    four threads of a column pair sum theirs with two shuffles, and the
//    CTA of row block 0 stores them.
//  * Edges: TMA zero-fills boxes past the d, k and n edges. TMA reads rows
//    from 16-byte aligned bases at pitches that are multiples of 16 bytes:
//    this entry reads Pi's rows at a pitch of d rounded up to 4 elements and
//    A's at n rounded up to 4. The Python wrapper (kernels/sketch_fused.py)
//    makes a zero-padded copy where the caller's tensors are not so, and
//    counts the copies.
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
//  * Edges: TMA zero-fills boxes past the d, k and n edges, as above; this
//    entry reads Pi's rows at a pitch of d rounded up to 8 elements and A's
//    at n rounded up to 8 (the wrapper copies where the caller's are not).
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
constexpr int BK = 64;    // rows of A (the streamed dimension d) per bf16 stage

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
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

// ---------------------------------------------------------------------------
// The float32 instance: the transposed product on TF32 wgmma, A's fragments
// from registers, Pi and its small part by TMA, clusters along n (see the
// header).

constexpr int F32_BK = 32;             // rows of d a stage: a 128-byte row
constexpr int F32_STAGES = 4;
constexpr int F32_CLUSTER_MAX = 1;     // CTAs a cluster along k, at most
constexpr int F32_CLUSTER_N = 2;       // CTAs a cluster along n, at most
constexpr int F32_CONSUMER_WARPS = 8;  // two warpgroups: the wgmma
constexpr int F32_PRODUCER_WARP = 8;   // its lane 0 issues the copies
constexpr int F32_THREADS = 32 * (F32_CONSUMER_WARPS + 1);  // 288
// stages whose wgmma go into one fresh accumulator before it is added to
// the float32 sum: chains of 256 rows of d
constexpr int F32_CHAIN_STAGES = 8;
constexpr int F32_BOX_COLS = 32;                          // 128 bytes
constexpr int F32_A_BOXES = BN / F32_BOX_COLS;            // 4
constexpr int F32_PI_BYTES = BM * F32_BK * 4;             // 16,384
constexpr int F32_BOX_BYTES = F32_BK * F32_BOX_COLS * 4;  // 4,096
constexpr int F32_A_BYTES = F32_A_BOXES * F32_BOX_BYTES;  // 16,384
// a stage: Pi's tile, its small part's, A's tile
constexpr int F32_STAGE_BYTES = 2 * F32_PI_BYTES + F32_A_BYTES;
// the float32 sums kept in shared memory: half the CTA's output tile, 32
// values a consumer thread
constexpr int F32_SUM_BYTES = BM * BN * 2;                // 32,768
// the ring (on a 1,024-byte boundary), the sums, the full and empty
// barriers
constexpr int F32_SMEM = 1024 + F32_STAGES * F32_STAGE_BYTES +
                         F32_SUM_BYTES + 2 * 8 * F32_STAGES;
static_assert(F32_BK * 4 == 128 && F32_BOX_COLS * 4 == 128,
              "a row of a tile is one 128-byte swizzle span");
static_assert(F32_SMEM <= 232448, "shared memory of one CTA");

struct F32Args {
  float* out;
  float* norm2;
  int k;
  int n;
  int64_t d;
  int ck;           // CTAs a cluster along k: row blocks that share A tiles
  int cn;           // and along n: column tiles that share Pi's tiles
  int cs;           // ck * cn, CTA c at (c % ck, c / ck)
  int row_groups;   // groups of ck row blocks: ceil(ceil(k / BM) / ck)
  int64_t units;    // row_groups * ceil(ceil(n / BN) / cn)
  int pairs;        // 1: out takes 8-byte stores of column pairs
};

// d = (accumulate ? d : 0) + a b: a the 64 x 8 A fragment in registers
// (float32 bit patterns, read as TF32), b 8 x 128 K-major in shared
// memory; float32 sums.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
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

// keeps the compiler from moving writes of v across this point, and v live
// up to it (a wgmma reads its A fragment asynchronously)
__device__ __forceinline__ void reg_fence(uint32_t (&v)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(v[i])::"memory");
}

// x - trunc(x), trunc the top 19 bits (what the tensor core reads of x):
// exact in float32
__device__ __forceinline__ float small_part(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// The prologue: small = Pi - trunc(Pi), n4 float4s.
__global__ void __launch_bounds__(256)
sketch_pi_small(const float4* __restrict__ pi, float4* __restrict__ small,
                int64_t n4) {
  for (int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x; i < n4;
       i += (int64_t)gridDim.x * 256) {
    const float4 x = pi[i];
    small[i] = make_float4(small_part(x.x), small_part(x.y), small_part(x.z),
                           small_part(x.w));
  }
}

__global__ void __launch_bounds__(F32_THREADS, 1)
sketch_fused_f32_kernel(const __grid_constant__ CUtensorMap pi_map,
                        const __grid_constant__ CUtensorMap small_map,
                        const __grid_constant__ CUtensorMap a_map,
                        const F32Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the swizzle repeats every 1,024 bytes: the ring starts on such a
  // boundary, at the same offset in every CTA of the cluster
  const uint32_t raw = smem_addr(smem_raw);
  unsigned char* const ring = smem_raw + (1024u - raw % 1024u) % 1024u;
  float* const sums = reinterpret_cast<float*>(
      ring + F32_STAGES * F32_STAGE_BYTES);
  uint64_t* const full = reinterpret_cast<uint64_t*>(
      ring + F32_STAGES * F32_STAGE_BYTES + F32_SUM_BYTES);
  uint64_t* const empty = full + F32_STAGES;
  const uint32_t ring_s = smem_addr(ring);

  const int tid = threadIdx.x;
  // a shuffle tells the compiler the role is uniform across the warp
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int lane = tid % 32;
  const int rank = (int)special_ctarank();
  const int64_t n_steps = (a.d + F32_BK - 1) / F32_BK;

  if (tid == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], F32_CONSUMER_WARPS * a.cs);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  cluster_sync();  // every CTA's barriers are set before a copy reaches them

  // unit u: row block (u % row_groups) * ck + rk of Pi, column tile
  // (u / row_groups) * cn + rn of A
  const int rk = rank % a.ck, rn = rank / a.ck;
  auto unit_k0 = [&](int64_t u) {
    return ((int)(u % a.row_groups) * a.ck + rk) * BM;
  };
  auto unit_n0 = [&](int64_t u) {
    return ((int)(u / a.row_groups) * a.cn + rn) * BN;
  };
  // the ring's position, as every reader of it keeps it
  int slot = 0;
  uint32_t phase = 0;
  auto advance = [&]() {
    if (++slot == F32_STAGES) {
      slot = 0;
      phase ^= 1u;
    }
  };

  if (warp == F32_PRODUCER_WARP) {
    // one thread keeps the ring full
    if (lane == 0) {
      // A's tile goes to the ck CTAs of this column tile, Pi's to the cn
      // CTAs of this row block; this CTA loads boxes rk, rk + ck, .. of A's
      // and rows rn * BM / cn.. of Pi's and its small part's
      uint16_t a_mask = 0, pi_mask = 0;
      for (int c = 0; c < a.cs; ++c) {
        if (c / a.ck == rn) a_mask |= (uint16_t)(1u << c);
        if (c % a.ck == rk) pi_mask |= (uint16_t)(1u << c);
      }
      const int pi_rows = BM / a.cn;
      for (int64_t u = special_clusterid(); u < a.units;
           u += special_nclusters()) {
        const int k0 = unit_k0(u), n0 = unit_n0(u);
        const bool active = k0 < a.k;
        for (int64_t step = 0; step < n_steps; ++step) {
          // every consumer warp of the cluster is done with the slot
          mbar_wait(&empty[slot], phase ^ 1u);
          // stage <- rows d0.. of this CTA's Pi tile and its small part's,
          // and this CTA's boxes of the cluster's A tile into every CTA
          const uint32_t stage = ring_s + slot * F32_STAGE_BYTES;
          const int d0 = (int)(step * F32_BK);
          mbar_expect(&full[slot],
                      (active ? 2 * F32_PI_BYTES : 0) + F32_A_BYTES);
          if (active) {
            const uint32_t rows = rn * pi_rows * 128;
            tma_multicast(&pi_map, &full[slot], stage + rows, d0,
                          k0 + rn * pi_rows, pi_mask);
            tma_multicast(&small_map, &full[slot],
                          stage + F32_PI_BYTES + rows, d0, k0 + rn * pi_rows,
                          pi_mask);
          }
          for (int b = rk; b < F32_A_BOXES; b += a.ck)
            tma_multicast(&a_map, &full[slot],
                          stage + 2 * F32_PI_BYTES + b * F32_BOX_BYTES,
                          n0 + b * F32_BOX_COLS, d0, a_mask);
          advance();
        }
      }
    }
    __syncwarp();
  } else {
    // the consumers: warpgroup wg owns columns 64 wg.. of the tile
    const int wg = warp / 4;
    const int g = lane / 4, t = lane % 4;
    // this thread's M rows g and g + 8 of its warp are columns col and
    // col + 1 of the tile: in box 2 wg + w / 2 (w the warp in the
    // warpgroup), floats 2 (g % 2) and 2 (g % 2) + 1 of 16-byte chunk
    // 2 (g / 2) + w % 2 of a box row
    const int box = 2 * wg + (warp % 4) / 2;
    const int chunk = 2 * (g / 2) + warp % 2;
    const int col = F32_BOX_COLS * box + 4 * chunk + 2 * (g % 2);
    const int a_off = 2 * F32_PI_BYTES + box * F32_BOX_BYTES + 8 * (g % 2);
    // this warp is done with slot s: release it in every CTA of the
    // cluster (lane c arrives in CTA c, a predicated arrive)
    const uint32_t target = lane < a.cs ? lane : 0;
    auto release = [&](int s) {
      __syncwarp();
      asm volatile(
          "{\n.reg .pred p;\n.reg .b32 remote;\n"
          "setp.lt.s32 p, %1, %2;\n"
          "mapa.shared::cluster.u32 remote, %0, %3;\n"
          "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n}"
          :: "r"(smem_addr(&empty[s])), "r"(lane), "r"(a.cs), "r"(target)
          : "memory");
    };
    // a stage's A fragments into f: k8 step j's big part (a0..a3, the raw
    // values) at f[8 j..], its small part at f[8 j + 4..]; a0 and a1 are
    // row 8 j + t of columns col and col + 1, a2 and a3 row 8 j + t + 4.
    // Adds the stage's squares, summed apart first, into the norm sums n0
    // and n1.
    auto load = [&](uint32_t (&f)[32], int s, float& n0, float& n1) {
      const unsigned char* at = ring + s * F32_STAGE_BYTES + a_off;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < F32_BK / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * j + t + 4 * h;  // r % 8 == t + 4 h
          const float2 v = *reinterpret_cast<const float2*>(
              at + r * 128 + ((chunk ^ (t + 4 * h)) << 4));
          f[8 * j + 2 * h] = __float_as_uint(v.x);
          f[8 * j + 2 * h + 1] = __float_as_uint(v.y);
          f[8 * j + 4 + 2 * h] = __float_as_uint(small_part(v.x));
          f[8 * j + 5 + 2 * h] = __float_as_uint(small_part(v.y));
          s0 = fmaf(v.x, v.x, s0);
          s1 = fmaf(v.y, v.y, s1);
        }
      }
      n0 += s0;
      n1 += s1;
    };
    // this thread's 64 float32 sums: values 0..31 in held, 32..63 at
    // sum[(i - 32) * 256] (its own: no barrier)
    float* const sum = sums + tid;
    float part[64], held[32];
    uint32_t f[32];  // a stage's fragments
    for (int64_t u = special_clusterid(); u < a.units;
         u += special_nclusters()) {
      const int k0 = unit_k0(u), n0 = unit_n0(u);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        held[i] = 0.f;
        sum[i * 256] = 0.f;
      }
      float nrm0 = 0.f, nrm1 = 0.f;
      // A stage at a time: its fragments, its 12 wgmma into part (fresh at
      // a chain's first stage), a wait for them, the stage released.
      // Chains of F32_CHAIN_STAGES stages; warpgroup 1's are offset from
      // warpgroup 0's by half a chain, so that one warpgroup's wgmma run
      // while the other adds.
      int left = wg ? F32_CHAIN_STAGES / 2 : F32_CHAIN_STAGES;
      bool fresh = true;
      for (int64_t step = 0; step < n_steps; ++step) {
        const int s = slot;
        mbar_wait(&full[s], phase);
        load(f, s, nrm0, nrm1);
        const uint32_t pi_big = ring_s + s * F32_STAGE_BYTES;
        const uint32_t pi_small = pi_big + F32_PI_BYTES;
        reg_fence(f);
        reg_fence(part);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < F32_BK / 8; ++j) {
          const uint32_t big[4] = {f[8 * j], f[8 * j + 1], f[8 * j + 2],
                                   f[8 * j + 3]};
          const uint32_t small[4] = {f[8 * j + 4], f[8 * j + 5],
                                     f[8 * j + 6], f[8 * j + 7]};
          wgmma_tf32_n128(part, small, sw128_desc(pi_big + 32 * j, 16, 1024),
                          j > 0 || !fresh);
          wgmma_tf32_n128(part, big, sw128_desc(pi_big + 32 * j, 16, 1024),
                          1);
          wgmma_tf32_n128(part, big, sw128_desc(pi_small + 32 * j, 16, 1024),
                          1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(f);
        reg_fence(part);
        release(s);
        advance();
        fresh = --left == 0 || step + 1 == n_steps;
        if (fresh) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            held[i] += part[i];
            sum[i * 256] += part[32 + i];
          }
          left = F32_CHAIN_STAGES;
        }
      }
      // the four threads of a column pair (t = 0..3) hold its rows t and
      // t + 4 of every k8 step
      nrm0 += __shfl_xor_sync(0xffffffffu, nrm0, 1);
      nrm1 += __shfl_xor_sync(0xffffffffu, nrm1, 1);
      nrm0 += __shfl_xor_sync(0xffffffffu, nrm0, 2);
      nrm1 += __shfl_xor_sync(0xffffffffu, nrm1, 2);
      const int c = n0 + col;
      if (k0 == 0 && t == 0) {
        if (c < a.n) a.norm2[c] = nrm0;
        if (c + 1 < a.n) a.norm2[c + 1] = nrm1;
      }
      // the accumulator's layout: value 4 j + 2 h + e holds M row g +
      // 8 h of the warp (column c + h) and N column 8 j + 2 t + e (row
      // k0 + 8 j + 2 t + e of the output)
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = k0 + 8 * j + 2 * t + e;
          if (row >= a.k) continue;
          float* dst = a.out + (int64_t)row * a.n + c;
          const int i0 = 4 * j + e, i1 = 4 * j + 2 + e;
          const float v0 = i0 < 32 ? held[i0] : sum[(i0 - 32) * 256];
          const float v1 = i1 < 32 ? held[i1] : sum[(i1 - 32) * 256];
          if (a.pairs && c + 1 < a.n) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (c < a.n) dst[0] = v0;
            if (c + 1 < a.n) dst[1] = v1;
          }
        }
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still arrive on it
}

// A float32 matrix of `rows` x `cols` whose rows lie `pitch` elements
// apart, in boxes of box_rows x box_cols, 128-byte swizzle, zeros past its
// edges.
bool encode_f32(CUtensorMap* map, const void* base, int64_t rows,
                int64_t cols, int64_t pitch, int box_rows, int box_cols) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pitch * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The prologue alone: small[i] = Pi[i] - trunc(Pi[i]) for `count` floats
// (a multiple of 4) from 16-byte aligned bases.
int launch_pi_small(const float* Pi, float* small, int64_t count,
                    cudaStream_t stream) {
  if ((uintptr_t)Pi % 16 || (uintptr_t)small % 16 || count % 4 || count < 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n4 = count / 4;
  if (n4 == 0) return (int)cudaSuccess;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t blocks = (n4 + 255) / 256;
  const int64_t grid = blocks < 8LL * sms ? blocks : 8LL * sms;
  sketch_pi_small<<<(unsigned)grid, 256, 0, stream>>>(
      reinterpret_cast<const float4*>(Pi), reinterpret_cast<float4*>(small),
      n4);
  return (int)cudaGetLastError();
}

// A launch config of one cluster of cs CTAs, and the clusters of that size
// the card holds at once (queried once a device and size).
cudaError_t f32_config(int cs, cudaStream_t stream,
                       cudaLaunchAttribute (&attr)[1],
                       cudaLaunchConfig_t& cfg, int& active) {
  cudaError_t err = cudaFuncSetAttribute(
      sketch_fused_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F32_SMEM);
  if (err != cudaSuccess) return err;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3((unsigned)cs);
  cfg.blockDim = dim3(F32_THREADS);
  cfg.dynamicSmemBytes = F32_SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static int held[64][F32_CLUSTER_MAX * F32_CLUSTER_N + 1] = {};
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && held[device][cs] > 0) {
    active = held[device][cs];
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveClusters(&active, sketch_fused_f32_kernel,
                                       &cfg);
  if (err == cudaSuccess && device < 64) held[device][cs] = active;
  return err;
}

// Pi's rows at a pitch of d rounded up to 4 elements, A's at n rounded up
// to 4, both from 16-byte aligned bases (TMA's rule; the wrapper copies
// where the caller's tensors are not so); small: the caller's scratch of
// Pi's size, which the prologue fills first.
int launch_f32(const float* Pi, const float* A, float* small, float* out,
               float* norm2, int64_t k, int64_t d, int64_t n,
               cudaStream_t stream) {
  if ((uintptr_t)Pi % 16 || (uintptr_t)A % 16 || (uintptr_t)small % 16 ||
      d >= (1LL << 31) || k >= (1LL << 31) || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int64_t pitch_d = (d + 3) / 4 * 4;
  cudaError_t err = (cudaError_t)launch_pi_small(Pi, small, k * pitch_d,
                                                 stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t k_blocks = (k + BM - 1) / BM;
  const int64_t n_tiles = (n + BN - 1) / BN;
  F32Args a;
  a.out = out;
  a.norm2 = norm2;
  a.k = (int)k;
  a.n = (int)n;
  a.d = d;
  a.ck = (int)(k_blocks < F32_CLUSTER_MAX ? k_blocks : F32_CLUSTER_MAX);
  a.cn = (int)(n_tiles < F32_CLUSTER_N ? n_tiles : F32_CLUSTER_N);
  a.cs = a.ck * a.cn;
  a.row_groups = (int)((k_blocks + a.ck - 1) / a.ck);
  a.units = (int64_t)a.row_groups * ((n_tiles + a.cn - 1) / a.cn);
  a.pairs = n % 2 == 0 && (uintptr_t)out % 8 == 0;
  CUtensorMap pi_map, small_map, a_map;
  if (!encode_f32(&pi_map, Pi, k, d, pitch_d, BM / a.cn, F32_BK) ||
      !encode_f32(&small_map, small, k, d, pitch_d, BM / a.cn, F32_BK) ||
      !encode_f32(&a_map, A, d, n, (n + 3) / 4 * 4, F32_BK, F32_BOX_COLS))
    return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  int active = 0;
  err = f32_config(a.cs, stream, attr, cfg, active);
  if (err != cudaSuccess) return (int)err;
  if (active < 1) return (int)cudaErrorInvalidConfiguration;
  // as many clusters as are resident at once, or fewer if there are fewer
  // units
  const int64_t clusters = a.units < active ? a.units : active;
  cfg.gridDim = dim3((unsigned)(clusters * a.cs));
  err = cudaLaunchKernelEx(&cfg, sketch_fused_f32_kernel, pi_map, small_map,
                           a_map, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes. Each returns the cudaError_t of the
// launch (0 on success); it neither synchronises nor allocates. The float32
// entry reads rows at pitches rounded up to 4 elements and writes Pi's small
// parts into the caller's scratch (launch_f32), the bf16 entry at pitches
// rounded up to 8 (launch_bf16).
extern "C" int sketch_fused_f32(const float* Pi, const float* A,
                                float* pi_small, float* out, float* norm2,
                                int64_t k, int64_t d, int64_t n,
                                void* stream) {
  return launch_f32(Pi, A, pi_small, out, norm2, k, d, n,
                    static_cast<cudaStream_t>(stream));
}

// The float32 entry's prologue alone: small = Pi - trunc(Pi) for `count`
// floats.
extern "C" int sketch_fused_pi_small(const float* Pi, float* small,
                                     int64_t count, void* stream) {
  return launch_pi_small(Pi, small, count, static_cast<cudaStream_t>(stream));
}

extern "C" int sketch_fused_bf16(const __nv_bfloat16* Pi,
                                 const __nv_bfloat16* A, float* out,
                                 float* norm2, int64_t k, int64_t d, int64_t n,
                                 void* stream) {
  return launch_bf16(Pi, A, out, norm2, k, d, n,
                     static_cast<cudaStream_t>(stream));
}

// The clusters of the instance for `dtype_bytes` (4: float32, 2: bf16) the
// card holds at once for k rows of Pi (a cluster of min(ceil(k / 128), 4)
// CTAs), or minus a cudaError_t.
extern "C" int sketch_fused_clusters(int64_t k, int dtype_bytes) {
  const int64_t k_blocks = (k + BM - 1) / BM;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  int active = 0;
  const int max = dtype_bytes == 2 ? BF16_CLUSTER_MAX : F32_CLUSTER_MAX;
  const int cs = (int)(k_blocks < max ? k_blocks : max) *
                 (dtype_bytes == 2 ? 1 : F32_CLUSTER_N);
  const cudaError_t err = dtype_bytes == 2
                              ? bf16_config(cs, 0, attr, cfg, active)
                              : f32_config(cs, 0, attr, cfg, active);
  return err == cudaSuccess ? active : -(int)err;
}
