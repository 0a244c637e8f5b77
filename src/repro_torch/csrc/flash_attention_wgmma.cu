// Flash attention in bf16 for Hopper (sm_90a): wgmma on the tensor cores,
// fed by TMA through a ring of shared-memory stages.
//   o = softmax(mask(softcap(scale · q kᵀ))) v
// with GQA (query head h reads KV head h / group), a causal mask offset by
// Skv − Sq, a sliding window, tanh soft-capping and the real kv length.
//
// Replaces: flash_attention_pallas / _flash_kernel in
//   src/repro/kernels/flash_attention/flash_attention.py (the TPU kernel),
// for bf16 inputs; fp32 stays on the CUDA-core kernel of flash_attention.cu.
// Plain version: repro_torch.kernels.flash_attention.ref.flash_attention_ref.
//
// Numerics, as the TPU kernel: scores accumulate in fp32 and are scaled in
// fp32 (q is not pre-scaled); running max, running sum and the output
// accumulator are fp32; masked scores are -1e30, not -inf; p is rounded to
// bf16 for P·V while the running sum takes p unrounded; the result
// acc / (l + 1e-30) is written in bf16.  log2(e) is folded into the scale
// so that p = exp2(x − m), which moves p by a rounding of the scale.  The
// softcap costs one SFU instruction: x · (scale / softcap), tanh.approx.f32,
// · (softcap · log2 e); the PTX ISA bounds tanh.approx's relative error by
// 2^-10.987 (an H100 measured 2^-16.46 at worst: tools/flash_ab.py).  The
// slim loop ((64, 64) and the large heads) keeps the running max in the
// units of the raw (or tanh) score and takes p = 2^(u·c − m·c) in one FMA
// and one ex2.approx.ftz: a rounding apart.
//
// What bounds it on an H100: operations, 2·B·Hq·(kept (q, k) pairs)·(dh + dv)
// FLOP at the bf16 tensor-core rate against a few hundred MB of q, k, v and o:
// qwen3-1.7b's causal prefill (B 4, Hq 16, S 4,096, dh 128) 0.28 ms,
// gemma2-2b's global and local layers (B 2, Hq 8, S 8,192, dh 256) 0.556 and
// 0.417 ms, deepseek-v2's MLA (B 1, Hq 128, S 2,048, dh 192, dv 128) 0.174,
// internvl2-1b's (B 4, Hq 14, S 4,096, dh 64) 0.122.  Only wgmma reaches
// that rate, so both products run on it, TMA doing every load.  At dh = dv
// = 64 a score costs 256 FLOP, and the SFU's ex2 (16 a clock an SM) takes as
// long as the products: there every instruction a score counts.
//
// Instances (DK, DV) = (Q·Kᵀ's depth, P·V's width), picked by the binding's
// wgmma_instance alone: (64, 64), (128, 128), (192, 128) for MLA's heads and
// (256, 256) for gemma2's; TMA zero-fills columns past dh or dv (Inst below).
//
// Design: a block covers 128 query rows of one (batch, query head); blocks
// walk the query tiles heaviest first.  Two consumer warpgroups each own 64
// query rows: S = Q·Kᵀ is wgmma m64nBNk16 with both operands in shared
// memory, the online softmax runs in registers on wgmma's accumulator layout
// (the four lanes of a quad share a row), p is packed to bf16 pairs that are
// directly wgmma's A fragments, and O += P·V is wgmma m64nDVk16 with A from
// registers and V (keys × dv, dv contiguous) read transposed from shared
// memory.  The tensor cores are kept busy two ways: each consumer issues
// Q·Kᵀ of tile j and P·V of tile j − 1 together and runs tile j's softmax
// while P·V runs, and the two consumers take turns issuing (named
// barriers), so one's softmax overlaps the other's products.  One thread
// TMA-loads the q tiles once, then K and V tiles into a ring of stages, each
// guarded by a full barrier for K, one for V and empty barriers that both
// consumers release.  (128, 128): 64-key tiles, 3 stages, a producer
// warpgroup handing registers to the consumers (setmaxnreg 40/232), K and V
// released together after P·V (128-key tiles or a producer warp spilled or
// gained nothing: PERF.md).
// (64, 64): the slim loop below, 128-key tiles (S 64 + P 32 + O 32
//   registers in the producer warpgroup's budget of 168, no spill), 2 stages,
//   40/232: half the tiles of 64 keys, so half the per-tile waits, barrier
//   turns, quad shuffles and rescales of O (internvl2 −20%, whisper's encoder
//   −15% against 64-key tiles on the slim loop).  Tried and dropped, in
//   copies of this file (PERF.md): two blocks an SM, loading for themselves
//   (256 threads, 125 registers: +21% over the slim loop's 64-key tiles) or
//   with a producer at (384, 2) (80 registers: spilled and serialised,
//   4×); three consumers (192 query rows: 64-key tiles +10% at internvl2,
//   +37% at whisper's cross attention; 128-key tiles spill and serialise at
//   128 registers); 96-key tiles; 3 stages; a head-major grid; splitting
//   the keys of launches whose queries fit one block into spans merged by a
//   second kernel (whisper's cross attention +48–75%: at one block an SM
//   the spans run in more waves, and the merge reads every span's fp32 O).
// The large heads.  ptxas plans the wgmma pipeline within the register
// budget of the launch bound, not within the consumers' setmaxnreg count: at
// 384 threads, 168 registers.  Where the accumulators and fragments in
// flight pass about 150 of them it serialises every wgmma (C7512,
// "insufficient register resources"), as it did for the D 256 instance that
// (256, 256) replaces (O 128 + S 32 + P 16: 392 B of spills in its consumer
// loop, every wgmma waited on).  So:
// (192, 128) fits (O 64 + S 32 + P 16): the producer warpgroup (24/240),
//   64-key tiles, 4 stages (40 KB each beside a 48 KB q), and a head-major
//   grid: a head's 16 query tiles run side by side, so its K/V comes from
//   HBM once (query-major, 128 heads × 1.25 MB passed through L2 again for
//   every query tile: 0.54 ms, not 0.40).
// (256, 256) cannot: O alone is 128 registers.  Its block is the two
//   consumer warpgroups (256 threads, a budget of 255) and they issue their
//   own loads: one thread issues q, then each K and V tile as soon as its
//   stage is free, waiting only for the tile its consumer needs next.
//   80-key tiles (O 128 + S 40 + P 20: 255 registers, no spill), 2 stages
//   (q 64 KB + 2 × 80 KB); query-major (a head's 8 MB of K/V stays in L2
//   either way, and heads side by side balance the causal load better).
// Both: K is released as soon as Q·Kᵀ has read it, not with V after P·V
//   (K runs a tile ahead of V in the ring, in one order, `load`, whether
//   the producer or a consumer thread issues it); S's first k-step writes S
//   without reading it; the softcap is decided once per launch (a consumer
//   loop compiled for each case: a per-tile branch cost 16–20%).
// Tried and dropped (tools/flash_ab.py --dtype bf16, PERF.md): setmaxnreg
// 40/232 against 24/240, a producer warp (288 threads: ptxas still budgets
// 168), 64-key tiles at (256, 256) with the producer warpgroup (serialised),
// (192, 128) without one, loading for itself (256 threads: 1.7× slower),
// 96- and 128-key tiles at (192, 128), skipping O's rescale in a warp whose
// rows kept their max, masking every tile, consumers not taking turns.
// Layout: every tile is a set of boxes of 64 bf16 columns (128 bytes, the
// widest box that CU_TENSOR_MAP_SWIZZLE_128B allows), 64 rows for q and BN
// for k and v: a D-128 row is two boxes, a D-256 row four.  The wgmma
// descriptors use the same 128-byte swizzle: K-major (q, k) with 1,024
// bytes between 8-row groups, stepping 32 bytes per k16 inside a box;
// MN-major (v) with a box (BN × 128 bytes) between boxes.  TMA zero-fills
// rows past Sq or Skv and columns past dh or dv; keys past Skv are still
// masked to -1e30 explicitly.  Key tiles masked for every row of the block
// (above the causal diagonal, behind the window) are not visited; partly
// masked tiles are masked per element in registers.
//
// Inputs are read through their batch, head and row strides (one tensor
// map each): the wrapper guarantees a 16-byte aligned base, strides and
// head dims that are multiples of 8 elements (it copies an input that
// breaks that into a padded one first); o [B,Hq,Sq,dv] is contiguous.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kRows = 64;                   // query rows per consumer warpgroup (wgmma's M)
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kBQ = kRows * kConsumers;     // query rows per block
constexpr int kChunk = 64;                  // bf16 columns per 128-byte box
constexpr uint32_t kRowBytes = 128;         // one row of a box
constexpr float kNeg = -1e30f;

// How an instance is laid out and run: keys per tile, K/V stages in the
// ring, the producer's and the consumers' registers (setmaxnreg; producer
// registers 0: no producer warpgroup, the consumers issue the loads
// themselves in a block of two warpgroups, every thread keeping the
// registers it launched with, which is the budget ptxas plans the wgmma
// pipeline in); whether the consumer loop is the slim one (K
// released as soon as Q·Kᵀ has read it, not with V after P·V, and loaded a
// tile ahead of V by the kernel's `load`; an S tile's first k-step writing S
// without reading it; the softcap decided once per launch, a loop compiled
// for each case; the scale folded into the exponent's FMA, one
// ex2.approx.ftz a score); whether the grid runs one head's query tiles next
// to each other (so that the blocks reading one K/V head are on the card
// together), else the heads of one query tile.
template <int Keys, int Stages, int ProducerRegs, int ConsumerRegs, bool SlimLoop, bool HeadMajor>
struct Layout {
  static constexpr int kKeys = Keys, kStages = Stages, kProducerRegs = ProducerRegs, kConsumerRegs = ConsumerRegs;
  static constexpr bool kSlimLoop = SlimLoop, kOwnLoads = ProducerRegs == 0, kHeadMajor = HeadMajor;
  static constexpr int kThreads = 128 * (kConsumers + (kOwnLoads ? 0 : 1));
};

// The instances, by (DK, DV): the depth of Q·Kᵀ (q and k's head dim) and the
// width of P·V (v's); a head dim below an instance's is zero-filled by TMA.
template <int DK, int DV> struct Inst;
template <> struct Inst<64, 64> : Layout<128, 2, 40, 232, true, false> {};
template <> struct Inst<128, 128> : Layout<64, 3, 40, 232, false, false> {};
template <> struct Inst<192, 128> : Layout<64, 4, 24, 240, true, true> {};
template <> struct Inst<256, 256> : Layout<80, 2, 0, 0, true, false> {};

// the softcap as a consumer loop knows it: read per tile, or fixed off or on
constexpr int kCapRuntime = 0, kCapOff = 1, kCapOn = 2;
template <int C>
struct Cap {
  static constexpr int value = C;
};

template <int DK, int DV>
constexpr int smem_bytes() {  // 1,024 for alignment, q, the K and V rings, barriers
  using I = Inst<DK, DV>;
  return 1024 + 2 * (kConsumers * kRows * DK + I::kStages * I::kKeys * (DK + DV)) +
         8 * (1 + (I::kSlimLoop ? 4 : 3) * I::kStages);
}

struct Params {
  int group, sq, skv, dv, hq, causal, window;  // window 0 → none
  float scale_log2;                            // scale · log2(e)
  float cap_in, cap_out;                       // scale / softcap and softcap · log2(e); cap_out 0 → no softcap
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A ring that is out of
// step would spin forever; after ~2^34 cycles (seconds) the kernel traps
// instead, so the fault surfaces as a CUDA error rather than a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (t0 == 0) t0 = now;
    else if (now - t0 > (1ll << 34)) __trap();
  }
}

// whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// one 64 × 64 box of a 4-d [B, H, S, d] tensor map at (column, row, head, batch)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c, int r,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(r), "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (in 16-byte units), layout type 1 (B128)
__device__ __forceinline__ uint64_t sdesc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Named barriers 1 and 2 order the two consumer warpgroups' turns on the
// tensor cores (bar.sync by the one whose turn it is, bar.arrive by the other).
__device__ __forceinline__ void turn_wait(int wg) { asm volatile("bar.sync %0, 256;\n" ::"r"(wg) : "memory"); }
__device__ __forceinline__ void turn_pass(int wg) { asm volatile("bar.arrive %0, 256;\n" ::"r"(wg) : "memory"); }

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// Ties an accumulator to the point after wgmma_wait: the asm above
// reports its outputs when issued, the hardware writes them later.
template <int N>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64×N, fp32) (+)= A(64×16, bf16) · B(16×N, bf16).  ss: A and B K-major in
// shared memory (scale_d 0 overwrites D); rs: A from registers (four bf16
// pairs per thread), B MN-major ("transposed") in shared memory, D accumulated.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale_d);
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db);
// ss with D written, not read (scale_d 0): the first k-step of a fresh S tile
template <int N>
__device__ __forceinline__ void wgmma_ss_fresh(float* d, uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<80>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float* d, uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_fresh<64>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss_fresh<80>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "%40, %41, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39])
      : "l"(da), "l"(db), "r"(0));
}

template <>
__device__ __forceinline__ void wgmma_ss_fresh<128>(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 rows × BN keys) = Q·Kᵀ for a q tile at qa and a K tile at kt, issued
template <int DK, int BN, bool Fresh>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < DK / 16; ++kk) {  // 16 columns of dh: box kk / 4, 32 bytes each inside it
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = sdesc(qa + (kk / 4) * kRows * kRowBytes + col, 16, 1024);
    const uint64_t db = sdesc(kt + (kk / 4) * BN * kRowBytes + col, 16, 1024);
    if (Fresh && kk == 0) wgmma_ss_fresh<BN>(sc, da, db);
    else wgmma_ss<BN>(sc, da, db, kk > 0);
  }
}

// O += P·V for a V tile at vt (BN keys × dv, dv contiguous, so read transposed), issued
template <int DV, int BN>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* pa, uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)  // 16 keys: 16 rows of 128 bytes
    wgmma_rs<DV>(o, pa + 4 * kk, sdesc(vt + kk * 16 * kRowBytes, BN * kRowBytes, 1024));
}

// tanh in one SFU instruction (PTX ISA: relative error at most 2^-10.987)
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one score tile in wgmma's accumulator layout: this
// thread holds keys k0 + 8j + 2(lane%4) + {0,1} of rows a (sc[4j], sc[4j+1])
// and b (sc[4j+2], sc[4j+3]), at query positions qpos_a and qpos_a + 8.  The
// scores become p = exp2(x − m) (fp32, unrounded); m and this thread's part
// of l move on, and corr is the factor by which O has to shrink.  A capped
// score is softcap · tanh(x · scale / softcap) · log2(e): a multiply, a tanh,
// a multiply.
template <int NS>
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l, float* corr, const Params& p, int k0,
                                             int qpos_a, int lane, bool whole) {
  if (p.cap_out > 0.f) {
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = p.cap_out * tanh_approx(sc[i] * p.cap_in);
  } else {
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] *= p.scale_log2;
  }
  if (!whole) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
      const int qpos = qpos_a + 8 * ((i / 2) & 1);
      bool ok = kpos < p.skv;  // TMA zero-filled the keys past Skv: they score 0, not -1e30
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && qpos - kpos < p.window;
      if (!ok) sc[i] = kNeg;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four lanes of a quad hold one row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    sc[i] = exp2f(sc[i] - m[(i / 2) & 1]);
    rs[(i / 2) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];  // quad-reduced once, at the end
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// softmax_tile in fewer instructions a score: the running max is kept in the
// units of the raw score (or, capped, of tanh(x · scale / softcap)), and the
// factor c to log2 units (scale · log2 e, or softcap · log2 e) goes into the
// exponent's FMA, p = 2^(u·c − m·c), one ex2.approx.ftz a score.  A row
// masked in every key so far gets p = 0 here (the TPU kernel's p = 1 is
// wiped by the next correction all the same).
template <int NS, bool Capped>
__device__ __forceinline__ void softmax_tile_slim(float* sc, float* m, float* l, float* corr, const Params& p,
                                                  int k0, int qpos_a, int lane, bool whole) {
  const float c = Capped ? p.cap_out : p.scale_log2;
  if (Capped) {
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = tanh_approx(sc[i] * p.cap_in);
  }
  if (!whole) {
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + (i & 1);
      const int qpos = qpos_a + 8 * ((i / 2) & 1);
      bool ok = kpos < p.skv;  // TMA zero-filled the keys past Skv: they score 0, not -1e30
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && qpos - kpos < p.window;
      if (!ok) sc[i] = kNeg;
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < NS; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
  float mc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four lanes of a quad hold one row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = exp2_approx((m[r] - mx[r]) * c);
    m[r] = mx[r];
    // a row masked so far: p = 0 (2^(-1e30 c)); m·c would leave the FMA a
    // rounding residual of ~1e24, and 2^(±1e24) is 0 or inf
    mc[r] = mx[r] == kNeg ? 0.f : mx[r] * c;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    sc[i] = exp2_approx(fmaf(sc[i], c, -mc[(i / 2) & 1]));
    rs[(i / 2) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];  // quad-reduced once, at the end
}

template <int NS, int C>
__device__ __forceinline__ void softmax(float* sc, float* m, float* l, float* corr, const Params& p, int k0,
                                        int qpos_a, int lane, bool whole) {
  if constexpr (C == kCapRuntime) softmax_tile<NS>(sc, m, l, corr, p, k0, qpos_a, lane, whole);
  else softmax_tile_slim<NS, C == kCapOn>(sc, m, l, corr, p, k0, qpos_a, lane, whole);
}

// p in bf16 pairs: pa[4kk..4kk+3] is wgmma's A fragment of keys 16kk..16kk+15
template <int NS>
__device__ __forceinline__ void pack_p(const float* sc, uint32_t* pa) {
#pragma unroll
  for (int j = 0; j < NS / 4; ++j) {
    pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R) : "memory"); }
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R) : "memory"); }

template <int DK, int DV>
__global__ void __launch_bounds__(Inst<DK, DV>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, const Params p) {
  using I = Inst<DK, DV>;
  constexpr int BN = I::kKeys, S = I::kStages, NS = BN / 2;  // keys a tile; scores a thread holds
  constexpr int NCK = DK / kChunk, NCV = DV / kChunk;         // boxes per row of q or k, of v
  static_assert(S >= 2, "the consumers hold a tile's stage while they wait for the next one");
  static_assert(BN % 16 == 0 && DK % kChunk == 0 && DV % kChunk == 0, "tiles are whole k16 steps and boxes");
  constexpr uint32_t QBOX = kRows * kRowBytes, KBOX = BN * kRowBytes;  // bytes of one box of q, of k or v
  constexpr uint32_t QTILE = QBOX * NCK, KTILE = KBOX * NCK, VTILE = KBOX * NCV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats every 1,024 bytes
  const uint32_t sQ = base;                      // [kConsumers][NCK][64 rows][128 B]
  const uint32_t sK = sQ + kConsumers * QTILE;  // [S][NCK][BN keys][128 B]
  const uint32_t sV = sK + S * KTILE;           // [S][NCV][BN keys][128 B]
  const uint32_t bar_q = sV + S * VTILE;        // then full K [S], full V [S], empty [S] (K's, if slim), V's [S]
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * S, bar_e = bar_v + 8 * S;
  const uint32_t bar_ev = I::kSlimLoop ? bar_e + 8 * S : bar_e;  // where a stage's V is released

  // heaviest query tiles first under causality (of each head, if head-major)
  const int qt = I::kHeadMajor ? gridDim.x - 1 - blockIdx.x : gridDim.y - 1 - blockIdx.y;
  const int bh = I::kHeadMajor ? blockIdx.y : blockIdx.x;
  const int h = bh % p.hq, b = bh / p.hq, hk = h / p.group;
  const int q0 = qt * kBQ;
  const int off = p.skv - p.sq;
  // keys that some row of this block can see
  const int k_hi = p.causal ? min(p.skv, min(q0 + kBQ, p.sq) + off) : p.skv;
  const int k_lo = p.window > 0 ? max(0, q0 + off - p.window + 1) / BN * BN : 0;
  const int ntiles = (k_hi - k_lo + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumers * 128);
      if (I::kSlimLoop) mbar_init(bar_ev + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // The slim loop's K and V loads, in one order whoever issues them: K tile
  // it, then V tile it − 1 (Q·Kᵀ of tile it is issued with P·V of tile
  // it − 1), one thread issuing them: the producer's, waiting for each
  // stage, or (no producer) consumer 0's, the loader, which issues each
  // load whose stage is free and waits only for the tiles its consumer is
  // about to wait for: `load(need_k, need_v)` waits for the K tiles below
  // need_k and the V tiles below need_v.  Consumers call it only where they
  // load (kOwnLoads, a constant), or ptxas keeps it in every consumer's loop.
  const bool loader = I::kOwnLoads && threadIdx.x == 0;
  int nk = 0, nv = 0;  // the next K and V tiles to load
  auto load = [&](int need_k, int need_v) {
    for (;;) {
      if (nk < ntiles && nk <= nv + 1) {
        const int s = nk % S;
        const uint32_t par = ((nk / S) & 1) ^ 1;
        if (nk >= need_k && !mbar_test(bar_e + 8 * s, par)) return;
        mbar_wait(bar_e + 8 * s, par);
        mbar_expect_tx(bar_k + 8 * s, KTILE);
        for (int c = 0; c < NCK; ++c)
          tma_load(sK + s * KTILE + c * KBOX, &tk, bar_k + 8 * s, c * kChunk, k_lo + nk * BN, hk, b);
        ++nk;
      } else if (nv < nk) {  // V a tile behind K, the last one after K's last
        const int s = nv % S;
        const uint32_t par = ((nv / S) & 1) ^ 1;
        if (nv >= need_v && !mbar_test(bar_ev + 8 * s, par)) return;
        mbar_wait(bar_ev + 8 * s, par);
        mbar_expect_tx(bar_v + 8 * s, VTILE);
        for (int c = 0; c < NCV; ++c)
          tma_load(sV + s * VTILE + c * KBOX, &tv, bar_v + 8 * s, c * kChunk, k_lo + nv * BN, hk, b);
        ++nv;
      } else {
        return;
      }
    }
  };
  if (!I::kOwnLoads && wg == 0) {  // producer
    setmaxnreg_dec<I::kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kConsumers * QTILE);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < NCK; ++c)
          tma_load(sQ + w * QTILE + c * QBOX, &tq, bar_q, c * kChunk, q0 + w * kRows, h, b);
      if constexpr (I::kSlimLoop) {
        load(ntiles, ntiles);  // every tile, waiting for each stage
      } else {
        for (int it = 0; it < ntiles; ++it) {
          const int s = it % S, k0 = k_lo + it * BN;
          mbar_wait(bar_e + 8 * s, ((it / S) & 1) ^ 1);  // the first round finds every stage free
          mbar_expect_tx(bar_k + 8 * s, KTILE);
          for (int c = 0; c < NCK; ++c)
            tma_load(sK + s * KTILE + c * KBOX, &tk, bar_k + 8 * s, c * kChunk, k0, hk, b);
          mbar_expect_tx(bar_v + 8 * s, VTILE);
          for (int c = 0; c < NCV; ++c)
            tma_load(sV + s * VTILE + c * KBOX, &tv, bar_v + 8 * s, c * kChunk, k0, hk, b);
        }
      }
    }
  } else {  // consumers
    if constexpr (!I::kOwnLoads) setmaxnreg_inc<I::kConsumerRegs>();
    const int w = I::kOwnLoads ? wg : wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = q0 + w * kRows;  // this warpgroup's first query row
    // this thread's rows are qpos_a and qpos_a + 8 (query positions on the key axis)
    const int qpos_a = r0 + warp * 16 + lane / 4 + off;
    const int qlo = r0 + off, qhi = min(r0 + kRows, p.sq) - 1 + off;
    const uint32_t qa = sQ + w * QTILE;
    const int me = w + 1, other = 2 - w;  // named barriers 1 and 2

    if (loader) {
      mbar_expect_tx(bar_q, kConsumers * QTILE);
      for (int c2 = 0; c2 < kConsumers; ++c2)
        for (int c = 0; c < NCK; ++c)
          tma_load(sQ + c2 * QTILE + c * QBOX, &tq, bar_q, c * kChunk, q0 + c2 * kRows, h, b);
    }

    auto consume = [&](auto cap) {
      constexpr int C = decltype(cap)::value;
      float o[DV / 2];  // wgmma accumulator: columns 8n + 2(lane%4) + {0,1}, rows a (4n, 4n+1), b (4n+2, 4n+3)
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
      float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's part of the row sum

      // Both consumers walk all the block's key tiles, so that they take turns
      // on the tensor cores in step: while one runs its softmax, the other's
      // products run.  A tile masked for every row of a consumer gives p = 0
      // once the row has a real maximum, and is wiped by the correction when
      // it comes before one.
      auto whole = [&](int it) {  // no key of the tile is masked for any row of this warpgroup
        const int k0 = k_lo + it * BN;
        return k0 + BN <= p.skv && (!p.causal || k0 + BN - 1 <= qlo) && (p.window == 0 || qhi - k0 < p.window);
    };
    if (w == 1) turn_pass(other);  // consumer 0 goes first
    mbar_wait(bar_q, 0);
    {
      // Software pipeline: the softmax of tile it runs while the tensor
      // cores do P·V of tile it − 1.
      float sc[NS], corr[2];  // S tile, same layout as o with BN columns
      uint32_t pa[NS / 2];
      int s = 0;
      if (loader) load(1, 0);
      mbar_wait(bar_k, 0);
      turn_wait(me);
      wgmma_fence();
      issue_qk<DK, BN, I::kSlimLoop>(sc, qa, sK);
      wgmma_commit();
      turn_pass(other);
      wgmma_wait<0>();
      reg_fence<NS>(sc);
      if (I::kSlimLoop) mbar_arrive(bar_e);  // tile 0's K is read
      softmax<NS, C>(sc, m, l, corr, p, k_lo, qpos_a, lane, whole(0));  // o is 0: no rescale
      pack_p<NS>(sc, pa);
      for (int it = 1; it < ntiles; ++it) {
        const int sp = (it - 1) % S;
        s = it % S;
        if (loader) load(it + 1, it);
        mbar_wait(bar_k + 8 * s, (it / S) & 1);
        mbar_wait(bar_v + 8 * sp, ((it - 1) / S) & 1);
        turn_wait(me);
        wgmma_fence();
        issue_qk<DK, BN, I::kSlimLoop>(sc, qa, sK + s * KTILE);
        wgmma_commit();
        issue_pv<DV, BN>(o, pa, sV + sp * VTILE);
        wgmma_commit();
        turn_pass(other);
        wgmma_wait<1>();  // S of tile it is in; P·V of tile it − 1 runs on
        reg_fence<NS>(sc);
        if (I::kSlimLoop) mbar_arrive(bar_e + 8 * s);  // tile it's K is read
        softmax<NS, C>(sc, m, l, corr, p, k_lo + it * BN, qpos_a, lane, whole(it));
        if (loader) load(0, 0);
        wgmma_wait<0>();
        reg_fence<DV / 2>(o);
        mbar_arrive(bar_ev + 8 * sp);
#pragma unroll
        for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i / 2) & 1];
        pack_p<NS>(sc, pa);
      }
      s = (ntiles - 1) % S;
      if (loader) load(ntiles, ntiles);
      mbar_wait(bar_v + 8 * s, ((ntiles - 1) / S) & 1);
      turn_wait(me);
      wgmma_fence();
      issue_pv<DV, BN>(o, pa, sV + s * VTILE);
      wgmma_commit();
      if (w == 0) turn_pass(other);  // every bar.sync meets exactly one bar.arrive
      wgmma_wait<0>();
      reg_fence<DV / 2>(o);
      mbar_arrive(bar_ev + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row_a = r0 + warp * 16 + lane / 4;
    __nv_bfloat16* og = out + (static_cast<long long>(b) * p.hq + h) * p.sq * p.dv;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n) {
      const int col = 8 * n + 2 * (lane % 4);  // dv is a multiple of 8, so col + 1 < dv too
      if (col >= p.dv) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row_a + 8 * r;
        if (row >= p.sq) continue;
        const float den = l[r] + 1e-30f;
        *reinterpret_cast<__nv_bfloat162*>(og + static_cast<long long>(row) * p.dv + col) =
            __floats2bfloat162_rn(o[4 * n + 2 * r] / den, o[4 * n + 2 * r + 1] / den);
      }
    }
    };
    if (!I::kSlimLoop) consume(Cap<kCapRuntime>{});
    else if (p.cap_out > 0.f) consume(Cap<kCapOn>{});
    else consume(Cap<kCapOff>{});
  }
}

// cuTensorMapEncodeTiled is a driver-API call: fetched through the runtime,
// so the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// One input as the kernel reads it: a [B, H, S, d] bf16 tensor with element
// strides (sb, sh, ss, 1)
struct View {
  const void* ptr;
  int H, S, d;
  long long sb, sh, ss;
};

// 4-d map of a view in boxes of `rows` rows × 64 columns, 128-byte swizzle,
// zero fill out of bounds
bool make_map(CUtensorMap* map, const View& x, int B, int rows) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)x.d, (cuuint64_t)x.S, (cuuint64_t)x.H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)x.ss * 2, (cuuint64_t)x.sh * 2, (cuuint64_t)x.sb * 2};
  const cuuint32_t box[4] = {kChunk, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x.ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the kernel's shared memory opted in: above 48 KB a launch needs it
template <int DK, int DV>
cudaError_t opt_in() {
  return cudaFuncSetAttribute(flash_wgmma_kernel<DK, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes<DK, DV>());
}

template <int DK, int DV>
int launch(const View& q, const View& k, const View& v, void* out, int B, const Params& p, void* stream) {
  constexpr int smem = smem_bytes<DK, DV>();
  static_assert(smem <= 232448, "an instance must fit in a block's 227 KB of shared memory");
  if (q.d > DK || v.d > DV) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, kRows) || !make_map(&tk, k, B, Inst<DK, DV>::kKeys) ||
      !make_map(&tv, v, B, Inst<DK, DV>::kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = opt_in<DK, DV>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nq = (p.sq + kBQ - 1) / kBQ;
  const dim3 grid = Inst<DK, DV>::kHeadMajor ? dim3(nq, B * p.hq) : dim3(B * p.hq, nq);
  flash_wgmma_kernel<DK, DV><<<grid, Inst<DK, DV>::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

template <int DK, int DV>
int blocks_per_sm() {
  int n = 0;
  cudaError_t e = opt_in<DK, DV>();
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_wgmma_kernel<DK, DV>, Inst<DK, DV>::kThreads,
                                                      smem_bytes<DK, DV>());
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

bool aligned8(long long x) { return x % 8 == 0; }

}  // namespace

// (inst_dk, inst_dv) names the instance (the binding's wgmma_instance); a
// pair without one, or head dims above it, is refused.
extern "C" int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                                          int Hkv, int Sq, int Skv, int dh, int dv, int inst_dk, int inst_dv,
                                          long long qsb, long long qsh, long long qss, long long ksb, long long ksh,
                                          long long kss, long long vsb, long long vsh, long long vss,
                                          double scale, int causal, int window, double softcap, void* stream) {
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 || dh < 1 || dv < 1 || window < 0 || softcap < 0.0)
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA: 16-byte aligned bases, strides and rows (the wrapper pads what is not)
  for (const void* ptr : {q, k, v})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (long long x : {(long long)dh, (long long)dv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss})
    if (!aligned8(x)) return static_cast<int>(cudaErrorInvalidValue);
  const View vq{q, Hq, Sq, dh, qsb, qsh, qss}, vk{k, Hkv, Skv, dh, ksb, ksh, kss}, vv{v, Hkv, Skv, dv, vsb, vsh, vss};
  const Params p{Hq / Hkv, Sq, Skv, dv, Hq, causal, window, static_cast<float>(scale * 1.4426950408889634),
                 softcap > 0.0 ? static_cast<float>(scale / softcap) : 0.f,
                 static_cast<float>(softcap * 1.4426950408889634)};
  if (inst_dk == 64 && inst_dv == 64) return launch<64, 64>(vq, vk, vv, out, B, p, stream);
  if (inst_dk == 128 && inst_dv == 128) return launch<128, 128>(vq, vk, vv, out, B, p, stream);
  if (inst_dk == 192 && inst_dv == 128) return launch<192, 128>(vq, vk, vv, out, B, p, stream);
  if (inst_dk == 256 && inst_dv == 256) return launch<256, 256>(vq, vk, vv, out, B, p, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Blocks of the instance (inst_dk, inst_dv) that fit on one SM at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor); a CUDA error negated.
extern "C" int flash_attention_wgmma_blocks_per_sm_bf16(int inst_dk, int inst_dv) {
  if (inst_dk == 64 && inst_dv == 64) return blocks_per_sm<64, 64>();
  if (inst_dk == 128 && inst_dv == 128) return blocks_per_sm<128, 128>();
  if (inst_dk == 192 && inst_dv == 128) return blocks_per_sm<192, 128>();
  if (inst_dk == 256 && inst_dv == 256) return blocks_per_sm<256, 256>();
  return -static_cast<int>(cudaErrorInvalidValue);
}
