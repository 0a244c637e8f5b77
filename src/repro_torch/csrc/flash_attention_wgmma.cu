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
// so that p = exp2(x − m), which moves p by a rounding of the scale.
//
// What bounds it on an H100: operations.  Causal prefill at B 4, Hq 16,
// S 4,096, dh 128 is 2.75e11 FLOP against ~0.2 GB of q, k, v and o, so the
// bound is the bf16 tensor-core rate (0.28 ms).  Only wgmma reaches that
// rate, so both products run on it, with TMA doing every load.
//
// Design: a block of three warpgroups covers 128 query rows of one (batch,
// query head); blocks walk the query tiles heaviest first.  Warpgroup 0 is
// the producer: one thread TMA-loads the block's q tile once, then K and V
// tiles of 64 keys into a ring of shared-memory stages (3, or 2 at D 256),
// each stage guarded by a full barrier for K, one for V and an empty barrier
// that both consumers release.  Warpgroups 1 and 2 each own 64 query rows:
// S = Q·Kᵀ is wgmma m64n64k16 with both operands in shared memory, the
// online softmax runs in registers on wgmma's accumulator layout (the four
// lanes of a quad share a row), p is packed to bf16 pairs that are directly
// wgmma's A fragments, and O += P·V is wgmma m64nDk16 with A from registers
// and V (keys × dv, dv contiguous) read transposed from shared memory.
// The tensor cores are kept busy two ways: each consumer issues Q·Kᵀ of
// tile j and P·V of tile j − 1 together and runs tile j's softmax while
// P·V runs, and the two consumers take turns issuing (named barriers), so
// one's softmax overlaps the other's products.  setmaxnreg moves registers
// from the producer to the consumers.  128-key tiles, or a producer warp
// in place of the warpgroup, spilled or gained nothing (PERF.md).
// Layout: every tile is a set of 64-row boxes of 64 bf16 columns (128 bytes,
// the widest box that CU_TENSOR_MAP_SWIZZLE_128B allows): a D-128 row is two
// boxes, a D-256 row four.  The wgmma descriptors use the same 128-byte
// swizzle: K-major (q, k) with 1,024 bytes between 8-row groups, stepping 32
// bytes per k16 inside a box; MN-major (v) with 8,192 bytes between boxes.
// TMA zero-fills rows past Sq or Skv and columns past dh or dv; keys past
// Skv are still masked to -1e30 explicitly.  Key tiles masked for every row
// of the block (above the causal diagonal, behind the window) are not
// visited; partly masked tiles are masked per element in registers.
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
constexpr int kKeys = 64;                   // keys per tile
constexpr int kConsumers = 2;               // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBQ = kRows * kConsumers;     // query rows per block
constexpr int kChunk = 64;                  // bf16 columns per 128-byte box
constexpr uint32_t kBoxBytes = 64 * 128;    // one box: 64 rows of 128 bytes
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// K/V tiles in flight: three, or two at D 256, where three do not fit
template <int D> __host__ __device__ constexpr int stages() { return D == 256 ? 2 : 3; }

template <int D>
constexpr int smem_bytes() {  // 1,024 for alignment, q, the K and V rings, barriers
  return 1024 + kBoxBytes * (D / kChunk) * (kConsumers + 2 * stages<D>()) + 8 * (1 + 3 * stages<D>());
}

struct Params {
  int group, sq, skv, dv, hq, causal, window;  // window 0 → none
  float scale_log2, scale, softcap;            // softcap 0 → none
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
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int scale_d) {
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

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
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

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
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

__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db) {
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

template <int D>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a, uint64_t db) {
  if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (D == 128) wgmma_rs_n128(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (64 rows × 64 keys) = Q·Kᵀ for a q tile at qa and a K tile at kt, issued
template <int D>
__device__ __forceinline__ void issue_qk(float* sc, uint32_t qa, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {  // 16 columns of dh: box kk / 4, 32 bytes each inside it
    const uint32_t at = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    wgmma_ss_n64(sc, sdesc(qa + at, 16, 1024), sdesc(kt + at, 16, 1024), kk > 0);
  }
}

// O += P·V for a V tile at vt (keys × dv, dv contiguous, so read transposed), issued
template <int D>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* pa, uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)  // 16 keys: 16 rows of 128 bytes
    wgmma_pv<D>(o, pa + 4 * kk, sdesc(vt + kk * 16 * 128, kBoxBytes, 1024));
}

// Online softmax of one score tile in wgmma's accumulator layout: this
// thread holds keys k0 + 8j + 2(lane%4) + {0,1} of rows a (sc[4j], sc[4j+1])
// and b (sc[4j+2], sc[4j+3]), at query positions qpos_a and qpos_a + 8.  The
// scores become p = exp2(x − m) (fp32, unrounded); m and this thread's part
// of l move on, and corr is the factor by which O has to shrink.
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* l, float* corr, const Params& p, int k0,
                                             int qpos_a, int lane, bool whole) {
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = p.softcap * tanhf(sc[i] * p.scale / p.softcap) * kLog2e;
  } else {
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] *= p.scale_log2;
  }
  if (!whole) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
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
  for (int i = 0; i < 32; ++i) mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the four lanes of a quad hold one row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = exp2f(m[r] - mx[r]);
    m[r] = mx[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    sc[i] = exp2f(sc[i] - m[(i / 2) & 1]);
    rs[(i / 2) & 1] += sc[i];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];  // quad-reduced once, at the end
}

// p in bf16 pairs: pa[4kk..4kk+3] is wgmma's A fragment of keys 16kk..16kk+15
__device__ __forceinline__ void pack_p(const float* sc, uint32_t* pa) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    pa[2 * j] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[2 * j + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ out, const Params p) {
  constexpr int NC = D / kChunk;           // boxes per tile row
  constexpr int S = stages<D>();
  static_assert(S >= 2, "the consumers hold a tile's stage while they wait for the next one");
  constexpr uint32_t TILE = kBoxBytes * NC;  // bytes of one 64-row tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // the swizzle repeats every 1,024 bytes
  const uint32_t sQ = base;                     // [kConsumers][NC][64 rows][128 B]
  const uint32_t sK = sQ + kConsumers * TILE;  // [S][NC][64 keys][128 B]
  const uint32_t sV = sK + S * TILE;           // [S][NC][64 keys][128 B]
  const uint32_t bar_q = sV + S * TILE;        // then full K [S], full V [S], empty [S]
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * S, bar_e = bar_v + 8 * S;

  const int qt = gridDim.y - 1 - blockIdx.y;  // heaviest query tiles first under causality
  const int h = blockIdx.x % p.hq, b = blockIdx.x / p.hq, hk = h / p.group;
  const int q0 = qt * kBQ;
  const int off = p.skv - p.sq;
  // keys that some row of this block can see
  const int k_hi = p.causal ? min(p.skv, min(q0 + kBQ, p.sq) + off) : p.skv;
  const int k_lo = p.window > 0 ? max(0, q0 + off - p.window + 1) / kKeys * kKeys : 0;
  const int ntiles = (k_hi - k_lo + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kConsumers * TILE);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < NC; ++c)
          tma_load(sQ + w * TILE + c * kBoxBytes, &tq, bar_q, c * kChunk, q0 + w * kRows, h, b);
      for (int it = 0; it < ntiles; ++it) {
        const int s = it % S, k0 = k_lo + it * kKeys;
        mbar_wait(bar_e + 8 * s, ((it / S) & 1) ^ 1);  // the first round finds every stage free
        mbar_expect_tx(bar_k + 8 * s, TILE);
        for (int c = 0; c < NC; ++c)
          tma_load(sK + s * TILE + c * kBoxBytes, &tk, bar_k + 8 * s, c * kChunk, k0, hk, b);
        mbar_expect_tx(bar_v + 8 * s, TILE);
        for (int c = 0; c < NC; ++c)
          tma_load(sV + s * TILE + c * kBoxBytes, &tv, bar_v + 8 * s, c * kChunk, k0, hk, b);
      }
    }
  } else {  // consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int w = wg - 1, t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r0 = q0 + w * kRows;  // this warpgroup's first query row
    // this thread's rows are qpos_a and qpos_a + 8 (query positions on the key axis)
    const int qpos_a = r0 + warp * 16 + lane / 4 + off;
    const int qlo = r0 + off, qhi = min(r0 + kRows, p.sq) - 1 + off;
    const uint32_t qa = sQ + w * TILE;

    float o[D / 2];  // wgmma accumulator: columns 8n + 2(lane%4) + {0,1}, rows a (4n, 4n+1), b (4n+2, 4n+3)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};  // l: this thread's part of the row sum

    // Both consumers walk all the block's key tiles, so that they take turns
    // on the tensor cores in step: while one runs its softmax, the other's
    // products run.  A tile masked for every row of a consumer gives p = 0
    // once the row has a real maximum, and is wiped by the correction when
    // it comes before one.
    auto whole = [&](int it) {  // no key of the tile is masked for any row of this warpgroup
      const int k0 = k_lo + it * kKeys;
      return k0 + kKeys <= p.skv && (!p.causal || k0 + kKeys - 1 <= qlo) && (p.window == 0 || qhi - k0 < p.window);
    };
    const int me = wg, other = 3 - wg;  // named barriers 1 and 2
    if (wg == 2) turn_pass(other);      // consumer 1 goes first
    mbar_wait(bar_q, 0);
    {
      // Software pipeline: the softmax of tile it runs while the tensor
      // cores do P·V of tile it − 1.
      float sc[32], corr[2];  // S tile, same layout as o with 64 columns
      uint32_t pa[16];
      int s = 0;
      mbar_wait(bar_k, 0);
      turn_wait(me);
      wgmma_fence();
      issue_qk<D>(sc, qa, sK);
      wgmma_commit();
      turn_pass(other);
      wgmma_wait<0>();
      reg_fence<32>(sc);
      softmax_tile(sc, m, l, corr, p, k_lo, qpos_a, lane, whole(0));  // o is 0: no rescale
      pack_p(sc, pa);
      for (int it = 1; it < ntiles; ++it) {
        const int sp = (it - 1) % S;
        s = it % S;
        mbar_wait(bar_k + 8 * s, (it / S) & 1);
        mbar_wait(bar_v + 8 * sp, ((it - 1) / S) & 1);
        turn_wait(me);
        wgmma_fence();
        issue_qk<D>(sc, qa, sK + s * TILE);
        wgmma_commit();
        issue_pv<D>(o, pa, sV + sp * TILE);
        wgmma_commit();
        turn_pass(other);
        wgmma_wait<1>();  // S of tile it is in; P·V of tile it − 1 runs on
        reg_fence<32>(sc);
        softmax_tile(sc, m, l, corr, p, k_lo + it * kKeys, qpos_a, lane, whole(it));
        wgmma_wait<0>();
        reg_fence<D / 2>(o);
        mbar_arrive(bar_e + 8 * sp);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i / 2) & 1];
        pack_p(sc, pa);
      }
      s = (ntiles - 1) % S;
      mbar_wait(bar_v + 8 * s, ((ntiles - 1) / S) & 1);
      turn_wait(me);
      wgmma_fence();
      issue_pv<D>(o, pa, sV + s * TILE);
      wgmma_commit();
      if (wg == 1) turn_pass(other);  // every bar.sync meets exactly one bar.arrive
      wgmma_wait<0>();
      reg_fence<D / 2>(o);
      mbar_arrive(bar_e + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const int row_a = r0 + warp * 16 + lane / 4;
    __nv_bfloat16* og = out + (static_cast<long long>(b) * p.hq + h) * p.sq * p.dv;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
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

// 4-d map of a [B, H, S, d] bf16 tensor with element strides (sb, sh, ss, 1),
// in 64-row boxes of 64 columns, 128-byte swizzle, zero fill out of bounds
bool make_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int d, long long sb, long long sh,
              long long ss) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {kChunk, 64, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_d(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* out, int B,
             const Params& p, void* stream) {
  constexpr int smem = smem_bytes<D>();
  const cudaError_t e =
      cudaFuncSetAttribute(flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * p.hq, (p.sq + kBQ - 1) / kBQ);
  flash_wgmma_kernel<D><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned8(long long x) { return x % 8 == 0; }

}  // namespace

extern "C" int flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* out, int B, int Hq,
                                          int Hkv, int Sq, int Skv, int dh, int dv, long long qsb,
                                          long long qsh, long long qss, long long ksb, long long ksh,
                                          long long kss, long long vsb, long long vsh, long long vss,
                                          double scale, int causal, int window, double softcap, void* stream) {
  const int d = dh > dv ? dh : dv;
  if (B < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Skv < 1 || dh < 1 || dv < 1 || d > 256 ||
      window < 0 || softcap < 0.0)
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA: 16-byte aligned bases, strides and rows (the wrapper pads what is not)
  for (const void* ptr : {q, k, v})
    if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  for (long long x : {(long long)dh, (long long)dv, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss})
    if (!aligned8(x)) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Hq, Sq, dh, qsb, qsh, qss) || !make_map(&tk, k, B, Hkv, Skv, dh, ksb, ksh, kss) ||
      !make_map(&tv, v, B, Hkv, Skv, dv, vsb, vsh, vss))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{Hq / Hkv, Sq, Skv, dv, Hq, causal, window,
                 static_cast<float>(scale * 1.4426950408889634), static_cast<float>(scale),
                 static_cast<float>(softcap)};
  if (d <= 64) return launch_d<64>(tq, tk, tv, out, B, p, stream);
  if (d <= 128) return launch_d<128>(tq, tk, tv, out, B, p, stream);
  return launch_d<256>(tq, tk, tv, out, B, p, stream);
}
