// Matrix-free element-by-element (EBE) product for Hopper (sm_90a), with
// the gather of the element's nodal values fused in:
//   f_e = Σ_p wdet_p · coef_e · B_pᵀ D_p B_p u_e,   u_e = x[conn_e]
// with B_p rebuilt from J⁻¹ and the reference shape-function gradients, so
// no K_e, no B and no gathered [E,10,3] copy of x is ever stored.
//
// Replaces: ebe_element_matvec_pallas / _ebe_kernel in
//   src/repro/kernels/ebe_matvec/ebe_matvec.py (the TPU kernel), together
//   with the gather in front of it.
// Plain version: repro_torch.fem.spmv.gather_elem + ebe_element_matvec.
//
// What bounds it on an H100: bytes.  Per element it reads D (144 values),
// J⁻¹ (9), wdet (4), coef (1) and conn (10 int32) once, and writes f (30):
// about 1.5 KB in fp64 and 0.8 KB in fp32, for about 2.4 kflop, well below
// the card's ops:byte balance point in either type.  x (10 MB in fp64 at
// the full-size mesh) is read through the connectivity and stays in L2.
//
// Design: a persistent grid walks tiles of TE consecutive elements (TE a
// multiple of 4, at most 64).  Because D, J⁻¹, wdet, coef and conn are
// element-major, a tile's share of each is one contiguous range: one warp
// copies it into shared memory with Hopper's bulk asynchronous copy
// (cp.async.bulk, completing on an mbarrier), double-buffered, so the next
// tile's bytes arrive while this one computes.  Then the block gathers the
// tile's u_e = x[conn] into shared memory, and four threads share an
// element, one per Gauss point p:
//   Hr = Σ_n u_n ⊗ ∇̂N_pn (reference gradients, held in registers),
//   H = Hr J⁻¹, ε = sym(H), σ = wdet_p coef D_p ε, S = σ J⁻ᵀ,
//   f_n = S ∇̂N_pn,
// so the physical gradients are never formed.  D_p is read as 16-byte
// vectors; fp64 pads each element's D to 146 values in shared memory (one
// copy per element) so that the eight threads of a quarter warp, two
// elements × four points, hit eight different 16-byte bank groups; fp32
// needs no padding.  The four points' f are summed by a reduce-scatter of
// two shuffle rounds (23 values a thread instead of 60), each sum in a
// fixed order, then staged in shared memory and stored as 16-byte vectors.
// The ragged last tile (E not a multiple of TE) is loaded by plain loads.
// There are no atomics: the assembly (scatter) stays outside, deterministic.
//
// k-set launch (the paper's 2SET, Proposed 2's ensemble): k members share
// the mesh (conn, J⁻¹, wdet) and each has its own x, D, coef and f.  The
// persistent grid walks k × ntiles tiles, member-major; a tile reads its
// member's x, D, coef and writes its f at the member's offset, and reads
// the shared geometry at the same addresses for every member (so the
// second member's tiles find it in L2).  A member whose D or coef range is
// not 16-byte aligned (fp32 coef with E not a multiple of 4) is loaded by
// plain loads, as a ragged tile is, and a misaligned f by plain stores;
// the arithmetic is the same either way.  A launch of one member (k = 1)
// takes the instance without the member bookkeeping (KSET false): the
// one-member kernel as it was.
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kNPoint = 4;
constexpr int kNNode = 10;
constexpr int kDof = kNNode * 3;      // 30 values of u_e and f_e
constexpr int kDElem = kNPoint * 36;  // 144 values of D per element
constexpr int kMaxTile = 64;          // elements per tile (4 threads each)
constexpr int kMaxDevices = 64;       // device ordinals with a configuration of their own

// Shared-memory layout, for one tile of `te` elements.  Every range starts
// on a 16-byte boundary when te is a multiple of 4.
template <typename T>
struct Smem {
  static constexpr int kDStride = sizeof(T) == 8 ? kDElem + 2 : kDElem;  // see the design note
  int te;
  __host__ __device__ size_t d() const { return 0; }
  __host__ __device__ size_t jinv() const { return d() + sizeof(T) * te * kDStride; }
  __host__ __device__ size_t wdet() const { return jinv() + sizeof(T) * te * 9; }
  __host__ __device__ size_t coef() const { return wdet() + sizeof(T) * te * kNPoint; }
  __host__ __device__ size_t conn() const { return coef() + sizeof(T) * te; }
  __host__ __device__ size_t stage() const { return conn() + sizeof(int) * te * kNNode; }
  // [2 mbarriers | reference gradients | stage 0 | stage 1 | u | f]
  __host__ __device__ size_t gref() const { return 16; }
  __host__ __device__ size_t stages() const { return gref() + sizeof(T) * kNPoint * kDof; }
  __host__ __device__ size_t u() const { return stages() + 2 * stage(); }
  __host__ __device__ size_t f() const { return u() + sizeof(T) * te * kDof; }
  __host__ __device__ size_t total() const { return f() + sizeof(T) * te * kDof; }
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

// Wait for the phase of parity `parity` to complete; a copy that never
// lands traps after ~2^34 cycles instead of hanging the card.
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

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T>
__device__ __forceinline__ T shfl_xor(T v, int off) {
  return __shfl_xor_sync(0xffffffffu, v, off);
}

template <typename T>
struct Args {
  const T* x;
  const int* conn;
  const T* D;
  const T* Jinv;
  const T* wdet;
  const T* coef;  // nullable: coef 1
  int E;
  int N;  // nodes of one member's x
  int k;  // members
  // one member's x, D and coef
  __device__ __forceinline__ const T* xm(int m) const { return x + 3ll * N * m; }
  __device__ __forceinline__ const T* Dm(int m) const { return D + (long long)E * kDElem * m; }
  __device__ __forceinline__ const T* cm(int m) const { return coef ? coef + (long long)E * m : nullptr; }
  // can member m's full tiles take the bulk copies (16-byte aligned ranges)?
  // The bases are 16-byte aligned (the wrapper checks) and a member's D is
  // E·144 values, a multiple of 16 bytes: only coef's member offset can break it.
  __device__ __forceinline__ bool bulk_ok(int m) const {
    return !coef || (((long long)E * m * sizeof(T)) & 15) == 0;
  }
};

// Warp 0 starts the bulk copies of member m's full tile at e0 into `stage`.
template <typename T>
__device__ __forceinline__ void issue_tile(const Args<T>& a, const Smem<T>& L, unsigned char* stage,
                                           uint32_t bar, int m, long long e0, int lane) {
  const T* Dm = a.Dm(m);
  const T* cm = a.cm(m);
  const int te = L.te;
  if (lane == 0) {
    // earlier generic-proxy reads of this stage come before the async writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t bytes = sizeof(T) * te * (kDElem + 9 + kNPoint + (a.coef ? 1 : 0)) + sizeof(int) * te * kNNode;
    mbar_expect_tx(bar, bytes);
  }
  __syncwarp();
  if (Smem<T>::kDStride == kDElem) {
    if (lane == 0) bulk_load(smem_u32(stage + L.d()), Dm + e0 * kDElem, sizeof(T) * te * kDElem, bar);
  } else {
    for (int e = lane; e < te; e += 32)
      bulk_load(smem_u32(stage + L.d() + sizeof(T) * e * Smem<T>::kDStride), Dm + (e0 + e) * kDElem,
                sizeof(T) * kDElem, bar);
  }
  if (lane == 1) bulk_load(smem_u32(stage + L.jinv()), a.Jinv + e0 * 9, sizeof(T) * te * 9, bar);
  if (lane == 2) bulk_load(smem_u32(stage + L.wdet()), a.wdet + e0 * kNPoint, sizeof(T) * te * kNPoint, bar);
  if (lane == 3 && cm) bulk_load(smem_u32(stage + L.coef()), cm + e0, sizeof(T) * te, bar);
  if (lane == 4) bulk_load(smem_u32(stage + L.conn()), a.conn + e0 * kNNode, sizeof(int) * te * kNNode, bar);
}

// The block loads member m's tile of `n` ≤ te elements at e0 with plain
// loads (a ragged tile, or a member whose ranges are not 16-byte aligned).
template <typename T>
__device__ __forceinline__ void load_plain(const Args<T>& a, const Smem<T>& L, unsigned char* stage,
                                           int m, long long e0, int n) {
  const T* Dm = a.Dm(m);
  const T* cm = a.cm(m);
  T* Ds = reinterpret_cast<T*>(stage + L.d());
  for (int k = threadIdx.x; k < n * kDElem; k += blockDim.x)
    Ds[(k / kDElem) * Smem<T>::kDStride + k % kDElem] = Dm[e0 * kDElem + k];
  for (int k = threadIdx.x; k < n * 9; k += blockDim.x)
    reinterpret_cast<T*>(stage + L.jinv())[k] = a.Jinv[e0 * 9 + k];
  for (int k = threadIdx.x; k < n * kNPoint; k += blockDim.x)
    reinterpret_cast<T*>(stage + L.wdet())[k] = a.wdet[e0 * kNPoint + k];
  if (cm)
    for (int k = threadIdx.x; k < n; k += blockDim.x) reinterpret_cast<T*>(stage + L.coef())[k] = cm[e0 + k];
  for (int k = threadIdx.x; k < n * kNNode; k += blockDim.x)
    reinterpret_cast<int*>(stage + L.conn())[k] = a.conn[e0 * kNNode + k];
}

// This thread's Gauss point's 6×6 D as 16-byte vector loads from shared memory.
__device__ __forceinline__ void load_d(const double* src, double* d) {
#pragma unroll
  for (int k = 0; k < 18; ++k) {
    const double2 v = reinterpret_cast<const double2*>(src)[k];
    d[2 * k] = v.x;
    d[2 * k + 1] = v.y;
  }
}
__device__ __forceinline__ void load_d(const float* src, float* d) {
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float4 v = reinterpret_cast<const float4*>(src)[k];
    d[4 * k] = v.x;
    d[4 * k + 1] = v.y;
    d[4 * k + 2] = v.z;
    d[4 * k + 3] = v.w;
  }
}

template <typename T, bool KSET>
__global__ void __launch_bounds__(4 * kMaxTile)
ebe_kernel(Args<T> a, const T* __restrict__ gradn, int te, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Smem<T> L{te};
  const uint32_t bar0 = smem_u32(smem);
  T* gref = reinterpret_cast<T*>(smem + L.gref());
  T* us = reinterpret_cast<T*>(smem + L.u());
  T* fs = reinterpret_cast<T*>(smem + L.f());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int el = tid >> 2, p = tid & 3;  // element of the tile, Gauss point
  const int ntiles = (a.E + te - 1) / te;  // per member; tiles are member-major

  // the reference gradients go through shared memory: where the compiler
  // re-reads gr[] in the tile loop rather than hold it, the re-reads stay
  // out of L1/L2 (read from global, the fp32 instance ran slower)
  for (int k = tid; k < kNPoint * kDof; k += blockDim.x) gref[k] = gradn[k];
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar0 + 8, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  T gr[kDof];  // ∂N_n/∂ξ_k at this thread's point, gr[n*3+k]
#pragma unroll
  for (int k = 0; k < kDof; ++k) gr[k] = gref[p * kDof + k];

  const int k = KSET ? a.k : 1;
  // a full tile of a member whose ranges are aligned takes the bulk copies
  auto bulk = [&](int m, int t) {
    return m < k && (long long)(t + 1) * te <= a.E && (!KSET || a.bulk_ok(m));
  };
  // this block's tiles are blockIdx.x, + gridDim.x, …: member m, tile t of it
  int m = KSET ? blockIdx.x / ntiles : 0, t = blockIdx.x - m * ntiles;
  bool by_bulk = bulk(m, t);
  if (warp == 0 && by_bulk) issue_tile(a, L, smem + L.stages(), bar0, KSET ? m : 0, (long long)t * te, lane);

  int it = 0;
  uint32_t phase = 0;  // bit s: the parity of stage s's next completion
  for (; m < k; ++it) {
    const int s = it & 1;
    unsigned char* stage = smem + L.stages() + s * L.stage();
    int next_m = m, next_t = t + gridDim.x;
    while (next_t >= ntiles && next_m < k) {
      next_t -= ntiles;
      ++next_m;
    }
    const bool next_bulk = bulk(next_m, next_t);
    if (warp == 0 && next_bulk)
      issue_tile(a, L, smem + L.stages() + (s ^ 1) * L.stage(), bar0 + 8 * (s ^ 1), KSET ? next_m : 0,
                 (long long)next_t * te, lane);

    const long long e0 = (long long)t * te;
    const int n = e0 + te <= a.E ? te : a.E - (int)e0;
    if (by_bulk) {
      mbar_wait(bar0 + 8 * s, (phase >> s) & 1);
      phase ^= 1u << s;
    } else {
      load_plain(a, L, stage, KSET ? m : 0, e0, n);
      __syncthreads();
    }

    // gather u_e = x[conn] for the tile: 3 node slots per thread at most
    const int* cs = reinterpret_cast<const int*>(stage + L.conn());
    const T* xm = KSET ? a.xm(m) : a.x;
#pragma unroll
    for (int r = 0; r < (kNNode + 3) / 4; ++r) {
      const int k = tid + r * blockDim.x;
      if (k < n * kNNode) {
        const T* xn = xm + 3ll * cs[k];
        const T v0 = xn[0], v1 = xn[1], v2 = xn[2];
        us[3 * k] = v0;
        us[3 * k + 1] = v1;
        us[3 * k + 2] = v2;
      }
    }
    __syncthreads();

    // every thread computes, so the shuffles below see full warps; rows of
    // a ragged tile past n hold stale values and are not stored
    const T* ue = us + el * kDof;
    const T* Js = reinterpret_cast<const T*>(stage + L.jinv()) + el * 9;
    T J[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) J[k] = Js[k];
    // Hr[i][k] = Σ_n u_ni ∂N_n/∂ξ_k
    T Hr[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) Hr[k] = T(0);
#pragma unroll
    for (int nd = 0; nd < kNNode; ++nd) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const T ui = ue[nd * 3 + i];
#pragma unroll
        for (int k = 0; k < 3; ++k) Hr[i * 3 + k] += ui * gr[nd * 3 + k];
      }
    }
    // H[i][j] = Σ_k Hr[i][k] J⁻¹[k][j]  (∂u_i/∂x_j)
    T H[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j) H[i * 3 + j] = Hr[i * 3] * J[j] + Hr[i * 3 + 1] * J[3 + j] + Hr[i * 3 + 2] * J[6 + j];
    }
    const T eps[6] = {H[0], H[4], H[8], H[1] + H[3], H[5] + H[7], H[6] + H[2]};
    T d[36];
    load_d(reinterpret_cast<const T*>(stage + L.d()) + el * Smem<T>::kDStride + p * 36, d);
    const T c = a.coef ? reinterpret_cast<const T*>(stage + L.coef())[el] : T(1);  // member m's
    const T wp = reinterpret_cast<const T*>(stage + L.wdet())[el * kNPoint + p] * c;
    T sw[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T acc = T(0);
#pragma unroll
      for (int j = 0; j < 6; ++j) acc += d[i * 6 + j] * eps[j];
      sw[i] = acc * wp;
    }
    const T st[9] = {sw[0], sw[3], sw[5], sw[3], sw[1], sw[4], sw[5], sw[4], sw[2]};
    // Sg[i][k] = Σ_j σ_ij J⁻¹[k][j], then f_ni = Σ_k Sg[i][k] ∂N_n/∂ξ_k  (Bᵀσ)
    T Sg[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        Sg[i * 3 + k] = st[i * 3] * J[k * 3] + st[i * 3 + 1] * J[k * 3 + 1] + st[i * 3 + 2] * J[k * 3 + 2];
    }
    T f[kDof];
#pragma unroll
    for (int nd = 0; nd < kNNode; ++nd) {
#pragma unroll
      for (int i = 0; i < 3; ++i)
        f[nd * 3 + i] = Sg[i * 3] * gr[nd * 3] + Sg[i * 3 + 1] * gr[nd * 3 + 1] + Sg[i * 3 + 2] * gr[nd * 3 + 2];
    }

    // sum over the four points: reduce-scatter over lanes p^2, then p^1;
    // value k ends at one lane as (f_q + f_q^2) + (f_q^1 + f_q^3)
    const bool hi2 = p & 2, hi1 = p & 1;
    T r15[15];
#pragma unroll
    for (int j = 0; j < 15; ++j) {
      const T keep = hi2 ? f[15 + j] : f[j];
      const T send = hi2 ? f[j] : f[15 + j];
      r15[j] = keep + shfl_xor(send, 2);
    }
    T r8[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const T upper = j < 7 ? r15[8 + j] : T(0);
      const T keep = hi1 ? upper : r15[j];
      const T send = hi1 ? r15[j] : upper;
      r8[j] = keep + shfl_xor(send, 1);
    }
    if (el < n) {
      T* fe = fs + el * kDof + (hi2 ? 15 : 0) + (hi1 ? 8 : 0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < 7 || !hi1) fe[j] = r8[j];
    }
    __syncthreads();

    // the tile's f_e is one contiguous range of member m's out: 16-byte
    // stores where that range is 16-byte aligned
    T* dst = out + ((KSET ? (long long)a.E * m : 0ll) + e0) * kDof;
    const int nval = n * kDof, per = 16 / sizeof(T);
    const int nvec = KSET && (reinterpret_cast<uintptr_t>(dst) & 15) ? 0 : nval / per;
    if (sizeof(T) == 8) {
      for (int k = tid; k < nvec; k += blockDim.x)
        reinterpret_cast<double2*>(dst)[k] = reinterpret_cast<const double2*>(fs)[k];
    } else {
      for (int k = tid; k < nvec; k += blockDim.x)
        reinterpret_cast<float4*>(dst)[k] = reinterpret_cast<const float4*>(fs)[k];
    }
    for (int k = nvec * per + tid; k < nval; k += blockDim.x) dst[k] = fs[k];
    m = next_m;
    t = next_t;
    by_bulk = next_bulk;
  }
}

template <typename T, bool KSET>
int launch_instance(const Args<T>& args, const T* gradn, int tile_e, long long tiles, T* out, void* stream) {
  const size_t smem = Smem<T>{tile_e}.total();
  // per instance and per device (the launching thread's current one): the
  // shared-memory ceiling once, its SM count, and blocks per SM per tile
  // size; under a lock, since several host threads may launch at once
  static std::mutex mu;
  static int sms_of[kMaxDevices] = {};
  static int per_sm[kMaxDevices][kMaxTile / 4 + 1] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = 0, occ = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (sms_of[dev] == 0) {
      e = cudaFuncSetAttribute(ebe_kernel<T, KSET>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Smem<T>{kMaxTile}.total()));
      if (e != cudaSuccess) return static_cast<int>(e);
      if ((e = cudaDeviceGetAttribute(&sms_of[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
        return static_cast<int>(e);
    }
    int& cached = per_sm[dev][tile_e / 4];
    if (cached == 0) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached, ebe_kernel<T, KSET>, 4 * tile_e, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (cached < 1) {
        cached = 0;
        return static_cast<int>(cudaErrorInvalidConfiguration);
      }
    }
    sms = sms_of[dev];
    occ = cached;
  }
  const int grid = tiles < occ * sms ? static_cast<int>(tiles) : occ * sms;
  ebe_kernel<T, KSET><<<grid, 4 * tile_e, smem, static_cast<cudaStream_t>(stream)>>>(args, gradn, tile_e, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* conn, const void* D, const void* Jinv, const void* wdet,
           const void* coef, const void* gradn, int E, int N, int k, int tile_e, void* out, void* stream) {
  if (tile_e < 4 || tile_e > kMaxTile || tile_e % 4 || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (E <= 0) return static_cast<int>(cudaGetLastError());
  const long long tiles = (long long)k * ((E + tile_e - 1) / tile_e);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> args{(const T*)x, (const int*)conn, (const T*)D, (const T*)Jinv, (const T*)wdet,
                     (const T*)coef, E, N, k};
  return k == 1 ? launch_instance<T, false>(args, (const T*)gradn, tile_e, tiles, (T*)out, stream)
                : launch_instance<T, true>(args, (const T*)gradn, tile_e, tiles, (T*)out, stream);
}

}  // namespace

// k members: x [k,N,3], D [k,E,4,6,6], coef [k,E] (nullable), out [k,E,10,3];
// conn [E,10], Jinv [E,3,3] and wdet [E,4] shared
extern "C" int ebe_matvec_f32(const void* x, const void* conn, const void* D, const void* Jinv,
                              const void* wdet, const void* coef, const void* gradn, int E, int N, int k,
                              int tile_e, void* out, void* stream) {
  return launch<float>(x, conn, D, Jinv, wdet, coef, gradn, E, N, k, tile_e, out, stream);
}

extern "C" int ebe_matvec_f64(const void* x, const void* conn, const void* D, const void* Jinv,
                              const void* wdet, const void* coef, const void* gradn, int E, int N, int k,
                              int tile_e, void* out, void* stream) {
  return launch<double>(x, conn, D, Jinv, wdet, coef, gradn, E, N, k, tile_e, out, stream);
}
