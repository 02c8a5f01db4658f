// Elementwise-masked matmul, the crossbar-UNAWARE LTP baseline, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/bsmm.py _masked_kernel
// (masked_matmul_pallas):
//
//   out (M, N) = x (M, K) @ (w (K, N) * mask (K, N)),  f32 accumulator,
//
// over a dense grid of 128 x 128 (bk x bn) tiles.  Its defining
// property is kept: EVERY tile of w and of mask is read, and only the
// product of a tile whose mask is all zero is skipped (a skipped tile
// adds no term, even where w holds NaN).  That is what unstructured
// (LTP) sparsity costs on crossbar hardware: the bytes of dead weights
// still move, only the arithmetic goes.  (The block-sparse kernels of
// bsmm.cu are the crossbar-aware counterpart: they never read a dead
// tile.)  Inside a live tile the product is w * round_to<T>(mask) in
// w's type, so NaN * 0 stays NaN, as in the reference.  The mask may be
// float32, bfloat16 or one byte (bool / uint8).
//
// Three kernels, chosen on the host from (M, K, N, dtype) only
// (bsmm.masked_route / masked_splits), so that a call is bitwise
// repeatable at a fixed (M, K, N).  It is not batch invariant: the
// same row at another M may get another split count or kernel, and so
// other bits.
//
// 1. masked_stream_kernel, every M < 64 (decode rows), both dtypes:
//    split-K streaming.  The grid is (N / 128 column tiles) x (row
//    blocks of 8 or 32) x (S K-splits of whole 128-row tiles), S
//    picked for at least two waves of 132 SMs and, at 8 rows, up to the
//    three blocks an SM holds, so that no second round of blocks runs
//    on a part of the card.  Each block keeps a ring of 4 stages of
//    cp.async.cg 16-byte loads (w, mask and x rows of a quarter or an
//    eighth of a tile each; 3 stages, ~50-75 KB, in flight), forms
//    w * mask as it consumes a stage, accumulates the tile's
//    partial product in registers and adds it only once
//    __syncthreads_or says the whole tile's mask has a nonzero.  The
//    partials of the S splits go to an f32 workspace (S, M, N) and
//    masked_splitk_reduce_kernel sums them in split order (no atomics:
//    two calls give the same bits).  Bound on the H100 by the bytes of
//    w and mask (at M = 8, ~2 flops per weight byte).
//
// 2. masked_wgmma_kernel, bfloat16 at M >= 64: a 256 x 128 output tile
//    per block, 3 warpgroups.  A producer thread issues TMA loads of the
//    x tile (256 x 64, 128-byte swizzled), the w tile (two 64 x 64 boxes,
//    128-byte swizzled: wgmma's MN-major B layout) and the mask (boxes of
//    128-byte rows) into a ring of 64-row K stages behind full/empty
//    mbarriers.  Two consumer warpgroups form w * mask in place in the
//    w buffer (bf16 pair products), vote on the tile (two stages:
//    bar.red.or over the 256 consumer threads), and only for a live tile
//    run wgmma m64n128k16 (A = x, B = the product, both from shared
//    memory) into f32 registers, 128 rows each.  With 4 stages (a
//    one-byte mask) the next tile's product is formed while this tile's
//    wgmmas run.  Blocks walk M fastest, so the row tiles of one column
//    of w read it from the L2.  What bounds it at M = 1024: the bytes
//    from the L2 to the SMs, (M / 256) (w + mask) + (N / 128) x, rather
//    than HBM or the tensor cores; 256 rows a block (not 128) halve the
//    w and mask share of them and the product formation per output row.
//
// 3. masked_fma_kernel, float32 at M >= 64: a block owns 64 rows of one
//    column tile and walks its K range with one tile of loads in flight,
//    on the CUDA cores (the reference computes in f32; TF32 would break
//    its 1e-4 gate).  It splits K as route 1 does when its grid would
//    fill less than one wave.
//
// Shared memory of the wgmma kernel per 64-row stage: x 32 KB, w 16 KB,
// mask 8 / 16 / 32 KB (u8 / bf16 / f32): 4 stages of 56 KB (224 KB), 3 of
// 64 KB (192 KB) or 2 of 80 KB (160 KB), plus 1 KB alignment slack and
// the barriers: within the 227 KB a block may take
// (bsmm.masked_wgmma_smem_bytes).
#include <cuda.h>           // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 128;     // bk = bn: the paper's crossbar, the plan unit
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(uint8_t v) { return static_cast<float>(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back (the reference multiplies in w's dtype)
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <int BYTES> struct Chunk;
template <> struct Chunk<4> { using type = uint32_t; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<16> { using type = uint4; };

// V consecutive elements of U (16-byte-aligned pieces) as f32; returns
// whether any is nonzero.
template <typename U, int V>
__device__ __forceinline__ bool load_vals(const U* __restrict__ p, float* out) {
  constexpr int BYTES = V * (int)sizeof(U);
  constexpr int CH = BYTES >= 16 ? 16 : BYTES;
  using L = typename Chunk<CH>::type;
  alignas(16) U buf[V];
#pragma unroll
  for (int c = 0; c < BYTES / CH; ++c)
    reinterpret_cast<L*>(buf)[c] = reinterpret_cast<const L*>(p)[c];
  bool any = false;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    out[i] = to_f32(buf[i]);
    any |= (out[i] != 0.f);
  }
  return any;
}

// two consecutive elements as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const uint8_t* p) {
  const uint32_t v = *reinterpret_cast<const uint16_t*>(p);
  return make_float2(static_cast<float>(v & 0xffu), static_cast<float>(v >> 8));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// 16 bytes, or 16 zero bytes where !valid (src is then not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// 1. split-K streaming, M < 64
// ---------------------------------------------------------------------------
template <typename T, typename MT, int BM>
struct Stream {
  static constexpr int R = sizeof(T) == 2 ? 32 : 16;   // K rows per stage
  static constexpr int CPT = TILE / R;                  // stages per tile
  static constexpr int NS = 4;                          // ring depth
  static constexpr int KG = 4;                          // K groups of threads
  static constexpr int RK = R / KG;                     // rows per thread per stage
  static constexpr int W_BYTES = R * TILE * sizeof(T);
  static constexpr int M_BYTES = R * TILE * sizeof(MT);
  static constexpr int X_BYTES = BM * R * sizeof(T);
  static constexpr int STAGE = W_BYTES + M_BYTES + X_BYTES;
  static constexpr int SMEM = NS * STAGE;
  static_assert(RK * sizeof(T) == 16, "one 16-byte x load per row and stage");
  static_assert(BM * TILE * sizeof(float) <= SMEM, "the reduction reuses the ring");
};

// A block owns rows m0..m0+BM of column tile j and the K tiles of split
// z.  Thread (pair pr, K group kg) owns columns 2 pr, 2 pr + 1 of every
// row, summed over the RK rows of each stage that belong to its group.
template <typename T, typename MT, int BM>
__global__ void __launch_bounds__(THREADS, BM <= 8 ? 3 : 1)
masked_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const MT* __restrict__ mask, T* __restrict__ out,
                     float* __restrict__ ws, int M, int K, int N, int per) {
  using S = Stream<T, MT, BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * TILE;
  const int m0 = blockIdx.y * BM;
  const int kt0 = blockIdx.z * per;
  const int kt1 = min(kt0 + per, K / TILE);
  const int nst = (kt1 - kt0) * S::CPT;
  const int tid = threadIdx.x;
  const int pr = tid % 64, kg = tid / 64;

  auto issue = [&](int st) {
    uint8_t* s = smem + (st % S::NS) * S::STAGE;
    const size_t k = (size_t)kt0 * TILE + (size_t)st * S::R;
    constexpr int WC = TILE * sizeof(T) / 16;          // 16-byte pieces a row
    for (int c = tid; c < S::R * WC; c += THREADS) {
      const int r = c / WC, q = c % WC;
      cp_async16(s + c * 16,
                 reinterpret_cast<const uint8_t*>(w + (k + r) * N + n0) + q * 16);
    }
    constexpr int MC = TILE * sizeof(MT) / 16;
    for (int c = tid; c < S::R * MC; c += THREADS) {
      const int r = c / MC, q = c % MC;
      cp_async16(s + S::W_BYTES + c * 16,
                 reinterpret_cast<const uint8_t*>(mask + (k + r) * N + n0) + q * 16);
    }
    constexpr int XC = S::R * sizeof(T) / 16;
    for (int c = tid; c < BM * XC; c += THREADS) {
      const int r = c / XC, q = c % XC;
      const bool ok = m0 + r < M;                      // rows past M read as 0
      cp_async16_zfill(s + S::W_BYTES + S::M_BYTES + c * 16,
                       reinterpret_cast<const uint8_t*>(
                           x + (size_t)(ok ? m0 + r : 0) * K + k) + q * 16,
                       ok);
    }
  };

#pragma unroll
  for (int st = 0; st < S::NS - 1; ++st) {
    if (st < nst) issue(st);
    cp_async_commit();
  }

  float acc[BM][2], tacc[BM][2];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m][0] = acc[m][1] = tacc[m][0] = tacc[m][1] = 0.f;
  bool any = false;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<S::NS - 2>();          // this thread's pieces of stage st
    __syncthreads();                     // everyone's; slot st - 1 is free
    if (st + S::NS - 1 < nst) issue(st + S::NS - 1);
    cp_async_commit();

    const uint8_t* s = smem + (st % S::NS) * S::STAGE;
    const T* wsm = reinterpret_cast<const T*>(s);
    const MT* msm = reinterpret_cast<const MT*>(s + S::W_BYTES);
    const T* xsm = reinterpret_cast<const T*>(s + S::W_BYTES + S::M_BYTES);
    float pk[S::RK][2];
#pragma unroll
    for (int i = 0; i < S::RK; ++i) {
      const int r = kg * S::RK + i;
      const float2 wv = load2(wsm + r * TILE + 2 * pr);
      const float2 mv = load2(msm + r * TILE + 2 * pr);
      any |= (mv.x != 0.f) | (mv.y != 0.f);
      pk[i][0] = round_to<T>(wv.x * round_to<T>(mv.x));
      pk[i][1] = round_to<T>(wv.y * round_to<T>(mv.y));
    }
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      float xv[S::RK];
      load_vals<T, S::RK>(xsm + m * S::R + kg * S::RK, xv);
#pragma unroll
      for (int i = 0; i < S::RK; ++i) {
        tacc[m][0] = fmaf(xv[i], pk[i][0], tacc[m][0]);
        tacc[m][1] = fmaf(xv[i], pk[i][1], tacc[m][1]);
      }
    }
    if (st % S::CPT == S::CPT - 1) {     // the tile's last stage
      if (__syncthreads_or(any)) {       // its mask has a nonzero
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          acc[m][0] += tacc[m][0];
          acc[m][1] += tacc[m][1];
        }
      }
#pragma unroll
      for (int m = 0; m < BM; ++m) tacc[m][0] = tacc[m][1] = 0.f;
      any = false;
    }
  }

  // the K groups' sums, added in group order through shared memory
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);
  for (int g = 0; g < S::KG; ++g) {
    if (kg == g) {
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        float a = acc[m][0], b = acc[m][1];
        if (g > 0) {
          const float2 o = load2(red + m * TILE + 2 * pr);
          a = o.x + a;
          b = o.y + b;
        }
        if (g < S::KG - 1) {
          store2(red + m * TILE + 2 * pr, a, b);
        } else if (m0 + m < M) {
          const size_t row = (size_t)(m0 + m) * N + n0 + 2 * pr;
          if (ws != nullptr) store2(ws + (size_t)blockIdx.z * M * N + row, a, b);
          else store2(out + row, a, b);
        }
      }
    }
    if (g < S::KG - 1) __syncthreads();
  }
}

// out = sum over the S splits of the (S, M, N) f32 workspace, in split
// order, cast to T
template <typename T>
__global__ void __launch_bounds__(THREADS)
masked_splitk_reduce_kernel(const float* __restrict__ ws, T* __restrict__ out,
                            int S, size_t mn) {
  const size_t n4 = mn / 4;
  for (size_t i = blockIdx.x * (size_t)THREADS + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * THREADS) {
    float4 a = reinterpret_cast<const float4*>(ws)[i];
    for (int s = 1; s < S; ++s) {
      const float4 b = reinterpret_cast<const float4*>(ws + s * mn)[i];
      a.x += b.x;
      a.y += b.y;
      a.z += b.z;
      a.w += b.w;
    }
    store2(out + 4 * i, a.x, a.y);
    store2(out + 4 * i + 2, a.z, a.w);
  }
}

// ---------------------------------------------------------------------------
// 3. CUDA-core form, float32 at M >= 64
// ---------------------------------------------------------------------------
// A block owns rows m0..m0+BM of column tile j and the K tiles of split
// z; each thread a TM x TN register tile (NX threads along N, NY along
// M).  The whole 128 x 128 product tile is staged before the skip
// decision, because the skip is per (bk, bn) tile.
template <typename MT, int BM, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
masked_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const MT* __restrict__ mask, float* __restrict__ out,
                  float* __restrict__ ws, int M, int K, int N, int per) {
  constexpr int NX = TILE / TN, NY = THREADS / NX;
  static_assert(NY * TM == BM, "block rows");
  constexpr int V = 4;                   // floats per 16-byte load of w / x
  constexpr int LDX = BM + 1;
  extern __shared__ __align__(16) float smem_f[];
  float* wsm = smem_f;                   // (k, n) product tile, 128 x 128
  float* xs = smem_f + TILE * TILE;      // (k, m) x slice, 128 x LDX

  const int n0 = blockIdx.x * TILE;
  const int m0 = blockIdx.y * BM;
  const int kb0 = blockIdx.z * per * TILE;
  const int kb1 = min(kb0 + per * TILE, K);
  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

  for (int kb = kb0; kb < kb1; kb += TILE) {
    bool any = false;
    for (int e = tid; e < TILE * TILE / V; e += THREADS) {   // w and mask, every byte
      const int r = e / (TILE / V), c = (e % (TILE / V)) * V;
      const size_t off = (size_t)(kb + r) * N + n0 + c;
      float wv[V], mv[V];
      load_vals<float, V>(w + off, wv);
      any |= load_vals<MT, V>(mask + off, mv);
#pragma unroll
      for (int i = 0; i < V; ++i) wsm[r * TILE + c + i] = wv[i] * mv[i];
    }
    for (int e = tid; e < BM * TILE / V; e += THREADS) {     // x slice, transposed
      const int r = e / (TILE / V), c = (e % (TILE / V)) * V;
      const int m = m0 + r;
      float v[V];
      if (m < M) {
        load_vals<float, V>(x + (size_t)m * K + kb + c, v);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) xs[(c + i) * LDX + r] = v[i];
    }
    if (__syncthreads_or(any)) {          // the tile's mask has a nonzero
#pragma unroll 4
      for (int k = 0; k < TILE; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int a = 0; a < TM; ++a) av[a] = xs[k * LDX + ty + a * NY];
#pragma unroll
        for (int b = 0; b < TN; ++b) bv[b] = wsm[k * TILE + tx + b * NX];
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int m = m0 + ty + a * NY;
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const size_t o = (size_t)m * N + n0 + tx + b * NX;
      if (ws != nullptr) ws[(size_t)blockIdx.z * M * N + o] = acc[a][b];
      else out[o] = acc[a][b];
    }
  }
}

// ---------------------------------------------------------------------------
// 2. bfloat16 at M >= 64: TMA-fed, warp-specialised, wgmma
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BM = 256;           // output rows per block (two consumers x 128)
constexpr int BN = 128;           // output columns per block (one tile)
constexpr int BKS = 64;           // K rows per stage (two stages a tile)
constexpr int THREADS = 384;      // producer warpgroup + two consumers
constexpr int ROW = 128;          // bytes per swizzled row
constexpr int ATOM = 8 * ROW;     // one 128B-swizzle atom: 8 rows
constexpr int BOX = BKS * ROW;    // one 64-row box of 128-byte rows

template <typename MT>
struct Plan {
  static constexpr int X_BYTES = BM * ROW;                 // 256 rows x 64 bf16
  static constexpr int W_BYTES = 2 * BOX;                  // 64 rows x 128 bf16
  static constexpr int M_BOXES = (int)sizeof(MT);          // boxes of 128-byte rows
  static constexpr int M_COLS = ROW / (int)sizeof(MT);     // mask columns a box
  static constexpr int M_BYTES = M_BOXES * BOX;
  static constexpr int STAGE = X_BYTES + W_BYTES + M_BYTES;
  static constexpr int FIT = (232448 - 1024 - 64) / STAGE;  // stages that fit
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int SMEM = BAR_OFF + 16 * STAGES + 1024;
  // the next tile's product is formed while this tile's wgmmas run when
  // two tiles (four stages) fit
  static constexpr bool LOOKAHEAD = STAGES >= 4;
  static_assert(STAGES >= 2 && SMEM <= 232448, "over the 227 KB a block may take");
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// returns once the phase of parity `parity` has completed; a wait that
// never ends (a TMA load that never lands) traps, so that a fault surfaces
// as a launch error instead of a hung card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (tries == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128B-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define WG_D16(i) WG_D4(i), WG_D4((i) + 4), WG_D4((i) + 8), WG_D4((i) + 12)

// d (64 x 128 f32) += A (64 x 16, smem, K-major) B (16 x 128, smem,
// MN-major: two 64-column boxes BOX bytes apart, the descriptor's
// leading byte offset)
__device__ __forceinline__ void mma_ss_n128_tb(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 1;\n}"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "l"(da), "l"(db), "r"(1));
}

#undef WG_D16
#undef WG_D4

// OR of v over the 256 consumer threads (named barrier 1); also a
// barrier among them
__device__ __forceinline__ bool consumers_or(bool v) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, 1, 256, p;\n"
      "selp.u32 %0, 1, 0, q;\n}"
      : "=r"(r) : "r"((uint32_t)v) : "memory");
  return r != 0;
}

// the eight mask values at logical (row, n..n+7) of a stage's mask boxes
// as four bf16 pairs (the reference's mask.astype(bfloat16)); returns
// whether any of them is nonzero before the rounding
__device__ __forceinline__ bool mask8(const uint8_t* ms, int row, int n,
                                      __nv_bfloat162* m) {
  const uint2 v = *reinterpret_cast<const uint2*>(ms + row * ROW + n);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = i < 2 ? v.x : v.y;
    const int sh = 16 * (i & 1);
    m[i] = __floats2bfloat162_rn(static_cast<float>((w >> sh) & 0xffu),
                                 static_cast<float>((w >> (sh + 8)) & 0xffu));
  }
  return (v.x | v.y) != 0;
}
__device__ __forceinline__ bool mask8(const __nv_bfloat16* ms, int row, int n,
                                      __nv_bfloat162* m) {
  const int box = n / 64, col = n % 64;
  const uint4 v = *reinterpret_cast<const uint4*>(ms + box * (BOX / 2) + row * 64 + col);
  *reinterpret_cast<uint4*>(m) = v;
  return ((v.x | v.y | v.z | v.w) & 0x7fff7fffu) != 0;      // -0 is zero
}
__device__ __forceinline__ bool mask8(const float* ms, int row, int n,
                                      __nv_bfloat162* m) {
  const int box = n / 32, col = n % 32;
  const float4* p = reinterpret_cast<const float4*>(ms + box * (BOX / 4) + row * 32 + col);
  const float4 a = p[0], b = p[1];
  m[0] = __floats2bfloat162_rn(a.x, a.y);
  m[1] = __floats2bfloat162_rn(a.z, a.w);
  m[2] = __floats2bfloat162_rn(b.x, b.y);
  m[3] = __floats2bfloat162_rn(b.z, b.w);
  return (a.x != 0.f) | (a.y != 0.f) | (a.z != 0.f) | (a.w != 0.f) |
         (b.x != 0.f) | (b.y != 0.f) | (b.z != 0.f) | (b.w != 0.f);
}

// w * round_bf16(mask) in place over one stage's w boxes (which TMA laid
// out 128B-swizzled: 16-byte piece pc of row r holds logical piece
// pc ^ (r % 8)), as bf16 pair products (one rounding of the exact
// product, as the reference's bf16 multiply); t is the consumer
// thread, 0..255.  Returns whether any of this thread's mask values is
// nonzero.
template <typename MT>
__device__ __forceinline__ bool form_product(uint8_t* wsm, const MT* msm, int t) {
  bool any = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = t + 256 * j;                     // 16-byte piece, 0..1023
    const int box = c >> 9, row = (c >> 3) & 63, pc = c & 7;
    const int n = box * 64 + ((pc ^ (row & 7)) << 3);
    uint4* wp = reinterpret_cast<uint4*>(wsm + box * BOX + row * ROW + pc * 16);
    uint4 v = *wp;
    __nv_bfloat162 m[4];
    any |= mask8(msm, row, n, m);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __hmul2(h[i], m[i]);
    *wp = v;
  }
  return any;
}

template <typename MT>
__global__ void __launch_bounds__(THREADS, 1)
masked_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap mmap,
                    __nv_bfloat16* __restrict__ out, int M, int K, int N) {
  using P = Plan<MT>;
  constexpr int ST = P::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);              // the same, generic
  const uint32_t full_bar = base + P::BAR_OFF;           // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * ST;          // + 8 * stage

  const int m0 = blockIdx.x * BM;          // row tiles fastest: one w column
  const int n0 = blockIdx.y * BN;          // at a time comes from the L2
  const int nst = K / BKS;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 2 * 128);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the TMA ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x == 0) {
      for (int g = 0; g < nst; ++g) {
        const int s = g % ST;
        if (g >= ST) mbar_wait(empty_bar + 8 * s, ((g / ST) & 1) ^ 1);
        const uint32_t fb = full_bar + 8 * s;
        const uint32_t st = base + s * P::STAGE;
        mbar_expect_tx(fb, P::STAGE);
        tma_load_2d(st, &xmap, fb, g * BKS, m0);
        tma_load_2d(st + P::X_BYTES, &wmap, fb, n0, g * BKS);
        tma_load_2d(st + P::X_BYTES + BOX, &wmap, fb, n0 + 64, g * BKS);
#pragma unroll
        for (int b = 0; b < P::M_BOXES; ++b)
          tma_load_2d(st + P::X_BYTES + P::W_BYTES + b * BOX, &mmap, fb,
                      n0 + b * P::M_COLS, g * BKS);
      }
    }
  } else {
    // ---- consumers: 128 output rows each, two 64-row slices ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int t = threadIdx.x - 128;
    const int cw = t / 128;                      // consumer 0 or 1
    const int warp = (t % 128) / 32;
    const int lane = t % 32;

    float d[2][64];                              // two slices x 128 columns
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) d[h][i] = 0.f;

    // wait for tile i's two stages, form their products, vote
    auto prepare = [&](int i) -> bool {
      bool any = false;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int g = 2 * i + u, s = g % ST;
        mbar_wait(full_bar + 8 * s, (g / ST) & 1);
        uint8_t* st = gbase + s * P::STAGE;
        any |= form_product<MT>(st + P::X_BYTES,
                                reinterpret_cast<const MT*>(st + P::X_BYTES + P::W_BYTES), t);
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      return consumers_or(any);
    };
    auto issue = [&](int i) {
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const uint32_t st = base + ((2 * i + u) % ST) * P::STAGE;
        const uint32_t xa = st + cw * 128 * ROW;
        const uint32_t wb = st + P::X_BYTES;
#pragma unroll
        for (int kk = 0; kk < BKS / 16; ++kk) {
          const uint64_t db = desc_sw128(wb + kk * 16 * ROW, BOX, ATOM);
#pragma unroll
          for (int sl = 0; sl < 2; ++sl)
            mma_ss_n128_tb(d[sl], desc_sw128(xa + sl * 64 * ROW + kk * 32, 16, ATOM), db);
        }
      }
      wgmma_commit();
    };
    auto release = [&](int i) {
      mbar_arrive(empty_bar + 8 * ((2 * i) % ST));
      mbar_arrive(empty_bar + 8 * ((2 * i + 1) % ST));
    };

    const int ntiles = nst / 2;
    bool live = prepare(0);
    for (int i = 0; i < ntiles; ++i) {
      const bool ahead = P::LOOKAHEAD && i + 1 < ntiles;
      bool next = false;
      if (live) {                 // issue and wait on one straight path
        issue(i);
        if (ahead) next = prepare(i + 1);
        wgmma_wait0();
        fence_regs(d[0]);
        fence_regs(d[1]);
      } else if (ahead) {
        next = prepare(i + 1);
      }
      release(i);
      if (!P::LOOKAHEAD && i + 1 < ntiles) next = prepare(i + 1);
      live = next;
    }

    const int cq = (lane % 4) * 2;               // columns cq, cq + 1 of each 8
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      const int r0 = m0 + cw * 128 + sl * 64 + warp * 16 + lane / 4;   // rows r0, r0 + 8
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + cq;
        if (r0 < M) store2(out + (size_t)r0 * N + col, d[sl][4 * j], d[sl][4 * j + 1]);
        if (r0 + 8 < M)
          store2(out + (size_t)(r0 + 8) * N + col, d[sl][4 * j + 2], d[sl][4 * j + 3]);
      }
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library links against cudart only
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

constexpr int ENCODE_FAILED = 10000;   // + CUresult; see kernel_error_string

// a row-major (rows, cols) matrix as a 2-D map read in boxes of
// box_cols x box_rows, zero-filled out of bounds
int make_map(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
             int elem, int rows, int cols, int box_cols, int box_rows,
             CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return ENCODE_FAILED + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(ptr), dims, strides,
                            box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

template <typename MT> constexpr CUtensorMapDataType map_type() {
  if constexpr (std::is_same<MT, float>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  else if constexpr (std::is_same<MT, __nv_bfloat16>::value) return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  else return CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

template <typename MT>
int launch(const void* x, const void* w, const void* mask, void* out, int M,
           int K, int N, cudaStream_t s) {
  using P = Plan<MT>;
  CUtensorMap xm, wm, mm;
  int e = make_map(&xm, x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, M, K, 64, BM,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0)
    e = make_map(&wm, w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, K, N, 64, BKS,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (e == 0)
    e = make_map(&mm, mask, map_type<MT>(), sizeof(MT), K, N, P::M_COLS, BKS,
                 CU_TENSOR_MAP_SWIZZLE_NONE);
  if (e != 0) return e;
  auto kernel = masked_wgmma_kernel<MT>;
  static bool ready = false;             // once, so graph capture calls only the kernel
  if (!ready) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
    if (a != cudaSuccess) return a;
    ready = true;
  }
  dim3 grid((M + BM - 1) / BM, N / BN);
  kernel<<<grid, THREADS, P::SMEM, s>>>(xm, wm, mm,
                                        static_cast<__nv_bfloat16*>(out), M, K, N);
  return cudaGetLastError();
}

}  // namespace wg

// Raise a kernel's dynamic shared-memory limit past 48 KB, once per
// kernel (the flag is the caller's static), so that launches made while
// a CUDA graph captures the stream call nothing but the kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  done = err == cudaSuccess;
  return err;
}

template <typename T, typename MT, int BM>
cudaError_t launch_stream(const T* x, const T* w, const MT* m, T* out, float* ws,
                          int M, int K, int N, int per, int splits, cudaStream_t s) {
  using S = Stream<T, MT, BM>;
  static bool ready = false;
  auto kernel = masked_stream_kernel<T, MT, BM>;
  const cudaError_t err = allow_smem(kernel, S::SMEM, ready);
  if (err != cudaSuccess) return err;
  dim3 grid(N / TILE, (M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, S::SMEM, s>>>(x, w, m, out, ws, M, K, N, per);
  return cudaGetLastError();
}

template <typename MT>
cudaError_t launch_fma(const float* x, const float* w, const MT* m, float* out,
                       float* ws, int M, int K, int N, int per, int splits,
                       cudaStream_t s) {
  constexpr int BM = 64;
  static bool ready = false;
  auto kernel = masked_fma_kernel<MT, BM, 4, 8>;
  const size_t smem = (TILE * TILE + TILE * (BM + 1)) * sizeof(float);
  const cudaError_t err = allow_smem(kernel, smem, ready);
  if (err != cudaSuccess) return err;
  dim3 grid(N / TILE, (M + BM - 1) / BM, splits);
  kernel<<<grid, THREADS, smem, s>>>(x, w, m, out, ws, M, K, N, per);
  return cudaGetLastError();
}

enum Route { STREAM = 0, FMA = 1, WGMMA = 2 };

template <typename T, typename MT>
int launch(const void* x, const void* w, const void* mask, void* out, void* ws,
           int M, int K, int N, int route, int per, int splits, cudaStream_t s) {
  if (route == WGMMA) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return wg::launch<MT>(x, w, mask, out, M, K, N, s);
    return cudaErrorInvalidValue;
  }
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const MT* mp = static_cast<const MT*>(mask);
  T* op = static_cast<T*>(out);
  float* wsp = splits > 1 ? static_cast<float*>(ws) : nullptr;
  cudaError_t err;
  if (route == STREAM) {
    if (M <= 8) err = launch_stream<T, MT, 8>(xp, wp, mp, op, wsp, M, K, N, per, splits, s);
    else err = launch_stream<T, MT, 32>(xp, wp, mp, op, wsp, M, K, N, per, splits, s);
  } else if constexpr (std::is_same<T, float>::value) {
    err = launch_fma<MT>(xp, wp, mp, op, wsp, M, K, N, per, splits, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const size_t blocks = (mn / 4 + THREADS - 1) / THREADS;
  masked_splitk_reduce_kernel<T><<<(unsigned)(blocks < 1056 ? blocks : 1056), THREADS, 0, s>>>(
      wsp, op, splits, mn);
  return cudaGetLastError();
}

template <typename T>
int launch_mask(const void* x, const void* w, const void* mask, void* out,
                void* ws, int M, int K, int N, int mask_dtype, int route,
                int per, int splits, cudaStream_t s) {
  if (mask_dtype == 0)
    return launch<T, float>(x, w, mask, out, ws, M, K, N, route, per, splits, s);
  if (mask_dtype == 1)
    return launch<T, __nv_bfloat16>(x, w, mask, out, ws, M, K, N, route, per, splits, s);
  if (mask_dtype == 2)
    return launch<T, uint8_t>(x, w, mask, out, ws, M, K, N, route, per, splits, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, K), w (K, N), mask (K, N) and out (M, N) contiguous and 16-byte
// aligned; K and N multiples of 128.  dtype (x, w, out): 0 = float32,
// 1 = bfloat16; mask_dtype: 0 = float32, 1 = bfloat16, 2 = one byte
// (bool / uint8).  route (bsmm.masked_route): 0 = split-K streaming (M <
// 64), 1 = CUDA-core FMA (float32 only), 2 = wgmma (bfloat16 only, one
// split).  The K
// tiles are cut into `splits` runs of `per` tiles (the last may be
// shorter, none empty); with splits > 1, ws is an f32 (splits, M, N)
// workspace and a second kernel sums it in split order.  Returns 0, a
// cudaError_t, or 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int masked_matmul_launch(const void* x, const void* w,
                                    const void* mask, void* out, void* ws,
                                    int M, int K, int N, int dtype,
                                    int mask_dtype, int route, int per,
                                    int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kt = K / TILE;
  if (M <= 0 || K <= 0 || N <= 0 || K % TILE || N % TILE) return cudaErrorInvalidValue;
  if (per <= 0 || splits <= 0 || per * (splits - 1) >= kt || per * splits < kt)
    return cudaErrorInvalidValue;
  if ((route == STREAM && M >= 64) || (route == WGMMA && (dtype != 1 || splits != 1)) ||
      (route == FMA && dtype != 0) ||
      route < STREAM || route > WGMMA || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_mask<float>(x, w, mask, out, ws, M, K, N, mask_dtype, route, per, splits, s);
  if (dtype == 1)
    return launch_mask<__nv_bfloat16>(x, w, mask, out, ws, M, K, N, mask_dtype, route, per,
                                      splits, s);
  return cudaErrorInvalidValue;
}

// dynamic shared memory of the wgmma kernel for a mask of mask_dtype
extern "C" int masked_matmul_wgmma_smem(int mask_dtype) {
  if (mask_dtype == 0) return wg::Plan<float>::SMEM;
  if (mask_dtype == 1) return wg::Plan<__nv_bfloat16>::SMEM;
  if (mask_dtype == 2) return wg::Plan<uint8_t>::SMEM;
  return 0;
}

extern "C" const char* kernel_error_string(int code) {
  if (code >= wg::ENCODE_FAILED) return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
