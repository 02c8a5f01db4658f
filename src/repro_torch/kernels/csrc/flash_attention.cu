// Flash attention (causal or full, grouped-query) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (called by flash_attention there):
//
//   q (B, S, Hq, hd), k (B, S, Hkv, hd), v (B, S, Hkv, dv)  ->  out (B, S, Hq, dv)
//
// Scores q . k times 1/sqrt(hd) (scale of q's width), masked positions set
// to the finite -1e30, the softmax streamed over key tiles with a running
// max m, sum l and accumulator acc in f32, and the output acc / max(l,
// 1e-30) in q's type.  Query head h reads KV head h / (Hq / Hkv): grouped
// keys are never materialised.  Beyond the TPU kernel's grid both kernels
// below take any S >= 1 (ragged query and key tiles are masked, not
// asserted away) and a value width dv <= hd (MLA prefill: hd = 192, dv =
// 128; recurrentgemma's local attention: hd = dv = 256).  Causal blocks stop at the diagonal key tile (the fully masked
// tiles past it are skipped, as pl.when skips them on the TPU), and the
// grid runs the late (longest) query tiles first.  Two kernels, chosen by
// dtype in the open (the wrapper never falls back from one to the other):
//
// 1. flash_attention_kernel<NC>: float32 operands (the reference
//    computes f32 throughout and the f32 gate is 1e-4, which a tensor-core
//    route in TF32 or bf16 would break).  One block per (64-row query tile,
//    query head, batch row), 256 threads.  The q tile sits in shared memory
//    (transposed, f32); each key tile of 64 rows is staged as f32, each
//    thread computes a 4 x 4 piece of the 64 x 64 score tile on the CUDA
//    cores, the row max and sum are reduced over the 16 threads that share
//    four rows, p goes back to shared memory, and each thread accumulates 4
//    rows x NC value columns of p @ v in registers.  Bound on the H100 by
//    the CUDA cores' 67 TFLOP/s f32 rate.
//
// 2. flash_attention_wgmma_kernel<HC, DC, BK>: bfloat16 operands, the
//    serving path.  One block per (128-row query tile, query head, batch
//    row), 3 warpgroups:
//    - warpgroup 0, the producer, drops to 40 registers (setmaxnreg); one
//      thread issues the TMA loads: the q tile once, then K and V tiles of
//      BK keys into a ring of 2 stages, each stage guarded by a "full" and
//      an "empty" mbarrier;
//    - warpgroups 1 and 2, the consumers, rise to 232 registers and own 64
//      query rows each.  Per key tile: s = q k^T by wgmma (m64nBKk16, both
//      operands in 128-byte-swizzled shared memory, K-major), the scale and
//      mask (only on the diagonal tile and the ragged last tile), the row
//      max over the 4 threads of the accumulator's quad, p = exp2(s - m)
//      converted to bf16 in registers, and acc += p v by wgmma with p as
//      the register A operand and V the transposed (MN-major) B operand
//      read in its natural (key, dv) layout; then the stage goes back to
//      the producer.  The epilogue divides by l and writes rows < S only.
//    Tensor maps are 4-D, (d, head, S, B), built on the host per launch
//    (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint so
//    that the library needs no -lcuda) and passed as __grid_constant__
//    parameters.  TMA's out-of-bounds zero fill pads a ragged S inside its
//    own batch row (it never reads the next row's tokens) and pads hd and
//    dv up to whole 64-column chunks, so one kernel serves every width.
//
// Numerics contract of the bf16 kernel (the f32 kernel's is the
// reference's):
//   - s = q k^T on wgmma, bf16 operands and an f32 accumulator: bf16 x bf16
//     products are exact in f32, so s equals the reference's products up to
//     the order of the sums;
//   - the scale carries log2(e) (scale_log2 = log2(e) / sqrt(hd)) so that
//     p = exp2(s * scale_log2 - m) and alpha = exp2(m_old - m_new) run on
//     ex2.approx (relative error ~2^-22); m, l, alpha and p are f32 registers;
//   - l sums the unrounded f32 p (per thread, reduced over the quad at the
//     end);
//   - p is rounded to bf16 for p @ v (round to nearest even), as the
//     reference's Pallas kernel does for bf16 operands (p.astype(v.dtype),
//     flash_attention.py:99); the port's plain version keeps p in f32, and
//     the bf16 gate of 1e-2 of the output scale against it is unchanged;
//   - a row's sums run in one order whatever B, Hq or the other rows hold.
//
// Shared memory of the bf16 kernel (bytes; 1024-aligned swizzle atoms,
// plus 1 KB alignment slack and the barriers):
//   q: HC x 128 rows x 128 B, K and V per stage: HC (DC) x BK rows x 128 B
//   hd 128, dv 128 (llama):     BK 128: 32 + 2 (32 + 32) = 160 KB
//   hd 192, dv 128 (MLA):       BK 128: 48 + 2 (48 + 32) = 208 KB
//   hd 192, dv 192:             BK  64: 48 + 2 (24 + 24) = 144 KB
//   hd 256, dv <= 192:          BK  64: 64 + 2 (32 + 24) = 176 KB at most
//   hd 256, dv 256:             BK  64: 64 + 2 (32 + 32) = 192 KB
//   hd <= 64 (the tests' 64/32): BK 128: 16 + 2 (16 + 16) =  80 KB
// all under the 227 KB one block may take; one block per SM.  At dv 256
// each consumer thread holds a 64 x 256 f32 O accumulator (128 registers)
// beside the 32 of s and 16 of p, inside the 232 that setmaxnreg gives it;
// the build log's -Xptxas=-v line says whether it spills.
//
// What bounds it on the H100: at prefill lengths 4 S^2 hd Hq / 2 flops
// (causal) against ~(2 hd + dv) S Hkv + dv S Hq bytes, far above the
// card's ridge, so the tensor cores' 989 TFLOP/s bf16 rate bounds it.
// This first wgmma kernel overlaps loads with compute (TMA ring) and the
// two consumers with each other, but not a warpgroup's softmax with its
// own products (no intra-warpgroup ping-pong): its time against the bound
// is in PERF.md.
#include <cuda.h>           // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // key rows per tile
constexpr int THREADS = 256;
constexpr int RM = 4;             // query rows per thread
constexpr int CN = 4;             // score columns per thread
constexpr int LD = 68;            // row stride (floats) of the transposed q/k
                                  // tiles and of p: 16-byte aligned rows, and
                                  // the two half-warps' rows 16 banks apart
constexpr float NEG = -1e30f;     // finite mask value, as the reference's NEG_INF

// reductions over the 16 lanes (one half-warp) that share a row group
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// value column of accumulator slot c of thread tx: pairs of neighbouring
// columns, the 16 threads of a row group side by side, so that a
// half-warp's float2 reads of a V row are one contiguous 128-byte run
__device__ __forceinline__ int vcol(int tx, int c) { return 2 * tx + (c & 1) + 32 * (c >> 1); }

template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out, int S,
                       int Hq, int Hkv, int hd, int dv, float scale,
                       int causal) {
  constexpr int VLD = 16 * NC;      // V tile row stride: every slot's column
  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid % 16;          // score columns tx*4.., value slots vcol(tx, .)
  const int ty = tid / 16;          // query rows ty*4 .. ty*4+3
  const int q0 = qt * BQ;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                 // (hd, LD) q tile, transposed
  float* ks = qs + hd * LD;         // (hd, LD) k tile, transposed
  float* ps = ks + hd * LD;         // (BQ, LD) probabilities
  float* vs = ps + BQ * LD;         // (BK, VLD) v tile, columns >= dv zero

  for (int e = tid; e < BQ * hd; e += THREADS) {
    const int r = e / hd, d = e - r * hd;
    const int s = q0 + r;
    qs[d * LD + r] = s < S ? q[(((size_t)b * S + s) * Hq + h) * hd + d] : 0.f;
  }
  for (int e = tid; e < BK * VLD; e += THREADS) vs[e] = 0.f;

  float m[RM], l[RM], acc[RM][NC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int nkt = (S + BK - 1) / BK;
  if (causal) nkt = min(nkt, qt + 1);    // BQ == BK: later tiles fully masked
  const size_t row0 = (size_t)b * S;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                // the previous tile's readers are done
    for (int e = tid; e < BK * hd; e += THREADS) {
      const int r = e / hd, d = e - r * hd;
      const int s = k0 + r;
      ks[d * LD + r] = s < S ? k[((row0 + s) * Hkv + hk) * hd + d] : 0.f;
    }
    for (int e = tid; e < BK * dv; e += THREADS) {
      const int r = e / dv, d = e - r * dv;
      const int s = k0 + r;
      vs[r * VLD + d] = s < S ? v[((row0 + s) * Hkv + hk) * dv + d] : 0.f;
    }
    __syncthreads();

    // scores: a 4 x 4 piece of q k^T per thread
    float sc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + d * LD + ty * RM);
      const float4 ka = *reinterpret_cast<const float4*>(ks + d * LD + tx * CN);
      const float qv[RM] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[CN] = {ka.x, ka.y, ka.z, ka.w};
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // scale, mask, streaming softmax update
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int qi = q0 + ty * RM + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int kj = k0 + tx * CN + j;
        float val = sc[i][j] * scale;
        if (kj >= S || (causal && kj > qi)) val = NEG;
        sc[i][j] = val;
        mx = fmaxf(mx, val);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      sum = group_sum(sum);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      *reinterpret_cast<float4*>(ps + (ty * RM + i) * LD + tx * CN) =
          make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
    }
    __syncthreads();

    // acc += p @ v, four keys at a time
    for (int kk = 0; kk < BK; kk += 4) {
      float4 pa[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (ty * RM + i) * LD + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (kk + u) * VLD;
#pragma unroll
        for (int c = 0; c < NC; c += 2) {
          const float2 vv = *reinterpret_cast<const float2*>(vrow + vcol(tx, c));
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y : u == 2 ? pa[i].z : pa[i].w;
            acc[i][c] = fmaf(p, vv.x, acc[i][c]);
            acc[i][c + 1] = fmaf(p, vv.y, acc[i][c + 1]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int qi = q0 + ty * RM + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = out + ((row0 + qi) * Hq + h) * dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = vcol(tx, c);
      if (col < dv) orow[col] = acc[i][c] / den;
    }
  }
}

template <int NC>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       float* out, int B, int S, int Hq, int Hkv, int hd,
                       int dv, float scale, int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * hd * LD + (size_t)BQ * LD +
                                       (size_t)BK * 16 * NC);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<NC><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, S, Hq, Hkv, hd, dv, scale, causal);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The bf16 kernel: TMA-fed, warp-specialised, both products on wgmma
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BQ = 128;           // query rows per block (two consumers x 64)
constexpr int THREADS = 384;      // producer warpgroup + two consumers
constexpr int CHUNK = 64;         // bf16 columns per 128-byte swizzled row
constexpr int ROW = 128;          // bytes per swizzled row
constexpr int STAGES = 2;
constexpr int ATOM = 8 * ROW;     // one 128B-swizzle atom: 8 rows
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
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
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i]) :: "memory");
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3])
#define WG_D16(i) WG_D4(i), WG_D4((i) + 4), WG_D4((i) + 8), WG_D4((i) + 12)

// d (64 x 64 f32) (+)= A (64 x 16, smem) B (16 x 64, smem), both K-major
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_D16(0), WG_D16(16)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 128 f32) (+)= A (64 x 16, smem) B (16 x 128, smem), both K-major
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A (64 x 16 bf16, registers) B (16 x 64, smem, MN-major)
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t* a,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : WG_D16(0), WG_D16(16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D16
#undef WG_D4

template <int BK>
__device__ __forceinline__ void mma_ss(float (&d)[BK / 2], uint64_t da,
                                       uint64_t db, int accumulate) {
  if constexpr (BK == 128) mma_ss_n128(d, da, db, accumulate);
  else mma_ss_n64(d, da, db, accumulate);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// shared-memory plan of one block (offsets from a 1024-aligned base)
template <int HC, int DC, int BK>
struct Plan {
  static constexpr int Q_BYTES = HC * BQ * ROW;
  static constexpr int K_BYTES = HC * BK * ROW;      // one stage
  static constexpr int V_BYTES = DC * BK * ROW;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * K_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * V_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(SMEM <= 232448, "over the 227 KB a block may take");
};

// HC (DC): 64-column chunks of hd (dv); BK: keys per tile
template <int HC, int DC, int BK>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ out, int S, int Hq,
                             int Hkv, int dv, float scale_log2, int causal) {
  using P = Plan<HC, DC, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + P::K_OFF, sV = base + P::V_OFF;
  const uint32_t q_bar = base + P::BAR_OFF;
  const uint32_t full_bar = q_bar + 8;                  // + 8 * stage
  const uint32_t empty_bar = full_bar + 8 * STAGES;     // + 8 * stage

  const int qt = gridDim.x - 1 - blockIdx.x;   // longest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int q0 = qt * BQ;
  int nkt = (S + BK - 1) / BK;
  if (causal) nkt = min(nkt, (q0 + BQ + BK - 1) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
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
      mbar_expect_tx(q_bar, P::Q_BYTES);
#pragma unroll
      for (int c = 0; c < HC; ++c)
        tma_load_4d(sQ + c * BQ * ROW, &qmap, q_bar, c * CHUNK, h, q0, b);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty_bar + 8 * s, ((kt / STAGES) & 1) ^ 1);
        const uint32_t fb = full_bar + 8 * s;
        mbar_expect_tx(fb, P::K_BYTES + P::V_BYTES);
#pragma unroll
        for (int c = 0; c < HC; ++c)
          tma_load_4d(sK + s * P::K_BYTES + c * BK * ROW, &kmap, fb, c * CHUNK,
                      hk, kt * BK, b);
#pragma unroll
        for (int c = 0; c < DC; ++c)
          tma_load_4d(sV + s * P::V_BYTES + c * BK * ROW, &vmap, fb, c * CHUNK,
                      hk, kt * BK, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int t = threadIdx.x - 128;
    const int cw = t / 128;                      // consumer 0 or 1
    const int warp = (t % 128) / 32;
    const int lane = t % 32;
    const int wrow0 = q0 + cw * 64;              // the consumer's first row
    const int r0 = wrow0 + warp * 16 + lane / 4; // this thread's rows r0, r0 + 8
    const int cq = (lane % 4) * 2;               // and columns cq, cq + 1 of each 8
    const uint32_t qa = sQ + cw * 64 * ROW;

    float o[DC][32];
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
    float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;

    mbar_wait(q_bar, 0);
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(full_bar + 8 * s, (kt / STAGES) & 1);
      const uint32_t ks = sK + s * P::K_BYTES;
      const uint32_t vs = sV + s * P::V_BYTES;

      // s = q k^T over hd in steps of 16
      float sc[BK / 2];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < HC; ++c)
#pragma unroll
        for (int kk = 0; kk < CHUNK / 16; ++kk)
          mma_ss<BK>(sc, desc_sw128(qa + c * BQ * ROW + kk * 32, 16, ATOM),
                     desc_sw128(ks + c * BK * ROW + kk * 32, 16, ATOM),
                     (c | kk) != 0);
      wgmma_commit();
      wgmma_wait0();
      fence_regs(sc);

      // scale into the exp2 domain; mask the diagonal and ragged tiles
      const int k0 = kt * BK;
      const bool masked = k0 + BK > S || (causal && k0 + BK - 1 > wrow0);
      float mx0 = NEG, mx1 = NEG;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        float x = sc[i] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * (i / 4) + cq + (i & 1);
          const int row = (i & 2) ? r0 + 8 : r0;
          if (key >= S || (causal && key > row)) x = NEG;
        }
        sc[i] = x;
        if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
      }
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;

      // p in f32 for l, rounded to bf16 pairs as the A operand of p @ v
      uint32_t pa[BK / 4];
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const float mm = (i & 2) ? mn1 : mn0;
        const float e0 = ex2(sc[i] - mm), e1 = ex2(sc[i + 1] - mm);
        if (i & 2) ls1 += e0 + e1; else ls0 += e0 + e1;
        pa[i / 2] = pack_bf16(e0, e1);
      }
      l0 = l0 * a0 + ls0;
      l1 = l1 * a1 + ls1;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[c][i] *= (i & 2) ? a1 : a0;

      // o += p v over the tile's keys in steps of 16
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int c = 0; c < DC; ++c)
          mma_rs_n64(o[c], pa + 4 * kk,
                     desc_sw128(vs + c * BK * ROW + kk * 16 * ROW, ATOM, ATOM));
      wgmma_commit();
      wgmma_wait0();
#pragma unroll
      for (int c = 0; c < DC; ++c) fence_regs(o[c]);
      fence_regs(pa);
      mbar_arrive(empty_bar + 8 * s);
    }

    const float inv0 = 1.f / fmaxf(quad_sum(l0), 1e-30f);
    const float inv1 = 1.f / fmaxf(quad_sum(l1), 1e-30f);
    const size_t rs = (size_t)Hq * dv;           // output row stride
    __nv_bfloat16* o0 = out + ((size_t)b * S + r0) * rs + (size_t)h * dv;
    __nv_bfloat16* o1 = o0 + 8 * rs;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c * CHUNK + 8 * j + cq;
        if (col >= dv) continue;
        if (r0 < S)
          *reinterpret_cast<__nv_bfloat162*>(o0 + col) = __floats2bfloat162_rn(
              o[c][4 * j] * inv0, o[c][4 * j + 1] * inv0);
        if (r0 + 8 < S)
          *reinterpret_cast<__nv_bfloat162*>(o1 + col) = __floats2bfloat162_rn(
              o[c][4 * j + 2] * inv1, o[c][4 * j + 3] * inv1);
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

// a (B, S, H, d) bf16 tensor as a 4-D map (d, H, S, B) read in boxes of
// 64 columns x `rows` rows of one head, 128B-swizzled, zero-filled out of
// bounds
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int d,
             int rows) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return ENCODE_FAILED + CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)H * d * 2,
                                 (cuuint64_t)S * H * d * 2};
  const cuuint32_t box[4] = {(cuuint32_t)CHUNK, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                            const_cast<void*>(ptr), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

template <int HC, int DC, int BK>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int Hq, int Hkv, int hd, int dv, float scale,
           int causal, cudaStream_t stream) {
  using P = Plan<HC, DC, BK>;
  CUtensorMap qm, km, vm;
  int e = make_map(&qm, q, B, S, Hq, hd, BQ);
  if (e == 0) e = make_map(&km, k, B, S, Hkv, hd, BK);
  if (e == 0) e = make_map(&vm, v, B, S, Hkv, dv, BK);
  if (e != 0) return e;
  auto kernel = flash_attention_wgmma_kernel<HC, DC, BK>;
  const cudaError_t a = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (a != cudaSuccess) return a;
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kernel<<<grid, THREADS, P::SMEM, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(out), S, Hq, Hkv, dv,
      scale * LOG2E, causal);
  return cudaGetLastError();
}

// the instantiations (HC, DC, BK): BK 128 where two stages of 128 keys fit
#define WG_GEOMETRIES(X) \
  X(1, 1, 128) X(2, 1, 128) X(2, 2, 128) X(3, 1, 128) X(3, 2, 128) \
  X(3, 3, 64) X(4, 1, 64) X(4, 2, 64) X(4, 3, 64) X(4, 4, 64)

int launch_geometry(const void* q, const void* k, const void* v, void* out,
                    int B, int S, int Hq, int Hkv, int hd, int dv, float scale,
                    int causal, cudaStream_t st) {
  const int hc = (hd + CHUNK - 1) / CHUNK, dc = (dv + CHUNK - 1) / CHUNK;
#define WG_LAUNCH(H, D, K) \
  if (hc == H && dc == D) return launch<H, D, K>(q, k, v, out, B, S, Hq, Hkv, hd, dv, scale, causal, st);
  WG_GEOMETRIES(WG_LAUNCH)
#undef WG_LAUNCH
  return cudaErrorInvalidValue;
}

int smem_bytes(int hd, int dv) {
  const int hc = (hd + CHUNK - 1) / CHUNK, dc = (dv + CHUNK - 1) / CHUNK;
#define WG_SMEM(H, D, K) \
  if (hc == H && dc == D) return Plan<H, D, K>::SMEM;
  WG_GEOMETRIES(WG_SMEM)
#undef WG_SMEM
  return 0;
}

#undef WG_GEOMETRIES

}  // namespace wg

}  // namespace

// float32 operands: the CUDA-core kernel.  The wrapper checks what it
// needs: contiguous (B, S, H, d) operands, S >= 1, Hq % Hkv == 0, 1 <= dv
// <= hd <= 256 (so that the (2 hd + 64) x 68 + 64 x 16 ceil(dv / 16)
// floats of shared memory fit in the 227 KB a block may take: 222,208
// bytes at hd = dv = 256).  Returns cudaGetLastError().
extern "C" int flash_attention_f32_launch(const void* q, const void* k,
                                          const void* v, void* out, int B,
                                          int S, int Hq, int Hkv, int hd,
                                          int dv, float scale, int causal,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(out);
  if (dv <= 32) return launch_f32<2>(fq, fk, fv, fo, B, S, Hq, Hkv, hd, dv, scale, causal, s);
  if (dv <= 64) return launch_f32<4>(fq, fk, fv, fo, B, S, Hq, Hkv, hd, dv, scale, causal, s);
  if (dv <= 128) return launch_f32<8>(fq, fk, fv, fo, B, S, Hq, Hkv, hd, dv, scale, causal, s);
  if (dv <= 192) return launch_f32<12>(fq, fk, fv, fo, B, S, Hq, Hkv, hd, dv, scale, causal, s);
  if (dv <= 256) return launch_f32<16>(fq, fk, fv, fo, B, S, Hq, Hkv, hd, dv, scale, causal, s);
  return cudaErrorInvalidValue;
}

// bfloat16 operands: the wgmma kernel.  On top of the f32 route's rules
// the wrapper checks TMA's (flash_attention.wgmma_geometry): 16-byte
// aligned bases and hd, dv multiples of 8 elements, so that every stride
// of the 4-D maps is a multiple of 16 bytes.  Returns 0, a cudaError_t,
// or 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int flash_attention_bf16_launch(const void* q, const void* k,
                                           const void* v, void* out, int B,
                                           int S, int Hq, int Hkv, int hd,
                                           int dv, float scale, int causal,
                                           void* stream) {
  return wg::launch_geometry(q, k, v, out, B, S, Hq, Hkv, hd, dv, scale,
                             causal, static_cast<cudaStream_t>(stream));
}

// the bf16 kernel's dynamic shared memory (bytes) at (hd, dv); 0 where
// no instantiation takes it
extern "C" int flash_attention_bf16_smem(int hd, int dv) {
  return wg::smem_bytes(hd, dv);
}

extern "C" const char* kernel_error_string(int code) {
  if (code >= wg::ENCODE_FAILED) return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
