// Paged decode attention for Hopper (sm_90a), in both of the
// reference's forms.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/paged_attention.py:
//   _paged_kernel_kv (grouped-query form: values from their own pool) and
//   _paged_kernel (fused-V form of absorbed MLA: the values are the first
//   dv lanes of each key row, the pool holding concat(c_kv, k_rope)).
//
//   q (B, Hq, hd), k_pool (P, T, Hkv, hd), v_pool (P, T, Hkv, dv) or, fused,
//   none; tables (B, NB), lengths (B,) >= 1  ->  out (B, Hq, dv)
//
// Split-KV ("flash-decoding"): the grid is (Hkv x head groups, B, NB).
// Block (h, b, j) takes logical block j of sequence b for one group of
// at most GB of the G = Hq / Hkv query heads of KV head h; it exits at
// once if j >= ceil(len_b / T), so table entries past the live blocks
// (the engine points them at scratch block 0) are never touched.  Over
// the live rows of pool[tables[b, j]] it computes, in f32, the scores
// q . k times `scale`, their max m_j, the sum l_j of exp(s - m_j) and
// acc_j = exp(s - m_j) @ v, and writes (acc_j, m_j, l_j) to an f32
// workspace (B, Hq, NB, dv + 2).  paged_attention_combine_kernel, one
// block per (query head, sequence), merges the live partials in j order
// (m = max m_j, l = sum l_j e^(m_j - m), acc = sum acc_j e^(m_j - m)) and
// writes acc / l in q's type.  The split is a fixed chunk of T tokens and
// the merge order is fixed, so a row's bits depend on its own length and
// contents only, never on the batch around it (greedy streams survive a
// swap or a failover through that).  The grid needs no read of `lengths`
// on the host, so a launch can be captured in a CUDA graph.  Rows past
// len inside the last live block are never read into a product.
//
// Two kernels compute the partials (paged_attention.fused_route picks,
// on the host; the wrapper never falls back from one to the other):
//
// A. paged_attention_split_kernel (route "simt"): the GQA form (#6), and
//    the fused form in float32 or at geometries route B does not take.
// B. paged_attention_fused_wgmma_kernel (route "wgmma"): the fused form
//    in bfloat16 when the query heads per KV head are a multiple of 64,
//    hd a multiple of 64 up to 576, dv a multiple of 128 up to 512 and
//    T = 128 (deepseek-v3: G = 128, hd = 576 = 512 + 64, dv = 512).
//
// Route A, per block: (0) the GQA form puts the live K and V rows of its pool block
// in flight at once (cp.async.cg, 16 bytes a piece: 32 KB each for llama's
// T = 128, hd = 128 in bf16) while q is staged, then (1) scores, eight
// threads per key row, summed with three shuffles; (2) max and exp-sum,
// one warp per query head; (3) p @ v, threads along pairs of value dims
// and TG token groups (TG = THREADS / (dv / 2) rounded down: at dv = 96,
// phi-3's head width, 5 groups of 48 threads and 16 threads idle in that
// pass), partial sums combined through shared memory in a fixed order.
// The fused (MLA) form's rows are 576 lanes wide: a staged block would
// not fit beside its state, so it reads K/V rows from the
// L2 in the same three passes (the head groups of one block read the
// same rows).  Values are read through (v_pool, v_ld): the fused form
// passes the key pool again with row stride hd.
//
// What bounds it on the H100: the K/V bytes of the live context (each
// element is used for 2 G flops), so the GQA form is bound by memory;
// splitting the sequences gives llama's B = 8 decode 168 working blocks
// where one block per sequence gave 64, and the staged loads keep ~64 KB
// in flight per block.  The fused form at G = 128 does ~240 flops per
// latent-row byte, near the card's bf16 ridge (~295): on the CUDA cores
// in f32 (route A) its operations bound it, 16 head groups of 8 each
// re-reading the block's 128 x 576 latent rows from the L2.
//
// Route B: one block per (64 query heads, sequence, logical block), so
// that a (sequence, block) pair costs G / 64 = 2 blocks, each reading
// the latent rows once.  Its thread 0 issues every TMA load at once (q's
// 64 heads x hd as a 2-D (B Hq, hd) map, the pool block's 128 rows x hd
// as a 3-D (hd, Hkv, P T) map at row tables[b, j] T), one mbarrier per
// 64-lane chunk, 128-byte swizzled: q takes 8 KB and K 16 KB a chunk,
// 216 KB at hd = 576, nothing reused, so no ring.  Two warpgroups of
// 128 threads (no producer warpgroup, so no setmaxnreg: 256 threads may
// take 255 registers each):
//   1. warpgroup w scores the block's tokens 64 w .. 64 w + 63 for all
//      64 heads, S = q K^T by wgmma m64n64k16 (A = q, B = the K rows,
//      both K-major), chunk by chunk as the loads land;
//   2. masks tokens past len to the finite -1e30, takes each head's max
//      over its 64 tokens and exchanges it with the other warpgroup
//      through shared memory: the block's max m_j over all 128 tokens,
//      so no rescaling is needed;
//   3. p = exp(s - m_j) in f32, l_w = its row sums (exchanged like the
//      max, l_j = l_0 + l_1 in that order), and p rounded to bf16 into
//      shared memory over q's first two chunks (free once both
//      warpgroups' scores are done), in the 128-byte-swizzled K-major
//      layout of wgmma's A;
//   4. acc_j = P V by wgmma m64n64k16 over all 128 tokens, A = P, B = V
//      the same K rows' lanes (MN-major, tnspB = 1): warpgroup w owns
//      value lanes (dv / 2) w .. (dv / 2) (w + 1), 64 f32 registers a
//      64-lane box; then (acc_j, m_j, l_j) go to the workspace as route
//      A's, and the same combine kernel merges them.
// Rows past len inside the last live block are zeroed in shared memory
// (every lane chunk) before any product reads them: they may hold NaN.
//
// Numerics contract of route B (the reference, paged_attention.py:133,
// casts q and k to f32 and keeps p in f32):
//   - s = q k^T from bf16 operands into an f32 accumulator: the products
//     are exact in f32, so s differs from the reference's only in the
//     order of the sums;
//   - the mask, max, exp (__expf) and l in f32 registers; l sums the
//     unrounded p;
//   - p is rounded to bf16 (round to nearest even) for P V, as kernel #8
//     does; the bf16 gate (1e-2 of the output scale against
//     paged_attention_ref) holds, and one rounding of p in [0, 1] moves
//     each weight by at most 2^-9 of itself;
//   - a row's sums run in one order whatever the batch holds, and the
//     merge is route A's: batch invariant, bitwise repeatable.
// Times against the bound are in PERF.md.
#include <cuda.h>           // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int GB = 8;             // query heads per block (a head group)
constexpr float NEG = -1e30f;     // finite mask value, as the reference's _NEG
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TPR = 8;            // threads per key row in the score pass
constexpr int COMBINE_THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T, converted to f32
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  // two consecutive values
  __device__ __forceinline__ static float2 load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ __forceinline__ static float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// STAGED: the GQA form, K and V rows staged in shared memory; else the
// fused form, rows read from global memory (v_pool = k_pool, v_ld = hd)
template <typename T, bool STAGED>
__global__ void __launch_bounds__(THREADS)
paged_attention_split_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                             const T* __restrict__ v_pool,
                             const int* __restrict__ tables,
                             const int* __restrict__ lengths,
                             float* __restrict__ part, int Hq, int Hkv, int hd,
                             int dv, int v_ld, int T_, int NB, float scale) {
  constexpr int V = Vec<T>::N;
  const int b = blockIdx.y;
  const int j = blockIdx.z;
  const int n = lengths[b];
  if (j * T_ >= n) return;               // past the live blocks: never read
  const int live = min(T_, n - j * T_);
  const size_t p = (size_t)tables[(size_t)b * NB + j];

  const int G = Hq / Hkv;
  const int ngb = (G + GB - 1) / GB;     // head groups per KV head
  const int gbs = min(G, GB);            // smem rows per group
  const int h = blockIdx.x / ngb;
  const int g0 = (blockIdx.x % ngb) * GB;
  const int gn = min(GB, G - g0);        // heads of this block's group
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ND = dv / 2;            // value-dim pairs
  const int TG = THREADS / ND;      // token groups in the p @ v pass (floor)

  extern __shared__ __align__(16) uint8_t smem[];
  T* ks = reinterpret_cast<T*>(smem);                  // (T, hd), staged form
  T* vs = ks + (STAGED ? (size_t)T_ * hd : 0);         // (T, dv), staged form
  float* qs = reinterpret_cast<float*>(vs + (STAGED ? (size_t)T_ * dv : 0));  // (gbs, hd)
  float* s = qs + gbs * hd;         // (gbs, T) scores, then probabilities
  float* red = s + gbs * T_;        // (TG, gbs, dv) partial p @ v
  float* ml = red + TG * gbs * dv;  // (gbs, 2): m_j, l_j

  const T* kblk = k_pool + (p * T_ * Hkv + h) * hd;      // row t at t * Hkv * hd
  const T* vblk = v_pool + (p * T_ * Hkv + h) * v_ld;    // row t at t * Hkv * v_ld
  if constexpr (STAGED) {
    const int kc = hd / V, vc = dv / V;
    for (int c = tid; c < live * kc; c += THREADS) {
      const int t = c / kc, e = (c % kc) * V;
      cp_async16(ks + t * hd + e, kblk + (size_t)t * Hkv * hd + e);
    }
    cp_async_commit();
    for (int c = tid; c < live * vc; c += THREADS) {
      const int t = c / vc, e = (c % vc) * V;
      cp_async16(vs + t * dv + e, vblk + (size_t)t * Hkv * v_ld + e);
    }
    cp_async_commit();
  }
  const size_t qrow = (size_t)b * Hq + (size_t)h * G + g0;   // first head
  for (int e = tid; e < gn * hd; e += THREADS) qs[e] = to_f32(q[qrow * hd + e]);
  if constexpr (STAGED) cp_async_wait<1>();    // this thread's K pieces
  __syncthreads();

  // (1) scores: TPR threads per key row (T is a multiple of THREADS / TPR)
  const int sub = tid % TPR;        // piece of the key row this thread reads
  for (int t = tid / TPR; t < T_; t += THREADS / TPR) {
    float acc[GB];
#pragma unroll
    for (int g = 0; g < GB; ++g) acc[g] = 0.f;
    if (t < live) {
      const T* krow = STAGED ? ks + (size_t)t * hd : kblk + (size_t)t * Hkv * hd;
      for (int c = sub * V; c < hd; c += TPR * V) {
        float kv[V];
        Vec<T>::load(krow + c, kv);
#pragma unroll
        for (int g = 0; g < GB; ++g) {
          if (g < gn) {
#pragma unroll
            for (int i = 0; i < V; ++i) acc[g] = fmaf(qs[g * hd + c + i], kv[i], acc[g]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < gn) {
        float v = acc[g];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        if (sub == 0) s[g * T_ + t] = t < live ? v * scale : NEG;
      }
    }
  }
  __syncthreads();

  // (2) the block's max and exp-sum: one warp per query head
  for (int g = warp; g < gn; g += WARPS) {
    float mx = NEG;
    for (int t = lane; t < T_; t += 32) mx = fmaxf(mx, s[g * T_ + t]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int t = lane; t < T_; t += 32) {
      const float pv = expf(s[g * T_ + t] - mx);
      s[g * T_ + t] = pv;
      sum += pv;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml[2 * g] = mx;
      ml[2 * g + 1] = sum;
    }
  }
  if constexpr (STAGED) cp_async_wait<0>();    // this thread's V pieces
  __syncthreads();

  // (3) partial p @ v over this thread's token group, live rows only
  const int dp = tid % ND;          // value-dim pair of this thread
  const int tg = tid / ND;          // token group of this thread
  if (tg < TG) {                    // threads past TG whole groups idle
    float pa[GB][2];
#pragma unroll
    for (int g = 0; g < GB; ++g) pa[g][0] = pa[g][1] = 0.f;
#pragma unroll 4
    for (int t = tg; t < live; t += TG) {
      const float2 vv = Vec<T>::load2(STAGED ? vs + (size_t)t * dv + 2 * dp
                                             : vblk + (size_t)t * Hkv * v_ld + 2 * dp);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < gn) {
          const float pg = s[g * T_ + t];
          pa[g][0] = fmaf(pg, vv.x, pa[g][0]);
          pa[g][1] = fmaf(pg, vv.y, pa[g][1]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (g < gn) {
        red[(tg * gbs + g) * dv + 2 * dp] = pa[g][0];
        red[(tg * gbs + g) * dv + 2 * dp + 1] = pa[g][1];
      }
    }
  }
  __syncthreads();
  const int W = dv + 2;
  for (int e = tid; e < gn * dv; e += THREADS) {
    const int g = e / dv, d = e % dv;
    float a = 0.f;
    for (int r = 0; r < TG; ++r) a += red[(r * gbs + g) * dv + d];
    part[((qrow + g) * NB + j) * W + d] = a;
  }
  if (tid < gn) {
    part[((qrow + tid) * NB + j) * W + dv] = ml[2 * tid];
    part[((qrow + tid) * NB + j) * W + dv + 1] = ml[2 * tid + 1];
  }
}

// out[b, hq] = the merge of row b's live partials, in j order
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_attention_combine_kernel(const float* __restrict__ part,
                               const int* __restrict__ lengths, T* __restrict__ out,
                               int Hq, int dv, int T_, int NB) {
  const int hq = blockIdx.x, b = blockIdx.y;
  const int nblk = (lengths[b] + T_ - 1) / T_;
  const int W = dv + 2;
  const float* base = part + ((size_t)b * Hq + hq) * NB * W;
  float m = NEG;
  for (int j = 0; j < nblk; ++j) m = fmaxf(m, base[j * W + dv]);
  float l = 0.f;
  for (int j = 0; j < nblk; ++j) l += base[j * W + dv + 1] * expf(base[j * W + dv] - m);
  for (int d = threadIdx.x; d < dv; d += COMBINE_THREADS) {
    float a = 0.f;
    for (int j = 0; j < nblk; ++j) a += base[j * W + d] * expf(base[j * W + dv] - m);
    out[((size_t)b * Hq + hq) * dv + d] = from_f32<T>(a / l);
  }
}

template <typename T, bool STAGED>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lengths, void* out, float* part,
                   int B, int Hq, int Hkv, int hd, int dv, int v_ld, int T_,
                   int NB, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int gbs = G < GB ? G : GB;
  const int ngb = (G + GB - 1) / GB;
  const int TG = THREADS / (dv / 2);
  const size_t smem =
      (STAGED ? sizeof(T) * (size_t)T_ * (hd + dv) : 0) +
      sizeof(float) * ((size_t)gbs * (hd + T_) + (size_t)TG * gbs * dv + 2 * (size_t)gbs);
  auto kernel = paged_attention_split_kernel<T, STAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(Hkv * ngb, B, NB);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lengths, part, Hq, Hkv, hd, dv,
      v_ld, T_, NB, scale);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  paged_attention_combine_kernel<T><<<dim3(Hq, B), COMBINE_THREADS, 0, stream>>>(
      part, lengths, static_cast<T*>(out), Hq, dv, T_, NB);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Route B: the fused form on TMA + wgmma
// ---------------------------------------------------------------------------
namespace wg {

constexpr int HEADS = 64;         // query heads a block (wgmma's M)
constexpr int TOKENS = 128;       // tokens a pool block (T)
constexpr int HALF = 64;          // tokens a warpgroup scores
constexpr int THREADS = 256;      // two consumer warpgroups
constexpr int CHUNK = 64;         // bf16 lanes a 128-byte swizzled row
constexpr int ROW = 128;          // bytes a swizzled row
constexpr int ATOM = 8 * ROW;     // one 128B-swizzle atom: 8 rows
constexpr int Q_BOX = HEADS * ROW;    // 8 KB: 64 heads x 64 lanes
constexpr int K_BOX = TOKENS * ROW;   // 16 KB: 128 tokens x 64 lanes
constexpr int MAX_HC = 9;         // lane chunks that fit: hd <= 576

// shared memory at hc 64-lane chunks of hd, from a 1024-aligned base:
// q chunks, K chunks, one mbarrier a chunk, then the (warpgroup, head)
// row maxima and row sums in f32; plus 1 KB to align the base
// (paged_attention.fused_wgmma_smem_bytes is the same rule)
__host__ __device__ constexpr int k_off(int hc) { return hc * Q_BOX; }
__host__ __device__ constexpr int bar_off(int hc) { return hc * (Q_BOX + K_BOX); }
__host__ __device__ constexpr int red_off(int hc) { return bar_off(hc) + 8 * hc; }
__host__ __device__ constexpr int smem_bytes(int hc) { return red_off(hc) + 4 * 2 * 2 * HEADS + 1024; }
static_assert(smem_bytes(MAX_HC) <= 232448, "over the 227 KB a block may take");

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

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
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

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// named barriers: 1 + w, one warpgroup; 3, both
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;" :: "r"(1 + w) : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;" ::: "memory");
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

// d (64 x 64 f32) (+)= A (64 x 16, smem, K-major) B (16 x 64, smem): B
// K-major (TB = 0: the scores' K rows) or MN-major (TB = 1: V)
template <int TB>
__device__ __forceinline__ void mma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, %35;\n}"
      : WG_D16(0), WG_D16(16)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

#undef WG_D16
#undef WG_D4

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

// DW: 64-lane value boxes a warpgroup owns (dv = 128 DW); hc: lane
// chunks of hd.  Grid (Hkv x G / 64, B, NB).
template <int DW>
__global__ void __launch_bounds__(THREADS, 1)
paged_attention_fused_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                                   const __grid_constant__ CUtensorMap kmap,
                                   const int* __restrict__ tables,
                                   const int* __restrict__ lengths,
                                   float* __restrict__ part, int Hq, int Hkv, int hc,
                                   int NB, float scale) {
  constexpr int DV = 2 * DW * CHUNK;
  const int b = blockIdx.y;
  const int j = blockIdx.z;
  const int n = lengths[b];
  if (j * TOKENS >= n) return;           // past the live blocks: never read
  const int live = min(TOKENS, n - j * TOKENS);
  const int G = Hq / Hkv;
  const int h = blockIdx.x / (G / HEADS);
  const int qrow = b * Hq + h * G + (blockIdx.x % (G / HEADS)) * HEADS;
  const int prow = tables[(size_t)b * NB + j] * TOKENS;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* sbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sK = base + k_off(hc), bar = base + bar_off(hc);
  float* rmax = reinterpret_cast<float*>(sbase + red_off(hc));   // (warpgroup, head)
  float* rsum = rmax + 2 * HEADS;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int c = 0; c < hc; ++c) mbar_init(bar + 8 * c, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < hc; ++c) {       // every load at once, chunk by chunk
      mbar_expect_tx(bar + 8 * c, Q_BOX + K_BOX);
      tma_load_2d(sQ + c * Q_BOX, &qmap, bar + 8 * c, c * CHUNK, qrow);
      tma_load_3d(sK + c * K_BOX, &kmap, bar + 8 * c, c * CHUNK, h, prow);
    }
  }

  const int w = tid / 128;               // warpgroup: tokens 64 w.., value boxes DW w..
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int r0 = warp * 16 + lane / 4;   // this thread's heads r0, r0 + 8
  const int cq = (lane % 4) * 2;         // and columns cq, cq + 1 of each 8
  const int t0 = w * HALF;

  // rows past len: zeroed in every chunk before a product reads them
  if (live < t0 + HALF) {
    const int z0 = max(live, t0);
    const int rows = t0 + HALF - z0;
    for (int c = 0; c < hc; ++c) mbar_wait(bar + 8 * c, 0);
    for (int e = tid % 128; e < hc * rows * (ROW / 16); e += 128) {
      const int c = e / (rows * (ROW / 16));
      const int r = z0 + (e / (ROW / 16)) % rows;
      *reinterpret_cast<uint4*>(sbase + k_off(hc) + c * K_BOX + r * ROW + (e % (ROW / 16)) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
    warpgroup_sync(w);
  }

  // 1. s = q k^T over this warpgroup's 64 tokens, 16 lanes a step
  float sc[32];
  wgmma_fence();
  for (int c = 0; c < hc; ++c) {
    mbar_wait(bar + 8 * c, 0);
#pragma unroll
    for (int kk = 0; kk < CHUNK / 16; ++kk)
      mma_n64<0>(sc, desc_sw128(sQ + c * Q_BOX + kk * 32, 16, ATOM),
                 desc_sw128(sK + c * K_BOX + t0 * ROW + kk * 32, 16, ATOM), (c | kk) != 0);
  }
  wgmma_commit();
  wgmma_wait0();
  fence_regs(sc);

  // 2. scale, mask, the block's max of each head
  float mx0 = NEG, mx1 = NEG;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int t = t0 + 8 * (i / 4) + cq + (i & 1);
    const float x = t < live ? sc[i] * scale : NEG;
    sc[i] = x;
    if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
  }
  mx0 = quad_max(mx0);
  mx1 = quad_max(mx1);
  if (lane % 4 == 0) {
    rmax[w * HEADS + r0] = mx0;
    rmax[w * HEADS + r0 + 8] = mx1;
  }
  consumers_sync();                      // both warpgroups' scores are done: q is free
  const float m0 = fmaxf(rmax[r0], rmax[HEADS + r0]);
  const float m1 = fmaxf(rmax[r0 + 8], rmax[HEADS + r0 + 8]);

  // 3. p in f32 for l, rounded to bf16 into P's chunk w (over q's chunk w)
  uint8_t* pbox = sbase + w * Q_BOX;
  float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float e0 = __expf(sc[4 * jj] - m0), e1 = __expf(sc[4 * jj + 1] - m0);
    const float e2 = __expf(sc[4 * jj + 2] - m1), e3 = __expf(sc[4 * jj + 3] - m1);
    ls0 += e0 + e1;
    ls1 += e2 + e3;
    const int sw = ((jj ^ (lane / 4)) << 4) + (lane % 4) * 4;   // 128B swizzle: row & 7 = lane / 4
    *reinterpret_cast<uint32_t*>(pbox + r0 * ROW + sw) = pack_bf16(e0, e1);
    *reinterpret_cast<uint32_t*>(pbox + (r0 + 8) * ROW + sw) = pack_bf16(e2, e3);
  }
  ls0 = quad_sum(ls0);
  ls1 = quad_sum(ls1);
  if (lane % 4 == 0) {
    rsum[w * HEADS + r0] = ls0;
    rsum[w * HEADS + r0 + 8] = ls1;
  }
  fence_proxy_async();
  consumers_sync();                      // P and the row sums are in place

  // 4. acc = P V over the block's 128 tokens, this warpgroup's value boxes
  float o[DW][32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TOKENS / 16; ++kk) {
    const uint64_t da = desc_sw128(sQ + (kk / 4) * Q_BOX + (kk % 4) * 32, 16, ATOM);
#pragma unroll
    for (int d = 0; d < DW; ++d)
      mma_n64<1>(o[d], da, desc_sw128(sK + (w * DW + d) * K_BOX + kk * 16 * ROW, ATOM, ATOM),
                 kk != 0);
  }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int d = 0; d < DW; ++d) fence_regs(o[d]);

  constexpr int W = DV + 2;
  float* p0 = part + ((size_t)(qrow + r0) * NB + j) * W;
  float* p1 = part + ((size_t)(qrow + r0 + 8) * NB + j) * W;
#pragma unroll
  for (int d = 0; d < DW; ++d)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int col = (w * DW + d) * CHUNK + 8 * jj + cq;
      *reinterpret_cast<float2*>(p0 + col) = make_float2(o[d][4 * jj], o[d][4 * jj + 1]);
      *reinterpret_cast<float2*>(p1 + col) = make_float2(o[d][4 * jj + 2], o[d][4 * jj + 3]);
    }
  if (w == 0 && lane % 4 == 0) {
    p0[DV] = m0;
    p0[DV + 1] = rsum[r0] + rsum[HEADS + r0];
    p1[DV] = m1;
    p1[DV + 1] = rsum[r0 + 8] + rsum[HEADS + r0 + 8];
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

// a bf16 tensor of `rank` dims (innermost first, dims[0] = hd lanes) as a
// map read in 128B-swizzled boxes of 64 lanes x `box` (outer dims)
int make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
             const cuuint32_t* box) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return ENCODE_FAILED + CUDA_ERROR_NOT_FOUND;
  cuuint64_t strides[2];
  cuuint64_t s = dims[0] * 2;
  for (int i = 0; i + 1 < rank; ++i) {
    strides[i] = s;
    s *= dims[i + 1];
  }
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

template <int DW>
int launch_fused(const void* q, const void* k_pool, const int* tables, const int* lengths,
                 float* part, int B, int Hq, int Hkv, int hd, int P, int NB, float scale,
                 cudaStream_t stream) {
  CUtensorMap qm, km;
  const cuuint64_t qdims[2] = {(cuuint64_t)hd, (cuuint64_t)B * Hq};
  const cuuint32_t qbox[2] = {CHUNK, HEADS};
  const cuuint64_t kdims[3] = {(cuuint64_t)hd, (cuuint64_t)Hkv, (cuuint64_t)P * TOKENS};
  const cuuint32_t kbox[3] = {CHUNK, 1, TOKENS};
  int e = make_map(&qm, q, 2, qdims, qbox);
  if (e == 0) e = make_map(&km, k_pool, 3, kdims, kbox);
  if (e != 0) return e;
  auto kernel = paged_attention_fused_wgmma_kernel<DW>;
  static bool ready = false;             // once, so that a graph capture sees only the launch
  if (!ready) {
    const cudaError_t a = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes(MAX_HC));
    if (a != cudaSuccess) return a;
    ready = true;
  }
  const int hc = hd / CHUNK;
  dim3 grid(Hq / HEADS, B, NB);          // Hkv x (G / 64) head halves
  kernel<<<grid, THREADS, smem_bytes(hc), stream>>>(qm, km, tables, lengths, part, Hq, Hkv,
                                                     hc, NB, scale);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  v_pool == nullptr selects the fused
// form: values are the first dv lanes of each k_pool row.  part is an f32
// workspace of B x Hq x NB x (dv + 2) floats.  The wrapper checks what
// the kernels need (paged_attention._check_kernel_geometry): Hq % Hkv ==
// 0; hd a multiple of 16 bytes of the dtype (and dv too in the GQA form);
// T a multiple of 32; dv even and <= 512 (dv <= hd in the fused form);
// 16-byte aligned pools; and
//   (GQA: T (hd + dv) x elem) + (g (hd + T) + floor(512 / dv) g dv + 2 g) x 4
// bytes of shared memory, g = min(Hq / Hkv, 8), within the 227 KB a
// block may take.  route (paged_attention.fused_route): 0 = simt, 1 =
// wgmma (fused form, bfloat16, Hq / Hkv a multiple of 64, hd a multiple
// of 64 up to 576, dv a multiple of 128 up to min(512, hd), T = 128; P
// pool blocks, 16-byte aligned q and pool).  Returns 0, a cudaError_t,
// or 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const int* tables,
                                      const int* lengths, void* out, void* part,
                                      int B, int Hq, int Hkv, int hd, int dv,
                                      int T_, int NB, int P, float scale, int dtype,
                                      int route, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(part);
  if (route == 1) {
    if (v_pool != nullptr || dtype != 1 || T_ != wg::TOKENS || Hq % Hkv ||
        (Hq / Hkv) % wg::HEADS || hd % wg::CHUNK || hd / wg::CHUNK > wg::MAX_HC ||
        dv % (2 * wg::CHUNK) || dv > hd)
      return cudaErrorInvalidValue;
    int e = cudaErrorInvalidValue;
    switch (dv / (2 * wg::CHUNK)) {
      case 1: e = wg::launch_fused<1>(q, k_pool, tables, lengths, ws, B, Hq, Hkv, hd, P, NB, scale, s); break;
      case 2: e = wg::launch_fused<2>(q, k_pool, tables, lengths, ws, B, Hq, Hkv, hd, P, NB, scale, s); break;
      case 3: e = wg::launch_fused<3>(q, k_pool, tables, lengths, ws, B, Hq, Hkv, hd, P, NB, scale, s); break;
      case 4: e = wg::launch_fused<4>(q, k_pool, tables, lengths, ws, B, Hq, Hkv, hd, P, NB, scale, s); break;
    }
    if (e != 0) return e;
    paged_attention_combine_kernel<__nv_bfloat16><<<dim3(Hq, B), COMBINE_THREADS, 0, s>>>(
        ws, lengths, static_cast<__nv_bfloat16*>(out), Hq, dv, T_, NB);
    return cudaGetLastError();
  }
  if (route != 0) return cudaErrorInvalidValue;
  if (v_pool == nullptr) {
    if (dtype == 0)
      return launch<float, false>(q, k_pool, k_pool, tables, lengths, out, ws, B,
                                  Hq, Hkv, hd, dv, hd, T_, NB, scale, s);
    if (dtype == 1)
      return launch<__nv_bfloat16, false>(q, k_pool, k_pool, tables, lengths, out,
                                          ws, B, Hq, Hkv, hd, dv, hd, T_, NB, scale, s);
  } else {
    if (dtype == 0)
      return launch<float, true>(q, k_pool, v_pool, tables, lengths, out, ws, B,
                                 Hq, Hkv, hd, dv, dv, T_, NB, scale, s);
    if (dtype == 1)
      return launch<__nv_bfloat16, true>(q, k_pool, v_pool, tables, lengths, out,
                                         ws, B, Hq, Hkv, hd, dv, dv, T_, NB, scale, s);
  }
  return cudaErrorInvalidValue;
}

// dynamic shared memory of route B at hd (bytes), as its launch asks
extern "C" int paged_attention_fused_wgmma_smem(int hd) {
  return wg::smem_bytes((hd + wg::CHUNK - 1) / wg::CHUNK);
}

extern "C" const char* kernel_error_string(int code) {
  if (code >= wg::ENCODE_FAILED) return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
