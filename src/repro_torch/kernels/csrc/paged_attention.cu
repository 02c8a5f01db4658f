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
// Per block: (0) the GQA form puts the live K and V rows of its pool block
// in flight at once (cp.async.cg, 16 bytes a piece: 32 KB each for llama's
// T = 128, hd = 128 in bf16) while q is staged, then (1) scores, eight
// threads per key row, summed with three shuffles; (2) max and exp-sum,
// one warp per query head; (3) p @ v, threads along pairs of value dims
// and TG token groups, partial sums combined through shared memory in a
// fixed order.  The fused (MLA) form's rows are 576 lanes wide: a staged
// block would not fit beside its state, so it reads K/V rows from the
// L2 in the same three passes (the head groups of one block read the
// same rows).  Values are read through (v_pool, v_ld): the fused form
// passes the key pool again with row stride hd.
//
// What bounds it on the H100: the K/V bytes of the live context (each
// element is used for 2 G flops), so the GQA form is bound by memory;
// splitting the sequences gives llama's B = 8 decode 168 working blocks
// where one block per sequence gave 64, and the staged loads keep ~64 KB
// in flight per block.  The fused form at G = 128 does ~240 flops per
// latent-row byte, near the card's bf16 ridge (~295), on the CUDA cores
// in f32, so its operations bound it; the split spreads its work over
// every live (sequence, block) pair.  Times against the bound are in
// PERF.md.
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
  const int TG = THREADS / ND;      // token groups in the p @ v pass

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
  if (tg < TG) {
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  v_pool == nullptr selects the fused
// form: values are the first dv lanes of each k_pool row.  part is an f32
// workspace of B x Hq x NB x (dv + 2) floats.  The wrapper checks what
// the kernels need (paged_attention._check_kernel_geometry): Hq % Hkv ==
// 0; hd a multiple of 16 bytes of the dtype (and dv too in the GQA form);
// T a multiple of 32; dv even with dv / 2 dividing 256 (dv <= hd in the
// fused form); 16-byte aligned pools; and
//   (GQA: T (hd + dv) x elem) + (g (hd + T) + (512 / dv) g dv + 2 g) x 4
// bytes of shared memory, g = min(Hq / Hkv, 8), within the 227 KB a
// block may take.  Returns cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const int* tables,
                                      const int* lengths, void* out, void* part,
                                      int B, int Hq, int Hkv, int hd, int dv,
                                      int T_, int NB, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(part);
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

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
