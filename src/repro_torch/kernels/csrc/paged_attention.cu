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
// One thread block per (KV head h, head group, sequence b): the G = Hq /
// Hkv query heads of a KV head are split into groups of at most GB, and
// a block takes one group, so that its f32 state fits in shared memory
// at MLA's G = 128, hd = 576, dv = 512 (a whole group would need ~880 KB)
// and a batch of 8 sequences fills 128 blocks.  The groups of one KV head
// read the same K rows, the later ones from the L2.  Values are read
// through (v_pool, v_ld): the GQA form passes its value pool with row
// stride dv, the fused form passes the key pool again with row stride
// hd, so the values are the first dv lanes of each key row and no second
// pool exists.
//
// The block walks only the live logical blocks j < ceil(len / T), reading
// pool[tables[b, j]]; table entries past them (the engine points them at
// scratch block 0) are never touched, nor are the rows of the last live
// block past len.  Scores are q . k in f32 (bf16 loads cast up), then
// times `scale`, as the reference does; the softmax streams over blocks
// with the running max m, the sum l and the accumulator kept in f32
// shared memory, and the flush writes acc / l in q's type.
//
// Per block of T tokens: (1) scores, eight threads per key row, each
// loading 16-byte pieces of it (a row is one contiguous hd run), summed
// with three shuffles; (2) the softmax update, one warp per query head;
// (3) p @ v, threads along pairs of value dims and TG token groups,
// partial sums combined through shared memory.
//
// What bounds it on the H100: the K/V bytes of the live context (each
// element is used for 2 G flops), so the GQA form is bound by memory.
// The fused form at G = 128 does ~240 flops per latent-row byte, near
// the card's bf16 ridge (~295); this kernel does them in f32 on the CUDA
// cores, not the tensor cores, so its operations are what it waits on.
// The block walks a sequence's blocks one after another, so the longest
// sequence sets the time; splitting a sequence over blocks is later
// work.  Its time against the bound is in PERF.md.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int GB = 8;             // query heads per block (a head group)
constexpr float NEG = -1e30f;     // finite mask value, as the reference's _NEG
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TPR = 8;            // threads per key row in the score pass

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

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int Hq, int Hkv, int hd, int dv, int v_ld, int T_,
                       int NB, float scale) {
  constexpr int V = Vec<T>::N;
  const int G = Hq / Hkv;
  const int ngb = (G + GB - 1) / GB;     // head groups per KV head
  const int gbs = min(G, GB);            // smem rows per group
  const int h = blockIdx.x / ngb;
  const int g0 = (blockIdx.x % ngb) * GB;
  const int gn = min(GB, G - g0);        // heads of this block's group
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ND = dv / 2;            // value-dim pairs
  const int TG = THREADS / ND;      // token groups in the p @ v pass

  extern __shared__ float smem[];
  float* qs = smem;                 // (gbs, hd)
  float* s = qs + gbs * hd;         // (gbs, T) scores, then probabilities
  float* acc = s + gbs * T_;        // (gbs, dv)
  float* red = acc + gbs * dv;      // (TG, gbs, dv) partial p @ v
  float* m = red + TG * gbs * dv;   // (gbs,)
  float* l = m + gbs;               // (gbs,)
  float* corr = l + gbs;            // (gbs,)

  const size_t qrow = (size_t)b * Hq + (size_t)h * G + g0;   // first head
  for (int e = tid; e < gn * hd; e += THREADS) qs[e] = to_f32(q[qrow * hd + e]);
  for (int e = tid; e < gn * dv; e += THREADS) acc[e] = 0.f;
  if (tid < gn) {
    m[tid] = NEG;
    l[tid] = 0.f;
  }
  __syncthreads();

  const int n = lengths[b];
  const int nblk = (n + T_ - 1) / T_;
  const int sub = tid % TPR;        // piece of the key row this thread reads
  const int dp = tid % ND;          // value-dim pair of this thread
  const int tg = tid / ND;          // token group of this thread
  for (int j = 0; j < nblk; ++j) {
    const size_t p = (size_t)tables[(size_t)b * NB + j];
    const int live = min(T_, n - j * T_);

    // (1) scores: TPR threads per key row (T_ is a multiple of THREADS / TPR)
    for (int t = tid / TPR; t < T_; t += THREADS / TPR) {
      float part[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) part[g] = 0.f;
      if (t < live) {
        const T* krow = k_pool + ((p * T_ + t) * Hkv + h) * hd;
        for (int c = sub * V; c < hd; c += TPR * V) {
          float kv[V];
          Vec<T>::load(krow + c, kv);
#pragma unroll
          for (int g = 0; g < GB; ++g) {
            if (g < gn) {
#pragma unroll
              for (int i = 0; i < V; ++i) part[g] = fmaf(qs[g * hd + c + i], kv[i], part[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        if (g < gn) {
          float v = part[g];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          if (sub == 0) s[g * T_ + t] = t < live ? v * scale : NEG;
        }
      }
    }
    __syncthreads();

    // (2) streaming softmax update: one warp per query head
    for (int g = warp; g < gn; g += WARPS) {
      float mx = NEG;
      for (int t = lane; t < T_; t += 32) mx = fmaxf(mx, s[g * T_ + t]);
      mx = warp_max(mx);
      const float m_prev = m[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < T_; t += 32) {
        const float pv = expf(s[g * T_ + t] - m_new);
        s[g * T_ + t] = pv;
        sum += pv;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[g] = c;
        l[g] = l[g] * c + sum;
        m[g] = m_new;
      }
    }
    __syncthreads();

    // (3) partial p @ v over this thread's token group, live rows only
    if (tg < TG) {
      float pa[GB][2];
#pragma unroll
      for (int g = 0; g < GB; ++g) pa[g][0] = pa[g][1] = 0.f;
      const T* vcol = v_pool + (p * T_ * Hkv + h) * v_ld + 2 * dp;
#pragma unroll 4
      for (int t = tg; t < live; t += TG) {
        const float2 vv = Vec<T>::load2(vcol + (size_t)t * Hkv * v_ld);
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
    for (int e = tid; e < gn * dv; e += THREADS) {
      const int g = e / dv;
      float a = acc[e] * corr[g];
      for (int r = 0; r < TG; ++r) a += red[r * gbs * dv + e];
      acc[e] = a;
    }
    __syncthreads();
  }

  for (int e = tid; e < gn * dv; e += THREADS) {
    const int g = e / dv;
    out[qrow * dv + e] = from_f32<T>(acc[e] / l[g]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* tables, const int* lengths, void* out, int B,
                   int Hq, int Hkv, int hd, int dv, int v_ld, int T_, int NB,
                   float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int gbs = G < GB ? G : GB;
  const int ngb = (G + GB - 1) / GB;
  const int TG = THREADS / (dv / 2);
  const size_t smem = sizeof(float) * ((size_t)gbs * (hd + T_ + dv) +
                                       (size_t)TG * gbs * dv + 3 * (size_t)gbs);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid(Hkv * ngb, B);
  paged_attention_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), tables, lengths, static_cast<T*>(out), Hq,
      Hkv, hd, dv, v_ld, T_, NB, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  v_pool == nullptr selects the fused
// form: values are the first dv lanes of each k_pool row.  The wrapper
// checks what the kernel needs: Hq % Hkv == 0; hd a multiple of 8 x (16
// bytes of the dtype); T a multiple of 32; dv even with dv / 2 dividing
// 256 (dv <= hd in the fused form); 16-byte aligned pools; and
// (g (hd + T + dv) + (512 / dv) g dv + 3 g) x 4 bytes of shared memory,
// g = min(Hq / Hkv, 8), within the 227 KB a block may take.  Returns
// cudaGetLastError().
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool, const int* tables,
                                      const int* lengths, void* out, int B,
                                      int Hq, int Hkv, int hd, int dv, int T_,
                                      int NB, float scale, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool fused = v_pool == nullptr;
  const void* vp = fused ? k_pool : v_pool;
  const int v_ld = fused ? hd : dv;
  if (dtype == 0)
    return launch<float>(q, k_pool, vp, tables, lengths, out, B, Hq, Hkv, hd,
                         dv, v_ld, T_, NB, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, vp, tables, lengths, out, B, Hq,
                                 Hkv, hd, dv, v_ld, T_, NB, scale, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
