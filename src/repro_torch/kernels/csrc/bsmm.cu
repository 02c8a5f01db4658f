// Block-sparse matmul forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels src/repro/kernels/bsmm.py::_bsmm_kernel
// (plain) and ::_bsmm_epilogue_kernel (bias + relu/gelu/silu fused into
// the flush).  Both are one template here: EPI selects the epilogue.
//
//   out[M, N] = sum over t < counts[j] of x[:, K-tile idx[j, t]] @ w[K-tile idx[j, t], N-tile j]
//
// over the plan's 128x128 crossbar tiles.  A thread block owns one
// (BM x BN) piece of output column tile j = n0 / 128, reads counts[j]
// and walks the live K tiles idx[j, :counts[j]] itself: dead tiles are
// never read.  Inside a plan tile the K loop steps by BK (32 at
// prefill, the whole 128 at decode), staging x and w sub-tiles through
// shared memory as f32 with 16-byte loads (operands must be 16-byte
// aligned; the wrapper checks), and each thread keeps a TM x TN
// register tile of f32 accumulators.  The flush adds the bias
// (in f32), applies the activation and casts to the output type.
//
// bfloat16 at M >= 128 (prefill) multiplies on the tensor cores with
// WMMA fragments (bsmm_wmma_kernel); float32, and every M < 128, use
// CUDA-core FMA.
//
// What bounds it on the H100: the bytes of the live weight tiles, at
// decode (M = 8 rows, some 2 flops per byte) and, counted once per live
// tile, even at prefill.  Neither variant reaches that: both have one
// tile of loads in flight per block (no cp.async/TMA double buffering),
// and WMMA (mma.sync) is below wgmma's rate.  Small M uses narrow
// 32-column blocks so that enough blocks pull weight bytes on every SM.
// Times against the bound are in PERF.md.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 128;   // the plan's tile edge (the paper's crossbar)

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(z, 0.f);
    case ACT_GELU: {  // tanh form, as jax.nn.gelu's default
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return 0.5f * z * (1.f + tanhf(c * (z + 0.044715f * z * z * z)));
    }
    case ACT_SILU:
      return z / (1.f + expf(-z));
    default:
      return z;
  }
}

// 16 bytes of T from global memory, converted to f32.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
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
};

template <typename T, int BM, int BN, int BK, int TM, int TN, bool EPI>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
bsmm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ out,
                const int* __restrict__ idx, const int* __restrict__ counts,
                int M, int K, int N, int kmax, int act) {
  constexpr int NX = BN / TN;           // threads along N
  constexpr int NT = (BM / TM) * NX;    // threads per block
  constexpr int V = Vec<T>::N;          // elements per 16-byte load
  __shared__ float xs[BK][BM + 1];      // x sub-tile, transposed (k, m)
  __shared__ float ws[BK][BN];          // w sub-tile (k, n)

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int j = n0 / TILE;
  const int tid = threadIdx.x;
  const int tx = tid % NX;
  const int ty = tid / NX;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

  const int cnt = counts[j];
  for (int t = 0; t < cnt; ++t) {
    const int kt = idx[j * kmax + t];
    for (int kk = 0; kk < TILE; kk += BK) {
      const int kb = kt * TILE + kk;
      for (int e = tid; e < BM * BK / V; e += NT) {   // 16 B loads along k
        const int r = e / (BK / V), c = (e % (BK / V)) * V;
        const int m = m0 + r;
        float v[V];
        if (m < M) {
          Vec<T>::load(x + (size_t)m * K + kb + c, v);
        } else {
#pragma unroll
          for (int i = 0; i < V; ++i) v[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) xs[c + i][r] = v[i];
      }
      for (int e = tid; e < BK * BN / V; e += NT) {   // 16 B loads along n
        const int r = e / (BN / V), c = (e % (BN / V)) * V;
        float v[V];
        Vec<T>::load(w + (size_t)(kb + r) * N + n0 + c, v);
#pragma unroll
        for (int i = 0; i < V; ++i) ws[r][c + i] = v[i];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int a = 0; a < TM; ++a) av[a] = xs[k][ty + a * (BM / TM)];
#pragma unroll
        for (int b = 0; b < TN; ++b) bv[b] = ws[k][tx + b * NX];
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int m = m0 + ty + a * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int n = n0 + tx + b * NX;
      float z = acc[a][b];
      if (EPI) {
        if (bias != nullptr) z += to_f32(bias[n]);
        z = activate(z, act);
      }
      out[(size_t)m * N + n] = from_f32<T>(z);
    }
  }
}

// Tensor-core variant for bfloat16 at M >= 128 (prefill): the same walk
// over live K tiles, with bf16 sub-tiles staged in shared memory as they
// are and multiplied by WMMA 16x16x16 fragments into f32 accumulators.
// 8 warps each own a 32 x 64 piece of the 128 x 128 output tile; the
// flush goes fragment by fragment through a per-warp f32 staging tile,
// where the epilogue is applied.
template <bool EPI>
__global__ void __launch_bounds__(256)
bsmm_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, const int* __restrict__ idx,
                 const int* __restrict__ counts, int M, int K, int N, int kmax,
                 int act) {
  using namespace nvcuda;
  constexpr int BM = 128, BN = 128, BK = 64;
  constexpr int LDA = BK + 8, LDB = BN + 8;   // padded, multiples of 8
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[8][16 * 16];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int j = n0 / TILE;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2;      // 4 warp rows of 32
  const int wn = warp % 2;      // 2 warp columns of 64

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  const int cnt = counts[j];
  for (int t = 0; t < cnt; ++t) {
    const int kt = idx[j * kmax + t];
    for (int kk = 0; kk < TILE; kk += BK) {
      const int kb = kt * TILE + kk;
      for (int e = tid; e < BM * BK / 8; e += 256) {   // 16 B loads
        const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
        const int m = m0 + r;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m < M) v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + kb + c);
        *reinterpret_cast<uint4*>(As + r * LDA + c) = v;
      }
      for (int e = tid; e < BK * BN / 8; e += 256) {
        const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(Bs + r * LDB + c) =
            *reinterpret_cast<const uint4*>(w + (size_t)(kb + r) * N + n0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int k16 = 0; k16 < BK; k16 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
          wmma::load_matrix_sync(fa[a], As + (wm * 32 + a * 16) * LDA + k16, LDA);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          wmma::load_matrix_sync(fb[b], Bs + k16 * LDB + wn * 64 + b * 16, LDB);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
      }
      __syncthreads();
    }
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      wmma::store_matrix_sync(cs, acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + a * 16 + e / 16;
        const int n = n0 + wn * 64 + b * 16 + e % 16;
        if (m < M) {
          float z = cs[e];
          if (EPI) {
            if (bias != nullptr) z += __bfloat162float(bias[n]);
            z = activate(z, act);
          }
          out[(size_t)m * N + n] = __float2bfloat16(z);
        }
      }
      __syncwarp();
    }
  }
}

template <typename T, bool EPI>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   const int* idx, const int* counts, int M, int K, int N,
                   int kmax, int act, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (M >= TILE) {
      dim3 grid(N / TILE, (M + TILE - 1) / TILE);
      bsmm_wmma_kernel<EPI><<<grid, 256, 0, stream>>>(xp, wp, bp, op, idx, counts,
                                                     M, K, N, kmax, act);
      return cudaGetLastError();
    }
  }
  if (M >= TILE) {
    constexpr int BM = 128, BN = 128, BK = 32, TM = 8, TN = 8;
    dim3 grid(N / BN, (M + BM - 1) / BM);
    bsmm_fwd_kernel<T, BM, BN, BK, TM, TN, EPI><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
        xp, wp, bp, op, idx, counts, M, K, N, kmax, act);
  } else {
    // small M (decode): a whole plan tile per step, so one load round
    // trip per live tile instead of four
    constexpr int BM = 16, BN = 32, BK = 128, TM = 2, TN = 1;
    dim3 grid(N / BN, (M + BM - 1) / BM);
    bsmm_fwd_kernel<T, BM, BN, BK, TM, TN, EPI><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(
        xp, wp, bp, op, idx, counts, M, K, N, kmax, act);
  }
  return cudaGetLastError();
}

template <bool EPI>
int dispatch(const void* x, const void* w, const void* bias, void* out,
             const int* idx, const int* counts, int M, int K, int N, int kmax,
             int dtype, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, EPI>(x, w, bias, out, idx, counts, M, K, N, kmax, act, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, EPI>(x, w, bias, out, idx, counts, M, K, N, kmax, act, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int bsmm_launch(const void* x, const void* w, void* out,
                           const int* idx, const int* counts, int M, int K,
                           int N, int kmax, int dtype, void* stream) {
  return dispatch<false>(x, w, nullptr, out, idx, counts, M, K, N, kmax, dtype,
                         ACT_NONE, stream);
}

// bias may be null (then act(acc) alone); act: 0 none, 1 relu, 2 gelu (tanh), 3 silu.
extern "C" int bsmm_epilogue_launch(const void* x, const void* w,
                                    const void* bias, void* out,
                                    const int* idx, const int* counts, int M,
                                    int K, int N, int kmax, int dtype, int act,
                                    void* stream) {
  return dispatch<true>(x, w, bias, out, idx, counts, M, K, N, kmax, dtype, act,
                        stream);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
