// Block-sparse matmul, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bsmm.py:
//   _bsmm_kernel (plain forward) and _bsmm_epilogue_kernel (bias +
//   relu/gelu/silu fused into the flush): one template here, EPI
//   selects the epilogue;
//   _bsmm_dx_kernel (dx = g @ (w * bitmap)^T over the transposed plan):
//   the same template with TRANS set, reading w's tiles along N;
//   _bsmm_dw_kernel (dw tile = x^T g for every live tile): bsmm_dw_*
//   below, which store each live tile straight into the zeroed dense
//   grad instead of materialising (L, 128, 128) and scattering.
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
// The expert-batched form (bsmm_batched_launch) is the same kernel with
// grid z over E experts, each block offsetting x, w and out by its
// expert's strides: the reference vmaps the Pallas call over the expert
// axis into one launch, and so does this, with the one plan that the
// union of the expert masks gives.  MoE rows per expert are few (8 at
// decode, 16-24 at prefill) and the grid is wide (experts x column
// tiles), so it takes bsmm_stream_kernel, which streams each live weight
// tile through registers instead of staging it in shared memory.  Only
// the batched form (E > 1) takes it: the 2-D launches keep the kernels
// below, whatever their grid.
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
//
// Backward.  dx walks, for its output column tile k (a K tile), the
// live N tiles idx_t[k, :counts_t[k]]: the forward walk with the plan
// transposed and w read as its transpose (TRANS), so dead tiles are
// never read.  dw runs one block per live tile l and sums x[:, kk[l]]^T
// @ g[:, nn[l]] over every row in f32; M is its contraction, so it is
// bound by the operations at training row counts (2 * M flops per
// element of a tile against 2 * 2 bytes read per row) and by the bytes
// of x's and g's live columns when M is small.  Both mask a ragged M:
// rows past M are loaded as zeros and never stored, so they add
// nothing to dw.  Same limits as the forward: no cp.async/TMA double
// buffering, WMMA (mma.sync) for bf16, CUDA-core FMA for f32.
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

// out (M, N) = x (M, K) @ B, where B is w (K, N), or, with TRANS, the
// transpose of w (N, K) (the dx product: x = g, w = the weight).
template <typename T, int BM, int BN, int BK, int TM, int TN, bool EPI, bool TRANS>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
bsmm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                const T* __restrict__ bias, T* __restrict__ out,
                const int* __restrict__ idx, const int* __restrict__ counts,
                int M, int K, int N, int kmax, int act, long long sx,
                long long sw, long long so) {
  constexpr int NX = BN / TN;           // threads along N
  constexpr int NT = (BM / TM) * NX;    // threads per block
  constexpr int V = Vec<T>::N;          // elements per 16-byte load
  __shared__ float xs[BK][BM + 1];      // x sub-tile, transposed (k, m)
  __shared__ float ws[BK][BN + (TRANS ? 1 : 0)];   // B sub-tile (k, n)

  x += blockIdx.z * sx;                 // this block's expert (batched form)
  w += blockIdx.z * sw;
  out += blockIdx.z * so;
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
      if (TRANS) {
        for (int e = tid; e < BN * BK / V; e += NT) {   // 16 B loads along k of w's rows
          const int r = e / (BK / V), c = (e % (BK / V)) * V;
          float v[V];
          Vec<T>::load(w + (size_t)(n0 + r) * K + kb + c, v);
#pragma unroll
          for (int i = 0; i < V; ++i) ws[c + i][r] = v[i];
        }
      } else {
        for (int e = tid; e < BK * BN / V; e += NT) {   // 16 B loads along n
          const int r = e / (BN / V), c = (e % (BN / V)) * V;
          float v[V];
          Vec<T>::load(w + (size_t)(kb + r) * N + n0 + c, v);
#pragma unroll
          for (int i = 0; i < V; ++i) ws[r][c + i] = v[i];
        }
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
// where the epilogue is applied.  With TRANS (dx) w's rows are staged
// as they are, (n, k), and read as a column-major B fragment.
template <bool EPI, bool TRANS>
__global__ void __launch_bounds__(256)
bsmm_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                 const __nv_bfloat16* __restrict__ w,
                 const __nv_bfloat16* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, const int* __restrict__ idx,
                 const int* __restrict__ counts, int M, int K, int N, int kmax,
                 int act, long long sx, long long sw, long long so) {
  using namespace nvcuda;
  constexpr int BM = 128, BN = 128, BK = 64;
  constexpr int LDA = BK + 8;                    // padded, multiples of 8
  constexpr int LDB = TRANS ? BK + 8 : BN + 8;   // Bs is (n, k) with TRANS
  using BLayout = typename std::conditional<TRANS, nvcuda::wmma::col_major,
                                            nvcuda::wmma::row_major>::type;
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[TRANS ? BN * LDB : BK * LDB];
  __shared__ __align__(32) float Cs[8][16 * 16];

  x += blockIdx.z * sx;                 // this block's expert (batched form)
  w += blockIdx.z * sw;
  out += blockIdx.z * so;
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
      if (TRANS) {
        for (int e = tid; e < BN * BK / 8; e += 256) {   // w rows n0.., along k
          const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
          *reinterpret_cast<uint4*>(Bs + r * LDB + c) =
              *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * K + kb + c);
        }
      } else {
        for (int e = tid; e < BK * BN / 8; e += 256) {
          const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
          *reinterpret_cast<uint4*>(Bs + r * LDB + c) =
              *reinterpret_cast<const uint4*>(w + (size_t)(kb + r) * N + n0 + c);
        }
      }
      __syncthreads();
#pragma unroll
      for (int k16 = 0; k16 < BK; k16 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, BLayout> fb[4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
          wmma::load_matrix_sync(fa[a], As + (wm * 32 + a * 16) * LDA + k16, LDA);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const __nv_bfloat16* bp = TRANS ? Bs + (wn * 64 + b * 16) * LDB + k16
                                          : Bs + k16 * LDB + wn * 64 + b * 16;
          wmma::load_matrix_sync(fb[b], bp, LDB);
        }
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

// E > 1 is the expert-batched form: grid z runs over E (x, w, out)
// triples, sx, sw, so elements apart, that share one plan.
// Few rows, many blocks (the expert-batched decode): every weight byte
// feeds at most 8 rows, so the product is a stream of weight bytes.  A
// block owns one 128-column plan tile j, 8 rows and one expert; for each
// live K tile it starts all of its weight loads at once, straight from
// global memory into registers (16 bytes along N a thread, so a warp
// reads whole 256-byte row pieces), stages the 8 x 128 slice of x as
// f32 in shared memory, and multiplies.  The tile's 128 k rows are split
// over KG thread groups, whose partial sums meet once, after the last
// tile, through shared memory.  It needs a wide grid to keep enough
// loads in flight (one block per column tile, not per 32 columns), so
// `launch` takes it only for the expert-batched form and only when the
// grid fills the card twice over.
template <typename T> struct Raw;     // CPT values of T in 16 bytes
template <> struct Raw<float> {
  static constexpr int CPT = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
  }
};
template <> struct Raw<__nv_bfloat16> {
  static constexpr int CPT = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

constexpr int SM_ROWS = 8;            // rows per block of the stream kernel

template <typename T, bool EPI>
__global__ void __launch_bounds__(256)
bsmm_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ out,
                   const int* __restrict__ idx, const int* __restrict__ counts,
                   int M, int K, int N, int kmax, int act, long long sx,
                   long long sw, long long so) {
  constexpr int MR = SM_ROWS;
  constexpr int CPT = Raw<T>::CPT;     // columns per thread
  constexpr int NG = TILE / CPT;       // column groups (16 bf16, 32 f32)
  constexpr int KG = 256 / NG;         // k groups (16 bf16, 8 f32)
  constexpr int KPT = TILE / KG;       // k rows per thread per tile
  constexpr int V = Vec<T>::N;
  constexpr int WARPS = 8;
  __shared__ __align__(16) float xs[MR][TILE];          // x slice (m, k)
  __shared__ __align__(16) float red[WARPS][MR][TILE];  // partial sums

  x += blockIdx.z * sx;                 // this block's expert (batched form)
  w += blockIdx.z * sw;
  out += blockIdx.z * so;
  const int m0 = blockIdx.x * MR;
  const int j = blockIdx.y;
  const int n0 = j * TILE;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int ng = tid % NG, kg = tid / NG;
  const T* wcol = w + n0 + ng * CPT;

  float acc[MR][CPT];
#pragma unroll
  for (int a = 0; a < MR; ++a)
#pragma unroll
    for (int b = 0; b < CPT; ++b) acc[a][b] = 0.f;

  const int cnt = counts[j];
  for (int t = 0; t < cnt; ++t) {
    const int kb = idx[j * kmax + t] * TILE;
    uint4 raw[KPT];                     // this tile's weights, in flight
#pragma unroll
    for (int i = 0; i < KPT; ++i)
      raw[i] = *reinterpret_cast<const uint4*>(wcol + (size_t)(kb + kg + i * KG) * N);
    for (int e = tid; e < MR * TILE / V; e += 256) {
      const int r = e / (TILE / V), c = (e % (TILE / V)) * V;
      const int m = m0 + r;
      float v[V];
      if (m < M) {
        Vec<T>::load(x + (size_t)m * K + kb + c, v);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) xs[r][c + i] = v[i];
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < KPT; ++i) {
      const int k = kg + i * KG;
      float wf[CPT];
      Raw<T>::unpack(raw[i], wf);
#pragma unroll
      for (int a = 0; a < MR; ++a) {
        const float xv = xs[a][k];
#pragma unroll
        for (int b = 0; b < CPT; ++b) acc[a][b] = fmaf(xv, wf[b], acc[a][b]);
      }
    }
    __syncthreads();
  }

  // the KG partial sums of each output: the k groups of a warp first
#pragma unroll
  for (int o = NG; o < 32; o <<= 1)
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int b = 0; b < CPT; ++b)
        acc[a][b] += __shfl_xor_sync(0xffffffffu, acc[a][b], o);
  if (lane < NG) {
#pragma unroll
    for (int a = 0; a < MR; ++a)
#pragma unroll
      for (int b = 0; b < CPT; ++b) red[warp][a][ng * CPT + b] = acc[a][b];
  }
  __syncthreads();
  for (int e = tid; e < MR * TILE; e += 256) {
    const int a = e / TILE, n = e % TILE;
    const int m = m0 + a;
    if (m >= M) continue;
    float z = 0.f;
#pragma unroll
    for (int r = 0; r < WARPS; ++r) z += red[r][a][n];
    if (EPI) {
      if (bias != nullptr) z += to_f32(bias[n0 + n]);
      z = activate(z, act);
    }
    out[(size_t)m * N + n0 + n] = from_f32<T>(z);
  }
}

// the card's SM count, read once (the port drives one card)
static int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T, bool EPI, bool TRANS>
cudaError_t launch(const void* x, const void* w, const void* bias, void* out,
                   const int* idx, const int* counts, int M, int K, int N,
                   int kmax, int act, int E, long long sx, long long sw,
                   long long so, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  T* op = static_cast<T*>(out);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (M >= TILE) {
      dim3 grid(N / TILE, (M + TILE - 1) / TILE, E);
      bsmm_wmma_kernel<EPI, TRANS><<<grid, 256, 0, stream>>>(
          xp, wp, bp, op, idx, counts, M, K, N, kmax, act, sx, sw, so);
      return cudaGetLastError();
    }
  }
  const long long stream_blocks =
      (long long)E * (N / TILE) * ((M + SM_ROWS - 1) / SM_ROWS);
  if (E > 1 && !TRANS && M <= 4 * SM_ROWS &&
      stream_blocks >= 2 * sm_count()) {
    // expert-batched, few rows over a grid that fills the card twice:
    // stream the weights (the 2-D entry points keep their kernels)
    dim3 grid((M + SM_ROWS - 1) / SM_ROWS, N / TILE, E);
    bsmm_stream_kernel<T, EPI><<<grid, 256, 0, stream>>>(
        xp, wp, bp, op, idx, counts, M, K, N, kmax, act, sx, sw, so);
  } else if (M >= TILE) {
    constexpr int BM = 128, BN = 128, BK = 32, TM = 8, TN = 8;
    dim3 grid(N / BN, (M + BM - 1) / BM, E);
    bsmm_fwd_kernel<T, BM, BN, BK, TM, TN, EPI, TRANS>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(xp, wp, bp, op, idx, counts,
                                                      M, K, N, kmax, act, sx, sw, so);
  } else {
    // small M (decode): a whole plan tile per step, so one load round
    // trip per live tile instead of four
    constexpr int BM = 16, BN = 32, BK = 128, TM = 2, TN = 1;
    dim3 grid(N / BN, (M + BM - 1) / BM, E);
    bsmm_fwd_kernel<T, BM, BN, BK, TM, TN, EPI, TRANS>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(xp, wp, bp, op, idx, counts,
                                                      M, K, N, kmax, act, sx, sw, so);
  }
  return cudaGetLastError();
}

template <bool EPI, bool TRANS>
int dispatch(const void* x, const void* w, const void* bias, void* out,
             const int* idx, const int* counts, int M, int K, int N, int kmax,
             int dtype, int act, void* stream, int E = 1, long long sx = 0,
             long long sw = 0, long long so = 0) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, EPI, TRANS>(x, w, bias, out, idx, counts, M, K, N, kmax,
                                     act, E, sx, sw, so, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, EPI, TRANS>(x, w, bias, out, idx, counts, M, K, N,
                                             kmax, act, E, sx, sw, so, s);
  return cudaErrorInvalidValue;
}

// dw, f32 (and any type) on CUDA cores: one block per live tile l, a
// 16 x 16 thread grid with an 8 x 8 register tile each covers the
// 128 x 128 output; the row (contraction) loop steps by BR rows, staging
// x[:, kk[l]] and g[:, nn[l]] as f32 with 16-byte loads.
template <typename T>
__global__ void __launch_bounds__(256)
bsmm_dw_fma_kernel(const T* __restrict__ x, const T* __restrict__ g,
                   T* __restrict__ dw, const int* __restrict__ kk,
                   const int* __restrict__ nn, int M, int K, int N) {
  constexpr int BR = 32, TM = 8, TN = 8, NX = TILE / TN;
  constexpr int V = Vec<T>::N;
  __shared__ float xs[BR][TILE];   // (row, k)
  __shared__ float gs[BR][TILE];   // (row, n)
  const int k0 = kk[blockIdx.x] * TILE;
  const int n0 = nn[blockIdx.x] * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

  for (int m0 = 0; m0 < M; m0 += BR) {
    for (int e = tid; e < BR * TILE / V; e += 256) {
      const int r = e / (TILE / V), c = (e % (TILE / V)) * V;
      const int m = m0 + r;
      float xv[V], gv[V];
      if (m < M) {
        Vec<T>::load(x + (size_t)m * K + k0 + c, xv);
        Vec<T>::load(g + (size_t)m * N + n0 + c, gv);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) xv[i] = gv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        xs[r][c + i] = xv[i];
        gs[r][c + i] = gv[i];
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int r = 0; r < BR; ++r) {
      float av[TM], bv[TN];
#pragma unroll
      for (int a = 0; a < TM; ++a) av[a] = xs[r][ty + a * (TILE / TM)];
#pragma unroll
      for (int b = 0; b < TN; ++b) bv[b] = gs[r][tx + b * NX];
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b)
      dw[(size_t)(k0 + ty + a * (TILE / TM)) * N + n0 + tx + b * NX] =
          from_f32<T>(acc[a][b]);
}

// dw, bfloat16 on the tensor cores: one block per live tile, 8 warps
// each own a 32 x 64 piece of it.  x's rows are staged as they are,
// (row, k), and read as a column-major A fragment (A = x^T); g's rows
// (row, n) are the row-major B fragment.
__global__ void __launch_bounds__(256)
bsmm_dw_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ g,
                    __nv_bfloat16* __restrict__ dw, const int* __restrict__ kk,
                    const int* __restrict__ nn, int M, int K, int N) {
  using namespace nvcuda;
  constexpr int BR = 64, LD = TILE + 8;
  __shared__ __align__(32) __nv_bfloat16 As[BR * LD];
  __shared__ __align__(32) __nv_bfloat16 Bs[BR * LD];
  __shared__ __align__(32) float Cs[8][16 * 16];
  const int k0 = kk[blockIdx.x] * TILE;
  const int n0 = nn[blockIdx.x] * TILE;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  for (int m0 = 0; m0 < M; m0 += BR) {
    for (int e = tid; e < BR * TILE / 8; e += 256) {   // 16 B loads
      const int r = e / (TILE / 8), c = (e % (TILE / 8)) * 8;
      const int m = m0 + r;
      uint4 xv = make_uint4(0u, 0u, 0u, 0u), gv = xv;
      if (m < M) {
        xv = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + c);
        gv = *reinterpret_cast<const uint4*>(g + (size_t)m * N + n0 + c);
      }
      *reinterpret_cast<uint4*>(As + r * LD + c) = xv;
      *reinterpret_cast<uint4*>(Bs + r * LD + c) = gv;
    }
    __syncthreads();
#pragma unroll
    for (int r16 = 0; r16 < BR; r16 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wmma::load_matrix_sync(fa[a], As + r16 * LD + wm * 32 + a * 16, LD);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        wmma::load_matrix_sync(fb[b], Bs + r16 * LD + wn * 64 + b * 16, LD);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
    __syncthreads();
  }

  float* cs = Cs[warp];
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      wmma::store_matrix_sync(cs, acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int k = k0 + wm * 32 + a * 16 + e / 16;
        const int n = n0 + wn * 64 + b * 16 + e % 16;
        dw[(size_t)k * N + n] = __float2bfloat16(cs[e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the launch.
extern "C" int bsmm_launch(const void* x, const void* w, void* out,
                           const int* idx, const int* counts, int M, int K,
                           int N, int kmax, int dtype, void* stream) {
  return dispatch<false, false>(x, w, nullptr, out, idx, counts, M, K, N, kmax,
                                dtype, ACT_NONE, stream);
}

// bias may be null (then act(acc) alone); act: 0 none, 1 relu, 2 gelu (tanh), 3 silu.
extern "C" int bsmm_epilogue_launch(const void* x, const void* w,
                                    const void* bias, void* out,
                                    const int* idx, const int* counts, int M,
                                    int K, int N, int kmax, int dtype, int act,
                                    void* stream) {
  return dispatch<true, false>(x, w, bias, out, idx, counts, M, K, N, kmax, dtype,
                               act, stream);
}

// The expert-batched forward (the reference's jax.vmap of plan_matmul over
// experts, src/repro/models/moe.py:81-83): out[e] (M, N) = x[e] (M, K) @
// (w[e] (K, N) * tile bitmap) for e < E, contiguous (E, M, K), (E, K, N)
// and (E, M, N), one plan shared by every expert, one launch (grid z = e).
extern "C" int bsmm_batched_launch(const void* x, const void* w, void* out,
                                   const int* idx, const int* counts, int E,
                                   int M, int K, int N, int kmax, int dtype,
                                   void* stream) {
  return dispatch<false, false>(x, w, nullptr, out, idx, counts, M, K, N, kmax,
                                dtype, ACT_NONE, stream, E, (long long)M * K,
                                (long long)K * N, (long long)M * N);
}

// dx (M, K) = g (M, N) @ (w (K, N) * tile bitmap)^T over the transposed
// plan: idx_t (K / 128, nmax) live N tiles of each K-row tile, counts_t.
extern "C" int bsmm_dx_launch(const void* g, const void* w, void* dx,
                              const int* idx_t, const int* counts_t, int M,
                              int K, int N, int nmax, int dtype, void* stream) {
  // the forward walk with contraction N and output width K
  return dispatch<false, true>(g, w, nullptr, dx, idx_t, counts_t, M, N, K, nmax,
                               dtype, ACT_NONE, stream);
}

// dw (K, N): for each of the L live tiles l, rows kk[l] * 128.. and
// columns nn[l] * 128.. get x (M, K)[:, tile]^T @ g (M, N)[:, tile].
// Dead tiles are not written: the caller passes a zeroed dw.
extern "C" int bsmm_dw_launch(const void* x, const void* g, void* dw,
                              const int* kk, const int* nn, int L, int M, int K,
                              int N, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0) return cudaSuccess;
  if (dtype == 0) {
    bsmm_dw_fma_kernel<float><<<L, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g),
        static_cast<float*>(dw), kk, nn, M, K, N);
  } else if (dtype == 1) {
    bsmm_dw_wmma_kernel<<<L, 256, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(dw), kk, nn, M, K, N);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
