// Block-sparse matmul, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/bsmm.py:
//   _bsmm_kernel (plain forward) and _bsmm_epilogue_kernel (bias +
//   relu/gelu/silu fused into the flush): the 2-D forward routes below,
//   EPI selecting the epilogue;
//   _bsmm_dx_kernel (dx = g @ (w * bitmap)^T over the transposed plan):
//   bsmm_dx_wgmma_kernel for bfloat16 from 64 rows, bsmm_fwd_kernel with
//   TRANS set otherwise, both reading w's tiles along N;
//   _bsmm_dw_kernel (dw tile = x^T g for every live tile): bsmm_dw_*
//   below, which store each live tile straight into the zeroed dense
//   grad instead of materialising (L, 128, 128) and scattering.
//
//   out[M, N] = sum over t < counts[j] of x[:, K-tile idx[j, t]] @ w[K-tile idx[j, t], N-tile j]
//
// over the plan's 128x128 crossbar tiles.  Every kernel walks the live
// K tiles idx[j, :counts[j]] of its column tile itself: dead tiles are
// never read.  The flush adds the bias (in f32), applies the activation
// and casts to the output type; an all-dead column tile is act(bias).
//
// The 2-D forward (bsmm2d_launch) has three routes, chosen on the host
// from (M, K, N, dtype, plan) alone (bsmm.bsmm_route / bsmm_splits):
//
// 1. bsmm2d_stream_kernel, every M < 64 (decode rows), both dtypes.  A
//    block owns 32 columns of column tile j, 8 or 32 rows, and piece z
//    of j's live list: the list is cut into S contiguous pieces of whole
//    tiles (never more than its count), S the most that keeps every
//    block resident at once (3 an SM).  Each block streams its tiles
//    through a ring of 6 cp.async.cg 16-byte stages (5 in flight, w rows
//    coalesced along N, x rows zero-filled past M) and multiplies on the
//    tensor cores at up to 8 bf16 rows (mma.sync m16n8k16, B by
//    ldmatrix.trans from a swizzled stage, a warp a 16-row K step), on
//    the CUDA cores otherwise.  The pieces' f32 partials meet through a workspace
//    (S, M, N): the last block to finish an output block, found by an
//    atomic counter that it then resets to 0, adds them in split order
//    0..S-1, applies the epilogue and stores (no atomics touch the
//    values).  Bound on the H100 by the bytes of the live weight tiles
//    (~2 flops per weight byte at 8 rows) and, at this size, by launch
//    latency.
//
// 2. bsmm2d_wgmma_kernel, bfloat16 from 64 rows (prefill, the retrain
//    forward).  A block owns a 128 x 128 output tile and one piece of its
//    live list.  A producer warp keeps a ring of TMA loads (x 128 x 64
//    and w 64 x 128, both 128-byte swizzled, w as wgmma's MN-major B)
//    behind full/empty mbarriers, each live tile's coordinates read from
//    idx, so the gather costs nothing; one consumer warpgroup runs
//    wgmma m64n128k16 into f32 registers with one stage of wgmmas in
//    flight.  The ring is 6 stages where the grid has at most one block
//    an SM and 3 (two blocks an SM) where it has more.  Split pieces of
//    a tile form one thread-block cluster: each block stages its f32
//    tile in its own ring, and each sums one slice of the tile's rows
//    over every piece, in split order, through distributed shared
//    memory, then applies the epilogue in one rolled pass of coalesced
//    stores.  What bounds it at these sizes: each block's walk of its
//    column's live list, fed at what one SM can pull; splits spread it.
//
// 3. bsmm2d_fma_kernel, float32 from 64 rows: CUDA-core FMA (no TF32:
//    the reference computes in f32), 64 rows a block, split through the
//    workspace as route 1.
//
// Two calls at a fixed (M, K, N, plan) give the same bits, and a row's
// bits never depend on the other rows' values (at a fixed M: a
// different M may change the route or the split count).
//
// The expert-batched forward (bsmm_batched_launch): the reference vmaps
// the Pallas call over the expert axis into one launch, and so does
// this, with the one plan that the union of the expert masks gives, on
// one of three routes chosen on the host (bsmm.bsmm_batched_route /
// bsmm_batched_splits):
// - wgmma, bfloat16 from 64 rows an expert (training capacity, C = 320
//   in deepseek-v3's retrain): route 2's mainloop over 3-D tensor maps
//   (cols, rows, E), so that a box running past row C zero-fills
//   instead of reading expert e + 1's rows, and the store masked at C.
//   The grid is one-dimensional (E x column tiles x row blocks; z holds
//   a split's clusters, and the split rule counts the grid over all
//   experts, so at MoE shapes nothing splits), placed expert-major: an
//   expert's row blocks innermost, then its column tiles, so that the
//   row blocks of a column tile read its live w boxes together and the
//   column tiles re-read x_e while it is in L2; each live w box leaves
//   device memory about once per expert.  x comes in 64-row boxes, and
//   a last row block of at most 64 rows (C = 320 = 2 x 128 + 64) loads
//   one of them a stage and runs m64 wgmmas for it alone: no half-empty
//   128-row block.  Both choices were timed against their alternatives
//   on the H100 (PERF.md): tile-major placement (every expert's row
//   blocks of a column tile, then the next tile) was 1.3-1.4x slower; a
//   cluster of an (expert, tile)'s row blocks that loads each w box once
//   and multicasts it 2.4-2.7x slower, each block's ring slot then
//   waiting on the slowest block of its cluster.  What bounds it at C = 320:
//   the bytes of x, the live w tiles and out, at 1.6-1.8x that bound
//   (PERF.md).
// - stream, at most 32 rows an expert over a grid that fills the card
//   twice (decode and MoE prefill: 8-24 rows of 256 experts):
//   bsmm_stream_kernel, each live weight tile streamed through
//   registers instead of staged in shared memory, grid z = E.
// - simt, otherwise (float32; bfloat16 below 64 rows on a narrow grid):
//   bsmm_fwd_kernel, the CUDA-core tile walk, grid z = E.
//
// Backward.  dx walks, for its output column tile k (a K tile), the
// live N tiles idx_t[k, :counts_t[k]] (the transposed plan), on one of
// two routes chosen on the host (bsmm.bsmm_dx_route / bsmm_dx_splits):
// - wgmma, bfloat16 from 64 rows: route 2's machinery with B read
//   K-major.  For dx the contraction index n is the contiguous one in a
//   row of w (K, N), so a stage is one 64-column x 128-row TMA box of g
//   at (n, m0) (A, exactly as the forward reads x) and one of w at (n,
//   k0) (B, 128 K rows of 64 n each: wgmma's K-major B, tnspB = 0, 32
//   bytes a k16 step, the stride byte offset one 8-row atom).  Block
//   (mb, k, z) multiplies rows mb * 128.. by piece z of k's live list;
//   pieces meet in a cluster as route 2's, with no epilogue; an all-dead
//   K-row tile stores zeros.  f32 accumulation, one rounding to bf16 at
//   the store.  At training row counts (2 M flops a live weight
//   element) its operations bound it at llama's wide shapes and the
//   bytes of g, w and dx at the narrow ones; a fixed cost a launch and
//   the longest K-row list, walked by one block, keep it above both.
// - simt, float32 and bfloat16 below 64 rows: the legacy CUDA-core walk
//   (bsmm_fwd_kernel with TRANS, w staged as its transpose).
// Two dx calls at a fixed (M, K, N, plan) give the same bits, and a
// row's bits never depend on the other rows.  dw runs one block per live tile l
// and piece z of its rows (its contraction), split where the L live
// tiles leave SMs idle: bf16 multiplies with TMA + wgmma (A = the x tile
// read MN-major from shared memory, i.e. x^T; B = the g tile, MN-major),
// its pieces meeting in a cluster as route 2's; f32 on the CUDA cores,
// through the workspace.  Rows past M are zero-filled and add nothing.
// It is bound by the operations at training row counts (2 * M flops per
// tile element against 2 * 2 bytes a row) and by the bytes of x's and
// g's live columns when M is small.  Times against the bounds are in
// PERF.md.
//
// The expert-batched backward (bsmm_batched_dx_launch,
// bsmm_batched_dw_launch: the backward of the reference's jax.vmap of
// plan_matmul over experts) runs the same kernels over E experts that
// share one plan, in one launch.  Each expert's rows are the MoE
// capacity C, a multiple of 8 but not of the 64- or 128-row box, so the
// bf16 kernels read g, x and w through 3-D tensor maps (cols, rows, E):
// a box that runs past row C zero-fills instead of reading expert e +
// 1's rows, which dw would sum into expert e's tile; dx masks its store
// at C.  dx's wgmma grid is the batched forward's (one-dimensional,
// expert-major, K-row tiles in place of column tiles, g in 64-row boxes
// with the same one-slice last block; z for the split's clusters); on
// simt the expert is grid z, as in dw's grids.  At C = 320 placing dx
// expert-major made it 1.3-1.4x faster (each g_e re-read by its K-row
// tiles while in L2, where tile-major re-read it after all 42 MB of g
// had passed), the one-slice tail 4-5 % more (PERF.md).  At training capacity
// the live weight tiles' bytes, read once per expert, and g's and dx's
// bound dx and dw.
#include <cuda.h>           // CUtensorMap and its enums (header only: no -lcuda)
#include <cuda_runtime.h>
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int TILE = 128;   // the plan's tile edge (the paper's crossbar)

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3 };

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// z * sigmoid(t) without branches: __expf and the approximate divide
// (both within a few ulp in f32; exp(-t) = inf gives -0 or 0, not NaN)
__device__ __forceinline__ float times_sigmoid(float z, float t) {
  return __fdividef(z, 1.f + __expf(-t));
}

__device__ __forceinline__ float activate(float z, int act) {
  switch (act) {
    case ACT_RELU:
      return fmaxf(z, 0.f);
    case ACT_GELU: {  // tanh form, as jax.nn.gelu's default:
      // 0.5 z (1 + tanh(u)) = z sigmoid(2 u)
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return times_sigmoid(z, 2.f * c * (z + 0.044715f * z * z * z));
    }
    case ACT_SILU:
      return times_sigmoid(z, z);
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
template <typename T, int BM, int BN, int BK, int TM, int TN, bool TRANS>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
bsmm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                const int* __restrict__ idx, const int* __restrict__ counts,
                int M, int K, int N, int kmax, long long sx, long long sw,
                long long so) {
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
      out[(size_t)m * N + n] = from_f32<T>(acc[a][b]);
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
// only the expert-batched forward takes it, on its `stream` route
// (bsmm.bsmm_batched_route: at most 32 rows an expert, over a grid that
// fills the card twice).
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

template <typename T>
__global__ void __launch_bounds__(256)
bsmm_stream_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
                   const int* __restrict__ idx, const int* __restrict__ counts,
                   int M, int K, int N, int kmax, long long sx, long long sw,
                   long long so) {
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

// The legacy CUDA-core walks of E (x, w, out) triples, grid z = E: the
// weight-streaming kernel (`streamed`, the batched forward's `stream`
// route) or bsmm_fwd_kernel (`simt`: the batched forward, and with TRANS
// dx, below 64 bfloat16 rows or in float32).
template <typename T, bool TRANS>
cudaError_t launch(const void* x, const void* w, void* out, const int* idx,
                   const int* counts, int M, int K, int N, int kmax, int E,
                   long long sx, long long sw, long long so, bool streamed,
                   cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  if (streamed && !TRANS) {
    dim3 grid((M + SM_ROWS - 1) / SM_ROWS, N / TILE, E);
    bsmm_stream_kernel<T><<<grid, 256, 0, stream>>>(
        xp, wp, op, idx, counts, M, K, N, kmax, sx, sw, so);
  } else if (M >= TILE) {
    constexpr int BM = 128, BN = 128, BK = 32, TM = 8, TN = 8;
    dim3 grid(N / BN, (M + BM - 1) / BM, E);
    bsmm_fwd_kernel<T, BM, BN, BK, TM, TN, TRANS>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(xp, wp, op, idx, counts, M, K, N,
                                                      kmax, sx, sw, so);
  } else {
    // small M (decode): a whole plan tile per step, so one load round
    // trip per live tile instead of four
    constexpr int BM = 16, BN = 32, BK = 128, TM = 2, TN = 1;
    dim3 grid(N / BN, (M + BM - 1) / BM, E);
    bsmm_fwd_kernel<T, BM, BN, BK, TM, TN, TRANS>
        <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(xp, wp, op, idx, counts, M, K, N,
                                                      kmax, sx, sw, so);
  }
  return cudaGetLastError();
}

template <bool TRANS>
int dispatch(const void* x, const void* w, void* out, const int* idx, const int* counts,
             int M, int K, int N, int kmax, int dtype, void* stream, int E,
             long long sx, long long sw, long long so, bool streamed = false) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, TRANS>(x, w, out, idx, counts, M, K, N, kmax, E, sx, sw, so,
                                streamed, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, TRANS>(x, w, out, idx, counts, M, K, N, kmax, E, sx, sw,
                                        so, streamed, s);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The 2-D forward routes and dw: helpers
// ---------------------------------------------------------------------------
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

// two consecutive elements as f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Piece z of a list of c items cut into parts = min(S, max(c, 1))
// contiguous pieces of balanced size: items [t0, t1).  bsmm.split_pieces
// on the host is the same rule.
__device__ __forceinline__ void piece(int c, int S, int z, int& parts, int& t0, int& t1) {
  parts = min(S, max(c, 1));
  t0 = (int)((long long)z * c / parts);
  t1 = (int)((long long)(z + 1) * c / parts);
}

// Called by every thread of the block once its partial tile is stored
// in the workspace.  True in every thread of the block that is the last
// of `parts` to arrive at *counter; that block resets it to 0 for the
// next launch and may then read every piece's partial (with __ldcg).
__device__ __forceinline__ bool last_to_finish(int* counter, int parts) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(counter, 1);
    last = done == parts - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  const bool r = last != 0;
  if (r) __threadfence();
  return r;
}

// the split-order sum of two adjacent f32 outputs at element offset o of
// each of the `parts` (M, N) partials mn elements apart, read four pieces
// at a time so that their loads are in flight together
__device__ __forceinline__ float2 sum_pieces(const float* ws, size_t mn, size_t o, int parts) {
  float2 s = make_float2(0.f, 0.f);
  for (int p0 = 0; p0 < parts; p0 += 4) {
    float2 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (p0 + i < parts) v[i] = __ldcg(reinterpret_cast<const float2*>(ws + (p0 + i) * mn + o));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (p0 + i >= parts) break;
      if (p0 + i == 0) {
        s = v[0];
      } else {
        s.x += v[i].x;
        s.y += v[i].y;
      }
    }
  }
  return s;
}

__device__ __forceinline__ float epilogue(float z, const float* bias, int n, int act) {
  if (bias != nullptr) z += bias[n];
  return activate(z, act);
}
__device__ __forceinline__ float epilogue(float z, const __nv_bfloat16* bias, int n, int act) {
  if (bias != nullptr) z += __bfloat162float(bias[n]);
  return activate(z, act);
}

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

// ---------------------------------------------------------------------------
// Route 1: streaming, M < 64
// ---------------------------------------------------------------------------
// mma.sync m16n8k16, bf16 in, f32 accumulate: d += a (16 x 16, rows 8-15
// zero) b (16 x 8)
__device__ __forceinline__ void mma_16816(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices from shared memory, transposed (each lane
// names one row of one matrix)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

template <typename T, int BM>
struct Stream2d {
  // bfloat16 at up to 8 rows multiplies on the tensor cores (mma.sync,
  // a warp a 16-row K step); float32, and 9-63 rows, on the CUDA cores
  static constexpr bool TC = std::is_same<T, __nv_bfloat16>::value && BM == 8;
  static constexpr int BN = 32;                           // columns a block
  static constexpr int PAIRS = BN / 2;                    // column pairs
  static constexpr int KG = 256 / PAIRS;                  // K groups of threads (16)
  static constexpr int RK = 16 / (int)sizeof(T);          // rows a thread per stage: one 16 B x load
  static constexpr int R = KG * RK;                       // K rows a stage: 128 bf16, 64 f32
  static constexpr int CPT = TILE / R;                    // stages a tile
  static constexpr int NS = 6;                            // ring depth
  static constexpr int ROWB = BN * (int)sizeof(T);        // bytes of a w row
  // CUDA cores, 64-byte rows: one spare row after every RK, so that the
  // two K groups of a warp read different banks; tensor cores: each
  // row's 16-byte pieces XOR-swizzled by (row / 2) % 4, so that
  // ldmatrix's eight rows hit eight bank groups, and x rows padded by 16
  // bytes, so that the eight rows' A fragments do too
  static constexpr int GPAD = !TC && ROWB == 64 ? 64 : 0;
  static constexpr int W_BYTES = R * ROWB + KG * GPAD;
  static constexpr int XROW = R * (int)sizeof(T) + (TC ? 16 : 0);
  static constexpr int X_BYTES = BM * XROW;
  static constexpr int STAGE = W_BYTES + X_BYTES;
  static constexpr int SMEM = NS * STAGE;
  static_assert(STAGE % 16 == 0, "16-byte stages");
  static_assert(8 * BM * BN * 4 <= SMEM, "the reduction reuses the ring");
};

// A block owns rows m0..m0+BM, columns n0..n0+32 and piece z of column
// tile j's live list.  On the CUDA cores thread (pair pr, K group kg)
// owns columns 2 pr, 2 pr + 1 of every row, summed over rows kg * RK ..
// of each stage; on the tensor cores warp w owns K rows 16 w .. of each
// stage.
template <typename T, int BM, bool EPI>
__global__ void __launch_bounds__(256, BM <= 8 ? 3 : 2)
bsmm2d_stream_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ out,
                     float* __restrict__ ws, int* __restrict__ cnt,
                     const int* __restrict__ idx, const int* __restrict__ counts,
                     int M, int K, int N, int kmax, int act, int S) {
  using P = Stream2d<T, BM>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int n0 = blockIdx.x * P::BN;
  const int m0 = blockIdx.y * BM;
  const int z = blockIdx.z;
  const int j = n0 / TILE;
  int parts, t0, t1;
  piece(counts[j], S, z, parts, t0, t1);
  if (z >= parts) return;
  const int* live = idx + (size_t)j * kmax;
  const int nst = (t1 - t0) * P::CPT;
  const int tid = threadIdx.x;
  const int pr = tid % P::PAIRS, kg = tid / P::PAIRS;

  auto issue = [&](int st) {
    uint8_t* s = smem + (st % P::NS) * P::STAGE;
    const size_t k = (size_t)live[t0 + st / P::CPT] * TILE + (st % P::CPT) * P::R;
    constexpr int WC = P::ROWB / 16;                    // 16 B pieces a w row
    for (int c = tid; c < P::R * WC; c += 256) {
      const int r = c / WC, q = c % WC;
      const int at = P::TC ? r * P::ROWB + ((q ^ ((r >> 1) & 3)) << 4)
                           : r * P::ROWB + (r / P::RK) * P::GPAD + q * 16;
      cp_async16(s + at, reinterpret_cast<const uint8_t*>(w + (k + r) * N + n0) + q * 16);
    }
    constexpr int XC = P::R * (int)sizeof(T) / 16;      // 16 B pieces an x row
    for (int c = tid; c < BM * XC; c += 256) {
      const int r = c / XC, q = c % XC;
      const bool ok = m0 + r < M;                        // rows past M read as 0
      cp_async16_zfill(s + P::W_BYTES + r * P::XROW + q * 16,
                       reinterpret_cast<const uint8_t*>(
                           x + (size_t)(ok ? m0 + r : 0) * K + k) + q * 16,
                       ok);
    }
  };

#pragma unroll
  for (int st = 0; st < P::NS - 1; ++st) {
    if (st < nst) issue(st);
    cp_async_commit();
  }

  float acc[BM][2];
#pragma unroll
  for (int m = 0; m < BM; ++m) acc[m][0] = acc[m][1] = 0.f;
  float tc[4][4] = {};                   // tensor cores: 4 column groups of 8
  const int warp = tid / 32, lane = tid % 32;

  for (int st = 0; st < nst; ++st) {
    cp_async_wait<P::NS - 2>();          // this thread's pieces of stage st
    __syncthreads();                     // everyone's; slot st - 1 is free
    if (st + P::NS - 1 < nst) issue(st + P::NS - 1);
    cp_async_commit();

    const uint8_t* s = smem + (st % P::NS) * P::STAGE;
    if constexpr (P::TC) {
      // A: row m = lane / 4 of x, K columns 16 warp + 2 (lane % 4) (+ 8);
      // B: the 16 x 32 w rows 16 warp.., one ldmatrix.x4 a 16-column half
      const uint8_t* xs = s + P::W_BYTES + (lane >> 2) * P::XROW + warp * 32 + (lane & 3) * 4;
      const uint32_t a0 = *reinterpret_cast<const uint32_t*>(xs);
      const uint32_t a2 = *reinterpret_cast<const uint32_t*>(xs + 16);
      const int k = warp * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);  // this lane's row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = 2 * h + (lane >> 4);               // its 8-column group
        uint32_t b[4];
        ldmatrix_x4_trans(b, s + k * P::ROWB + ((q ^ ((k >> 1) & 3)) << 4));
        mma_16816(tc[2 * h], a0, a2, b[0], b[1]);
        mma_16816(tc[2 * h + 1], a0, a2, b[2], b[3]);
      }
      continue;
    }
    const T* xsm = reinterpret_cast<const T*>(s + P::W_BYTES);
    float wv[P::RK][2];
#pragma unroll
    for (int i = 0; i < P::RK; ++i) {
      const int r = kg * P::RK + i;
      const float2 v = load2(reinterpret_cast<const T*>(s + r * P::ROWB + kg * P::GPAD) + 2 * pr);
      wv[i][0] = v.x;
      wv[i][1] = v.y;
    }
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      float xv[P::RK];
      Vec<T>::load(xsm + m * P::R + kg * P::RK, xv);
#pragma unroll
      for (int i = 0; i < P::RK; ++i) {
        acc[m][0] = fmaf(xv[i], wv[i][0], acc[m][0]);
        acc[m][1] = fmaf(xv[i], wv[i][1], acc[m][1]);
      }
    }
  }

  // the K groups' sums: (CUDA cores) the two of a warp by a shuffle,
  // then the eight warps' in warp order through shared memory
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);           // (warp, m, n)
  if constexpr (P::TC) {
#pragma unroll
    for (int g = 0; g < 4; ++g)          // rows 0-7: the accumulator's first half
      store2(red + (warp * BM + (lane >> 2)) * P::BN + 8 * g + 2 * (lane & 3), tc[g][0],
             tc[g][1]);
  } else {
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      acc[m][0] += __shfl_xor_sync(0xffffffffu, acc[m][0], 16);
      acc[m][1] += __shfl_xor_sync(0xffffffffu, acc[m][1], 16);
    }
    if (lane < 16) {
#pragma unroll
      for (int m = 0; m < BM; ++m)
        store2(red + (warp * BM + m) * P::BN + 2 * pr, acc[m][0], acc[m][1]);
    }
  }
  __syncthreads();
  constexpr int PER = (BM * P::PAIRS + 255) / 256;       // output pairs a thread
  float2 v[PER];
  int row[PER], col[PER];
  bool ok[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = tid + u * 256;                         // output pair e
    const int m = e / P::PAIRS, c = 2 * (e % P::PAIRS);
    row[u] = m0 + m;
    col[u] = n0 + c;
    ok[u] = e < BM * P::PAIRS && m0 + m < M;
    v[u] = make_float2(0.f, 0.f);
    if (e < BM * P::PAIRS) {
      v[u] = load2(red + m * P::BN + c);
#pragma unroll
      for (int r = 1; r < 8; ++r) {
        const float2 o = load2(red + (r * BM + m) * P::BN + c);
        v[u].x += o.x;
        v[u].y += o.y;
      }
    }
  }
  if (parts > 1) {
    const size_t mn = (size_t)M * N;
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (ok[u]) store2(ws + z * mn + (size_t)row[u] * N + col[u], v[u].x, v[u].y);
    if (!last_to_finish(cnt + blockIdx.x + gridDim.x * blockIdx.y, parts)) return;
#pragma unroll
    for (int u = 0; u < PER; ++u)
      if (ok[u]) v[u] = sum_pieces(ws, mn, (size_t)row[u] * N + col[u], parts);
  }
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    if (!ok[u]) continue;
    float a = v[u].x, b = v[u].y;
    if (EPI) {
      a = epilogue(a, bias, col[u], act);
      b = epilogue(b, bias, col[u] + 1, act);
    }
    store2(out + (size_t)row[u] * N + col[u], a, b);
  }
}

// ---------------------------------------------------------------------------
// Route 3: float32 from 64 rows on the CUDA cores
// ---------------------------------------------------------------------------
// A block owns rows m0..m0+64 of column tile j and one piece of its live
// list; each thread a 4 x 8 register tile; the K loop steps by 32 rows,
// staging x (transposed) and w as f32.
template <bool EPI>
__global__ void __launch_bounds__(256)
bsmm2d_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias, float* __restrict__ out,
                  float* __restrict__ ws, int* __restrict__ cnt,
                  const int* __restrict__ idx, const int* __restrict__ counts,
                  int M, int K, int N, int kmax, int act, int S) {
  constexpr int BM = 64, BN = 128, BK = 32, TM = 4, TN = 8;
  constexpr int NX = BN / TN, NY = 256 / NX;
  static_assert(NY * TM == BM, "block rows");
  __shared__ float xs[BK][BM + 1];      // (k, m)
  __shared__ __align__(16) float wsm[BK][BN];   // (k, n)

  const int m0 = blockIdx.x * BM;
  const int j = blockIdx.y;
  const int n0 = j * BN;
  const int z = blockIdx.z;
  int parts, t0, t1;
  piece(counts[j], S, z, parts, t0, t1);
  if (z >= parts) return;
  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

  for (int t = t0; t < t1; ++t) {
    const int kt = idx[(size_t)j * kmax + t];
    for (int kk = 0; kk < TILE; kk += BK) {
      const int kb = kt * TILE + kk;
      for (int e = tid; e < BM * BK / 4; e += 256) {   // 16 B loads along k
        const int r = e / (BK / 4), c = (e % (BK / 4)) * 4;
        const int m = m0 + r;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (m < M) Vec<float>::load(x + (size_t)m * K + kb + c, v);
#pragma unroll
        for (int i = 0; i < 4; ++i) xs[c + i][r] = v[i];
      }
      for (int e = tid; e < BK * BN / 4; e += 256) {   // 16 B loads along n
        const int r = e / (BN / 4), c = (e % (BN / 4)) * 4;
        *reinterpret_cast<float4*>(&wsm[r][c]) =
            *reinterpret_cast<const float4*>(w + (size_t)(kb + r) * N + n0 + c);
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < BK; ++k) {
        float av[TM], bv[TN];
#pragma unroll
        for (int a = 0; a < TM; ++a) av[a] = xs[k][ty + a * NY];
#pragma unroll
        for (int b = 0; b < TN; ++b) bv[b] = wsm[k][tx + b * NX];
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int b = 0; b < TN; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
      }
      __syncthreads();
    }
  }

  const size_t mn = (size_t)M * N;
  if (parts > 1) {
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      const int m = m0 + ty + a * NY;
      if (m >= M) continue;
#pragma unroll
      for (int b = 0; b < TN; ++b) ws[z * mn + (size_t)m * N + n0 + tx + b * NX] = acc[a][b];
    }
    if (!last_to_finish(cnt + blockIdx.x + gridDim.x * blockIdx.y, parts)) return;
    for (int p = 0; p < parts; ++p) {    // every piece in split order, own included
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        const int m = m0 + ty + a * NY;
        if (m >= M) continue;
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          const float v = __ldcg(ws + p * mn + (size_t)m * N + n0 + tx + b * NX);
          acc[a][b] = p == 0 ? v : acc[a][b] + v;
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int m = m0 + ty + a * NY;
    if (m >= M) continue;
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int n = n0 + tx + b * NX;
      out[(size_t)m * N + n] = EPI ? epilogue(acc[a][b], bias, n, act) : acc[a][b];
    }
  }
}

// ---------------------------------------------------------------------------
// Route 2 (bfloat16 from 64 rows) and bf16 dw: TMA-fed wgmma
// ---------------------------------------------------------------------------
namespace wg {

constexpr int BM = 128;           // output rows a block (two 64-row slices)
constexpr int BN = 128;           // output columns a block (one tile)
constexpr int BKS = 64;           // contraction rows a stage
constexpr int CONSUMERS = 128;    // one warpgroup runs the wgmmas
constexpr int THREADS = CONSUMERS + 32;   // and one warp issues the TMA loads
constexpr int ROW = 128;          // bytes a swizzled row
constexpr int ATOM = 8 * ROW;     // one 128B-swizzle atom: 8 rows
constexpr int BOX = BKS * ROW;    // one 64 x 64 bf16 box
constexpr int STAGE = 4 * BOX;    // A (two boxes) + B (two boxes): 32 KB

// A ring of ST stages: 3 where two blocks share an SM (grids of more
// blocks than SMs), 6 where a block has its SM to itself.  The dynamic
// shared memory a block asks for (bsmm.wgmma_smem_bytes) is the ring,
// its barriers and 1 KB to align the ring to the swizzle atom.
template <int ST>
struct Ring {
  static constexpr int BAR_OFF = ST * STAGE;            // full, then empty barriers
  static constexpr int SMEM = BAR_OFF + 16 * ST + 1024;
  static_assert(SMEM <= 232448, "over the 227 KB a block may take");
};
constexpr int SHARED = 3, ALONE = 6;
constexpr int MAX_PIECES = 4;     // blocks of a cluster that meet on one tile
static_assert(2 * (Ring<SHARED>::SMEM + 1024) <= 233472, "two blocks an SM");
static_assert(BM * (BN + 4) * 4 <= SHARED * STAGE, "the epilogue's tile fits the ring");

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

// the same box of expert c2's slice of an (E, rows, cols) tensor: rows
// past the slice's end zero-fill instead of reading expert c2 + 1's
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
         "r"(c2)
      : "memory");
}

template <bool R3>
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         const int* c, int i) {
  if constexpr (R3)
    tma_load_3d(dst, map, bar, c[i], c[i + 1], c[8]);
  else
    tma_load_2d(dst, map, bar, c[i], c[i + 1]);
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
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
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

// d (64 x 128 f32) += A (64 x 16, smem) B (16 x 128, smem).  A is
// K-major (TA = 0: the forward's x, dx's g) or MN-major (TA = 1: dw's
// x^T); B is MN-major (TB = 1: the forward's w and dw's g, two 64-column
// boxes BOX bytes apart, the descriptor's leading byte offset) or
// K-major (TB = 0: dx's w, 128 rows of 64 contraction elements).
template <int TA, int TB>
__device__ __forceinline__ void mma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, %67, %68;\n}"
      : WG_D16(0), WG_D16(16), WG_D16(32), WG_D16(48)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

#undef WG_D16
#undef WG_D4

enum Mode { FWD = 0, DW = 1, DX = 2 };

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// the consumer warpgroup's own barrier (named barrier 1)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" :: "n"(CONSUMERS) : "memory");
}

// The mainloop shared by the forward, dw and dx: nst stages of BKS
// contraction rows, each A and B 16 KB by TMA; `coords(g, c)` gives
// stage g's box coordinates as (inner, outer) pairs: A box 0, A box 1
// (dw: two 64-row boxes of x; the 2-D FWD and DX one 64 x 128 box), B
// box 0, B box 1 (FWD and DW: two 64-column boxes; the 2-D DX one 64 x
// 128 box of w, the batched DX two 64-row ones); with R3 (the
// expert-batched forms) the maps are 3-D, (cols, rows, E), c[8] is the
// block's expert, and the batched FWD and DX read A as SL boxes of 64
// rows: SL = 1 for a last row block of at most 64 rows, which loads and
// multiplies one 64-row slice instead of a half-empty 128-row tile.  The
// producer warp's first thread keeps every free slot of the ring
// loading; the consumer warpgroup keeps one stage of wgmmas in flight
// and frees a slot (its empty barrier) as soon as the wgmmas that read
// it are done.  Returns in the producer warp once its loads are issued
// (the warp stays in the block for the cluster's barriers).
template <int MODE, int STAGES, bool R3, int SL = 2, typename Coords>
__device__ __forceinline__ void mainloop(const CUtensorMap* amap, const CUtensorMap* bmap,
                                         uint32_t base, uint32_t full_bar, int nst,
                                         Coords coords, float (&d)[2][64]) {
  static_assert(SL == 2 || (R3 && MODE != DW), "one slice: the batched FWD and DX only");
  constexpr bool A64 = R3 && MODE != DW;            // A in SL boxes of 64 rows
  constexpr bool B2 = MODE != DX || R3;             // B in two boxes
  constexpr uint32_t BYTES = A64 ? (2 + SL) * BOX : STAGE;
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x != CONSUMERS) return;
    for (int g = 0; g < nst; ++g) {
      const int s = g % STAGES;
      if (g >= STAGES) mbar_wait(empty_bar + 8 * s, ((g / STAGES) & 1) ^ 1);
      const uint32_t fb = full_bar + 8 * s;
      const uint32_t st = base + s * STAGE;
      int c[9];
      coords(g, c);
      mbar_expect_tx(fb, BYTES);
      tma_load<R3>(st, amap, fb, c, 0);                    // 2-D FWD, DX: 64 x 128
      if (MODE == DW || (A64 && SL == 2)) tma_load<R3>(st + BOX, amap, fb, c, 2);
#pragma unroll
      for (int i = 0; i < (B2 ? 2 : 1); ++i)               // 2-D DX: one 64 x 128
        tma_load<R3>(st + (2 + i) * BOX, bmap, fb, c, 4 + 2 * i);
    }
    return;
  }
  for (int g = 0; g < nst; ++g) {
    const int s = g % STAGES;
    mbar_wait(full_bar + 8 * s, (g / STAGES) & 1);
    const uint32_t a = base + s * STAGE;
    const uint32_t b = a + 2 * BOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKS / 16; ++kk) {
      // B: MN-major, 16 rows a step; dx's w K-major, 32 bytes a step
      const uint64_t db = MODE == DX ? desc_sw128(b + kk * 32, 16, ATOM)
                                     : desc_sw128(b + kk * 16 * ROW, BOX, ATOM);
#pragma unroll
      for (int sl = 0; sl < SL; ++sl) {
        if (MODE == FWD)   // x rows sl * 64.., K-major: 16 columns = 32 bytes a step
          mma_n128<0, 1>(d[sl], desc_sw128(a + sl * BOX + kk * 32, 16, ATOM), db);
        else if (MODE == DX)   // g rows sl * 64.., as the forward's x
          mma_n128<0, 0>(d[sl], desc_sw128(a + sl * BOX + kk * 32, 16, ATOM), db);
        else               // x^T: box sl holds k sl * 64.., MN-major: 16 rows a step
          mma_n128<1, 1>(d[sl], desc_sw128(a + sl * BOX + kk * 16 * ROW, BOX, ATOM), db);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();                     // stage g - 1's wgmmas are done:
    if (g > 0) mbar_arrive(empty_bar + 8 * ((g - 1) % STAGES));   // its slot is free
  }
  wgmma_wait<0>();
  fence_regs(d[0]);
  fence_regs(d[1]);
}

template <int ST>
__device__ __forceinline__ uint32_t init_barriers(uint8_t* smem_raw, uint32_t& base) {
  const uint32_t raw = smem_u32(smem_raw);
  base = (raw + 1023u) & ~1023u;
  const uint32_t full_bar = base + Ring<ST>::BAR_OFF;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(full_bar + 8 * (ST + s), CONSUMERS);   // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return full_bar;
}

// Store a 128 x 128 f32 accumulator tile (two 64-row wgmma slices) at
// rows r0.., columns c0.. of a row-major (rows, ld) output, through
// `put(row, col, a, b)` for each pair of adjacent columns.
template <typename Put>
__device__ __forceinline__ void for_each_pair(const float (&d)[2][64], Put put) {
  const int t = threadIdx.x;
  const int warp = t / 32, lane = t % 32;
  const int cq = (lane % 4) * 2;
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int r = sl * 64 + warp * 16 + lane / 4;     // rows r, r + 8
#pragma unroll
    for (int jj = 0; jj < 16; ++jj) {
      put(r, 8 * jj + cq, d[sl][4 * jj], d[sl][4 * jj + 1]);
      put(r + 8, 8 * jj + cq, d[sl][4 * jj + 2], d[sl][4 * jj + 3]);
    }
  }
}

// The pieces of one output tile meet in their cluster (one block a
// piece, the cluster's rank = the piece): each block stages its f32
// tile d in its own idle ring (every load landed, every wgmma done),
// then takes rows [rows * rank / S, rows * (rank + 1) / S) of the tile,
// adds the first `parts` pieces' tiles there in split order, reading the
// others' through distributed shared memory, and hands each adjacent
// pair of outputs to put(r, c, a, b); the epilogue runs in this one
// rolled pass of coalesced row stores.  A cluster of one block (no
// split) takes the whole tile.  Every thread of the block calls it.
template <typename Put>
__device__ __forceinline__ void cluster_sum(const float (&d)[2][64], uint8_t* ring, int parts,
                                            int rows, Put put) {
  namespace cg = cooperative_groups;
  constexpr int LD = BN + 4;
  constexpr int MAXP = MAX_PIECES;
  cg::cluster_group cluster = cg::this_cluster();
  float* tile = reinterpret_cast<float*>(ring);
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  __syncwarp();                          // the producer warp's lanes meet again
  if (threadIdx.x < CONSUMERS) {
    consumers_sync();                    // every warp's wgmmas are done
    for_each_pair(d, [&](int r, int c, float a, float b) { store2(tile + r * LD + c, a, b); });
  }
  if (S == 1) {                          // no split: this block's tile alone
    __syncthreads();
#pragma unroll 4
    for (int e = threadIdx.x; e < rows * (BN / 2); e += THREADS) {
      const int r = e / (BN / 2), c = 2 * (e % (BN / 2));
      const float2 v = load2(tile + r * LD + c);
      put(r, c, v.x, v.y);
    }
    return;
  }
  cluster.sync();                        // every piece's tile is in place
  const float* from[MAXP];
#pragma unroll
  for (int p = 0; p < MAXP; ++p)
    from[p] = cluster.map_shared_rank(tile, p < parts ? p : 0);
  const int r0 = rows * rank / S, r1 = rows * (rank + 1) / S;
#pragma unroll 4
  for (int e = threadIdx.x; e < (r1 - r0) * (BN / 2); e += THREADS) {
    const int r = r0 + e / (BN / 2), c = 2 * (e % (BN / 2));
    float2 v[MAXP];
#pragma unroll
    for (int p = 0; p < MAXP; ++p)
      if (p < parts) v[p] = *reinterpret_cast<const float2*>(from[p] + r * LD + c);
    float2 sum = v[0];
#pragma unroll
    for (int p = 1; p < MAXP; ++p)
      if (p < parts) {
        sum.x += v[p].x;
        sum.y += v[p].y;
      }
    put(r, c, sum.x, sum.y);
  }
  cluster.sync();                        // no block leaves while its tile is read
}

// The forward: grid (row blocks, column tiles, S).  Block (mb, j, z)
// multiplies rows mb * 128.. by piece z of column tile j's live list.
template <bool EPI, int ST>
__global__ void __launch_bounds__(THREADS, 2)
bsmm2d_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ out, const int* __restrict__ idx,
                    const int* __restrict__ counts, int M, int N, int kmax,
                    int act, int S) {
  const int m0 = blockIdx.x * BM;
  const int j = blockIdx.y;
  const int n0 = j * BN;
  const int z = blockIdx.z;
  int parts, t0, t1;
  piece(counts[j], S, z, parts, t0, t1);
  if (z >= parts) t0 = t1 = 0;           // an empty piece still sums a slice
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  const uint32_t full_bar = init_barriers<ST>(smem_raw, base);
  const int* live = idx + (size_t)j * kmax + t0;
  __shared__ float sbias[BN];            // this tile's bias, once
  if (EPI && threadIdx.x < BN) sbias[threadIdx.x] = bias == nullptr ? 0.f
      : __bfloat162float(bias[n0 + threadIdx.x]);

  float d[2][64];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int i = 0; i < 64; ++i) d[sl][i] = 0.f;

  mainloop<FWD, ST, false>(&xmap, &wmap, base, full_bar, 2 * (t1 - t0),
                [&](int g, int* c) {
                  const int kc = live[g / 2] * TILE + (g % 2) * BKS;
                  c[0] = kc; c[1] = m0;                   // x (64 k) x (128 rows)
                  c[4] = n0; c[5] = kc;                   // w (64 n) x (64 k), twice
                  c[6] = n0 + 64; c[7] = kc;
                },
                d);
  cluster_sum(d, smem_raw + (base - smem_u32(smem_raw)), parts, min(BM, M - m0),
              [&](int r, int c, float a, float b) {
                if (EPI) {
                  a = activate(a + sbias[c], act);
                  b = activate(b + sbias[c + 1], act);
                }
                store2(out + (size_t)(m0 + r) * N + n0 + c, a, b);
              });
}

// The expert-batched grids (forward and dx) are one-dimensional in x
// (z holds the split's clusters): block b covers expert e, output tile t
// (the forward's column tile, dx's K-row tile) and row block mb of the
// expert's M rows, placed expert-major: the row blocks innermost, then
// the tiles, then the experts.  One expert's blocks run together, so the
// row blocks of a tile read its w boxes at once and the tiles re-read
// x_e (g_e) while it is in L2.
__device__ __forceinline__ void place(int b, int tiles, int mblocks, int& e, int& t,
                                      int& mb) {
  mb = b % mblocks;
  const int r = b / mblocks;
  t = r % tiles;
  e = r / tiles;
}

// whether the block at row m0 of M rows takes one 64-row slice: a last
// row block of at most 64 rows does
__device__ __forceinline__ bool one_slice(int M, int m0) { return M - m0 <= BM / 2; }

// The expert-batched forward of E experts, x (E, M, K) @ w (E, K, N):
// block (e, j, mb) of the grid (E x N / 128 x row blocks, 1, S) multiplies
// x_e's rows mb * 128.. by piece z of column tile j's live list, reading
// x and w through 3-D maps (boxes past row M zero-fill), and stores
// out_e's rows below M.

template <int ST, int SL>
__device__ __forceinline__ void fwd_batched(const CUtensorMap* xmap, const CUtensorMap* wmap,
                                            __nv_bfloat16* __restrict__ out,
                                            const int* __restrict__ idx,
                                            const int* __restrict__ counts, int M, int N,
                                            int kmax, int S, int e, int j, int mb) {
  const int m0 = mb * BM;
  const int n0 = j * BN;
  const int z = blockIdx.z;
  int parts, t0, t1;
  piece(counts[j], S, z, parts, t0, t1);
  if (z >= parts) t0 = t1 = 0;           // an empty piece still sums a slice
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  const uint32_t full_bar = init_barriers<ST>(smem_raw, base);
  const int* live = idx + (size_t)j * kmax + t0;
  __nv_bfloat16* o = out + (size_t)e * M * N;

  float d[2][64];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int i = 0; i < 64; ++i) d[sl][i] = 0.f;

  mainloop<FWD, ST, true, SL>(xmap, wmap, base, full_bar, 2 * (t1 - t0),
                [&](int g, int* c) {
                  const int kc = live[g / 2] * TILE + (g % 2) * BKS;
                  c[0] = kc; c[1] = m0;                   // x (64 k) x (64 rows), SL times
                  c[2] = kc; c[3] = m0 + BM / 2;
                  c[4] = n0; c[5] = kc;                   // w (64 n) x (64 k), twice
                  c[6] = n0 + 64; c[7] = kc;
                  c[8] = e;
                },
                d);
  cluster_sum(d, smem_raw + (base - smem_u32(smem_raw)), parts, min(BM, M - m0),
              [&](int r, int c, float a, float b) {
                store2(o + (size_t)(m0 + r) * N + n0 + c, a, b);
              });
}

template <int ST>
__global__ void __launch_bounds__(THREADS, 2)
bsmm_batched_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          __nv_bfloat16* __restrict__ out, const int* __restrict__ idx,
                          const int* __restrict__ counts, int M, int N, int kmax, int S) {
  int e, j, mb;
  place(blockIdx.x, N / BN, (M + BM - 1) / BM, e, j, mb);
  if (one_slice(M, mb * BM))
    fwd_batched<ST, 1>(&xmap, &wmap, out, idx, counts, M, N, kmax, S, e, j, mb);
  else
    fwd_batched<ST, 2>(&xmap, &wmap, out, idx, counts, M, N, kmax, S, e, j, mb);
}

// dw: grid (L, S, E), clusters of the S pieces of a tile.  Block (l, z,
// e) sums x_e[rows, kk[l]]^T g_e[rows, nn[l]] over piece z of the 64-row
// stages; the cluster stores the tile into dw_e (K, N).  BATCHED reads x
// and g through 3-D maps (cols, M, E), so that a box past row M zero-fills
// instead of summing expert e + 1's rows into expert e's tile (the 2-D
// form has E = 1 and 2-D maps).
template <int ST, bool BATCHED>
__device__ __forceinline__ void dw_wgmma(const CUtensorMap* xmap, const CUtensorMap* gmap,
                                         __nv_bfloat16* __restrict__ dw,
                                         const int* __restrict__ kk,
                                         const int* __restrict__ nn, int M, int K, int N,
                                         int S) {
  const int l = blockIdx.x;
  const int z = blockIdx.y;
  const int e = blockIdx.z;
  int parts, s0, s1;
  piece((M + BKS - 1) / BKS, S, z, parts, s0, s1);
  if (z >= parts) s0 = s1 = 0;
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  const uint32_t full_bar = init_barriers<ST>(smem_raw, base);
  const int k0 = kk[l] * TILE;
  const int n0 = nn[l] * TILE;
  __nv_bfloat16* out = dw + (size_t)e * K * N;

  float d[2][64];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int i = 0; i < 64; ++i) d[sl][i] = 0.f;

  mainloop<DW, ST, BATCHED>(xmap, gmap, base, full_bar, s1 - s0,
               [&](int g, int* c) {
                 const int r = (s0 + g) * BKS;
                 c[0] = k0; c[1] = r;                    // x (64 k) x (64 rows), twice
                 c[2] = k0 + 64; c[3] = r;
                 c[4] = n0; c[5] = r;                    // g (64 n) x (64 rows), twice
                 c[6] = n0 + 64; c[7] = r;
                 c[8] = e;
               },
               d);
  cluster_sum(d, smem_raw + (base - smem_u32(smem_raw)), parts, TILE,
              [&](int r, int c, float a, float b) {
                store2(out + (size_t)(k0 + r) * N + n0 + c, a, b);
              });
}

// the 2-D and the expert-batched dw under their own names (a profile
// tells them apart)
template <int ST>
__global__ void __launch_bounds__(THREADS, 2)
bsmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap gmap,
                     __nv_bfloat16* __restrict__ dw, const int* __restrict__ kk,
                     const int* __restrict__ nn, int M, int K, int N, int S) {
  dw_wgmma<ST, false>(&xmap, &gmap, dw, kk, nn, M, K, N, S);
}

template <int ST>
__global__ void __launch_bounds__(THREADS, 2)
bsmm_batched_dw_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                             const __grid_constant__ CUtensorMap gmap,
                             __nv_bfloat16* __restrict__ dw, const int* __restrict__ kk,
                             const int* __restrict__ nn, int M, int K, int N, int S) {
  dw_wgmma<ST, true>(&xmap, &gmap, dw, kk, nn, M, K, N, S);
}

// dx: block (e, k, mb, z) multiplies g_e's rows mb * 128.. by piece z of
// K-row tile k's live N tiles, w_e read K-major (128 k rows of 64 n a
// stage); the cluster (its S pieces, along z) stores the bf16 tile of
// dx_e (M, K), rows past M masked, zeros where k's list is empty.  The
// 2-D grid is (row blocks, K / 128, S); the batched one (E x K / 128 x
// row blocks, 1, S), placed expert-major, reads g and w through 3-D maps
// (cols, rows, E), g in 64-row boxes (SL of them), so that its rows past
// M zero-fill per expert.
template <int ST, bool BATCHED, int SL>
__device__ __forceinline__ void dx_wgmma(const CUtensorMap* gmap, const CUtensorMap* wmap,
                                         __nv_bfloat16* __restrict__ dx,
                                         const int* __restrict__ idx_t,
                                         const int* __restrict__ counts_t, int M, int K,
                                         int nmax, int S, int e, int k, int mb) {
  const int m0 = mb * BM;
  const int k0 = k * TILE;
  const int z = blockIdx.z;
  int parts, t0, t1;
  piece(counts_t[k], S, z, parts, t0, t1);
  if (z >= parts) t0 = t1 = 0;           // an empty piece still sums a slice
  extern __shared__ uint8_t smem_raw[];
  uint32_t base;
  const uint32_t full_bar = init_barriers<ST>(smem_raw, base);
  const int* live = idx_t + (size_t)k * nmax + t0;
  __nv_bfloat16* out = dx + (size_t)e * M * K;

  float d[2][64];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int i = 0; i < 64; ++i) d[sl][i] = 0.f;

  mainloop<DX, ST, BATCHED, SL>(gmap, wmap, base, full_bar, 2 * (t1 - t0),
               [&](int g, int* c) {
                 const int nc = live[g / 2] * TILE + (g % 2) * BKS;
                 c[0] = nc; c[1] = m0;                   // g (64 n) x (128 rows), or
                 c[2] = nc; c[3] = m0 + BM / 2;          // batched SL x (64 rows)
                 c[4] = nc; c[5] = k0;                   // w (64 n) x (128 k), or
                 c[6] = nc; c[7] = k0 + BM / 2;          // batched 2 x (64 k)
                 c[8] = e;
               },
               d);
  cluster_sum(d, smem_raw + (base - smem_u32(smem_raw)), parts, min(BM, M - m0),
              [&](int r, int c, float a, float b) {
                store2(out + (size_t)(m0 + r) * K + k0 + c, a, b);
              });
}

template <int ST>
__global__ void __launch_bounds__(THREADS, 2)
bsmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap gmap,
                     const __grid_constant__ CUtensorMap wmap,
                     __nv_bfloat16* __restrict__ dx, const int* __restrict__ idx_t,
                     const int* __restrict__ counts_t, int M, int K, int nmax, int S) {
  dx_wgmma<ST, false, 2>(&gmap, &wmap, dx, idx_t, counts_t, M, K, nmax, S, 0,
                                blockIdx.y, blockIdx.x);
}

template <int ST>
__global__ void __launch_bounds__(THREADS, 2)
bsmm_batched_dx_wgmma_kernel(const __grid_constant__ CUtensorMap gmap,
                             const __grid_constant__ CUtensorMap wmap,
                             __nv_bfloat16* __restrict__ dx, const int* __restrict__ idx_t,
                             const int* __restrict__ counts_t, int M, int K, int nmax,
                             int S) {
  int e, k, mb;
  place(blockIdx.x, K / BN, (M + BM - 1) / BM, e, k, mb);
  if (one_slice(M, mb * BM))
    dx_wgmma<ST, true, 1>(&gmap, &wmap, dx, idx_t, counts_t, M, K, nmax, S, e, k, mb);
  else
    dx_wgmma<ST, true, 2>(&gmap, &wmap, dx, idx_t, counts_t, M, K, nmax, S, e, k, mb);
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

// a row-major (rows, cols) bf16 matrix as a 2-D map read in 128B-swizzled
// boxes of 64 columns x box_rows, zero-filled out of bounds; with experts
// > 0, a stack of that many such matrices as a 3-D map (cols, rows,
// experts) read one expert's box at a time, so that a box running past
// `rows` zero-fills there instead of reaching the next expert's rows
int make_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
             int experts = 0) {
  const EncodeTiled encode = encode_fn();
  if (encode == nullptr) return ENCODE_FAILED + CUDA_ERROR_NOT_FOUND;
  const cuuint32_t rank = experts > 0 ? 3 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)experts};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
                            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED + (int)r;
}

// the ring depth of a grid: deep where no SM holds two of its blocks
inline bool alone(dim3 grid) {
  return (long long)grid.x * grid.y * grid.z <= sm_count();
}

// one launch of `kernel` whose blocks form clusters of `cluster` (a
// plain launch where that is one block: each block its own cluster)
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, dim3 cluster, int smem,
                            cudaStream_t s, Args... args) {
  if (cluster.x * cluster.y * cluster.z == 1) {
    kernel<<<grid, THREADS, smem, s>>>(args...);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster.x;
  attr[0].val.clusterDim.y = cluster.y;
  attr[0].val.clusterDim.z = cluster.z;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool EPI, int ST>
int launch_fwd_ring(const CUtensorMap& xm, const CUtensorMap& wm, const void* bias, void* out,
                    const int* idx, const int* counts, int M, int N, int kmax, int act, int S,
                    dim3 grid, cudaStream_t s) {
  static bool ready = false;
  auto kernel = bsmm2d_wgmma_kernel<EPI, ST>;
  const cudaError_t a = allow_smem(kernel, Ring<ST>::SMEM, ready);
  if (a != cudaSuccess) return a;
  return launch_clusters(kernel, grid, dim3(1, 1, S), Ring<ST>::SMEM, s, xm, wm,
                         static_cast<const __nv_bfloat16*>(bias),
                         static_cast<__nv_bfloat16*>(out), idx, counts, M, N, kmax, act, S);
}

template <bool EPI>
int launch_fwd(const void* x, const void* w, const void* bias, void* out, const int* idx,
               const int* counts, int M, int K, int N, int kmax, int act, int S,
               cudaStream_t s) {
  CUtensorMap xm, wm;
  int e = make_map(&xm, x, M, K, BM);
  if (e == 0) e = make_map(&wm, w, K, N, BKS);
  if (e != 0) return e;
  dim3 grid((M + BM - 1) / BM, N / BN, S);
  if (alone(grid))
    return launch_fwd_ring<EPI, ALONE>(xm, wm, bias, out, idx, counts, M, N, kmax, act, S,
                                       grid, s);
  return launch_fwd_ring<EPI, SHARED>(xm, wm, bias, out, idx, counts, M, N, kmax, act, S,
                                      grid, s);
}

template <int ST, bool BATCHED>
int launch_dw_ring(const CUtensorMap& xm, const CUtensorMap& gm, void* dw, const int* kk,
                   const int* nn, int M, int K, int N, int S, dim3 grid, cudaStream_t s) {
  static bool ready = false;
  auto kernel = BATCHED ? bsmm_batched_dw_wgmma_kernel<ST> : bsmm_dw_wgmma_kernel<ST>;
  const cudaError_t a = allow_smem(kernel, Ring<ST>::SMEM, ready);
  if (a != cudaSuccess) return a;
  return launch_clusters(kernel, grid, dim3(1, S, 1), Ring<ST>::SMEM, s, xm, gm,
                         static_cast<__nv_bfloat16*>(dw), kk, nn, M, K, N, S);
}

template <int ST>
int launch_dx_ring(const CUtensorMap& gm, const CUtensorMap& wm, void* dx, const int* idx_t,
                   const int* counts_t, int M, int K, int nmax, int S, dim3 grid,
                   cudaStream_t s) {
  static bool ready = false;
  auto kernel = bsmm_dx_wgmma_kernel<ST>;
  const cudaError_t a = allow_smem(kernel, Ring<ST>::SMEM, ready);
  if (a != cudaSuccess) return a;
  return launch_clusters(kernel, grid, dim3(1, 1, S), Ring<ST>::SMEM, s, gm, wm,
                         static_cast<__nv_bfloat16*>(dx), idx_t, counts_t, M, K, nmax, S);
}

// dx (M, K) of g (M, N) and w (K, N)
int launch_dx(const void* g, const void* w, void* dx, const int* idx_t, const int* counts_t,
              int M, int K, int N, int nmax, int S, cudaStream_t s) {
  CUtensorMap gm, wm;
  int e = make_map(&gm, g, M, N, BM);
  if (e == 0) e = make_map(&wm, w, K, N, BM);   // 128 k rows of 64 n: K-major B
  if (e != 0) return e;
  dim3 grid((M + BM - 1) / BM, K / BN, S);
  if (alone(grid))
    return launch_dx_ring<ALONE>(gm, wm, dx, idx_t, counts_t, M, K, nmax, S, grid, s);
  return launch_dx_ring<SHARED>(gm, wm, dx, idx_t, counts_t, M, K, nmax, S, grid, s);
}

// The expert-batched forward and dx share their launch: FWD = x (E, M,
// K) @ w (E, K, N) -> out (E, M, N), over N / 128 column tiles; DX = g
// (E, M, N) @ w^T -> dx (E, M, K), over K / 128 K-row tiles.  A is read
// in 64-row boxes, w in 64-row boxes of 64 columns (FWD: 64 k x 64 n,
// MN-major B; DX: 64 k x 64 n, two making the K-major 128-k box).
template <int MODE, int ST>
int launch_batched_ring(const CUtensorMap& am, const CUtensorMap& wm, void* out,
                        const int* idx, const int* counts, int M, int K, int N, int lmax,
                        int S, dim3 grid, cudaStream_t s) {
  static bool ready = false;
  auto kernel = MODE == FWD ? bsmm_batched_wgmma_kernel<ST> : bsmm_batched_dx_wgmma_kernel<ST>;
  const cudaError_t a = allow_smem(kernel, Ring<ST>::SMEM, ready);
  if (a != cudaSuccess) return a;
  return launch_clusters(kernel, grid, dim3(1, 1, S), Ring<ST>::SMEM, s, am, wm,
                         static_cast<__nv_bfloat16*>(out), idx, counts, M,
                         MODE == FWD ? N : K, lmax, S);
}

template <int MODE>
int launch_batched(const void* a, const void* w, void* out, const int* idx, const int* counts,
                   int E, int M, int K, int N, int lmax, int S, cudaStream_t s) {
  CUtensorMap am, wm;
  int e = make_map(&am, a, M, MODE == FWD ? K : N, BM / 2, E);
  if (e == 0) e = make_map(&wm, w, K, N, BKS, E);
  if (e != 0) return e;
  dim3 grid(E * ((MODE == FWD ? N : K) / TILE) * ((M + BM - 1) / BM), 1, S);
  if (alone(grid))
    return launch_batched_ring<MODE, ALONE>(am, wm, out, idx, counts, M, K, N, lmax, S, grid,
                                            s);
  return launch_batched_ring<MODE, SHARED>(am, wm, out, idx, counts, M, K, N, lmax, S, grid,
                                           s);
}

// dw of E experts (E = 1 and 2-D maps unless BATCHED): x (E, M, K), g
// (E, M, N), dw (E, K, N)
template <bool BATCHED>
int launch_dw(const void* x, const void* g, void* dw, const int* kk, const int* nn, int E,
              int L, int M, int K, int N, int S, cudaStream_t s) {
  CUtensorMap xm, gm;
  const int experts = BATCHED ? E : 0;
  int e = make_map(&xm, x, M, K, BKS, experts);
  if (e == 0) e = make_map(&gm, g, M, N, BKS, experts);
  if (e != 0) return e;
  dim3 grid(L, S, E);
  if (alone(grid))
    return launch_dw_ring<ALONE, BATCHED>(xm, gm, dw, kk, nn, M, K, N, S, grid, s);
  return launch_dw_ring<SHARED, BATCHED>(xm, gm, dw, kk, nn, M, K, N, S, grid, s);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// dw, float32 on the CUDA cores: grid (L, S, E).  Block (l, z, e) covers
// the 128 x 128 tile of expert e (E = 1 for the 2-D form) with a 16 x 16
// thread grid of 8 x 8 register tiles and sums piece z of the 32-row
// steps, staging x_e[:, kk[l]] and g_e[:, nn[l]] as f32 with 16-byte
// loads; rows past M load as zeros.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
bsmm_dw_fma_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   float* __restrict__ dw, float* __restrict__ ws,
                   int* __restrict__ cnt, const int* __restrict__ kk,
                   const int* __restrict__ nn, int M, int K, int N, int S) {
  constexpr int BR = 32, TM = 8, TN = 8, NX = TILE / TN;
  __shared__ __align__(16) float xs[BR][TILE];   // (row, k)
  __shared__ __align__(16) float gs[BR][TILE];   // (row, n)
  const int l = blockIdx.x;
  const int z = blockIdx.y;
  const int e = blockIdx.z;
  int parts, s0, s1;
  piece((M + BR - 1) / BR, S, z, parts, s0, s1);
  if (z >= parts) return;
  x += (size_t)e * M * K;
  g += (size_t)e * M * N;
  dw += (size_t)e * K * N;
  const int k0 = kk[l] * TILE;
  const int n0 = nn[l] * TILE;
  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

  for (int m0 = s0 * BR; m0 < s1 * BR; m0 += BR) {
    for (int i = tid; i < BR * TILE / 4; i += 256) {
      const int r = i / (TILE / 4), c = (i % (TILE / 4)) * 4;
      const int m = m0 + r;
      float4 xv = make_float4(0.f, 0.f, 0.f, 0.f), gv = xv;
      if (m < M) {
        xv = *reinterpret_cast<const float4*>(x + (size_t)m * K + k0 + c);
        gv = *reinterpret_cast<const float4*>(g + (size_t)m * N + n0 + c);
      }
      *reinterpret_cast<float4*>(&xs[r][c]) = xv;
      *reinterpret_cast<float4*>(&gs[r][c]) = gv;
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

  constexpr size_t T2 = (size_t)TILE * TILE;
  const size_t lt = (size_t)gridDim.x * T2;
  if (parts > 1) {
    ws += (size_t)e * S * lt;            // expert e's (S, L, 128, 128) partials
    float* wz = ws + z * lt + l * T2;
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) wz[(ty + a * (TILE / TM)) * TILE + tx + b * NX] = acc[a][b];
    if (!last_to_finish(cnt + (size_t)e * gridDim.x + l, parts)) return;
    for (int p = 0; p < parts; ++p) {    // every piece in split order, own included
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b) {
          const float v = __ldcg(ws + p * lt + l * T2 + (ty + a * (TILE / TM)) * TILE + tx + b * NX);
          acc[a][b] = p == 0 ? v : acc[a][b] + v;
        }
    }
  }
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b)
      dw[(size_t)(k0 + ty + a * (TILE / TM)) * N + n0 + tx + b * NX] = acc[a][b];
}

enum Route { STREAM = 0, FMA = 1, WGMMA = 2 };

template <typename T, int BM, bool EPI>
cudaError_t launch_stream2d(const void* x, const void* w, const void* bias, void* out,
                            float* ws, int* cnt, const int* idx, const int* counts, int M,
                            int K, int N, int kmax, int act, int S, cudaStream_t s) {
  using P = Stream2d<T, BM>;
  static bool ready = false;
  auto kernel = bsmm2d_stream_kernel<T, BM, EPI>;
  const cudaError_t err = allow_smem(kernel, P::SMEM, ready);
  if (err != cudaSuccess) return err;
  dim3 grid(N / P::BN, (M + BM - 1) / BM, S);
  kernel<<<grid, 256, P::SMEM, s>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                    static_cast<const T*>(bias), static_cast<T*>(out), ws,
                                    cnt, idx, counts, M, K, N, kmax, act, S);
  return cudaGetLastError();
}

template <typename T, bool EPI>
int launch2d(const void* x, const void* w, const void* bias, void* out, float* ws, int* cnt,
             const int* idx, const int* counts, int M, int K, int N, int kmax, int act,
             int route, int S, cudaStream_t s) {
  if (route == STREAM) {
    if (M <= 8)
      return launch_stream2d<T, 8, EPI>(x, w, bias, out, ws, cnt, idx, counts, M, K, N,
                                        kmax, act, S, s);
    return launch_stream2d<T, 32, EPI>(x, w, bias, out, ws, cnt, idx, counts, M, K, N,
                                       kmax, act, S, s);
  }
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return wg::launch_fwd<EPI>(x, w, bias, out, idx, counts, M, K, N, kmax, act, S, s);
  } else {
    dim3 grid((M + 63) / 64, N / TILE, S);
    bsmm2d_fma_kernel<EPI><<<grid, 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(bias), static_cast<float*>(out), ws, cnt, idx, counts, M,
        K, N, kmax, act, S);
    return cudaGetLastError();
  }
}

}  // namespace

// The 2-D forward, kernel #1 (epi = 0) and #2 (epi = 1): out (M, N) =
// act(x (M, K) @ (w (K, N) * tile bitmap) + bias), contiguous, 16-byte
// aligned, K and N multiples of 128.  dtype (x, w, bias, out): 0 =
// float32, 1 = bfloat16.  bias may be null (then act(acc) alone); act:
// 0 none, 1 relu, 2 gelu (tanh), 3 silu (epi = 0: none).  route
// (bsmm.bsmm_route): 0 = stream (M < 64), 1 = fma (float32, M >= 64), 2 =
// wgmma (bfloat16, M >= 64).  Each column tile's live list is cut into at
// most `splits` pieces: on wgmma, at most 4, the pieces of a tile one
// cluster; on stream and fma, with splits > 1, ws is an f32 (splits, M,
// N) workspace and cnt zeroed int32 counters, one per output block
// (left zeroed).  Returns 0, a cudaError_t, or 10000 + the CUresult of a
// failed tensor-map encoding.
extern "C" int bsmm2d_launch(const void* x, const void* w, const void* bias, void* out,
                             void* ws, int* cnt, const int* idx, const int* counts, int M,
                             int K, int N, int kmax, int dtype, int epi, int act, int route,
                             int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || K % TILE || N % TILE || kmax <= 0 || splits <= 0 ||
      (route == WGMMA && splits > wg::MAX_PIECES) ||
      (route != WGMMA && splits > 1 && (ws == nullptr || cnt == nullptr)))
    return cudaErrorInvalidValue;
  if ((route == STREAM) != (M < 64) || (route == FMA && dtype != 0) ||
      (route == WGMMA && dtype != 1) || route < STREAM || route > WGMMA)
    return cudaErrorInvalidValue;
  if (!epi) act = ACT_NONE, bias = nullptr;
  float* wsp = static_cast<float*>(ws);
  if (dtype == 0)
    return epi ? launch2d<float, true>(x, w, bias, out, wsp, cnt, idx, counts, M, K, N, kmax,
                                       act, route, splits, s)
               : launch2d<float, false>(x, w, bias, out, wsp, cnt, idx, counts, M, K, N,
                                        kmax, act, route, splits, s);
  if (dtype == 1)
    return epi ? launch2d<__nv_bfloat16, true>(x, w, bias, out, wsp, cnt, idx, counts, M, K,
                                               N, kmax, act, route, splits, s)
               : launch2d<__nv_bfloat16, false>(x, w, bias, out, wsp, cnt, idx, counts, M,
                                                K, N, kmax, act, route, splits, s);
  return cudaErrorInvalidValue;
}

// dynamic shared memory of the wgmma kernels (the forward's route 2 and
// bf16 dw), as their launches ask for it: alone = 0, the ring of a grid
// whose blocks share SMs two by two; 1, of one no larger than the SMs
extern "C" int bsmm_wgmma_smem(int alone) {
  return alone ? wg::Ring<wg::ALONE>::SMEM : wg::Ring<wg::SHARED>::SMEM;
}

namespace {

constexpr int MAX_GRID_Z = 65535;   // experts a batched launch takes (grid z)

// dx of E experts: the 2-D entry point's body (E = 1, 2-D maps) and the
// batched one's (3-D maps; the expert in grid z on simt and in grid x,
// placed expert-major, on wgmma, whose split clusters take z)
int dx_launch(const void* g, const void* w, void* dx, const int* idx_t, const int* counts_t,
              int E, int M, int K, int N, int nmax, int dtype, int route, int splits,
              void* stream, bool batched) {
  if (E <= 0 || E > MAX_GRID_Z || M <= 0 || K <= 0 || N <= 0 || K % TILE || N % TILE ||
      nmax <= 0 || splits <= 0)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1 || M < 64 || splits > wg::MAX_PIECES) return cudaErrorInvalidValue;
    return batched ? wg::launch_batched<wg::DX>(g, w, dx, idx_t, counts_t, E, M, K, N, nmax,
                                                splits, s)
                   : wg::launch_dx(g, w, dx, idx_t, counts_t, M, K, N, nmax, splits, s);
  }
  if (route != 0 || splits != 1 || (dtype == 1 && M >= 64)) return cudaErrorInvalidValue;
  // the forward walk with contraction N and output width K, grid z = E
  return dispatch<true>(g, w, dx, idx_t, counts_t, M, N, K, nmax, dtype, stream, E,
                        (long long)M * N, (long long)K * N, (long long)M * K);
}

// dw of E experts (grid z = E on both routes); see bsmm_batched_dw_launch
int dw_launch(const void* x, const void* g, void* dw, void* ws, int* cnt, const int* kk,
              const int* nn, int E, int L, int M, int K, int N, int dtype, int splits,
              void* stream, bool batched) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L <= 0) return cudaSuccess;
  if (E <= 0 || E > MAX_GRID_Z || M <= 0 || K % TILE || N % TILE || splits <= 0 ||
      (dtype == 1 && splits > wg::MAX_PIECES) ||
      (dtype == 0 && splits > 1 && (ws == nullptr || cnt == nullptr)))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    bsmm_dw_fma_kernel<<<dim3(L, splits, E), 256, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(g), static_cast<float*>(dw),
        static_cast<float*>(ws), cnt, kk, nn, M, K, N, splits);
    return cudaGetLastError();
  }
  if (dtype == 1)
    return batched ? wg::launch_dw<true>(x, g, dw, kk, nn, E, L, M, K, N, splits, s)
                   : wg::launch_dw<false>(x, g, dw, kk, nn, 1, L, M, K, N, splits, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dx (M, K) = g (M, N) @ (w (K, N) * tile bitmap)^T over the transposed
// plan: idx_t (K / 128, nmax) live N tiles of each K-row tile, counts_t.
// route (bsmm.bsmm_dx_route): 0 = simt (float32, or bfloat16 below 64
// rows; splits must be 1), 1 = wgmma (bfloat16 from 64 rows; each list
// cut into `splits` <= 4 pieces, a cluster).  Returns 0, a cudaError_t,
// or 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int bsmm_dx_launch(const void* g, const void* w, void* dx,
                              const int* idx_t, const int* counts_t, int M,
                              int K, int N, int nmax, int dtype, int route,
                              int splits, void* stream) {
  return dx_launch(g, w, dx, idx_t, counts_t, 1, M, K, N, nmax, dtype, route, splits, stream,
                   false);
}

// The expert-batched forward (the reference's jax.vmap of plan_matmul over
// experts, src/repro/models/moe.py:81-83): out[e] (M, N) = x[e] (M, K) @
// (w[e] (K, N) * tile bitmap) for e < E, contiguous (E, M, K), (E, K, N)
// and (E, M, N), one plan shared by every expert, one launch.  route
// (bsmm.bsmm_batched_route): 0 = stream (at most 32 rows; the
// weight-streaming kernel, grid z = e), 1 = simt (the CUDA-core tile
// walk, grid z = e), 2 = wgmma (bfloat16 from 64 rows: TMA + wgmma,
// 3-D maps, each column tile's live list cut into `splits` <= 4 pieces,
// a cluster); splits must be 1 off wgmma.  Returns 0, a cudaError_t, or
// 10000 + the CUresult of a failed tensor-map encoding.
extern "C" int bsmm_batched_launch(const void* x, const void* w, void* out,
                                   const int* idx, const int* counts, int E,
                                   int M, int K, int N, int kmax, int dtype, int route,
                                   int splits, void* stream) {
  if (E <= 0 || E > MAX_GRID_Z || M <= 0 || K <= 0 || N <= 0 || K % TILE || N % TILE ||
      kmax <= 0 || splits <= 0 || route < 0 || route > 2 || (route != 2 && splits != 1))
    return cudaErrorInvalidValue;
  if (route == 2) {
    if (dtype != 1 || M < 64 || splits > wg::MAX_PIECES) return cudaErrorInvalidValue;
    return wg::launch_batched<wg::FWD>(x, w, out, idx, counts, E, M, K, N, kmax, splits,
                                       static_cast<cudaStream_t>(stream));
  }
  if (route == 0 && M > 4 * SM_ROWS) return cudaErrorInvalidValue;
  return dispatch<false>(x, w, out, idx, counts, M, K, N, kmax, dtype, stream, E,
                         (long long)M * K, (long long)K * N, (long long)M * N, route == 0);
}

// The expert-batched dx (the backward of the reference's jax.vmap of
// plan_matmul over experts): dx[e] (M, K) = g[e] (M, N) @ (w[e] (K, N) *
// tile bitmap)^T for e < E, contiguous (E, M, N), (E, K, N) and (E, M,
// K), one transposed plan for every expert, one launch; routes and
// splits as bsmm_dx_launch's, M being each expert's rows.
extern "C" int bsmm_batched_dx_launch(const void* g, const void* w, void* dx,
                                      const int* idx_t, const int* counts_t, int E,
                                      int M, int K, int N, int nmax, int dtype,
                                      int route, int splits, void* stream) {
  return dx_launch(g, w, dx, idx_t, counts_t, E, M, K, N, nmax, dtype, route, splits, stream,
                   true);
}

// dw (K, N): for each of the L live tiles l, rows kk[l] * 128.. and
// columns nn[l] * 128.. get x (M, K)[:, tile]^T @ g (M, N)[:, tile].
// Dead tiles are not written: the caller passes a zeroed dw.  dtype 0 =
// float32 (CUDA cores), 1 = bfloat16 (TMA + wgmma).  Each tile's rows are
// cut into at most `splits` pieces: bfloat16, at most 4, a cluster;
// float32, with splits > 1, ws is an f32 (splits, L, 128, 128) workspace
// and cnt L zeroed int32 counters.
extern "C" int bsmm_dw_launch(const void* x, const void* g, void* dw, void* ws, int* cnt,
                              const int* kk, const int* nn, int L, int M, int K, int N,
                              int dtype, int splits, void* stream) {
  return dw_launch(x, g, dw, ws, cnt, kk, nn, 1, L, M, K, N, dtype, splits, stream, false);
}

// The expert-batched dw: dw[e] (K, N) gets x[e] (M, K)[:, tile]^T @ g[e]
// (M, N)[:, tile] on each of the L live tiles of the shared plan (the
// union of the expert masks), contiguous (E, M, K), (E, M, N) and (E, K,
// N), one launch; the caller passes a zeroed dw.  As bsmm_dw_launch, with
// a float32 split workspace of (E, splits, L, 128, 128) and E * L
// counters.
extern "C" int bsmm_batched_dw_launch(const void* x, const void* g, void* dw, void* ws,
                                      int* cnt, const int* kk, const int* nn, int E, int L,
                                      int M, int K, int N, int dtype, int splits,
                                      void* stream) {
  return dw_launch(x, g, dw, ws, cnt, kk, nn, E, L, M, K, N, dtype, splits, stream, true);
}

extern "C" const char* kernel_error_string(int code) {
  if (code >= wg::ENCODE_FAILED) return "cuTensorMapEncodeTiled failed (CUresult = code - 10000)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
