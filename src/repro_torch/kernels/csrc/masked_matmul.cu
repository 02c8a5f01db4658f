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
// product of a tile whose mask is all zero is skipped.  That is what
// unstructured (LTP) sparsity costs on crossbar hardware: the bytes of
// dead weights still move, only the arithmetic goes.  (The block-sparse
// kernels of bsmm.cu are the crossbar-aware counterpart: they never
// read a dead tile.)
//
// A block owns BM rows of one 128-column tile j and walks every K tile
// in order.  For each it stages the whole 128 x 128 product w * mask in
// shared memory (16-byte loads of w, the matching bytes of mask, the
// product rounded to w's type as the reference's `w * m.astype(w)`),
// and the x slice beside it, while each thread notes whether any of its
// mask values is nonzero; __syncthreads_or then gives the tile's
// liveness, and only a live tile is multiplied.  The whole tile is
// staged before the decision because the skip is per (bk, bn) tile.
//
// bfloat16 at M >= 128 multiplies on the tensor cores with WMMA
// 16x16x16 fragments (8 warps, each a 32 x 64 piece of a 128 x 128
// output tile); float32, and every M < 128, use CUDA-core FMA with a
// register tile per thread.  The mask may be float32, bfloat16 or one
// byte (bool / uint8).
//
// What bounds it on the H100: the bytes of w and mask, read in full
// whatever the mask (at M = 8, ~2 flops per weight byte), and at large
// M the live tiles' flops.  This first kernel has one tile of loads in
// flight per block and no cp.async/TMA double buffering; WMMA
// (mma.sync) is below wgmma's rate.  Times against the bound are in
// PERF.md.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
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

// CUDA-core form: a block owns rows m0..m0+BM of column tile j; each
// thread a TM x TN register tile (NX threads along N, NY along M).
template <typename T, typename MT, int BM, int TM, int TN>
__global__ void __launch_bounds__(THREADS)
masked_fma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const MT* __restrict__ mask, T* __restrict__ out, int M,
                  int K, int N) {
  constexpr int NX = TILE / TN, NY = THREADS / NX;
  static_assert(NY * TM == BM, "block rows");
  constexpr int V = 16 / sizeof(T);      // elements per 16-byte load of w / x
  constexpr int LDX = BM + 1;
  extern __shared__ __align__(16) float smem[];
  float* ws = smem;                      // (k, n) product tile, 128 x 128
  float* xs = smem + TILE * TILE;        // (k, m) x slice, 128 x LDX

  const int n0 = blockIdx.x * TILE;
  const int m0 = blockIdx.y * BM;
  const int tid = threadIdx.x;
  const int tx = tid % NX, ty = tid / NX;

  float acc[TM][TN];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) acc[a][b] = 0.f;

  for (int kb = 0; kb < K; kb += TILE) {
    bool any = false;
    for (int e = tid; e < TILE * TILE / V; e += THREADS) {   // w and mask, every byte
      const int r = e / (TILE / V), c = (e % (TILE / V)) * V;
      const size_t off = (size_t)(kb + r) * N + n0 + c;
      float wv[V], mv[V];
      load_vals<T, V>(w + off, wv);
      any |= load_vals<MT, V>(mask + off, mv);
#pragma unroll
      for (int i = 0; i < V; ++i)
        ws[r * TILE + c + i] = round_to<T>(wv[i] * round_to<T>(mv[i]));
    }
    for (int e = tid; e < BM * TILE / V; e += THREADS) {     // x slice, transposed
      const int r = e / (TILE / V), c = (e % (TILE / V)) * V;
      const int m = m0 + r;
      float v[V];
      if (m < M) {
        load_vals<T, V>(x + (size_t)m * K + kb + c, v);
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
        for (int b = 0; b < TN; ++b) bv[b] = ws[k * TILE + tx + b * NX];
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
    for (int b = 0; b < TN; ++b)
      out[(size_t)m * N + n0 + tx + b * NX] = from_f32<T>(acc[a][b]);
  }
}

// Tensor-core form for bfloat16 at M >= 128: the same walk with the
// bf16 product tile and x tile staged as they are and multiplied by
// WMMA fragments into f32 accumulators.
constexpr int LDW = TILE + 8;                   // padded rows, multiples of 8
constexpr size_t WMMA_SMEM = 2 * TILE * LDW * sizeof(__nv_bfloat16) + 8 * 256 * sizeof(float);

template <typename MT>
__global__ void __launch_bounds__(THREADS)
masked_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ w,
                   const MT* __restrict__ mask, __nv_bfloat16* __restrict__ out,
                   int M, int K, int N) {
  using namespace nvcuda;
  constexpr int V = 8;
  extern __shared__ __align__(32) unsigned char raw[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(raw);           // (m, k)
  __nv_bfloat16* Bs = As + TILE * LDW;                                 // (k, n)
  float* Cs = reinterpret_cast<float*>(Bs + TILE * LDW);               // 8 x 16 x 16

  const int n0 = blockIdx.x * TILE;
  const int m0 = blockIdx.y * TILE;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;       // 4 x 2 warps of 32 x 64

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  for (int kb = 0; kb < K; kb += TILE) {
    bool any = false;
    for (int e = tid; e < TILE * TILE / V; e += THREADS) {
      const int r = e / (TILE / V), c = (e % (TILE / V)) * V;
      const size_t off = (size_t)(kb + r) * N + n0 + c;
      float wv[V], mv[V];
      load_vals<__nv_bfloat16, V>(w + off, wv);
      any |= load_vals<MT, V>(mask + off, mv);
      alignas(16) __nv_bfloat16 pv[V];
#pragma unroll
      for (int i = 0; i < V; ++i) pv[i] = __float2bfloat16(wv[i] * round_to<__nv_bfloat16>(mv[i]));
      *reinterpret_cast<uint4*>(Bs + r * LDW + c) = *reinterpret_cast<const uint4*>(pv);
    }
    for (int e = tid; e < TILE * TILE / V; e += THREADS) {
      const int r = e / (TILE / V), c = (e % (TILE / V)) * V;
      const int m = m0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M) v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + kb + c);
      *reinterpret_cast<uint4*>(As + r * LDW + c) = v;
    }
    if (__syncthreads_or(any)) {
#pragma unroll
      for (int k16 = 0; k16 < TILE; k16 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
        for (int a = 0; a < 2; ++a)
          wmma::load_matrix_sync(fa[a], As + (wm * 32 + a * 16) * LDW + k16, LDW);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          wmma::load_matrix_sync(fb[b], Bs + k16 * LDW + wn * 64 + b * 16, LDW);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
      }
    }
    __syncthreads();
  }

  float* cs = Cs + warp * 256;
#pragma unroll
  for (int a = 0; a < 2; ++a) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      wmma::store_matrix_sync(cs, acc[a][b], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = m0 + wm * 32 + a * 16 + e / 16;
        const int n = n0 + wn * 64 + b * 16 + e % 16;
        if (m < M) out[(size_t)m * N + n] = __float2bfloat16(cs[e]);
      }
      __syncwarp();
    }
  }
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

template <typename T, typename MT>
cudaError_t launch(const void* x, const void* w, const void* mask, void* out,
                   int M, int K, int N, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const MT* mp = static_cast<const MT*>(mask);
  T* op = static_cast<T*>(out);
  cudaError_t err;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (M >= TILE) {
      static bool ready = false;
      auto kernel = masked_wmma_kernel<MT>;
      if ((err = allow_smem(kernel, WMMA_SMEM, ready)) != cudaSuccess) return err;
      dim3 grid(N / TILE, (M + TILE - 1) / TILE);
      kernel<<<grid, THREADS, WMMA_SMEM, s>>>(xp, wp, mp, op, M, K, N);
      return cudaGetLastError();
    }
  }
  if (M >= 64) {
    constexpr int BM = 64;
    static bool ready = false;
    auto kernel = masked_fma_kernel<T, MT, BM, 4, 8>;
    const size_t smem = (TILE * TILE + TILE * (BM + 1)) * sizeof(float);
    if ((err = allow_smem(kernel, smem, ready)) != cudaSuccess) return err;
    dim3 grid(N / TILE, (M + BM - 1) / BM);
    kernel<<<grid, THREADS, smem, s>>>(xp, wp, mp, op, M, K, N);
  } else {
    constexpr int BM = 16;
    static bool ready = false;
    auto kernel = masked_fma_kernel<T, MT, BM, 2, 4>;
    const size_t smem = (TILE * TILE + TILE * (BM + 1)) * sizeof(float);
    if ((err = allow_smem(kernel, smem, ready)) != cudaSuccess) return err;
    dim3 grid(N / TILE, (M + BM - 1) / BM);
    kernel<<<grid, THREADS, smem, s>>>(xp, wp, mp, op, M, K, N);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_mask(const void* x, const void* w, const void* mask, void* out,
                        int M, int K, int N, int mask_dtype, cudaStream_t s) {
  if (mask_dtype == 0) return launch<T, float>(x, w, mask, out, M, K, N, s);
  if (mask_dtype == 1) return launch<T, __nv_bfloat16>(x, w, mask, out, M, K, N, s);
  if (mask_dtype == 2) return launch<T, uint8_t>(x, w, mask, out, M, K, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (M, K), w (K, N), mask (K, N) and out (M, N) contiguous and 16-byte
// aligned; K and N multiples of 128.  dtype (x, w, out): 0 = float32,
// 1 = bfloat16; mask_dtype: 0 = float32, 1 = bfloat16, 2 = one byte
// (bool / uint8).  Returns cudaGetLastError() after the launch.
extern "C" int masked_matmul_launch(const void* x, const void* w,
                                    const void* mask, void* out, int M, int K,
                                    int N, int dtype, int mask_dtype,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0 || N <= 0 || K % TILE || N % TILE) return cudaErrorInvalidValue;
  if (dtype == 0) return launch_mask<float>(x, w, mask, out, M, K, N, mask_dtype, s);
  if (dtype == 1) return launch_mask<__nv_bfloat16>(x, w, mask, out, M, K, N, mask_dtype, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
