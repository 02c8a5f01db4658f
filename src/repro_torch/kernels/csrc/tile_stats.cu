// Per-tile statistics of a (K, N) weight for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/tile_stats.py
// _tile_stats_kernel: for every (bk, bn) tile of w,
//
//   live[i, j] = any(w[tile] != 0)   (int32)
//   sums[i, j] = sum |w[tile]|       (float32)
//
// the device-side form of core.crossbar.xbar_stats.  The tile extents
// come from PruneConfig.xbar_rows/xbar_cols, so they are run-time
// arguments.  A ragged last row or column of tiles reads as zero: the
// kernel masks rows past K and columns past N instead of padding.
//
// One block per tile (the grid's x is the flat tile index, so any tile
// count fits).  The block's 256 threads stride over the tile's rows
// with 16-byte loads along N when every row piece is 16-byte aligned
// (N and bn multiples of the elements per load, w 16-byte aligned;
// scalar loads otherwise), keep a running f32 sum of |w| and a nonzero
// flag, and reduce them with warp shuffles and one shared-memory pass.
//
// What bounds it on the H100: the bytes of w, read once (one f32 add
// and one compare per element is far below the card's rate).  A
// 128 x 128 f32 tile is 64 KB: each block streams it with all of its
// loads issued before the reduction, and the grid has one block per
// tile (144 blocks for vgg11's 4608 x 512 conv, 1536 for 3072 x 8192).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
tile_stats_kernel(const T* __restrict__ w, int* __restrict__ live,
                  float* __restrict__ sums, int K, int N, int bk, int bn,
                  int nt, bool vec) {
  constexpr int V = 16 / sizeof(T);       // elements per 16-byte load
  const int tile = blockIdx.x;
  const int r0 = (tile / nt) * bk;
  const int c0 = (tile % nt) * bn;
  const int rows = min(bk, K - r0);
  const int cols = min(bn, N - c0);
  float s = 0.f;
  bool any = false;
  if (vec) {
    const int vpr = cols / V;             // cols is a multiple of V here
    for (int e = threadIdx.x; e < rows * vpr; e += THREADS) {
      const int r = e / vpr, c = (e % vpr) * V;
      const uint4 raw = *reinterpret_cast<const uint4*>(w + (size_t)(r0 + r) * N + c0 + c);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = to_f32(v[i]);
        s += fabsf(f);
        any |= (f != 0.f);
      }
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += THREADS) {
      const int r = e / cols, c = e % cols;
      const float f = to_f32(w[(size_t)(r0 + r) * N + c0 + c]);
      s += fabsf(f);
      any |= (f != 0.f);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __shared__ float part[THREADS / 32];
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  const int any_all = __syncthreads_or(any);   // also the barrier for part
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) total += part[i];
    sums[tile] = total;
    live[tile] = any_all ? 1 : 0;
  }
}

}  // namespace

// w (K, N) contiguous, dtype 0 = float32, 1 = bfloat16; live and sums
// (ceil(K / bk), ceil(N / bn)).  Returns cudaGetLastError() after the launch.
extern "C" int tile_stats_launch(const void* w, void* live, void* sums, int K,
                                 int N, int bk, int bn, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 0 || N <= 0 || bk <= 0 || bn <= 0) return cudaErrorInvalidValue;
  const int kt = (K + bk - 1) / bk, nt = (N + bn - 1) / bn;
  const long long tiles = (long long)kt * nt;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool aligned = reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (dtype == 0) {
    const bool vec = aligned && N % 4 == 0 && bn % 4 == 0;
    tile_stats_kernel<float><<<(unsigned)tiles, THREADS, 0, s>>>(
        static_cast<const float*>(w), static_cast<int*>(live),
        static_cast<float*>(sums), K, N, bk, bn, nt, vec);
  } else if (dtype == 1) {
    const bool vec = aligned && N % 8 == 0 && bn % 8 == 0;
    tile_stats_kernel<__nv_bfloat16><<<(unsigned)tiles, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(w), static_cast<int*>(live),
        static_cast<float*>(sums), K, N, bk, bn, nt, vec);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
