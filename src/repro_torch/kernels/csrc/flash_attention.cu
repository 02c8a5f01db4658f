// Flash attention (causal or full, grouped-query) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::
// _flash_kernel (called by flash_attention there):
//
//   q (B, S, Hq, hd), k (B, S, Hkv, hd), v (B, S, Hkv, dv)  ->  out (B, S, Hq, dv)
//
// in float32 or bfloat16, what the TPU kernel computes: q, k and v are
// read as f32, scores q . k times 1/sqrt(hd) (scale of q's width), masked
// positions set to the finite -1e30, the softmax streamed over key tiles
// with a running max m, sum l and accumulator acc in f32 (p stays f32 for
// p @ v), and the output acc / max(l, 1e-30) in q's type.  Query head h
// reads KV head h / (Hq / Hkv): grouped keys are never materialised.
// Beyond the TPU kernel's grid it takes any S >= 1 (the ragged last query
// and key tiles are masked, not asserted away) and a value width dv <= hd
// of its own (MLA prefill: hd = 192, dv = 128).
//
// One thread block per (query tile of BQ = 64 rows, query head, batch
// row), 256 threads.  The block keeps its q tile in shared memory
// (transposed, f32) and walks the key tiles of BK = 64 rows: K (transposed)
// and V are staged in shared memory as f32, each thread computes a 4 x 4
// piece of the 64 x 64 score tile on the CUDA cores, the row max and sum
// are reduced over the 16 threads that share four rows, p goes back to
// shared memory, and each thread accumulates 4 rows x NC value columns
// of p @ v in registers.  Causal blocks stop at the diagonal tile: the
// fully masked tiles past it are skipped, as pl.when skips them on the
// TPU, and the grid runs the late (longest) query tiles first.
//
// What bounds it on the H100: at prefill lengths the work is
// 4 S^2 hd Hq / 2 flops (causal) against ~(2 hd + dv) S Hkv + dv S Hq
// bytes, far above the card's ridge, so the operations bound it.  This
// first kernel does them in f32 on the CUDA cores (67 TFLOP/s peak), not
// on the tensor cores (989 TFLOP/s bf16): its time against the bound is
// in PERF.md, and moving q k^T and p @ v onto wgmma is later work.
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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
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
    qs[d * LD + r] = s < S ? to_f32(q[(((size_t)b * S + s) * Hq + h) * hd + d]) : 0.f;
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
      ks[d * LD + r] = s < S ? to_f32(k[((row0 + s) * Hkv + hk) * hd + d]) : 0.f;
    }
    for (int e = tid; e < BK * dv; e += THREADS) {
      const int r = e / dv, d = e - r * dv;
      const int s = k0 + r;
      vs[r * VLD + d] = s < S ? to_f32(v[((row0 + s) * Hkv + hk) * dv + d]) : 0.f;
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
    T* orow = out + ((row0 + qi) * Hq + h) * dv;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = vcol(tx, c);
      if (col < dv) orow[col] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Hq, int Hkv, int hd, int dv, float scale,
                   int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)2 * hd * LD + (size_t)BQ * LD +
                                       (size_t)BK * 16 * NC);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_attention_kernel<T, NC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((S + BQ - 1) / BQ, Hq, B);
  flash_attention_kernel<T, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Hq, Hkv, hd, dv,
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dv(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int Hq, int Hkv, int hd, int dv,
                      float scale, int causal, cudaStream_t s) {
  if (dv <= 32) return launch<T, 2>(q, k, v, out, B, S, Hq, Hkv, hd, dv, scale, causal, s);
  if (dv <= 64) return launch<T, 4>(q, k, v, out, B, S, Hq, Hkv, hd, dv, scale, causal, s);
  if (dv <= 128) return launch<T, 8>(q, k, v, out, B, S, Hq, Hkv, hd, dv, scale, causal, s);
  if (dv <= 192) return launch<T, 12>(q, k, v, out, B, S, Hq, Hkv, hd, dv, scale, causal, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; causal: 0 or 1.  The wrapper checks
// what the kernel needs: contiguous (B, S, H, d) operands, S >= 1,
// Hq % Hkv == 0, 1 <= dv <= min(hd, 192), hd <= 256 (so that the
// (2 hd + 64) x 68 + 64 x 16 ceil(dv / 16) floats of shared memory fit in
// the 227 KB a block may take).  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int Hq, int Hkv, int hd, int dv,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dv<float>(q, k, v, out, B, S, Hq, Hkv, hd, dv, scale, causal, s);
  if (dtype == 1)
    return launch_dv<__nv_bfloat16>(q, k, v, out, B, S, Hq, Hkv, hd, dv, scale,
                                    causal, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
