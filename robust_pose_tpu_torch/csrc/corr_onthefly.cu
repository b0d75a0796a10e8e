// RAFT correlation window lookup, computed on the fly (no volume in memory).
//
// Replaces: robust_pose_tpu/ops/pallas_corr_onthefly.py::_onthefly_kernel
// (reached through _lookup_level / onthefly_lookup), one launch per pyramid
// level per GRU iteration.
//
// What it computes, per (batch b, query n, level): the sample centre
// c = coords[b, n] / 2^level, and for the (2r+1)^2 window offsets (dy, dx)
// the bilinear sample, with zero padding, of
//     corr(y, x) = <f2_level[b, y, x, :], f1[b, n, :]> / sqrt(C)
// at (c.y - r + dy, c.x - r + dx). Output (B, (2r+1)^2, N) f32, dy-major.
//
// What bounds it on an H100: the Pallas kernel recomputes the whole
// Hl x Wl correlation slab per 128-query block on the TPU's MXU because TPU
// gathers are slow. A Hopper SM gathers well, so this kernel computes only
// the (2r+2)^2 = 100 dot products a window touches (about 13x fewer FLOPs
// than the slab at level 0 of a 64x80 map). At C = 256 in bf16 that is
// 100 x 256 FMAs per query on the CUDA cores plus 100 x 512 B of gathered
// f2 rows, most of them served from L1/L2 because neighbouring queries share
// their windows. Device-memory bytes would bound it at about 0.06 ms per
// 4-level lookup (B = 16, 64x80, C = 256); this simple design is bound by
// latency instead: each window pixel is a dependent gather followed by a
// 5-step shuffle reduction, 100 of them in series per warp (PERF.md has the
// measured time).
//
// Design: one warp per query, WARPS queries (consecutive n) per block. Each
// lane keeps its 16-byte chunks of the query's f1 row in registers as f32.
// For each window pixel inside the level the warp loads the f2 row with
// 16-byte vector loads (lane i reads channels [8i, 8i+8) for bf16 at
// C = 256), multiplies with f32 accumulation and reduces with shuffles. The 100 correlations go to shared
// memory, the 81 bilinear outputs are formed from them, and the block writes
// its (81, WARPS) output tile with consecutive queries side by side.
// Positions are tested in float before any int conversion, so NaN or huge
// coordinates read nothing (and, as in the reference, propagate NaN through
// the bilinear weights).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int MAX_CHUNKS = 4;  // 16-byte chunks of f1 per lane: C <= 128 * 16 B

// 16-byte chunk of an f2 row (VEC elements) dotted with the lane's f1 chunk
// held in registers, f32 accumulation
__device__ __forceinline__ float dot_chunk(const float* q, const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return a.x * q[0] + a.y * q[1] + a.z * q[2] + a.w * q[3];
}

__device__ __forceinline__ float dot_chunk(const float* q,
                                           const __nv_bfloat16* p) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 v = __bfloat1622float2(h[k]);
    acc = fmaf(v.x, q[2 * k], acc);
    acc = fmaf(v.y, q[2 * k + 1], acc);
  }
  return acc;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
corr_window_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                   const float* __restrict__ coords, float* __restrict__ out,
                   int N, int C, int Hl, int Wl, int radius, float inv_scale,
                   float inv_sqrt_c) {
  constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  const int D = 2 * radius + 1;
  const int D2 = D + 1;                     // window rows/cols touched
  extern __shared__ float smem[];
  float* win_all = smem;                    // [WARPS][D2 * D2]
  float* tile = win_all + WARPS * D2 * D2;  // [D * D][WARPS]

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * WARPS;
  const int n = n0 + warp;
  const bool active = n < N;
  float* win = win_all + warp * D2 * D2;
  const int nchunks = C / (32 * VEC);       // whole chunks per lane

  if (active) {
    // the lane's f1 channels [ (j*32 + lane) * VEC, +VEC ) in registers
    float q[MAX_CHUNKS][VEC];
    const T* f1p = f1 + ((size_t)b * N + n) * C;
#pragma unroll
    for (int j = 0; j < MAX_CHUNKS; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        q[j][e] = j < nchunks ? to_f32(f1p[(j * 32 + lane) * VEC + e]) : 0.f;
    const float cx = coords[((size_t)b * N + n) * 2 + 0] * inv_scale;
    const float cy = coords[((size_t)b * N + n) * 2 + 1] * inv_scale;
    const float x0 = floorf(cx);
    const float y0 = floorf(cy);
    const float wx = cx - x0;
    const float wy = cy - y0;
    const T* f2b = f2 + (size_t)b * Hl * Wl * C;

    for (int k = 0; k < D2 * D2; ++k) {
      const float yy = y0 - radius + (k / D2);
      const float xx = x0 - radius + (k % D2);
      float acc = 0.f;
      if (yy >= 0.f && yy < (float)Hl && xx >= 0.f && xx < (float)Wl) {
        const T* p = f2b + ((size_t)(int)yy * Wl + (int)xx) * C + lane * VEC;
#pragma unroll
        for (int j = 0; j < MAX_CHUNKS; ++j)
          if (j < nchunks) acc += dot_chunk(q[j], p + j * 32 * VEC);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
      }
      if (lane == 0) win[k] = acc * inv_sqrt_c;
    }
    __syncwarp();
    // bilinear combination, rows first: A = (1-wy) c[i] + wy c[i+1], then
    // out = (1-wx) A[j] + wx A[j+1] (the order of the reference's one-hot
    // weight products)
    for (int o = lane; o < D * D; o += 32) {
      const int i = o / D, j = o % D;
      const float a0 = (1.f - wy) * win[i * D2 + j] + wy * win[(i + 1) * D2 + j];
      const float a1 = (1.f - wy) * win[i * D2 + j + 1] +
                       wy * win[(i + 1) * D2 + j + 1];
      tile[o * WARPS + warp] = (1.f - wx) * a0 + wx * a1;
    }
  }
  __syncthreads();
  const int nq = min(WARPS, N - n0);
  for (int idx = threadIdx.x; idx < D * D * WARPS; idx += blockDim.x) {
    const int o = idx / WARPS, j = idx % WARPS;
    if (j < nq) out[((size_t)b * D * D + o) * N + n0 + j] = tile[idx];
  }
}

template <typename T>
int launch(const void* f1, const void* f2, const void* coords, void* out,
           int B, int N, int C, int Hl, int Wl, int radius, float inv_scale,
           float inv_sqrt_c, cudaStream_t stream) {
  const int D = 2 * radius + 1;
  const size_t smem =
      sizeof(float) * (WARPS * (D + 1) * (D + 1) + D * D * WARPS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        corr_window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + WARPS - 1) / WARPS, B);
  corr_window_kernel<T><<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<const float*>(coords), static_cast<float*>(out), N, C, Hl,
      Wl, radius, inv_scale, inv_sqrt_c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. f1 (B, N, C), f2 (B, Hl, Wl, C), coords
// (B, N, 2) f32, out (B, (2r+1)^2, N) f32, all contiguous and 16-byte
// aligned; C a multiple of 32 * (16 / element size) and at most MAX_CHUNKS
// times that (checked by the Python wrapper).
extern "C" int corr_window_level(const void* f1, const void* f2,
                                 const void* coords, void* out, int B, int N,
                                 int C, int Hl, int Wl, int radius,
                                 float inv_scale, float inv_sqrt_c, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(f1, f2, coords, out, B, N, C, Hl, Wl, radius,
                                 inv_scale, inv_sqrt_c, s);
  return launch<float>(f1, f2, coords, out, B, N, C, Hl, Wl, radius, inv_scale,
                       inv_sqrt_c, s);
}
