// RAFT correlation-window lookup over the transposed volume (K4) and its
// backward (K5).
//
// Replaces: robust_pose_tpu/ops/pallas_lookup_lanewise.py::_lanewise_kernel
// (forward, reached through _lookup_level / lanewise_lookup) and
// ::_lanewise_bwd_kernel (its custom VJP), one launch each per pyramid level
// and GRU iteration of a training step with live RAFT gradients.
//
// What they compute, per (batch b, query n, level): the sample centre
// c = coords[b, n] / 2^level in level pixels, x0 = floor(c.x), y0 = floor(c.y),
// wx = c.x - x0, wy = c.y - y0, and for the D x D window (D = 2r + 1) the
// bilinear sample of the volume corr[b, :, :, n] (B, Hl, Wl, N), N minor,
// separably: rows first, A[i][j'] = (1-wy) T[i][j'] + wy T[i+1][j'], then
// columns, out[i][j] = (1-wx) A[i][j] + wx A[i][j+1], over the
// (D+1) x (D+1) taps T[i][j'] = corr[b, y0-r+i, x0-r+j', n]. A tap row or
// column outside [0, Hl) x [0, Wl) carries weight zero (the Pallas kernel's
// iota match never hits it; grid_sample's zero padding, partial corners
// included). Output (B, D*D, N) f32, dy-major. The backward returns
// dcorr (B, Hl, Wl, N) in the volume's dtype and dcoords (B, N, 2) =
// [dcx, dcy] / 2^level, with the Pallas backward's formulas.
//
// What bounds them on an H100, and the design. The Pallas kernels are dense:
// each 128-lane block multiplies the whole Hl x Wl slab by iota-built
// one-hot weights (~6.7 M MACs a block at level 0), because a TPU has cheap
// lanes and slow gathers. A Hopper SM gathers well, so here one thread owns
// one query n (neighbouring threads on neighbouring n, so queries with
// nearby centres read nearby addresses and share L1/L2 sectors) and reads
// only the (D+1)^2 = 100 taps its window touches, row by row, keeping two
// tap rows in registers.
// * K4 moves the taps and writes the outputs: at the training shapes
//   (B = 24 pairs, N = 5120, 4 levels, bf16 volume) about 258 MB per 4-level
//   lookup, ~0.08 ms at 3.35 TB/s; its arithmetic (~4 flops a tap) is
//   negligible. It is bound by the gather's sector traffic and latency.
//   The arithmetic uses __fmul_rn / __fadd_rn (no FMA contraction), so it
//   rounds exactly as the plain PyTorch version's separate multiplies and
//   adds do.
// * K5: dcorr[b, y, x, n] receives only from query n, so each thread owns
//   one column of the volume: it writes its <= 100 tap cotangents with plain
//   stores, no atomics, and the result is deterministic. The rest of dcorr
//   is zero, written by one cudaMemsetAsync before the kernel. That dense
//   write is K5's bound: the 4-level dcorr is ~1.67 GB in bf16 at the
//   training shapes, ~0.5 ms at 3.35 TB/s. dcy and dcx are accumulated in
//   registers from the row and column derivative weights.
// Positions are tested in float before any int conversion, so NaN or huge
// centres read nothing and give zero outputs, as the Pallas kernels do.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// a*b + c*d with both products and the sum rounded separately
__device__ __forceinline__ float lin2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

struct Window {
  float wx, wy, x0, y0;
};

__device__ __forceinline__ Window window(const float* coords, size_t q,
                                         float inv_scale) {
  Window w;
  const float cx = coords[2 * q] * inv_scale;
  const float cy = coords[2 * q + 1] * inv_scale;
  w.x0 = floorf(cx);
  w.y0 = floorf(cy);
  w.wx = cx - w.x0;
  w.wy = cy - w.y0;
  return w;
}

// tap row i' of the window: T[j'] = corr[b, y, x0-R+j', n], zero where the
// row or the column lies outside the level
template <int R, typename T>
__device__ __forceinline__ bool load_row(const T* __restrict__ corr_b, int N,
                                         int Hl, int Wl, float yy,
                                         const Window& w, const bool* colok,
                                         float* row) {
  constexpr int P = 2 * R + 2;
  const bool ok = yy >= 0.f && yy < (float)Hl;
  if (ok) {
    const T* p = corr_b + (size_t)(int)yy * Wl * N;
#pragma unroll
    for (int j = 0; j < P; ++j)
      row[j] = colok[j]
                   ? to_f32(__ldg(p + (size_t)(int)(w.x0 - R + j) * N))
                   : 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) row[j] = 0.f;
  }
  return ok;
}

// K4: out (B, D*D, N) f32
template <int R, typename T>
__global__ void __launch_bounds__(THREADS)
lanewise_fwd_kernel(const T* __restrict__ corr,
                    const float* __restrict__ coords, float* __restrict__ out,
                    int N, int Hl, int Wl, float inv_scale) {
  constexpr int D = 2 * R + 1;
  constexpr int P = D + 1;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= N) return;
  const Window w = window(coords, (size_t)b * N + n, inv_scale);
  bool colok[P];
  float wc0[P], wc1[P];  // column weights: 1-wx at the left tap, wx at the right
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float xx = w.x0 - R + j;
    colok[j] = xx >= 0.f && xx < (float)Wl;
    wc0[j] = colok[j] ? 1.f - w.wx : 0.f;
    wc1[j] = colok[j] ? w.wx : 0.f;
  }
  const T* corr_b = corr + (size_t)b * Hl * Wl * N + n;
  float* out_b = out + (size_t)b * D * D * N + n;
  float prev[P], cur[P];
  bool prev_ok = load_row<R>(corr_b, N, Hl, Wl, w.y0 - R, w, colok, prev);
#pragma unroll
  for (int i = 1; i < P; ++i) {
    const bool ok = load_row<R>(corr_b, N, Hl, Wl, w.y0 - R + i, w, colok, cur);
    const float w0 = prev_ok ? 1.f - w.wy : 0.f;
    const float w1 = ok ? w.wy : 0.f;
    float A[P];
#pragma unroll
    for (int j = 0; j < P; ++j) A[j] = lin2(w0, prev[j], w1, cur[j]);
#pragma unroll
    for (int j = 0; j < D; ++j)
      out_b[(size_t)((i - 1) * D + j) * N] = lin2(wc0[j], A[j], wc1[j + 1], A[j + 1]);
#pragma unroll
    for (int j = 0; j < P; ++j) prev[j] = cur[j];
    prev_ok = ok;
  }
}

// gx[j'] = wx g[j'-1] + (1-wx) g[j'] and gxp[j'] = g[j'-1] - g[j'] for the
// window row dy of the output cotangent g (B, D*D, N) f32
template <int R>
__device__ __forceinline__ void g_row(const float* __restrict__ g_b, int N,
                                      int dy, float wx, float* gx,
                                      float* gxp) {
  constexpr int D = 2 * R + 1;
  constexpr int P = D + 1;
  float gr[D];
#pragma unroll
  for (int j = 0; j < D; ++j) gr[j] = __ldg(g_b + (size_t)(dy * D + j) * N);
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float lo = j >= 1 ? gr[j - 1] : 0.f;
    const float hi = j < D ? gr[j] : 0.f;
    gx[j] = lin2(wx, lo, 1.f - wx, hi);
    gxp[j] = __fsub_rn(lo, hi);
  }
}

// K5: dcorr (B, Hl, Wl, N) zero outside the windows (memset by the caller),
// dcoords (B, N, 2) f32
template <int R, typename T>
__global__ void __launch_bounds__(THREADS)
lanewise_bwd_kernel(const T* __restrict__ corr,
                    const float* __restrict__ coords,
                    const float* __restrict__ g, T* __restrict__ dcorr,
                    float* __restrict__ dcoords, int N, int Hl, int Wl,
                    float inv_scale) {
  constexpr int D = 2 * R + 1;
  constexpr int P = D + 1;
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int b = blockIdx.y;
  if (n >= N) return;
  const size_t q = (size_t)b * N + n;
  const Window w = window(coords, q, inv_scale);
  bool colok[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float xx = w.x0 - R + j;
    colok[j] = xx >= 0.f && xx < (float)Wl;
  }
  const T* corr_b = corr + (size_t)b * Hl * Wl * N + n;
  T* dcorr_b = dcorr + (size_t)b * Hl * Wl * N + n;
  const float* g_b = g + (size_t)b * D * D * N + n;

  float prev[P], cur[P];          // tap rows i'-1 and i'
  float gx_prev[P], gxp_prev[P];  // window row dy = i'-1
  float gx_cur[P], gxp_cur[P];    // window row dy = i'
  float dcx = 0.f, dcy = 0.f;
  bool prev_ok = false;
#pragma unroll
  for (int j = 0; j < P; ++j) prev[j] = gx_prev[j] = gxp_prev[j] = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const float yy = w.y0 - R + i;
    const bool ok = load_row<R>(corr_b, N, Hl, Wl, yy, w, colok, cur);
    if (i < D) {
      g_row<R>(g_b, N, i, w.wx, gx_cur, gxp_cur);
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) gx_cur[j] = gxp_cur[j] = 0.f;
    }
    if (ok) {
      // dcorr at tap row i': window rows i'-1 (weight wy) and i' (1-wy)
      T* p = dcorr_b + (size_t)(int)yy * Wl * N;
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (colok[j])
          store(p + (size_t)(int)(w.x0 - R + j) * N,
                lin2(w.wy, gx_prev[j], 1.f - w.wy, gx_cur[j]));
    }
    if (i >= 1) {
      // window row dy = i-1: d out / d wy through the row difference of the
      // taps, d out / d wx through the column derivative weights
      const float w0 = prev_ok ? 1.f - w.wy : 0.f;
      const float w1 = ok ? w.wy : 0.f;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (colok[j]) {
          dcy = fmaf(__fsub_rn(cur[j], prev[j]), gx_prev[j], dcy);
          dcx = fmaf(lin2(w0, prev[j], w1, cur[j]), gxp_prev[j], dcx);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      prev[j] = cur[j];
      gx_prev[j] = gx_cur[j];
      gxp_prev[j] = gxp_cur[j];
    }
    prev_ok = ok;
  }
  dcoords[2 * q] = dcx * inv_scale;
  dcoords[2 * q + 1] = dcy * inv_scale;
}

template <int R, typename T>
int launch_fwd(const void* corr, const void* coords, void* out, int B, int N,
               int Hl, int Wl, float inv_scale, cudaStream_t s) {
  dim3 grid((N + THREADS - 1) / THREADS, B);
  lanewise_fwd_kernel<R, T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(corr), static_cast<const float*>(coords),
      static_cast<float*>(out), N, Hl, Wl, inv_scale);
  return (int)cudaGetLastError();
}

template <int R, typename T>
int launch_bwd(const void* corr, const void* coords, const void* g,
               void* dcorr, void* dcoords, int B, int N, int Hl, int Wl,
               float inv_scale, cudaStream_t s) {
  cudaError_t e = cudaMemsetAsync(dcorr, 0, (size_t)B * Hl * Wl * N * sizeof(T), s);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + THREADS - 1) / THREADS, B);
  lanewise_bwd_kernel<R, T><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(corr), static_cast<const float*>(coords),
      static_cast<const float*>(g), static_cast<T*>(dcorr),
      static_cast<float*>(dcoords), N, Hl, Wl, inv_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 volume; radius 4 (RAFT large; checked
// by the Python wrapper). corr (B, Hl, Wl, N), coords (B, N, 2) f32 in
// level-0 pixels, out (B, 81, N) f32; all contiguous. Returns the CUDA error.
extern "C" int lanewise_fwd(const void* corr, const void* coords, void* out,
                            int B, int N, int Hl, int Wl, int radius,
                            float inv_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (radius != 4) return (int)cudaErrorInvalidValue;
  return dtype == 1
             ? launch_fwd<4, __nv_bfloat16>(corr, coords, out, B, N, Hl, Wl, inv_scale, s)
             : launch_fwd<4, float>(corr, coords, out, B, N, Hl, Wl, inv_scale, s);
}

// g (B, 81, N) f32; dcorr (B, Hl, Wl, N) in the volume's dtype (zeroed
// here); dcoords (B, N, 2) f32.
extern "C" int lanewise_bwd(const void* corr, const void* coords,
                            const void* g, void* dcorr, void* dcoords, int B,
                            int N, int Hl, int Wl, int radius,
                            float inv_scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (radius != 4) return (int)cudaErrorInvalidValue;
  return dtype == 1
             ? launch_bwd<4, __nv_bfloat16>(corr, coords, g, dcorr, dcoords, B, N, Hl, Wl, inv_scale, s)
             : launch_bwd<4, float>(corr, coords, g, dcorr, dcoords, B, N, Hl, Wl, inv_scale, s);
}
