// Per-query RAFT correlation-window lookup over the all-pairs volume: K6 (one
// thread per query) and K7 (a warp per GROUP = 8 queries).
//
// Replaces: robust_pose_tpu/ops/pallas_lookup.py::_lookup_kernel (K6, reached
// through pallas_lookup_level / pallas_lookup_pyramid) and
// ::_lookup_kernel_grouped (K7, pallas_lookup_level_grouped /
// pallas_lookup_pyramid_grouped: RAFT's lookup "grouped"), one launch each
// per pyramid level and GRU iteration.
//
// What both compute, per query m with its own correlation image
// corr[m] (Hl, Wl), f32 or bf16, and centre c = coords[m] * inv_scale in level
// pixels: x0 = floor(c.x), wx = c.x - x0 (likewise y), and over the 10 x 10
// taps T[i][j] = corr[m, y0-4+i, x0-4+j] (zero where the tap row or column
// lies outside the level: the Pallas kernels' iota match never hits it),
// rows first, ry[i][j] = (1-wy) T[i][j] + wy T[i+1][j], then columns,
// out[i][k] = (1-wx) ry[i][k] + wx ry[i][k+1], i, k in 0..8. The bf16 volume
// is widened to f32 before any product. Query m = b N + q writes
// out[b sb + (9 i + k) sk + q sq]: (M, 81) for the JAX contract, or the
// port's (B, 81, N) lookup layout without a transpose.
//
// What bounds them on an H100, and the design. The Pallas kernels multiply
// each query's whole Hl x Wl image by iota-built one-hot row and column
// weights on the MXU, 8 queries to a block-diagonal product in K7, because a
// TPU gathers slowly. A Hopper SM gathers well, so both read only the 100 taps
// a window touches. The work is a few flops a tap; the bound is the bytes:
// the in-level taps and the f32 outputs (at the f2m precompute's shapes,
// 40,960 queries, 4 levels, bf16: about 33 MB of taps and 53 MB of outputs,
// ~0.026 ms at 3.35 TB/s). Each query's taps lie in its own image, 10 KB
// (bf16, level 0) from the next query's, so neighbouring queries share no
// sectors:
// * K6: one thread per query, the layout of the lane-wise K4. A warp load
//   touches 32 sectors of 32 different images; a thread keeps two tap rows in
//   registers.
// * K7: a warp per 8 queries, 4 lanes per query, lane j computing window rows
//   j, j+4, j+8 from tap rows i and i+1. A tap row is 10 contiguous elements
//   of one image, so each lane's loads touch one or two sectors; rows shared
//   by neighbouring lanes are read twice, from L1.
// The arithmetic uses __fmul_rn / __fadd_rn (no FMA contraction), so both
// round as the plain PyTorch version's separate products and sums do.
// Positions are tested in float before any int conversion, so NaN or huge
// centres read nothing and give zero outputs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int R = 4;
constexpr int D = 2 * R + 1;  // 9
constexpr int P = D + 1;      // 10 tap rows and columns
constexpr int THREADS = 128;
constexpr int GROUP = 8;      // K7: queries per warp
constexpr int LANES = 32 / GROUP;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a*b + c*d with both products and the sum rounded separately
__device__ __forceinline__ float lin2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

struct Window {
  float x0, y0, wx, wy;
  bool colok[P];
};

__device__ __forceinline__ void window(const float* coords, int64_t m,
                                       float inv_scale, int Wl, Window& w) {
  const float cx = coords[2 * m] * inv_scale;
  const float cy = coords[2 * m + 1] * inv_scale;
  w.x0 = floorf(cx);
  w.y0 = floorf(cy);
  w.wx = cx - w.x0;
  w.wy = cy - w.y0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float xx = w.x0 - R + j;
    w.colok[j] = xx >= 0.f && xx < (float)Wl;
  }
}

// tap row yy of one query's image: row[j] = img[yy, x0-R+j], zero outside
template <typename T>
__device__ __forceinline__ bool load_row(const T* __restrict__ img, int Hl,
                                         int Wl, float yy, const Window& w,
                                         float* row) {
  const bool ok = yy >= 0.f && yy < (float)Hl;
  if (ok) {
    const T* p = img + (int64_t)(int)yy * Wl;
#pragma unroll
    for (int j = 0; j < P; ++j)
      row[j] = w.colok[j] ? to_f32(__ldg(p + (int)(w.x0 - R + j))) : 0.f;
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) row[j] = 0.f;
  }
  return ok;
}

// window row i from tap rows i (a, in level if oka) and i+1 (c)
__device__ __forceinline__ void emit_row(const float* a, bool oka,
                                         const float* c, bool okc,
                                         const Window& w, float* out_m,
                                         int64_t sk, int i) {
  const float w0 = oka ? 1.f - w.wy : 0.f;
  const float w1 = okc ? w.wy : 0.f;
  float ry[P];
#pragma unroll
  for (int j = 0; j < P; ++j) ry[j] = lin2(w0, a[j], w1, c[j]);
#pragma unroll
  for (int k = 0; k < D; ++k)
    out_m[(int64_t)(i * D + k) * sk] = lin2(1.f - w.wx, ry[k], w.wx, ry[k + 1]);
}

// K6: one thread per query
template <typename T>
__global__ void __launch_bounds__(THREADS)
pixel_lookup_kernel(const T* __restrict__ corr, const float* __restrict__ coords,
                    float* __restrict__ out, int M, int N, int Hl, int Wl,
                    float inv_scale, int64_t sb, int64_t sk, int64_t sq) {
  const int64_t m = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (m >= M) return;
  Window w;
  window(coords, m, inv_scale, Wl, w);
  const T* img = corr + m * Hl * Wl;
  float* out_m = out + (m / N) * sb + (m % N) * sq;
  float prev[P], cur[P];
  bool prev_ok = load_row(img, Hl, Wl, w.y0 - R, w, prev);
#pragma unroll
  for (int i = 0; i < D; ++i) {
    const bool ok = load_row(img, Hl, Wl, w.y0 - R + i + 1, w, cur);
    emit_row(prev, prev_ok, cur, ok, w, out_m, sk, i);
#pragma unroll
    for (int j = 0; j < P; ++j) prev[j] = cur[j];
    prev_ok = ok;
  }
}

// K7: a warp per GROUP queries, LANES lanes per query; lane j of a query
// computes window rows j, j + LANES, ...
template <typename T>
__global__ void __launch_bounds__(THREADS)
grouped_lookup_kernel(const T* __restrict__ corr,
                      const float* __restrict__ coords, float* __restrict__ out,
                      int M, int N, int Hl, int Wl, float inv_scale, int64_t sb,
                      int64_t sk, int64_t sq) {
  const int lane = threadIdx.x & 31;
  const int64_t warp = (int64_t)blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int64_t m = warp * GROUP + lane / LANES;
  if (m >= M) return;
  Window w;
  window(coords, m, inv_scale, Wl, w);
  const T* img = corr + m * Hl * Wl;
  float* out_m = out + (m / N) * sb + (m % N) * sq;
  for (int i = lane % LANES; i < D; i += LANES) {
    float a[P], c[P];
    const bool oka = load_row(img, Hl, Wl, w.y0 - R + i, w, a);
    const bool okc = load_row(img, Hl, Wl, w.y0 - R + i + 1, w, c);
    emit_row(a, oka, c, okc, w, out_m, sk, i);
  }
}

template <typename T>
int launch(bool grouped, const void* corr, const void* coords, void* out, int M,
           int N, int Hl, int Wl, float inv_scale, int64_t sb, int64_t sk,
           int64_t sq, cudaStream_t s) {
  const T* c = static_cast<const T*>(corr);
  const float* xy = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (grouped) {
    const int64_t threads = ((int64_t)M + GROUP - 1) / GROUP * 32;
    grouped_lookup_kernel<T><<<(unsigned)((threads + THREADS - 1) / THREADS),
                               THREADS, 0, s>>>(c, xy, o, M, N, Hl, Wl,
                                                inv_scale, sb, sk, sq);
  } else {
    pixel_lookup_kernel<T><<<(unsigned)(((int64_t)M + THREADS - 1) / THREADS),
                             THREADS, 0, s>>>(c, xy, o, M, N, Hl, Wl, inv_scale,
                                              sb, sk, sq);
  }
  return (int)cudaGetLastError();
}

int dispatch(bool grouped, const void* corr, const void* coords, void* out,
             int M, int N, int Hl, int Wl, float inv_scale, long long sb,
             long long sk, long long sq, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || M % N != 0) return (int)cudaErrorInvalidValue;
  return dtype == 1
             ? launch<__nv_bfloat16>(grouped, corr, coords, out, M, N, Hl, Wl,
                                     inv_scale, sb, sk, sq, s)
             : launch<float>(grouped, corr, coords, out, M, N, Hl, Wl,
                             inv_scale, sb, sk, sq, s);
}

}  // namespace

// corr (M, Hl, Wl) contiguous, dtype 0 = float32, 1 = bfloat16; coords (M, 2)
// f32, multiplied by inv_scale; out f32 with element (m = b N + q, window
// entry e) at b sb + e sk + q sq. Returns the CUDA error of the launch.
extern "C" int pixel_lookup(const void* corr, const void* coords, void* out,
                            int M, int N, int Hl, int Wl, float inv_scale,
                            long long sb, long long sk, long long sq, int dtype,
                            void* stream) {
  return dispatch(false, corr, coords, out, M, N, Hl, Wl, inv_scale, sb, sk, sq,
                  dtype, stream);
}

extern "C" int grouped_lookup(const void* corr, const void* coords, void* out,
                              int M, int N, int Hl, int Wl, float inv_scale,
                              long long sb, long long sk, long long sq,
                              int dtype, void* stream) {
  return dispatch(true, corr, coords, out, M, N, Hl, Wl, inv_scale, sb, sk, sq,
                  dtype, stream);
}
