// Per-query RAFT correlation-window lookup over the all-pairs volume: K7 (a
// block per tile of 32 neighbouring queries) and K6 (a warp per query), each
// running every level of the pyramid in one launch.
//
// Replaces: robust_pose_tpu/ops/pallas_lookup.py::_lookup_kernel (K6, reached
// through pallas_lookup_level / pallas_lookup_pyramid) and
// ::_lookup_kernel_grouped (K7, pallas_lookup_level_grouped /
// pallas_lookup_pyramid_grouped: RAFT's lookup "grouped"), which run one
// pallas_call per pyramid level and GRU iteration.
//
// What both compute, per level l and query m with its own correlation image
// corr_l[m] (Hl, Wl), f32 or bf16, and centre c = coords[m] * 2^-l in level
// pixels: x0 = floor(c.x), wx = c.x - x0 (likewise y), and over the 10 x 10
// taps T[i][j] = corr_l[m, y0-4+i, x0-4+j] (zero where the tap row or column
// lies outside the level: the Pallas kernels' iota match never hits it),
// rows first, ry[i][j] = (1-wy) T[i][j] + wy T[i+1][j], then columns,
// out[i][k] = (1-wx) ry[i][k] + wx ry[i][k+1], i, k in 0..8. The bf16 volume
// is widened to f32 before any product. Query m = b N + q of level l writes
// out[b sb + l sl + (9 i + k) sk + q sq]: the port's lookup layout
// (B, L*81, N), whose per-level (B, 81, N) slices RAFT's motion encoder
// takes, or (M, 81) for the JAX contract of one level.
//
// What bounds them on an H100, and the designs. The Pallas kernels multiply
// each query's whole Hl x Wl image by iota-built one-hot row and column
// weights on the MXU, 8 queries to a block-diagonal product in K7, because a
// TPU gathers slowly. A Hopper SM gathers well, so both read only the 100 taps
// a window touches. The work is a few flops a tap; the bound is the bytes,
// the in-level taps and the f32 outputs, two thirds of them outputs (at the
// f2m precompute's shapes, 40,960 queries, 4 levels, bf16: about 24 MB of
// taps and 53 MB of outputs, ~0.023 ms at 3.35 TB/s). At the f2m step's batch
// of 1 that bound (~0.003 ms) is below what any launch costs, so there the
// launch bounds them: one launch serves the whole pyramid, the level a grid
// dimension. Each query's taps lie in its own image, 10 KB (bf16, level 0)
// from the next query's, so neighbouring queries share no sectors; a tap row
// is 10 contiguous elements, one or two 32-byte sectors.
// * K7, the kernel for the (B, L*81, N) layout. The group of 8 was the MXU's;
//   a warp's width and a 128-byte line are this card's. A block of 10 warps
//   takes 32 neighbouring queries of one level. 300 of its threads fetch the
//   tile's 32 x 100 taps, thread (qq, t) tap t of queries qq, qq + 3, ...: a
//   warp load covers three or four tap rows of one query (where a thread
//   walks a tap row instead, every warp load touches 32 sectors of 32
//   images, ten times over), a thread's tap row and column never change,
//   every load is started before any is used,
//   and each tap is fetched once, into a shared [32][101] f32 tile (the odd
//   query stride keeps the next step's reads on 32 banks). Then lane = query
//   and warp = window row: a warp blends its two tap rows once and stores 9
//   entries, each 32 consecutive queries, a full 128-byte line. The loads
//   are bound by latency (the stores alone run at a memset's rate), so the
//   block is held to 32 registers a thread and 6 blocks share an SM.
// * K6 stays the per-query kernel its Pallas original is, with a warp, not a
//   thread, on the query: the 100 taps go out as four independent warp-wide
//   loads (lane l takes taps l, l + 32, ...), are exchanged through shared
//   memory, and each lane computes entries l, l + 32, l + 64. In the (M, 81)
//   layout a query's 81 floats are contiguous and the warp's stores coalesce.
//   In the (B, L*81, N) layout a warp's store would be 4 bytes each of 32
//   sectors, and such stores then take most of the kernel's time, so there
//   the 8 warps of a block, on 8 neighbouring queries, gather their entries in
//   shared memory and the block stores them 8 queries to a 32-byte sector; a
//   full line needs 32 queries, and K7 is the kernel for that layout.
// The arithmetic uses __fmul_rn / __fadd_rn (no FMA contraction), so both
// round as the plain PyTorch version's separate products and sums do.
// Positions are tested in float before any int conversion, so NaN or huge
// centres read nothing (their outputs are zero, or NaN where a NaN weight
// meets them, as in the plain version).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int R = 4;
constexpr int D = 2 * R + 1;   // 9
constexpr int P = D + 1;       // 10 tap rows and columns
constexpr int TAPS = P * P;    // 100
constexpr int E = D * D;       // 81 window entries
constexpr int MAX_LEVELS = 4;

// K7: 10 warps; 300 threads load (3 queries of 100 taps a round), 9 warps
// compute (a window row each); 6 blocks an SM (32 registers a thread): the
// loads are bound by latency, so the threads in flight set the time
constexpr int TILE = 32;             // queries a block
constexpr int K7_THREADS = 320;
constexpr int K7_BLOCKS_PER_SM = 6;
constexpr int QSTEP = 3;             // queries a round of loads
constexpr int ROUNDS = (TILE + QSTEP - 1) / QSTEP;   // 11
constexpr int QSTRIDE = TAPS + 1;    // words between two queries' taps

// K6: 8 warps, a query each
constexpr int K6_THREADS = 256;
constexpr int K6_WARPS = K6_THREADS / 32;
constexpr int WARP_ITEMS = (TAPS + 31) / 32;   // 4
constexpr int ESTRIDE = E + 3;       // words between two queries' entries

// level l is (H0 >> l, W0 >> l), read at coords * 2^-l
struct Levels {
  const void* corr[MAX_LEVELS];
  int H0, W0;
};

// (a chain of selects: indexing the parameter by l would copy it to the stack)
template <typename T>
__device__ __forceinline__ const T* level_ptr(const Levels& lv, int l) {
  return static_cast<const T*>(l == 0   ? lv.corr[0]
                               : l == 1 ? lv.corr[1]
                               : l == 2 ? lv.corr[2]
                                        : lv.corr[3]);
}

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
};

__device__ __forceinline__ Window window(const float* __restrict__ coords,
                                         int64_t m, float inv_scale) {
  const float cx = coords[2 * m] * inv_scale;
  const float cy = coords[2 * m + 1] * inv_scale;
  Window w;
  w.x0 = floorf(cx);
  w.y0 = floorf(cy);
  w.wx = cx - w.x0;
  w.wy = cy - w.y0;
  return w;
}

// tap (r, c) of one query's image: img[y0-4+r, x0-4+c], zero outside; dr, dc
// are r - 4 and c - 4 as floats
template <typename T>
__device__ __forceinline__ float load_tap(const T* __restrict__ img, int Hl,
                                          int Wl, const Window& w, float dr,
                                          float dc) {
  const float yy = w.y0 + dr;
  const float xx = w.x0 + dc;
  if (yy >= 0.f && yy < (float)Hl && xx >= 0.f && xx < (float)Wl)
    return to_f32(__ldg(img + (int)yy * Wl + (int)xx));
  return 0.f;
}

// the weights of tap rows i and i + 1 in window row i: zero outside the level
__device__ __forceinline__ void row_weights(const Window& w, int i, int Hl,
                                            float& w0, float& w1) {
  const float ya = w.y0 + (float)(i - R), yc = w.y0 + (float)(i + 1 - R);
  w0 = (ya >= 0.f && ya < (float)Hl) ? 1.f - w.wy : 0.f;
  w1 = (yc >= 0.f && yc < (float)Hl) ? w.wy : 0.f;
}

// K7: a block per tile of TILE neighbouring queries of one level
// (blockIdx.y); blockIdx.x = b * tiles + tile
template <typename T>
__global__ void __launch_bounds__(K7_THREADS, K7_BLOCKS_PER_SM)
grouped_lookup_kernel(Levels lv, const float* __restrict__ coords,
                      float* __restrict__ out, int N, int tiles, int64_t sb,
                      int64_t sl, int64_t sk, int64_t sq) {
  __shared__ float taps[TILE * QSTRIDE];
  __shared__ Window win[TILE];
  const int l = blockIdx.y;
  const int Hl = lv.H0 >> l, Wl = lv.W0 >> l;
  const int b = blockIdx.x / tiles;
  const int q0 = (blockIdx.x - b * tiles) * TILE;
  const int nq = min(TILE, N - q0);           // the ragged last tile
  const int64_t m0 = (int64_t)b * N + q0;
  if (threadIdx.x < nq)
    win[threadIdx.x] = window(coords, m0 + threadIdx.x, 1.f / (float)(1 << l));
  __syncthreads();
  // thread (qq, t) loads tap t of queries qq, qq + 3, ...: its tap row and
  // column stay, a warp load covers three or four tap rows of one query
  const int qq = threadIdx.x / TAPS, t = threadIdx.x - qq * TAPS;
  if (qq < QSTEP) {
    const int r = t / P, c = t - r * P;
    const float dr = (float)(r - R), dc = (float)(c - R);
    const T* img = level_ptr<T>(lv, l) + (m0 + qq) * Hl * Wl;
    float v[ROUNDS];
#pragma unroll
    for (int it = 0; it < ROUNDS; ++it) {
      const int q = qq + QSTEP * it;
      v[it] = q < nq ? load_tap(img + (int64_t)(QSTEP * it) * Hl * Wl, Hl, Wl,
                                win[q], dr, dc)
                     : 0.f;
    }
#pragma unroll
    for (int it = 0; it < ROUNDS; ++it) {
      const int q = qq + QSTEP * it;
      if (q < TILE) taps[q * QSTRIDE + t] = v[it];
    }
  }
  __syncthreads();
  // warp i computes window row i of the tile, lane = query: its stores are
  // one entry of 32 neighbouring queries each
  const int lane = threadIdx.x & 31, i = threadIdx.x >> 5;
  if (i >= D || lane >= nq) return;
  const Window w = win[lane];
  float w0, w1;
  row_weights(w, i, Hl, w0, w1);
  const float* a = taps + lane * QSTRIDE + i * P;
  float ry[P];
#pragma unroll
  for (int j = 0; j < P; ++j) ry[j] = lin2(w0, a[j], w1, a[P + j]);
  float* o = out + b * sb + l * sl + (int64_t)(q0 + lane) * sq + i * D * sk;
#pragma unroll
  for (int k = 0; k < D; ++k)
    o[k * sk] = lin2(1.f - w.wx, ry[k], w.wx, ry[k + 1]);
}

// K6: a warp per query m = blockIdx.x * K6_WARPS + warp of one level
// (blockIdx.y)
template <typename T>
__global__ void __launch_bounds__(K6_THREADS)
pixel_lookup_kernel(Levels lv, const float* __restrict__ coords,
                    float* __restrict__ out, int M, int N, int64_t sb,
                    int64_t sl, int64_t sk, int64_t sq) {
  __shared__ float taps[K6_WARPS][WARP_ITEMS * 32];
  __shared__ float vals[K6_WARPS][ESTRIDE];
  __shared__ int64_t base[K6_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = blockIdx.y;
  const int Hl = lv.H0 >> l, Wl = lv.W0 >> l;
  const int m0 = blockIdx.x * K6_WARPS;
  const int m = m0 + warp;
  // where the warps' queries are the closer-packed axis of the output, the
  // block gathers its 8 queries' entries and stores them 8 to a sector
  const bool gather = sq < sk;
  if (m < M) {
    const Window w = window(coords, m, 1.f / (float)(1 << l));
    const T* img = level_ptr<T>(lv, l) + (int64_t)m * Hl * Wl;
    float v[WARP_ITEMS];
#pragma unroll
    for (int it = 0; it < WARP_ITEMS; ++it) {
      const int t = lane + 32 * it;
      const int r = t / P, c = t - r * P;
      v[it] = t < TAPS ? load_tap(img, Hl, Wl, w, (float)(r - R), (float)(c - R))
                       : 0.f;
    }
#pragma unroll
    for (int it = 0; it < WARP_ITEMS; ++it) taps[warp][lane + 32 * it] = v[it];
    __syncwarp();
    const int b = m / N;
    const int64_t off = b * sb + l * sl + (int64_t)(m - b * N) * sq;
    if (lane == 0) base[warp] = off;
    for (int e = lane; e < E; e += 32) {
      const int i = e / D, k = e - i * D;
      float w0, w1;
      row_weights(w, i, Hl, w0, w1);
      const float* a = taps[warp] + i * P + k;
      const float val = lin2(1.f - w.wx, lin2(w0, a[0], w1, a[P]), w.wx,
                             lin2(w0, a[1], w1, a[P + 1]));
      if (gather)
        vals[warp][e] = val;
      else
        out[off + e * sk] = val;
    }
  }
  if (!gather) return;
  __syncthreads();
  const int nq = min(K6_WARPS, M - m0);
  for (int idx = threadIdx.x; idx < E * K6_WARPS; idx += K6_THREADS) {
    const int e = idx / K6_WARPS, q = idx - e * K6_WARPS;
    if (q < nq) out[base[q] + e * sk] = vals[q][e];
  }
}

__global__ void noop_kernel() {}

template <typename T>
int launch(bool grouped, const Levels& lv, const void* coords, void* out, int B,
           int N, int L, int64_t sb, int64_t sl, int64_t sk, int64_t sq,
           cudaStream_t s) {
  const float* xy = static_cast<const float*>(coords);
  float* o = static_cast<float*>(out);
  if (grouped) {
    const int tiles = (N + TILE - 1) / TILE;
    const dim3 grid((unsigned)(B * tiles), (unsigned)L);
    grouped_lookup_kernel<T><<<grid, K7_THREADS, 0, s>>>(lv, xy, o, N, tiles,
                                                         sb, sl, sk, sq);
  } else {
    const int M = B * N;
    const dim3 grid((unsigned)((M + K6_WARPS - 1) / K6_WARPS), (unsigned)L);
    pixel_lookup_kernel<T><<<grid, K6_THREADS, 0, s>>>(lv, xy, o, M, N, sb, sl,
                                                       sk, sq);
  }
  return (int)cudaGetLastError();
}

int dispatch(bool grouped, const void* c0, const void* c1, const void* c2,
             const void* c3, const void* coords, void* out, int B, int N,
             int H0, int W0, int L, long long sb, long long sl, long long sk,
             long long sq, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // queries and one image's elements are counted in int
  if (B <= 0 || N <= 0 || L < 1 || L > MAX_LEVELS || H0 < 0 || W0 < 0 ||
      (int64_t)B * (N + TILE) > 0x7fffffffLL ||
      (int64_t)H0 * W0 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Levels lv = {{c0, c1, c2, c3}, H0, W0};
  return dtype == 1 ? launch<__nv_bfloat16>(grouped, lv, coords, out, B, N, L,
                                            sb, sl, sk, sq, s)
                    : launch<float>(grouped, lv, coords, out, B, N, L, sb, sl,
                                    sk, sq, s);
}

}  // namespace

// One launch for the L <= 4 levels of a pyramid. Level l: corr_l
// (B N, H0 >> l, W0 >> l) contiguous, dtype 0 = float32, 1 = bfloat16 (levels
// past L are not read); coords (B N, 2) f32 in level-0 pixels, multiplied by
// 2^-l; out f32 with element (query m = b N + q, level l, window entry e) at
// b sb + l sl + e sk + q sq. Returns the CUDA error of the launch.
extern "C" int pixel_lookup(const void* c0, const void* c1, const void* c2,
                            const void* c3, const void* coords, void* out,
                            int B, int N, int H0, int W0, int L, long long sb,
                            long long sl, long long sk, long long sq,
                            int dtype, void* stream) {
  return dispatch(false, c0, c1, c2, c3, coords, out, B, N, H0, W0, L, sb, sl,
                  sk, sq, dtype, stream);
}

extern "C" int grouped_lookup(const void* c0, const void* c1, const void* c2,
                              const void* c3, const void* coords, void* out,
                              int B, int N, int H0, int W0, int L,
                              long long sb, long long sl, long long sk,
                              long long sq, int dtype, void* stream) {
  return dispatch(true, c0, c1, c2, c3, coords, out, B, N, H0, W0, L, sb, sl,
                  sk, sq, dtype, stream);
}

// An empty kernel through the same path: what any launch costs at least.
extern "C" int noop_launch(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
