// RAFT correlation-window lookup over the transposed volume (K4) and its
// backward (K5), each one launch for every level of the pyramid.
//
// Replaces: robust_pose_tpu/ops/pallas_lookup_lanewise.py::_lanewise_kernel
// (forward, reached through _lookup_level / lanewise_lookup) and
// ::_lanewise_bwd_kernel (its custom VJP), which run one pallas_call per
// pyramid level and GRU iteration of a training step with live RAFT
// gradients.
//
// What they compute, per (batch b, query n, level l): the sample centre
// c = coords[b, n] * s_l in level pixels (s_l = s_0 2^-l), x0 = floor(c.x),
// y0 = floor(c.y), wx = c.x - x0, wy = c.y - y0, and for the D x D window
// (D = 2r + 1 = 9) the bilinear sample of the volume corr_l[b, :, :, n]
// (B, Hl, Wl, N), N minor, (Hl, Wl) = (H0 >> l, W0 >> l), separably: rows
// first, A[i][j'] = (1-wy) T[i][j'] + wy T[i+1][j'], then columns,
// out[i][j] = (1-wx) A[i][j] + wx A[i][j+1], over the (D+1) x (D+1) taps
// T[i][j'] = corr_l[b, y0-r+i, x0-r+j', n]. A tap row or column outside
// [0, Hl) x [0, Wl) carries weight zero (the Pallas kernel's iota match never
// hits it; grid_sample's zero padding, partial corners included). Output
// (B, L*81, N) f32, level l at channels 81 l .. 81 l + 80, dy-major. The
// backward takes the cotangent g of that buffer and returns dcorr_l
// (B, Hl, Wl, N) in the volume's dtype for every level and dcoords (B, N, 2)
// = sum over l of [dcx_l, dcy_l] s_l, with the Pallas backward's formulas.
//
// What bounds them on an H100, and the design. The Pallas kernels are dense:
// each 128-lane block multiplies the whole Hl x Wl slab by iota-built one-hot
// weights, because a TPU has cheap lanes and slow gathers. Here only the 100
// taps a window touches are read. The volume keeps the queries minor, so
// element (y, x) of 32 neighbouring queries is 64 contiguous bytes (bf16),
// while one query's own taps lie N elements apart. A thread that walks its
// own window therefore asks for a 32-byte sector a tap, 32 sectors a warp
// load, and uses 2 bytes of each; neighbouring queries do want the same
// sectors (their windows overlap), but at other moments of their loops.
// * Gathering the taps (both kernels, gather_taps): a warp owns 32
//   neighbouring queries and walks the volume rows their windows touch. A row
//   is staged in shared memory with asynchronous 16-byte copies, 8 queries
//   (bf16) of one position each, and a piece is fetched only where one of its
//   queries has the position in its window: the sectors asked for are the ones
//   the windows cover, once, with no instruction a tap. Each lane then copies
//   its 10 taps of the row to a table tab[tap][query] (the query is the
//   bank); lanes whose centres differ in y are at different tap rows of their
//   own windows meanwhile. What this cannot avoid is the layout's grain: the
//   taps of one window lie N elements apart, so every sector comes from
//   another DRAM page, and at level 0 of a smooth flow field a sector serves
//   16 windows that are one column apart each, so about a third of it is taps.
//   Fetching a whole 64-byte segment a position took as long as fetching
//   the needed pieces only, and neither more copies in flight nor more warps
//   an SM changed the time: the count of scattered accesses, not their
//   bytes, sets it.
// * K4 then blends each thread's own table column exactly as a per-query
//   kernel would, every lane at the same window entry, so each store is 32
//   consecutive floats. The arithmetic uses __fmul_rn / __fadd_rn (no FMA
//   contraction), so it rounds exactly as the plain PyTorch version's
//   separate multiplies and adds do. The bound is the bytes: the in-level taps
//   once and the f32 outputs. (Blending while walking, without the table, was
//   tried: lanes at different window rows store to different rows of the
//   output, and those stores cost more than the table.)
// * K5: dcorr[b, y, x, n] receives only from query n, so a block owns 64
//   neighbouring queries and writes every element of its slab of dcorr
//   once, coalesced over n: no zero fill before it, no atomics, no partial
//   sectors. Per level (a loop in the block, so that dcoords sums in level
//   order in registers and the result does not depend on scheduling): the
//   taps are gathered as in K4; each thread computes its query's dcx, dcy and
//   the 10 x 10 tap cotangents wy gx[i-1][j] + (1-wy) gx[i][j], which
//   overwrite the taps in the table, already rounded to the volume's dtype;
//   then the block sweeps its slab. Rows that no window of the block touches
//   are zeros written 16 bytes a thread with no arithmetic; on the others a
//   lane takes two neighbouring queries, looks each up in the table where the
//   position lies in its window, and stores the pair (a full 128-byte line a
//   warp in bf16). The bound is the dense write of dcorr.
// Positions are tested in float before any int conversion, so NaN or huge
// centres read nothing and give what the plain version gives.
// On an NVIDIA H100 80GB HBM3 at 700 W, B = 24, N = 5,120, 4 levels, bf16
// (chip_smoke.py kernels): K4 0.16 ms a call at the centres of a smooth flow
// field and 0.23 ms at centres scattered by 4 px of noise a query (bound
// 0.069 ms, grid_sample 0.33 ms); K5 0.90 and 1.02 ms (bound 0.57 ms;
// zeroing dcorr's bytes alone takes 0.51 ms; grid_sample's backward 1.93
// ms). K5's gather, cotangents and slab sweep do not hide each other: all
// three wait for the same memory.
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
constexpr int QB = 64;         // queries (= threads) a block
constexpr int WARPS = QB / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int FAR = 1 << 29;   // a window origin that no position matches
constexpr int CW = 48;         // columns a staged chunk of a volume row
constexpr int NBUF = 2;        // staged chunks a warp: one in use, the rest in flight
// a block's shared memory: the table, then every warp's staging (25 KB in
// bf16, 50 KB in f32)
constexpr size_t SHARED_ELEMS = (size_t)TAPS * QB + (size_t)WARPS * NBUF * CW * 32;

// level l is (H0 >> l, W0 >> l), read at coords * s_0 2^-l
struct Levels {
  const void* corr[MAX_LEVELS];
  void* dcorr[MAX_LEVELS];     // K5 only
  int H0, W0;
};

// (chains of selects: indexing the parameter by l would copy it to the stack)
template <typename T>
__device__ __forceinline__ const T* corr_ptr(const Levels& lv, int l) {
  return static_cast<const T*>(l == 0   ? lv.corr[0]
                               : l == 1 ? lv.corr[1]
                               : l == 2 ? lv.corr[2]
                                        : lv.corr[3]);
}
template <typename T>
__device__ __forceinline__ T* dcorr_ptr(const Levels& lv, int l) {
  return static_cast<T*>(l == 0   ? lv.dcorr[0]
                         : l == 1 ? lv.dcorr[1]
                         : l == 2 ? lv.dcorr[2]
                                  : lv.dcorr[3]);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, __nv_bfloat16 a,
                                           __nv_bfloat16 b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(a, b);
}

// a*b + c*d with both products and the sum rounded separately
__device__ __forceinline__ float lin2(float a, float b, float c, float d) {
  return __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, d));
}

struct Window {
  float wx, wy, x0, y0;
  int xb, yb;               // level column and row of tap (0, 0); -FAR: none
  int xlo, xhi, ylo, yhi;   // the in-level part, inclusive; lo > hi: none
};

// the window of query q (coords (B N, 2)) at a level Hl x Wl; ``valid``
// false: a thread past the last query. A window that misses the level, or a
// centre that is NaN or huge, has no in-level part.
__device__ __forceinline__ Window window(const float* __restrict__ coords,
                                         size_t q, bool valid, float inv_scale,
                                         int Hl, int Wl) {
  Window w;
  float cx = 0.f, cy = 0.f;
  if (valid) {
    cx = coords[2 * q] * inv_scale;
    cy = coords[2 * q + 1] * inv_scale;
  }
  w.x0 = floorf(cx);
  w.y0 = floorf(cy);
  w.wx = cx - w.x0;
  w.wy = cy - w.y0;
  const bool hit = valid && w.x0 - R <= (float)(Wl - 1) && w.x0 + (R + 1) >= 0.f &&
                   w.y0 - R <= (float)(Hl - 1) && w.y0 + (R + 1) >= 0.f;
  w.xb = hit ? (int)w.x0 - R : -FAR;
  w.yb = hit ? (int)w.y0 - R : -FAR;
  w.xlo = hit ? max(w.xb, 0) : FAR;
  w.ylo = hit ? max(w.yb, 0) : FAR;
  w.xhi = hit ? min(w.xb + P - 1, Wl - 1) : -1;
  w.yhi = hit ? min(w.yb + P - 1, Hl - 1) : -1;
  return w;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// A warp's 32 windows' taps into the table, tab[tap][query], this thread's
// column at tcol (tap t at tcol[t * QB]): all 100 of a query's taps, zero
// where they lie outside the level. The warp walks the volume rows that its
// windows touch, top to bottom, and each row in chunks of CW columns of the
// in-level columns X0..X1 that any of the windows needs. A chunk is staged in
// shared memory, stage[position][query], and each lane then copies those of
// its own 10 taps of the row that lie in it; lane k is at its tap row
// y - yb_k, so the lanes run one row apart where their centres differ.
// VEC > 1: the staging loads are asynchronous 16-byte copies of VEC
// consecutive queries (N a multiple of VEC, the volume 16-byte aligned),
// 32 / VEC lanes a position, and a piece is fetched only where one of its VEC
// queries has the position in its window, so a position costs the sectors its
// windows cover and no instruction a tap. VEC = 1: a lane loads its own
// query's elements. NBUF - 1 chunks are in flight while one is copied.
// ``stage``: NBUF * CW * 32 elements of this warp's; ``slab``:
// corr_l[b, 0, 0, n0] of the warp's first query; nq of its queries exist.
template <typename T, int VEC>
__device__ __forceinline__ void gather_taps(T* stage, const T* __restrict__ slab,
                                            int N, int Hl, int Wl,
                                            const Window& w, bool valid, int nq,
                                            unsigned colok, T* tcol) {
  const int lane = threadIdx.x & 31;
  const bool hit = w.xlo <= w.xhi;
  const int X0 = __reduce_min_sync(FULL, w.xlo);
  const int X1 = __reduce_max_sync(FULL, w.xhi);
  int ya = __reduce_min_sync(FULL, hit ? w.yb : FAR);
  int yz = __reduce_max_sync(FULL, hit ? w.yb : -FAR);
  if (X1 < X0) ya = yz = 0;   // no window of the warp touches the level
  const int yb = hit ? w.yb : ya;   // a lane with nothing to read walks along
  const int cnt = X1 - X0 + 1, last = yz + P - 1;
  const int nch = max(1, (cnt + CW - 1) / CW);   // chunks a row
  const int steps = (last - ya + 1) * nch;
  int fy = ya, fc = 0, fk = 0;   // the fetches run ahead: their row, chunk, buffer
  auto fetch = [&]() {
    if (fy <= last && cnt > 0 && fy >= 0 && fy < Hl) {   // (uniform over the warp)
      const bool rowin = fy >= w.ylo && fy <= w.yhi;
      int lo = rowin ? w.xlo : FAR, hi = rowin ? w.xhi : -1;
      const int c0 = X0 + fc * CW;   // the chunk's first column
      T* buf = stage + fk * CW * 32;
      const T* row = slab + (size_t)fy * Wl * N;
      if (VEC > 1) {
        constexpr int LP = 32 / VEC;   // lanes (pieces) a position
        constexpr int PS = 32 / LP;    // positions a warp-wide copy
#pragma unroll
        for (int d = 1; d < VEC; d *= 2) {   // over the VEC queries of a piece
          lo = min(lo, __shfl_xor_sync(FULL, lo, d));
          hi = max(hi, __shfl_xor_sync(FULL, hi, d));
        }
        const int piece = (lane % LP) * VEC;
        lo = max(__shfl_sync(FULL, lo, piece), c0);
        hi = min(__shfl_sync(FULL, hi, piece), c0 + CW - 1);
        if (piece < nq)   // lane / LP picks every PS-th position from the first
          for (int x = lo + (lane / LP - (lo - c0) % PS + PS) % PS; x <= hi; x += PS)
            cp_async16(buf + (x - c0) * 32 + piece, row + (size_t)x * N + piece);
      } else if (lane < nq) {
        for (int x = max(lo, c0); x <= min(hi, c0 + CW - 1); ++x)
          buf[(x - c0) * 32 + lane] = __ldg(row + (size_t)x * N + lane);
      }
    }
    cp_async_commit();
    fk = fk + 1 == NBUF ? 0 : fk + 1;
    if (++fc == nch) {
      fc = 0;
      ++fy;
    }
  };
#pragma unroll
  for (int k = 0; k < NBUF - 1; ++k) fetch();
  const T zero = from_f32<T>(0.f);
  for (int s = 0, y = ya, c = 0, k = 0; s < steps; ++s) {
    fetch();
    cp_async_wait<NBUF - 1>();
    __syncwarp();
    const int i = y - yb;
    if (valid && (unsigned)i < (unsigned)P) {
      const bool ok = hit && y >= 0 && y < Hl;
      const int q = (hit ? w.xb - X0 : 0) - c * CW;   // tap 0's place in the chunk
      const T* src = stage + (k * CW + q) * 32 + lane;
      T* dst = tcol + i * P * QB;
#pragma unroll
      for (int j = 0; j < P; ++j) {
        if (ok && (colok >> j & 1u)) {
          if ((unsigned)(q + j) < (unsigned)CW) dst[j * QB] = src[j * 32];
        } else if (c == 0) {
          dst[j * QB] = zero;
        }
      }
    }
    __syncwarp();
    k = k + 1 == NBUF ? 0 : k + 1;
    if (++c == nch) {
      c = 0;
      ++y;
    }
  }
}

// which tap columns lie in the level, tested in float: bit j
__device__ __forceinline__ unsigned columns_in_level(const Window& w, int Wl) {
  unsigned m = 0u;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float xx = w.x0 - R + j;
    m |= (xx >= 0.f && xx < (float)Wl) ? 1u << j : 0u;
  }
  return m;
}

__device__ __forceinline__ bool row_in_level(const Window& w, int Hl, int i) {
  const float yy = w.y0 - R + i;
  return yy >= 0.f && yy < (float)Hl;
}

// K4: grid (ceil(N / QB), B, L); out (B, L*81, N) f32; dynamic shared memory:
// SHARED_ELEMS elements, the table, then every warp's staging
template <typename T, int VEC>
__global__ void __launch_bounds__(QB, 8)
lanewise_fwd_kernel(Levels lv, const float* __restrict__ coords,
                    float* __restrict__ out, int N, int L, float inv_scale0) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  T* tab = reinterpret_cast<T*>(shared_raw);
  const int l = blockIdx.z, b = blockIdx.y;
  const int Hl = lv.H0 >> l, Wl = lv.W0 >> l;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * QB + warp * 32;
  const int n = blockIdx.x * QB + threadIdx.x;
  const bool valid = n < N;
  const Window w = window(coords, (size_t)b * N + n, valid,
                          inv_scale0 / (float)(1 << l), Hl, Wl);
  const unsigned colok = columns_in_level(w, Wl);
  T* tcol = tab + threadIdx.x;
  gather_taps<T, VEC>(
      tab + TAPS * QB + warp * NBUF * CW * 32,
      corr_ptr<T>(lv, l) + (size_t)b * Hl * Wl * N + n0, N, Hl, Wl, w, valid,
      min(32, N - n0), colok, tcol);
  if (!valid) return;
  // from here on a thread reads only the column it wrote itself, and the
  // lanes of a warp are at the same window row: their stores coalesce
  float wc0[P], wc1[P];  // column weights: 1-wx at the left tap, wx at the right
#pragma unroll
  for (int j = 0; j < P; ++j) {
    wc0[j] = (colok >> j & 1u) ? 1.f - w.wx : 0.f;
    wc1[j] = (colok >> j & 1u) ? w.wx : 0.f;
  }
  float* o = out + ((size_t)(b * L + l) * E) * N + n;
  float prev[P], cur[P];
#pragma unroll
  for (int j = 0; j < P; ++j) prev[j] = to_f32(tcol[j * QB]);
  bool prev_ok = row_in_level(w, Hl, 0);
#pragma unroll
  for (int i = 1; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) cur[j] = to_f32(tcol[(i * P + j) * QB]);
    const bool ok = row_in_level(w, Hl, i);
    const float w0 = prev_ok ? 1.f - w.wy : 0.f;
    const float w1 = ok ? w.wy : 0.f;
    float A[P];
#pragma unroll
    for (int j = 0; j < P; ++j) A[j] = lin2(w0, prev[j], w1, cur[j]);
#pragma unroll
    for (int j = 0; j < D; ++j)
      o[(size_t)((i - 1) * D + j) * N] = lin2(wc0[j], A[j], wc1[j + 1], A[j + 1]);
#pragma unroll
    for (int j = 0; j < P; ++j) prev[j] = cur[j];
    prev_ok = ok;
  }
}

// One query's cotangents at one level from its taps T in the table column
// tcol, a tap column j at a time (the columns are independent, so few values
// are live), every lane of a warp at the same entry, so that the loads of g
// coalesce. With g the query's output cotangent (entry e at g_q[e * N], zero
// outside the window), gx[dy] = wx g[dy][j-1] + (1-wx) g[dy][j] and
// gxp[dy] = g[dy][j-1] - g[dy][j]: every in-level tap (i, j) is overwritten
// by its cotangent wy gx[i-1] + (1-wy) gx[i], rounded to T; dcy sums
// (T[i] - T[i-1]) gx[i-1] and dcx sums A[i-1] gxp[i-1] over the in-level
// columns, A the row blend of the forward; [dcx, dcy] * inv_scale is added
// to (sum_x, sum_y). The order of the sums is fixed.
template <typename T>
__device__ __forceinline__ void cotangents(T* tcol, const float* __restrict__ g_q,
                                           int N, const Window& w, int Hl,
                                           unsigned colok, float inv_scale,
                                           float& sum_x, float& sum_y) {
  unsigned rowok = 0u;
#pragma unroll
  for (int i = 0; i < P; ++i) rowok |= row_in_level(w, Hl, i) ? 1u << i : 0u;
  float dcx = 0.f, dcy = 0.f;
  float lo[D], hi[D], next[D];   // g[.][j-1], g[.][j], g[.][j+1]
#pragma unroll
  for (int dy = 0; dy < D; ++dy) {
    lo[dy] = 0.f;
    hi[dy] = __ldg(g_q + (size_t)(dy * D) * N);
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
#pragma unroll
    for (int dy = 0; dy < D; ++dy)
      next[dy] = j + 1 < D ? __ldg(g_q + (size_t)(dy * D + j + 1) * N) : 0.f;
    if (colok >> j & 1u) {
      float t_prev = 0.f, gx_prev = 0.f, gxp_prev = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const bool ok = rowok >> i & 1u;
        const float t_cur = to_f32(tcol[(i * P + j) * QB]);
        const float gx_cur = i < D ? lin2(w.wx, lo[i], 1.f - w.wx, hi[i]) : 0.f;
        const float gxp_cur = i < D ? __fsub_rn(lo[i], hi[i]) : 0.f;
        if (ok)
          tcol[(i * P + j) * QB] =
              from_f32<T>(lin2(w.wy, gx_prev, 1.f - w.wy, gx_cur));
        if (i >= 1) {
          const float w0 = (rowok >> (i - 1) & 1u) ? 1.f - w.wy : 0.f;
          const float w1 = ok ? w.wy : 0.f;
          dcy = fmaf(__fsub_rn(t_cur, t_prev), gx_prev, dcy);
          dcx = fmaf(lin2(w0, t_prev, w1, t_cur), gxp_prev, dcx);
        }
        t_prev = t_cur;
        gx_prev = gx_cur;
        gxp_prev = gxp_cur;
      }
    }
#pragma unroll
    for (int dy = 0; dy < D; ++dy) {
      lo[dy] = hi[dy];
      hi[dy] = next[dy];
    }
  }
  sum_x += dcx * inv_scale;
  sum_y += dcy * inv_scale;
}

// The block's slab of dcorr_l, every element once: ``slab`` = dcorr_l[b, 0,
// 0, n0], nq queries wide. Rows outside [Z0, Z1) hold no tap of the block:
// with ``vec16`` they are written as 16-byte zeros (a thread keeps its
// 16-byte piece of the 64 queries and walks the positions), else like the
// others. On a row of [Z0, Z1) warp w takes positions w, w + WARPS, ... and
// a lane two queries (neighbours stored as one pair with PAIR, else lane and
// lane + 32): tab[tap][query] where the position lies in the query's window
// (origin xb, yb), else zero.
template <typename T, bool PAIR>
__device__ __forceinline__ void write_slab(T* __restrict__ slab, const T* tab,
                                           const int* xb, const int* yb, int Z0,
                                           int Z1, int N, int nq, int Hl, int Wl,
                                           bool vec16) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (vec16) {
    constexpr int EG = 16 / (int)sizeof(T);   // elements a 16-byte piece
    constexpr int GP = QB / EG;               // pieces a position
    const int piece = threadIdx.x % GP;
    if (piece * EG < nq) {
      T* p0 = slab + piece * EG;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      for (int p = threadIdx.x / GP; p < Z0 * Wl; p += QB / GP)
        *reinterpret_cast<uint4*>(p0 + (size_t)p * N) = zero;
      for (int p = Z1 * Wl + threadIdx.x / GP; p < Hl * Wl; p += QB / GP)
        *reinterpret_cast<uint4*>(p0 + (size_t)p * N) = zero;
    }
  } else {
    Z0 = 0;
    Z1 = Hl;
  }
  const int q0 = PAIR ? 2 * lane : lane;
  const int q1 = PAIR ? 2 * lane + 1 : lane + 32;
  const int xb0 = xb[q0], yb0 = yb[q0], xb1 = xb[q1], yb1 = yb[q1];
  const bool v0 = q0 < nq, v1 = q1 < nq;
  const T zero = from_f32<T>(0.f);
  for (int y = Z0; y < Z1; ++y) {
    const bool r0 = (unsigned)(y - yb0) < (unsigned)P;
    const bool r1 = (unsigned)(y - yb1) < (unsigned)P;
    const T* t0 = tab + q0 + (r0 ? ((y - yb0) * P - xb0) * QB : 0);
    const T* t1 = tab + q1 + (r1 ? ((y - yb1) * P - xb1) * QB : 0);
    T* row = slab + (size_t)y * Wl * N;
    for (int x = warp; x < Wl; x += WARPS) {
      const bool in0 = r0 && (unsigned)(x - xb0) < (unsigned)P;
      const bool in1 = r1 && (unsigned)(x - xb1) < (unsigned)P;
      const T a = in0 ? t0[x * QB] : zero;
      const T c = in1 ? t1[x * QB] : zero;
      T* dst = row + (size_t)x * N;
      if (PAIR) {
        if (v0) store_pair(dst + q0, a, c);
      } else {
        if (v0) dst[q0] = a;
        if (v1) dst[q1] = c;
      }
    }
  }
}

// K5: grid (ceil(N / QB), B); g (B, L*81, N) f32; dcorr_l (B, Hl, Wl, N),
// every element written; dcoords (B, N, 2) f32; dynamic shared memory as K4
template <typename T, bool PAIR, int VEC>
__global__ void __launch_bounds__(QB, 8)
lanewise_bwd_kernel(Levels lv, const float* __restrict__ coords,
                    const float* __restrict__ g, float* __restrict__ dcoords,
                    int N, int L, float inv_scale0, int vec16) {
  extern __shared__ __align__(16) unsigned char shared_raw[];
  __shared__ int s_xb[QB], s_yb[QB], s_y0[WARPS], s_y1[WARPS];
  T* tab = reinterpret_cast<T*>(shared_raw);
  const int b = blockIdx.y, n0 = blockIdx.x * QB;
  const int t = threadIdx.x, warp = t >> 5, n = n0 + t;
  const bool valid = n < N;
  const size_t q = (size_t)b * N + n;
  T* stage = tab + TAPS * QB + warp * NBUF * CW * 32;
  T* tcol = tab + t;
  float dcx = 0.f, dcy = 0.f;
  for (int l = 0; l < L; ++l) {
    const int Hl = lv.H0 >> l, Wl = lv.W0 >> l;
    const float inv_scale = inv_scale0 / (float)(1 << l);
    __syncthreads();   // the level before has been written out of the table
    const Window w = window(coords, q, valid, inv_scale, Hl, Wl);
    s_xb[t] = w.xb;
    s_yb[t] = w.yb;
    const int Y0 = __reduce_min_sync(FULL, w.ylo);
    const int Y1 = __reduce_max_sync(FULL, w.yhi);
    if ((t & 31) == 0) {
      s_y0[warp] = Y0;
      s_y1[warp] = Y1;
    }
    const unsigned colok = columns_in_level(w, Wl);
    gather_taps<T, VEC>(
        stage, corr_ptr<T>(lv, l) + (size_t)b * Hl * Wl * N + n0 + warp * 32,
        N, Hl, Wl, w, valid, min(32, N - n0 - warp * 32), colok, tcol);
    if (valid)
      cotangents(tcol, g + ((size_t)(b * L + l) * E) * N + n, N, w, Hl, colok,
                 inv_scale, dcx, dcy);
    __syncthreads();
    int Z0 = s_y0[0], Z1 = s_y1[0];
#pragma unroll
    for (int k = 1; k < WARPS; ++k) {
      Z0 = min(Z0, s_y0[k]);
      Z1 = max(Z1, s_y1[k]);
    }
    if (Z0 > Z1) {     // no window of the block touches the level
      Z0 = Hl;
      Z1 = Hl;
    } else {
      Z1 += 1;
    }
    write_slab<T, PAIR>(dcorr_ptr<T>(lv, l) + (size_t)b * Hl * Wl * N + n0, tab,
                        s_xb, s_yb, Z0, Z1, N, min(QB, N - n0), Hl, Wl,
                        vec16 != 0);
  }
  if (valid) {
    dcoords[2 * q] = dcx;
    dcoords[2 * q + 1] = dcy;
  }
}

bool sizes_ok(int B, int N, int H0, int W0, int L, int radius) {
  // queries and one level's positions are counted in int
  return radius == R && B > 0 && N > 0 && L >= 1 && L <= MAX_LEVELS && H0 >= 0 &&
         W0 >= 0 && B <= 65535 && (int64_t)N + QB <= 0x7fffffffLL &&
         (int64_t)H0 * W0 <= 0x7fffffffLL;
}

// all of these pointers and a row of N elements of T are 16-byte aligned
template <typename T>
bool aligned16(void* const* ptrs, int L, int N) {
  uintptr_t low = 0;
  for (int l = 0; l < L; ++l) low |= reinterpret_cast<uintptr_t>(ptrs[l]);
  return low % 16 == 0 && (N * sizeof(T)) % 16 == 0;
}

// a kernel's dynamic shared memory: above 48 KB it has to be asked for
template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  if (bytes > 227 * 1024) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int VEC>
int launch_fwd(const Levels& lv, const void* coords, void* out, int B, int N,
               int L, float inv_scale0, cudaStream_t s) {
  const size_t shared = SHARED_ELEMS * sizeof(T);
  const cudaError_t e = allow_shared(lanewise_fwd_kernel<T, VEC>, shared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((N + QB - 1) / QB), (unsigned)B, (unsigned)L);
  lanewise_fwd_kernel<T, VEC><<<grid, QB, shared, s>>>(
      lv, static_cast<const float*>(coords), static_cast<float*>(out), N, L,
      inv_scale0);
  return (int)cudaGetLastError();
}

template <typename T, bool PAIR, int VEC>
int launch_bwd(const Levels& lv, const void* coords, const void* g,
               void* dcoords, int B, int N, int L, float inv_scale0, int vec16,
               cudaStream_t s) {
  const size_t shared = SHARED_ELEMS * sizeof(T);
  const cudaError_t e = allow_shared(lanewise_bwd_kernel<T, PAIR, VEC>, shared);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((N + QB - 1) / QB), (unsigned)B);
  lanewise_bwd_kernel<T, PAIR, VEC><<<grid, QB, shared, s>>>(
      lv, static_cast<const float*>(coords), static_cast<const float*>(g),
      static_cast<float*>(dcoords), N, L, inv_scale0, vec16);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(const Levels& lv, const void* coords, void* out, int B, int N,
                 int L, float inv_scale0, cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
  return aligned16<T>(const_cast<void* const*>(lv.corr), L, N)
             ? launch_fwd<T, V>(lv, coords, out, B, N, L, inv_scale0, s)
             : launch_fwd<T, 1>(lv, coords, out, B, N, L, inv_scale0, s);
}

template <typename T>
int dispatch_bwd(const Levels& lv, const void* coords, const void* g,
                 void* dcoords, int B, int N, int L, float inv_scale0,
                 cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
  // the staged loads need the volumes aligned; the stored pairs every dcorr
  // element pair, the 16-byte zeros every piece of a dcorr row
  const bool in16 = aligned16<T>(const_cast<void* const*>(lv.corr), L, N);
  const bool out16 = aligned16<T>(lv.dcorr, L, N);
  uintptr_t low = 0;
  for (int l = 0; l < L; ++l) low |= reinterpret_cast<uintptr_t>(lv.dcorr[l]);
  const bool pair = N % 2 == 0 && low % (2 * sizeof(T)) == 0;
  if (pair)
    return in16 ? launch_bwd<T, true, V>(lv, coords, g, dcoords, B, N, L,
                                         inv_scale0, out16, s)
                : launch_bwd<T, true, 1>(lv, coords, g, dcoords, B, N, L,
                                         inv_scale0, out16, s);
  return in16 ? launch_bwd<T, false, V>(lv, coords, g, dcoords, B, N, L,
                                        inv_scale0, 0, s)
              : launch_bwd<T, false, 1>(lv, coords, g, dcoords, B, N, L,
                                        inv_scale0, 0, s);
}

}  // namespace

// One launch for the L <= 4 levels of a pyramid, radius 4 (RAFT large).
// Level l: corr_l (B, H0 >> l, W0 >> l, N) contiguous, dtype 0 = float32,
// 1 = bfloat16 (levels past L are not read); coords (B, N, 2) f32, multiplied
// by inv_scale0 2^-l; out (B, L*81, N) f32. Returns the CUDA error.
extern "C" int lanewise_fwd(const void* c0, const void* c1, const void* c2,
                            const void* c3, const void* coords, void* out,
                            int B, int N, int H0, int W0, int L, int radius,
                            float inv_scale0, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!sizes_ok(B, N, H0, W0, L, radius)) return (int)cudaErrorInvalidValue;
  const Levels lv = {{c0, c1, c2, c3}, {nullptr, nullptr, nullptr, nullptr}, H0, W0};
  return dtype == 1
             ? dispatch_fwd<__nv_bfloat16>(lv, coords, out, B, N, L, inv_scale0, s)
             : dispatch_fwd<float>(lv, coords, out, B, N, L, inv_scale0, s);
}

// g (B, L*81, N) f32; dcorr_l (d0..d3) shaped and typed as corr_l, every
// element written; dcoords (B, N, 2) f32, the levels summed in order.
extern "C" int lanewise_bwd(const void* c0, const void* c1, const void* c2,
                            const void* c3, const void* coords, const void* g,
                            void* d0, void* d1, void* d2, void* d3,
                            void* dcoords, int B, int N, int H0, int W0, int L,
                            int radius, float inv_scale0, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!sizes_ok(B, N, H0, W0, L, radius)) return (int)cudaErrorInvalidValue;
  const Levels lv = {{c0, c1, c2, c3}, {d0, d1, d2, d3}, H0, W0};
  return dtype == 1
             ? dispatch_bwd<__nv_bfloat16>(lv, coords, g, dcoords, B, N, L, inv_scale0, s)
             : dispatch_bwd<float>(lv, coords, g, dcoords, B, N, L, inv_scale0, s);
}
