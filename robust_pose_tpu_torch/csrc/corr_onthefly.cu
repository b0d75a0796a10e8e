// RAFT correlation window lookup computed on the fly (K1): one launch for
// every level of a pyramid, no correlation volume in memory.
//
// Replaces: robust_pose_tpu/ops/pallas_corr_onthefly.py::_onthefly_kernel
// (reached through _lookup_level / onthefly_lookup, one pallas_call a level).
//
// What it computes, per (batch b, level l, query n): the sample centre
// c = coords[b, n] / (s0 2^l), and for the D x D window offsets (dy, dx),
// D = 2R + 1, the bilinear sample, with zero padding, of
//     corr(y, x) = <f2_l[b, y, x, :], f1[b, n, :]> / sqrt(C)
// at (c.y - R + dy, c.x - R + dx). The radius R is a template parameter:
// 4 for RAFT's large variant (9 x 9 outputs from 10 x 10 taps), 3 for its
// small one (7 x 7 from 8 x 8, on 128-channel features). Level l is
// (H0 >> l, W0 >> l), its pointer picked by a chain of selects (an indexed
// by-value pointer array is copied to the stack). Output (B, L * D^2, N)
// f32, level l at rows D^2 l .. D^2 (l + 1) - 1, dy-major; the wrapper hands
// out the per-level views.
//
// bf16 (corr_window_mma, the full-width path). The Pallas kernel multiplies
// the whole level slab by a 128-query block on the MXU and then keeps the
// window; the first port did the opposite, a warp a query gathering its 100
// window rows with a dependent load and a shuffle reduction each: bound by
// that latency, 3.61-3.64 ms per 4-level lookup at B = 16, 60x its byte
// bound (NVIDIA H100 80GB HBM3, 700 W; PERF.md). This kernel takes the
// middle road. A block of 4 warps owns one (b, level) and an
// 8 x 8 tile of neighbouring queries (one row of 64 when the query grid is
// one row). Each warp keeps its 16 queries' f1 rows in registers as mma B
// fragments. The block takes the union rectangle of the tile's windows (only
// queries whose centre is finite and whose window meets the level; clipped
// to the level) and streams the rectangle's f2 rows in chunks of 16
// positions, double-buffered with cp.async, each row read once a tile. Each
// chunk is multiplied by the warps' queries on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 accumulate: a chunk is 16 x 64 x C, far too small
// for a warpgroup's wgmma, and ldmatrix feeds mma.sync straight from padded
// shared rows with no descriptor or swizzle). A product is kept, scaled by
// 1 / sqrt(C), only where its position lies in its own query's P x P
// window, written once into a [tap][query] table that starts at zero (zero
// padding off the level); then the bilinear blend, rows first as the plain
// version, and the (D^2, 64) output tile stored 8 neighbouring queries a
// 32-byte sector. No atomics: two calls give the same bits. Positions are
// tested in float before any int conversion: a NaN or huge centre adds
// nothing to the rectangle, and its NaN weights carry NaN into its outputs
// as in the plain version.
//
// What bounds it: not the tensor cores (the window-only products are 12.1
// GFLOP a lookup at B = 16, 12 us at the bf16 peak; a rectangle holds a
// few times a window's rows) and not device memory (the byte bound is 0.061
// ms), but moving every tile's rectangle and f1 rows from L2 to its SM at
// every level, and the latency of each block's phases, which only more
// resident blocks hide: 0.27-0.28 ms a lookup at B = 16 with a smooth flow,
// 0.43 with 4 px of noise a query. What was measured: 8 warps with the f1
// tile and 64-row chunks in 128 KB of shared memory (one block an SM) took
// 0.57; f1 in registers with 64-, 32-, 16-row chunks 0.42, 0.31, 0.27 (more
// resident blocks: 3, 4, 5 an SM); 3 or 4 chunks in flight, f1 staged
// through shared memory, or 128 queries a block were all slower (PERF.md,
// PR 6, with the constants below).
//
// f32 (corr_window_f32, the card-vs-CPU phases): exact f32 FMAs on the
// CUDA cores (TF32 would break those phases' tolerances), the first port's
// design: a warp a query, the query's f1 row in registers, one gathered f2
// row and a shuffle reduction a window pixel.
#include <climits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NO_WINDOW = -(1 << 28);   // window origin of a query that reads nothing

template <typename T>
__device__ __forceinline__ const T* level_ptr(int l, const T* p0, const T* p1,
                                              const T* p2, const T* p3) {
  return l == 0 ? p0 : l == 1 ? p1 : l == 2 ? p2 : p3;
}

// --- bf16: tensor-core products over each query tile's union rectangle ------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy into shared memory, zero-filled where src_bytes is 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (y, x) of rectangle position p = y rw + x: a float quotient, corrected
// to the exact one (its error is far below one row)
__device__ __forceinline__ void rect_yx(int p, int rw, float inv_rw, int& y,
                                        int& x) {
  y = (int)((p + 0.5f) * inv_rw);
  x = p - y * rw;
  if (x < 0) { --y; x += rw; }
  else if (x >= rw) { ++y; x -= rw; }
}

// Shared memory: a ring of NSTAGE f2 chunks as rows of C bf16 padded by
// 16 bytes (ldmatrix's 8 rows then fall in 8 different bank groups), the
// [tap][query] table of P x P taps (P = 2R + 2), per-query window data.
__host__ __device__ constexpr size_t mma_smem_bytes(int P, int C, int TQ,
                                                    int CH, int NSTAGE) {
  return (size_t)NSTAGE * CH * (C * 2 + 16) + sizeof(float) * P * P * TQ +
         sizeof(int) * 5 * TQ + sizeof(int) * 4 * (TQ / 32);
}

// Window radius R; TQ queries a block (a TH x TQ/TH tile of the query
// grid), TQ / 16 warps of 16 queries each
template <int R, int C, int TQ, int CH, int NSTAGE>
__global__ void __launch_bounds__(TQ * 2)
corr_window_mma(const __nv_bfloat16* __restrict__ f1,
                const __nv_bfloat16* __restrict__ p0,
                const __nv_bfloat16* __restrict__ p1,
                const __nv_bfloat16* __restrict__ p2,
                const __nv_bfloat16* __restrict__ p3,
                const float* __restrict__ coords, float* __restrict__ out,
                int N, int Wq, int Hq, int TH, int H0, int W0, int L,
                float inv_scale0, float inv_sqrt_c) {
  constexpr int D = 2 * R + 1;           // outputs a window row
  constexpr int P = D + 1;               // taps a window row
  constexpr int THREADS = TQ * 2;
  constexpr int RS = C * 2 + 16;         // padded row, bytes
  constexpr int KS = C / 16;             // k steps of 16 channels
  constexpr int MT = CH / 16;            // 16-position row tiles a chunk
  constexpr int PIECES = C / 8;          // 16-byte pieces a row
  constexpr int RPP = THREADS / PIECES;  // rows a pass of the chunk load
  static_assert(THREADS % PIECES == 0 && CH % RPP == 0 && CH % 16 == 0 &&
                NSTAGE >= 2 && TQ % 32 == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* f2s = smem;
  float* tab = reinterpret_cast<float*>(f2s + NSTAGE * CH * RS);  // [P*P][TQ]
  int* qoy = reinterpret_cast<int*>(tab + P * P * TQ);
  int* qox = qoy + TQ;
  int* qn = qox + TQ;                    // query index n, -1 off the grid
  float* qwx = reinterpret_cast<float*>(qn + TQ);
  float* qwy = qwx + TQ;
  int* red = reinterpret_cast<int*>(qwy + TQ);   // [TQ / 32 warps][4]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int TW = TQ / TH;
  const int tiles_x = (Wq + TW - 1) / TW;
  const int ty = blockIdx.x / tiles_x, tx = blockIdx.x % tiles_x;
  const int b = blockIdx.y, lvl = blockIdx.z;
  const int Hl = H0 >> lvl, Wl = W0 >> lvl;
  const float inv_scale = inv_scale0 / (float)(1 << lvl);   // exact
  const __nv_bfloat16* f2 =
      level_ptr(lvl, p0, p1, p2, p3) + (size_t)b * Hl * Wl * C;

  // 1. per-query window: origin, bilinear fractions, and its share of the
  //    rectangle (the first TQ / 32 warps hold the queries)
  if (tid < TQ) {
    const int gy = ty * TH + tid / TW, gx = tx * TW + tid % TW;
    const bool in = gy < Hq && gx < Wq;
    const int n = in ? gy * Wq + gx : -1;
    float cx = 0.f, cy = 0.f;
    if (in) {
      cx = coords[((size_t)b * N + n) * 2 + 0] * inv_scale;
      cy = coords[((size_t)b * N + n) * 2 + 1] * inv_scale;
    }
    const float x0 = floorf(cx), y0 = floorf(cy);
    qwx[tid] = cx - x0;
    qwy[tid] = cy - y0;
    qn[tid] = n;
    // isfinite is false for NaN: fminf/fmaxf would drop a NaN silently
    const bool meets = in && isfinite(cx) && isfinite(cy) &&
                       y0 - R <= (float)(Hl - 1) && y0 + (R + 1) >= 0.f &&
                       x0 - R <= (float)(Wl - 1) && x0 + (R + 1) >= 0.f;
    const int oy = meets ? (int)y0 - R : NO_WINDOW;
    const int ox = meets ? (int)x0 - R : NO_WINDOW;
    qoy[tid] = oy;
    qox[tid] = ox;
    int v[4] = {meets ? max(oy, 0) : INT_MAX,
                meets ? min(oy + P - 1, Hl - 1) : INT_MIN,
                meets ? max(ox, 0) : INT_MAX,
                meets ? min(ox + P - 1, Wl - 1) : INT_MIN};
    v[0] = __reduce_min_sync(0xffffffffu, v[0]);
    v[1] = __reduce_max_sync(0xffffffffu, v[1]);
    v[2] = __reduce_min_sync(0xffffffffu, v[2]);
    v[3] = __reduce_max_sync(0xffffffffu, v[3]);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < 4; ++k) red[warp * 4 + k] = v[k];
  }
  for (int i = tid; i < P * P * TQ / 4; i += THREADS)
    reinterpret_cast<float4*>(tab)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  int ry0 = red[0], ry1 = red[1], rx0 = red[2], rx1 = red[3];
#pragma unroll
  for (int w = 1; w < TQ / 32; ++w) {
    ry0 = min(ry0, red[4 * w]);
    ry1 = max(ry1, red[4 * w + 1]);
    rx0 = min(rx0, red[4 * w + 2]);
    rx1 = max(rx1, red[4 * w + 3]);
  }
  const int rw = rx1 - rx0 + 1;
  const float inv_rw = 1.f / (float)rw;
  const int npos = (ry1 >= ry0 && rx1 >= rx0) ? (ry1 - ry0 + 1) * rw : 0;
  const int nch = (npos + CH - 1) / CH;

  auto load_chunk = [&](int c, int stage) {
    unsigned char* dst = f2s + stage * CH * RS + (tid % PIECES) * 16;
    for (int r = tid / PIECES; r < CH; r += RPP) {
      const int p = c * CH + r;
      const __nv_bfloat16* src = f2;
      int bytes = 0;
      if (p < npos) {
        int y, x;
        rect_yx(p, rw, inv_rw, y, x);
        src = f2 + ((size_t)(ry0 + y) * Wl + rx0 + x) * C + (tid % PIECES) * 8;
        bytes = 16;
      }
      cp_async16(dst + r * RS, src, bytes);
    }
  };

  if (nch > 0) {
#pragma unroll
    for (int c = 0; c < NSTAGE - 1; ++c) {
      if (c < nch) load_chunk(c, c);
      cp_async_commit();
    }
    // 2. this warp's 16 queries as mma B fragments, straight from f1, in
    //    registers for every chunk (zeros off the query grid)
    const int g = lane >> 2, t4 = lane & 3;
    unsigned bfr[2][KS][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int n = qn[(warp * 2 + nt) * 8 + g];
      const unsigned* row = reinterpret_cast<const unsigned*>(
          f1 + ((size_t)b * N + max(n, 0)) * C);
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        bfr[nt][k][0] = n >= 0 ? __ldg(row + k * 8 + t4) : 0u;
        bfr[nt][k][1] = n >= 0 ? __ldg(row + k * 8 + 4 + t4) : 0u;
      }
    }
    // 3. a ring of NSTAGE chunks, NSTAGE - 1 in flight
    for (int c = 0; c < nch; ++c) {
      cp_async_wait<NSTAGE - 2>();
      __syncthreads();   // chunk c landed; chunk c - 1's stage is free
      if (c + NSTAGE - 1 < nch) load_chunk(c + NSTAGE - 1, (c + NSTAGE - 1) % NSTAGE);
      cp_async_commit();
      // chunk (CH x C) x the warp's queries^T (C x 16), tensor cores
      const unsigned char* a_base = f2s + (c % NSTAGE) * CH * RS +
                                    (lane & 15) * RS + (lane >> 4) * 16;
      float acc[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          unsigned a[4];
          ldmatrix_x4(a, a_base + m * 16 * RS + k * 32);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            if (k == 0)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
            mma_bf16(acc[m][nt], a, bfr[nt][k][0], bfr[nt][k][1]);
          }
        }
      // 4. keep each product that lies in its own query's window
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = c * CH + m * 16 + g + 8 * h;
          if (p < npos) {
            int y, x;
            rect_yx(p, rw, inv_rw, y, x);
            y += ry0;
            x += rx0;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int q = (warp * 2 + nt) * 8 + 2 * t4 + e;
                const int dy = y - qoy[q], dx = x - qox[q];
                if ((unsigned)dy < (unsigned)P && (unsigned)dx < (unsigned)P)
                  tab[(dy * P + dx) * TQ + q] = acc[m][nt][2 * h + e] * inv_sqrt_c;
              }
          }
        }
    }
    cp_async_wait<0>();
  }
  __syncthreads();

  // 5. bilinear blend, rows first: A = (1-wy) c[i] + wy c[i+1], then
  //    out = (1-wx) A[j] + wx A[j+1]; 8 neighbouring queries a 32-byte sector
  float* ob = out + ((size_t)b * L + lvl) * D * D * N;
  for (int i = tid; i < D * D * TQ; i += THREADS) {
    const int o = i / TQ, q = i % TQ;
    const int n = qn[q];
    if (n < 0) continue;
    const int di = o / D, dj = o % D;
    const float wx = qwx[q], wy = qwy[q];
    const float* tq = tab + q;
    const float a0 = (1.f - wy) * tq[(di * P + dj) * TQ] +
                     wy * tq[((di + 1) * P + dj) * TQ];
    const float a1 = (1.f - wy) * tq[(di * P + dj + 1) * TQ] +
                     wy * tq[((di + 1) * P + dj + 1) * TQ];
    ob[(size_t)o * N + n] = (1.f - wx) * a0 + wx * a1;
  }
}

template <int R, int C, int TQ, int CH, int NSTAGE>
int launch_mma(const void* f1, const void* p0, const void* p1, const void* p2,
               const void* p3, const void* coords, void* out, int B, int N,
               int Hq, int Wq, int TH, int H0, int W0, int L,
               float inv_scale0, float inv_sqrt_c, cudaStream_t s) {
  using bf = __nv_bfloat16;
  constexpr size_t smem = mma_smem_bytes(2 * R + 2, C, TQ, CH, NSTAGE);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        corr_window_mma<R, C, TQ, CH, NSTAGE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int tw = TQ / TH;
  dim3 grid(((Hq + TH - 1) / TH) * ((Wq + tw - 1) / tw), B, L);
  corr_window_mma<R, C, TQ, CH, NSTAGE><<<grid, TQ * 2, smem, s>>>(
      static_cast<const bf*>(f1), static_cast<const bf*>(p0),
      static_cast<const bf*>(p1), static_cast<const bf*>(p2),
      static_cast<const bf*>(p3), static_cast<const float*>(coords),
      static_cast<float*>(out), N, Wq, Hq, TH, H0, W0, L, inv_scale0,
      inv_sqrt_c);
  return (int)cudaGetLastError();
}

// --- f32: exact FMAs on the CUDA cores, a warp a query -----------------------

constexpr int WARPS = 8;
constexpr int MAX_CHUNKS = 4;  // 16-byte chunks of f1 a lane: C <= 512

__device__ __forceinline__ float dot_chunk(const float* q, const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return a.x * q[0] + a.y * q[1] + a.z * q[2] + a.w * q[3];
}

template <int R>
__global__ void __launch_bounds__(WARPS * 32)
corr_window_f32(const float* __restrict__ f1, const float* __restrict__ p0,
                const float* __restrict__ p1, const float* __restrict__ p2,
                const float* __restrict__ p3, const float* __restrict__ coords,
                float* __restrict__ out, int N, int C, int H0, int W0, int L,
                float inv_scale0, float inv_sqrt_c) {
  constexpr int D = 2 * R + 1, P = D + 1;
  constexpr int VEC = 4;
  __shared__ float win_all[WARPS * P * P];
  __shared__ float tile[D * D * WARPS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y, lvl = blockIdx.z;
  const int Hl = H0 >> lvl, Wl = W0 >> lvl;
  const float inv_scale = inv_scale0 / (float)(1 << lvl);
  const int n0 = blockIdx.x * WARPS;
  const int n = n0 + warp;
  float* win = win_all + warp * P * P;
  const int nchunks = C / (32 * VEC);
  if (n < N) {
    float q[MAX_CHUNKS][VEC];
    const float* f1p = f1 + ((size_t)b * N + n) * C;
#pragma unroll
    for (int j = 0; j < MAX_CHUNKS; ++j)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        q[j][e] = j < nchunks ? f1p[(j * 32 + lane) * VEC + e] : 0.f;
    const float cx = coords[((size_t)b * N + n) * 2 + 0] * inv_scale;
    const float cy = coords[((size_t)b * N + n) * 2 + 1] * inv_scale;
    const float x0 = floorf(cx), y0 = floorf(cy);
    const float wx = cx - x0, wy = cy - y0;
    const float* f2b =
        level_ptr(lvl, p0, p1, p2, p3) + (size_t)b * Hl * Wl * C;
    for (int k = 0; k < P * P; ++k) {
      const float yy = y0 - R + (k / P);
      const float xx = x0 - R + (k % P);
      float acc = 0.f;
      if (yy >= 0.f && yy < (float)Hl && xx >= 0.f && xx < (float)Wl) {
        const float* p = f2b + ((size_t)(int)yy * Wl + (int)xx) * C + lane * VEC;
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
    for (int o = lane; o < D * D; o += 32) {
      const int i = o / D, j = o % D;
      const float a0 = (1.f - wy) * win[i * P + j] + wy * win[(i + 1) * P + j];
      const float a1 =
          (1.f - wy) * win[i * P + j + 1] + wy * win[(i + 1) * P + j + 1];
      tile[o * WARPS + warp] = (1.f - wx) * a0 + wx * a1;
    }
  }
  __syncthreads();
  const int nq = min(WARPS, N - n0);
  float* ob = out + ((size_t)b * L + lvl) * D * D * N;
  for (int idx = threadIdx.x; idx < D * D * WARPS; idx += blockDim.x) {
    const int o = idx / WARPS, j = idx % WARPS;
    if (j < nq) ob[(size_t)o * N + n0 + j] = tile[idx];
  }
}

// the bf16 kernel's tile, chunk and ring depth (PERF.md, PR 6, has the
// variants measured)
constexpr int QUERIES = 64;    // queries a block
constexpr int CHUNK = 16;      // f2 positions a chunk
constexpr int STAGES = 2;      // chunks in the ring

template <int R>
int launch_f32(const void* f1, const void* p0, const void* p1, const void* p2,
               const void* p3, const void* coords, void* out, int B, int N,
               int C, int H0, int W0, int L, float inv_scale0,
               float inv_sqrt_c, cudaStream_t s) {
  dim3 grid((N + WARPS - 1) / WARPS, B, L);
  corr_window_f32<R><<<grid, WARPS * 32, 0, s>>>(
      static_cast<const float*>(f1), static_cast<const float*>(p0),
      static_cast<const float*>(p1), static_cast<const float*>(p2),
      static_cast<const float*>(p3), static_cast<const float*>(coords),
      static_cast<float*>(out), N, C, H0, W0, L, inv_scale0, inv_sqrt_c);
  return (int)cudaGetLastError();
}

template <int R>
int launch(const void* f1, const void* p0, const void* p1, const void* p2,
           const void* p3, const void* coords, void* out, int B, int N, int C,
           int Hq, int Wq, int TH, int H0, int W0, int L, float inv_scale0,
           float inv_sqrt_c, int dtype, cudaStream_t s) {
  if (dtype != 1)
    return launch_f32<R>(f1, p0, p1, p2, p3, coords, out, B, N, C, H0, W0, L,
                         inv_scale0, inv_sqrt_c, s);
  if (C == 256)
    return launch_mma<R, 256, QUERIES, CHUNK, STAGES>(
        f1, p0, p1, p2, p3, coords, out, B, N, Hq, Wq, TH, H0, W0, L,
        inv_scale0, inv_sqrt_c, s);
  if (C == 128)
    return launch_mma<R, 128, QUERIES, CHUNK, STAGES>(
        f1, p0, p1, p2, p3, coords, out, B, N, Hq, Wq, TH, H0, W0, L,
        inv_scale0, inv_sqrt_c, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// One lookup over L (1 to 4) levels, one launch, window radius 3 (RAFT
// small: 7 x 7 outputs, 8 x 8 taps) or 4 (RAFT large: 9 x 9, 10 x 10).
// dtype: 0 = float32, 1 = bfloat16. f1 (B, N, C); level l
// (B, H0 >> l, W0 >> l, C) at p_l; coords (B, N, 2) f32, centres in units of
// level 0 times s0 (inv_scale0 = 1 / s0, s0 a power of two for exact
// scaling); out (B, L * (2r+1)^2, N) f32. The queries form an Hq x Wq grid
// (N = Hq Wq) that bf16 tiles TH x QUERIES/TH.
// All contiguous and 16-byte aligned; C 128 or 256 for bf16, a multiple of
// 128 and at most 512 for f32 (the Python wrapper checks). Returns
// cudaGetLastError() after the launch.
extern "C" int corr_window_pyramid(const void* f1, const void* p0,
                                   const void* p1, const void* p2,
                                   const void* p3, const void* coords,
                                   void* out, int B, int N, int C, int Hq,
                                   int Wq, int TH, int H0, int W0, int L,
                                   int radius, float inv_scale0,
                                   float inv_sqrt_c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (radius == 4)
    return launch<4>(f1, p0, p1, p2, p3, coords, out, B, N, C, Hq, Wq, TH, H0,
                     W0, L, inv_scale0, inv_sqrt_c, dtype, s);
  if (radius == 3)
    return launch<3>(f1, p0, p1, p2, p3, coords, out, B, N, C, Hq, Wq, TH, H0,
                     W0, L, inv_scale0, inv_sqrt_c, dtype, s);
  return (int)cudaErrorInvalidValue;
}
