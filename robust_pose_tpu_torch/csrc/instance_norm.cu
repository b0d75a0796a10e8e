// Instance norm over a contiguous NHWC map: K2's statistics, and the whole
// norm (statistics, normalize and an optional ReLU) in one C call.
//
// Replaces: robust_pose_tpu/ops/pallas_instance_norm.py::_stats_kernel (K2,
// reached through instance_norm_stats), the per-(sample, channel) sum and sum
// of squares over H x W in f32, for C <= 128. The JAX package leaves the
// normalize to XLA, where it fuses with the ReLU after it; here nothing fuses
// it, so instance_norm_fwd takes the normalize and the ReLU into the kernel's
// second pass.
//
// What both entries compute, per sample b and channel c of x (B, HW, C), f32,
// bf16 or f16: s = sum_p x[b, p, c], ss = sum_p x[b, p, c]^2, f32 results.
// The norm: mu = s / n, var = max(ss / n - mu^2, 0), rstd = rsqrt(var + eps)
// and y = [relu]((x - mu) rstd) in f32, cast to x's dtype (the JAX package's
// formula, pallas_instance_norm.py:95-111).
//
// Rounding. The sums are taken in f64 over the plain version's f32 terms (x,
// and x * x rounded to f32) and rounded to f32 once, so they are the
// correctly rounded sums, which an f32 sum in any order only approaches.
// From them on every op is the plain version's, one f32 rounding each
// (__fdiv_rn, __fmul_rn, __fsub_rn: no FMA contraction; rsqrt as 1 / sqrt,
// as PyTorch's CPU rsqrt computes it). So the card's norm equals the CPU's
// plain version bit for bit wherever the CPU's f32 sums are the correctly
// rounded ones, and the paths that compare the card with the CPU see no more
// than that difference.
//
// What bounds them on an H100: bytes. A norm does ~5 operations an element
// (two of them f64 adds) against 4 bytes moved (bf16: one read, one write),
// far below the card's ~10 f64 or ~20 f32 operations a byte. This design
// moves 6 bytes an element in bf16: x is read twice (statistics, then apply)
// and y written once. At an
// f2f window's batch of 16 the largest norm's input (16 x 256 x 320 x 64
// bf16, 168 MB) is larger than the 50 MB L2, so the second read comes from
// device memory: 1.5x the 4-byte floor. At the f2m step's batch of 1 the same
// norm's input is 10.5 MB, which the L2 holds between the two passes, so
// there the design expects the floor's traffic and the three launches' fixed
// cost (a few microseconds each) to set the time.
//
// Design (not the Pallas kernel's grid over row blocks with a carried sum):
// * Loads are 16 bytes a thread (8 bf16 / f16, 4 f32) along the channel axis.
//   A block's threads cover whole rows of the sample's (HW, C) slab: thread t
//   takes channel vector cv = t % (C / VEC) of row t / (C / VEC) and walks
//   down the rows with a stride of R = 256 / (C / VEC) rows, so a warp reads
//   512 contiguous bytes and a thread's channels never change. Four rows are
//   in flight a thread. Where C is not a multiple of VEC, or x is not 16-byte
//   aligned, one element a thread.
// * Statistics: grid (splits, B), each block a chunk of one sample's rows,
//   f64 sums in registers, then the block's R row groups added in shared
//   memory in a fixed order into one (2, C) f64 partial. A second small
//   launch (one block a sample) adds the partials in split order. No float
//   atomics: two runs give the same bits.
// * Apply: the same grid and row walk, the sample's mu / rstd staged in
//   shared memory and held in registers for the thread's channels.
// No tensor cores and no TMA: a streaming two-pass kernel. Making it faster
// (one read of x where the sample fits on chip) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>
#include <cstring>

namespace {

constexpr int THREADS = 256;         // stats and apply blocks
constexpr int UNROLL = 4;            // rows in flight a thread
constexpr int MAX_C = 128;           // the TPU kernel's lane width
constexpr int FINISH_THREADS = 512;  // one block a sample

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// 16-byte packs move as one uint4 (one vector load or store instruction).
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const Pack<T, VEC>* p) {
  Pack<T, VEC> o;
  if constexpr (sizeof(o) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&o, &u, 16);
  } else {
    o = *p;
  }
  return o;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(Pack<T, VEC>* p, const Pack<T, VEC>& o) {
  if constexpr (sizeof(o) == 16) {
    uint4 u;
    memcpy(&u, &o, 16);
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *p = o;
  }
}

// The rows [row0, row1) of block (j, b): ``rows_per`` rows a block.
struct Chunk {
  int64_t row0, row1;
};

__device__ __forceinline__ Chunk chunk(int HW, int rows_per) {
  const int64_t row0 = (int64_t)blockIdx.x * rows_per;
  const int64_t row1 = row0 + rows_per < HW ? row0 + rows_per : (int64_t)HW;
  return {row0, row1};
}

// Pass 1: one (2, C) partial of (sum, sum of squares) per block.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
instance_norm_partial(const T* __restrict__ x, double* __restrict__ part, int HW,
                      int C, int rows_per) {
  __shared__ double sh_s[THREADS * VEC];
  __shared__ double sh_q[THREADS * VEC];
  const int CV = C / VEC;
  const int R = THREADS / CV;
  const int t = threadIdx.x;
  const int r = t / CV, cv = t - r * CV;
  const int b = blockIdx.y;
  double s[VEC], q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = q[i] = 0.0;
  if (r < R) {
    const Chunk ch = chunk(HW, rows_per);
    const Pack<T, VEC>* base =
        reinterpret_cast<const Pack<T, VEC>*>(x + (int64_t)b * HW * C) + cv;
    int64_t row = ch.row0 + r;
    for (; row + (UNROLL - 1) * R < ch.row1; row += UNROLL * R) {
      Pack<T, VEC> p[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) p[u] = load(base + (row + u * R) * CV);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float v = to_f(p[u].v[i]);
          s[i] += v;
          q[i] += __fmul_rn(v, v);
        }
    }
    for (; row < ch.row1; row += R) {
      const Pack<T, VEC> p = load(base + row * CV);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float v = to_f(p.v[i]);
        s[i] += v;
        q[i] += __fmul_rn(v, v);
      }
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      sh_s[r * C + cv * VEC + i] = s[i];
      sh_q[r * C + cv * VEC + i] = q[i];
    }
  }
  __syncthreads();
  if (t < C) {
    double a = 0.0, aq = 0.0;
    for (int k = 0; k < R; ++k) {   // row groups in order
      a += sh_s[k * C + t];
      aq += sh_q[k * C + t];
    }
    double* out = part + ((int64_t)b * gridDim.x + blockIdx.x) * 2 * C;
    out[t] = a;
    out[C + t] = aq;
  }
}

// Pass 1b: one block a sample adds its ``nsplit`` partials in split order
// (thread (c, g) the splits g, g + G, ..., then the G groups in order). With
// ``moments`` it writes mu and rstd (B, C); else sum and sum of squares into
// out (B, 2, C).
__global__ void __launch_bounds__(FINISH_THREADS)
instance_norm_finish(const double* __restrict__ part, int nsplit, int C, int HW,
                     float eps, int moments, float* __restrict__ out,
                     float* __restrict__ mu, float* __restrict__ rstd) {
  __shared__ double sh_s[FINISH_THREADS];
  __shared__ double sh_q[FINISH_THREADS];
  const int c = threadIdx.x, g = threadIdx.y, G = blockDim.y;
  const int b = blockIdx.x;
  const double* p = part + (int64_t)b * nsplit * 2 * C;
  double a = 0.0, aq = 0.0;
  for (int j = g; j < nsplit; j += G) {
    a += p[(int64_t)j * 2 * C + c];
    aq += p[(int64_t)j * 2 * C + C + c];
  }
  sh_s[g * C + c] = a;
  sh_q[g * C + c] = aq;
  __syncthreads();
  if (g != 0) return;
  a = aq = 0.0;
  for (int k = 0; k < G; ++k) {
    a += sh_s[k * C + c];
    aq += sh_q[k * C + c];
  }
  const float sf = __double2float_rn(a), qf = __double2float_rn(aq);
  if (!moments) {
    out[(int64_t)b * 2 * C + c] = sf;
    out[(int64_t)b * 2 * C + C + c] = qf;
    return;
  }
  // the plain version's f32 ops, one rounding each; rsqrt as 1 / sqrt
  const float n = (float)HW;
  const float m = __fdiv_rn(sf, n);
  float var = __fsub_rn(__fdiv_rn(qf, n), __fmul_rn(m, m));
  var = var < 0.f ? 0.f : var;          // clamp(min=0); NaN stays NaN
  mu[(int64_t)b * C + c] = m;
  rstd[(int64_t)b * C + c] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
}

// Pass 2: y = [relu]((x - mu) rstd), cast to T.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
instance_norm_apply(const T* __restrict__ x, T* __restrict__ y,
                    const float* __restrict__ mu, const float* __restrict__ rstd,
                    int HW, int C, int rows_per, int relu) {
  __shared__ float sh_mu[MAX_C];
  __shared__ float sh_rs[MAX_C];
  const int CV = C / VEC;
  const int R = THREADS / CV;
  const int t = threadIdx.x;
  const int r = t / CV, cv = t - r * CV;
  const int b = blockIdx.y;
  if (t < C) {
    sh_mu[t] = mu[(int64_t)b * C + t];
    sh_rs[t] = rstd[(int64_t)b * C + t];
  }
  __syncthreads();
  if (r >= R) return;
  float m[VEC], rs[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    m[i] = sh_mu[cv * VEC + i];
    rs[i] = sh_rs[cv * VEC + i];
  }
  const Chunk ch = chunk(HW, rows_per);
  const int64_t off = (int64_t)b * HW * C;
  const Pack<T, VEC>* src = reinterpret_cast<const Pack<T, VEC>*>(x + off) + cv;
  Pack<T, VEC>* dst = reinterpret_cast<Pack<T, VEC>*>(y + off) + cv;
  auto norm = [&](const Pack<T, VEC>& p) {
    Pack<T, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      float v = __fmul_rn(__fsub_rn(to_f(p.v[i]), m[i]), rs[i]);
      if (relu) v = v < 0.f ? 0.f : v;  // clamp_min(0); NaN stays NaN
      o.v[i] = from_f<T>(v);
    }
    return o;
  };
  int64_t row = ch.row0 + r;
  for (; row + (UNROLL - 1) * R < ch.row1; row += UNROLL * R) {
    Pack<T, VEC> p[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) p[u] = load(src + (row + u * R) * CV);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) store(dst + (row + u * R) * CV, norm(p[u]));
  }
  for (; row < ch.row1; row += R) store(dst + row * CV, norm(load(src + row * CV)));
}

struct Args {
  const void* x;
  void* y;       // null: statistics only
  double* part;  // (B, nsplit, 2, C)
  float* out;    // statistics: (B, 2, C)
  float* mu;     // norm: (B, C) each
  float* rstd;
  int B, HW, C, rows_per, nsplit;
  float eps;
  int relu;
  cudaStream_t stream;
};

template <typename T, int VEC>
int run(const Args& a) {
  const dim3 grid((unsigned)a.nsplit, (unsigned)a.B);
  const T* x = static_cast<const T*>(a.x);
  instance_norm_partial<T, VEC><<<grid, THREADS, 0, a.stream>>>(
      x, a.part, a.HW, a.C, a.rows_per);
  const int G = FINISH_THREADS / a.C;
  instance_norm_finish<<<a.B, dim3(a.C, G), 0, a.stream>>>(
      a.part, a.nsplit, a.C, a.HW, a.eps, a.y != nullptr, a.out, a.mu, a.rstd);
  if (a.y != nullptr)
    instance_norm_apply<T, VEC><<<grid, THREADS, 0, a.stream>>>(
        x, static_cast<T*>(a.y), a.mu, a.rstd, a.HW, a.C, a.rows_per, a.relu);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

template <typename T>
int by_width(const Args& a) {
  constexpr int VEC = 16 / sizeof(T);
  if (a.C % VEC == 0 && aligned16(a.x) && aligned16(a.y)) return run<T, VEC>(a);
  return run<T, 1>(a);
}

int dispatch(const Args& a, int dtype) {
  // every split a chunk of rows_per rows, the last one non-empty
  if (a.B <= 0 || a.B > 65535 || a.HW <= 0 || a.C <= 0 || a.C > MAX_C ||
      a.rows_per <= 0 || a.nsplit <= 0 ||
      (int64_t)(a.nsplit - 1) * a.rows_per >= a.HW ||
      (int64_t)a.nsplit * a.rows_per < a.HW)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return by_width<float>(a);
    case 1: return by_width<__nv_bfloat16>(a);
    case 2: return by_width<__half>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// K2: (sum, sum of squares) over HW of x (B, HW, C) contiguous, dtype 0 =
// float32, 1 = bfloat16, 2 = float16, into out (B, 2, C) f32; ``part`` is
// (B, nsplit, 2, C) f64 scratch, split j of a sample its rows [j rows_per,
// (j + 1) rows_per). Two launches. Returns the CUDA error of the launches.
extern "C" int instance_norm_stats(const void* x, void* part, void* out, int B,
                                   int HW, int C, int rows_per, int nsplit,
                                   int dtype, void* stream) {
  const Args a = {x, nullptr, static_cast<double*>(part), static_cast<float*>(out),
                  nullptr, nullptr, B, HW, C, rows_per, nsplit, 0.f, 0,
                  static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype);
}

// The norm: the statistics, then y (B, HW, C) of x's dtype =
// [relu]((x - mu) rstd), with mu and rstd (B, C) f32 written beside it; the
// arguments as instance_norm_stats'. Three launches.
extern "C" int instance_norm_fwd(const void* x, void* y, void* part, void* mu,
                                 void* rstd, int B, int HW, int C, int rows_per,
                                 int nsplit, float eps, int relu, int dtype,
                                 void* stream) {
  if (y == nullptr) return (int)cudaErrorInvalidValue;
  const Args a = {x, y, static_cast<double*>(part), nullptr,
                  static_cast<float*>(mu), static_cast<float*>(rstd), B, HW, C,
                  rows_per, nsplit, eps, relu, static_cast<cudaStream_t>(stream)};
  return dispatch(a, dtype);
}
