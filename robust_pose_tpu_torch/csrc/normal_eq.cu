// The Levenberg-Marquardt pose solve on the card: the fused normal-equation
// build (K3) and the whole deferred-acceptance loop around it in ONE
// cooperative launch.
//
// Replaces: robust_pose_tpu/ops/pallas_normal_eq.py::_normal_eq_kernel
// (reached through normal_equations_pallas, one call per LM residual
// evaluation) and the lax.while_loop around it in
// robust_pose_tpu/solver/gauss_newton.py:solve_pose.
//
// What a build computes, per batch element b, at pose T = [t, q]:
//   pp = R(q) p1 + t
//   2D: pi = proj(K pp), r2 = pi - (pixel centre + flow),
//       J2 = [M | pp x M_row], M = (K[:2] - pi K[2]) / z,
//       c2 = lw2 * w1 * valid2 / (N H W), valid2: target inside the image
//   3D: r3 = pp - p2, J3 = [I | pp x e_i], c3 = lw3 * w2 / N
//   H = sum c2 J2^T J2 + c3 J3^T J3, g = sum c2 J2^T r2 + c3 J3^T r3,
//   cost = sum c2 |r2|^2 + c3 |r3|^2
// over the N = H*W pixels of the (B, 12, Npad) channel-major planes of
// pack_planes (padding pixels have zero weights and contribute nothing).
//
// What bounds a build on an H100: it streams the 10 planes the math reads
// once (B x N x 40 bytes, 105 MB at B = 8, 512x640) and does ~260 f32
// operations per pixel, 6.5 a byte -- below the card's f32 ridge (67
// TFLOP/s over 3.35 TB/s = 20), so device-memory bytes bound it. What bounds
// the solve is the chain of builds (1 + realized iterations) and the
// latency of the per-sample update between them: a host-driven loop paid
// ~150 launches and a host round trip for each iteration.
//
// Design.
// - A build: a 2048-pixel block of one sample is one work item; each of its
//   256 threads loads 16 bytes of each of the 10 planes twice (two groups
//   of 4 pixels, 10 loads in flight per group), keeps the 28 sums (21
//   upper-triangle H entries, 6 g entries, cost) in registers, and the
//   block reduces them in a fixed order (warp shuffles, then the 8 warp
//   partials in order) into a (B, n_blocks, 28) scratch. A finish sums
//   column k of the partials with lane-strided sums and a shuffle tree.
//   There are no float atomics, so two runs give the same bits, and the
//   build inside the solve is the same code as normal_eq's: bit-equal H, g
//   and cost at the same pose.
// - lm_solve: one cooperative launch of as many 256-thread blocks as can be
//   resident (at most one a work item). Per iteration: phase A, every block
//   builds its work items at the samples' trial poses (done samples are
//   skipped: they are frozen); grid barrier; phase B, the block of sample
//   b finishes its sums and one thread runs the update (accept, damping,
//   done, next proposal: the damped 6 x 6 system by an LU with partial
//   pivoting, the zeroed non-finite step, exp(delta) * pose); grid
//   barrier. Every block then reads the done flags and leaves the loop
//   when all are set (early exit) or at the cap. The LM state of a sample
//   (pose, trial, step, H, g, cost, damping) lives in device memory
//   (state, (B, 80) floats); reads of what another block wrote go through
//   L2 (__ldcg).
// - The update rounds as the plain version does op by op (each product,
//   sum and quotient on its own, as PyTorch's elementwise kernels do; the
//   cross products contracted as ATen's cross kernel is): solve6_lu and
//   lm_propose in ops/normal_eq.py. The iteration counts depend on the last
//   bits of each step once the cost changes less than its rounding, so
//   this is what lets the plain loop with K3 builds hold the kernel to its
//   counts and flags.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NSUM = 28;
constexpr int BLOCK_N = 2048;          // pixels of a work item
constexpr int GROUPS = BLOCK_N / (4 * THREADS);
constexpr int STATE = 80;              // floats of LM state a sample
// state layout; the last two are written once, after the loop
constexpr int S_POSE = 0, S_TRIAL = 7, S_DELTA = 14, S_H = 20, S_G = 56,
              S_COST = 62, S_LAM = 63, S_NPOSE = 64, S_TAU = 71;

struct Build {
  const float* planes;
  const float* kvec;
  const float* lw;
  int npad, h, w, n_pix;
  float div2, div3;
};

__device__ __forceinline__ float lane4(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The 28 sums of work item (b, blk) at pose T, reduced over the block in a
// fixed order; thread t < 28 returns sum t. Called by the whole block.
__device__ __forceinline__ float block_sums(const Build& P, int b, int blk,
                                            const float T[7],
                                            float (*red)[NSUM]) {
  const float tx = T[0], ty = T[1], tz = T[2];
  const float qx = T[3], qy = T[4], qz = T[5], qw = T[6];
  const float fx = P.kvec[b * 4 + 0], fy = P.kvec[b * 4 + 1];
  const float cx = P.kvec[b * 4 + 2], cy = P.kvec[b * 4 + 3];
  const float s2 = P.lw[b * 2 + 1] / P.div2;
  const float s3 = P.lw[b * 2 + 0] / P.div3;
  const size_t pstride = (size_t)P.npad / 4;  // float4s between planes
  const float4* base = reinterpret_cast<const float4*>(
      P.planes + (size_t)b * 12 * P.npad + (size_t)blk * BLOCK_N);

  float acc[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) acc[k] = 0.f;

#pragma unroll 1
  for (int grp = 0; grp < GROUPS; ++grp) {
    const int q = threadIdx.x + grp * THREADS;
    float4 v[10];
#pragma unroll
    for (int c = 0; c < 10; ++c) v[c] = __ldg(base + c * pstride + q);
    // pixel p = (row, col) of the image, row modulo h past its end
    const int p0 = blk * BLOCK_N + 4 * q;
    int col_i = p0 % P.w, row_i = (p0 / P.w) % P.h;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = p0 + e;
      if (e > 0 && ++col_i == P.w) {
        col_i = 0;
        if (++row_i == P.h) row_i = 0;
      }
      const float p1x = lane4(v[0], e), p1y = lane4(v[1], e),
                  p1z = lane4(v[2], e);
      // pp = R(q) p1 + t  (t2 = 2 qv x p;  p + qw t2 + qv x t2)
      const float t2x = 2.f * (qy * p1z - qz * p1y);
      const float t2y = 2.f * (qz * p1x - qx * p1z);
      const float t2z = 2.f * (qx * p1y - qy * p1x);
      const float ppx = p1x + qw * t2x + (qy * t2z - qz * t2y) + tx;
      const float ppy = p1y + qw * t2y + (qz * t2x - qx * t2z) + ty;
      const float ppz = p1z + qw * t2z + (qx * t2y - qy * t2x) + tz;

      // 2D reprojection term
      const float az = fmaxf(ppz, 1e-12f);
      const float inv_z = 1.f / az;
      const float pix = (fx * ppx + cx * ppz) * inv_z;
      const float piy = (fy * ppy + cy * ppz) * inv_z;
      const float col = (float)col_i + 0.5f;
      const float row = (float)row_i + 0.5f;
      const float fox = col + lane4(v[6], e);
      const float foy = row + lane4(v[7], e);
      const float r2x = pix - fox;
      const float r2y = piy - foy;
      const float in_pix = p < P.n_pix ? 1.f : 0.f;
      const float valid2 = (fox > 0.f && foy > 0.f && fox < (float)P.w &&
                            foy < (float)P.h) ? 1.f : 0.f;
      const float c2 = s2 * lane4(v[8], e) * valid2 * in_pix;
      const float m00 = fx * inv_z;
      const float m02 = (cx - pix) * inv_z;
      const float m11 = fy * inv_z;
      const float m12 = (cy - piy) * inv_z;
      const float j2[2][6] = {
          {m00, 0.f, m02, ppy * m02, ppz * m00 - ppx * m02, -ppy * m00},
          {0.f, m11, m12, ppy * m12 - ppz * m11, -ppx * m12, ppx * m11}};
      const float r2[2] = {r2x, r2y};

      // 3D point-to-point term
      const float r3[3] = {ppx - lane4(v[3], e), ppy - lane4(v[4], e),
                           ppz - lane4(v[5], e)};
      const float c3 = s3 * lane4(v[9], e) * in_pix;
      const float j3[3][6] = {{1.f, 0.f, 0.f, 0.f, ppz, -ppy},
                              {0.f, 1.f, 0.f, -ppz, 0.f, ppx},
                              {0.f, 0.f, 1.f, ppy, -ppx, 0.f}};

      int k = 0;
#pragma unroll
      for (int a = 0; a < 6; ++a) {
#pragma unroll
        for (int c = a; c < 6; ++c) {
          const float h2 = j2[0][a] * j2[0][c] + j2[1][a] * j2[1][c];
          const float h3 = j3[0][a] * j3[0][c] + j3[1][a] * j3[1][c] +
                           j3[2][a] * j3[2][c];
          acc[k++] += c2 * h2 + c3 * h3;
        }
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        const float g2 = j2[0][a] * r2[0] + j2[1][a] * r2[1];
        const float g3 =
            j3[0][a] * r3[0] + j3[1][a] * r3[1] + j3[2][a] * r3[2];
        acc[21 + a] += c2 * g2 + c3 * g3;
      }
      acc[27] += c2 * (r2x * r2x + r2y * r2y) +
                 c3 * (r3[0] * r3[0] + r3[1] * r3[1] + r3[2] * r3[2]);
    }
  }

  // block reduction in a fixed order: warp shuffles, then warp partials
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NSUM; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  float out = 0.f;
  if (threadIdx.x < NSUM) {
#pragma unroll
    for (int wi = 0; wi < WARPS; ++wi) out += red[wi][threadIdx.x];
  }
  __syncthreads();  // red is free again
  return out;
}

// Sum k of sample b's partials (n_blocks rows of 28): lane-strided sums,
// then a shuffle tree; every lane returns it.
__device__ __forceinline__ float column_sum(const float* part, int n_blocks,
                                            int k, int lane) {
  float v = 0.f;
  for (int j = lane; j < n_blocks; j += 32) v += __ldcg(part + (size_t)j * NSUM + k);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// sum index k -> H[a][c] of the upper triangle, row-major
__device__ __forceinline__ void sum_to_entry(int k, int& a, int& c) {
  a = 0;
  int rem = k;
  while (rem >= 6 - a) { rem -= 6 - a; ++a; }
  c = a + rem;
}

// ---------------------------------------------------------------------------
// The per-sample update, rounded as the plain version's PyTorch ops are.
// ---------------------------------------------------------------------------

__device__ __forceinline__ float fm(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float fa(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float fs(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float fd(float a, float b) { return __fdiv_rn(a, b); }

// torch.linalg.cross on the card: a*b - c*d in one expression, which nvcc
// contracts to fma(a, b, -(c * d)) (chip_smoke.py checks the bits)
__device__ __forceinline__ float cross_term(float a, float b, float c, float d) {
  return fmaf(a, b, -fm(c, d));
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float o[3]) {
  o[0] = cross_term(a[1], b[2], a[2], b[1]);
  o[1] = cross_term(a[2], b[0], a[0], b[2]);
  o[2] = cross_term(a[0], b[1], a[1], b[0]);
}

// torch.sum over a last dimension of 3 and torch.linalg.norm over one of
// 4 or 6, in the order PyTorch's reduction kernel adds them on the card
// (chip_smoke.py checks the bits)
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return fa(fa(a, c), b);
}

__device__ __forceinline__ float norm4(float a, float b, float c, float d) {
  return __fsqrt_rn(fa(fa(fm(a, a), fm(c, c)), fa(fm(b, b), fm(d, d))));
}

__device__ __forceinline__ float norm6(const float d[6]) {
  return __fsqrt_rn(fa(fa(fa(fm(d[0], d[0]), fm(d[4], d[4])), fm(d[2], d[2])),
                       fa(fa(fm(d[1], d[1]), fm(d[5], d[5])), fm(d[3], d[3]))));
}

__device__ __forceinline__ float safe_sqrt(float x) {
  return x > 0.f ? __fsqrt_rn(x) : 0.f;
}

// se3.retract(delta, pose) = exp(delta) * pose
__device__ void retract(const float d[6], const float pose[7], float out[7]) {
  const float v[3] = {d[0], d[1], d[2]};
  const float w[3] = {d[3], d[4], d[5]};
  const float ts = sum3(fm(w[0], w[0]), fm(w[1], w[1]), fm(w[2], w[2]));
  const float theta = safe_sqrt(ts);
  // so3_exp_quat
  const float half = fm(0.5f, theta);
  const float sinc_half = ts < 1e-8f ? fs(0.5f, fm(ts, 1.0f / 48.0f))
                                     : fd(sinf(half), theta);
  const float qe[4] = {fm(sinc_half, w[0]), fm(sinc_half, w[1]),
                       fm(sinc_half, w[2]), cosf(half)};
  // _V_coeffs
  const bool small = ts < 1e-2f;
  const float tsq = fm(ts, ts);
  const float Bc = small ? fa(fs(0.5f, fm(ts, 1.0f / 24.0f)),
                              fm(tsq, 1.0f / 720.0f))
                         : fd(fs(1.f, cosf(theta)), ts);
  const float Cc = small ? fa(fs((float)(1.0 / 6.0), fm(ts, 1.0f / 120.0f)),
                              fm(tsq, 1.0f / 5040.0f))
                         : fd(fs(theta, sinf(theta)), fm(ts, theta));
  float wxv[3], wxwxv[3];
  cross3(w, v, wxv);
  cross3(w, wxv, wxwxv);
  float te[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    te[i] = fa(fa(v[i], fm(Bc, wxv[i])), fm(Cc, wxwxv[i]));
  // mul(exp, pose): t = te + quat_rotate(qe, pose_t), q = qe * pose_q
  const float p[3] = {pose[0], pose[1], pose[2]};
  float c1[3], t2[3], c2[3];
  cross3(qe, p, c1);
#pragma unroll
  for (int i = 0; i < 3; ++i) t2[i] = fm(2.f, c1[i]);
  cross3(qe, t2, c2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    out[i] = fa(te[i], fa(fa(p[i], fm(qe[3], t2[i])), c2[i]));
  const float x1 = qe[0], y1 = qe[1], z1 = qe[2], w1 = qe[3];
  const float x2 = pose[3], y2 = pose[4], z2 = pose[5], w2 = pose[6];
  out[3] = fs(fa(fa(fm(w1, x2), fm(x1, w2)), fm(y1, z2)), fm(z1, y2));
  out[4] = fa(fa(fs(fm(w1, y2), fm(x1, z2)), fm(y1, w2)), fm(z1, x2));
  out[5] = fa(fs(fa(fm(w1, z2), fm(x1, y2)), fm(y1, x2)), fm(z1, w2));
  out[6] = fs(fs(fs(fm(w1, w2), fm(x1, x2)), fm(y1, y2)), fm(z1, z2));
}

// se3.normalize(pose) and se3.log of it: what solve_pose returns
__device__ void finish(const float pose[7], float npose[7], float tau[6]) {
  const float nq = norm4(pose[3], pose[4], pose[5], pose[6]);
#pragma unroll
  for (int i = 0; i < 7; ++i) npose[i] = i < 3 ? pose[i] : fd(pose[i], nq);
  // so3_log
  const float sign = npose[6] < 0.f ? -1.f : 1.f;
  const float qv[3] = {fm(npose[3], sign), fm(npose[4], sign), fm(npose[5], sign)};
  const float qw = fm(npose[6], sign);
  const float n_sq = sum3(fm(qv[0], qv[0]), fm(qv[1], qv[1]), fm(qv[2], qv[2]));
  const float n = safe_sqrt(n_sq);
  const float angle = fm(2.f, atan2f(n, qw));
  const float qw_c = isnan(qw) ? qw : fmaxf(qw, 1e-8f);  // torch.clamp
  const float scale =
      n_sq < 1e-12f
          ? fm(fm(fd(1.f, qw_c), 2.f), fs(1.f, fd(n_sq, fm(3.f, fm(qw_c, qw_c)))))
          : fd(angle, n);
  const float w[3] = {fm(scale, qv[0]), fm(scale, qv[1]), fm(scale, qv[2])};
  // log(g): t - 0.5 w x t + D w x (w x t)
  const float ts = sum3(fm(w[0], w[0]), fm(w[1], w[1]), fm(w[2], w[2]));
  const float theta = safe_sqrt(ts);
  const bool small = ts < 1e-2f;
  const float tsq = fm(ts, ts);
  const float Bc = small ? fa(fs(0.5f, fm(ts, 1.0f / 24.0f)), fm(tsq, 1.0f / 720.0f))
                         : fd(fs(1.f, cosf(theta)), ts);
  const float A = small ? fa(fs(1.f, fm(ts, 1.0f / 6.0f)), fm(tsq, 1.0f / 120.0f))
                        : fd(sinf(theta), theta);
  const float D = small ? fa(fa(fm(ts, 1.0f / 720.0f), (float)(1.0 / 12.0)),
                             fm(tsq, 1.0f / 30240.0f))
                        : fd(fs(1.f, fd(A, fm(2.f, Bc))), ts);
  const float t[3] = {npose[0], npose[1], npose[2]};
  float wxt[3], wxwxt[3];
  cross3(w, t, wxt);
  cross3(w, wxt, wxwxt);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    tau[i] = fa(fs(t[i], fm(0.5f, wxt[i])), fm(D, wxwxt[i]));
    tau[3 + i] = w[i];
  }
}

// lm_propose: Hd = H + (lam diag(H) + 1e-12) I, delta = -Hd^-1 g (LU with
// partial pivoting, solve6_lu), zeroed where not finite, trial = retract.
// Registers only: every index is a compile-time one after unrolling.
__device__ void propose(const float H[36], const float g[6], float lam,
                        const float pose[7], float trial[7], float delta[6]) {
  float A[6][6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float d = fa(fm(lam, H[i * 6 + i]), 1e-12f);
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = fa(H[i * 6 + j], fm(d, i == j ? 1.f : 0.f));
    x[i] = g[i];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    // pivot: the largest |a| of column k (a NaN counts as +inf), first on ties
    int p = k;
    float best = isnan(A[k][k]) ? INFINITY : fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float a = isnan(A[i][k]) ? INFINITY : fabsf(A[i][k]);
      if (a > best) { best = a; p = i; }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      if (i == p) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[k][j]; A[k][j] = A[i][j]; A[i][j] = t;
        }
        const float t = x[k]; x[k] = x[i]; x[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = fd(A[i][k], A[k][k]);
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = fs(A[i][j], fm(l, A[k][j]));
      x[i] = fs(x[i], fm(l, x[k]));
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = fs(s, fm(A[i][j], x[j]));
    x[i] = fd(s, A[i][i]);
  }
  bool finite = true;
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
#pragma unroll
  for (int i = 0; i < 6; ++i) delta[i] = finite ? -x[i] : 0.f;
  retract(delta, pose, trial);
}

// ---------------------------------------------------------------------------
// kernels
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
normal_eq_partial(Build P, const float* __restrict__ pose,
                  float* __restrict__ partial) {
  __shared__ float red[WARPS][NSUM];
  const int b = blockIdx.y, blk = blockIdx.x;
  float T[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) T[i] = pose[b * 7 + i];
  const float v = block_sums(P, b, blk, T, red);
  if (threadIdx.x < NSUM)
    partial[((size_t)b * gridDim.x + blk) * NSUM + threadIdx.x] = v;
}

__global__ void __launch_bounds__(NSUM * 32)
normal_eq_finish(const float* __restrict__ partial, float* __restrict__ out,
                 int n_blocks) {
  const int b = blockIdx.x;
  const int k = threadIdx.x >> 5;  // one warp per sum
  const float v = column_sum(partial + (size_t)b * n_blocks * NSUM, n_blocks,
                             k, threadIdx.x & 31);
  if ((threadIdx.x & 31) != 0) return;
  float* o = out + (size_t)b * 43;
  if (k < 21) {
    int a, c;
    sum_to_entry(k, a, c);
    o[a * 6 + c] = v;
    o[c * 6 + a] = v;
  } else {
    o[36 + (k - 21)] = v;  // g (6), then cost
  }
}

struct Solve {
  Build P;
  float* partial;  // (B, n_blocks, 28)
  float* state;    // (B, STATE)
  int* niter;      // (B,)
  int* flags;      // (B, 2): done, failed (lam >= 1e6)
  int B, iters, early_exit;
  float init_lambda, lambda_up, lambda_down, tol_step;
};

__global__ void __launch_bounds__(THREADS) lm_solve_kernel(Solve S) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float red[WARPS][NSUM];
  __shared__ float sums[NSUM];
  __shared__ int all_done;
  const int n_blocks = S.P.npad / BLOCK_N;
  const int items = S.B * n_blocks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int it = -1; it < S.iters; ++it) {
    if (it >= 0 && S.early_exit) {
      if (threadIdx.x == 0) {
        int all = 1;
        for (int b = 0; b < S.B; ++b) all &= __ldcg(S.flags + 2 * b);
        all_done = all;
      }
      __syncthreads();
      if (all_done) break;  // the same answer in every block
    }
    // phase A: the builds at the trial poses (the identity first)
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int b = item / n_blocks, blk = item % n_blocks;
      float T[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 1.f};
      if (it >= 0) {
        if (__ldcg(S.flags + 2 * b)) continue;  // frozen
#pragma unroll
        for (int i = 0; i < 7; ++i) T[i] = __ldcg(S.state + b * STATE + S_TRIAL + i);
      }
      const float v = block_sums(S.P, b, blk, T, red);
      if (threadIdx.x < NSUM)
        S.partial[((size_t)b * n_blocks + blk) * NSUM + threadIdx.x] = v;
    }
    grid.sync();
    // phase B: the update of each sample, in the block b % gridDim.x
    for (int b = blockIdx.x; b < S.B; b += gridDim.x) {
      if (it >= 0 && __ldcg(S.flags + 2 * b)) continue;
      for (int k = warp; k < NSUM; k += WARPS) {
        const float v = column_sum(S.partial + (size_t)b * n_blocks * NSUM,
                                   n_blocks, k, lane);
        if (lane == 0) sums[k] = v;
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        float* st = S.state + b * STATE;
        float Ht[36], gt[6], pose[7], H[36], g[6], trial[7], delta[6];
        for (int k = 0; k < 21; ++k) {
          int a, c;
          sum_to_entry(k, a, c);
          Ht[a * 6 + c] = Ht[c * 6 + a] = sums[k];
        }
        for (int i = 0; i < 6; ++i) gt[i] = sums[21 + i];
        const float cost_t = sums[27];
        float lam, cost;
        bool done = false, failed = false;
        if (it < 0) {
          for (int i = 0; i < 7; ++i) pose[i] = i == 6 ? 1.f : 0.f;
          for (int i = 0; i < 36; ++i) H[i] = Ht[i];
          for (int i = 0; i < 6; ++i) g[i] = gt[i];
          cost = cost_t;
          lam = S.init_lambda;
          S.niter[b] = 0;
        } else {
          float d[6];
          for (int i = 0; i < 6; ++i) d[i] = __ldcg(st + S_DELTA + i);
          const bool step_small = norm6(d) <= S.tol_step;
          cost = __ldcg(st + S_COST);
          const bool accept = cost_t < cost;
          for (int i = 0; i < 7; ++i)
            pose[i] = __ldcg(st + (accept ? S_TRIAL : S_POSE) + i);
          for (int i = 0; i < 36; ++i) H[i] = accept ? Ht[i] : __ldcg(st + S_H + i);
          for (int i = 0; i < 6; ++i) g[i] = accept ? gt[i] : __ldcg(st + S_G + i);
          if (accept) cost = cost_t;
          lam = __ldcg(st + S_LAM);
          lam = fm(lam, accept ? S.lambda_down : S.lambda_up);
          lam = fminf(fmaxf(lam, 1e-9f), 1e6f);
          failed = lam >= 1e6f;
          done = (accept && step_small) || failed;
          S.niter[b] = __ldcg(S.niter + b) + 1;
        }
        propose(H, g, lam, pose, trial, delta);
        for (int i = 0; i < 7; ++i) {
          st[S_POSE + i] = pose[i];
          st[S_TRIAL + i] = trial[i];
        }
        for (int i = 0; i < 6; ++i) st[S_DELTA + i] = delta[i];
        for (int i = 0; i < 36; ++i) st[S_H + i] = H[i];
        for (int i = 0; i < 6; ++i) st[S_G + i] = g[i];
        st[S_COST] = cost;
        st[S_LAM] = lam;
        S.flags[2 * b] = done;
        S.flags[2 * b + 1] = failed;
      }
      __syncthreads();
    }
    grid.sync();
  }
  // the normalized pose and its tangent, by the thread that wrote the state
  for (int b = blockIdx.x; b < S.B; b += gridDim.x) {
    if (threadIdx.x == 0) {
      float* st = S.state + b * STATE;
      float pose[7], npose[7], tau[6];
      for (int i = 0; i < 7; ++i) pose[i] = st[S_POSE + i];
      finish(pose, npose, tau);
      for (int i = 0; i < 7; ++i) st[S_NPOSE + i] = npose[i];
      for (int i = 0; i < 6; ++i) st[S_TAU + i] = tau[i];
    }
  }
}

__global__ void lm_propose_kernel(const float* __restrict__ H,
                                  const float* __restrict__ g,
                                  const float* __restrict__ lam,
                                  const float* __restrict__ pose,
                                  float* __restrict__ trial,
                                  float* __restrict__ delta,
                                  float* __restrict__ fin, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float Hb[36], gb[6], pb[7], tb[7], db[6];
  for (int i = 0; i < 36; ++i) Hb[i] = H[b * 36 + i];
  for (int i = 0; i < 6; ++i) gb[i] = g[b * 6 + i];
  for (int i = 0; i < 7; ++i) pb[i] = pose[b * 7 + i];
  propose(Hb, gb, lam[b], pb, tb, db);
  for (int i = 0; i < 7; ++i) trial[b * 7 + i] = tb[i];
  for (int i = 0; i < 6; ++i) delta[b * 6 + i] = db[i];
  // the finish of the pose (normalize, log) and the step's norm
  float np[7], tau[6];
  finish(pb, np, tau);
  for (int i = 0; i < 7; ++i) fin[b * 14 + i] = np[i];
  for (int i = 0; i < 6; ++i) fin[b * 14 + 7 + i] = tau[i];
  fin[b * 14 + 13] = norm6(db);
}

Build make_build(const void* planes, const void* kvec, const void* lw,
                 int npad, int h, int w, float div2, float div3) {
  return Build{static_cast<const float*>(planes),
               static_cast<const float*>(kvec), static_cast<const float*>(lw),
               npad, h, w, h * w, div2, div3};
}

}  // namespace

// planes (B, 12, npad) f32 with npad a multiple of 2048, pose (B, 7), kvec
// (B, 4), lw (B, 2), partial (B, npad / 2048, 28) scratch, out (B, 43) =
// [H (36, row-major), g (6), cost]; all f32 and contiguous.
extern "C" int normal_eq(const void* planes, const void* pose, const void* kvec,
                         const void* lw, void* partial, void* out, int B,
                         int npad, int h, int w, float div2, float div3,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = npad / BLOCK_N;
  normal_eq_partial<<<dim3(n_blocks, B), THREADS, 0, s>>>(
      make_build(planes, kvec, lw, npad, h, w, div2, div3),
      static_cast<const float*>(pose), static_cast<float*>(partial));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  normal_eq_finish<<<B, NSUM * 32, 0, s>>>(static_cast<const float*>(partial),
                                           static_cast<float*>(out), n_blocks);
  return (int)cudaGetLastError();
}

// The LM solve from the identity in one cooperative launch. planes, kvec, lw
// as normal_eq; partial (B, npad / 2048, 28) and state (B, 64) f32 scratch
// (state[:, :7] is the solved pose, state[:, 64:71] it normalized and
// state[:, 71:77] its log), niter (B,) int32, flags (B, 2) int32
// (done, failed). Returns a CUDA error code; a grid that cannot be resident
// at once is refused by the launch and reported, never run another way.
extern "C" int lm_solve(const void* planes, const void* kvec, const void* lw,
                        void* partial, void* state, void* niter, void* flags,
                        int B, int npad, int h, int w, float div2, float div3,
                        int iters, float init_lambda, float lambda_up,
                        float lambda_down, int early_exit, float tol_step,
                        void* stream) {
  static int resident[64];  // blocks that fit at once, per device (0: unknown)
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0, coop = 0;
    if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, lm_solve_kernel, THREADS, 0)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess ||
        (e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) !=
            cudaSuccess)
      return (int)e;
    if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per_sm * sms;
  }
  const int items = B * (npad / BLOCK_N);
  const int grid = items < resident[dev] ? items : resident[dev];
  Solve S{make_build(planes, kvec, lw, npad, h, w, div2, div3),
          static_cast<float*>(partial), static_cast<float*>(state),
          static_cast<int*>(niter), static_cast<int*>(flags),
          B, iters, early_exit, init_lambda, lambda_up, lambda_down, tol_step};
  void* args[] = {&S};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(lm_solve_kernel),
                                  dim3(grid), dim3(THREADS), args, 0,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The solve kernel's per-sample arithmetic alone, one thread a sample: H
// (B, 36), g (B, 6), lam (B,), pose (B, 7) -> trial (B, 7), delta (B, 6),
// fin (B, 14) = [pose normalized, its log, |delta|]; f32, contiguous.
extern "C" int lm_propose(const void* H, const void* g, const void* lam,
                          const void* pose, void* trial, void* delta, void* fin,
                          int B, void* stream) {
  lm_propose_kernel<<<(B + 127) / 128, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(H), static_cast<const float*>(g),
      static_cast<const float*>(lam), static_cast<const float*>(pose),
      static_cast<float*>(trial), static_cast<float*>(delta),
      static_cast<float*>(fin), B);
  return (int)cudaGetLastError();
}

