// Fused normal-equation build for the Levenberg-Marquardt pose solver.
//
// Replaces: robust_pose_tpu/ops/pallas_normal_eq.py::_normal_eq_kernel
// (reached through normal_equations_pallas), one call per LM residual
// evaluation (1 + up to lbgfs_iters per window).
//
// What it computes, per batch element b, at pose T = [t, q]:
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
// What bounds it on an H100: it streams 11 f32 planes once (B x N x 44
// bytes, 115 MB at B = 8, 512x640) and does ~250 f32 operations per pixel,
// about 5.7 operations per byte -- below the card's f32 ridge (67 TFLOP/s
// over 3.35 TB/s = 20), so device-memory bytes bound it.
//
// Design: pass 1 runs a grid of (pixel block, batch); each thread walks its
// pixels with coalesced plane loads, keeps the 28 sums (21 upper-triangle H
// entries, 6 g entries, cost) in registers, and the block reduces them with
// warp shuffles and shared memory into a (B, n_blocks, 28) scratch tensor
// the wrapper allocates. Pass 2 runs one block per batch element; warp k
// sums column k of the partials in a fixed order. There are no float
// atomics, so two runs give the same bits. Pass 2 writes H (full 6x6), g and
// cost into one (B, 43) output.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NSUM = 28;

__global__ void __launch_bounds__(THREADS)
normal_eq_partial(const float* __restrict__ planes,
                  const float* __restrict__ pose,
                  const float* __restrict__ kvec, const float* __restrict__ lw,
                  float* __restrict__ partial, int npad, int h, int w,
                  int n_pix, float div2, float div3, int pix_per_block) {
  const int b = blockIdx.y;
  const int blk = blockIdx.x;
  const float tx = pose[b * 7 + 0], ty = pose[b * 7 + 1], tz = pose[b * 7 + 2];
  const float qx = pose[b * 7 + 3], qy = pose[b * 7 + 4], qz = pose[b * 7 + 5],
              qw = pose[b * 7 + 6];
  const float fx = kvec[b * 4 + 0], fy = kvec[b * 4 + 1];
  const float cx = kvec[b * 4 + 2], cy = kvec[b * 4 + 3];
  const float s2 = lw[b * 2 + 1] / div2;
  const float s3 = lw[b * 2 + 0] / div3;
  const float* pl = planes + (size_t)b * 12 * npad;

  float acc[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) acc[k] = 0.f;

  const int start = blk * pix_per_block;
  const int stop = min(start + pix_per_block, npad);
  for (int p = start + threadIdx.x; p < stop; p += THREADS) {
    const float p1x = pl[0 * (size_t)npad + p];
    const float p1y = pl[1 * (size_t)npad + p];
    const float p1z = pl[2 * (size_t)npad + p];
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
    const float col = (float)(p % w) + 0.5f;
    const float row = (float)((p / w) % h) + 0.5f;
    const float fox = col + pl[6 * (size_t)npad + p];
    const float foy = row + pl[7 * (size_t)npad + p];
    const float r2x = pix - fox;
    const float r2y = piy - foy;
    const float in_pix = p < n_pix ? 1.f : 0.f;
    const float valid2 =
        (fox > 0.f && foy > 0.f && fox < (float)w && foy < (float)h) ? 1.f : 0.f;
    const float c2 = s2 * pl[8 * (size_t)npad + p] * valid2 * in_pix;
    const float m00 = fx * inv_z;
    const float m02 = (cx - pix) * inv_z;
    const float m11 = fy * inv_z;
    const float m12 = (cy - piy) * inv_z;
    const float j2[2][6] = {
        {m00, 0.f, m02, ppy * m02, ppz * m00 - ppx * m02, -ppy * m00},
        {0.f, m11, m12, ppy * m12 - ppz * m11, -ppx * m12, ppx * m11}};
    const float r2[2] = {r2x, r2y};

    // 3D point-to-point term
    const float r3[3] = {ppx - pl[3 * (size_t)npad + p],
                         ppy - pl[4 * (size_t)npad + p],
                         ppz - pl[5 * (size_t)npad + p]};
    const float c3 = s3 * pl[9 * (size_t)npad + p] * in_pix;
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
      const float g3 = j3[0][a] * r3[0] + j3[1][a] * r3[1] + j3[2][a] * r3[2];
      acc[21 + a] += c2 * g2 + c3 * g3;
    }
    acc[27] += c2 * (r2x * r2x + r2y * r2y) +
               c3 * (r3[0] * r3[0] + r3[1] * r3[1] + r3[2] * r3[2]);
  }

  // block reduction in a fixed order: warp shuffles, then warp partials
  __shared__ float red[THREADS / 32][NSUM];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NSUM; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  if (threadIdx.x < NSUM) {
    float v = 0.f;
#pragma unroll
    for (int wi = 0; wi < THREADS / 32; ++wi) v += red[wi][threadIdx.x];
    partial[((size_t)b * gridDim.x + blk) * NSUM + threadIdx.x] = v;
  }
}

__global__ void __launch_bounds__(NSUM * 32)
normal_eq_finish(const float* __restrict__ partial, float* __restrict__ out,
                 int n_blocks) {
  const int b = blockIdx.x;
  const int k = threadIdx.x >> 5;  // one warp per sum
  const int lane = threadIdx.x & 31;
  float v = 0.f;
  for (int j = lane; j < n_blocks; j += 32)
    v += partial[((size_t)b * n_blocks + j) * NSUM + k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane != 0) return;
  float* o = out + (size_t)b * 43;
  if (k < 21) {
    // k -> (a, c) of the upper triangle, row-major
    int a = 0, rem = k;
    while (rem >= 6 - a) { rem -= 6 - a; ++a; }
    const int c = a + rem;
    o[a * 6 + c] = v;
    o[c * 6 + a] = v;
  } else {
    o[36 + (k - 21)] = v;  // g (6), then cost
  }
}

}  // namespace

// planes (B, 12, npad) f32, pose (B, 7), kvec (B, 4), lw (B, 2), partial
// (B, n_blocks, 28) scratch, out (B, 43) = [H (36, row-major), g (6), cost];
// all f32 and contiguous.
extern "C" int normal_eq(const void* planes, const void* pose, const void* kvec,
                         const void* lw, void* partial, void* out, int B,
                         int npad, int h, int w, float div2, float div3,
                         int pix_per_block, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = (npad + pix_per_block - 1) / pix_per_block;
  normal_eq_partial<<<dim3(n_blocks, B), THREADS, 0, s>>>(
      static_cast<const float*>(planes), static_cast<const float*>(pose),
      static_cast<const float*>(kvec), static_cast<const float*>(lw),
      static_cast<float*>(partial), npad, h, w, h * w, div2, div3,
      pix_per_block);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  normal_eq_finish<<<B, NSUM * 32, 0, s>>>(static_cast<const float*>(partial),
                                           static_cast<float*>(out), n_blocks);
  return (int)cudaGetLastError();
}
