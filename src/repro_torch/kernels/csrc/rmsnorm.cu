// RMSNorm over the rows of a (rows, h) bf16 matrix, for sm_90a.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas / _rmsnorm_kernel
// (the Pallas TPU kernel that normalises (block_rows, h) tiles in VMEM).
//
// Bound on the H100: device memory.  Each element is read once and written
// once and costs a handful of fp32 operations, so a (4096, 7168) call moves
// 117 MB and needs about 35 us at 3.35 TB/s; the arithmetic is three orders
// of magnitude below the card's rate.
//
// Design: one block per row, so the row's sum of squares is a block
// reduction (warp shuffles, then one value per warp through shared memory)
// and no state crosses blocks.  Threads stride over the row in 16-byte
// chunks of eight bf16 values when the row is 16-byte aligned, which keeps
// a warp's loads on neighbouring addresses whatever the width (7168, 1536,
// 96 are not powers of two: no padding, only striding); an odd or unaligned
// width takes the scalar path.  The second pass re-reads the row, which is
// at most 14 KB and still in L1/L2, instead of holding it in registers.
// Numerics follow the TPU kernel: fp32 mean of x^2, rsqrt(var + eps), gain
// `scale` or `1 + scale`, product rounded once to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float block_sum(float v, float* warp_sums) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  float t = lane < n_warps ? warp_sums[lane] : 0.f;
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  return t;
}

__global__ void rmsnorm_kernel(const __nv_bfloat16* __restrict__ x,
                               const __nv_bfloat16* __restrict__ scale,
                               __nv_bfloat16* __restrict__ out, int h,
                               float eps, int gemma_style, int vec) {
  __shared__ float warp_sums[32];
  const long long row = blockIdx.x;
  const __nv_bfloat16* xr = x + row * h;
  __nv_bfloat16* yr = out + row * h;
  const float g0 = gemma_style ? 1.f : 0.f;

  float ss = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    for (int c = threadIdx.x; c < h / 8; c += blockDim.x) {
      uint4 u = xv[c];
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(p[i]);
        ss += f.x * f.x + f.y * f.y;
      }
    }
  } else {
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      float f = __bfloat162float(xr[i]);
      ss += f * f;
    }
  }
  const float inv = rsqrtf(block_sum(ss, warp_sums) / (float)h + eps);

  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* sv = reinterpret_cast<const uint4*>(scale);
    uint4* yv = reinterpret_cast<uint4*>(yr);
    for (int c = threadIdx.x; c < h / 8; c += blockDim.x) {
      uint4 u = xv[c], s = sv[c], o;
      const __nv_bfloat162* px = reinterpret_cast<const __nv_bfloat162*>(&u);
      const __nv_bfloat162* ps = reinterpret_cast<const __nv_bfloat162*>(&s);
      __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 f = __bfloat1622float2(px[i]);
        float2 g = __bfloat1622float2(ps[i]);
        po[i] = __floats2bfloat162_rn((f.x * inv) * (g0 + g.x),
                                      (f.y * inv) * (g0 + g.y));
      }
      yv[c] = o;
    }
  } else {
    for (int i = threadIdx.x; i < h; i += blockDim.x) {
      float f = __bfloat162float(xr[i]);
      float g = g0 + __bfloat162float(scale[i]);
      yr[i] = __float2bfloat16((f * inv) * g);
    }
  }
}

}  // namespace

extern "C" int repro_rmsnorm_bf16(const void* x, const void* scale, void* out,
                                  long long rows, int h, float eps,
                                  int gemma_style, void* stream) {
  if (rows == 0) return 0;
  const int vec = (h % 8 == 0) &&
                  (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(scale) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int work = vec ? h / 8 : h;
  int threads = ((work + 31) / 32) * 32;
  threads = threads < 32 ? 32 : (threads > 256 ? 256 : threads);
  rmsnorm_kernel<<<(unsigned)rows, threads, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(scale),
      static_cast<__nv_bfloat16*>(out), h, eps, gemma_style, vec);
  return (int)cudaGetLastError();
}
