// Causal flash attention with q/k head dim dq != v head dim dv (MLA), bf16
// in and out, for sm_90a.
//
// Replaces: src/repro/kernels/mla_attention.py, flash_attention_pallas /
// _flash_kernel (the Pallas TPU kernel: grid (b*n_h, q blocks), a loop over
// k blocks up to the causal frontier carrying fp32 (m, l, acc) in VMEM).
//
// Bound on the H100: tensor-core operations.  At DeepSeek-v3 widths
// (n_h = 128, dq = 192, dv = 128, s = 4096) the causal half of QK^T and PV
// is 0.69 TFLOP, about 0.69 ms at 989 TFLOP/s, against 0.4 GB of q/k/v/out
// (0.12 ms at 3.35 TB/s).
//
// Design (a simple, correct first kernel; wgmma/TMA are later work):
// * one block of four warps per (64-row q tile, batch*head); the heaviest
//   causal tiles are launched first.  Blocks share nothing, so the TPU
//   grid's sequential q dimension needs no carry.
// * q, k and v are read in their (b, s, n_h, d) layout through strides, so
//   no transpose copy is made, and a ragged last tile is masked (rows past
//   s load as zeros, keys past s score NEG_INF) instead of padding s.
// * each warp owns 16 query rows.  S = Q K^T and O += P V run on the tensor
//   cores as 16x16x16 bf16 WMMA products with fp32 accumulation; the online
//   softmax runs in fp32 on the warp's own rows (two lanes per row), so only
//   the K/V tile loads need block barriers.
// * numerics follow the TPU kernel: fp32 scores times `scale` (the TPU
//   kernel scales q in fp32 before an fp32 dot; scaling the fp32 product of
//   the exact bf16 inputs is the same up to one fp32 rounding), NEG_INF =
//   -2^30 for masked keys, fp32 running max/sum, output acc / max(l, 1e-20).
//   P is rounded to bf16 for the PV product, as tensor cores require.
// * shared memory holds the Q, K and V tiles, the fp32 scores, P, and the
//   fp32 output accumulator (126 KB at dq = 192, dv = 128), above the 48 KB
//   static limit, so the launcher raises cudaFuncAttributeMaxDynamicSharedMemorySize.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;   // query rows per block (16 per warp)
constexpr int BK = 64;   // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1073741824.0f;  // -2^30, as in the TPU kernel
constexpr int PAD_H = 8;  // bf16 row padding (16 bytes) against bank conflicts
constexpr int PAD_F = 4;  // fp32 row padding (16 bytes)

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* out;
  long long q_sb, q_ss, q_sh;  // element strides of q (last dim contiguous)
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int s, nh, dq, dv, causal;
  float scale;
};

struct Layout {
  int ldq, ldv, lds, ldp, ldo;
  size_t q_off, k_off, v_off, s_off, p_off, o_off, bytes;
};

__host__ __device__ inline Layout make_layout(int dq, int dv) {
  Layout L;
  L.ldq = dq + PAD_H;
  L.ldv = dv + PAD_H;
  L.lds = BK + PAD_F;
  L.ldp = BK + PAD_H;
  L.ldo = dv + PAD_F;
  L.q_off = 0;
  L.k_off = L.q_off + (size_t)BQ * L.ldq * 2;
  L.v_off = L.k_off + (size_t)BK * L.ldq * 2;
  L.s_off = L.v_off + (size_t)BK * L.ldv * 2;
  L.p_off = L.s_off + (size_t)BQ * L.lds * 4;
  L.o_off = L.p_off + (size_t)BQ * L.ldp * 2;
  L.bytes = L.o_off + (size_t)BQ * L.ldo * 4;
  return L;
}

// rows [row0, row0 + 64) of one head, d columns, into shared memory with
// leading dimension ld; rows at or past s are zero.  16-byte chunks.
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int ld,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int s, int d) {
  const int chunks = d / 8;
  for (int c = threadIdx.x; c < 64 * chunks; c += THREADS) {
    const int r = c / chunks, col = (c % chunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < s)
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) *
                                                      row_stride + col);
    *reinterpret_cast<uint4*>(dst + r * ld + col) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = make_layout(a.dq, a.dv);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q_off);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.k_off);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.v_off);
  float* Ss = reinterpret_cast<float*>(smem + L.s_off);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(smem + L.p_off);
  float* Os = reinterpret_cast<float*>(smem + L.o_off);

  const int n_qt = (a.s + BQ - 1) / BQ;
  const int qt = n_qt - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / a.nh, hd = bh % a.nh;
  const int q0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  const __nv_bfloat16* qb = a.q + b * a.q_sb + hd * a.q_sh;
  const __nv_bfloat16* kb = a.k + b * a.k_sb + hd * a.k_sh;
  const __nv_bfloat16* vb = a.v + b * a.v_sb + hd * a.v_sh;

  load_tile(Qs, L.ldq, qb, a.q_ss, q0, a.s, a.dq);
  for (int i = threadIdx.x; i < BQ * L.ldo; i += THREADS) Os[i] = 0.f;

  // this lane's softmax row (two lanes per row, each half of the columns)
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int q_pos = q0 + row;
  float m_i = NEG_INF, l_i = 0.f;

  const int n_kt = (a.s + BK - 1) / BK;
  int hi = n_kt;
  if (a.causal) {
    const int frontier = (q0 + BQ + BK - 1) / BK;
    hi = frontier < n_kt ? frontier : n_kt;
  }

  for (int kt = 0; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile fully consumed (and Q/O ready)
    load_tile(Ks, L.ldq, kb, a.k_ss, k0, a.s, a.dq);
    load_tile(Vs, L.ldv, vb, a.v_ss, k0, a.s, a.dv);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) wmma::fill_fragment(acc[j], 0.f);
      for (int kk = 0; kk < a.dq; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, Qs + warp * 16 * L.ldq + kk, L.ldq);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fb, Ks + j * 16 * L.ldq + kk, L.ldq);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < BK / 16; ++j)
        wmma::store_matrix_sync(Ss + warp * 16 * L.lds + j * 16, acc[j],
                                L.lds, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on this lane's half row
    {
      float* srow = Ss + row * L.lds;
      const int c0 = half * (BK / 2);
      float mx = NEG_INF;
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const int k_pos = k0 + c;
        float sv = srow[c] * a.scale;
        const bool ok = k_pos < a.s && (!a.causal || k_pos <= q_pos);
        sv = ok ? sv : NEG_INF;
        srow[c] = sv;
        mx = fmaxf(mx, sv);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_new = fmaxf(m_i, mx);
      const float alpha = expf(m_i - m_new);
      float sum = 0.f;
      __nv_bfloat16* prow = Ps + row * L.ldp;
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const float p = expf(srow[c] - m_new);
        sum += p;
        prow[c] = __float2bfloat16(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      l_i = l_i * alpha + sum;
      m_i = m_new;
      float* orow = Os + row * L.ldo;
      const int h2 = a.dv / 2;
      for (int c = half * h2; c < half * h2 + h2; ++c) orow[c] *= alpha;
    }
    __syncwarp();

    // O += P V for this warp's rows
    for (int n = 0; n < a.dv; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> o;
      wmma::load_matrix_sync(o, Os + warp * 16 * L.ldo + n, L.ldo,
                             wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fp;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fv;
        wmma::load_matrix_sync(fp, Ps + warp * 16 * L.ldp + kk, L.ldp);
        wmma::load_matrix_sync(fv, Vs + kk * L.ldv + n, L.ldv);
        wmma::mma_sync(o, fp, fv, o);
      }
      wmma::store_matrix_sync(Os + warp * 16 * L.ldo + n, o, L.ldo,
                              wmma::mem_row_major);
    }
    __syncwarp();
  }

  // out = acc / max(l, 1e-20) for the rows inside the sequence
  if (q_pos < a.s) {
    const float inv = 1.f / fmaxf(l_i, 1e-20f);
    const float* orow = Os + row * L.ldo;
    __nv_bfloat16* dst = a.out + b * a.o_sb + (long long)q_pos * a.o_ss +
                         hd * a.o_sh;
    const int h2 = a.dv / 2;
    for (int c = half * h2; c < half * h2 + h2; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(orow[c] * inv, orow[c + 1] * inv);
    }
  }
}

}  // namespace

extern "C" int repro_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* out, int b, int s,
    int nh, int dq, int dv, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, float scale, int causal, void* stream) {
  if (b == 0 || s == 0 || nh == 0) return 0;
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.q_sb = q_strides[0]; a.q_ss = q_strides[1]; a.q_sh = q_strides[2];
  a.k_sb = k_strides[0]; a.k_ss = k_strides[1]; a.k_sh = k_strides[2];
  a.v_sb = v_strides[0]; a.v_ss = v_strides[1]; a.v_sh = v_strides[2];
  a.o_sb = o_strides[0]; a.o_ss = o_strides[1]; a.o_sh = o_strides[2];
  a.s = s; a.nh = nh; a.dq = dq; a.dv = dv; a.causal = causal;
  a.scale = scale;
  const Layout L = make_layout(dq, dv);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + BQ - 1) / BQ, b * nh);
  flash_kernel<<<grid, THREADS, L.bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
