// Grouped expert matmul (GMM), bf16 in and out with fp32 accumulation, for
// sm_90a.
//
// Replaces: src/repro/kernels/moe_gmm.py, gmm_pallas / _gmm_kernel (the
// Pallas TPU kernel: lhs (M, K) rows grouped by expert in blocks of
// block_m, rhs (E, K, N), a scalar-prefetched expert_map naming each row
// block's expert, K held whole in VMEM).
//
// Bound on the H100: device memory at the token counts of one training
// step.  At DeepSeek-v3 widths with 4096 tokens (E = 256, C = 160, so
// M = 40960) one gate/up call reads 7.5 GB of expert weights, about 2.5 ms
// at 3.35 TB/s, against 1.2 TFLOP (1.2 ms at 989 TFLOP/s).
//
// Design (a simple, correct first kernel; wgmma/TMA are later work):
// * one block of eight warps per (64-row tile of one expert's row group,
//   128-column tile); each block reads its own expert id from expert_map,
//   which takes the place of the TPU's scalar prefetch.
// * K is walked in chunks of 32 through a two-stage cp.async ring in
//   shared memory (the TPU kernel kept K whole in VMEM; 227 KB of shared
//   memory cannot hold a 7168-deep tile), so the next chunk's copy overlaps
//   the current chunk's products.
// * the products are 16x16x16 bf16 WMMA tensor-core operations with fp32
//   accumulators, each warp owning a 32x32 piece of the 64x128 tile.
// * block_m need not be a multiple of 64 (C = 160 and C = 40 are not):
//   rows past the end of a group load as zeros and are not stored, so no
//   tile ever mixes two experts.  Columns and K past the matrix edge are
//   masked the same way.
// * blocks are ordered so the row tiles of one (group, column tile) run
//   side by side, which keeps that expert's weight slab in L2 while they
//   read it.
// * an expert id outside [0, E) fills the tile with NaN instead of reading
//   outside rhs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 128, BKC = 32;
constexpr int THREADS = 256;  // 8 warps: 2 along M x 4 along N
constexpr int LDA = BKC + 8;  // bf16 leading dims with 16-byte padding
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;   // fp32 staging for the epilogue
constexpr int A_STAGE = BM * LDA;    // elements
constexpr int B_STAGE = BKC * LDB;
constexpr int PIPE_BYTES = 2 * (A_STAGE + B_STAGE) * 2;
constexpr int EPI_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

__device__ __forceinline__ void cp_async16(void* smem_ptr, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_ptr));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(THREADS)
gmm_kernel(const __nv_bfloat16* __restrict__ lhs,
           const __nv_bfloat16* __restrict__ rhs,
           const int* __restrict__ expert_map, __nv_bfloat16* __restrict__ out,
           int K, int N, int E, int block_m) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + 2 * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem);

  const int tiles_per_group = (block_m + BM - 1) / BM;
  const int n_col_tiles = (N + BN - 1) / BN;
  int lin = blockIdx.x;
  const int t = lin % tiles_per_group;
  lin /= tiles_per_group;
  const int ct = lin % n_col_tiles;
  const int g = lin / n_col_tiles;

  const long long group_end = (long long)(g + 1) * block_m;
  const long long row0 = (long long)g * block_m + (long long)t * BM;
  const int col0 = ct * BN;
  const int e = expert_map[g];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;

  if (e < 0 || e >= E) {
    const __nv_bfloat16 nan = __float2bfloat16(__int_as_float(0x7fc00000));
    for (int i = tid; i < BM * BN; i += THREADS) {
      const long long rr = row0 + i / BN;
      const int cc = col0 + i % BN;
      if (rr < group_end && cc < N) out[rr * N + cc] = nan;
    }
    return;
  }
  const __nv_bfloat16* B = rhs + (long long)e * K * N;

  auto load_stage = [&](int kc, int stage) {
    const int k0 = kc * BKC;
    {  // A: 64 rows x 32 columns = 256 chunks of 8, one per thread
      const int r = tid >> 2, c = (tid & 3) * 8;
      const long long gr = row0 + r;
      const bool ok = gr < group_end && k0 + c < K;
      const __nv_bfloat16* src = ok ? lhs + gr * K + k0 + c : lhs;
      cp_async16(As + stage * A_STAGE + r * LDA + c, src, ok);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // B: 32 rows x 128 columns = 512 chunks
      const int chunk = tid + i * THREADS;
      const int r = chunk >> 4, c = (chunk & 15) * 8;
      const bool ok = k0 + r < K && col0 + c < N;
      const __nv_bfloat16* src = ok ? B + (long long)(k0 + r) * N + col0 + c
                                    : rhs;
      cp_async16(Bs + stage * B_STAGE + r * LDB + c, src, ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int n_kc = (K + BKC - 1) / BKC;
  load_stage(0, 0);
  cp_async_commit();
  for (int kc = 0; kc < n_kc; ++kc) {
    if (kc + 1 < n_kc) {
      load_stage(kc + 1, (kc + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* Ast = As + (kc & 1) * A_STAGE;
    const __nv_bfloat16* Bst = Bs + (kc & 1) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], Ast + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], Bst + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: fp32 tile through shared memory, masked bf16 stores
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int chunk = tid; chunk < BM * BN / 8; chunk += THREADS) {
    const int r = chunk / (BN / 8), c = (chunk % (BN / 8)) * 8;
    const long long gr = row0 + r;
    if (gr >= group_end || col0 + c >= N) continue;
    const float* src = Cs + r * LDC + c;
    uint4 o;
    __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      po[i] = __floats2bfloat162_rn(src[2 * i], src[2 * i + 1]);
    *reinterpret_cast<uint4*>(out + gr * N + col0 + c) = o;
  }
}

}  // namespace

extern "C" int repro_gmm_bf16(const void* lhs, const void* rhs,
                              const void* expert_map, void* out,
                              long long M, int K, int N, int E, int block_m,
                              void* stream) {
  if (M == 0 || N == 0) return 0;
  const long long groups = M / block_m;
  const long long blocks = groups * ((block_m + BM - 1) / BM) *
                           ((N + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  gmm_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(lhs),
      static_cast<const __nv_bfloat16*>(rhs),
      static_cast<const int*>(expert_map), static_cast<__nv_bfloat16*>(out),
      K, N, E, block_m);
  return (int)cudaGetLastError();
}
