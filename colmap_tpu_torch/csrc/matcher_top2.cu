// Fused descriptor matcher for Hopper (sm_90a): exact uint8 dot products,
// forward running top-2 per query row and reverse argmax per target column,
// in one sweep over the targets.
//
// Replaces the TPU kernels colmap_tpu/features/pallas_matcher.py
// `_matcher_kernel` and `_matcher_kernel_bf16` (the same function; the bf16
// variant only existed for one TPU compiler's lowering). Bound in
// colmap_tpu_torch/features/hopper_matcher.py, whose `_top2_fwd_rev_reference`
// is the plain PyTorch twin.
//
// What bounds it on this card. At N = M = 8192 the work is the int8 dot
// products (2*128 operations per similarity): the int8 tensor-core rate is
// the ceiling. At small N the reverse partial buffer (8 bytes per column per
// 64-row query tile) is what moves through memory. The simple design answers
// both with a single sweep over M per CTA (each query tile reads every target
// tile once from L2, the similarity tile never leaves registers, the forward
// top-2 lives in registers for the whole sweep) and a two-pass reverse: each
// CTA writes one (best, index) per column of its query tile, and a second
// small kernel reduces over the query tiles. Dot products use __dp4a, which
// is exact; wgmma / TMA and a single-pass reverse are later work.
//
// Semantics held bit-for-bit against the twin:
//   sim = (dot_c + 128*rs1 + 128*rs2 - 128^3) * (inv1 * inv2)
// where every term before the product is an integer below 2^24 (exact in
// f32 in any order); masked entries are -3e38 (the TPU kernel's sentinel);
// every argmax resolves ties to the lowest index.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (never --use_fast_math: the products must stay IEEE).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows and target columns per tile
constexpr int kWords = 32;     // 128 int8 values = 32 int32 words
constexpr int kStride = 33;    // padded shared-memory row stride (no bank conflicts)
constexpr int kThreads = 256;  // 16 row groups x 16 column groups, 4x4 each
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ void top2_push(float s, int j, float& best,
                                          float& second, int& idx) {
  // columns arrive in increasing order: strict > keeps the first maximum
  if (s > best) {
    second = best;
    best = s;
    idx = j;
  } else if (s > second) {
    second = s;
  }
}

__device__ __forceinline__ void top2_merge(float& best, float& second,
                                           int& idx, float ob, float os,
                                           int oi) {
  // merge of disjoint column sets; ties in best go to the lower index
  const bool take = (ob > best) || (ob == best && oi < idx);
  const float ns = fmaxf(fminf(best, ob), fmaxf(second, os));
  best = fmaxf(best, ob);
  second = ns;
  idx = take ? oi : idx;
}

__global__ void __launch_bounds__(kThreads)
matcher_sweep_kernel(const int8_t* __restrict__ c1,
                     const int8_t* __restrict__ c2,
                     const float* __restrict__ rs1,
                     const float* __restrict__ inv1,
                     const uint8_t* __restrict__ val1,
                     const float* __restrict__ rs2,
                     const float* __restrict__ inv2,
                     const uint8_t* __restrict__ val2, int N, int M,
                     float* __restrict__ fbest, float* __restrict__ fsecond,
                     int* __restrict__ fidx, float* __restrict__ pbest,
                     int* __restrict__ pidx) {
  __shared__ int a_s[kTile * kStride];
  __shared__ int b_s[kTile * kStride];
  __shared__ float rs2_s[kTile];
  __shared__ float inv2_s[kTile];
  __shared__ uint8_t val2_s[kTile];
  __shared__ float red_b[kThreads / 16][kTile];
  __shared__ int red_i[kThreads / 16][kTile];

  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // row group: rows rg*4 .. rg*4+3
  const int cg = tid & 15;  // column group: columns cg + 16*c, c = 0..3
  const int ntile = blockIdx.x;
  const long long b = blockIdx.y;
  const int row0 = ntile * kTile;

  const int* c1w = reinterpret_cast<const int*>(c1 + (b * N + row0) * 128);
  for (int e = tid; e < kTile * kWords; e += kThreads) {
    a_s[(e >> 5) * kStride + (e & 31)] = c1w[e];
  }
  float rs_a[4], inv_a[4];
  bool val_a[4];
  float best[4], second[4];
  int idx[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const long long r = b * N + row0 + rg * 4 + q;
    rs_a[q] = rs1[r];
    inv_a[q] = inv1[r];
    val_a[q] = val1[r] != 0;
    best[q] = -CUDART_INF_F;
    second[q] = -CUDART_INF_F;
    idx[q] = 0;
  }

  for (int col0 = 0; col0 < M; col0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    const int* c2w = reinterpret_cast<const int*>(c2 + (b * M + col0) * 128);
    for (int e = tid; e < kTile * kWords; e += kThreads) {
      b_s[(e >> 5) * kStride + (e & 31)] = c2w[e];
    }
    if (tid < kTile) {
      rs2_s[tid] = rs2[b * M + col0 + tid];
      inv2_s[tid] = inv2[b * M + col0 + tid];
      val2_s[tid] = val2[b * M + col0 + tid];
    }
    __syncthreads();

    int acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[q][c] = 0;

#pragma unroll 8
    for (int k = 0; k < kWords; ++k) {
      int av[4], bv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) av[q] = a_s[(rg * 4 + q) * kStride + k];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = b_s[(cg + 16 * c) * kStride + k];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[q][c] = __dp4a(av[q], bv[c], acc[q][c]);
    }

#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int jl = cg + 16 * c;
      const int j = col0 + jl;
      const float rs_b = rs2_s[jl];
      const float inv_b = inv2_s[jl];
      const bool val_b = val2_s[jl] != 0;
      float rev_b = -CUDART_INF_F;
      int rev_i = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        // exact: every term and partial sum is an integer below 2^24
        const float d = (float)acc[q][c] + 128.0f * rs_a[q] + 128.0f * rs_b
                        - 2097152.0f;
        const float s = d * (inv_a[q] * inv_b);
        top2_push(val_b ? s : kNeg, j, best[q], second[q], idx[q]);
        const float r = val_a[q] ? s : kNeg;
        if (r > rev_b) {  // rows increase with q: first maximum kept
          rev_b = r;
          rev_i = row0 + rg * 4 + q;
        }
      }
      red_b[rg][jl] = rev_b;
      red_i[rg][jl] = rev_i;
    }
    __syncthreads();
    if (tid < kTile) {
      float bv = red_b[0][tid];
      int bi = red_i[0][tid];
      for (int g = 1; g < kThreads / 16; ++g) {
        const float v = red_b[g][tid];
        if (v > bv) {
          bv = v;
          bi = red_i[g][tid];
        }
      }
      const long long o = (b * (N / kTile) + ntile) * M + col0 + tid;
      pbest[o] = bv;
      pidx[o] = bi;
    }
  }

  // merge the 16 column groups of each row (lanes rg*16 .. rg*16+15)
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[q], off);
      const float os = __shfl_xor_sync(0xffffffffu, second[q], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[q], off);
      top2_merge(best[q], second[q], idx[q], ob, os, oi);
    }
    if (cg == 0) {
      const long long r = b * N + row0 + rg * 4 + q;
      fbest[r] = best[q];
      fsecond[r] = second[q];
      fidx[r] = idx[q];
    }
  }
}

__global__ void matcher_reverse_reduce_kernel(const float* __restrict__ pbest,
                                              const int* __restrict__ pidx,
                                              int B, int n_tiles, int M,
                                              float* __restrict__ rbest,
                                              int* __restrict__ ridx) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)B * M) return;
  const long long b = t / M;
  const long long j = t % M;
  const float* pb = pbest + b * n_tiles * M + j;
  const int* pi = pidx + b * n_tiles * M + j;
  float bv = pb[0];
  int bi = pi[0];
  for (int n = 1; n < n_tiles; ++n) {  // query tiles in order: first max kept
    const float v = pb[(long long)n * M];
    if (v > bv) {
      bv = v;
      bi = pi[(long long)n * M];
    }
  }
  rbest[t] = bv;
  ridx[t] = bi;
}

}  // namespace

// Plain C entry point. Inputs: c1 (B, N, 128) and c2 (B, M, 128) int8,
// row sums / inverse norms (B, N|M) f32, valid flags (B, N|M) as bytes.
// Outputs: forward best / second / index (B, N); reverse best / index
// (B, M). Scratch: pbest / pidx (B, N/64, M). N and M are multiples of 64.
// Returns the cudaError_t of the launches (0 on success).
extern "C" int matcher_top2_fwd_rev(
    const void* c1, const void* c2, const void* rs1, const void* inv1,
    const void* val1, const void* rs2, const void* inv2, const void* val2,
    int B, int N, int M, void* fbest, void* fsecond, void* fidx, void* pbest,
    void* pidx, void* rbest, void* ridx, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(N / kTile, B);
  matcher_sweep_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const int8_t*>(c1), static_cast<const int8_t*>(c2),
      static_cast<const float*>(rs1), static_cast<const float*>(inv1),
      static_cast<const uint8_t*>(val1), static_cast<const float*>(rs2),
      static_cast<const float*>(inv2), static_cast<const uint8_t*>(val2), N,
      M, static_cast<float*>(fbest), static_cast<float*>(fsecond),
      static_cast<int*>(fidx), static_cast<float*>(pbest),
      static_cast<int*>(pidx));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = (long long)B * M;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  matcher_reverse_reduce_kernel<<<blocks, threads, 0, s>>>(
      static_cast<const float*>(pbest), static_cast<const int*>(pidx), B,
      N / kTile, M, static_cast<float*>(rbest), static_cast<int*>(ridx));
  return static_cast<int>(cudaGetLastError());
}
