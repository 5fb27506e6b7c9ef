// Fused descriptor matcher for Hopper (sm_90a): exact uint8 dot products on
// the int8 tensor cores, forward running top-2 per query row and reverse
// argmax per target column, in one sweep over the targets.
//
// Replaces the TPU kernels colmap_tpu/features/pallas_matcher.py
// `_matcher_kernel` and `_matcher_kernel_bf16` (the same function; the bf16
// variant only existed for one TPU compiler's lowering). Bound in
// colmap_tpu_torch/features/hopper_matcher.py, whose `_top2_fwd_rev_reference`
// is the plain PyTorch twin.
//
// What bounds it on this card (H100 SXM, 1,979 TOP/s int8, 3.35 TB/s):
//   B=8, N=M=8192: 2*128*B*N*M = 137.4 G int8 operations, 0.069 ms; the
//     descriptors are 16.8 MB, the reverse partials 2 x 67 MB (0.045 ms).
//     The products bound it.
//   B=190, N=M=1024: 51.0 G operations, 0.026 ms; 49.8 MB of descriptors
//     plus 2 x 24.9 MB of partials, 0.030 ms. Memory bounds it.
// What limits it, now that the products run on the tensor cores, is the
// epilogue (bench_matcher.py --ablate times each part alone; numbers in
// PERF.md): per similarity one add and two multiplies, a top-2 push (a
// compare, three min/max, a select) and a reverse compare (a compare, two
// selects); compares, min/max and selects issue at 64 a clock per SM, half
// the FP32 rate. The products alone take well under half the kernel's time.
// The design:
//   - Products: mma.sync.m16n8k32 s8 x s8 -> s32 (exact). Both operands are
//     K-contiguous rows of 128 bytes, which is the row.col operand layout,
//     so no transpose. A CTA owns 128 query rows (two 64-row halves of the
//     partial buffer), so each target tile read from L2 feeds 128 rows; its
//     8 warps each hold a 32 x 32 tile of a 128 x 64 tile of similarities,
//     and keep their query A fragments in registers for the whole sweep.
//   - Targets: a cp.async double buffer of 64-row tiles in shared memory,
//     rows padded to 144 bytes so one ldmatrix (8 rows of 16 bytes) hits
//     every bank group once.
//   - Epilogue: the row half of the correction is the accumulators' start
//     value and carries the bits of 2^23, so the accumulator read as a
//     float is 2^23 plus a non-negative integer below 2^23; one float add
//     of the column term removes the bias exactly (no I2F, which issues at
//     16 a clock). Masks are predicates: masked columns are never pushed
//     and masked rows never become reverse candidates.
//   - Reverse: each thread keeps the best of its 4 rows per column; the
//     32 candidates of a column go through shared memory and are merged by
//     2 threads per column and 64-row half. Two passes: each CTA writes one
//     (best, row) per column and half to a (B, N/64, M) buffer; a second
//     kernel reduces over the halves. A single-pass atomic reverse would
//     save the partials' traffic, which matters only within 2x of the bound.
//
// Semantics held bit-for-bit against the twin:
//   sim = (dot_c + 128*rs1 + 128*rs2 - 128^3) * (inv1 * inv2)
// where the sum before the product is the exact uint8 dot product (an
// integer in [0, 255^2 * 128] < 2^23, exact in f32 in any order); masked
// entries are -3e38 (the TPU kernel's sentinel); every argmax resolves ties
// to the lowest index.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (never --use_fast_math: the products must stay IEEE).
// -DMATCHER_SKIP_EPILOGUE / -DMATCHER_SKIP_PRODUCTS build wrong-answer
// variants that only bench_matcher.py --ablate times.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;        // target columns per tile; rows per partial
constexpr int kRowsCta = 128;    // query rows per CTA: two 64-row halves
constexpr int kThreads = 256;    // 8 warps: 4 along the rows x 2 along columns
constexpr int kWR = 4;
constexpr int kWC = 2;
constexpr int kMT = 2;           // 16-row mma tiles per warp: 32 rows
constexpr int kNT = 4;           // 8-column mma tiles per warp: 32 columns
constexpr int kRows = 2 * kMT;   // query rows a thread holds
constexpr int kSlots = 8 * kWR;  // reverse candidates per column (warp, group)
constexpr int kSlotStride = kSlots + 2;  // conflict-free 8-byte stores
constexpr int kRowBytes = 144;   // 128 + 16: conflict-free ldmatrix
constexpr int kStageBytes = kTile * kRowBytes;
constexpr int kStages = 2;       // target tiles in flight in shared memory
constexpr float kNeg = -3.0e38f;
// row term = 128*rs1 + 2^21 + bits(2^23), the accumulators' start value:
// dot_c + row term lies in [2^23 + 16384, 2^23 + 8339584], so read as a
// float it is 2^23 plus that integer, exactly.
constexpr int kRowBias = (1 << 21) + 0x4B000000;
// column term = 128*rs2 - 2^21 (the 128^3 of the correction) - 2^21 (the
// row term's bias) - 2^23 (the float's implicit bit)
constexpr float kColBias = -12582912.0f;

static_assert(kWR * kWC * 32 == kThreads, "warp grid");
static_assert(kWR * 16 * kMT == kRowsCta && kWC * 8 * kNT == kTile, "tiles");

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

__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  // ties go to the lower row
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until the oldest tile has landed: the kStages - 1 newer copy groups
// may still be in flight
__device__ __forceinline__ void cp_async_wait_tile() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kStages - 1) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, int& r0, int& r1,
                                            int& r2, int& r3) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

// D = A (16x32 s8, row) * B (32x8 s8, col) + C, int32. Lane (g = lane/4,
// t = lane%4) holds A rows g / g+8 at k bytes 4t and 16+4t, B column g at
// k bytes 4t and 16+4t, and C / D rows g / g+8 at columns 2t, 2t+1.
__device__ __forceinline__ void mma_s8(int (&d)[4], const int (&a)[4],
                                       int b0, int b1, const int (&c)[4]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
}

__global__ void __launch_bounds__(kThreads, 2)
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
  __shared__ __align__(128) int8_t b_s[kStages][kStageBytes];
  __shared__ __align__(16) float rs2_s[kStages][kTile];
  __shared__ __align__(16) float inv2_s[kStages][kTile];
  __shared__ __align__(16) uint8_t val2_s[kStages][kTile];
  // reverse candidates (value, CTA row) per column and (row warp, group)
  __shared__ __align__(16) float2 cand[kTile * kSlotStride];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // mma group: rows g, g+8; column g of B
  const int t4 = lane & 3;  // thread in group: columns 2*t4, 2*t4+1 of D
  const int wr = warp / kWC;
  const int wc = warp % kWC;
  const int wrow0 = wr * 16 * kMT;  // the warp's first row in the CTA
  const int wcol0 = wc * 8 * kNT;   // the warp's first column in a tile
  const long long b = blockIdx.y;
  const int row0 = blockIdx.x * kRowsCta;
  const int n_half = min(2, (N - row0) / kTile);  // 64-row halves present
  const int8_t* c2b = c2 + b * M * 128;

  // tile loads: the 64 target rows are 512 contiguous 16-byte chunks; this
  // thread copies chunks tid and tid + 256 to their padded places, and
  // threads 0-35 one chunk of the tile's row sums, norms or flags
  static_assert(kTile * 8 == 2 * kThreads, "two chunks a thread");
  const int8_t* c2_src = c2 + b * M * 128 + tid * 16;
  const unsigned b_dst =
      smem_addr(b_s[0]) + (tid >> 3) * kRowBytes + (tid & 7) * 16;
  constexpr unsigned kHalfTileDst = (kThreads / 8) * kRowBytes;
  const char* col_src = nullptr;
  unsigned col_dst = 0;
  int col_scale = 4;  // bytes per column of the array this thread copies
  if (tid < 16) {
    col_src = reinterpret_cast<const char*>(rs2 + b * M) + tid * 16;
    col_dst = smem_addr(&rs2_s[0][tid * 4]);
  } else if (tid < 32) {
    col_src = reinterpret_cast<const char*>(inv2 + b * M) + (tid - 16) * 16;
    col_dst = smem_addr(&inv2_s[0][(tid - 16) * 4]);
  } else if (tid < 36) {
    col_src = reinterpret_cast<const char*>(val2 + b * M) + (tid - 32) * 16;
    col_dst = smem_addr(&val2_s[0][(tid - 32) * 16]);
    col_scale = 1;
  }
  const unsigned col_stage = tid < 16 ? sizeof(rs2_s[0])
                             : tid < 32 ? sizeof(inv2_s[0])
                                        : sizeof(val2_s[0]);
  auto load_tile = [&](int stage, int col0) {
    const int8_t* src = c2_src + (long long)col0 * 128;
    const unsigned dst = b_dst + stage * kStageBytes;
    cp_async16(dst, src);
    cp_async16(dst + kHalfTileDst, src + kThreads * 16);
    if (tid < 36) cp_async16(col_dst + stage * col_stage,
                             col_src + col0 * col_scale);
  };

  const int n_tiles = M / kTile;
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < n_tiles) load_tile(p, p * kTile);
    cp_async_commit();
  }

  // the thread's query rows: q = 2*mt + h is CTA row wrow0 + 16*mt + 8*h + g
  auto cta_row = [&](int q) { return wrow0 + 8 * q + g; };
  // query A fragments for the whole sweep: [m tile][k step of 32][register]
  int afrag[kMT][4][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // a partial last CTA reads row N-1
        const int r = min(row0 + cta_row(2 * mt + (i & 1)), N - 1);
        afrag[mt][ks][i] = *reinterpret_cast<const int*>(
            c1 + (b * N + r) * 128 + ks * 32 + (i >> 1) * 16 + t4 * 4);
      }
    }
  }
  int row_c[kMT][4];  // the accumulators' start: row terms in D's layout
  float inv_a[kRows];
  bool val_a[kRows];
  float best[kRows], second[kRows];
  int idx[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const long long r = b * N + min(row0 + cta_row(q), N - 1);
    const int term = __float2int_rn(rs1[r]) * 128 + kRowBias;
    row_c[q >> 1][2 * (q & 1)] = term;
    row_c[q >> 1][2 * (q & 1) + 1] = term;
    inv_a[q] = inv1[r];
    val_a[q] = val1[r] != 0;
    // masked columns are never pushed; the sentinel stands in for them
    best[q] = kNeg;
    second[q] = kNeg;
    idx[q] = 0;
  }
  // the reverse reduction: thread (h, column, part) merges the candidates
  // of row warp 2h + part for one column of the tile
  const int red_part = tid & 1;
  const int red_col = (tid >> 1) & (kTile - 1);
  const int red_h = tid >> 7;

  int st = 0;               // the stage of tile t
  int ld = kStages - 1;     // the stage of tile t + kStages - 1
#pragma unroll 2
  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) load_tile(ld, (t + kStages - 1) * kTile);
    cp_async_commit();
    cp_async_wait_tile();
    __syncthreads();  // tile t is in shared memory for every thread

    int acc[kMT][kNT][4];
    const unsigned bbase = smem_addr(b_s[st]) +
                           (wcol0 + (lane & 7)) * kRowBytes + (lane >> 3) * 16;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      int bf[4][2];  // [k step][register]
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {  // bytes 64*kh .. 64*kh+63
        ldmatrix_x4(bbase + nt * 8 * kRowBytes + kh * 64, bf[2 * kh][0],
                    bf[2 * kh][1], bf[2 * kh + 1][0], bf[2 * kh + 1][1]);
      }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#ifdef MATCHER_SKIP_PRODUCTS  // a measurement build: no products
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = row_c[mt][i] + bf[i][0];
#else
        mma_s8(acc[mt][nt], afrag[mt][0], bf[0][0], bf[0][1], row_c[mt]);
#pragma unroll
        for (int ks = 1; ks < 4; ++ks)
          mma_s8(acc[mt][nt], afrag[mt][ks], bf[ks][0], bf[ks][1],
                 acc[mt][nt]);
#endif
      }
    }

#ifdef MATCHER_SKIP_EPILOGUE  // a measurement build: products only
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) idx[0] ^= acc[mt][nt][i];
#else
    const int col0 = t * kTile;
    const int jbase = col0 + wcol0 + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      // the thread's two columns of this mma tile, 2*t4 and 2*t4+1
      const int jl = wcol0 + nt * 8 + 2 * t4;
      const float2 rs_b = *reinterpret_cast<const float2*>(&rs2_s[st][jl]);
      const float2 inv_b2 = *reinterpret_cast<const float2*>(&inv2_s[st][jl]);
      const unsigned val_b2 =
          *reinterpret_cast<const unsigned short*>(&val2_s[st][jl]);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        // exact: 128*rs2 and the bias are integers below 2^24
        const float col_term = fmaf(c ? rs_b.y : rs_b.x, 128.0f, kColBias);
        const float inv_b = c ? inv_b2.y : inv_b2.x;
        const bool val_b = (val_b2 >> (8 * c)) & 0xffu;
        float rv = -CUDART_INF_F;  // stays so if the 4 rows are masked
        int rq = 0;  // 8*q: the row's offset from the thread's first row
#pragma unroll
        for (int q = 0; q < kRows; ++q) {
          // exact: the uint8 dot product, an integer below 2^23
          const float d =
              __fadd_rn(__int_as_float(acc[q >> 1][nt][2 * (q & 1) + c]),
                        col_term);
          const float s = __fmul_rn(d, __fmul_rn(inv_a[q], inv_b));
          // forward: columns arrive in increasing order, so strict >
          // keeps the first maximum
          if (val_b && s > best[q]) idx[q] = jbase + nt * 8 + c;
          if (val_b) {
            second[q] = fmaxf(second[q], fminf(s, best[q]));
            best[q] = fmaxf(best[q], s);
          }
          // reverse: rows increase with q, so strict > keeps the first
          if (q == 0) {
            rv = val_a[0] ? s : -CUDART_INF_F;
          } else if (val_a[q] && s > rv) {
            rv = s;
            rq = 8 * q;
          }
        }
        cand[(jl + c) * kSlotStride + wr * 8 + g] =
            make_float2(rv, __int_as_float(cta_row(0) + rq));
      }
    }
    __syncthreads();  // every candidate is in; stage st is read
    {
      // masked rows never become candidates: a half with no valid row
      // keeps the sentinel and its first row, as the twin's argmax does
      float v = kNeg;
      int i = red_h * kTile;
      const float4* cp = reinterpret_cast<const float4*>(
          &cand[red_col * kSlotStride + (2 * red_h + red_part) * 8]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 e = cp[k];
        argmax_merge(v, i, e.x, __float_as_int(e.y));
        argmax_merge(v, i, e.z, __float_as_int(e.w));
      }
      argmax_merge(v, i, __shfl_xor_sync(0xffffffffu, v, 1),
                   __shfl_xor_sync(0xffffffffu, i, 1));
      if (red_part == 0 && red_h < n_half) {
        const long long o =
            (b * (N / kTile) + row0 / kTile + red_h) * M + col0 + red_col;
        pbest[o] = v;
        pidx[o] = row0 + i;
      }
    }
#endif
    st = st + 1 == kStages ? 0 : st + 1;
    ld = ld + 1 == kStages ? 0 : ld + 1;
  }

  // merge the 4 lanes of each row (t4 = 0..3), then the kWC column warps
  // through shared memory that held the candidates
  static_assert(3 * kWC * kRowsCta <= 2 * kTile * kSlotStride, "fits");
  float(*fb_s)[kRowsCta] = reinterpret_cast<float(*)[kRowsCta]>(cand);
  float(*fs_s)[kRowsCta] = fb_s + kWC;
  int(*fi_s)[kRowsCta] = reinterpret_cast<int(*)[kRowsCta]>(fb_s + 2 * kWC);
  __syncthreads();  // the last tile's candidates are read
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[q], off);
      const float os = __shfl_xor_sync(0xffffffffu, second[q], off);
      const int oi = __shfl_xor_sync(0xffffffffu, idx[q], off);
      top2_merge(best[q], second[q], idx[q], ob, os, oi);
    }
    if (t4 == 0) {
      fb_s[wc][cta_row(q)] = best[q];
      fs_s[wc][cta_row(q)] = second[q];
      fi_s[wc][cta_row(q)] = idx[q];
    }
  }
  __syncthreads();
  if (tid < kRowsCta && tid < n_half * kTile) {
    float bv = fb_s[0][tid], sv = fs_s[0][tid];
    int bi = fi_s[0][tid];
#pragma unroll
    for (int w = 1; w < kWC; ++w) {
      top2_merge(bv, sv, bi, fb_s[w][tid], fs_s[w][tid], fi_s[w][tid]);
    }
    const long long r = b * N + row0 + tid;
    fbest[r] = bv;
    fsecond[r] = sv;
    fidx[r] = bi;
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
// row sums / inverse norms (B, N|M) f32, valid flags (B, N|M) as bytes, all
// 16-byte aligned. Outputs: forward best / second / index (B, N); reverse
// best / index (B, M). Scratch: pbest / pidx (B, N/64, M). N and M are
// multiples of 64. Returns the cudaError_t of the launches (0 on success).
extern "C" int matcher_top2_fwd_rev(
    const void* c1, const void* c2, const void* rs1, const void* inv1,
    const void* val1, const void* rs2, const void* inv2, const void* val2,
    int B, int N, int M, void* fbest, void* fsecond, void* fidx, void* pbest,
    void* pidx, void* rbest, void* ridx, void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid((N + kRowsCta - 1) / kRowsCta, B);
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
