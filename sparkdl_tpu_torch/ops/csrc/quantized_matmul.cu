// Weight-only int8 matmul for Hopper (sm_90a): out = (x @ w_q) * scales.
//
// Replaces: sparkdl_tpu/ops/pallas/quantized_matmul.py, _qmm_kernel
// (called through quantized_matmul_pallas). Same arithmetic: x (M, K) in
// bf16 or fp32, w_q (K, N) int8 row-major, scales (N,) fp32; products
// accumulate in fp32 over K and the per-column scale is applied once,
// after the K sum; the output is written in x's dtype.
//
// What bounds it: at decode M is the slot count (8), so each weight byte
// feeds 2*M flops and the kernel is bound by the bytes of w_q
// (K*N int8 + 4N of scales). At prefill (M = the prompt bucket, up to
// 1024) it is bound by the 2*M*K*N operations.
//
// Routes, chosen by shape in the C entry point (never after a failure):
// - bf16 x with N a multiple of 16, K a multiple of 8 and x, w_q,
//   scales and out 16-byte aligned: the tensor cores (below), the GEMV at
//   M <= 8 and the GEMM above it;
// - fp32 x (the lm_head) and every other bf16 call: the CUDA cores
//   (qmm_kernel), since bf16 tensor cores cannot take fp32 x exactly.
//
// Tensor cores: bf16 operands, fp32 accumulators. An int8 is an exact
// bf16 and its product with a bf16 x is exact in fp32, so the tensor
// cores sum exact products; the column's fp32 scale multiplies the sum
// once, after K, as the TPU kernel does. Only the order of the fp32 sums
// differs from the plain version's x.f32 @ (w_q.f32 * s); w_q * s is
// never rounded to bf16. The conversion is exact for every int8, -128
// included: flip the sign bit (u = b ^ 0x80, unsigned 0..255), place u
// under the exponent of 2^23 with a byte permute, subtract 2^23 + 128 in
// fp32 (u - 128 = b), then keep each float's high half with one byte
// permute a pair (an integer of at most 8 significant bits has zeros in
// the low 16 bits of its fp32 form): 2.5 instructions a weight, no I2F.
// The product is turned around, out^T = W^T x^T, so the weights are the
// A operand (16 columns of N an mma) and x the B operand (8 rows of M).
// Decode (M <= 8, qmm_gemv_kernel), bound by bytes: mma.sync m16n8k16,
// so no lane is wasted at M = 8. A block of 8 warps on the same 128
// columns, each warp on its own k16 steps (split K inside the block),
// 2 blocks an SM. In the A fragment, lane 4g + t holds (row g, k 2t and
// 2t + 1) and (row g, k 2t + 8 and 2t + 9), and the same for row g + 8:
// the lane loads 16 neighbouring columns of K rows 2t, 2t + 1, 2t + 8 and
// 2t + 9 as four 16-byte non-allocating loads and so feeds 8 mma tiles:
// tile j's A row r stands for column 16 (r % 8) + 2j + r / 8 of the
// warp's 128, so a lane's C fragments hold exactly the 16 columns it
// loaded, and the epilogue writes them as two 16-byte stores a row. The
// loads of the next 2 k16 steps are issued before a step's products (a
// ring of 3 register buffers), so weight bytes stay in flight. The
// warps' sums meet in shared memory in a fixed order.
// Prefill (M > 8, qmm_gemm_kernel), bound by operations: one warpgroup
// a block, 64 columns by 128 rows of x, wgmma m64n128k16 with the
// converted weights as the register A operand and x as the K-major B
// operand in shared memory (128-byte swizzle). The block's threads copy
// each 64-row K step of x (16 KB) and of the weights (4 KB, rows padded
// to 80 bytes against bank conflicts) into a ring of 4 stages with
// cp.async, so a weight byte leaves the L2 once for 128 rows of x. Warp
// w converts the 16 columns 16 w .. 16 w + 15 (tile row g is column 2g,
// row g + 8 column 2g + 1), one k16 step ahead of the wgmma that reads
// them. Phase 3's prompt buckets (up to 1024 rows) are 1-8 row tiles.
// Where the (N, M) tiles alone would leave the SMs idle, K is also split
// over gridDim.z (qmm_plan), each split writes an fp32 partial and a
// second pass sums the splits in order, scales and casts: deterministic,
// no atomics. The ragged K tail (K a multiple of 8) loads zero x and
// zero weights and never reads past K.
//
// CUDA cores (qmm_kernel): a block owns BN = 256 columns, BM = 8 rows of
// x and one slice of K. Each of its 8 warps walks its own rows of that
// slice; each lane owns 8 neighbouring columns and reads them as one
// 8-byte load per weight row. The block stages x for CHUNK rows of K in
// shared memory as fp32, transposed so that one row's 8 x values are two
// 16-byte broadcast reads; each lane issues all RPW weight loads of its
// rows before it uses any, converts int8 to fp32 as above, and does 64
// FMAs per weight row; the warps' sums meet in shared memory. M tiles
// ride gridDim.y (W is re-read once per 8 rows of x). The ragged K tail
// stages as zeros; ragged N takes guarded byte loads; nothing is padded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 8;               // rows of x per block
constexpr int COLS = 8;             // columns per lane: one 8-byte load
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS; // 256
constexpr int BN = 32 * COLS;       // 256 columns per block
constexpr int CHUNK = 128;          // K rows of x staged at a time
constexpr int RPW = CHUNK / WARPS;  // weight rows per warp per chunk
constexpr int BLOCKS_PER_SM = 4;    // split K below this many blocks an SM

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Four int8 in a word -> four exact floats: flip each byte's sign bit
// (b + 128, unsigned), place it under the exponent of 2^23, subtract.
__device__ __forceinline__ void int8x4_to_f32(uint32_t v, float* f) {
  v ^= 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7653)) - 8388736.f;
}

__device__ __forceinline__ uint2 load_w8(const int8_t* row, int n0, int N,
                                         bool vec) {
  if (vec) return *reinterpret_cast<const uint2*>(row + n0);
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (n0 + j < N) lo |= (uint32_t)(uint8_t)row[n0 + j] << (8 * j);
    if (n0 + 4 + j < N) hi |= (uint32_t)(uint8_t)row[n0 + 4 + j] << (8 * j);
  }
  return make_uint2(lo, hi);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
           const float* __restrict__ scales, T* __restrict__ out,
           float* __restrict__ partial, int M, int K, int N,
           int k_per_split) {
  __shared__ __align__(16) float xs[CHUNK][BM];
  __shared__ float red[WARPS][BN];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int col0 = blockIdx.x * BN;
  const int n0 = col0 + lane * COLS;
  const int m0 = blockIdx.y * BM;
  const int rows = min(BM, M - m0);
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const bool vec = ((N & 7) == 0) && (n0 + COLS <= N);

  float acc[BM][COLS];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] = 0.f;

  for (int c0 = kbeg; c0 < kend; c0 += CHUNK) {
    for (int i = threadIdx.x; i < CHUNK * BM; i += THREADS) {
      const int r = i / CHUNK, kk = i % CHUNK, k = c0 + kk;
      xs[kk][r] = (r < rows && k < kend)
                      ? to_f32(x[(size_t)(m0 + r) * K + k]) : 0.f;
    }
    __syncthreads();

    uint2 wr[RPW];
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      const int k = c0 + warp * RPW + u;
      wr[u] = (k < kend && n0 < N)
                  ? load_w8(w + (size_t)k * N, n0, N, vec) : make_uint2(0, 0);
    }
#pragma unroll
    for (int u = 0; u < RPW; ++u) {
      const int kk = warp * RPW + u;
      const float4 xa = *reinterpret_cast<const float4*>(&xs[kk][0]);
      const float4 xb = *reinterpret_cast<const float4*>(&xs[kk][4]);
      const float xv[BM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      float wf[COLS];
      int8x4_to_f32(wr[u].x, wf);
      int8x4_to_f32(wr[u].y, wf + 4);
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int j = 0; j < COLS; ++j) acc[r][j] += xv[r] * wf[j];
    }
    __syncthreads();
  }

  // sum the warps, one row of x at a time (r unrolled: acc stays in
  // registers; the branch is uniform across the block)
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    if (r < rows) {
#pragma unroll
      for (int j = 0; j < COLS; ++j) red[warp][lane * COLS + j] = acc[r][j];
      __syncthreads();
      for (int c = threadIdx.x; c < BN; c += THREADS) {
        const int n = col0 + c;
        if (n < N) {
          float s = 0.f;
#pragma unroll
          for (int t = 0; t < WARPS; ++t) s += red[t][c];
          const int m = m0 + r;
          if (gridDim.z == 1)
            out[(size_t)m * N + n] = from_f32<T>(s * scales[n]);
          else
            partial[((size_t)blockIdx.z * M + m) * N + n] = s;
        }
      }
      __syncthreads();
    }
  }
}

// Sum the K splits in order, scale, cast.
template <typename T>
__global__ void qmm_reduce(const float* __restrict__ partial,
                           const float* __restrict__ scales,
                           T* __restrict__ out, int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
    out[i] = from_f32<T>(s * scales[i % N]);
  }
}

template <typename T>
int launch_simt(const void* x, const void* w, const void* scales, void* out,
                void* partial, int M, int K, int N, int splits,
                int k_per_split, void* stream) {
  // refused, never launched: unaligned 8-byte weight loads, or a split
  // plan without its fp32 workspace
  if (reinterpret_cast<uintptr_t>(w) % 8 != 0 || splits < 1 ||
      k_per_split < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  qmm_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<T*>(out),
      static_cast<float*>(partial), M, K, N, k_per_split);
  return static_cast<int>(cudaSuccess);
}

// ---- bf16 x: tensor cores --------------------------------------------------

// d = a b + c: mma.sync m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1,
                                         const float* c) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// The bf16 pair (lo, hi) of two floats that hold integers of at most 8
// significant bits: their high halves, exact.
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Write rows m and m + 1 (c0, c2 and c1, c3 of acc[8][4]) of the lane's
// 16 columns: times the columns' scales in bf16 to out, or unscaled in
// fp32 to split z's partial sums.
__device__ __forceinline__ void store_cols(
    float (*acc)[4], const float* __restrict__ scales,
    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int M,
    int N, int m, int col) {
  if (col >= N) return;
  if (gridDim.z == 1) {
    const float4* sp = reinterpret_cast<const float4*>(scales + col);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(sp + q);
      const float sc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // column 4q + e is tile (4q + e) / 2, row g (even) or g + 8 (odd)
        const int j = (4 * q + e) / 2, hi = 2 * (e & 1);
        acc[j][hi] *= sc[e];
        acc[j][hi + 1] *= sc[e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (m + r >= M) continue;
    if (gridDim.z == 1) {
      uint32_t v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        __nv_bfloat162 b2 = __floats2bfloat162_rn(acc[j][r], acc[j][2 + r]);
        v[j] = *reinterpret_cast<uint32_t*>(&b2);
      }
      uint4* o = reinterpret_cast<uint4*>(out + (size_t)(m + r) * N + col);
      o[0] = make_uint4(v[0], v[1], v[2], v[3]);
      o[1] = make_uint4(v[4], v[5], v[6], v[7]);
    } else {
      float4* o = reinterpret_cast<float4*>(
          partial + ((size_t)blockIdx.z * M + m + r) * N + col);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        o[q] = make_float4(acc[2 * q][r], acc[2 * q][2 + r],
                           acc[2 * q + 1][r], acc[2 * q + 1][2 + r]);
    }
  }
}

// -- decode (M <= 8): a GEMV, bound by the weight bytes ---------------------

constexpr int TC_COLS = 128;      // columns of a GEMV block (8 m16 tiles)
constexpr int GEMV_WARPS = 8;     // along K, on the same 128 columns
constexpr int GEMV_STEP = 16 * GEMV_WARPS;  // K rows the block's warps take
constexpr int GEMV_BUFS = 3;      // k16 steps a warp has loads in flight

__device__ __forceinline__ uint4 load_stream16(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// One k16 step's operands for a lane: its 16 columns of K rows 2t, 2t + 1,
// 2t + 8 and 2t + 9, and x's B fragment (x row g, k 2t .. 2t + 1 and
// 2t + 8 .. 2t + 9); zeros past kend (and x rows past M).
struct GemvStep {
  uint4 w[4];
  uint32_t xb[2];
};

__device__ __forceinline__ void gemv_load(GemvStep& s, const int8_t* wl,
                                          const __nv_bfloat16* xr, bool xok,
                                          int N, int k0, int kend, int t) {
  const int rows[4] = {2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + rows[i];
    s.w[i] = k < kend ? load_stream16(wl + (size_t)k * N)
                      : make_uint4(0u, 0u, 0u, 0u);
  }
  // K and kend are even, so a pair is inside kend or past it whole
  const int k = k0 + 2 * t;
  s.xb[0] = (xok && k < kend)
                ? __ldg(reinterpret_cast<const uint32_t*>(xr + k)) : 0u;
  s.xb[1] = (xok && k + 8 < kend)
                ? __ldg(reinterpret_cast<const uint32_t*>(xr + k + 8)) : 0u;
}

// acc[j] += tile j's product for one k16 step.
__device__ __forceinline__ void gemv_step(float (*acc)[4],
                                          const GemvStep& s) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    // word q (columns 4q .. 4q + 3) of K rows 2t, 2t + 1, 2t + 8, 2t + 9
    float f[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) int8x4_to_f32(word(s.w[i], q), f[i]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // tile 2q + h: row g is column 4q + 2h, row g + 8 is 4q + 2h + 1
      uint32_t a[4];
      a[0] = pack_hi(f[0][2 * h], f[1][2 * h]);          // row g, k 2t
      a[1] = pack_hi(f[0][2 * h + 1], f[1][2 * h + 1]);  // row g + 8
      a[2] = pack_hi(f[2][2 * h], f[3][2 * h]);          // row g, k 2t + 8
      a[3] = pack_hi(f[2][2 * h + 1], f[3][2 * h + 1]);  // row g + 8
      float* c = acc[2 * q + h];
      mma16816(c, a, s.xb[0], s.xb[1], c);
    }
  }
}

__global__ void __launch_bounds__(32 * GEMV_WARPS, 2)
qmm_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ w, const float* __restrict__ scales,
                __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
                int M, int K, int N, int k_per_split) {
  // warps 1.. hand their sums to warp 0: [warp][reg][lane]
  __shared__ float red[GEMV_WARPS - 1][32][32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col = blockIdx.x * TC_COLS + 16 * g;  // the lane's 16 columns
  // N is a multiple of 16: a lane's columns are all inside N or all past
  // it (those read column 0 and store nothing)
  const int lcol = col < N ? col : 0;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const bool xok = g < M;  // x rows >= M give zeros
  const __nv_bfloat16* xr = x + (size_t)(xok ? g : 0) * K;
  const int8_t* wl = w + lcol;

  // a ring of GEMV_BUFS steps: step i's loads are issued GEMV_BUFS - 1
  // steps before its products (loads past kend are skipped)
  GemvStep buf[GEMV_BUFS];
  const int k_first = kbeg + 16 * warp;
#pragma unroll
  for (int i = 0; i < GEMV_BUFS - 1; ++i)
    gemv_load(buf[i], wl, xr, xok, N, k_first + i * GEMV_STEP, kend, t);
  for (int k = k_first; k < kend; k += GEMV_BUFS * GEMV_STEP) {
#pragma unroll
    for (int i = 0; i < GEMV_BUFS; ++i) {
      const int kc = k + i * GEMV_STEP;
      gemv_load(buf[(i + GEMV_BUFS - 1) % GEMV_BUFS], wl, xr, xok, N,
                kc + (GEMV_BUFS - 1) * GEMV_STEP, kend, t);
      if (kc < kend) gemv_step(acc, buf[i]);  // warp-uniform
    }
  }

  if (warp > 0) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[warp - 1][4 * j + e][lane] = acc[j][e];
  }
  __syncthreads();
  if (warp > 0) return;
  for (int z = 0; z < GEMV_WARPS - 1; ++z)  // in order: deterministic
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += red[z][4 * j + e][lane];
  // x rows 2t (c0, c2) and 2t + 1 (c1, c3)
  store_cols(acc, scales, out, partial, M, N, 2 * t, col);
}

// -- prefill (M > 8): a GEMM on wgmma, bound by the operations ---------------

constexpr int GEMM_COLS = 64;    // output columns a block (the wgmma M)
constexpr int GEMM_ROWS = 128;   // rows of x a block (the wgmma N)
constexpr int GEMM_KT = 64;      // K rows a stage
constexpr int GEMM_STAGES = 4;
constexpr int GEMM_THREADS = 128;  // one warpgroup
constexpr int GEMM_WROW = 80;    // bytes a weight row takes in a stage
constexpr int GEMM_XBYTES = GEMM_ROWS * 128;        // 16 KB, swizzled
constexpr int GEMM_WBYTES = GEMM_KT * GEMM_WROW;    // 5 KB
constexpr int GEMM_STAGE = GEMM_XBYTES + GEMM_WBYTES;  // 21 x 1024 bytes
// the ring, and 1024 bytes to align it to the swizzle's period
constexpr int GEMM_SMEM = GEMM_STAGES * GEMM_STAGE + 1024;
static_assert(GEMM_STAGE % 1024 == 0, "stages keep the x tiles aligned");

// 16 bytes global -> shared, asynchronous (L2 only); src_bytes 0 fills
// zeros.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t lds16(uint32_t addr) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(addr));
  return v;
}

// Copy K rows k0 .. k0 + 63 of the block's x rows (row r's 16-byte chunk
// c at r * 128 + (c ^ r % 8) * 16: the 128-byte swizzle) and of its 64
// weight columns into a stage; zeros past kend, M and N.
__device__ __forceinline__ void gemm_stage(
    uint32_t st, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, int M, int K, int N, int row0, int col0,
    int k0, int kend) {
  for (int c = threadIdx.x; c < GEMM_ROWS * 8; c += GEMM_THREADS) {
    const int r = c >> 3, q = c & 7;
    const int row = row0 + r, k = k0 + 8 * q;
    const bool ok = row < M && k < kend;
    cp16(st + r * 128 + ((q ^ (r & 7)) << 4),
         x + (ok ? (size_t)row * K + k : 0), ok ? 16 : 0);
  }
  for (int c = threadIdx.x; c < GEMM_KT * 4; c += GEMM_THREADS) {
    const int r = c >> 2, q = c & 3;
    const int k = k0 + r, col = col0 + 16 * q;
    const bool ok = k < kend && col < N;
    cp16(st + GEMM_XBYTES + r * GEMM_WROW + 16 * q,
         w + (ok ? (size_t)k * N + col : 0), ok ? 16 : 0);
  }
}

// Warp w's A fragment for k16 step s of a stage: columns 16 w + 2g (tile
// row g) and + 1 (row g + 8) of K rows 16 s + 2t, + 1, + 8, + 9.
__device__ __forceinline__ void gemm_a(uint32_t* a, uint32_t wst, int s,
                                       int warp, int g, int t) {
  const uint32_t p = wst + (16 * s + 2 * t) * GEMM_WROW + 16 * warp + 2 * g;
  // bytes (row g, row g + 8) of K rows 2t and 2t + 1, then 2t + 8, 2t + 9
  const uint32_t lo = lds16(p) | (lds16(p + GEMM_WROW) << 16);
  const uint32_t hi = lds16(p + 8 * GEMM_WROW) |
                      (lds16(p + 9 * GEMM_WROW) << 16);
  float f[4];
  int8x4_to_f32(lo, f);  // (2t, g), (2t, g + 8), (2t + 1, g), (2t + 1, g + 8)
  a[0] = pack_hi(f[0], f[2]);
  a[1] = pack_hi(f[1], f[3]);
  int8x4_to_f32(hi, f);
  a[2] = pack_hi(f[0], f[2]);
  a[3] = pack_hi(f[1], f[3]);
}

__global__ void __launch_bounds__(GEMM_THREADS, 2)
qmm_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                const int8_t* __restrict__ w, const float* __restrict__ scales,
                __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
                int M, int K, int N, int k_per_split) {
  extern __shared__ __align__(16) uint8_t gsmem[];
  const uint32_t ring = (hopper::smem_u32(gsmem) + 1023u) & ~1023u;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * GEMM_COLS;
  const int row0 = blockIdx.y * GEMM_ROWS;
  const int kbeg = blockIdx.z * k_per_split;
  const int kend = min(K, kbeg + k_per_split);
  const int n_st = (kend - kbeg + GEMM_KT - 1) / GEMM_KT;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // the ring: STAGES - 1 stages ahead; one commit a slot, empty or not,
  // so that wait_group counts slots
#pragma unroll
  for (int s = 0; s < GEMM_STAGES - 1; ++s) {
    if (s < n_st)
      gemm_stage(ring + s * GEMM_STAGE, x, w, M, K, N, row0, col0,
                 kbeg + s * GEMM_KT, kend);
    cp_commit();
  }
  for (int i = 0; i < n_st; ++i) {
    cp_wait<GEMM_STAGES - 2>();  // this thread's copies of stage i
    hopper::fence_proxy_async();  // visible to the wgmma's reads
    __syncthreads();             // everyone's; and slot i - 1 is free
    const int next = i + GEMM_STAGES - 1;
    if (next < n_st)
      gemm_stage(ring + (next % GEMM_STAGES) * GEMM_STAGE, x, w, M, K, N,
                 row0, col0, kbeg + next * GEMM_KT, kend);
    cp_commit();
    const uint32_t st = ring + (i % GEMM_STAGES) * GEMM_STAGE;
    uint32_t a[2][4];
    gemm_a(a[0], st + GEMM_XBYTES, 0, warp, g, t);
#pragma unroll
    for (int s = 0; s < GEMM_KT / 16; ++s) {
      hopper::wgmma_fence();
      hopper::wgmma_rs_n128_kb(acc, a[s & 1],
                               hopper::desc_sw128(st + 32 * s, 16, 1024));
      hopper::wgmma_commit();
      if (s + 1 < GEMM_KT / 16) {
        // step s - 1's wgmma, the last reader of a[(s + 1) & 1], is done
        hopper::wgmma_wait<1>();
        hopper::fence_regs<4>(a[(s + 1) & 1]);
        gemm_a(a[(s + 1) & 1], st + GEMM_XBYTES, s + 1, warp, g, t);
      }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<64>(acc);
    hopper::fence_regs<4>(a[0]);
    hopper::fence_regs<4>(a[1]);
  }

  // acc[4j + e]: x row 8j + 2t + (e & 1), column 16 w + 2g + (e >> 1)
  const int col = col0 + 16 * warp + 2 * g;
  if (col >= N) return;  // N is a multiple of 16: the warp's 16 columns
  float s0 = 1.f, s1 = 1.f;
  if (gridDim.z == 1) {
    const float2 sc = __ldg(reinterpret_cast<const float2*>(scales + col));
    s0 = sc.x;
    s1 = sc.y;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = row0 + 8 * j + 2 * t + r;
      if (m >= M) continue;
      if (gridDim.z == 1) {
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)m * N + col) =
            __floats2bfloat162_rn(acc[4 * j + r] * s0,
                                  acc[4 * j + 2 + r] * s1);
      } else {
        *reinterpret_cast<float2*>(
            partial + ((size_t)blockIdx.z * M + m) * N + col) =
            make_float2(acc[4 * j + r], acc[4 * j + 2 + r]);
      }
    }
  }
}

// The tensor-core route: bf16 x at N a multiple of 16 and K a positive
// multiple of 8 (16-byte rows of x and w_q).
bool tc_shape(int K, int N) { return N % 16 == 0 && K > 0 && K % 8 == 0; }

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_tc(const void* x, const void* w, const void* scales, void* out,
              void* partial, int M, int K, int N, int splits,
              int k_per_split, cudaStream_t st) {
  // refused, never launched: a split that is not whole K steps of the
  // path (128 rows at decode, 64 at prefill), or a split plan without its
  // fp32 workspace
  const int unit = M <= 8 ? GEMV_STEP : GEMM_KT;
  if (splits < 1 || k_per_split < unit || k_per_split % unit != 0 ||
      (splits > 1 && (partial == nullptr || !aligned16(partial))))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto xp = static_cast<const __nv_bfloat16*>(x);
  const auto wp = static_cast<const int8_t*>(w);
  const auto sp = static_cast<const float*>(scales);
  const auto op = static_cast<__nv_bfloat16*>(out);
  const auto pp = static_cast<float*>(partial);
  if (M <= 8) {
    qmm_gemv_kernel<<<dim3((N + TC_COLS - 1) / TC_COLS, 1, splits),
                      32 * GEMV_WARPS, 0, st>>>(xp, wp, sp, op, pp, M, K, N,
                                                k_per_split);
    return static_cast<int>(cudaSuccess);
  }
  // once a device: the setting outlives the call
  static unsigned long long set_on = 0;  // bit d: device d is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !((set_on >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(qmm_gemm_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               GEMM_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) set_on |= 1ull << dev;
  }
  const dim3 grid((N + GEMM_COLS - 1) / GEMM_COLS,
                  (M + GEMM_ROWS - 1) / GEMM_ROWS, splits);
  qmm_gemm_kernel<<<grid, GEMM_THREADS, GEMM_SMEM, st>>>(
      xp, wp, sp, op, pp, M, K, N, k_per_split);
  return static_cast<int>(cudaSuccess);
}

// Splits of K for the tensor-core route, in whole steps of the path:
// none where the (N, M) tiles already fill half the SMs (the split's
// second pass costs more than the idle SMs: on one H100, gate/up at
// decode, 112 tiles, ran faster unsplit than in 2 splits), else as
// many as keep the grid within one wave of 2 blocks an SM (a second,
// partial wave costs more than idle SMs), with at least one k16 step a
// warp at decode and 4 stages a split at prefill.
void tc_plan(int M, int K, int N, int sm_count, int* splits,
             int* k_per_split) {
  const bool gemv = M <= 8;
  const long unit = gemv ? GEMV_STEP : GEMM_KT;
  const long steps = (K + unit - 1) / unit;
  const long tiles =
      gemv ? (N + TC_COLS - 1) / TC_COLS
           : (long)((N + GEMM_COLS - 1) / GEMM_COLS) *
                 ((M + GEMM_ROWS - 1) / GEMM_ROWS);
  long s = 2 * tiles > sm_count ? 1 : 2L * sm_count / tiles;
  const long most = gemv ? steps : steps / 4;
  if (s > most) s = most;
  if (s < 1) s = 1;
  const long per = (steps + s - 1) / s;
  *k_per_split = static_cast<int>(per * unit);
  *splits = static_cast<int>((steps + per - 1) / per);
}

// The CUDA-core route's split: only when the (M, N) tiles alone would
// leave fewer than BLOCKS_PER_SM blocks an SM (decode at small N); a
// split covers whole CHUNK-row steps.
void simt_plan(int M, int K, int N, int sm_count, int* splits,
               int* k_per_split) {
  const long tiles = (long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  const long want = (BLOCKS_PER_SM * (long)sm_count + tiles - 1) / tiles;
  const long steps = (K + CHUNK - 1) / CHUNK;
  long s = want < steps ? want : steps;
  if (s < 1) s = 1;
  long per = ((K + s - 1) / s + CHUNK - 1) / CHUNK * CHUNK;
  if (per < CHUNK) per = CHUNK;
  *k_per_split = static_cast<int>(per);
  *splits = static_cast<int>(K > 0 ? (K + per - 1) / per : 1);
}

// Sum the splits and cast: the second pass of a split plan.
template <typename T>
void launch_reduce(const void* partial, const void* scales, void* out, int M,
                   int N, int splits, cudaStream_t st) {
  size_t blocks = ((size_t)M * N + 255) / 256;
  if (blocks > 65535) blocks = 65535;
  qmm_reduce<T><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const float*>(partial), static_cast<const float*>(scales),
      static_cast<T*>(out), M, N, splits);
}

}  // namespace

extern "C" {

// How to split K for (M, K, N) with x in bf16 (x_bf16 = 1) or fp32 on a
// card of sm_count SMs, for the route the shape takes: the tensor cores
// (bf16 x, N % 16 == 0, K % 8 == 0) split in whole K steps of 128 rows
// (decode) or 64 (prefill), the CUDA cores in whole CHUNK-row steps. The
// caller gives qmm_* an fp32 workspace of splits * M * N when splits > 1.
// A tensor-core plan also suits the CUDA cores, which take any split, so
// a call the tensor cores refuse by alignment runs on its plan there.
int qmm_plan(int M, int K, int N, int x_bf16, int sm_count, int* splits,
             int* k_per_split) {
  if (M <= 0 || N <= 0 || K < 0 || sm_count < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16 && tc_shape(K, N))
    tc_plan(M, K, N, sm_count, splits, k_per_split);
  else
    simt_plan(M, K, N, sm_count, splits, k_per_split);
  return 0;
}

int qmm_bf16(const void* x, const void* w, const void* scales, void* out,
             void* partial, int M, int K, int N, int splits,
             int k_per_split, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (tc_shape(K, N) && aligned16(x) && aligned16(w) && aligned16(scales) &&
      aligned16(out))
    err = launch_tc(x, w, scales, out, partial, M, K, N, splits, k_per_split,
                    st);
  else
    err = launch_simt<__nv_bfloat16>(x, w, scales, out, partial, M, K, N,
                                     splits, k_per_split, stream);
  if (err != 0) return err;
  if (splits > 1)
    launch_reduce<__nv_bfloat16>(partial, scales, out, M, N, splits, st);
  return static_cast<int>(cudaGetLastError());
}

int qmm_f32(const void* x, const void* w, const void* scales, void* out,
            void* partial, int M, int K, int N, int splits, int k_per_split,
            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = launch_simt<float>(x, w, scales, out, partial, M, K, N,
                                     splits, k_per_split, stream);
  if (err != 0) return err;
  if (splits > 1)
    launch_reduce<float>(partial, scales, out, M, N, splits, st);
  return static_cast<int>(cudaGetLastError());
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
