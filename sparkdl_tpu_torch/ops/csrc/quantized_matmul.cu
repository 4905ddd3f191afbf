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
// Design, for the byte-bound decode first: a block owns BN = 256
// columns, BM = 8 rows of x and one slice of K. Each of its 8 warps
// walks its own rows of that slice; each lane owns 8 neighbouring
// columns and reads them as one 8-byte load per weight row, so a warp
// reads whole 256-byte row segments. The block stages x for CHUNK rows
// of K in shared memory as fp32, transposed so that one row's 8 x values
// are two 16-byte broadcast reads; each lane then issues all RPW weight
// loads of its rows before it uses any, converts int8 to fp32 with a
// byte permute and one add (the I2F unit would halve the FMA rate), and
// does 64 FMAs per weight row. The warps' sums meet in shared memory at
// the end. When N/256 x M/8 blocks would leave the 132 SMs idle (decode:
// N = 1024 and 4096), K is split over gridDim.z (qmm_plan below chooses
// the split, so the tiling is known in this file alone); each split
// writes an fp32 partial and a second pass sums the splits in a fixed
// order (deterministic), applies the scale and casts. Otherwise the
// single pass writes the output itself. M tiles ride gridDim.y, so one
// kernel serves decode and prefill (where W is re-read once per 8 rows
// of x). The ragged K tail stages as zeros and its weight rows are never
// read; ragged N falls back to guarded byte loads; no padding copies. No
// tensor cores yet: wgmma/TMA tiles for prefill are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
int launch(const void* x, const void* w, const void* scales, void* out,
           void* partial, int M, int K, int N, int splits, int k_per_split,
           void* stream) {
  // refused, never launched: unaligned 8-byte weight loads, or a split
  // plan without its fp32 workspace
  if (reinterpret_cast<uintptr_t>(w) % 8 != 0 || splits < 1 ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  qmm_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<T*>(out),
      static_cast<float*>(partial), M, K, N, k_per_split);
  if (splits > 1) {
    size_t blocks = ((size_t)M * N + 255) / 256;
    if (blocks > 65535) blocks = 65535;
    qmm_reduce<T><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const float*>(partial),
        static_cast<const float*>(scales), static_cast<T*>(out), M, N,
        splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// How to split K for (M, K, N) on a card of sm_count SMs: split only when
// the (M, N) tiles alone would leave fewer than BLOCKS_PER_SM blocks an SM
// (decode at small N); a split covers whole CHUNK-row steps. The caller
// gives qmm_* an fp32 workspace of splits * M * N when splits > 1.
int qmm_plan(int M, int K, int N, int sm_count, int* splits,
             int* k_per_split) {
  const long tiles = (long)((N + BN - 1) / BN) * ((M + BM - 1) / BM);
  if (tiles <= 0 || K < 0) return static_cast<int>(cudaErrorInvalidValue);
  const long want = (BLOCKS_PER_SM * (long)sm_count + tiles - 1) / tiles;
  const long steps = (K + CHUNK - 1) / CHUNK;
  long s = want < steps ? want : steps;
  if (s < 1) s = 1;
  long per = ((K + s - 1) / s + CHUNK - 1) / CHUNK * CHUNK;
  if (per < CHUNK) per = CHUNK;
  *k_per_split = static_cast<int>(per);
  *splits = static_cast<int>(K > 0 ? (K + per - 1) / per : 1);
  return 0;
}

int qmm_bf16(const void* x, const void* w, const void* scales, void* out,
             void* partial, int M, int K, int N, int splits,
             int k_per_split, void* stream) {
  return launch<__nv_bfloat16>(x, w, scales, out, partial, M, K, N, splits,
                               k_per_split, stream);
}

int qmm_f32(const void* x, const void* w, const void* scales, void* out,
            void* partial, int M, int K, int N, int splits, int k_per_split,
            void* stream) {
  return launch<float>(x, w, scales, out, partial, M, K, N, splits,
                       k_per_split, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
