// Weight-only int4 matmul for Hopper (sm_90a):
// out = x @ (unpack(packed) * repeat(scales, group)).
//
// Replaces: sparkdl_tpu/ops/pallas/quantized_matmul.py, _q4mm_kernel
// (called through quantized_matmul_int4_pallas). Same arithmetic: x
// (M, K) in bf16 or fp32; packed (K/2, N) int8 row-major, packed row i
// holding weight row 2i in its LOW nibble and row 2i+1 in its HIGH
// nibble, both two's-complement int4; scales (K/group, N) fp32. Like the
// TPU kernel, each weight is dequantized first (q * its group's scale,
// the same fp32 product as the plain version's) and then multiplied into
// fp32 sums over K; the output is written in x's dtype. Only the order
// of the fp32 sums differs from the plain version.
//
// What bounds it: at decode M is the slot count (8), so each packed byte
// (two weights) feeds 4*M flops and the kernel is bound by the bytes of
// packed + scales (K*N/2 + 4*N*K/group: with group 64 the scales add 1/8
// to the int4 bytes). At prefill (M up to the prefill chunk, 256) it is
// bound by the 2*M*K*N operations.
//
// Design, for the byte-bound decode first (the int8 kernel's tiling,
// csrc/quantized_matmul.cu, with nibbles in place of bytes): a block owns
// BN = 256 columns, BM = 8 rows of x and one slice of K. Each lane owns 8
// neighbouring columns and reads one packed row of them as one 8-byte
// load, which yields 16 weights (two K rows); a warp thus reads whole
// 256-byte segments of a packed row. The block stages x for CHUNK = 128
// rows of K in shared memory as fp32, transposed so that one K row's 8 x
// values are two 16-byte broadcast reads. Each of the 8 warps walks its
// own PRW = 8 packed rows of the chunk, issuing all their loads before it
// uses any. A nibble becomes an exact float without the I2F unit: mask
// the four low (or, after a shift, high) nibbles of a word and flip their
// sign bit in one LOP3, place each byte under the exponent of 2^23 with
// a byte permute, subtract 2^23 + 8. The group's 8 scales stay in
// registers while the warp's rows stay in one group (one load per warp
// and chunk when group is a multiple of 16, as 32, 64 and 128 are; any
// group that divides K is right). The warps' sums meet in shared
// memory at the end. When N/256 x M/8 blocks would leave the 132 SMs
// idle (decode at N = 1024 and 4096), K is split over gridDim.z
// (q4mm_plan below), each split writes an fp32 partial, and a second
// pass sums the splits in a fixed order (deterministic, no atomics) and
// casts. The ragged K tail stages as zero x and its packed rows are
// never read; ragged N takes guarded byte loads; nothing is padded. No
// tensor cores yet: unpacking to bf16 for mma/wgmma at prefill is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 8;                 // rows of x per block
constexpr int COLS = 8;               // columns per lane: one 8-byte load
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;   // 256
constexpr int BN = 32 * COLS;         // 256 columns per block
constexpr int CHUNK = 128;            // K rows of x staged at a time
constexpr int PRW = CHUNK / 2 / WARPS;  // packed rows per warp per chunk
constexpr int BLOCKS_PER_SM = 4;      // split K below this many blocks an SM

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

// Four nibbles, one in the low half of each byte of v (the rest of each
// byte ignored), two's complement -> four exact floats: u = n ^ 8 is the
// nibble plus 8 as an unsigned 0..15; 2^23 + u is exact; minus 2^23 + 8.
__device__ __forceinline__ void nibbles_to_f32(uint32_t v, float* f) {
  v = (v & 0x0F0F0F0Fu) ^ 0x08080808u;
  f[0] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7650)) - 8388616.f;
  f[1] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7651)) - 8388616.f;
  f[2] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7652)) - 8388616.f;
  f[3] = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7653)) - 8388616.f;
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

// The 8 scales of one K row's group for a lane's columns (zeros past N).
__device__ __forceinline__ void load_scales(const float* row, int n0, int N,
                                            bool vec, float* s) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(row + n0);
    const float4 b = *reinterpret_cast<const float4*>(row + n0 + 4);
    s[0] = a.x; s[1] = a.y; s[2] = a.z; s[3] = a.w;
    s[4] = b.x; s[5] = b.y; s[6] = b.z; s[7] = b.w;
    return;
  }
#pragma unroll
  for (int j = 0; j < COLS; ++j) s[j] = (n0 + j < N) ? row[n0 + j] : 0.f;
}

// acc[r][j] += x[r][k] * (q[k][j] * scale[k / group][j]) for one K row k
// of the lane's 8 columns: the dequant first, as the plain version does.
// sc holds group gcur's scales; a row of another group reloads them
// (warp-uniform: every lane has the same k).
__device__ __forceinline__ void fma_row(float (&acc)[BM][COLS], float* wf,
                                        float* sc, const float* xrow,
                                        const float* scales, int k,
                                        int group, int n0, int N, bool vec,
                                        int& gcur) {
  if (k / group != gcur) {
    gcur = k / group;
    load_scales(scales + (size_t)gcur * N, n0, N, vec, sc);
  }
  const float4 xa = *reinterpret_cast<const float4*>(xrow);
  const float4 xb = *reinterpret_cast<const float4*>(xrow + 4);
  const float xv[BM] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
  for (int j = 0; j < COLS; ++j) wf[j] *= sc[j];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[r][j] += xv[r] * wf[j];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
q4mm_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
            const float* __restrict__ scales, T* __restrict__ out,
            float* __restrict__ partial, int M, int K, int N, int group,
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

  int gcur = -1;          // group whose scales sc holds (warp-uniform)
  float sc[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) sc[j] = 0.f;

  for (int c0 = kbeg; c0 < kend; c0 += CHUNK) {
    for (int i = threadIdx.x; i < CHUNK * BM; i += THREADS) {
      const int r = i / CHUNK, kk = i % CHUNK, k = c0 + kk;
      xs[kk][r] = (r < rows && k < kend)
                      ? to_f32(x[(size_t)(m0 + r) * K + k]) : 0.f;
    }
    __syncthreads();

    // kbeg, c0 and K are even, so a packed row never straddles kend
    const int kw = c0 + 2 * warp * PRW;  // the warp's first K row
    uint2 wr[PRW];
#pragma unroll
    for (int u = 0; u < PRW; ++u) {
      const int k = kw + 2 * u;
      wr[u] = (k < kend && n0 < N)
                  ? load_w8(w + (size_t)(k / 2) * N, n0, N, vec)
                  : make_uint2(0, 0);
    }
    // the group of the warp's first row, loaded beside the weights (when
    // group is a multiple of 2 * PRW it covers all the warp's rows)
    if (kw < kend && kw / group != gcur) {
      gcur = kw / group;
      load_scales(scales + (size_t)gcur * N, n0, N, vec, sc);
    }
#pragma unroll
    for (int u = 0; u < PRW; ++u) {
      const int kk = 2 * (warp * PRW + u);
      if (c0 + kk >= kend) break;  // warp-uniform: the ragged K tail
      float wf[COLS];
      // weight row k (low nibbles), then row k + 1 (high nibbles)
      nibbles_to_f32(wr[u].x, wf);
      nibbles_to_f32(wr[u].y, wf + 4);
      fma_row(acc, wf, sc, &xs[kk][0], scales, c0 + kk, group, n0, N, vec,
              gcur);
      nibbles_to_f32(wr[u].x >> 4, wf);
      nibbles_to_f32(wr[u].y >> 4, wf + 4);
      fma_row(acc, wf, sc, &xs[kk + 1][0], scales, c0 + kk + 1, group, n0,
              N, vec, gcur);
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
            out[(size_t)m * N + n] = from_f32<T>(s);
          else
            partial[((size_t)blockIdx.z * M + m) * N + n] = s;
        }
      }
      __syncthreads();
    }
  }
}

// Sum the K splits in order, cast.
template <typename T>
__global__ void q4mm_reduce(const float* __restrict__ partial,
                            T* __restrict__ out, int M, int N, int splits) {
  const size_t mn = (size_t)M * N;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += partial[z * mn + i];
    out[i] = from_f32<T>(s);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scales, void* out,
           void* partial, int M, int K, int N, int group, int splits,
           int k_per_split, void* stream) {
  // refused, never launched: an odd K or a group that does not divide
  // it, unaligned 8-byte weight or 16-byte scale loads, a split that is
  // not a whole number of CHUNK rows, or a split plan without its fp32
  // workspace
  if ((K & 1) || group < 1 || K % group != 0 ||
      reinterpret_cast<uintptr_t>(w) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(scales) % 16 != 0 || splits < 1 ||
      k_per_split < 1 || k_per_split % CHUNK != 0 ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  q4mm_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scales), static_cast<T*>(out),
      static_cast<float*>(partial), M, K, N, group, k_per_split);
  if (splits > 1) {
    size_t blocks = ((size_t)M * N + 255) / 256;
    if (blocks > 65535) blocks = 65535;
    q4mm_reduce<T><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<T*>(out), M, N,
        splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// How to split K for (M, K, N) on a card of sm_count SMs: split only when
// the (M, N) tiles alone would leave fewer than BLOCKS_PER_SM blocks an SM
// (decode at small N); a split covers whole CHUNK-row steps (so whole
// packed rows). The caller gives q4mm_* an fp32 workspace of
// splits * M * N when splits > 1.
int q4mm_plan(int M, int K, int N, int sm_count, int* splits,
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

int q4mm_bf16(const void* x, const void* w, const void* scales, void* out,
              void* partial, int M, int K, int N, int group, int splits,
              int k_per_split, void* stream) {
  return launch<__nv_bfloat16>(x, w, scales, out, partial, M, K, N, group,
                               splits, k_per_split, stream);
}

int q4mm_f32(const void* x, const void* w, const void* scales, void* out,
             void* partial, int M, int K, int N, int group, int splits,
             int k_per_split, void* stream) {
  return launch<float>(x, w, scales, out, partial, M, K, N, group, splits,
                       k_per_split, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
