// Weight-only int4 matmul for Hopper (sm_90a):
// out = x @ (unpack(packed) * repeat(scales, group)).
//
// Replaces: sparkdl_tpu/ops/pallas/quantized_matmul.py, _q4mm_kernel
// (called through quantized_matmul_int4_pallas). x (M, K) in bf16 or
// fp32; packed (K/2, N) int8 row-major, packed row i holding weight row
// 2i in its LOW nibble and row 2i+1 in its HIGH nibble, both two's-
// complement int4; scales (K/group, N) fp32; the output in x's dtype.
//
// What bounds it: at decode M is the slot count (8), so each packed byte
// (two weights) feeds 4*M flops and the kernel is bound by the bytes of
// packed + scales (K*N/2 + 4*N*K/group: with group 64 the scales add 1/8
// to the int4 bytes). At prefill (M up to the prefill chunk, 256) it is
// bound by the 2*M*K*N operations.
//
// bf16 x: the tensor cores, mma.sync m16n8k16 with bf16 operands and
// fp32 accumulators, the product turned around: out^T = W^T x^T, so the
// weights are the A operand (16 columns of N an mma) and x the B operand
// (8 rows of M), which at decode (M = 8) wastes no lane. A nibble -8..7
// is an exact bf16 and its product with a bf16 x is exact in fp32, so a
// scale group's products are summed by the tensor cores into an fp32
// partial, the partial is multiplied by the column's fp32 scale and
// added to an fp32 accumulator: sum_g s_g sum_{k in g} q_k x_k. Only the
// order of fp32 sums differs from the plain version's x.f32 @ (q * s);
// q * s is never rounded to bf16.
// Fragments straight from the packed layout: in the A fragment, lane
// 4g + t holds (row g, k 2t and 2t + 1) and (row g, k 2t + 8 and 2t + 9)
// (and the same for row g + 8), which are the two nibbles of the packed
// byte (row t, column) and of (row t + 4, column). A lane takes 16
// neighbouring columns of packed rows t and t + 4 as two 16-byte chunks
// and so feeds 8 mma tiles: tile j's A row r stands for column
// 16 (r % 8) + 2j + r / 8 of the warp's 128, so a lane's C fragments hold
// exactly the 16 columns it loaded (and their 16 scales), and the
// epilogue writes them as two 16-byte stores a row. A nibble pair
// becomes a bf16x2 without I2F: flip the nibbles' sign bits (u = n ^ 8,
// one XOR a word), put a byte's low nibble in bits 0-3 and its high
// nibble in bits 16-19 (a byte permute of the word and of the word >>
// 4), OR in the exponent of 128 (0x4300, one LOP3: 128 + u is exact in
// bf16) and subtract 136 in one bf16x2 FMA. The path takes group 32, 64
// or 128 (2, 4 or 8 k16 steps) and N a multiple of 16; it refuses
// (cudaErrorInvalidValue) x, packed rows, scales or out not 16-byte
// aligned.
// Decode (M <= 8, q4mm_gemv_kernel), bound by bytes: a block of 8 warps
// on the same 128 columns, each warp on its own scale groups (split K
// inside the block), 2 blocks an SM; a warp issues all of a group's
// loads (its 2 x 16-byte non-allocating weight loads a k16 step, x's B
// fragments, 4 float4 of scales) before the group's products, and the
// warps' sums meet in shared memory in a fixed order.
// Prefill (M > 8, q4mm_gemm_kernel), bound by operations: a block of 4
// warps, 32 rows of x each (4 n8 tiles, so a weight's dequant feeds 4
// products; 16 rows at group 128), on 128 columns; its threads copy
// each scale group's packed rows, scales and x rows into a ring of 4
// shared-memory stages with cp.async, so a weight byte leaves the L2
// once a block.
// Where the (N, M) tiles alone would leave the SMs idle, K is also split
// over gridDim.z (q4mm_plan), each split writes an fp32 partial and a
// second pass sums the splits in order and casts: deterministic, no
// atomics.
//
// fp32 x (the lm_head), and bf16 x at an N or group the tensor-core path
// does not take: CUDA cores (q4mm_kernel), since bf16 tensor cores
// cannot take fp32 x exactly. A block owns BN = 256 columns, BM = 8 rows
// of x and one slice of K. Each lane owns 8 neighbouring columns and
// reads one packed row of them as one 8-byte load, which yields 16
// weights (two K rows); a warp thus reads whole 256-byte segments of a
// packed row. The block stages x for CHUNK = 128 rows of K in shared
// memory as fp32, transposed so that one K row's 8 x values are two
// 16-byte broadcast reads. Each of the 8 warps walks its own PRW = 8
// packed rows of the chunk, issuing all their loads before it uses any.
// A nibble becomes an exact float without the I2F unit: mask the four
// low (or, after a shift, high) nibbles of a word and flip their sign
// bit in one LOP3, place each byte under the exponent of 2^23 with a
// byte permute, subtract 2^23 + 8. Each weight is dequantized first (q *
// its group's scale, the plain version's fp32 product) and then
// multiplied into fp32 sums over K. The group's 8 scales stay in
// registers while the warp's rows stay in one group (any group that
// divides K is right). The warps' sums meet in shared memory at the end;
// K is split over gridDim.z as above. The ragged K tail stages as zero x
// and its packed rows are never read; ragged N takes guarded byte loads;
// nothing is padded. This path, the lm_head's one call a decode step
// (0.44 ms of the 4.55 that all 225 int4 calls take on one H100 80GB
// HBM3 at 700 W), is B6's next lever.

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
int launch_simt(const void* x, const void* w, const void* scales, void* out,
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

// ---- bf16 x: tensor cores --------------------------------------------------

constexpr int TC_COLS = 128;  // columns of a warp (8 m16 tiles)

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

// Byte i of a packed word as a bf16x2 (low nibble in the low half: the
// even K row first). u holds the word's nibbles plus 8 (n ^ 8), hi is
// u >> 4: bits 0-3 <- u's byte i, bits 16-19 <- hi's byte i, under the
// exponent of 128; then (128 + u) - 136 = n, exact.
__device__ __forceinline__ uint32_t nibble_pair(uint32_t u, uint32_t hi,
                                                int i) {
  const uint32_t sel = i | (i << 4) | ((4 + i) << 8) | ((4 + i) << 12);
  const uint32_t t = (__byte_perm(u, hi, sel) & 0x000F000Fu) | 0x43004300u;
  uint32_t r;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(t), "r"(0x3F803F80u), "r"(0xC308C308u));  // t * 1 - 136
  return r;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Tile j's A fragment for one k16 step from the lane's two chunks (packed
// rows t and t + 4, its 16 columns): bytes 2j (row g) and 2j + 1 (row g
// + 8) of each.
__device__ __forceinline__ void a_fragment(uint32_t* a, uint32_t w0,
                                           uint32_t w1, int j) {
  const uint32_t u0 = w0 ^ 0x88888888u, u1 = w1 ^ 0x88888888u;
  const int b = 2 * (j % 2);
  a[0] = nibble_pair(u0, u0 >> 4, b);      // row g, k 2t, 2t + 1
  a[1] = nibble_pair(u0, u0 >> 4, b + 1);  // row g + 8
  a[2] = nibble_pair(u1, u1 >> 4, b);      // row g, k 2t + 8, 2t + 9
  a[3] = nibble_pair(u1, u1 >> 4, b + 1);  // row g + 8
}

// acc (tile j) += part * the scales of columns col + 2j (c0, c1: rows g)
// and col + 2j + 1 (c2, c3: rows g + 8)
__device__ __forceinline__ void add_scaled(float* acc, const float* part,
                                           float s_even, float s_odd) {
  acc[0] += part[0] * s_even;
  acc[1] += part[1] * s_even;
  acc[2] += part[2] * s_odd;
  acc[3] += part[3] * s_odd;
}

// Write rows m and m + 1 (c0, c2 and c1, c3 of acc[8][4]) of the lane's
// 16 columns: bf16 to out, or fp32 to split z's partial sums.
__device__ __forceinline__ void store_cols(
    const float (*acc)[4], __nv_bfloat16* __restrict__ out,
    float* __restrict__ partial, int M, int N, int m, int col) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (m + r >= M || col >= N) continue;
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

constexpr int GEMV_WARPS = 8;  // along K, on the same 128 columns

__device__ __forceinline__ uint4 load_stream16(const int8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// 2 blocks an SM (at most 128 registers a thread) below group 128, whose
// 64 registers of weight chunks need more.
template <int GSTEPS>
__global__ void __launch_bounds__(32 * GEMV_WARPS, GSTEPS > 4 ? 1 : 2)
q4mm_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ scales,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
                 int M, int K, int N, int k_per_split) {
  constexpr int GROUP = 16 * GSTEPS;
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

  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  // the x row whose B fragments this lane loads (rows >= M give zeros)
  const bool xok = g < M;
  const __nv_bfloat16* xr = x + (size_t)(xok ? g : 0) * K + 2 * t;
  const int8_t* wl = w + (size_t)t * N + lcol;  // packed row t, 16 columns
  for (int k0 = kbeg + warp * GROUP; k0 < kend; k0 += GEMV_WARPS * GROUP) {
    // every load of the group first: packed rows t and t + 4 of each k16
    // step, x's B fragments, the 16 columns' scales
    uint4 wr[GSTEPS][2];
    uint32_t xb[GSTEPS][2];
#pragma unroll
    for (int ks = 0; ks < GSTEPS; ++ks) {
      const int8_t* p = wl + (size_t)(k0 / 2 + 8 * ks) * N;
      wr[ks][0] = load_stream16(p);
      wr[ks][1] = load_stream16(p + 4 * (size_t)N);
      const __nv_bfloat16* xp = xr + k0 + 16 * ks;
      xb[ks][0] = xok ? __ldg(reinterpret_cast<const uint32_t*>(xp)) : 0u;
      xb[ks][1] = xok ? __ldg(reinterpret_cast<const uint32_t*>(xp + 8)) : 0u;
    }
    float sc[16];
    const float4* sp = reinterpret_cast<const float4*>(
        scales + (size_t)(k0 / GROUP) * N + lcol);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = __ldg(sp + q);
      sc[4 * q] = v.x;
      sc[4 * q + 1] = v.y;
      sc[4 * q + 2] = v.z;
      sc[4 * q + 3] = v.w;
    }
    // tile by tile: the group's exact products summed by the tensor
    // cores into part, then times the column's scale into acc
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float part[4];
#pragma unroll
      for (int ks = 0; ks < GSTEPS; ++ks) {
        uint32_t a[4];
        a_fragment(a, word(wr[ks][0], j / 2), word(wr[ks][1], j / 2), j);
        mma16816(part, a, xb[ks][0], xb[ks][1], ks == 0 ? zero : part);
      }
      add_scaled(acc[j], part, sc[2 * j], sc[2 * j + 1]);
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
  store_cols(acc, out, partial, M, N, 2 * t, col);
}

// -- prefill (M > 8): a GEMM, bound by the operations ------------------------

constexpr int GEMM_WARPS = 4;  // along M
constexpr int GEMM_THREADS = 32 * GEMM_WARPS;

// n8 tiles (8 rows of x each) a warp: 4 (128 rows a block), or 2 at
// group 128, whose x fragments (8 k16 steps) would not fit beside 4.
__host__ __device__ constexpr int gemm_mt(int group) {
  return group > 64 ? 2 : 4;
}
__host__ __device__ constexpr int gemm_rows(int group) {
  return 8 * gemm_mt(group) * GEMM_WARPS;
}

// One stage of the ring, for a group of G = 16 GSTEPS rows of K: the
// block's 128 columns of packed rows as the lanes read them ([k16 step]
// [row t or t + 4][lane], 16 bytes each), their 128 scales, then the
// block's x rows for those G columns of K, each row padded by 16 bytes
// (so the 8 rows x 4 lanes of a B fragment load hit 32 distinct banks).
template <int GSTEPS>
struct GemmSmem {
  static constexpr int ROWS = gemm_rows(16 * GSTEPS);  // rows of x a block
  static constexpr int W = GSTEPS * 2 * 32 * 16;
  static constexpr int SC = TC_COLS * 4;
  static constexpr int XROW = GSTEPS * 32 + 16;  // G bf16 + 16 bytes
  static constexpr int STAGE = W + SC + ROWS * XROW;
  // 4 stages, or as many as 110 KB hold (2 blocks an SM)
  static constexpr int STAGES = 110 * 1024 / STAGE < 4 ? 110 * 1024 / STAGE
                                                        : 4;
  static_assert(STAGES >= 2, "a ring needs two stages");
  static constexpr int BYTES = STAGES * STAGE;
};

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

__device__ __forceinline__ uint32_t lds32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float2 lds64f(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// Stage one group (K rows k0 .. k0 + G - 1) of the block's columns and
// rows into a ring slot, the block's threads sharing the copies.
template <int GSTEPS>
__device__ __forceinline__ void stage_group(
    uint32_t st, const __nv_bfloat16* __restrict__ x,
    const int8_t* __restrict__ w, const float* __restrict__ scales, int M,
    int K, int N, int col0, int row0, int k0) {
  using Sm = GemmSmem<GSTEPS>;
  for (int c = threadIdx.x; c < GSTEPS * 2 * 32; c += GEMM_THREADS) {
    // chunk (k16 step, row t or t + 4, lane): packed row k0 / 2 + 8 ks +
    // 4 half + lane % 4, columns 16 (lane / 4) ..
    const int lane = c & 31, half = (c >> 5) & 1, ks = c >> 6;
    const int col = col0 + 16 * (lane >> 2);
    const size_t prow = (size_t)(k0 / 2 + 8 * ks + 4 * half + (lane & 3));
    const bool ok = col < N;
    cp16(st + 16 * c, w + prow * N + (ok ? col : 0), ok ? 16 : 0);
  }
  if (threadIdx.x < TC_COLS / 4) {
    const int col = col0 + 4 * threadIdx.x;
    const bool ok = col < N;
    cp16(st + Sm::W + 16 * threadIdx.x,
         scales + (size_t)(k0 / (16 * GSTEPS)) * N + (ok ? col : 0),
         ok ? 16 : 0);
  }
  constexpr int XCHUNKS = GSTEPS * 2;  // 16-byte chunks of a row's group
  for (int c = threadIdx.x; c < Sm::ROWS * XCHUNKS; c += GEMM_THREADS) {
    const int r = c / XCHUNKS, q = c % XCHUNKS;
    const int row = row0 + r;
    const bool ok = row < M;
    cp16(st + Sm::W + Sm::SC + r * Sm::XROW + 16 * q,
         x + (size_t)(ok ? row : 0) * K + k0 + 8 * q, ok ? 16 : 0);
  }
}

template <int GSTEPS>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
q4mm_gemm_kernel(const __nv_bfloat16* __restrict__ x,
                 const int8_t* __restrict__ w,
                 const float* __restrict__ scales,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ partial,
                 int M, int K, int N, int k_per_split) {
  using Sm = GemmSmem<GSTEPS>;
  constexpr int MT = gemm_mt(16 * GSTEPS);
  constexpr int STAGES = Sm::STAGES;
  constexpr int GROUP = 16 * GSTEPS;
  extern __shared__ __align__(16) uint8_t gsmem[];
  const uint32_t ring =
      static_cast<uint32_t>(__cvta_generic_to_shared(gsmem));

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int col0 = blockIdx.x * TC_COLS;
  const int col = col0 + 16 * g;  // the lane's 16 output columns
  const int row0 = blockIdx.y * Sm::ROWS;
  const int m0 = row0 + warp * 8 * MT;  // the warp's first row
  const int kbeg = blockIdx.z * k_per_split;
  const int n_grp = (min(K, kbeg + k_per_split) - kbeg) / GROUP;

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  // the ring: STAGES - 1 groups ahead; one commit a slot, empty or not,
  // so that wait_group counts slots
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_grp)
      stage_group<GSTEPS>(ring + s * Sm::STAGE, x, w, scales, M, K, N, col0,
                          row0, kbeg + s * GROUP);
    cp_commit();
  }
  const float zero[4] = {0.f, 0.f, 0.f, 0.f};
  for (int i = 0; i < n_grp; ++i) {
    cp_wait<STAGES - 2>();  // this thread's copies of group i
    __syncthreads();        // everyone's; and slot i - 1 is free
    const int next = i + STAGES - 1;
    if (next < n_grp)
      stage_group<GSTEPS>(ring + (next % STAGES) * Sm::STAGE, x, w, scales,
                          M, K, N, col0, row0, kbeg + next * GROUP);
    cp_commit();
    if (m0 >= M) continue;  // warp-uniform: rows past M
    const uint32_t st = ring + (i % STAGES) * Sm::STAGE;
    // x's B fragments of the warp's rows: row 8 mt + g, k 16 ks + 2t
    // (and + 8)
    uint32_t xb[GSTEPS][MT][2];
#pragma unroll
    for (int ks = 0; ks < GSTEPS; ++ks)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const uint32_t a = st + Sm::W + Sm::SC +
                           (warp * 8 * MT + 8 * mt + g) * Sm::XROW +
                           (16 * ks + 2 * t) * 2;
        xb[ks][mt][0] = lds32(a);
        xb[ks][mt][1] = lds32(a + 16);
      }
    // tile by tile: the group's exact products summed by the tensor
    // cores into part, then times the column's scale into acc. A weight
    // word is read from shared memory where it is used (4-byte loads of
    // 16-byte chunks meet 4-way bank conflicts, but leave the registers
    // to the 4 n8 tiles).
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float part[MT][4];
#pragma unroll
      for (int ks = 0; ks < GSTEPS; ++ks) {
        const uint32_t wa = st + (2 * ks * 32 + lane) * 16 + 4 * (j / 2);
        uint32_t a[4];
        a_fragment(a, lds32(wa), lds32(wa + 32 * 16), j);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma16816(part[mt], a, xb[ks][mt][0], xb[ks][mt][1],
                   ks == 0 ? zero : part[mt]);
      }
      const float2 sc = lds64f(st + Sm::W + 4 * (16 * g + 2 * j));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        add_scaled(acc[mt][j], part[mt], sc.x, sc.y);
    }
  }
  // x rows m0 + 8 mt + 2t (c0, c2) and + 1 (c1, c3)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_cols(acc[mt], out, partial, M, N, m0 + 8 * mt + 2 * t, col);
}

// The tensor-core path takes bf16 x at N a multiple of 16 and group 32,
// 64 or 128.
bool tc_takes(int N, int group) {
  return N % 16 == 0 && (group == 32 || group == 64 || group == 128);
}

// Splits of K for the tensor-core path, in whole groups: as many as keep
// the grid within one wave of 2 blocks an SM (a second, partial wave
// costs more than idle SMs), with at least 8 groups a split (one for
// each warp of a decode block, two ring's worth at prefill).
void tc_plan(int M, int K, int N, int group, int sm_count, int* splits,
             int* k_per_split) {
  const long groups = K / group;
  const long rows =
      M <= 8 ? 1 : (M + gemm_rows(group) - 1) / gemm_rows(group);
  const long tiles = (long)((N + TC_COLS - 1) / TC_COLS) * rows;
  long s = 2L * sm_count / tiles;
  if (s > groups / 8) s = groups / 8;
  if (s < 1) s = 1;
  const long per = groups > 0 ? (groups + s - 1) / s : 1;
  *k_per_split = static_cast<int>(per * group);
  *splits = static_cast<int>(groups > 0 ? (groups + per - 1) / per : 1);
}

template <int GSTEPS>
cudaError_t tc_launch(const void* x, const void* w, const void* scales,
                      void* out, void* partial, int M, int K, int N,
                      int splits, int k_per_split, cudaStream_t st) {
  const auto xp = static_cast<const __nv_bfloat16*>(x);
  const auto wp = static_cast<const int8_t*>(w);
  const auto sp = static_cast<const float*>(scales);
  const auto op = static_cast<__nv_bfloat16*>(out);
  const auto pp = static_cast<float*>(partial);
  const unsigned cols = (N + TC_COLS - 1) / TC_COLS;
  if (M <= 8) {
    q4mm_gemv_kernel<GSTEPS><<<dim3(cols, 1, splits), 32 * GEMV_WARPS, 0,
                               st>>>(xp, wp, sp, op, pp, M, K, N,
                                     k_per_split);
    return cudaSuccess;
  }
  using Sm = GemmSmem<GSTEPS>;
  cudaError_t err = cudaFuncSetAttribute(
      q4mm_gemm_kernel<GSTEPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Sm::BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid(cols, (M + Sm::ROWS - 1) / Sm::ROWS, splits);
  q4mm_gemm_kernel<GSTEPS><<<grid, GEMM_THREADS, Sm::BYTES, st>>>(
      xp, wp, sp, op, pp, M, K, N, k_per_split);
  return cudaSuccess;
}

int launch_tc(const void* x, const void* w, const void* scales, void* out,
              void* partial, int M, int K, int N, int group, int splits,
              int k_per_split, void* stream) {
  // refused, never launched: K not a whole number of groups, x, packed
  // rows, scales, out or the partial sums not 16-byte aligned (16-byte
  // loads and copies), a split that is not whole groups, or a split plan
  // without its fp32 workspace
  if (group < 1 || K % group != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scales) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(partial) % 16 != 0 || splits < 1 ||
      k_per_split < group || k_per_split % group != 0 ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      group == 32   ? tc_launch<2>(x, w, scales, out, partial, M, K, N,
                                   splits, k_per_split, st)
      : group == 64 ? tc_launch<4>(x, w, scales, out, partial, M, K, N,
                                   splits, k_per_split, st)
                    : tc_launch<8>(x, w, scales, out, partial, M, K, N,
                                   splits, k_per_split, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    size_t blocks = ((size_t)M * N + 255) / 256;
    if (blocks > 65535) blocks = 65535;
    q4mm_reduce<__nv_bfloat16><<<(unsigned)blocks, 256, 0, st>>>(
        static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(out),
        M, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

// The CUDA-core path's split: only when the (M, N) tiles alone would
// leave fewer than BLOCKS_PER_SM blocks an SM (decode at small N); a
// split covers whole CHUNK-row steps (so whole packed rows).
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

}  // namespace

extern "C" {

// How to split K for (M, K, N) at `group` with x in bf16 (x_bf16 = 1) or
// fp32 on a card of sm_count SMs, for the path q4mm_bf16 / q4mm_f32
// takes: the tensor-core path splits in whole groups, at least one a
// warp along K; the CUDA-core path in whole CHUNK-row steps. The caller
// gives q4mm_* an fp32 workspace of splits * M * N when splits > 1.
int q4mm_plan(int M, int K, int N, int group, int x_bf16, int sm_count,
              int* splits, int* k_per_split) {
  if (M <= 0 || N <= 0 || K < 0 || group < 1 || sm_count < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_bf16 && tc_takes(N, group)) {
    tc_plan(M, K, N, group, sm_count, splits, k_per_split);
  } else {
    simt_plan(M, K, N, sm_count, splits, k_per_split);
  }
  return 0;
}

int q4mm_bf16(const void* x, const void* w, const void* scales, void* out,
              void* partial, int M, int K, int N, int group, int splits,
              int k_per_split, void* stream) {
  if (tc_takes(N, group))
    return launch_tc(x, w, scales, out, partial, M, K, N, group, splits,
                     k_per_split, stream);
  return launch_simt<__nv_bfloat16>(x, w, scales, out, partial, M, K, N,
                                    group, splits, k_per_split, stream);
}

int q4mm_f32(const void* x, const void* w, const void* scales, void* out,
             void* partial, int M, int K, int N, int group, int splits,
             int k_per_split, void* stream) {
  return launch_simt<float>(x, w, scales, out, partial, M, K, N, group,
                            splits, k_per_split, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
