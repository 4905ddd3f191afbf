// Flash attention for Hopper (sm_90a): the forward with its per-row
// logsumexp, and the two backward kernels (dq; dk and dv), bf16 in and
// out, fp32 softmax state and accumulators.
//
// Replaces: sparkdl_tpu/ops/pallas/flash_attention.py, the bodies
// _make_kernel (the forward, called through flash_attention_bhsd),
// _make_dq_kernel and _make_dkv_kernel (both called through
// flash_attention_bwd_bhsd). Same contract and numerics: scores
// s = q.k * scale in fp32; causal and ragged keys masked to -1e30 in the
// forward (a row whose running max is still <= -1e30 / 2 takes p = 0),
// zero probability in the backward; running max m, sum l and the (rows,
// D) accumulator in fp32; p cast to bf16 before the PV product; out =
// acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)). Backward:
// p = exp(s - lse), ds = p (dp - delta) scale with dp = do.v and delta =
// sum(do * o) computed by the caller; dq = sum ds k, dk = sum ds^T q,
// dv = sum p^T do, ds and p cast to bf16 before their products.
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous (B, S, H, D), the
// models' own layout (no transposes), k and v with as many heads as q
// (GQA repeated by the caller); lse and delta are (B, H, S) fp32. Any
// S: keys >= S are masked here and rows >= S are neither read (zeros
// are staged instead) nor written, so the caller pads nothing.
//
// What bounds it: operations. A (b, h) slice does 4 (forward), 6 (dq)
// or 8 (dk/dv) * D flops a visible (query, key) pair on bf16 operands,
// and reads each of q, k, v, do once a tile: at S = 2048 and D = 128
// that is ~500 flops a byte, above the card's ~295 of bf16 tensor-core
// flops a byte of HBM.
//
// Design: the products run on the tensor cores through warp-level
// mma.sync m16n8k16 (bf16 operands, fp32 accumulators). A block of 4
// warps owns 64 rows (q rows for the forward and dq, keys for dk/dv);
// each warp owns 16 of them and keeps their accumulators in registers,
// so no warp ever reduces with another and neither backward kernel needs
// atomics: the results are deterministic. The other operand streams
// through shared memory in tiles of 64 rows (rows padded by 8 bf16 so
// the fragment loads hit 32 distinct banks). The TPU's sequential grid
// axis becomes that loop inside the block, pruned by the causal bound:
// the forward and dq visit kv tiles up to the diagonal, dk/dv visits q
// tiles from the diagonal on. A score tile's fp32 accumulator fragment
// is, register for register, the A operand of the next product once it
// is packed to bf16, so p and ds never leave registers. dk/dv walks each
// q tile in two halves of 32 columns to keep two (16, D) accumulators
// within the register file. Known limits of this first version: loads
// are synchronous (no cp.async/TMA pipeline), mma.sync instead of
// wgmma, and GQA is repeated by the caller rather than read in place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;              // rows of a q tile and of a kv tile
constexpr int WARPS = 4;               // 16 rows of the block each
constexpr int THREADS = WARPS * 32;
constexpr int PAD = 8;                 // bf16 of padding a shared-memory row
constexpr float NEG_INF = -1e30f;

// D * 2 bytes a row, staged as 16-byte vectors; rows >= S become zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint16_t* tile,
                                          const __nv_bfloat16* src,
                                          size_t row_stride, int row0,
                                          int S) {
  constexpr int LD = D + PAD;
  constexpr int VECS = D / 8;
  for (int i = threadIdx.x; i < BLOCK * VECS; i += THREADS) {
    const int r = i / VECS, c8 = (i % VECS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(
          src + (size_t)(row0 + r) * row_stride + c8);
    *reinterpret_cast<uint4*>(tile + r * LD + c8) = val;
  }
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats as one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// In the m16n8k16 fragments, lane = 4 g + t: A holds rows g and g + 8 at
// columns 2t, 2t + 1 (and + 8); B holds column g at rows 2t, 2t + 1 (and
// + 8); C holds rows g and g + 8 at columns 2t, 2t + 1.

// A fragment: rows row0.. of a tile, depth k0..k0 + 15.
__device__ __forceinline__ void load_a(uint32_t* a, const uint16_t* t,
                                       int LD, int row0, int k0, int lane) {
  const uint16_t* p = t + (row0 + (lane >> 2)) * LD + k0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// B fragment with B[k][n] = t[n0 + n][k0 + k]: the tile's rows are the
// product's columns (K for q.k^T, V for do.v^T, Q and dO for dk/dv's
// scores); pairs along k are adjacent.
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const uint16_t* t, int LD, int n0,
                                            int k0, int lane) {
  const uint16_t* p = t + (n0 + (lane >> 2)) * LD + k0 + (lane & 3) * 2;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment with B[k][n] = t[k0 + k][n0 + n]: the tile's rows are the
// product's depth (V for p.v, K for ds.k, Q and dO for dk/dv).
__device__ __forceinline__ void load_b_cols(uint32_t& b0, uint32_t& b1,
                                            const uint16_t* t, int LD, int k0,
                                            int n0, int lane) {
  const uint16_t* p = t + (k0 + (lane & 3) * 2) * LD + n0 + (lane >> 2);
  b0 = uint32_t(p[0]) | (uint32_t(p[LD]) << 16);
  b1 = uint32_t(p[8 * LD]) | (uint32_t(p[9 * LD]) << 16);
}

// A fragment of depth chunk kk from a C-fragment score tile s[n][4]:
// columns 16 kk .. 16 kk + 15 are the n-tiles 2 kk and 2 kk + 1.
__device__ __forceinline__ void c_to_a(uint32_t* a, float (*s)[4], int kk) {
  a[0] = pack(s[2 * kk][0], s[2 * kk][1]);
  a[1] = pack(s[2 * kk][2], s[2 * kk][3]);
  a[2] = pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  a[3] = pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// Rows g and g + 8 of a (16, D) accumulator, as bf16, rows >= S skipped.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           size_t row_stride, int row_a,
                                           int S, float (*acc)[4],
                                           const float* inv, int lane) {
  const int c = (lane & 3) * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= S) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(
        dst + (size_t)row * row_stride + c);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      out[nt * 4] = pack(acc[nt][2 * r] * inv[r], acc[nt][2 * r + 1] * inv[r]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int S, int H, int causal, float scale) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* ks = qs + BLOCK * LD;
  uint16_t* vs = ks + BLOCK * LD;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (lane & 3) * 2;
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;
  const int q0 = qt * BLOCK;
  const int row_a = q0 + warp * 16 + (lane >> 2);

  load_tile<D>(qs, q + base, stride, q0, S);
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    load_a(qf[kk], qs, LD, warp * 16, kk * 16, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  const int n_kv = (S + BLOCK - 1) / BLOCK;
  const int upper = causal ? min(qt + 1, n_kv) : n_kv;
  for (int j = 0; j < upper; ++j) {
    __syncthreads();  // every warp is done with the previous tile
    load_tile<D>(ks, k + base, stride, j * BLOCK, S);
    load_tile<D>(vs, v + base, stride, j * BLOCK, S);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, ks, LD, nt * 8, kk * 16, lane);
        mma(s[nt], qf[kk], b0, b1);
      }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row_a + 8 * (e >> 1);
        const int col = j * BLOCK + nt * 8 + c + (e & 1);
        float x = s[nt][e] * scale;
        if (col >= S || (causal && col > row)) x = NEG_INF;
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
    bool dead[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a quad hold the 64 columns of a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      dead[r] = m_new <= NEG_INF / 2;
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = dead[r] ? 0.f : expf(s[nt][e] - m[r]);
        s[nt][e] = p;
        rs[r] += p;
      }
    // l stays a per-lane partial sum (alpha is the same on the 4 lanes
    // of a row); the quad adds its partials once, after the loop
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= alpha[e >> 1];

#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, vs, LD, kk * 16, nt * 8, lane);
        mma(acc[nt], a, b0, b1);
      }
    }
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lc = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / lc;
    const int row = row_a + 8 * r;
    if ((lane & 3) == 0 && row < S)
      lse[((size_t)b * H + h) * S + row] = m[r] + logf(lc);
  }
  store_rows<D>(o + base, stride, row_a, S, acc, inv, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int S, int H,
                        int causal, float scale) {
  constexpr int LD = D + PAD;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* dos = qs + BLOCK * LD;
  uint16_t* ks = dos + BLOCK * LD;
  uint16_t* vs = ks + BLOCK * LD;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (lane & 3) * 2;
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;
  const size_t vec = ((size_t)b * H + h) * S;
  const int q0 = qt * BLOCK;
  const int row_a = q0 + warp * 16 + (lane >> 2);

  load_tile<D>(qs, q + base, stride, q0, S);
  load_tile<D>(dos, dout + base, stride, q0, S);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse_r[r] = row < S ? lse[vec + row] : 0.f;
    delta_r[r] = row < S ? delta[vec + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int n_kv = (S + BLOCK - 1) / BLOCK;
  const int upper = causal ? min(qt + 1, n_kv) : n_kv;
  for (int j = 0; j < upper; ++j) {
    __syncthreads();
    load_tile<D>(ks, k + base, stride, j * BLOCK, S);
    load_tile<D>(vs, v + base, stride, j * BLOCK, S);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      load_a(aq, qs, LD, warp * 16, kk * 16, lane);
      load_a(ado, dos, LD, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, ks, LD, nt * 8, kk * 16, lane);
        mma(s[nt], aq, b0, b1);
        load_b_rows(b0, b1, vs, LD, nt * 8, kk * 16, lane);
        mma(dp[nt], ado, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int row = row_a + 8 * r;
        const int col = j * BLOCK + nt * 8 + c + (e & 1);
        float p = expf(s[nt][e] * scale - lse_r[r]);
        if (col >= S || (causal && col > row)) p = 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[r]) * scale;  // ds
      }
#pragma unroll
    for (int kk = 0; kk < BLOCK / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s, kk);
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t b0, b1;
        load_b_cols(b0, b1, ks, LD, kk * 16, nt * 8, lane);
        mma(acc[nt], a, b0, b1);
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + base, stride, row_a, S, acc, one, lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int H,
                         int causal, float scale) {
  constexpr int LD = D + PAD;
  constexpr int HALF = BLOCK / 2;  // q columns a pass
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;
  uint16_t* vs = ks + BLOCK * LD;
  uint16_t* qs = vs + BLOCK * LD;
  uint16_t* dos = qs + BLOCK * LD;
  float* lse_s = reinterpret_cast<float*>(dos + BLOCK * LD);
  float* delta_s = lse_s + BLOCK;
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = (lane & 3) * 2;
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;
  const size_t vec = ((size_t)b * H + h) * S;
  const int k0 = kt * BLOCK;
  const int key_a = k0 + warp * 16 + (lane >> 2);

  load_tile<D>(ks, k + base, stride, k0, S);
  load_tile<D>(vs, v + base, stride, k0, S);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;

  const int n_q = (S + BLOCK - 1) / BLOCK;
  for (int i = causal ? kt : 0; i < n_q; ++i) {
    const int i0 = i * BLOCK;
    __syncthreads();
    load_tile<D>(qs, q + base, stride, i0, S);
    load_tile<D>(dos, dout + base, stride, i0, S);
    if (threadIdx.x < BLOCK) {
      const int row = i0 + threadIdx.x;
      lse_s[threadIdx.x] = row < S ? lse[vec + row] : 0.f;
      delta_s[threadIdx.x] = row < S ? delta[vec + row] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n0 = half * HALF;
      // s^T = k.q^T and dp^T = v.do^T: this warp's 16 keys x 32 queries
      float s[HALF / 8][4], dp[HALF / 8][4];
#pragma unroll
      for (int nt = 0; nt < HALF / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        load_a(ak, ks, LD, warp * 16, kk * 16, lane);
        load_a(av, vs, LD, warp * 16, kk * 16, lane);
#pragma unroll
        for (int nt = 0; nt < HALF / 8; ++nt) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, qs, LD, n0 + nt * 8, kk * 16, lane);
          mma(s[nt], ak, b0, b1);
          load_b_rows(b0, b1, dos, LD, n0 + nt * 8, kk * 16, lane);
          mma(dp[nt], av, b0, b1);
        }
      }
#pragma unroll
      for (int nt = 0; nt < HALF / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_a + 8 * (e >> 1);
          const int col = n0 + nt * 8 + c + (e & 1);
          const int row = i0 + col;
          float p = expf(s[nt][e] * scale - lse_s[col]);
          if (row >= S || (causal && row < key)) p = 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - delta_s[col]) * scale;  // ds^T
        }
      // dv += p^T do, dk += ds^T q over these 32 queries
#pragma unroll
      for (int kk = 0; kk < HALF / 16; ++kk) {
        uint32_t ap[4], ads[4];
        c_to_a(ap, s, kk);
        c_to_a(ads, dp, kk);
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          uint32_t b0, b1;
          load_b_cols(b0, b1, dos, LD, n0 + kk * 16, nt * 8, lane);
          mma(dv_acc[nt], ap, b0, b1);
          load_b_cols(b0, b1, qs, LD, n0 + kk * 16, nt * 8, lane);
          mma(dk_acc[nt], ads, b0, b1);
        }
      }
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dk + base, stride, key_a, S, dk_acc, one, lane);
  store_rows<D>(dv + base, stride, key_a, S, dv_acc, one, lane);
}

// Shapes this tiling cannot take are refused, never launched: a head
// dim other than 64 or 128, a grid above the card's limits, a pointer
// not 16-byte aligned (the tiles are staged as 16-byte vectors); a
// shared-memory need above the card's limit fails in
// cudaFuncSetAttribute.
bool refused(int B, int S, int H, int D, const void* const* ptrs, int n) {
  if (B <= 0 || S <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      (D != 64 && D != 128))
    return true;
  for (int i = 0; i < n; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) return true;
  return false;
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int S, int H, int causal, float scale, cudaStream_t stream) {
  const size_t smem = 3 * BLOCK * (D + PAD) * sizeof(uint16_t);
  cudaError_t err = prepare(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BLOCK - 1) / BLOCK, H, B);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int S, int H,
           int causal, float scale, cudaStream_t stream) {
  const size_t smem = 4 * BLOCK * (D + PAD) * sizeof(uint16_t);
  cudaError_t err = prepare(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BLOCK - 1) / BLOCK, H, B);
  flash_bwd_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dq), S, H, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            int S, int H, int causal, float scale, cudaStream_t stream) {
  const size_t smem = 4 * BLOCK * (D + PAD) * sizeof(uint16_t) +
                      2 * BLOCK * sizeof(float);
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + BLOCK - 1) / BLOCK, H, B);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), S, H,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o: (B, S, H, D) bf16; lse: (B, H, S) fp32.
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, int B, int S, int H, int D, int causal, float scale,
              void* stream) {
  const void* ptrs[] = {q, k, v, o};
  if (refused(B, S, H, D, ptrs, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64 ? fwd<64>(q, k, v, o, lse, B, S, H, causal, scale, st)
                 : fwd<128>(q, k, v, o, lse, B, S, H, causal, scale, st);
}

// dout, dq: (B, S, H, D) bf16; lse, delta: (B, H, S) fp32.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int B, int S, int H, int D, int causal,
                 float scale, void* stream) {
  const void* ptrs[] = {q, k, v, dout, dq};
  if (refused(B, S, H, D, ptrs, 5))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64
             ? bwd_dq<64>(q, k, v, dout, lse, delta, dq, B, S, H, causal,
                          scale, st)
             : bwd_dq<128>(q, k, v, dout, lse, delta, dq, B, S, H, causal,
                           scale, st);
}

// dk, dv: (B, S, H, D) bf16.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int B, int S, int H, int D, int causal,
                  float scale, void* stream) {
  const void* ptrs[] = {q, k, v, dout, dk, dv};
  if (refused(B, S, H, D, ptrs, 6))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 64
             ? bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                           causal, scale, st)
             : bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S, H,
                            causal, scale, st);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
