// Flash attention for Hopper (sm_90a): the forward with its per-row
// logsumexp, and the two backward kernels (dq; dk and dv), bf16 in and
// out, fp32 softmax state and accumulators.
//
// Replaces: sparkdl_tpu/ops/pallas/flash_attention.py, the bodies
// _make_kernel (the forward, called through flash_attention_bhsd),
// _make_dq_kernel and _make_dkv_kernel (both called through
// flash_attention_bwd_bhsd). Same contract and numerics: scores
// s = q.k * scale in fp32; causal and ragged keys masked to -1e30 in the
// forward (there the raw q.k takes -1e30 / scale; a row whose running
// max is still <= -1e30 / 2 takes p = 0),
// zero probability in the backward; running max m, sum l and the (rows,
// D) accumulator in fp32; p cast to bf16 before the PV product; out =
// acc / max(l, 1e-30), lse = m + log(max(l, 1e-30)). Backward:
// p = exp(s - lse), ds = p (dp - delta) scale with dp = do.v and delta =
// sum(do * o) computed by the caller; dq = sum ds k, dk = sum ds^T q,
// dv = sum p^T do, ds and p cast to bf16 before their products. All
// three take exponentials as exp2 with log2(e) folded into the scale
// (and into lse); lse is returned in natural-log units.
//
// Layout: q, k, v, o, do, dq, dk, dv are contiguous (B, S, H, D), the
// models' own layout (no transposes), k and v with as many heads as q
// (GQA repeated by the caller); lse and delta are (B, H, S) fp32. Any
// S: keys >= S are masked here and rows >= S are neither read (zeros
// are staged instead) nor written, so the caller pads nothing.
//
// What bounds them: operations. A (b, h) slice does 4 (forward), 6 (dq)
// or 8 (dk/dv) * D flops a visible (query, key) pair on bf16 operands,
// and reads each of q, k, v, do once a tile: at S = 2048 and D = 128
// that is ~500 flops a byte, above the card's ~295 of bf16 tensor-core
// flops a byte of HBM. Only wgmma reaches the tensor cores' full rate.
//
// Forward and dq (flash_fwd_kernel, flash_bwd_dq_kernel): one Hopper
// mainloop, warp-specialised; hopper.cuh holds the pieces (tensor maps,
// mbarriers, TMA, smem descriptors, wgmma). A block of 384 threads owns
// 128 q rows of one (b, h): warpgroup 0 is the producer, warpgroups 1
// and 2 are consumers of 64 rows each. setmaxnreg gives the producer 40
// registers a thread and the consumers 232 (ptxas allots 168 to all at
// launch). One producer thread loads the block's q tile (and, for dq,
// its do tile) once by TMA, then streams k and v tiles through two
// rings of 2 stages in 128-byte-swizzled shared memory: each stage has a
// full mbarrier, completed by the TMA's bytes, and an empty one, which
// each of the 8 consumer warps arrives on once the products that read
// the tile have retired. k and v have rings of their own, so a k tile
// is released while its v tile is still in use.
//
// Forward: 128-key tiles (q 32 KB + 2 x (32 + 32) KB at D = 128).
// S = q k^T is wgmma m64n128k16 with both operands in shared memory (k
// K-major, as stored); the softmax runs on the fp32 accumulator fragment
// in registers; p, packed to bf16, is the register A operand of
// O += p v (wgmma m64nDk16, v MN-major through the transpose bit). A
// consumer's phase i issues O += p_{i-1} v_{i-1} and S = q k_i^T
// together, then runs tile i's softmax while the other consumer, whose
// turn comes next (two named barriers alternate the turns), holds the
// tensor cores. The row max is taken on raw scores and a probability is
// one FFMA and one ex2.approx; the mask is applied only on a tile that
// can hide a key (walking from the causal bound down, the first one).
// dq: 64-key tiles (q and do 32 KB each + 2 x (16 + 16) KB at D = 128);
// S = q k^T and dP = do v^T are two shared-memory wgmmas in flight
// together (p is computed while dP still runs), and dQ += ds k takes ds
// from registers and k MN-major. lse and delta are read once into
// registers; the first consumer skips a tile wholly above its rows.
// Both kernels put the q tiles of one (b, h) in consecutive blocks, the
// heaviest causal tile first, so a slice's k and v are read from L2 by
// blocks running together. No atomics: dq is deterministic.
//
// dk/dv (flash_bwd_dkv_kernel): the same warp-specialised shape, turned
// key-stationary. A block owns 128 keys of one (b, h), 64 for each
// consumer warpgroup, so no two warpgroups write one row and the kernel
// needs no atomics: dk and dv are deterministic. Setmaxnreg gives the
// producer 24 registers a thread and the consumers 240: a consumer
// holds dk and dv for its 64 keys (64 + 64 fp32 a thread at D = 128) and
// s^T, dp^T of a 64-row q tile (32 + 32). The producer warp loads the
// block's k and v tiles once by TMA, then streams q and do tiles of 64
// rows through a ring of 2 stages (128-byte swizzle); each stage also
// carries its rows' lse * log2(e) and delta, which the producer's lanes
// store beside the TMA and arrive for on the stage's full barrier. A
// consumer's tile: s^T = k q^T and dp^T = v do^T, two shared-memory
// wgmmas in flight together (k and v K-major from rows 64 cw of the
// block's tiles, q and do K-major); p = 2^(s scale log2(e) - lse
// log2(e)) by one FFMA and one ex2.approx while dp^T still runs; ds =
// p (dp - delta) scale; p and ds packed to bf16 in registers are the A
// operands of dV += p^T do and dK += ds^T q, with do and q MN-major
// through the transpose bit (the q rows are the products' depth). The
// TPU's sequential grid axis becomes the loop over q tiles, which starts
// at the block's diagonal when causal; only the diagonal tile and the
// one holding row S - 1 are masked (rows >= S arrive as zeros and are
// masked by row). A (b, h)'s key blocks are consecutive blocks, key block
// 0 (the heaviest causal one) first, so q and do are read from L2 by
// blocks running together.
//
// Known limits: a consumer does not overlap its softmax with the next
// tile's products (the two warpgroups interleave on the tensor cores);
// every 128-row (forward, dq) or 128-key (dk/dv) block reads its
// streamed tiles again from L2 (no cluster multicast); the grids are
// not persistent; GQA is repeated by the caller rather than read in
// place.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// Two floats as one bf16x2 register, the first in the low half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A score or output tile's fp32 accumulator in registers, as [n8
// block][4]: mma.sync's C fragment, and a wgmma m64 fragment is one per
// warp (16 rows a warp). Lane = 4 g + t holds rows g and g + 8 at
// columns 2t, 2t + 1 of each 8-column block.

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

// ---- forward and dq: warp-specialised wgmma mainloop (hopper.cuh) -------

constexpr int HBLOCK = 128;     // q rows of a block (2 consumer warpgroups)
constexpr int HTHREADS = 384;   // producer warpgroup + 2 consumers
constexpr int STAGES = 2;       // k/v ring depth
constexpr int FWD_BN = 128;     // keys of a forward tile
constexpr int DQ_BN = 64;       // keys of a dq tile
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of the two kernels, byte offsets from a 1024-byte
// aligned base: the q (and do) tile, the rings' k and v tiles, then the
// mbarriers: q_full, k_full[STAGES], v_full[STAGES], k_empty[STAGES],
// v_empty[STAGES].
template <int D, int BN, int ROW_TILES>
struct HopperSmem {
  static constexpr int ROWS = HBLOCK * D * 2;   // a q or do tile
  static constexpr int TILE = BN * D * 2;       // a k or v tile
  static constexpr int K0 = ROW_TILES * ROWS;
  static constexpr int V0 = K0 + STAGES * TILE;
  static constexpr int BAR = V0 + STAGES * TILE;
  // + the barriers, + slack to align the base
  static constexpr int BYTES = BAR + 8 * (1 + 4 * STAGES) + 1024;
};

// The k ring and the v ring: a stage's full barrier completes with its
// TMA bytes, its empty barrier with one arrival from each of the 8
// consumer warps once their products on the tile have retired.
struct Ring {
  uint32_t bars;
  __device__ uint32_t q_full() const { return bars; }
  __device__ uint32_t k_full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const {
    return bars + 8 * (1 + STAGES + s);
  }
  __device__ uint32_t k_empty(int s) const {
    return bars + 8 * (1 + 2 * STAGES + s);
  }
  __device__ uint32_t v_empty(int s) const {
    return bars + 8 * (1 + 3 * STAGES + s);
  }
  __device__ void init() const {
    hopper::mbar_init(q_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(k_empty(s), 8);
      hopper::mbar_init(v_empty(s), 8);
    }
    hopper::mbar_fence_init();
  }
};

// Block -> (q tile, head, batch): the q tiles of one (b, h) are
// consecutive blocks, so they run together and read that slice's k and
// v from L2 (at B 2, H 32, S 2048, D 128 all of k and v, 64 MB, exceed
// the 50 MB L2), and within a slice the last (heaviest causal) q tile
// comes first.
struct BlockTile {
  int qt, h, b;
  __device__ BlockTile(int S, int H) {
    const int n_q = (S + HBLOCK - 1) / HBLOCK;
    const int bh = blockIdx.x / n_q;
    qt = n_q - 1 - blockIdx.x % n_q;
    h = bh % H;
    b = bh / H;
  }
};

// The producer thread: q (and do) once, then the k and v tiles of
// indices n_tiles - 1 down to 0 through the ring.
template <int D, int BN, int ROW_TILES, typename Smem>
__device__ __forceinline__ void produce(const Ring& ring, uint32_t base,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tdo,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int h, int b,
                                        int q0, int n_tiles) {
  hopper::tma_prefetch(tq);
  hopper::tma_prefetch(tk);
  hopper::tma_prefetch(tv);
  if constexpr (ROW_TILES == 2) hopper::tma_prefetch(tdo);
  hopper::mbar_expect_tx(ring.q_full(), ROW_TILES * Smem::ROWS);
  hopper::tma_tile<D>(base, tq, ring.q_full(), HBLOCK, h, q0, b);
  if constexpr (ROW_TILES == 2)
    hopper::tma_tile<D>(base + Smem::ROWS, tdo, ring.q_full(), HBLOCK, h, q0,
                        b);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int j = n_tiles - 1 - i;
    const uint32_t free = ((i / STAGES) & 1) ^ 1;
    hopper::mbar_wait(ring.k_empty(s), free);
    hopper::mbar_expect_tx(ring.k_full(s), Smem::TILE);
    hopper::tma_tile<D>(base + Smem::K0 + s * Smem::TILE, tk, ring.k_full(s),
                        BN, h, j * BN, b);
    hopper::mbar_wait(ring.v_empty(s), free);
    hopper::mbar_expect_tx(ring.v_full(s), Smem::TILE);
    hopper::tma_tile<D>(base + Smem::V0 + s * Smem::TILE, tv, ring.v_full(s),
                        BN, h, j * BN, b);
  }
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int S, int H, int causal, float scale,
                     float scale_log2) {
  using Smem = HopperSmem<D, FWD_BN, 1>;
  constexpr int BN = FWD_BN;
  extern __shared__ __align__(1024) uint8_t hsmem[];
  const uint32_t base = (hopper::smem_u32(hsmem) + 1023u) & ~1023u;
  const Ring ring{base + Smem::BAR};
  const BlockTile tile(S, H);
  const int q0 = tile.qt * HBLOCK;
  const int n_kv = (S + BN - 1) / BN;
  // BN == HBLOCK: q tile qt's causal bound is kv tile qt
  const int n_tiles = causal ? min(tile.qt + 1, n_kv) : n_kv;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      produce<D, BN, 1, Smem>(ring, base, &tq, nullptr, &tk, &tv, tile.h,
                              tile.b, q0, n_tiles);
    return;
  }
  hopper::setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: 64 rows
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int c = (lane & 3) * 2;
  const int row0 = q0 + 64 * cw;
  const int row_a = row0 + warp * 16 + (lane >> 2);  // and row_a + 8

  // 64 x N fp32 wgmma fragments as [n8 block][4]: mma.sync's C layout
  // a warp, so c_to_a and store_rows apply
  float acc[D / 8][4], s[BN / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  uint32_t pa[BN / 16][4];
  // The running max m is kept on u = sign(scale) q.k, whose order is the
  // scaled scores' (so scale q.k = |scale| u), and a masked raw score is
  // -1e30 / scale: u = -1e30 / |scale|.
  const float ascale = fabsf(scale), ascale_log2 = fabsf(scale_log2);
  const float masked = NEG_INF / ascale;
  float m[2] = {masked, masked}, l[2] = {0.f, 0.f};

  // Ping-pong: the two warpgroups take turns to issue their products
  // (named barrier 1 + cw is this warpgroup's turn), so one's softmax
  // runs while the other's products hold the tensor cores. Warpgroup 0
  // goes first; each phase ends by handing the turn over, except the
  // last phase of warpgroup 1, whose turn nobody waits for.
  const int n_phases = n_tiles + 1;
  if (cw == 1) hopper::bar_arrive(1, 256);
  auto take_turn = [&]() { hopper::bar_sync(1 + cw, 256); };
  auto pass_turn = [&](int phase) {
    if (cw == 0 || phase + 1 < n_phases) hopper::bar_arrive(2 - cw, 256);
  };
  auto issue_s = [&](uint32_t kt) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BN>(&s[0][0],
                           hopper::desc_k(base, HBLOCK, 64 * cw, 16 * kk),
                           hopper::desc_k(kt, BN, 0, 16 * kk), kk > 0);
    hopper::wgmma_commit();
  };
  auto issue_pv = [&](uint32_t vt) {
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hopper::wgmma_rs<D>(&acc[0][0], pa[kk],
                          hopper::desc_mn(vt, BN, 16 * kk), 1);
    hopper::wgmma_commit();
  };
  // The softmax of kv tile j's scores in s: the running max and sum,
  // the output rescaled, p packed to bf16 in pa for the next p.v. The
  // max is taken on unscaled scores, so a probability is one FFMA and
  // one ex2: p = 2^(s scale log2(e) - m |scale| log2(e)).
  auto softmax = [&](int j) {
    if ((causal && j * BN + BN - 1 > row0) || (j + 1) * BN > S) {
      // a key of this tile can be hidden from a row: mask it (only the
      // first tile walked, the diagonal or the one holding key S - 1)
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_a + 8 * (e >> 1);
          const int col = j * BN + nt * 8 + c + (e & 1);
          if (col >= S || (causal && col > row))
            s[nt][e] = scale > 0.f ? masked : -masked;
        }
    }
    float mx[2] = {masked, masked};
    if (scale > 0.f) {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
    } else {
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], -s[nt][e]);
    }
    float alpha[2], msub[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the 4 lanes of a quad hold the 128 columns of a row
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = hopper::ex2((m[r] - m_new) * ascale_log2);
      // a row with every key so far masked takes p = 0: 2^(-huge - 0)
      msub[r] = m_new <= masked / 2 ? 0.f : m_new * ascale_log2;
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[nt][e] = hopper::ex2(fmaf(s[nt][e], scale_log2, -msub[e >> 1]));
        rs[e >> 1] += s[nt][e];
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
    for (int kk = 0; kk < BN / 16; ++kk) c_to_a(pa[kk], s, kk);
  };
  auto k_tile = [&](int i) {
    return base + Smem::K0 + (i % STAGES) * Smem::TILE;
  };
  auto v_tile = [&](int i) {
    return base + Smem::V0 + (i % STAGES) * Smem::TILE;
  };
  auto parity = [](int i) { return (uint32_t)((i / STAGES) & 1); };
  auto release = [&](uint32_t bar) {
    if (lane == 0) hopper::mbar_arrive(bar);
  };

  // phase 0: s = q k_0^T. Phase i (1 .. n_tiles - 1): o += p_{i-1} v_{i-1}
  // and s = q k_i^T, both in flight together. The last phase: the last
  // p.v. Tiles are walked from index n_tiles - 1 down.
  hopper::mbar_wait(ring.q_full(), 0);
  for (int i = 0; i < n_phases; ++i) {
    const bool has_s = i < n_tiles, has_pv = i > 0;
    if (has_s) hopper::mbar_wait(ring.k_full(i % STAGES), parity(i));
    if (has_pv)
      hopper::mbar_wait(ring.v_full((i - 1) % STAGES), parity(i - 1));
    take_turn();
    hopper::fence_regs<D / 2>(&acc[0][0]);
    hopper::fence_regs<BN / 2>(&s[0][0]);
    hopper::wgmma_fence();
    if (has_pv) issue_pv(v_tile(i - 1));
    if (has_s) issue_s(k_tile(i));
    pass_turn(i);
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(&acc[0][0]);
    hopper::fence_regs<BN / 2>(&s[0][0]);
    hopper::fence_regs<BN / 4>(&pa[0][0]);  // read by the p.v in flight
    if (has_pv) release(ring.v_empty((i - 1) % STAGES));
    if (has_s) {
      release(ring.k_empty(i % STAGES));
      softmax(n_tiles - 1 - i);
    }
  }

  float inv[2];
  const size_t vec = ((size_t)tile.b * H + tile.h) * S;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float lc = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / lc;
    const int row = row_a + 8 * r;
    if ((lane & 3) == 0 && row < S)
      lse[vec + row] = m[r] * ascale + logf(lc);
  }
  store_rows<D>(o + ((size_t)tile.b * S * H + tile.h) * D, (size_t)H * D,
                row_a, S, acc, inv, lane);
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tdo,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int S, int H,
                        int causal, float scale, float scale_log2) {
  using Smem = HopperSmem<D, DQ_BN, 2>;
  constexpr int BN = DQ_BN;
  extern __shared__ __align__(1024) uint8_t hsmem[];
  const uint32_t base = (hopper::smem_u32(hsmem) + 1023u) & ~1023u;
  const Ring ring{base + Smem::BAR};
  const BlockTile tile(S, H);
  const int q0 = tile.qt * HBLOCK;
  const int n_kv = (S + BN - 1) / BN;
  const int n_tiles =
      causal ? min((q0 + HBLOCK - 1) / BN + 1, n_kv) : n_kv;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0)
      produce<D, BN, 2, Smem>(ring, base, &tq, &tdo, &tk, &tv, tile.h,
                              tile.b, q0, n_tiles);
    return;
  }
  hopper::setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1;
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int c = (lane & 3) * 2;
  const int row0 = q0 + 64 * cw;
  const int row_a = row0 + warp * 16 + (lane >> 2);
  const uint32_t qs = base, dos = base + Smem::ROWS;

  const size_t vec = ((size_t)tile.b * H + tile.h) * S;
  float lse2[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    lse2[r] = row < S ? lse[vec + row] * LOG2E : 0.f;
    delta_r[r] = row < S ? delta[vec + row] : 0.f;
  }
  float acc[D / 8][4], s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
  for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
  uint32_t da[BN / 16][4];

  hopper::mbar_wait(ring.q_full(), 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    const int j = n_tiles - 1 - i;
    const uint32_t kt = base + Smem::K0 + st * Smem::TILE;
    const uint32_t vt = base + Smem::V0 + st * Smem::TILE;
    if (causal && j * BN > row0 + 63) {
      // every key of the tile is above this warpgroup's rows. The stage
      // is still waited for: a parity wait passes at once on a barrier
      // whose previous phase is incomplete, so a consumer that skipped a
      // phase could read the stage's next use before it has arrived
      hopper::mbar_wait(ring.k_full(st), phase);
      hopper::mbar_wait(ring.v_full(st), phase);
      if (lane == 0) {
        hopper::mbar_arrive(ring.k_empty(st));
        hopper::mbar_arrive(ring.v_empty(st));
      }
      continue;
    }

    hopper::mbar_wait(ring.k_full(st), phase);
    hopper::fence_regs<BN / 2>(&s[0][0]);
    hopper::fence_regs<BN / 2>(&dp[0][0]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BN>(&s[0][0],
                           hopper::desc_k(qs, HBLOCK, 64 * cw, 16 * kk),
                           hopper::desc_k(kt, BN, 0, 16 * kk), kk > 0);
    hopper::wgmma_commit();
    hopper::mbar_wait(ring.v_full(st), phase);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<BN>(&dp[0][0],
                           hopper::desc_k(dos, HBLOCK, 64 * cw, 16 * kk),
                           hopper::desc_k(vt, BN, 0, 16 * kk), kk > 0);
    hopper::wgmma_commit();

    // p while dp is still in flight
    hopper::wgmma_wait<1>();
    hopper::fence_regs<BN / 2>(&s[0][0]);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = hopper::ex2(fmaf(s[nt][e], scale_log2, -lse2[e >> 1]));
    if ((causal && j * BN + BN - 1 > row0) || (j + 1) * BN > S) {
      // a key of this tile can be hidden from a row: zero its p
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_a + 8 * (e >> 1);
          const int col = j * BN + nt * 8 + c + (e & 1);
          if (col >= S || (causal && col > row)) s[nt][e] = 0.f;
        }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<BN / 2>(&dp[0][0]);
#pragma unroll
    for (int nt = 0; nt < BN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)  // ds
        s[nt][e] = s[nt][e] * (dp[nt][e] - delta_r[e >> 1]) * scale;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) c_to_a(da[kk], s, kk);

    hopper::fence_regs<D / 2>(&acc[0][0]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      hopper::wgmma_rs<D>(&acc[0][0], da[kk],
                          hopper::desc_mn(kt, BN, 16 * kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(&acc[0][0]);
    hopper::fence_regs<BN / 4>(&da[0][0]);  // read by the ds.k in flight
    if (lane == 0) {
      hopper::mbar_arrive(ring.k_empty(st));
      hopper::mbar_arrive(ring.v_empty(st));
    }
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(dq + ((size_t)tile.b * S * H + tile.h) * D, (size_t)H * D,
                row_a, S, acc, one, lane);
}

// ---- dk/dv: key-stationary warp-specialised wgmma (hopper.cuh) ---------

constexpr int DKV_BN = 128;    // keys of a block (2 consumers x 64)
constexpr int DKV_BM = 64;     // q rows of a streamed q / do tile
constexpr int DKV_STAGES = 2;  // q/do ring depth

// dk/dv's shared memory, byte offsets from a 1024-byte aligned base: the
// block's k and v tiles, the ring's q and do tiles, each stage's lse
// (times log2(e)) and delta ([stage][2][64] fp32), then the mbarriers:
// kv_full, full[DKV_STAGES], empty[DKV_STAGES].
template <int D>
struct DkvSmem {
  static constexpr int KV = DKV_BN * D * 2;    // a k or v tile
  static constexpr int ROWS = DKV_BM * D * 2;  // a q or do tile
  static constexpr int V0 = KV;
  static constexpr int Q0 = 2 * KV;
  static constexpr int DO0 = Q0 + DKV_STAGES * ROWS;
  static constexpr int VEC0 = DO0 + DKV_STAGES * ROWS;
  static constexpr int BAR = VEC0 + DKV_STAGES * 2 * DKV_BM * 4;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * DKV_STAGES) + 1024;
};

// The ring of q/do tiles: a stage's full barrier completes with its TMA
// bytes and one arrival from each lane of the producer warp (the lane's
// lse and delta are stored); its empty barrier with one arrival from
// each of the 8 consumer warps.
struct DkvRing {
  uint32_t bars;
  __device__ uint32_t kv_full() const { return bars; }
  __device__ uint32_t full(int s) const { return bars + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const {
    return bars + 8 * (1 + DKV_STAGES + s);
  }
  __device__ void init() const {
    hopper::mbar_init(kv_full(), 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      hopper::mbar_init(full(s), 32);
      hopper::mbar_init(empty(s), 8);
    }
    hopper::mbar_fence_init();
  }
};

// The producer warp: the block's k and v tiles once, then q/do tiles
// i_begin .. n_q - 1 through the ring, with their rows' lse * log2(e) and
// delta (0 for rows >= S). A lane reads its 4 values before it waits for
// the stage, so the loads overlap the wait.
template <int D>
__device__ __forceinline__ void produce_dkv(
    const DkvRing& ring, uint32_t base, float* vecs, const CUtensorMap* tq,
    const CUtensorMap* tk, const CUtensorMap* tv, const CUtensorMap* tdo,
    const float* __restrict__ lse, const float* __restrict__ delta,
    size_t vec, int S, int h, int b, int key0, int i_begin, int n_q,
    int lane) {
  using Smem = DkvSmem<D>;
  if (lane == 0) {
    hopper::tma_prefetch(tq);
    hopper::tma_prefetch(tdo);
    hopper::tma_prefetch(tk);
    hopper::tma_prefetch(tv);
    hopper::mbar_expect_tx(ring.kv_full(), 2 * Smem::KV);
    hopper::tma_tile<D>(base, tk, ring.kv_full(), DKV_BN, h, key0, b);
    hopper::tma_tile<D>(base + Smem::V0, tv, ring.kv_full(), DKV_BN, h,
                        key0, b);
  }
  for (int i = i_begin; i < n_q; ++i) {
    const int it = i - i_begin, s = it % DKV_STAGES;
    const int i0 = i * DKV_BM;
    float l[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + lane + 32 * r;
      l[r] = row < S ? lse[vec + row] * LOG2E : 0.f;
      dl[r] = row < S ? delta[vec + row] : 0.f;
    }
    hopper::mbar_wait(ring.empty(s), ((it / DKV_STAGES) & 1) ^ 1);
    float* vs = vecs + s * 2 * DKV_BM;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      vs[lane + 32 * r] = l[r];
      vs[DKV_BM + lane + 32 * r] = dl[r];
    }
    if (lane == 0) {
      hopper::mbar_expect_tx(ring.full(s), 2 * Smem::ROWS);
      hopper::tma_tile<D>(base + Smem::Q0 + s * Smem::ROWS, tq, ring.full(s),
                          DKV_BM, h, i0, b);
      hopper::tma_tile<D>(base + Smem::DO0 + s * Smem::ROWS, tdo,
                          ring.full(s), DKV_BM, h, i0, b);
    } else {
      hopper::mbar_arrive(ring.full(s));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int S, int H,
                         int causal, float scale, float scale_log2) {
  using Smem = DkvSmem<D>;
  constexpr int BM = DKV_BM;
  extern __shared__ __align__(1024) uint8_t hsmem[];
  const uint32_t base = (hopper::smem_u32(hsmem) + 1023u) & ~1023u;
  float* vecs = reinterpret_cast<float*>(
      hsmem + (base - hopper::smem_u32(hsmem)) + Smem::VEC0);
  const DkvRing ring{base + Smem::BAR};
  // block -> (key block, head, batch): a (b, h)'s key blocks are
  // consecutive blocks, key block 0 (the heaviest causal one) first
  const int n_kb = (S + DKV_BN - 1) / DKV_BN;
  const int kb = blockIdx.x % n_kb, bh = blockIdx.x / n_kb;
  const int h = bh % H, b = bh / H;
  const int key0 = kb * DKV_BN;
  const int n_q = (S + BM - 1) / BM;
  // causal: the first q tile that can see the block's first key
  const int i_begin = causal ? key0 / BM : 0;
  const size_t vec = ((size_t)b * H + h) * S;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x < 128) {
    hopper::setmaxnreg_dec<24>();
    if (threadIdx.x < 32)
      produce_dkv<D>(ring, base, vecs, &tq, &tk, &tv, &tdo, lse, delta, vec,
                     S, h, b, key0, i_begin, n_q, threadIdx.x);
    return;
  }
  hopper::setmaxnreg_inc<240>();
  const int cw = threadIdx.x / 128 - 1;  // consumer warpgroup: 64 keys
  const int t = threadIdx.x % 128;
  const int warp = t >> 5, lane = t & 31;
  const int c = (lane & 3) * 2;
  const int kc0 = key0 + 64 * cw;
  const int key_a = kc0 + warp * 16 + (lane >> 2);  // and key_a + 8

  // 64 x N fp32 wgmma fragments as [n8 block][4] (mma.sync's C layout a
  // warp): dk and dv (keys x D); s^T and dp^T (keys x q rows)
  float dk_acc[D / 8][4], dv_acc[D / 8][4], s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[nt][e] = dv_acc[nt][e] = 0.f;
  uint32_t pa[BM / 16][4], da[BM / 16][4];
  const uint32_t kt = base, vt = base + Smem::V0;

  hopper::mbar_wait(ring.kv_full(), 0);
  for (int i = i_begin; i < n_q; ++i) {
    const int it = i - i_begin, st = it % DKV_STAGES;
    const uint32_t phase = (it / DKV_STAGES) & 1;
    const int i0 = i * BM;
    const uint32_t qs = base + Smem::Q0 + st * Smem::ROWS;
    const uint32_t dos = base + Smem::DO0 + st * Smem::ROWS;
    const float* vs = vecs + st * 2 * BM;
    if (causal && i0 + BM - 1 < kc0) {
      // every row of the tile is above this warpgroup's keys; the stage
      // is still waited for (see flash_bwd_dq_kernel)
      hopper::mbar_wait(ring.full(st), phase);
      if (lane == 0) hopper::mbar_arrive(ring.empty(st));
      continue;
    }

    hopper::mbar_wait(ring.full(st), phase);
    hopper::wgmma_fence();
    // s^T = k q^T and dp^T = v do^T, both in flight together
    hopper::wgmma_ss_n64_first(&s[0][0], hopper::desc_k(kt, DKV_BN, 64 * cw, 0),
                               hopper::desc_k(qs, BM, 0, 0));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      hopper::wgmma_ss_n64(&s[0][0],
                           hopper::desc_k(kt, DKV_BN, 64 * cw, 16 * kk),
                           hopper::desc_k(qs, BM, 0, 16 * kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_ss_n64_first(&dp[0][0],
                               hopper::desc_k(vt, DKV_BN, 64 * cw, 0),
                               hopper::desc_k(dos, BM, 0, 0));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      hopper::wgmma_ss_n64(&dp[0][0],
                           hopper::desc_k(vt, DKV_BN, 64 * cw, 16 * kk),
                           hopper::desc_k(dos, BM, 0, 16 * kk), 1);
    hopper::wgmma_commit();

    // p^T while dp^T is still in flight: a column is a q row
    hopper::wgmma_wait<1>();
    hopper::fence_regs<BM / 2>(&s[0][0]);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
      const float2 l = *reinterpret_cast<const float2*>(vs + nt * 8 + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = hopper::ex2(fmaf(s[nt][e], scale_log2,
                                    -((e & 1) ? l.y : l.x)));
    }
    if ((causal && i0 < kc0 + 63) || i0 + BM > S) {
      // a row of this tile can be hidden from a key, or be >= S: zero
      // its p (only the diagonal tile and the last one)
#pragma unroll
      for (int nt = 0; nt < BM / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_a + 8 * (e >> 1);
          const int row = i0 + nt * 8 + c + (e & 1);
          if (row >= S || (causal && row < key)) s[nt][e] = 0.f;
        }
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs<BM / 2>(&dp[0][0]);
#pragma unroll
    for (int nt = 0; nt < BM / 8; ++nt) {
      const float2 dl =
          *reinterpret_cast<const float2*>(vs + BM + nt * 8 + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)  // ds^T
        dp[nt][e] = s[nt][e] * (dp[nt][e] - ((e & 1) ? dl.y : dl.x)) * scale;
    }
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      c_to_a(pa[kk], s, kk);
      c_to_a(da[kk], dp, kk);
    }

    // dv += p^T do and dk += ds^T q: do and q MN-major (the q rows are
    // the products' depth)
    hopper::fence_regs<D / 2>(&dk_acc[0][0]);
    hopper::fence_regs<D / 2>(&dv_acc[0][0]);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      hopper::wgmma_rs<D>(&dv_acc[0][0], pa[kk],
                          hopper::desc_mn(dos, BM, 16 * kk), 1);
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk)
      hopper::wgmma_rs<D>(&dk_acc[0][0], da[kk],
                          hopper::desc_mn(qs, BM, 16 * kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs<D / 2>(&dk_acc[0][0]);
    hopper::fence_regs<D / 2>(&dv_acc[0][0]);
    hopper::fence_regs<BM / 4>(&pa[0][0]);  // read by the products in flight
    hopper::fence_regs<BM / 4>(&da[0][0]);
    if (lane == 0) hopper::mbar_arrive(ring.empty(st));
  }
  const float one[2] = {1.f, 1.f};
  const size_t off = ((size_t)b * S * H + h) * D;
  store_rows<D>(dk + off, (size_t)H * D, key_a, S, dk_acc, one, lane);
  store_rows<D>(dv + off, (size_t)H * D, key_a, S, dv_acc, one, lane);
}

// Shapes this tiling cannot take are refused, never launched: a head
// dim other than 64 or 128, a grid above the card's limits, a pointer
// not 16-byte aligned (the TMA maps need 16-byte aligned tensors); a
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

// The forward's and dq's grid: one block a (q tile, head, batch).
unsigned hopper_grid(int B, int S, int H) {
  const long long blocks =
      (long long)((S + HBLOCK - 1) / HBLOCK) * B * H;
  return blocks > 0x7fffffffLL ? 0u : static_cast<unsigned>(blocks);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse,
        int B, int S, int H, int causal, float scale, cudaStream_t stream) {
  using Smem = HopperSmem<D, FWD_BN, 1>;
  const unsigned grid = hopper_grid(B, S, H);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  cudaError_t err = hopper::bshd_map(&tq, q, B, S, H, D, HBLOCK);
  if (err == cudaSuccess) err = hopper::bshd_map(&tk, k, B, S, H, D, FWD_BN);
  if (err == cudaSuccess) err = hopper::bshd_map(&tv, v, B, S, H, D, FWD_BN);
  if (err == cudaSuccess) err = prepare(flash_fwd_kernel<D>, Smem::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_fwd_kernel<D><<<grid, HTHREADS, Smem::BYTES, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      S, H, causal, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int S, int H,
           int causal, float scale, cudaStream_t stream) {
  using Smem = HopperSmem<D, DQ_BN, 2>;
  const unsigned grid = hopper_grid(B, S, H);
  if (grid == 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::bshd_map(&tq, q, B, S, H, D, HBLOCK);
  if (err == cudaSuccess)
    err = hopper::bshd_map(&tdo, dout, B, S, H, D, HBLOCK);
  if (err == cudaSuccess) err = hopper::bshd_map(&tk, k, B, S, H, D, DQ_BN);
  if (err == cudaSuccess) err = hopper::bshd_map(&tv, v, B, S, H, D, DQ_BN);
  if (err == cudaSuccess) err = prepare(flash_bwd_dq_kernel<D>, Smem::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<D><<<grid, HTHREADS, Smem::BYTES, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), S, H,
      causal, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            int S, int H, int causal, float scale, cudaStream_t stream) {
  using Smem = DkvSmem<D>;
  const long long blocks =
      (long long)((S + DKV_BN - 1) / DKV_BN) * B * H;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = hopper::bshd_map(&tq, q, B, S, H, D, DKV_BM);
  if (err == cudaSuccess)
    err = hopper::bshd_map(&tdo, dout, B, S, H, D, DKV_BM);
  if (err == cudaSuccess) err = hopper::bshd_map(&tk, k, B, S, H, D, DKV_BN);
  if (err == cudaSuccess) err = hopper::bshd_map(&tv, v, B, S, H, D, DKV_BN);
  if (err == cudaSuccess)
    err = prepare(flash_bwd_dkv_kernel<D>, Smem::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<D><<<(unsigned)blocks, HTHREADS, Smem::BYTES,
                            stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, H, causal, scale, scale * LOG2E);
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

// Dynamic shared memory of one block of kernel 0 (the forward), 1 (dq)
// or 2 (dk/dv) at head dim D (64 or 128); -1 for anything else.
int flash_smem_bytes(int kernel, int D) {
  if (D != 64 && D != 128) return -1;
  switch (kernel) {
    case 0:
      return D == 64 ? HopperSmem<64, FWD_BN, 1>::BYTES
                     : HopperSmem<128, FWD_BN, 1>::BYTES;
    case 1:
      return D == 64 ? HopperSmem<64, DQ_BN, 2>::BYTES
                     : HopperSmem<128, DQ_BN, 2>::BYTES;
    case 2:
      return D == 64 ? DkvSmem<64>::BYTES : DkvSmem<128>::BYTES;
    default:
      return -1;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
