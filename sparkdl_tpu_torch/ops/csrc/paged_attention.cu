// Paged-attention decode for Hopper (sm_90a): one decode step of GQA
// attention over a pooled paged KV cache, read through block tables.
//
// Replaces: sparkdl_tpu/ops/pallas/paged_attention.py, _kernel (called
// through paged_attention_decode). Same contract: q (B, H, D); pools
// (n_pages, page, Hkv, D); tables (B, max_pages) int32; lens (B,) int32;
// positions >= lens[b] masked; softmax statistics (max, sum) and the
// accumulator in fp32, probabilities rounded to v's dtype before the PV
// product; out = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: the bytes of the visible K and V,
// sum_b lens[b] * Hkv * D * 2 (K and V) * sizeof(elem). Each key is used
// by the rep = H / Hkv query heads of its group and nothing else, so
// there is no reuse for the tensor cores to exploit: the card's time
// goes to having enough bytes in flight.
//
// Routes, chosen by shape in the C entry point: bf16 pools with D 64,
// 128 or 256, rep <= 8 and a page a multiple of 16 rows take the split
// kernel below (the serving engine's Llama shapes); fp32 pools and other
// bf16 shapes take the page-serial kernel (paged_decode_kernel).
//
// Split kernel ("flash-decoding"): the grid is (B, Hkv, S), S =
// ceil(max_pages / pages_per_split) from the table's width, which the
// host knows; the host never reads lens. paged_decode_plan chooses
// pages_per_split so that B * Hkv * S fills the SMs while a split's K and
// V stay within 96 KB of shared memory (2 blocks an SM). A block of 4
// warps takes its split's pages of one (row b, kv head h) and the rep
// query rows of that head:
// - it reads lens[b] and the split's table entries itself; a split whose
//   first page starts at or past lens[b] writes an empty partial (m =
//   -1e30, l = 0, o = 0) and ends; pages past lens[b] are not read;
// - it copies every page of K and V it needs into shared memory in bf16
//   with cp.async, all in flight at once (K in one commit group, V in a
//   second, so the scores start while V still arrives); a key row's
//   16-byte chunks are swizzled (chunk ^= row % 8), so the ldmatrix
//   reads of 8 key rows hit 8 different banks;
// - S^T = K q^T on mma.sync m16n8k16 with keys as the M dimension and the
//   rep query rows padded to n8 (the padded columns are zero, never
//   enter a statistic and are never stored); scores times scale * log2(e)
//   go to shared memory in fp32, masked to -1e30 at positions >= lens[b];
// - one warp a query row takes the split's max m, p = exp2(s - m) (one
//   ex2.approx a probability, as in the flash kernels) and l = sum p in
//   fp32, and stores p rounded to bf16 (the TPU kernel's
//   p.astype(v.dtype));
// - O^T = V^T P^T on mma.sync (V's fragments by ldmatrix.trans), fp32;
//   the unnormalised o, m and l go to an fp32 workspace (B, H, S, D + 2).
// A second pass (paged_merge_kernel), launched by the same entry point,
// combines each (b, h)'s S partials in a fixed order, in logsumexp form:
// M = max m_s, w_s = exp2(m_s - M), out = sum w_s o_s / max(sum w_s l_s,
// 1e-30); an empty split (l_s = 0, o_s = 0) gets w_s = 0, so it weighs
// nothing and gives no NaN. Deterministic, no atomics.
// Page 0 is the serving engine's dump page: inactive rows point every
// table entry at it and carry a frozen length, so they read valid memory
// and their output is discarded.
//
// Page-serial kernel (it keeps p in fp32 for the PV product, the
// contract of its fp32 pools): one block per (row b, kv head h), its rep
// query
// rows in shared memory as fp32, a loop over pages p < ceil(lens[b] /
// page) with the loads of page p + 1 in registers while page p is
// computed, fp32 tiles in shared memory (K with a row stride of D + 1),
// one thread per (query row, position) score, one warp per query row for
// the online softmax, up to MAX_OUT accumulator outputs a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int MAX_OUT = 8;  // (rep * D) / THREADS outputs per thread
constexpr int LOADS = 8;    // 16-byte loads of K (and of V) per thread
constexpr float NEG_INF = -1e30f;

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Issue this thread's 16-byte loads of one (page, D) K and V tile of kv
// head h into registers.
template <typename T>
__device__ __forceinline__ void load_tile(const T* kpool, const T* vpool,
                                          size_t pg, int h, int Hkv, int D,
                                          int page, int tid, uint4* kr,
                                          uint4* vr) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = page * D / VEC;
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = tid + u * THREADS;
    if (i < nvec) {
      const int j = (i * VEC) / D, d = (i * VEC) % D;
      const size_t src = ((pg * page + j) * Hkv + h) * D + d;
      kr[u] = *reinterpret_cast<const uint4*>(kpool + src);
      vr[u] = *reinterpret_cast<const uint4*>(vpool + src);
    }
  }
}

// Convert the registers of load_tile to fp32 tiles in shared memory
// (K with a row stride of D + 1 floats).
template <typename T>
__device__ __forceinline__ void store_tile(const uint4* kr, const uint4* vr,
                                           float* ks, float* vs, int D,
                                           int page, int tid) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = page * D / VEC;
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int i = tid + u * THREADS;
    if (i < nvec) {
      const int j = (i * VEC) / D, d = (i * VEC) % D;
      const T* ke = reinterpret_cast<const T*>(&kr[u]);
      const T* ve = reinterpret_cast<const T*>(&vr[u]);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        ks[j * (D + 1) + d + e] = to_f32(ke[e]);
        vs[j * D + d + e] = to_f32(ve[e]);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kpool,
                    const T* __restrict__ vpool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens, T* __restrict__ out, int H,
                    int Hkv, int D, int page, int max_pages, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int rep = H / Hkv;
  const int KS = D + 1;                   // padded K row stride
  float* qs = smem;                       // (rep, D)
  float* ks = qs + rep * D;               // (page, D + 1)
  float* vs = ks + page * KS;             // (page, D)
  float* ps = vs + page * D;              // (rep, page) scores, then p
  float* m = ps + rep * page;             // (rep,) running max
  float* l = m + rep;                     // (rep,) running sum
  float* alpha = l + rep;                 // (rep,) rescale of this page

  const int len = lens[b];
  const int* table = tables + (size_t)b * max_pages;
  const T* qrow = q + ((size_t)b * H + (size_t)h * rep) * D;
  for (int i = tid; i < rep * D; i += THREADS) qs[i] = to_f32(qrow[i]);
  if (tid < rep) {
    m[tid] = NEG_INF;
    l[tid] = 0.f;
  }
  float acc[MAX_OUT];
#pragma unroll
  for (int u = 0; u < MAX_OUT; ++u) acc[u] = 0.f;

  const int n_pg = (len + page - 1) / page;
  uint4 kr[LOADS], vr[LOADS];
  if (n_pg > 0)
    load_tile<T>(kpool, vpool, (size_t)table[0], h, Hkv, D, page, tid, kr,
                 vr);
  for (int p = 0; p < n_pg; ++p) {
    store_tile<T>(kr, vr, ks, vs, D, page, tid);
    __syncthreads();
    // the next page's loads fly while this page is computed
    if (p + 1 < n_pg)
      load_tile<T>(kpool, vpool, (size_t)table[p + 1], h, Hkv, D, page,
                   tid, kr, vr);

    for (int i = tid; i < rep * page; i += THREADS) {
      const int r = i / page, j = i % page;
      float s = NEG_INF;
      if (p * page + j < len) {
        const float* qr = qs + r * D;
        const float* kk = ks + j * KS;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qr[d] * kk[d];
        s = dot * scale;
      }
      ps[i] = s;
    }
    __syncthreads();

    // one warp per query row: new max, p = exp(s - max), row sum
    for (int r = warp; r < rep; r += NWARPS) {
      float* pr = ps + r * page;
      float mx = NEG_INF;
      for (int j = lane; j < page; j += 32) mx = fmaxf(mx, pr[j]);
      const float m_new = fmaxf(m[r], warp_max(mx));
      float sum = 0.f;
      for (int j = lane; j < page; j += 32) {
        const float e = __expf(pr[j] - m_new);
        pr[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float a = __expf(m[r] - m_new);
        alpha[r] = a;
        l[r] = l[r] * a + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int u = 0; u < MAX_OUT; ++u) {
      const int o = tid + u * THREADS;
      if (o < rep * D) {
        const int r = o / D, d = o % D;
        const float* pr = ps + r * page;
        float pv = 0.f;
        for (int j = 0; j < page; ++j) pv += pr[j] * vs[j * D + d];
        acc[u] = acc[u] * alpha[r] + pv;
      }
    }
    __syncthreads();
  }

  T* orow = out + ((size_t)b * H + (size_t)h * rep) * D;
#pragma unroll
  for (int u = 0; u < MAX_OUT; ++u) {
    const int o = tid + u * THREADS;
    if (o < rep * D) orow[o] = from_f32<T>(acc[u] / fmaxf(l[o / D], 1e-30f));
  }
}

template <typename T>
int launch_serial(const void* q, const void* k, const void* v,
                  const void* tables, const void* lens, void* out, int B,
                  int H, int Hkv, int D, int page, int max_pages, float scale,
                  cudaStream_t stream) {
  // shapes this tiling cannot take are refused, never launched: 16-byte
  // loads of the pools, a (page, D) tile in LOADS loads a thread, the
  // (rep, D) accumulator in MAX_OUT registers a thread; a shared-memory
  // need above the card's limit fails in cudaFuncSetAttribute below
  constexpr int VEC = 16 / sizeof(T);
  if (Hkv <= 0 || H % Hkv != 0 || D % VEC != 0 ||
      page * D > THREADS * LOADS * VEC || (H / Hkv) * D > THREADS * MAX_OUT ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rep = H / Hkv;
  const size_t smem = sizeof(float) *
      ((size_t)rep * D + (size_t)page * (D + 1) + (size_t)page * D +
       (size_t)rep * page + 3 * (size_t)rep);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B, Hkv);
  paged_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<T*>(out), H, Hkv, D, page,
      max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bf16 pools: split over pages, tensor cores ----------------------------

constexpr int SPLIT_WARPS = 4;
constexpr int SPLIT_THREADS = 32 * SPLIT_WARPS;
// a split's K and V at most: 3 pages of 64 x 128 bf16 rows (2 blocks an
// SM); on one H100, at the serving engine's shapes, 3 pages a split
// beat 1, 2 and 4
constexpr int SPLIT_KV_BYTES = 96 * 1024;
constexpr int SC_PAD = 4;  // floats after a score row (bank spread)
constexpr int PB_PAD = 8;  // bf16 after a probability row
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices from shared memory (lane i gives row i % 8 of
// matrix i / 8): thread 4g + t gets row g, columns 2t and 2t + 1 of
// each; .trans: column g, rows 2t and 2t + 1.
__device__ __forceinline__ void ldsm_x4(uint32_t* a, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* a, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

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

// Shared memory of a split block holding nk keys (pages_per_split *
// page): K and V as [key][D] bf16 (swizzled chunks), scores [8][nk +
// SC_PAD] fp32, probabilities [8][nk + PB_PAD] bf16.
__host__ __device__ constexpr size_t split_smem(int nk, int D) {
  return (size_t)2 * nk * D * 2 + (size_t)8 * (nk + SC_PAD) * 4 +
         (size_t)8 * (nk + PB_PAD) * 2;
}

// Byte offset of key row r's 16-byte chunk c in a [key][D] bf16 tile.
template <int D>
__device__ __forceinline__ uint32_t kv_off(int r, int c) {
  return r * D * 2 + ((c ^ (r & 7)) << 4);
}

template <int D>
__global__ void __launch_bounds__(SPLIT_THREADS)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ kpool,
                   const __nv_bfloat16* __restrict__ vpool,
                   const int* __restrict__ tables,
                   const int* __restrict__ lens, float* __restrict__ work,
                   int H, int Hkv, int page, int max_pages, int pps, int S,
                   float scale_log2) {
  constexpr int CH = D / 8;  // 16-byte chunks of a key row
  extern __shared__ __align__(16) uint8_t split_buf[];
  const int b = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rep = H / Hkv;
  const int nk_max = pps * page;
  const uint32_t ks = hopper::smem_u32(split_buf);
  const uint32_t vs = ks + nk_max * D * 2;
  float* sc =
      reinterpret_cast<float*>(split_buf + (size_t)2 * nk_max * D * 2);
  const int lds = nk_max + SC_PAD;
  __nv_bfloat16* pb = reinterpret_cast<__nv_bfloat16*>(sc + 8 * lds);
  const int ldp = nk_max + PB_PAD;

  const int len = lens[b];
  const int p0 = sp * pps;                      // the split's first page
  const int n_pg = min(pps, (len + page - 1) / page - p0);
  // the workspace rows of query head h * rep + r: + r * S * (D + 2)
  float* wrow = work + ((size_t)(b * H + h * rep) * S + sp) * (D + 2);
  const size_t wstride = (size_t)S * (D + 2);
  if (n_pg <= 0) {  // an empty split: no key of it is visible
    for (int i = tid; i < rep * (D + 2); i += SPLIT_THREADS) {
      const int r = i / (D + 2), c = i % (D + 2);
      wrow[r * wstride + c] = c == D ? NEG_INF : 0.f;
    }
    return;
  }
  const int nk = n_pg * page;  // keys this split reads (a multiple of 16)

  // every page of K, then of V, in flight at once: a page's table entry
  // is read once, its rows' chunks spread over the threads
  const int* table = tables + (size_t)b * max_pages + p0;
  for (int pass = 0; pass < 2; ++pass) {
    const __nv_bfloat16* pool = pass == 0 ? kpool : vpool;
    const uint32_t dst = pass == 0 ? ks : vs;
    for (int p = 0; p < n_pg; ++p) {
      const __nv_bfloat16* src =
          pool + ((size_t)table[p] * page * Hkv + h) * D;
      for (int i = tid; i < page * CH; i += SPLIT_THREADS) {
        const int j = i / CH, c = i % CH;  // the page's row j, chunk c
        cp16(dst + kv_off<D>(p * page + j, c),
             src + (size_t)j * Hkv * D + c * 8);
      }
    }
    cp_commit();
  }

  // q's B fragments (query row g, d 2t .. and 2t + 8 ..); rows >= rep
  // are zero columns
  const bool qok = g < rep;
  const __nv_bfloat16* qrow =
      q + ((size_t)b * H + h * rep + (qok ? g : 0)) * D;
  uint32_t qf[D / 16][2];
#pragma unroll
  for (int ds = 0; ds < D / 16; ++ds) {
    qf[ds][0] = qok ? __ldg(reinterpret_cast<const uint32_t*>(
                          qrow + 16 * ds + 2 * t)) : 0u;
    qf[ds][1] = qok ? __ldg(reinterpret_cast<const uint32_t*>(
                          qrow + 16 * ds + 2 * t + 8)) : 0u;
  }

  cp_wait<1>();  // K
  __syncthreads();
  // S^T = K q^T, 16 keys a tile; scores in log2 units, masked
  const int base = p0 * page;  // the split's first position
  for (int kt = warp; kt < nk / 16; kt += SPLIT_WARPS) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const int j = lane >> 3;
    const int r = 16 * kt + (lane & 7) + 8 * (j & 1);
#pragma unroll
    for (int ds = 0; ds < D / 16; ++ds) {
      uint32_t a[4];
      ldsm_x4(a, ks + kv_off<D>(r, 2 * ds + (j >> 1)));
      mma16816(c, a, qf[ds][0], qf[ds][1], c);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 16 * kt + g + 8 * (e >> 1), qr = 2 * t + (e & 1);
      sc[qr * lds + key] = base + key < len ? c[e] * scale_log2 : NEG_INF;
    }
  }
  __syncthreads();

  // one warp a query row: the split's max, p = exp2(s - m) rounded to
  // bf16 for P.V, l = sum of the unrounded p
  for (int r = warp; r < rep; r += SPLIT_WARPS) {
    const float* srow = sc + r * lds;
    float mx = NEG_INF;
    for (int k = lane; k < nk; k += 32) mx = fmaxf(mx, srow[k]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int k = lane; k < nk; k += 32) {
      const float p = hopper::ex2(srow[k] - mx);
      sum += p;
      pb[r * ldp + k] = __float2bfloat16(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      wrow[r * wstride + D] = mx;
      wrow[r * wstride + D + 1] = sum;
    }
  }
  cp_wait<0>();  // V
  __syncthreads();

  // O^T = V^T P^T, 16 rows of D a tile
  const uint32_t pb_s = hopper::smem_u32(pb);
  for (int dt = warp; dt < D / 16; dt += SPLIT_WARPS) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    const int j = lane >> 3;
    for (int kk = 0; kk < nk / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, vs + kv_off<D>(16 * kk + (lane & 7) + 8 * (j >> 1),
                                  2 * dt + (j & 1)));
      // P^T's B fragment: query row g, keys 2t .. and 2t + 8 .. (rows
      // >= rep hold no probabilities: zero columns)
      const uint32_t pa = pb_s + 2 * (g * ldp + 16 * kk + 2 * t);
      uint32_t b0, b1;
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(b0) : "r"(pa));
      asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(b1) : "r"(pa + 16));
      mma16816(o, a, qok ? b0 : 0u, qok ? b1 : 0u, o);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qr = 2 * t + (e & 1), d = 16 * dt + g + 8 * (e >> 1);
      if (qr < rep) wrow[qr * wstride + d] = o[e];
    }
  }
}

// Combine the S partials of one (b, h) in order: out = sum w_s o_s /
// max(sum w_s l_s, 1e-30), w_s = exp2(m_s - max m) over the non-empty
// splits and 0 for the empty ones (l_s = 0, o_s = 0). The S statistics
// are read at once into shared memory, so the o loads of the sum are
// independent of each other.
__global__ void paged_merge_kernel(const float* __restrict__ work,
                                   __nv_bfloat16* __restrict__ out, int D,
                                   int S) {
  extern __shared__ float merge_w[];  // [S] weights, then [S] sums l
  const int bh = blockIdx.x, d = threadIdx.x;
  const float* w = work + (size_t)bh * S * (D + 2);
  for (int s = d; s < S; s += blockDim.x) {
    merge_w[s] = w[s * (D + 2) + D];
    merge_w[S + s] = w[s * (D + 2) + D + 1];
  }
  __syncthreads();
  float mx = NEG_INF;
  for (int s = 0; s < S; ++s)
    if (merge_w[S + s] > 0.f) mx = fmaxf(mx, merge_w[s]);
  __syncthreads();  // every thread has read the maxima
  for (int s = d; s < S; s += blockDim.x)
    merge_w[s] = merge_w[S + s] > 0.f ? exp2f(merge_w[s] - mx) : 0.f;
  __syncthreads();
  float acc = 0.f, l = 0.f;
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    acc += merge_w[s] * w[s * (D + 2) + d];
    l += merge_w[s] * merge_w[S + s];
  }
  out[(size_t)bh * D + d] = __float2bfloat16(acc / fmaxf(l, 1e-30f));
}

// The split route: bf16 pools, D 64, 128 or 256, rep <= 8, pages of a
// multiple of 16 rows.
bool split_shape(int H, int Hkv, int D, int page) {
  return Hkv > 0 && H % Hkv == 0 && H / Hkv <= 8 &&
         (D == 64 || D == 128 || D == 256) && page > 0 && page % 16 == 0;
}

template <int D>
cudaError_t split_launch(const void* q, const void* k, const void* v,
                         const void* tables, const void* lens, void* out,
                         void* work, int B, int H, int Hkv, int page,
                         int max_pages, int splits, int pps, float scale,
                         cudaStream_t st) {
  const size_t smem = split_smem(pps * page, D);
  // the dynamic shared-memory limit, raised only when a call needs more
  // than a device's setting (which outlives the call) allows
  static size_t set_to[64] = {};  // by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || smem > set_to[dev]) {
    err = cudaFuncSetAttribute(paged_split_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    if (dev < 64) set_to[dev] = smem;
  }
  paged_split_kernel<D><<<dim3(B, Hkv, splits), SPLIT_THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<float*>(work), H, Hkv, page,
      max_pages, pps, splits, scale * LOG2E);
  paged_merge_kernel<<<B * H, D, 2 * splits * sizeof(float), st>>>(
      static_cast<const float*>(work), static_cast<__nv_bfloat16*>(out), D,
      splits);
  return cudaSuccess;
}

int launch_split(const void* q, const void* k, const void* v,
                 const void* tables, const void* lens, void* out, void* work,
                 int B, int H, int Hkv, int D, int page, int max_pages,
                 int splits, int pps, float scale, cudaStream_t st) {
  // refused, never launched: splits that do not cover the table, no
  // workspace, q not 4-byte or the pools not 16-byte aligned (4- and
  // 16-byte loads); a split's shared memory above the card's limit fails
  // in cudaFuncSetAttribute
  const auto al = [](const void* p, int n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  if (pps < 1 || splits < 1 || (long)splits * pps < max_pages ||
      work == nullptr || !al(q, 4) || !al(k, 16) || !al(v, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      D == 64 ? split_launch<64>(q, k, v, tables, lens, out, work, B, H, Hkv,
                                 page, max_pages, splits, pps, scale, st)
      : D == 128
          ? split_launch<128>(q, k, v, tables, lens, out, work, B, H, Hkv,
                              page, max_pages, splits, pps, scale, st)
          : split_launch<256>(q, k, v, tables, lens, out, work, B, H, Hkv,
                              page, max_pages, splits, pps, scale, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The split of a call's pages for the route its shape takes: the split
// route (bf16 pools, elem_bytes 2, split_shape) takes pages_per_split
// pages a block, as many as fill 2 blocks an SM over B * Hkv * max_pages
// pages while a split's K and V stay within SPLIT_KV_BYTES, and splits =
// ceil(max_pages / pages_per_split); the caller gives paged_decode_bf16 an
// fp32 workspace of B * H * splits * (D + 2). The page-serial route
// takes no split and no workspace: splits = 0, pages_per_split = 0.
int paged_decode_plan(int B, int H, int Hkv, int D, int page, int max_pages,
                      int elem_bytes, int sm_count, int* splits,
                      int* pages_per_split) {
  if (B < 0 || max_pages < 0 || sm_count < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (elem_bytes != 2 || !split_shape(H, Hkv, D, page) || max_pages == 0) {
    *splits = 0;  // the page-serial route: no workspace
    *pages_per_split = 0;
    return 0;
  }
  long cap = SPLIT_KV_BYTES / ((long)page * D * 2 * 2);
  if (cap < 1) cap = 1;
  long want = ((long)B * Hkv * max_pages + 2L * sm_count - 1) /
              (2L * sm_count);
  if (want < 1) want = 1;
  const long pps = want < cap ? want : cap;
  *pages_per_split = static_cast<int>(pps);
  *splits = static_cast<int>((max_pages + pps - 1) / pps);
  return 0;
}

int paged_decode_bf16(const void* q, const void* k, const void* v,
                      const void* tables, const void* lens, void* out,
                      void* work, int B, int H, int Hkv, int D, int page,
                      int max_pages, int splits, int pages_per_split,
                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split_shape(H, Hkv, D, page) && max_pages > 0)
    return launch_split(q, k, v, tables, lens, out, work, B, H, Hkv, D, page,
                        max_pages, splits, pages_per_split, scale, st);
  return launch_serial<__nv_bfloat16>(q, k, v, tables, lens, out, B, H, Hkv,
                                      D, page, max_pages, scale, st);
}

int paged_decode_f32(const void* q, const void* k, const void* v,
                     const void* tables, const void* lens, void* out,
                     void* work, int B, int H, int Hkv, int D, int page,
                     int max_pages, int splits, int pages_per_split,
                     float scale, void* stream) {
  return launch_serial<float>(q, k, v, tables, lens, out, B, H, Hkv, D, page,
                              max_pages, scale,
                              static_cast<cudaStream_t>(stream));
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
