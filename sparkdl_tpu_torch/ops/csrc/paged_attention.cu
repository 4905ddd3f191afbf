// Paged-attention decode for Hopper (sm_90a): one decode step of GQA
// attention over a pooled paged KV cache, read through block tables.
//
// Replaces: sparkdl_tpu/ops/pallas/paged_attention.py, _kernel (called
// through paged_attention_decode). Same contract: q (B, H, D); pools
// (n_pages, page, Hkv, D); tables (B, max_pages) int32; lens (B,) int32;
// positions >= lens[b] masked to -1e30; online softmax with running max,
// sum and accumulator in fp32; out = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: the bytes of the visible K and V,
// sum_b lens[b] * Hkv * D * 2 (K and V) * sizeof(elem). Each key is used
// by the rep = H / Hkv query heads of its group and nothing else, so
// there is no reuse for the tensor cores to exploit.
//
// Design: one block per (row b, kv head h), holding its rep query rows
// in shared memory as fp32. The TPU's sequential page axis becomes a
// loop inside the block over pages p < ceil(lens[b] / page); the block
// reads tables[b, p] itself (the card has no scalar prefetch). Each
// thread keeps its share of a page's (page, D) K and V tiles of head h
// in registers as 16-byte loads, and the loads of page p + 1 are issued
// before page p is computed, so they fly under its arithmetic. Scores
// are one thread per (query row, position); the K tile keeps a row
// stride of D + 1 floats so those threads hit distinct banks. One warp
// per query row takes the running max, the exponentials and their sum
// with shuffles; each thread owns up to MAX_OUT outputs of the (rep, D)
// accumulator in registers. Page 0 is the serving engine's dump page:
// inactive rows point every table entry at it and carry a frozen
// length, so they read valid memory and their output is discarded.
// Known limit: B * Hkv blocks (64 at 8 slots and 8 kv heads on 132 SMs)
// and no split over pages, so the longest row sets the time; splitting
// pages (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* lens, void* out, int B, int H, int Hkv, int D,
           int page, int max_pages, float scale, void* stream) {
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
  paged_decode_kernel<T>
      <<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const int*>(tables),
          static_cast<const int*>(lens), static_cast<T*>(out), H, Hkv, D,
          page, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int paged_decode_bf16(const void* q, const void* k, const void* v,
                      const void* tables, const void* lens, void* out, int B,
                      int H, int Hkv, int D, int page, int max_pages,
                      float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, tables, lens, out, B, H, Hkv, D,
                               page, max_pages, scale, stream);
}

int paged_decode_f32(const void* q, const void* k, const void* v,
                     const void* tables, const void* lens, void* out, int B,
                     int H, int Hkv, int D, int page, int max_pages,
                     float scale, void* stream) {
  return launch<float>(q, k, v, tables, lens, out, B, H, Hkv, D, page,
                       max_pages, scale, stream);
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
