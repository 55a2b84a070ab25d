// Flash attention forward for Hopper (sm_90a), f32 and bf16 inputs with f32
// accumulation.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `_flash_call` of
// src/repro/kernels/flash_attention.py (`flash_attention`): causal,
// sliding-window or bidirectional online-softmax attention with a dynamic
// `q_offset` (chunked-prefill resume) and `kv_len` (live prefix of a padded
// cache), GQA group folded into the query panel, dead KV tiles skipped, and
// an optional (B, Hkv, nq, nk) execution map.
//
// Design.  One CTA per (q-tile, kv-head, batch).  Its query panel holds the
// G = H / Hkv heads of that kv-head for `qc` positions, rows g-major
// (row r = g * qc + i), as the TPU kernel's (G*qc, D) panel: the G heads
// share every K/V tile the CTA loads.  The CTA computes its live tile range
// [first, last] from q_offset, kv_len and window exactly as `_tile_bounds`
// does and loops over it; that loop replaces the sequential Pallas grid axis
// and its index-map clamp, so a dead tile is neither loaded nor computed.
// q, k, v are read in their native (B, S, H, D) / (B, T, Hkv, D) layouts
// through strides (no transpose or pad copy of the cache per call); the
// ragged edge of T and of S is masked here.  Masked logits take the finite
// MASK_VALUE.  For bf16 inputs P is rounded to bf16 before the PV product,
// as the TPU kernel does.  A q-tile without a live KV tile writes zeros.
// The kernel allocates nothing and runs on the caller's stream.
//
// What bounds it.  At the serving shapes (S = 512 rows against up to 2048
// live keys, D = 128) prefill attention does ~D/2 operations per byte it
// must move, so it is bound by operations.  The main path is f32 and its
// products must not go through TF32, so the ceiling is the SIMT f32 rate
// (67 TFLOP/s).  This simple version keeps Q, the K/V tile, P and the
// output accumulator in shared memory, Q, K and P transposed, and gives each
// thread 4x4 register tiles of both products, so one float4 of each operand
// feeds 16 FMAs (two shared-memory reads per 16 FMAs).  It does not yet use
// wgmma (whose f32 path would be TF32), TMA, double-buffered tile loads or
// warp specialisation, and one 188 KB CTA per SM leaves 8 warps to hide
// latency: that is where its distance from the bound lies.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;  // float4 loads in flight per thread in a tile load
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int* counts;  // (B, Hkv, nq, nk) or null
  int S, T, Hkv, G, D, Dv;
  long long sq_b, sq_s, sq_h;
  long long sk_b, sk_t, sk_h;
  long long sv_b, sv_t, sv_h;
  long long so_b, so_s, so_h;
  int q_offset, kv_len, window, bidirectional;
  float scale;
  int qc, kc, nq, nk;
  int RP, KCP;  // panel rows and tile columns rounded up to 4
};

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// P as the PV product sees it: bf16 inputs round it to the value dtype.
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

// Four consecutive elements as f32 (the wrapper guarantees 4-element
// alignment of every row start), and back.
__device__ __forceinline__ float4 load4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(x);
  const float2 a = __bfloat1622float2(x2[0]), b = __bfloat1622float2(x2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* x, float4 v) {
  *reinterpret_cast<float4*>(x) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* x, float4 v) {
  __nv_bfloat162* x2 = reinterpret_cast<__nv_bfloat162*>(x);
  x2[0] = __floats2bfloat162_rn(v.x, v.y);
  x2[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Python floor division, for negative numerators too.
__device__ __forceinline__ int floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// First/last live KV tile of the q-tile starting at absolute position q_lo
// (`_tile_bounds`), with last clamped to the grid as `flash_tile_counts`.
__device__ __forceinline__ void tile_bounds(const Params& p, int q_lo, int* first,
                                            int* last) {
  int f = 0, l;
  if (p.bidirectional) {
    l = floordiv(p.kv_len - 1, p.kc);
  } else {
    int q_hi = q_lo + p.qc - 1;
    l = floordiv(min(q_hi, p.kv_len - 1), p.kc);
    if (p.window > 0) {
      int c = q_lo - p.window + 2 - p.kc;
      f = max(0, -floordiv(-c, p.kc));
    }
  }
  *first = f;
  *last = min(l, p.nk - 1);
}

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// Shared-memory layout, in floats.  Q, K and P are stored transposed
// (position fastest) so each thread reads a float4 of 4 rows or 4 keys per
// step; row strides are padded by 4 floats to spread transposed writes over
// the banks while keeping every float4 16-byte aligned.
struct Smem {
  int QS, KS, PS, OS;              // row strides of Qt, Kt, Pt, Os
  int qt, kt, vs, pt, os, m, l, a, total;
  __host__ __device__ Smem(int RP, int KCP, int D, int Dv) {
    QS = RP + 4;
    KS = KCP + 4;
    PS = RP + 4;
    OS = Dv + 4;
    qt = 0;                        // (D, QS)   Q^T
    kt = qt + D * QS;              // (D, KS)   K^T of the current tile
    vs = kt + D * KS;              // (KCP, Dv) V of the current tile
    pt = vs + KCP * Dv;            // (KCP, PS) logits^T, then P^T
    os = pt + KCP * PS;            // (RP, OS)  unnormalised output accumulator
    m = os + RP * OS;
    l = m + RP;
    a = l + RP;
    total = a + RP;
  }
};

// Thread-tile walk over an (nty x ntx) grid of 4x4 tiles: consecutive lanes
// of a warp cover a 4 (rows) x 8 (columns) block of tiles, so a warp's
// float4 reads of 4 row-groups and 8 column-groups are each one contiguous
// 64- or 128-byte access.  Returns false for lanes past the grid's edge.
__device__ __forceinline__ bool tile_of(int t, int nty, int ntx, int* ty, int* tx) {
  const int bx = (ntx + 7) / 8;
  const int blk = t / 32, lane = t % 32;
  *ty = (blk / bx) * 4 + lane / 8;
  *tx = (blk % bx) * 8 + lane % 8;
  return *ty < nty && *tx < ntx;
}

__device__ __forceinline__ int tile_walk(int nty, int ntx) {
  return ((nty + 3) / 4) * ((ntx + 7) / 8) * 32;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Smem L(p.RP, p.KCP, p.D, p.Dv);
  float* Qt = sm + L.qt;
  float* Kt = sm + L.kt;
  float* Vs = sm + L.vs;
  float* Pt = sm + L.pt;
  float* Os = sm + L.os;
  float* Ms = sm + L.m;
  float* Ls = sm + L.l;
  float* As = sm + L.a;

  const int iq = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x;
  const int qc = p.qc, kc = p.kc, D = p.D, Dv = p.Dv;
  const int R = p.G * qc, RP = p.RP, KCP = p.KCP;
  const int s_lo = iq * qc;             // first query row of the tile
  const int q_lo = p.q_offset + s_lo;   // its absolute position

  int first, last;
  tile_bounds(p, q_lo, &first, &last);
  if (p.counts != nullptr) {
    int* row = p.counts + ((long long)(ib * p.Hkv + ih) * p.nq + iq) * p.nk;
    for (int ik = tid; ik < p.nk; ik += kThreads) row[ik] = (ik >= first && ik <= last);
  }

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);

  if (first > last) {  // no live KV tile: the rows are zeros
    for (int idx = tid; idx < R * Dv; idx += kThreads) {
      int r = idx / Dv, j = idx % Dv, g = r / qc, i = r % qc;
      if (s_lo + i < p.S)
        o[ib * p.so_b + (long long)(s_lo + i) * p.so_s + (long long)(ih * p.G + g) * p.so_h + j] =
            from_f32<T>(0.f);
    }
    return;
  }

  // Q^T once, float4 reads along d; consecutive lanes take consecutive
  // rows, so the transposed shared-memory writes do not conflict
  for (int idx = tid; idx < RP * (D / 4); idx += kThreads) {
    const int r = idx % RP, d = (idx / RP) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < R) {
      const int g = r / qc, i = r % qc;
      if (s_lo + i < p.S)
        x = load4(q + ib * p.sq_b + (long long)(s_lo + i) * p.sq_s +
                  (long long)(ih * p.G + g) * p.sq_h + d);
    }
    Qt[(d + 0) * L.QS + r] = x.x;
    Qt[(d + 1) * L.QS + r] = x.y;
    Qt[(d + 2) * L.QS + r] = x.z;
    Qt[(d + 3) * L.QS + r] = x.w;
  }
  for (int idx = tid; idx < RP * L.OS; idx += kThreads) Os[idx] = 0.f;
  for (int r = tid; r < RP; r += kThreads) {
    Ms[r] = -INFINITY;
    Ls[r] = 0.f;
  }

  const int nty = RP / 4;
  for (int ik = first; ik <= last; ++ik) {
    const int k_lo = ik * kc;
    __syncthreads();  // previous tile's readers are done with Kt/Vs/Pt
    // K^T and V of the tile as float4 groups, kBatch loads in flight per
    // thread before any is stored: the loads' latency, not their bytes,
    // bounds this phase.  K lanes take consecutive keys (conflict-free
    // transposed writes); V lanes take consecutive columns (coalesced).
    const int kgroups = KCP * (D / 4), ngroups = kgroups + KCP * (Dv / 4);
    for (int base = 0; base < ngroups; base += kBatch * kThreads) {
      float4 buf[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = base + u * kThreads + tid;
        buf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (g < kgroups) {
          const int c = g % KCP, key = k_lo + c;
          if (c < kc && key < p.T)
            buf[u] = load4(k + ib * p.sk_b + (long long)key * p.sk_t +
                           (long long)ih * p.sk_h + (g / KCP) * 4);
        } else if (g < ngroups) {
          const int gv = g - kgroups, c = gv / (Dv / 4), key = k_lo + c;
          if (c < kc && key < p.T)
            buf[u] = load4(v + ib * p.sv_b + (long long)key * p.sv_t +
                           (long long)ih * p.sv_h + (gv % (Dv / 4)) * 4);
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int g = base + u * kThreads + tid;
        if (g < kgroups) {
          const int c = g % KCP, d = (g / KCP) * 4;
          Kt[(d + 0) * L.KS + c] = buf[u].x;
          Kt[(d + 1) * L.KS + c] = buf[u].y;
          Kt[(d + 2) * L.KS + c] = buf[u].z;
          Kt[(d + 3) * L.KS + c] = buf[u].w;
        } else if (g < ngroups) {
          *reinterpret_cast<float4*>(Vs + (g - kgroups) * 4) = buf[u];
        }
      }
    }
    __syncthreads();

    // logits^T: 4 rows x 4 keys per thread tile, float4 reads of Q^T and K^T
    const int ntk = KCP / 4;
    for (int t = tid; t < tile_walk(nty, ntk); t += kThreads) {
      int ty, tx;
      if (!tile_of(t, nty, ntk, &ty, &tx)) continue;
      const int r0 = ty * 4, c0 = tx * 4;
      float acc[4][4] = {};
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(Qt + d * L.QS + r0);
        const float4 b = *reinterpret_cast<const float4*>(Kt + d * L.KS + c0);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + j, key = k_lo + c;
        float sv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = r0 + i, row = q_lo + r % qc;
          bool live = r < R && c < kc && key < p.kv_len;
          if (!p.bidirectional) {
            live = live && key <= row;
            if (p.window > 0) live = live && key > row - p.window;
          }
          sv[i] = live ? acc[i][j] * p.scale : kMaskValue;
        }
        *reinterpret_cast<float4*>(Pt + c * L.PS + r0) = make_float4(sv[0], sv[1], sv[2], sv[3]);
      }
    }
    __syncthreads();

    // online softmax, one thread per row (conflict-free column walk of P^T);
    // columns >= kc are not in the tile
    for (int r = tid; r < RP; r += kThreads) {
      float mx = -INFINITY;
      for (int c = 0; c < kc; ++c) mx = fmaxf(mx, Pt[c * L.PS + r]);
      const float m_prev = Ms[r];
      const float m_next = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < KCP; ++c) {
        float e = 0.f;
        if (c < kc) {
          e = expf(Pt[c * L.PS + r] - m_next);
          sum += e;
        }
        Pt[c * L.PS + r] = round_p(e, T());
      }
      const float alpha = expf(m_prev - m_next);
      As[r] = alpha;
      Ls[r] = Ls[r] * alpha + sum;
      Ms[r] = m_next;
    }
    __syncthreads();

    // O = O * alpha + P V: 4 rows x 4 value columns per thread tile
    const int ntj = Dv / 4;
    for (int t = tid; t < tile_walk(nty, ntj); t += kThreads) {
      int ty, tx;
      if (!tile_of(t, nty, ntj, &ty, &tx)) continue;
      const int r0 = ty * 4, j0 = tx * 4;
      float acc[4][4] = {};
#pragma unroll 4
      for (int c = 0; c < kc; ++c) {
        const float4 pr = *reinterpret_cast<const float4*>(Pt + c * L.PS + r0);
        const float4 vv = *reinterpret_cast<const float4*>(Vs + c * Dv + j0);
        const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
        const float vw[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], vw[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float alpha = As[r0 + i];
        float4* dst = reinterpret_cast<float4*>(Os + (r0 + i) * L.OS + j0);
        float4 cur = *dst;
        cur.x = cur.x * alpha + acc[i][0];
        cur.y = cur.y * alpha + acc[i][1];
        cur.z = cur.z * alpha + acc[i][2];
        cur.w = cur.w * alpha + acc[i][3];
        *dst = cur;
      }
    }
  }
  __syncthreads();

  for (int idx = tid; idx < R * (Dv / 4); idx += kThreads) {
    const int r = idx / (Dv / 4), j = (idx % (Dv / 4)) * 4, g = r / qc, i = r % qc;
    if (s_lo + i < p.S) {
      const float inv = 1.f / fmaxf(Ls[r], 1e-30f);
      float4 x = *reinterpret_cast<const float4*>(Os + r * L.OS + j);
      x.x *= inv; x.y *= inv; x.z *= inv; x.w *= inv;
      store4(o + ib * p.so_b + (long long)(s_lo + i) * p.so_s +
                 (long long)(ih * p.G + g) * p.so_h + j, x);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const Smem L(p.RP, p.KCP, p.D, p.Dv);
  const size_t bytes = sizeof(float) * (size_t)L.total;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(p.nq, p.Hkv, B);
  flash_fwd_kernel<T><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes (the wrapper checks it
// against the card's limit before launching).
long long flash_attention_smem_bytes(int G, int qc, int kc, int D, int Dv) {
  const Smem L(round4(G * qc), round4(kc), D, Dv);
  return (long long)sizeof(float) * L.total;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Strides are
// in elements; the last dimension of every tensor must be contiguous.
// Returns the cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int* counts,
                        int dtype, int B, int S, int H, int T, int Hkv, int D, int Dv,
                        long long sq_b, long long sq_s, long long sq_h, long long sk_b,
                        long long sk_t, long long sk_h, long long sv_b, long long sv_t,
                        long long sv_h, long long so_b, long long so_s, long long so_h,
                        int q_offset, int kv_len, int window, int bidirectional, float scale,
                        int qc, int kc, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.counts = counts;
  p.S = S; p.T = T; p.Hkv = Hkv; p.G = H / Hkv; p.D = D; p.Dv = Dv;
  p.sq_b = sq_b; p.sq_s = sq_s; p.sq_h = sq_h;
  p.sk_b = sk_b; p.sk_t = sk_t; p.sk_h = sk_h;
  p.sv_b = sv_b; p.sv_t = sv_t; p.sv_h = sv_h;
  p.so_b = so_b; p.so_s = so_s; p.so_h = so_h;
  p.q_offset = q_offset; p.kv_len = kv_len; p.window = window;
  p.bidirectional = bidirectional; p.scale = scale;
  p.qc = qc; p.kc = kc;
  p.nq = (S + qc - 1) / qc;
  p.nk = (T + kc - 1) / kc;
  p.RP = round4(p.G * qc);
  p.KCP = round4(kc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
