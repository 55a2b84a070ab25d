// Paged split-KV decode / verify attention for Hopper (sm_90a): queries in
// f32 or bf16, pages in f32, bf16 or int8 (with per-page, per-head scales),
// f32 accumulation.
//
// Replaces the Pallas TPU kernel `_paged_kernel` / `_split_kv_partition` of
// src/repro/kernels/decode_attention.py (`paged_decode_attention`), and fuses
// its cross-partition combine `_combine_partitions`, which runs outside the
// `pallas_call` in JAX, into a second launch of the same entry point.
//
// Contract (that of the reference).  q (B, S, H, D); k/v pages
// (Hkv, num_pages, page_size, W) with the new tokens' K/V already written;
// block_tables (B, max_pp) int32 with -1 tails; kv_lens (B,) int32 on the
// device.  Rows fold position-major: row r of kv-head h is query head
// h * G + r % G at position kv_len - S + r / G, masked causally (and by the
// window) at its own position.  A page is live iff it starts before kv_len
// and, with a window, ends inside the OLDEST row's window; kv_len == 0 gives
// no live page and an exactly zero output.  Inside a live page every row is
// scored and masked, as in the reference: a row that sees no key of any live
// page averages the live pages' rows with equal weight, as the reference
// does.  A -1 table entry outside the live pages is never read; one inside
// them is read as page 0, as the reference clips it.  int8 scales fold in as
// scalars: after the QK dot (with the softmax scale) and on P before the PV
// product.  For bf16 pages P is rounded to bf16 before the PV product.
//
// Design.  The TPU runs one grid step per page.  Here one CTA serves a SPAN
// of `span_pages` consecutive block-table entries (512 keys at page 16) for
// one (sequence, kv-head): it loads its page ids from the block table in
// device memory (the TPU's scalar prefetch becomes a plain load), writes the
// per-page execution map, and, over its live pages only, forms the G * S
// rows' logits in shared memory (warps take eight keys at a time, lanes
// across the head dimension), P = exp(s - m) with one warp per row, and the
// unnormalised P V with threads across (key split, row, 4 value columns).
// Dead spans write the neutral partials m = -inf, l = 0, o = 0.  The combine
// launch merges the spans' partials with the max / logsumexp rule and writes
// (B, S, H, dv) in q's dtype.  Nothing is allocated here: the partial
// buffers come from the wrapper.  Both launches run on the caller's stream.
//
// What bounds it.  A decode step reads every live K/V byte once and does ~1
// operation per byte: it is bound by the live K/V bytes over the memory rate
// (3.35 TB/s).  This simple version keeps eight row loads in flight per lane
// and does not yet use TMA or wgmma; with B * Hkv * spans CTAs (256 at B 8,
// kv_len 2064) few bytes are in flight per SM, so it is bound by load
// latency, not bandwidth.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 8;  // K or V rows in flight per thread
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* block_tables;  // (B, max_pp), row stride sbt
  const int* kv_lens;       // (B,)
  const float* k_scales;    // (Hkv, num_pages) or null
  const float* v_scales;
  void* out;
  float* o_part;  // (B, Hkv, NSPAN, R, Dv)
  float* m_part;  // (B, Hkv, NSPAN, R)
  float* l_part;  // (B, Hkv, NSPAN, R)
  int* counts;    // (B, Hkv, max_pp) or null
  int Hkv, G, S, R, D, Dv, pg, num_pages, max_pp, span_pages, nspan;
  long long sq_b, sq_s, sq_h;
  long long sk_h, sk_p, sk_t;
  long long sv_h, sv_p, sv_t;
  long long sbt;
  long long so_b, so_s, so_h;
  int window;
  float scale;
};

__device__ __forceinline__ float4 load4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(x);
  const float2 a = __bfloat1622float2(x2[0]), b = __bfloat1622float2(x2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const int8_t* x) {
  const char4 c = *reinterpret_cast<const char4*>(x);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
}
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// P in the value dtype before the PV product (the reference's
// `p.astype(v.dtype)`); int8 pages keep P in f32
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, int8_t) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// Key splits of the PV product: threads cover (split, row, 4 value columns).
__host__ __device__ inline int key_splits(int R, int Dv) {
  const int combos = R * (Dv / 4);
  return combos >= kThreads ? 1 : kThreads / combos;
}

// The reference's liveness predicate for block-table entry `ip`.
__device__ __forceinline__ bool page_live(int ip, int kvlen, const Params& p) {
  bool live = ip * p.pg < kvlen;
  if (p.window > 0) live = live && (ip * p.pg + p.pg - 1) > (kvlen - p.S - p.window);
  return live;
}

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_partition_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int is = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int R = p.R, D = p.D, Dv = p.Dv, pg = p.pg, G = p.G;
  const int kc = p.span_pages * pg;  // key capacity of a span
  const int NS = key_splits(R, Dv);
  float* qs = smem;                    // (R, D)
  float* ss = qs + round4(R * D);      // (R, kc) logits, then probabilities
  float* part = ss + round4(R * kc);   // (NS, R, Dv) PV partials
  int* pages = reinterpret_cast<int*>(part + NS * R * Dv);  // (span_pages)
  float* ksc = reinterpret_cast<float*>(pages + p.span_pages);
  float* vsc = ksc + p.span_pages;

  const long long slot = (long long)(ib * p.Hkv + ih) * p.nspan + is;
  const int kvlen = p.kv_lens[ib];
  const int p0 = is * p.span_pages;
  const int np_span = min(p.span_pages, p.max_pp - p0);
  if (p.counts != nullptr) {
    for (int j = tid; j < np_span; j += kThreads)
      p.counts[(long long)(ib * p.Hkv + ih) * p.max_pp + p0 + j] = page_live(p0 + j, kvlen, p);
  }
  // live entries of this span: a contiguous run [j_lo, j_hi]
  int j_lo = -1, j_hi = -1;
  for (int j = 0; j < np_span; ++j) {
    if (page_live(p0 + j, kvlen, p)) {
      if (j_lo < 0) j_lo = j;
      j_hi = j;
    }
  }
  if (j_lo < 0) {
    for (int e = tid; e < R * Dv; e += kThreads) p.o_part[slot * R * Dv + e] = 0.f;
    for (int r = tid; r < R; r += kThreads) {
      p.m_part[slot * R + r] = -INFINITY;
      p.l_part[slot * R + r] = 0.f;
    }
    return;
  }
  const int c_lo = j_lo * pg, c_hi = (j_hi + 1) * pg;  // keys relative to the span
  const int key0 = p0 * pg;                            // absolute position of key 0

  for (int j = j_lo + tid; j <= j_hi; j += kThreads) {
    int page = p.block_tables[ib * p.sbt + p0 + j];
    page = min(max(page, 0), p.num_pages - 1);
    pages[j] = page;
    if (p.k_scales != nullptr) {
      ksc[j] = p.k_scales[(long long)ih * p.num_pages + page];
      vsc[j] = p.v_scales[(long long)ih * p.num_pages + page];
    }
  }
  const TQ* q = static_cast<const TQ*>(p.q);
  const int D4 = D / 4;
  for (int e = tid; e < R * D4; e += kThreads) {
    const int r = e / D4, d = (e % D4) * 4;
    const int s_idx = r / G, g = r % G;
    *reinterpret_cast<float4*>(qs + r * D + d) =
        load4(q + ib * p.sq_b + s_idx * p.sq_s + (long long)(ih * G + g) * p.sq_h + d);
  }
  __syncthreads();

  // raw QK dots: each warp takes kKeys keys at a time, lanes across the
  // head dimension in float4 groups (32 groups per pass), so kKeys row
  // loads are in flight per lane and each K row is read once
  const TKV* k = static_cast<const TKV*>(p.k) + (long long)ih * p.sk_h;
  for (int c0 = c_lo + warp * kKeys; c0 < c_hi; c0 += kWarps * kKeys) {
    for (int d0 = 0; d0 < D4; d0 += 32) {
      const int d4 = d0 + lane;
      float4 kv[kKeys];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int c = c0 + u;
        kv[u] = (c < c_hi && d4 < D4)
                    ? load4(k + pages[c / pg] * p.sk_p + (long long)(c % pg) * p.sk_t + d4 * 4)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int r = 0; r < R; ++r) {
        const float4 qv = d4 < D4 ? *reinterpret_cast<const float4*>(qs + r * D + d4 * 4)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int u = 0; u < kKeys; ++u) {
          const float sdot = warp_sum(dot4(qv, kv[u]));
          if (lane == 0 && c0 + u < c_hi) {
            float* dst = ss + r * kc + c0 + u;
            *dst = d0 ? *dst + sdot : sdot;
          }
        }
      }
    }
  }
  __syncthreads();

  // per row (one warp each): scale (and int8 page scale), causal / window
  // mask at the row's position, m = max, P = exp(s - m), l = sum P
  for (int r = warp; r < R; r += kWarps) {
    const int row_pos = kvlen - p.S + r / G;
    float* srow = ss + r * kc;
    float mx = -INFINITY;
    for (int c = c_lo + lane; c < c_hi; c += 32) {
      float s = srow[c] * p.scale;
      if (p.k_scales != nullptr) s *= ksc[c / pg];
      const int pos = key0 + c;
      bool vis = pos <= row_pos;
      if (p.window > 0) vis = vis && pos > row_pos - p.window;
      s = vis ? s : kMaskValue;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = warp_max(mx);
    float sum = 0.f;
    for (int c = c_lo + lane; c < c_hi; c += 32) {
      const float e = expf(srow[c] - mx);
      sum += e;
      float pe = round_p(e, TKV());
      if (p.v_scales != nullptr) pe *= vsc[c / pg];
      srow[c] = pe;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      p.m_part[slot * R + r] = mx;
      p.l_part[slot * R + r] = sum;
    }
  }
  __syncthreads();

  // unnormalised P V: thread e -> (key split, row, 4 value columns), with
  // kKeys rows of V loaded before they are summed
  const int combos = R * (Dv / 4);
  const TKV* v = static_cast<const TKV*>(p.v) + (long long)ih * p.sv_h;
  for (int e = tid; e < NS * combos; e += kThreads) {
    const int split = e / combos, rj = e % combos;
    const int r = rj / (Dv / 4), j = (rj % (Dv / 4)) * 4;
    const float* prow = ss + r * kc;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = c_lo + split; c0 < c_hi; c0 += NS * kKeys) {
      float4 vv[kKeys];
      float pp[kKeys];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int c = c0 + u * NS;
        pp[u] = c < c_hi ? prow[c] : 0.f;
        vv[u] = c < c_hi ? load4(v + pages[c / pg] * p.sv_p + (long long)(c % pg) * p.sv_t + j)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        acc.x = fmaf(pp[u], vv[u].x, acc.x);
        acc.y = fmaf(pp[u], vv[u].y, acc.y);
        acc.z = fmaf(pp[u], vv[u].z, acc.z);
        acc.w = fmaf(pp[u], vv[u].w, acc.w);
      }
    }
    *reinterpret_cast<float4*>(part + split * R * Dv + r * Dv + j) = acc;
  }
  __syncthreads();
  for (int e = tid; e < R * Dv; e += kThreads) {
    float acc = 0.f;
    for (int split = 0; split < NS; ++split) acc += part[split * R * Dv + e];
    p.o_part[slot * R * Dv + e] = acc;
  }
}

// Cross-span max / logsumexp merge (`_combine_partitions`).
template <typename TQ>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(const Params p) {
  const int ih = blockIdx.x, ib = blockIdx.y;
  const int R = p.R, Dv = p.Dv, G = p.G;
  const long long base = (long long)(ib * p.Hkv + ih) * p.nspan;
  TQ* out = static_cast<TQ*>(p.out);
  for (int e = threadIdx.x; e < R * Dv; e += kThreads) {
    const int r = e / Dv, j = e % Dv;
    float m_glob = -INFINITY;
    for (int is = 0; is < p.nspan; ++is) m_glob = fmaxf(m_glob, p.m_part[(base + is) * R + r]);
    m_glob = fmaxf(m_glob, kMaskValue);
    float den = 0.f, num = 0.f;
    for (int is = 0; is < p.nspan; ++is) {
      // dead spans carry m = -inf: exp(-inf - finite) = 0
      const float alpha = expf(p.m_part[(base + is) * R + r] - m_glob);
      den += alpha * p.l_part[(base + is) * R + r];
      num += alpha * p.o_part[(base + is) * R * Dv + e];
    }
    const int s_idx = r / G, g = r % G;
    out[ib * p.so_b + s_idx * p.so_s + (long long)(ih * G + g) * p.so_h + j] =
        from_f32<TQ>(num / fmaxf(den, 1e-30f));
  }
}

size_t partition_smem_bytes(int R, int D, int Dv, int pg, int span_pages) {
  return sizeof(float) * ((size_t)round4(R * D) + (size_t)round4(R * span_pages * pg) +
                          (size_t)key_splits(R, Dv) * R * Dv + 3 * (size_t)span_pages);
}

template <typename TQ, typename TKV>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = partition_smem_bytes(p.R, p.D, p.Dv, p.pg, p.span_pages);
  cudaError_t err = cudaFuncSetAttribute(paged_partition_kernel<TQ, TKV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  paged_partition_kernel<TQ, TKV><<<dim3(p.nspan, p.Hkv, B), kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_combine_kernel<TQ><<<dim3(p.Hkv, B), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t launch_kv(const Params& p, int kv_dtype, int B, cudaStream_t stream) {
  if (kv_dtype == 0) return launch<TQ, float>(p, B, stream);
  if (kv_dtype == 1) return launch<TQ, __nv_bfloat16>(p, B, stream);
  if (kv_dtype == 2) return launch<TQ, int8_t>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory one partition CTA needs, for the wrapper's choice of span.
size_t paged_decode_attention_smem_bytes(int R, int D, int Dv, int pg, int span_pages) {
  return partition_smem_bytes(R, D, Dv, pg, span_pages);
}

// q_dtype: 0 = float32, 1 = bfloat16 (q and out); kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (k and v pages; int8 passes k/v scales, float
// pages pass null).  q is (B, S, H, D), pages (Hkv, num_pages, pg, W),
// out (B, S, H, Dv); strides are in elements and the last dimension is
// contiguous.  Returns the cudaError_t of the launches.
int paged_decode_attention_fwd(const void* q, const void* k, const void* v,
                               const int* block_tables, const int* kv_lens,
                               const float* k_scales, const float* v_scales, void* out,
                               float* o_part, float* m_part, float* l_part, int* counts,
                               int q_dtype, int kv_dtype, int B, int S, int H, int Hkv, int D,
                               int Dv, int pg, int num_pages, int max_pp, int span_pages,
                               long long sq_b, long long sq_s, long long sq_h,
                               long long sk_h, long long sk_p, long long sk_t,
                               long long sv_h, long long sv_p, long long sv_t, long long sbt,
                               long long so_b, long long so_s, long long so_h,
                               int window, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.block_tables = block_tables; p.kv_lens = kv_lens;
  p.k_scales = k_scales; p.v_scales = v_scales;
  p.out = out; p.o_part = o_part; p.m_part = m_part; p.l_part = l_part; p.counts = counts;
  p.Hkv = Hkv; p.G = H / Hkv; p.S = S; p.R = S * (H / Hkv); p.D = D; p.Dv = Dv;
  p.pg = pg; p.num_pages = num_pages; p.max_pp = max_pp; p.span_pages = span_pages;
  p.nspan = (max_pp + span_pages - 1) / span_pages;
  p.sq_b = sq_b; p.sq_s = sq_s; p.sq_h = sq_h;
  p.sk_h = sk_h; p.sk_p = sk_p; p.sk_t = sk_t;
  p.sv_h = sv_h; p.sv_p = sv_p; p.sv_t = sv_t;
  p.sbt = sbt;
  p.so_b = so_b; p.so_s = so_s; p.so_h = so_h;
  p.window = window; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return (int)launch_kv<float>(p, kv_dtype, B, st);
  if (q_dtype == 1) return (int)launch_kv<__nv_bfloat16>(p, kv_dtype, B, st);
  return (int)cudaErrorInvalidValue;
}

const char* paged_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
