// Split-KV decode attention (flash-decoding) for Hopper (sm_90a), f32 and
// bf16 inputs with f32 accumulation.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `_split_kv_partition` of
// src/repro/kernels/decode_attention.py (`decode_attention`) and fuses its
// cross-partition combine `_combine_partitions`, which runs outside the
// `pallas_call` in JAX, into a second launch of the same entry point.
//
// Design.  The padded cache (B, T, Hkv, D) is split along T into partitions
// of `kc` keys.  One CTA per (partition, kv-head, batch) serves the G query
// heads of its kv-head: partitions at or after kv_len, or wholly outside the
// window, write the neutral partials m = -inf, l = 0, o = 0 and load nothing.
// A live partition reads only its live keys: a 512-key f32 K panel at
// D = 128 (256 KB) does not fit in shared memory, so the CTA walks the keys
// eight per warp, keeps just the G x kc logits in shared memory, then forms
// P = exp(s - m) and the unnormalised P V with threads across groups of four
// value columns and a few key splits reduced in a fixed order.  For bf16 inputs P is
// rounded to bf16 before the PV product, as the TPU kernel does.  The
// combine kernel merges the partials with the max / logsumexp rule and
// writes (B, 1, H, Dv) in the input dtype.  Nothing is allocated here: the
// partial buffers come from the wrapper.  Both launches run on the caller's
// stream.
//
// What bounds it.  One decode step reads every live K/V byte once and does
// ~1 operation per byte, so it is bound by the live K/V bytes over the
// memory rate (3.35 TB/s).  This simple version keeps eight float4 row loads
// in flight per thread (K: lanes across the head dimension; V: threads
// across value columns); it does not yet use TMA or more CTAs per partition,
// and with B * Hkv * P = 160 CTAs at the serving shape few bytes are in
// flight per SM: the step is bound by load latency, not bandwidth.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKeys = 8;  // K or V rows in flight per thread
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* o_part;  // (B, Hkv, P, G, Dv)
  float* m_part;  // (B, Hkv, P, G)
  float* l_part;  // (B, Hkv, P, G)
  int* counts;    // (B, Hkv, P) or null
  int T, Hkv, G, D, Dv, P;
  long long sq_b, sq_h;
  long long sk_b, sk_t, sk_h;
  long long sv_b, sv_t, sv_h;
  long long so_b, so_h;
  int kv_len, window, kc;
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
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, a.w * b.w)));
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float round_p(float p, float) { return p; }
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

// Block-wide reduction through `red` (kThreads / 32 floats); every thread
// gets the result.
template <bool kMax>
__device__ float block_reduce(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = kMax ? warp_max(x) : warp_sum(x);
  __syncthreads();
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float y = red[0];
  for (int w = 1; w < kThreads / 32; ++w) y = kMax ? fmaxf(y, red[w]) : y + red[w];
  return y;
}

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// Key splits of the PV product: threads cover (split, head, 4 value columns).
__host__ __device__ inline int key_splits(int G, int Dv) {
  const int combos = G * (Dv / 4);
  return combos >= kThreads ? 1 : kThreads / combos;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decode_partition_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ip = blockIdx.x, ih = blockIdx.y, ib = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = p.G, D = p.D, Dv = p.Dv, kc = p.kc;
  const int NS = key_splits(G, Dv);
  float* qs = smem;                  // (G, D)
  float* ss = qs + round4(G * D);    // (G, kc) logits, then probabilities
  float* part = ss + round4(G * kc); // (NS, G, Dv) PV partials
  float* red = part + NS * G * Dv;

  const long long slot = (long long)(ib * p.Hkv + ih) * p.P + ip;
  const int k_lo = ip * kc;
  const int row_pos = p.kv_len - 1;  // the query's absolute position
  bool live = k_lo < p.kv_len;
  if (p.window > 0) live = live && (k_lo + kc - 1) > (row_pos - p.window);
  if (p.counts != nullptr && tid == 0) p.counts[slot] = live;
  if (!live) {
    for (int e = tid; e < G * Dv; e += kThreads) p.o_part[slot * G * Dv + e] = 0.f;
    for (int g = tid; g < G; g += kThreads) {
      p.m_part[slot * G + g] = -INFINITY;
      p.l_part[slot * G + g] = 0.f;
    }
    return;
  }
  // live keys of this partition: [c_lo, c_hi); the rest are masked and
  // contribute exp(MASK_VALUE - m) = 0 exactly, so they are never read
  int c_lo = 0;
  if (p.window > 0) c_lo = max(0, row_pos - p.window + 1 - k_lo);
  const int c_hi = min(kc, p.kv_len - k_lo);

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const int D4 = D / 4;
  for (int e = tid; e < G * D4; e += kThreads) {
    const int g = e / D4, d = (e % D4) * 4;
    *reinterpret_cast<float4*>(qs + g * D + d) =
        load4(q + ib * p.sq_b + (long long)(ih * G + g) * p.sq_h + d);
  }
  for (int e = tid; e < G * kc; e += kThreads) ss[e] = kMaskValue;
  __syncthreads();

  // logits: each warp takes kKeys keys at a time, lanes across the head
  // dimension in float4 groups, so kKeys row loads are in flight per lane
  const T* kbase = k + ib * p.sk_b + (long long)ih * p.sk_h;
  for (int c0 = c_lo + warp * kKeys; c0 < c_hi; c0 += (kThreads / 32) * kKeys) {
    for (int g = 0; g < G; ++g) {
      float acc[kKeys] = {};
      for (int d4 = lane; d4 < D4; d4 += 32) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + g * D + d4 * 4);
#pragma unroll
        for (int u = 0; u < kKeys; ++u)
          if (c0 + u < c_hi)
            acc[u] += dot4(qv, load4(kbase + (long long)(k_lo + c0 + u) * p.sk_t + d4 * 4));
      }
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const float s = warp_sum(acc[u]);
        if (lane == 0 && c0 + u < c_hi) ss[g * kc + c0 + u] = s * p.scale;
      }
    }
  }
  __syncthreads();

  // per query head: m = max, P = exp(s - m), l = sum P
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
    for (int c = tid; c < kc; c += kThreads) mx = fmaxf(mx, ss[g * kc + c]);
    mx = block_reduce<true>(mx, red);
    float sum = 0.f;
    for (int c = c_lo + tid; c < c_hi; c += kThreads) {
      const float e = expf(ss[g * kc + c] - mx);
      sum += e;
      ss[g * kc + c] = round_p(e, T());
    }
    sum = block_reduce<false>(sum, red);
    if (tid == 0) {
      p.m_part[slot * G + g] = mx;
      p.l_part[slot * G + g] = sum;
    }
  }
  __syncthreads();

  // unnormalised P V: thread e -> (key split, head, 4 value columns), with
  // kKeys rows of V loaded before they are summed
  const int combos = G * (Dv / 4);
  const T* vbase = v + ib * p.sv_b + (long long)ih * p.sv_h;
  for (int e = tid; e < NS * combos; e += kThreads) {
    const int split = e / combos, gj = e % combos;
    const int g = gj / (Dv / 4), j = (gj % (Dv / 4)) * 4;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = c_lo + split; c0 < c_hi; c0 += NS * kKeys) {
      float4 vv[kKeys];
      float pp[kKeys];
#pragma unroll
      for (int u = 0; u < kKeys; ++u) {
        const int c = c0 + u * NS;
        pp[u] = c < c_hi ? ss[g * kc + c] : 0.f;
        vv[u] = c < c_hi ? load4(vbase + (long long)(k_lo + c) * p.sv_t + j)
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
    *reinterpret_cast<float4*>(part + split * G * Dv + g * Dv + j) = acc;
  }
  __syncthreads();
  for (int e = tid; e < G * Dv; e += kThreads) {
    float acc = 0.f;
    for (int split = 0; split < NS; ++split) acc += part[split * G * Dv + e];
    p.o_part[slot * G * Dv + e] = acc;
  }
}

// Cross-partition max / logsumexp merge (`_combine_partitions`).
template <typename T>
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(const Params p) {
  const int ih = blockIdx.x, ib = blockIdx.y;
  const int G = p.G, Dv = p.Dv;
  const long long base = (long long)(ib * p.Hkv + ih) * p.P;
  T* out = static_cast<T*>(p.out);
  for (int e = threadIdx.x; e < G * Dv; e += kThreads) {
    const int g = e / Dv, j = e % Dv;
    float m_glob = -INFINITY;
    for (int ip = 0; ip < p.P; ++ip) m_glob = fmaxf(m_glob, p.m_part[(base + ip) * G + g]);
    m_glob = fmaxf(m_glob, kMaskValue);
    float den = 0.f, num = 0.f;
    for (int ip = 0; ip < p.P; ++ip) {
      // dead partitions carry m = -inf: exp(-inf - finite) = 0
      const float alpha = expf(p.m_part[(base + ip) * G + g] - m_glob);
      den += alpha * p.l_part[(base + ip) * G + g];
      num += alpha * p.o_part[(base + ip) * G * Dv + e];
    }
    out[ib * p.so_b + (long long)(ih * G + g) * p.so_h + j] = from_f32<T>(num / fmaxf(den, 1e-30f));
  }
}

size_t partition_smem_bytes(int G, int D, int Dv, int kc) {
  return sizeof(float) * ((size_t)round4(G * D) + (size_t)round4(G * kc) +
                          (size_t)key_splits(G, Dv) * G * Dv + kThreads / 32);
}

template <typename T>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = partition_smem_bytes(p.G, p.D, p.Dv, p.kc);
  cudaError_t err = cudaFuncSetAttribute(decode_partition_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  decode_partition_kernel<T><<<dim3(p.P, p.Hkv, B), kThreads, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_combine_kernel<T><<<dim3(p.Hkv, B), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  q is
// (B, 1, H, D), k/v (B, T, Hkv, D[v]), out (B, 1, H, Dv); strides are in
// elements and the last dimension is contiguous.  kv_len is already clamped
// to T.  Returns the cudaError_t of the launches.
int decode_attention_fwd(const void* q, const void* k, const void* v, void* out, float* o_part,
                         float* m_part, float* l_part, int* counts, int dtype, int B, int H,
                         int T, int Hkv, int D, int Dv, long long sq_b, long long sq_h,
                         long long sk_b, long long sk_t, long long sk_h, long long sv_b,
                         long long sv_t, long long sv_h, long long so_b, long long so_h,
                         int kv_len, int window, float scale, int kc, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.o_part = o_part; p.m_part = m_part; p.l_part = l_part; p.counts = counts;
  p.T = T; p.Hkv = Hkv; p.G = H / Hkv; p.D = D; p.Dv = Dv;
  p.P = (T + kc - 1) / kc;
  p.sq_b = sq_b; p.sq_h = sq_h;
  p.sk_b = sk_b; p.sk_t = sk_t; p.sk_h = sk_h;
  p.sv_b = sv_b; p.sv_t = sv_t; p.sv_h = sv_h;
  p.so_b = so_b; p.so_h = so_h;
  p.kv_len = kv_len; p.window = window; p.kc = kc; p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, B, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one partition CTA needs: the wrapper refuses a shape past
// the 227 KiB a CTA may opt in to before it launches.
size_t decode_attention_smem_bytes(int G, int D, int Dv, int kc) {
  return partition_smem_bytes(G, D, Dv, kc);
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
