// Split-KV decode attention over a dense cache for Hopper (sm_90a): q, k and
// v in f32 or bf16, f32 accumulation, the output in q's dtype.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `_split_kv_partition` of
// src/repro/kernels/decode_attention.py (`decode_attention`), and fuses its
// cross-partition combine `_combine_partitions`, which runs outside the
// `pallas_call` in JAX, into the same launch.
//
// Contract (that of the reference).  q (B, 1, H, D) is the new token's
// queries, k/v (B, T, Hkv, D[v]) the padded cache with their own strides, the
// new K/V already written, so the query sits at position kv_len - 1 (a host
// int, clamped to T).  It sees the keys [lo, kv_len), lo = kv_len - window
// with a window (at least 0).  The (B, Hkv, P) execution map is the
// reference's over `kc`-key partitions: partition ip is live iff it starts
// before kv_len and, with a window, ends inside it.  kv_len 0 gives an exactly
// zero output.  For bf16 inputs P is rounded to bf16 before the P V product,
// against the max of the key CHUNK it lies in (the reference rounds against
// its 512-key partition's max: within bf16's rounding of each other).
//
// What bounds it.  A decode step reads every live K/V byte once and does
// about one operation per byte, far below the card's ridge: it is bound by
// the live K/V bytes over the memory rate (3.35 TB/s).  MLA's absorbed decode
// (128 query heads on one latent head, D 576, Dv 512) does 128 times the
// operations per byte, and is bound by them (67 TFLOP/s on SIMT f32).  The
// design keeps the bytes in flight and the per-key work off the block's
// critical path:
//
// * One even wave of CTAs.  A CTA serves a SPAN of `span` keys of one
//   (sequence, kv-head, row group).  The wrapper picks the span from
//   host-known shapes only: T split evenly, in whole chunks, so that the grid
//   is about the CTAs the SMs hold at once (by shared memory, at most 3 an
//   SM), and no SM gets a CTA more than the others.  kv_len does not size the
//   grid: a span past it exits at once.
// * Key chunks owned by warps.  The CTA's warps form `key_warps` key groups;
//   group g computes chunks g, g + key_warps, ... of the span's live keys
//   (`chunk` keys each, 16 or fewer where the rows are wide) through its own
//   slots with no block barrier: K rows then V rows, each row one 1-D bulk
//   copy (`cp.async.bulk`, issued by one lane a row) completing on the
//   group's mbarriers.  The first chunk is requested before the query rows
//   load, the next chunk's K as soon as this chunk's QK is done, its V once
//   the P V is.  (A TMA tensor map, one copy a chunk, timed within a few
//   percent of this on the card, at the price of a host-side encode per
//   cache pointer: PERF.md, PR 17.)  Where V is the leading Dv
//   columns of K's own rows (MLA's one latent cache), the values are read
//   from the K rows and the group's two slots take alternate chunks of K, the
//   next but one requested once a P V is done.
// * K read once for all rows.  A warp scores the chunk for every row of its
//   tile from one copy of K in shared memory (T lanes a key across the head
//   dimension, reduced over T lanes; K rows skewed 16 bytes a lane so a
//   load's lanes read distinct banks), then per row: the chunk max, P =
//   exp(s - m_chunk) (rounded for bf16), l, folded into the row's running
//   (m, l) by the max / logsumexp rule; lanes across value columns add P V
//   into float4 accumulators in registers, four keys at a time.  No logit
//   buffer outlives a chunk.  The row loops carry no branch: rows past the
//   tile repeat its last row and are never kept.
// * Rows in tiles of at most 16 (4 at Dv 512), so shared memory and registers
//   do not grow with G: G 7 and 12 are masked inside their tile.  Where G
//   needs more tiles than one, `row_warps` warps of a key group take a tile
//   each over the same chunk in shared memory (a named barrier frees a slot),
//   so MLA's 128 rows read each key once per 32 rows, not once per 4.
// * SIMT f32 arithmetic: at <= 16 rows a warp the tensor cores would gain
//   nothing for decode, and f32 keeps f32 accuracy.
//
// The combine is folded in: the key groups merge their (o, m, l) through
// shared memory, a CTA writes its span's partial, and the last CTA of a
// (sequence, kv-head, row group) to arrive (an atomic counter it resets to
// 0, so a captured graph replays) merges the live spans with the max /
// logsumexp rule and writes (B, 1, H, Dv) in q's dtype; a single live span
// writes the output itself.  Nothing is allocated here: the partial buffer
// and counters come from the wrapper.  The launch runs on the caller's
// stream; two launches that may run at once must not share counters (the
// wrapper keeps them per stream, and gives a graph capture its own).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 8;  // key groups x row warps
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxRowTile = 16;
constexpr int kMaxChunk = 32;  // a lane copies a row of a chunk
constexpr int kMaxDevices = 64;
constexpr int kSmemOptIn = 227 * 1024;  // what a CTA may opt in to on Hopper
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* o_part;  // (B, Hkv, nspan, G, Dv)
  float* m_part;  // (B, Hkv, nspan, G)
  float* l_part;  // (B, Hkv, nspan, G)
  int* counts;    // (B, Hkv, P) or null
  int* arrive;    // (B, Hkv, groups) spans arrived, 0 between calls
  int Hkv, G, D, Dv;
  int span, nspan, chunk, rows_tile, row_warps, key_warps, groups, shared_kv;
  long long sq_b, sq_h;
  long long sk_b, sk_t, sk_h;
  long long sv_b, sv_t, sv_h;
  long long so_b, so_h;
  int kv_len, window, kc, P;
  float scale;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Byte offsets of the dynamic shared memory of one CTA.
struct Layout {
  int krow, vrow, stage;  // row strides of a slot's K and V; bytes of a key group's slots
  int ring, q, p, state, flag, total;
};

// QK lanes: T lanes a key of a chunk, T * chunk <= 32 (chunk a power of two)
__host__ __device__ inline int key_lanes(int chunk) {
  int t = 1;
  while (t * 2 * chunk <= 32) t *= 2;
  return t;
}

__host__ __device__ inline Layout layout(int rows_tile, int D, int Dv, int chunk, int esize,
                                         int key_warps, int row_warps, int shared_kv) {
  Layout L;
  // K rows skewed by 16 bytes a QK lane: the 8 lanes of a 16-byte load's
  // phase (8 / T keys, T lanes each) then read distinct banks
  const int t = key_lanes(chunk);
  L.krow = round16(D * esize) + (t < 8 ? 16 * t : 0);
  L.vrow = round16(Dv * esize);
  // a key group's slots: a chunk's K rows then its V rows, or two chunks of
  // K rows whose leading Dv columns are the values
  L.stage = shared_kv ? 2 * chunk * L.krow : chunk * (L.krow + L.vrow);
  const int rows_cta = row_warps * rows_tile, warps = key_warps * row_warps;
  // after the chunks, the slots hold the key groups' (o, m, l) for their
  // merge, then the spans' per-row max and 1 / denominator
  const int slots = key_warps * L.stage;
  const int merge = key_warps > 1 ? key_warps * rows_cta * (Dv + 2) * 4 : 0;
  L.ring = 128;  // after the mbarriers: two a key group
  L.q = L.ring + round16(imax(imax(slots, merge), rows_cta * 2 * 4));
  L.p = L.q + round16(rows_cta * D * 4);                    // the CTA's f32 query rows
  L.state = L.p + round16(warps * rows_tile * chunk * 4);   // a warp's chunk of logits / P
  L.flag = L.state + round16(warps * rows_tile * 3 * 4);    // a warp's m, l, alpha a row
  L.total = L.flag + 16;
  return L;
}

// ---- loads and conversions ----------------------------------------------

__device__ __forceinline__ float4 load4(const float* x) {
  return *reinterpret_cast<const float4*>(x);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* x) {
  const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(x);
  const float2 a = __bfloat1622float2(x2[0]), b = __bfloat1622float2(x2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// one 16-byte chunk of a K row, widened to f32
__device__ __forceinline__ void unpack16(const float* k, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(k);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
}
__device__ __forceinline__ void unpack16(const __nv_bfloat16* k, float* f) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 h;
    *reinterpret_cast<uint32_t*>(&h) = w[i];
    const float2 x = __bfloat1622float2(h);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

template <int N>
__device__ __forceinline__ float dot_q(const float* f, const float* q, float acc) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 qv = *reinterpret_cast<const float4*>(q + i);
    acc = fmaf(f[i], qv.x, acc);
    acc = fmaf(f[i + 1], qv.y, acc);
    acc = fmaf(f[i + 2], qv.z, acc);
    acc = fmaf(f[i + 3], qv.w, acc);
  }
  return acc;
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// P in the value dtype before the PV product (the reference's
// `p.astype(v.dtype)`)
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
}

template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 o, float inv) {
  dst[0] = from_f32<T>(o.x * inv);
  dst[1] = from_f32<T>(o.y * inv);
  dst[2] = from_f32<T>(o.z * inv);
  dst[3] = from_f32<T>(o.w * inv);
}

// max / sum over the n (a power of two) lanes of a lane group
__device__ __forceinline__ float group_max(float x, int n) {
  for (int off = n / 2; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x, int n) {
  for (int off = n / 2; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ---- bulk copies completing on an mbarrier ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// the warps of one key group, named barrier 1 + group
__device__ __forceinline__ void group_barrier(int group, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(threads) : "memory");
}

// One CTA: one span of keys of one (sequence, kv-head, row group).  Warp w
// is row warp w % row_warps of key group w / row_warps; the group computes
// chunks g, g + key_warps, ... of the span's live keys, each row warp for
// its tile of rows.  The groups merge their (o, m, l) once, the CTA writes
// the span's partial, and the last CTA of the (sequence, kv-head, row
// group) to arrive merges the spans and writes the output.  RMAX x PMAX
// float4 accumulators a lane: rows by passes of 128 value columns.
template <typename T, int RMAX, int PMAX>
__global__ void __launch_bounds__(kMaxThreads) decode_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kEpc = 16 / sizeof(T);  // elements of a 16-byte chunk
  const int is = blockIdx.x, ih = blockIdx.y / p.groups, it = blockIdx.y % p.groups;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int RW = p.row_warps, KW = p.key_warps, nt = 32 * KW * RW;
  const int kg = warp / RW, rw = warp % RW;
  const int D = p.D, Dv = p.Dv, G = p.G, CK = p.chunk, rows_tile = p.rows_tile;
  const bool shared_kv = p.shared_kv != 0;
  const long long bh = (long long)ib * p.Hkv + ih;

  // the execution map over the reference's kc-key partitions
  if (p.counts != nullptr && is == 0 && it == 0) {
    for (int ip = tid; ip < p.P; ip += nt) {
      const int k_lo = ip * p.kc;
      bool live = k_lo < p.kv_len;
      if (p.window > 0) live = live && (k_lo + p.kc - 1) > (p.kv_len - 1 - p.window);
      p.counts[bh * p.P + ip] = live;
    }
  }
  // the keys the query sees, [lo, hi), lie in the spans [s_lo, s_hi)
  const int hi = p.kv_len;
  const int lo = p.window > 0 ? max(0, hi - p.window) : 0;
  const int s_lo = hi > 0 ? lo / p.span : 0;
  const int s_hi = hi > 0 ? (hi + p.span - 1) / p.span : 0;
  const int nlive = s_hi - s_lo;
  const int rows_cta = RW * rows_tile;
  const int c0 = it * rows_cta;           // the CTA's first row of G
  const int rc = min(rows_cta, G - c0);   // its rows
  T* out = static_cast<T*>(p.out);
  if (nlive == 0) {  // kv_len 0: an exactly zero output
    if (is == 0) {
      for (int e = tid; e < rc * Dv; e += nt) {
        const int r = e / Dv, j = e % Dv;
        out[ib * p.so_b + (long long)(ih * G + c0 + r) * p.so_h + j] = from_f32<T>(0.f);
      }
    }
    return;
  }
  if (is < s_lo || is >= s_hi) return;

  const Layout L = layout(rows_tile, D, Dv, CK, sizeof(T), KW, RW, p.shared_kv);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);      // (key groups, 2)
  unsigned char* ring = smem + L.ring;                     // a key group's slots
  float* qs = reinterpret_cast<float*>(smem + L.q);        // (rows_cta, D)
  float* wps = reinterpret_cast<float*>(smem + L.p) + warp * rows_tile * CK;
  float* wm = reinterpret_cast<float*>(smem + L.state) + warp * rows_tile * 3;
  float* wl = wm + rows_tile;
  float* walpha = wl + rows_tile;
  int* last = reinterpret_cast<int*>(smem + L.flag);

  const int r0 = rw * rows_tile;                  // the warp's first row in the CTA
  const int rt = max(0, min(rows_tile, rc - r0));  // its rows (0 past G)
  const int a = max(lo, is * p.span);              // the span's live keys [a, e)
  const int e = min(hi, (is + 1) * p.span);
  const int nch = (e - a + CK - 1) / CK;
  const int my_n = nch > kg ? (nch - kg + KW - 1) / KW : 0;

  const T* kbase = static_cast<const T*>(p.k) + ib * p.sk_b + (long long)ih * p.sk_h;
  const T* vbase = static_cast<const T*>(p.v) + ib * p.sv_b + (long long)ih * p.sv_h;
  const int kbytes = D * (int)sizeof(T), vbytes = Dv * (int)sizeof(T);
  unsigned char* gslot = ring + kg * L.stage;
  uint64_t* gbar = bars + 2 * kg;
  const int vstride = shared_kv ? L.krow : L.vrow;  // bytes between V rows in a slot
  // chunk k of the group: its K rows, its V rows, their barriers and parity
  auto kslot = [&](int k) { return gslot + (shared_kv ? (k & 1) * CK * L.krow : 0); };
  auto vslot = [&](int k) { return shared_kv ? kslot(k) : gslot + CK * L.krow; };
  auto kbar = [&](int k) { return gbar + (shared_kv ? (k & 1) : 0); };
  auto vbar = [&](int k) { return shared_kv ? kbar(k) : gbar + 1; };
  auto parity = [&](int k) { return (uint32_t)((shared_kv ? k >> 1 : k) & 1); };
  auto chunk_key = [&](int k) { return a + (kg + k * KW) * CK; };
  // rows of chunk k (of K or of V) into its slot, one bulk copy a row
  // issued by a lane of the group's row warp 0
  auto issue = [&](int k, bool is_k) {
    const int key = chunk_key(k), n = min(CK, e - key);
    const long long st = is_k ? p.sk_t : p.sv_t;
    const T* src = (is_k ? kbase : vbase) + key * st;
    unsigned char* dst = is_k ? kslot(k) : vslot(k);
    const int bytes = is_k ? kbytes : vbytes, row = is_k ? L.krow : L.vrow;
    uint64_t* bar = is_k ? kbar(k) : vbar(k);
    if (lane == 0) {
      mbar_expect_tx(bar, (uint32_t)(n * bytes));
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncwarp();
    if (lane < n) bulk_copy(dst + lane * row, src + lane * st, bytes, bar);
  };
  auto group_sync = [&]() {
    if (RW == 1) __syncwarp();
    else group_barrier(kg, 32 * RW);
  };
  // the group's first chunk is requested before the query rows load, so
  // the two latencies overlap
  if (my_n > 0 && rw == 0) {
    if (lane < 2) mbar_init(&bars[2 * kg + lane]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncwarp();
    issue(0, true);
    if (!shared_kv) issue(0, false);
    else if (my_n > 1) issue(1, true);
  }
  const T* q = static_cast<const T*>(p.q);
  const int D4 = D / 4;
  for (int x = tid; x < rc * D4; x += nt) {
    const int r = x / D4, d = (x % D4) * 4;
    *reinterpret_cast<float4*>(qs + r * D + d) =
        load4(q + ib * p.sq_b + (long long)(ih * G + c0 + r) * p.sq_h + d);
  }
  if (lane < rows_tile) {
    wm[lane] = -INFINITY;
    wl[lane] = 0.f;
  }
  __syncthreads();

  const int Dv4 = Dv / 4;
  float4 acc[RMAX][PMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int ps = 0; ps < PMAX; ++ps) acc[r][ps] = make_float4(0.f, 0.f, 0.f, 0.f);

  if (my_n > 0) {
    // QK lanes: T lanes a key (part t of them takes the 16-byte chunks t,
    // t + T, ... of the key's row), every row of the tile at once
    const int TL = key_lanes(CK);
    const int part = lane & (TL - 1);
    const int kc16 = kbytes / 16;
    // softmax lanes: LR lanes a row, rows padded to a power of two
    int rp = 1;
    while (rp < rt) rp *= 2;
    const int LR = 32 / rp, srow = lane / LR, sq = lane & (LR - 1);
    const float* qw = qs + r0 * D;  // the warp's query rows
    // the loops run over RMAX rows with no branch: row r reads row
    // min(r, rt - 1) (its q and P), and the rows past rt are never kept
    int qoff[RMAX], poff[RMAX];
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      const int rr = max(0, min(r, rt - 1));
      qoff[r] = rr * D;
      poff[r] = rr * CK;
    }

    for (int k = 0; k < my_n; ++k) {
      const unsigned char* kp = kslot(k);
      const unsigned char* vp = vslot(k);
      const int n = min(CK, e - chunk_key(k));  // live keys of the chunk
      mbar_wait(kbar(k), parity(k));
      __syncwarp();
      for (int cc = 0; cc < CK; cc += 32 / TL) {
        const int c = cc + lane / TL;
        float s[RMAX];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) s[r] = 0.f;
        if (c < n) {
          const T* krow = reinterpret_cast<const T*>(kp + c * L.krow);
#pragma unroll 2
          for (int ch = part; ch < kc16; ch += TL) {
            float f[kEpc];
            unpack16(krow + ch * kEpc, f);
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
              s[r] = dot_q<kEpc>(f, qw + qoff[r] + ch * kEpc, s[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          const float x = group_sum(s[r], TL);
          if (r < rt && part == 0 && c < n) wps[r * CK + c] = x;
        }
      }
      if (!shared_kv) {
        group_sync();  // the K rows free
        if (rw == 0 && k + 1 < my_n) issue(k + 1, true);
      }

      // softmax of each row over the chunk: the scale, the chunk max, P =
      // exp(s - m_chunk) rounded for bf16, folded into the row's running
      // (m, l); P is stored times exp(m_chunk - m_new), walpha gets
      // exp(m_old - m_new)
      {
        const bool on = srow < rt;
        float* prow = wps + srow * CK;
        float mx = -INFINITY;
        if (on) {
          for (int c = sq; c < n; c += LR) {
            const float x = prow[c] * p.scale;
            prow[c] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = group_max(mx, LR);
        const float m_old = on ? wm[srow] : 0.f;
        const float m_new = fmaxf(m_old, mx);
        const float a_ch = expf(mx - m_new);
        float sum = 0.f;
        if (on) {
          for (int c = sq; c < n; c += LR) {
            const float x = expf(prow[c] - mx);
            sum += x;
            prow[c] = round_p(x, T()) * a_ch;
          }
        }
        sum = group_sum(sum, LR);
        __syncwarp();
        if (on && sq == 0) {
          const float a_old = expf(m_old - m_new);  // 0 on the warp's first chunk
          wm[srow] = m_new;
          wl[srow] = wl[srow] * a_old + sum * a_ch;
          walpha[srow] = a_old;
        }
      }
      __syncwarp();

      mbar_wait(vbar(k), parity(k));
      __syncwarp();
      // P V: lanes across value columns, 4 a lane a pass of 128
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        const float al = walpha[max(0, min(r, rt - 1))];
#pragma unroll
        for (int ps = 0; ps < PMAX; ++ps) {
          acc[r][ps].x *= al; acc[r][ps].y *= al; acc[r][ps].z *= al; acc[r][ps].w *= al;
        }
      }
      // keys four at a time (a row's P as one float4), then one at a time
      auto pv = [](float pc, float4 vv, float4& o) {
        o.x = fmaf(pc, vv.x, o.x);
        o.y = fmaf(pc, vv.y, o.y);
        o.z = fmaf(pc, vv.z, o.z);
        o.w = fmaf(pc, vv.w, o.w);
      };
      // a lane's value columns: pass ps takes 4 a lane of 128 (clamped to the
      // row past Dv; those columns are never kept)
      const int n4 = CK % 4 ? 0 : n & ~3;
      for (int c = 0; c < n4; c += 4) {
#pragma unroll
        for (int ps = 0; ps < PMAX; ++ps) {
          const int j4 = min((ps * 32 + lane) * 4, Dv - 4);
          float4 vv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            vv[u] = load4(reinterpret_cast<const T*>(vp + (c + u) * vstride) + j4);
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            const float4 p4 = *reinterpret_cast<const float4*>(wps + poff[r] + c);
            pv(p4.x, vv[0], acc[r][ps]);
            pv(p4.y, vv[1], acc[r][ps]);
            pv(p4.z, vv[2], acc[r][ps]);
            pv(p4.w, vv[3], acc[r][ps]);
          }
        }
      }
      for (int c = n4; c < n; ++c) {
        const T* vrow = reinterpret_cast<const T*>(vp + c * vstride);
#pragma unroll
        for (int ps = 0; ps < PMAX; ++ps) {
          const float4 vv = load4(vrow + min((ps * 32 + lane) * 4, Dv - 4));
#pragma unroll
          for (int r = 0; r < RMAX; ++r) pv(wps[poff[r] + c], vv, acc[r][ps]);
        }
      }
      group_sync();  // the V rows (with shared K/V, the chunk's slot) and P free
      if (rw == 0) {
        if (!shared_kv && k + 1 < my_n) issue(k + 1, false);
        if (shared_kv && k + 2 < my_n) issue(k + 2, true);
      }
    }
  }

  // the span's partial: one key group's accumulators as they are, else the
  // groups merged through shared memory (the slots are free).  A single
  // live span writes the output instead.
  const long long prow = (bh * p.nspan + is) * G + c0;  // (b, h, span, row c0)
  if (KW == 1) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= rt) continue;
      const float inv = nlive == 1 ? 1.f / fmaxf(wl[r], 1e-30f) : 1.f;
#pragma unroll
      for (int ps = 0; ps < PMAX; ++ps) {
        const int j4 = (ps * 32 + lane) * 4;
        if (j4 >= Dv) continue;
        if (nlive == 1)
          store4(out + ib * p.so_b + (long long)(ih * G + c0 + r0 + r) * p.so_h + j4,
                 acc[r][ps], inv);
        else
          *reinterpret_cast<float4*>(p.o_part + (prow + r0 + r) * Dv + j4) = acc[r][ps];
      }
    }
    if (nlive == 1) return;
    if (lane < rt) {
      p.m_part[prow + r0 + lane] = wm[lane];
      p.l_part[prow + r0 + lane] = wl[lane];
    }
  } else {
    __syncthreads();
    float* mo = reinterpret_cast<float*>(ring);    // (key groups, rows_cta, Dv)
    float* mml = mo + KW * rows_cta * Dv;          // (key groups, rows_cta, 2)
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= rt) continue;
#pragma unroll
      for (int ps = 0; ps < PMAX; ++ps) {
        const int j4 = (ps * 32 + lane) * 4;
        if (j4 < Dv)
          *reinterpret_cast<float4*>(mo + (kg * rows_cta + r0 + r) * Dv + j4) = acc[r][ps];
      }
    }
    if (lane < rt) {
      mml[(kg * rows_cta + r0 + lane) * 2] = wm[lane];
      mml[(kg * rows_cta + r0 + lane) * 2 + 1] = wl[lane];
    }
    __syncthreads();
    for (int x = tid; x < rc * Dv4; x += nt) {
      const int r = x / Dv4, j4 = (x % Dv4) * 4;
      float mx = -INFINITY;
      for (int g = 0; g < KW; ++g) mx = fmaxf(mx, mml[(g * rows_cta + r) * 2]);
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      float l = 0.f;
      for (int g = 0; g < KW; ++g) {
        const float m = mml[(g * rows_cta + r) * 2];
        if (m == -INFINITY) continue;  // a key group with no chunk
        const float al = expf(m - mx);
        const float4 y = *reinterpret_cast<const float4*>(mo + (g * rows_cta + r) * Dv + j4);
        o.x = fmaf(al, y.x, o.x); o.y = fmaf(al, y.y, o.y);
        o.z = fmaf(al, y.z, o.z); o.w = fmaf(al, y.w, o.w);
        l = fmaf(al, mml[(g * rows_cta + r) * 2 + 1], l);
      }
      if (nlive == 1) {
        store4(out + ib * p.so_b + (long long)(ih * G + c0 + r) * p.so_h + j4, o,
               1.f / fmaxf(l, 1e-30f));
      } else {
        *reinterpret_cast<float4*>(p.o_part + (prow + r) * Dv + j4) = o;
        if (j4 == 0) {
          p.m_part[prow + r] = mx;
          p.l_part[prow + r] = l;
        }
      }
    }
    if (nlive == 1) return;
  }

  // the last CTA of this (sequence, kv-head, row group) to arrive merges the
  // live spans by the max / logsumexp rule and resets the counter for the
  // next call (so a captured graph replays)
  __threadfence();
  __syncthreads();
  const long long bht = bh * p.groups + it;
  if (tid == 0) *last = atomicAdd(&p.arrive[bht], 1) == nlive - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (tid == 0) p.arrive[bht] = 0;
  const long long base = bh * p.nspan;
  float* mrow = reinterpret_cast<float*>(ring);  // per row: the max and 1 / the denominator
  for (int r = warp; r < rc; r += KW * RW) {
    float mx = -INFINITY;
    for (int s2 = s_lo + lane; s2 < s_hi; s2 += 32)
      mx = fmaxf(mx, __ldcg(p.m_part + (base + s2) * G + c0 + r));
    mx = fmaxf(group_max(mx, 32), kMaskValue);
    float den = 0.f;
    for (int s2 = s_lo + lane; s2 < s_hi; s2 += 32) {
      const float m = __ldcg(p.m_part + (base + s2) * G + c0 + r);
      den += expf(m - mx) * __ldcg(p.l_part + (base + s2) * G + c0 + r);
    }
    den = group_sum(den, 32);
    if (lane == 0) {
      mrow[2 * r] = mx;
      mrow[2 * r + 1] = 1.f / fmaxf(den, 1e-30f);
    }
  }
  __syncthreads();
  for (int x = tid; x < rc * Dv4; x += nt) {
    const int r = x / Dv4, j = (x % Dv4) * 4;
    const float mx = mrow[2 * r];
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s2 = s_lo; s2 < s_hi; ++s2) {
      const float al = expf(__ldcg(p.m_part + (base + s2) * G + c0 + r) - mx);
      const float4 y = __ldcg(reinterpret_cast<const float4*>(
          p.o_part + ((base + s2) * G + c0 + r) * (long long)Dv + j));
      o.x = fmaf(al, y.x, o.x); o.y = fmaf(al, y.y, o.y);
      o.z = fmaf(al, y.z, o.z); o.w = fmaf(al, y.w, o.w);
    }
    store4(out + ib * p.so_b + (long long)(ih * G + c0 + r) * p.so_h + j, o, mrow[2 * r + 1]);
  }
}

template <typename T, int RMAX, int PMAX>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  auto* kernel = decode_kernel<T, RMAX, PMAX>;
  // opt in to the most shared memory once per instantiation and device,
  // preferring shared memory to L1 (the chunks arrive by copies into it)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemOptIn);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  const Layout L = layout(p.rows_tile, p.D, p.Dv, p.chunk, sizeof(T), p.key_warps,
                          p.row_warps, p.shared_kv);
  kernel<<<dim3(p.nspan, p.Hkv * p.groups, B), 32 * p.key_warps * p.row_warps, L.total,
           stream>>>(p);
  return cudaGetLastError();
}

// accumulators: rows x passes of 128 value columns (the wrapper's row tile)
template <typename T>
cudaError_t launch_acc(const Params& p, int B, cudaStream_t stream) {
  const int passes = (p.Dv + 127) / 128;
  if (p.rows_tile <= 2 && passes <= 1) return launch<T, 2, 1>(p, B, stream);
  if (p.rows_tile <= 8 && passes <= 1) return launch<T, 8, 1>(p, B, stream);
  if (p.rows_tile <= 12 && passes <= 1) return launch<T, 12, 1>(p, B, stream);
  if (p.rows_tile <= 16 && passes <= 1) return launch<T, 16, 1>(p, B, stream);
  if (p.rows_tile <= 4 && passes <= 4) return launch<T, 4, 4>(p, B, stream);
  if (p.rows_tile <= 2 && passes <= 8) return launch<T, 2, 8>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory one CTA needs; the wrapper computes the same in Python
// (`decode_smem_bytes`) when it plans a shape.
size_t decode_attention_smem_bytes(int rows_tile, int D, int Dv, int chunk, int esize,
                                   int key_warps, int row_warps, int shared_kv) {
  return (size_t)layout(rows_tile, D, Dv, chunk, esize, key_warps, row_warps, shared_kv).total;
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).  q is
// (B, 1, H, D), k/v (B, T, Hkv, D[v]), out (B, 1, H, Dv); strides are in
// elements, the last dimension is contiguous, K/V rows of D / Dv elements
// are 16-byte multiples at 16-byte aligned addresses.  span, chunk,
// rows_tile, row_warps and key_warps come from the wrapper's plan; shared_kv
// says that v is the leading Dv columns of k's rows (same pointer and
// strides).  `part` holds B * Hkv * nspan * G * (Dv + 2) floats; `arrive`
// holds B * Hkv * groups zeros, and holds zeros again when the launch ends.
// kv_len is clamped to T; kc is the execution map's partition.  Returns the
// cudaError_t of the launch.
int decode_attention_fwd(const void* q, const void* k, const void* v, void* out, float* part,
                         int* counts, int* arrive, int dtype, int B, int H, int T, int Hkv,
                         int D, int Dv, int span, int chunk, int rows_tile, int row_warps,
                         int key_warps, int shared_kv, long long sq_b, long long sq_h,
                         long long sk_b, long long sk_t, long long sk_h, long long sv_b,
                         long long sv_t, long long sv_h, long long so_b, long long so_h,
                         int kv_len, int window, int kc, float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.counts = counts; p.arrive = arrive;
  p.Hkv = Hkv; p.G = H / Hkv; p.D = D; p.Dv = Dv;
  p.span = span; p.nspan = (T + span - 1) / span; p.chunk = chunk;
  p.rows_tile = rows_tile; p.row_warps = row_warps; p.key_warps = key_warps;
  p.groups = (p.G + row_warps * rows_tile - 1) / (row_warps * rows_tile);
  p.shared_kv = shared_kv;
  const long long slots = (long long)B * Hkv * p.nspan * p.G;
  p.o_part = part;
  p.m_part = part + slots * Dv;
  p.l_part = p.m_part + slots;
  p.sq_b = sq_b; p.sq_h = sq_h;
  p.sk_b = sk_b; p.sk_t = sk_t; p.sk_h = sk_h;
  p.sv_b = sv_b; p.sv_t = sv_t; p.sv_h = sv_h;
  p.so_b = so_b; p.so_h = so_h;
  p.kv_len = kv_len; p.window = window; p.kc = kc; p.P = (T + kc - 1) / kc;
  p.scale = scale;
  if (rows_tile < 1 || rows_tile > kMaxRowTile || key_warps < 1 || row_warps < 1 ||
      key_warps * row_warps > kMaxWarps || chunk < 1 || chunk > kMaxChunk || span < chunk ||
      D % 4 || Dv % 4 || (shared_kv && Dv > D) || arrive == nullptr || kv_len < 0 || kv_len > T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_acc<float>(p, B, st);
  if (dtype == 1) return (int)launch_acc<__nv_bfloat16>(p, B, st);
  return (int)cudaErrorInvalidValue;
}

// The id of the graph capture in progress on `stream` (unique to that
// capture), 0 when the stream is not capturing.
unsigned long long decode_attention_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}

const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
