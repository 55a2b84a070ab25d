// Paged split-KV decode / verify attention for Hopper (sm_90a): queries in
// f32 or bf16, pages in f32, bf16 or int8 (with per-page, per-head scales),
// f32 accumulation.
//
// Replaces the Pallas TPU kernel `_paged_kernel` / `_split_kv_partition` of
// src/repro/kernels/decode_attention.py (`paged_decode_attention`), and fuses
// its cross-partition combine `_combine_partitions`, which runs outside the
// `pallas_call` in JAX, into the same launch.
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
// product.  For bf16 pages P is rounded to bf16 against the PAGE's max
// before the PV product, as the Pallas kernel's per-page partition does.
//
// What bounds it.  A decode step reads every live K/V byte once and does
// about one operation per byte (five at S = 5 verify), far below the card's
// ridge: it is bound by the live K/V bytes over the memory rate (3.35 TB/s).
// The design keeps those bytes in flight and the per-page work off the
// block's critical path:
//
// * One wave of CTAs.  A CTA serves a SPAN of `span_pages` consecutive
//   block-table entries of one (sequence, kv-head, row tile).  The wrapper
//   picks the span from host-known shapes only (B x Hkv x max_pp, the SM
//   count and the CTAs an SM holds by shared memory): 256 keys, halved
//   while the grid still fits in one wave; the lengths stay on the device.
// * Pages owned by warps.  Each of the CTA's `warps` (4, fewer where the
//   pages do not fit) computes every `warps`-th live page of the span on its
//   own, with no block barrier in its loop: a page slot of K rows then V
//   rows, filled by 1-D bulk copies (`cp.async.bulk`, one a page when the
//   rows are contiguous, else one a row) completing on the warp's two
//   mbarriers.  The next page's K is requested as soon as this page's QK is
//   done, its V as soon as the P V is done.  One lane issues a page; on the
//   card 16-byte `cp.async` by all 32 lanes timed within 3 % of it.
// * Per-page partials, as the reference's.  A warp scores its page for all
//   rows of the tile (T lanes a key across the head dimension, K loaded
//   once for every row), then per row: the page max, P = exp(s - m_page)
//   rounded for bf16 and scaled by the int8 v scale, l_page, folded into
//   the row's running (m, l) by the max / logsumexp rule; the lanes across
//   value columns add P V into float4 accumulators in registers.
// * Rows in tiles of at most 16 (4 at Dv 512) over a grid axis: shared
//   memory and registers do not grow with S x G, so MLA's absorbed decode at
//   full width (128 rows, D 576, Dv 512) runs, each tile streaming the
//   pages through L2.
// * SIMT f32 arithmetic: at <= 16 rows a page, the tensor cores would gain
//   nothing, and f32 pages keep f32 accuracy.
//
// The combine is folded in: the warps merge their (o, m, l) through shared
// memory, the CTA writes its span's partial, and the last CTA of a
// (sequence, kv-head, row tile) to arrive (an atomic counter it resets to 0,
// so a captured graph replays) merges the spans with the max / logsumexp
// rule, skipping dead ones, and writes (B, S, H, dv) in q's dtype: one
// launch, and no second kernel waiting on the slowest span.  Nothing is
// allocated here: the partial buffers and counters come from the
// wrapper.  The launch runs on the caller's stream; two launches that may
// run at once must not share counters (the wrapper keeps them per stream,
// and gives a launch captured into a graph counters of its own).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                // pages computed at once in a CTA, at most
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxRowTile = 16;
constexpr int kMaxDevices = 64;
constexpr int kSmemOptIn = 227 * 1024;  // what a CTA may opt in to on Hopper
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
  float* o_part;  // (B, Hkv, nspan, R, Dv)
  float* m_part;  // (B, Hkv, nspan, R)
  float* l_part;  // (B, Hkv, nspan, R)
  int* counts;    // (B, Hkv, max_pp) or null
  int* arrive;    // (B, Hkv, tiles) spans arrived, 0 between calls
  int Hkv, G, S, R, D, Dv, pg, num_pages, max_pp;
  int span_pages, nspan, rows_tile, tiles, warps;
  long long sq_b, sq_s, sq_h;
  long long sk_h, sk_p, sk_t;
  long long sv_h, sv_p, sv_t;
  long long sbt;
  long long so_b, so_s, so_h;
  int window;
  float scale;
};

__host__ __device__ inline int round16(int x) { return (x + 15) / 16 * 16; }

// Byte offsets of the dynamic shared memory of one CTA.
struct Layout {
  int krow, vrow, stage;  // row strides of a slot's K and V, bytes of a slot
  int ring, q, p, state, pages, ksc, vsc, flag, total;
};

__host__ __device__ inline Layout layout(int rows_tile, int D, int Dv, int pg, int span_pages,
                                         int esize, int warps) {
  Layout L;
  L.krow = round16(D * esize);
  L.vrow = round16(Dv * esize);
  L.stage = pg * (L.krow + L.vrow);
  // the slots, and after the pages the warps' (o, m, l) for their merge
  const int slots = warps * L.stage;
  const int merge = warps * rows_tile * (Dv + 2) * 4;
  L.ring = 128;  // after the slots' mbarriers (K and V, a warp)
  L.q = L.ring + round16(slots > merge ? slots : merge);
  L.p = L.q + round16(rows_tile * D * 4);
  L.state = L.p + round16(warps * rows_tile * pg * 4);  // per warp: m, l, alpha a row
  L.pages = L.state + round16(warps * rows_tile * 3 * 4);
  L.ksc = L.pages + round16(span_pages * 4);
  L.vsc = L.ksc + round16(span_pages * 4);
  L.flag = L.vsc + round16(span_pages * 4);
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
__device__ __forceinline__ float4 load4(const int8_t* x) {
  const char4 c = *reinterpret_cast<const char4*>(x);
  return make_float4((float)c.x, (float)c.y, (float)c.z, (float)c.w);
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
__device__ __forceinline__ void unpack16(const int8_t* k, float* f) {
  const int4 raw = *reinterpret_cast<const int4*>(k);
  const int w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) f[i] = (float)(int8_t)(w[i / 4] >> (8 * (i % 4)));
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
// `p.astype(v.dtype)`); int8 pages keep P in f32
__device__ __forceinline__ float round_p(float p, float) { return p; }
__device__ __forceinline__ float round_p(float p, int8_t) { return p; }
__device__ __forceinline__ float round_p(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(p));
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

// The reference's liveness predicate for block-table entry `ip`.
__device__ __forceinline__ bool page_live(int ip, int kvlen, const Params& p) {
  bool live = ip * p.pg < kvlen;
  if (p.window > 0) live = live && (ip * p.pg + p.pg - 1) > (kvlen - p.S - p.window);
  return live;
}

// One CTA: one span of pages of one (sequence, kv-head, row tile).  Warp w
// computes live pages w, w + kWarps, ... through its own slots; the warps
// merge their (o, m, l) once, the CTA writes the span's partial, and the
// last CTA of the (sequence, kv-head, row tile) to arrive merges the spans
// and writes the output.  RMAX x PMAX float4 accumulators a lane: rows by
// passes of 128 value columns.
template <typename TQ, typename TKV, int RMAX, int PMAX>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int kEpc = 16 / sizeof(TKV);  // elements of a 16-byte chunk
  const int is = blockIdx.x, ih = blockIdx.y / p.tiles, it = blockIdx.y % p.tiles;
  const int ib = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = p.D, Dv = p.Dv, pg = p.pg, G = p.G, rows_tile = p.rows_tile;
  const int nw = p.warps, nt = 32 * nw;
  const Layout L = layout(rows_tile, D, Dv, pg, p.span_pages, sizeof(TKV), nw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);      // (warps, K and V)
  unsigned char* ring = smem + L.ring;                     // a page slot a warp
  float* qs = reinterpret_cast<float*>(smem + L.q);        // (rows_tile, D)
  float* wps = reinterpret_cast<float*>(smem + L.p) + warp * rows_tile * pg;
  float* wm = reinterpret_cast<float*>(smem + L.state) + warp * rows_tile * 3;
  float* wl = wm + rows_tile;
  float* walpha = wl + rows_tile;
  int* pages = reinterpret_cast<int*>(smem + L.pages);     // the span's page ids
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.vsc);
  int* last = reinterpret_cast<int*>(smem + L.flag);

  const int r0 = it * rows_tile;
  const int rt = min(rows_tile, p.R - r0);  // rows of this tile
  const long long bh = (long long)ib * p.Hkv + ih;
  const int p0 = is * p.span_pages;
  const int np_span = min(p.span_pages, p.max_pp - p0);
  // the prologue's loads do not depend on one another: the length, the
  // span's page ids and scales and the query tile are in flight at once
  const int kvlen = p.kv_lens[ib];
  for (int j = tid; j < np_span; j += nt) {
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
  for (int e = tid; e < rt * D4; e += nt) {
    const int r = e / D4, d = (e % D4) * 4;
    const int rg = r0 + r, s_idx = rg / G, g = rg % G;
    *reinterpret_cast<float4*>(qs + r * D + d) =
        load4(q + ib * p.sq_b + s_idx * p.sq_s + (long long)(ih * G + g) * p.sq_h + d);
  }
  if (p.counts != nullptr && it == 0) {
    for (int j = tid; j < np_span; j += nt)
      p.counts[bh * p.max_pp + p0 + j] = page_live(p0 + j, kvlen, p);
  }
  // live entries of this span: a contiguous run [j_lo, j_lo + n_live)
  int j_lo = 0, n_live = 0;
  for (int j = np_span - 1; j >= 0; --j) {
    if (page_live(p0 + j, kvlen, p)) {
      j_lo = j;
      ++n_live;
    }
  }
  if (lane < rows_tile) {
    wm[lane] = -INFINITY;
    wl[lane] = 0.f;
  }
  if (lane < 2) mbar_init(&bars[2 * warp + lane]);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  const int Dv4 = Dv / 4;
  float4 acc[RMAX][PMAX];
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
#pragma unroll
    for (int ps = 0; ps < PMAX; ++ps) acc[r][ps] = make_float4(0.f, 0.f, 0.f, 0.f);

  // this warp's live pages: w, w + warps, ... of the run
  const int my_n = n_live > warp ? (n_live - warp + nw - 1) / nw : 0;
  if (my_n > 0) {
    const TKV* kbase = static_cast<const TKV*>(p.k) + (long long)ih * p.sk_h;
    const TKV* vbase = static_cast<const TKV*>(p.v) + (long long)ih * p.sv_h;
    const int kbytes = D * (int)sizeof(TKV), vbytes = Dv * (int)sizeof(TKV);
    // a page's K (V) rows are one run when they are D (Dv) apart
    const bool k_run = p.sk_t == D, v_run = p.sv_t == Dv;
    unsigned char* kslot = ring + warp * L.stage;  // the warp's page: K rows, then V rows
    unsigned char* vslot = kslot + pg * L.krow;
    uint64_t* kbar = bars + 2 * warp;
    uint64_t* vbar = kbar + 1;
    // rows of the warp's page k (of K or of V) into its slot: one bulk copy
    // when the rows are one run, else one a row
    auto issue = [&](int k, bool is_k) {
      const int page = pages[j_lo + warp + k * nw];
      const TKV* src = (is_k ? kbase : vbase) + (long long)page * (is_k ? p.sk_p : p.sv_p);
      unsigned char* dst = is_k ? kslot : vslot;
      const int bytes = is_k ? kbytes : vbytes, row = is_k ? L.krow : L.vrow;
      const long long st = is_k ? p.sk_t : p.sv_t;
      uint64_t* bar = is_k ? kbar : vbar;
      const bool run = st * (long long)sizeof(TKV) == bytes;
      if (lane == 0) {
        mbar_expect_tx(bar, (uint32_t)(pg * bytes));
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (run) bulk_copy(dst, src, pg * bytes, bar);
      }
      if (!run) {
        __syncwarp();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        for (int i = lane; i < pg; i += 32) bulk_copy(dst + i * row, src + i * st, bytes, bar);
      }
    };
    issue(0, true);
    issue(0, false);

    // QK lanes: T lanes a key (part t of them takes the 16-byte chunks t,
    // t + T, ... of the key's row), every row of the tile at once
    int T = 1;
    while (T * 2 * pg <= 32) T *= 2;
    const int part = lane & (T - 1);
    const int kc16 = kbytes / 16;
    // softmax lanes: LR lanes a row, rows padded to a power of two
    int rp = 1;
    while (rp < rt) rp *= 2;
    const int LR = 32 / rp, srow = lane / LR, sq = lane & (LR - 1);

    // page k's K arrives, its QK, page k + 1's K requested; the softmax;
    // page k's V arrives, its P V, page k + 1's V requested.  Each barrier
    // completes once a page, so page k waits on parity k & 1.
    for (int k = 0; k < my_n; ++k) {
      const unsigned char* kpage = kslot;
      const unsigned char* vpage = vslot;
      mbar_wait(kbar, (uint32_t)(k & 1));
      __syncwarp();
      const int jj = j_lo + warp + k * nw;  // the page's entry in the span
      const int key0 = (p0 + jj) * pg;          // absolute position of its key 0

      for (int c0 = 0; c0 < pg; c0 += 32 / T) {
        const int c = c0 + lane / T;
        float s[RMAX];
#pragma unroll
        for (int r = 0; r < RMAX; ++r) s[r] = 0.f;
        if (c < pg) {
          const TKV* krow = reinterpret_cast<const TKV*>(kpage + c * L.krow);
          for (int ch = part; ch < kc16; ch += T) {
            float f[kEpc];
            unpack16(krow + ch * kEpc, f);
#pragma unroll
            for (int r = 0; r < RMAX; ++r)
              if (r < rt) s[r] = dot_q<kEpc>(f, qs + r * D + ch * kEpc, s[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < RMAX; ++r) {
          if (r >= rt) continue;  // uniform
          const float x = group_sum(s[r], T);
          if (part == 0 && c < pg) wps[r * pg + c] = x;
        }
      }
      __syncwarp();  // the K rows free
      if (k + 1 < my_n) issue(k + 1, true);

      // softmax of each row over the page: scale (and int8 k scale), the
      // causal / window mask at the row's position, the page max, P =
      // exp(s - m_page) rounded for bf16 and scaled by the int8 v scale,
      // folded into the row's running (m, l); P is stored times
      // exp(m_page - m_new), walpha gets exp(m_old - m_new)
      {
        const bool on = srow < rt;
        const int row_pos = kvlen - p.S + (r0 + srow) / G;
        float* prow = wps + srow * pg;
        const float kscale = p.k_scales != nullptr ? ksc[jj] : 1.f;
        const float vscale = p.v_scales != nullptr ? vsc[jj] : 1.f;
        float mx = -INFINITY;
        if (on) {
          for (int c = sq; c < pg; c += LR) {
            float x = prow[c] * p.scale;
            if (p.k_scales != nullptr) x *= kscale;
            const int pos = key0 + c;
            bool vis = pos <= row_pos;
            if (p.window > 0) vis = vis && pos > row_pos - p.window;
            x = vis ? x : kMaskValue;
            prow[c] = x;
            mx = fmaxf(mx, x);
          }
        }
        mx = group_max(mx, LR);
        const float m_old = on ? wm[srow] : 0.f;
        const float m_new = fmaxf(m_old, mx);
        const float a_pg = expf(mx - m_new);
        float sum = 0.f;
        if (on) {
          for (int c = sq; c < pg; c += LR) {
            const float e = expf(prow[c] - mx);
            sum += e;
            prow[c] = round_p(e, TKV()) * vscale * a_pg;
          }
        }
        sum = group_sum(sum, LR);
        __syncwarp();
        if (on && sq == 0) {
          const float a_old = expf(m_old - m_new);  // 0 on the warp's first page
          wm[srow] = m_new;
          wl[srow] = wl[srow] * a_old + sum * a_pg;
          walpha[srow] = a_old;
        }
      }
      __syncwarp();

      mbar_wait(vbar, (uint32_t)(k & 1));
      __syncwarp();
      // P V: lanes across value columns, 4 a lane a pass of 128
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r >= rt) continue;
        const float a = walpha[r];
#pragma unroll
        for (int ps = 0; ps < PMAX; ++ps) {
          acc[r][ps].x *= a; acc[r][ps].y *= a; acc[r][ps].z *= a; acc[r][ps].w *= a;
        }
      }
      for (int c = 0; c < pg; ++c) {
        const TKV* vrow = reinterpret_cast<const TKV*>(vpage + c * L.vrow);
#pragma unroll
        for (int ps = 0; ps < PMAX; ++ps) {
          const int j4 = (ps * 32 + lane) * 4;
          if (j4 >= Dv) continue;
          const float4 vv = load4(vrow + j4);
#pragma unroll
          for (int r = 0; r < RMAX; ++r) {
            if (r >= rt) continue;
            const float pc = wps[r * pg + c];
            acc[r][ps].x = fmaf(pc, vv.x, acc[r][ps].x);
            acc[r][ps].y = fmaf(pc, vv.y, acc[r][ps].y);
            acc[r][ps].z = fmaf(pc, vv.z, acc[r][ps].z);
            acc[r][ps].w = fmaf(pc, vv.w, acc[r][ps].w);
          }
        }
      }
      __syncwarp();  // the V rows and P free
      if (k + 1 < my_n) issue(k + 1, false);
    }
  }

  // merge the warps: their (o, m, l) through shared memory (the slots are
  // free), then the span's partial o (unnormalised), m and l
  __syncthreads();
  float* mo = reinterpret_cast<float*>(ring);         // (warps, rows_tile, Dv)
  float* mml = mo + nw * rows_tile * Dv;              // (warps, rows_tile, 2)
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= rt) continue;
#pragma unroll
    for (int ps = 0; ps < PMAX; ++ps) {
      const int j4 = (ps * 32 + lane) * 4;
      if (j4 < Dv) *reinterpret_cast<float4*>(mo + (warp * rows_tile + r) * Dv + j4) = acc[r][ps];
    }
  }
  if (lane < rt) {
    mml[(warp * rows_tile + lane) * 2] = wm[lane];
    mml[(warp * rows_tile + lane) * 2 + 1] = wl[lane];
  }
  __syncthreads();
  const long long prow = (bh * p.nspan + is) * p.R + r0;  // (b, h, span, row r0)
  for (int e = tid; e < rt * Dv4; e += nt) {
    const int r = e / Dv4, j4 = (e % Dv4) * 4;
    float mx = -INFINITY;
    for (int w = 0; w < nw; ++w) mx = fmaxf(mx, mml[(w * rows_tile + r) * 2]);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
    if (mx != -INFINITY) {
      for (int w = 0; w < nw; ++w) {
        const float m = mml[(w * rows_tile + r) * 2];
        if (m == -INFINITY) continue;  // a warp with no live page
        const float a = expf(m - mx);
        const float4 x = *reinterpret_cast<const float4*>(mo + (w * rows_tile + r) * Dv + j4);
        o.x = fmaf(a, x.x, o.x); o.y = fmaf(a, x.y, o.y);
        o.z = fmaf(a, x.z, o.z); o.w = fmaf(a, x.w, o.w);
        l = fmaf(a, mml[(w * rows_tile + r) * 2 + 1], l);
      }
      *reinterpret_cast<float4*>(p.o_part + (prow + r) * Dv + j4) = o;
    }
    if (j4 == 0) {  // a dead span: m = -inf, l = 0, its o never written
      p.m_part[prow + r] = mx;
      p.l_part[prow + r] = l;
    }
  }

  // the last CTA of this (sequence, kv-head, row tile) to arrive merges the
  // spans by the max / logsumexp rule and resets the counter for the next
  // call (so a captured graph replays)
  __threadfence();
  __syncthreads();
  const long long bht = bh * p.tiles + it;
  if (tid == 0) *last = atomicAdd(&p.arrive[bht], 1) == p.nspan - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (tid == 0) p.arrive[bht] = 0;
  const long long base = bh * p.nspan;
  const int R = p.R;
  float* mrow = mo;  // per row: the max and 1 / the denominator over the spans
  for (int r = warp; r < rt; r += nw) {
    float mx = -INFINITY;
    for (int s2 = lane; s2 < p.nspan; s2 += 32)
      mx = fmaxf(mx, __ldcg(p.m_part + (base + s2) * R + r0 + r));
    mx = fmaxf(group_max(mx, 32), kMaskValue);
    float den = 0.f;
    for (int s2 = lane; s2 < p.nspan; s2 += 32) {
      const float m = __ldcg(p.m_part + (base + s2) * R + r0 + r);
      if (m != -INFINITY) den += expf(m - mx) * __ldcg(p.l_part + (base + s2) * R + r0 + r);
    }
    den = group_sum(den, 32);
    if (lane == 0) {
      mrow[2 * r] = mx;
      mrow[2 * r + 1] = 1.f / fmaxf(den, 1e-30f);
    }
  }
  __syncthreads();
  TQ* out = static_cast<TQ*>(p.out);
  for (int e = tid; e < rt * Dv4; e += nt) {
    const int r = e / Dv4, j = (e % Dv4) * 4;
    const float mx = mrow[2 * r];
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s2 = 0; s2 < p.nspan; ++s2) {
      const float m = __ldcg(p.m_part + (base + s2) * R + r0 + r);
      if (m == -INFINITY) continue;  // a dead span
      const float a = expf(m - mx);
      const float4 x = __ldcg(reinterpret_cast<const float4*>(
          p.o_part + ((base + s2) * R + r0 + r) * (long long)Dv + j));
      o.x = fmaf(a, x.x, o.x); o.y = fmaf(a, x.y, o.y);
      o.z = fmaf(a, x.z, o.z); o.w = fmaf(a, x.w, o.w);
    }
    const float inv = mrow[2 * r + 1];
    const int rg = r0 + r, s_idx = rg / G, g = rg % G;
    TQ* dst = out + ib * p.so_b + s_idx * p.so_s + (long long)(ih * G + g) * p.so_h + j;
    dst[0] = from_f32<TQ>(o.x * inv);
    dst[1] = from_f32<TQ>(o.y * inv);
    dst[2] = from_f32<TQ>(o.z * inv);
    dst[3] = from_f32<TQ>(o.w * inv);
  }
}

template <typename TQ, typename TKV, int RMAX, int PMAX>
cudaError_t launch(const Params& p, int B, cudaStream_t stream) {
  auto* kernel = paged_decode_kernel<TQ, TKV, RMAX, PMAX>;
  // opt in to the most shared memory once per instantiation and device,
  // preferring shared memory to L1 (the pages arrive by copies into it)
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
  const Layout L =
      layout(p.rows_tile, p.D, p.Dv, p.pg, p.span_pages, sizeof(TKV), p.warps);
  kernel<<<dim3(p.nspan, p.Hkv * p.tiles, B), 32 * p.warps, L.total, stream>>>(p);
  return cudaGetLastError();
}

// accumulators: rows x passes of 128 value columns (the wrapper's row tile)
template <typename TQ, typename TKV>
cudaError_t launch_acc(const Params& p, int B, cudaStream_t stream) {
  const int passes = (p.Dv + 127) / 128;
  if (p.rows_tile <= 2 && passes <= 1) return launch<TQ, TKV, 2, 1>(p, B, stream);
  if (p.rows_tile <= 16 && passes <= 1) return launch<TQ, TKV, 16, 1>(p, B, stream);
  if (p.rows_tile <= 4 && passes <= 4) return launch<TQ, TKV, 4, 4>(p, B, stream);
  if (p.rows_tile <= 2 && passes <= 8) return launch<TQ, TKV, 2, 8>(p, B, stream);
  return cudaErrorInvalidValue;
}

template <typename TQ>
cudaError_t launch_kv(const Params& p, int kv_dtype, int B, cudaStream_t stream) {
  if (kv_dtype == 0) return launch_acc<TQ, float>(p, B, stream);
  if (kv_dtype == 1) return launch_acc<TQ, __nv_bfloat16>(p, B, stream);
  if (kv_dtype == 2) return launch_acc<TQ, int8_t>(p, B, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Shared memory one CTA needs; the wrapper computes the same in Python
// (`paged_smem_bytes`) when it plans a shape.
size_t paged_decode_attention_smem_bytes(int rows_tile, int D, int Dv, int pg, int span_pages,
                                         int kv_esize, int warps) {
  return (size_t)layout(rows_tile, D, Dv, pg, span_pages, kv_esize, warps).total;
}

// q_dtype: 0 = float32, 1 = bfloat16 (q and out); kv_dtype: 0 = float32,
// 1 = bfloat16, 2 = int8 (k and v pages; int8 passes k/v scales, float
// pages pass null).  q is (B, S, H, D), pages (Hkv, num_pages, pg, W),
// out (B, S, H, Dv); strides are in elements, the last dimension is
// contiguous, K/V rows of D / Dv elements are 16-byte multiples at 16-byte
// aligned addresses.  span_pages, rows_tile and warps (pages a CTA
// computes at once) come from the wrapper's plan;
// `arrive` holds B * Hkv * tiles zeros, and holds zeros again when the
// launch ends.  Returns the cudaError_t of the launch.
int paged_decode_attention_fwd(const void* q, const void* k, const void* v,
                               const int* block_tables, const int* kv_lens,
                               const float* k_scales, const float* v_scales, void* out,
                               float* o_part, float* m_part, float* l_part, int* counts,
                               int* arrive, int q_dtype, int kv_dtype, int B, int S, int H,
                               int Hkv, int D, int Dv, int pg, int num_pages, int max_pp,
                               int span_pages, int rows_tile, int warps,
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
  p.arrive = arrive;
  p.Hkv = Hkv; p.G = H / Hkv; p.S = S; p.R = S * (H / Hkv); p.D = D; p.Dv = Dv;
  p.pg = pg; p.num_pages = num_pages; p.max_pp = max_pp; p.span_pages = span_pages;
  p.nspan = (max_pp + span_pages - 1) / span_pages;
  p.rows_tile = rows_tile; p.tiles = (p.R + rows_tile - 1) / rows_tile; p.warps = warps;
  p.sq_b = sq_b; p.sq_s = sq_s; p.sq_h = sq_h;
  p.sk_h = sk_h; p.sk_p = sk_p; p.sk_t = sk_t;
  p.sv_h = sv_h; p.sv_p = sv_p; p.sv_t = sv_t;
  p.sbt = sbt;
  p.so_b = so_b; p.so_s = so_s; p.so_h = so_h;
  p.window = window; p.scale = scale;
  if (rows_tile < 1 || rows_tile > kMaxRowTile || warps < 1 || warps > kWarps || span_pages < 1 || Dv % 4 || D % 4 || arrive == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) return (int)launch_kv<float>(p, kv_dtype, B, st);
  if (q_dtype == 1) return (int)launch_kv<__nv_bfloat16>(p, kv_dtype, B, st);
  return (int)cudaErrorInvalidValue;
}

// The id of the graph capture in progress on `stream` (unique to that
// capture), 0 when the stream is not capturing.
unsigned long long paged_decode_attention_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}

const char* paged_decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
