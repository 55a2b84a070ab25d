// Flash attention forward for Hopper (sm_90a) on the tensor cores: f32
// inputs at f32 accuracy through the 3xTF32 split, bf16 inputs in one bf16
// pass, f32 accumulation and online softmax in both.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `_flash_call` of
// src/repro/kernels/flash_attention.py (`flash_attention`): causal,
// sliding-window or bidirectional online-softmax attention with a dynamic
// `q_offset` (chunked-prefill resume) and `kv_len` (live prefix of a padded
// cache), GQA group folded into the query panel, dead KV tiles skipped, and
// an optional (B, Hkv, nq, nk) execution map.
//
// Design.  The G = H / Hkv heads of a kv-head share every K/V tile: the
// query panel of a q-tile holds G * qc rows, g-major (row r = g * qc + i),
// as the TPU kernel's (G*qc, D) panel.  One CTA of 8 warps takes up to 128
// rows of one panel (a wider panel is cut into 128-row chunks, one CTA
// each, which load the same tiles); each warp owns a 16-row slab, the
// MMA's M.  The CTA computes its live tile range [first, last] from
// q_offset, kv_len and window exactly as `_tile_bounds` does and walks it;
// that loop replaces the sequential Pallas grid axis, so a dead tile is
// neither loaded nor computed.  A 1D grid orders the q-tiles last first:
// under a causal mask the last q-tiles see the most keys, so the heaviest
// CTAs start in the first wave.
//
// Loads.  Q is read once, multiplied by the scale in f32 (the plain
// version's order) and kept in shared memory.  K and V tiles go through a
// two-stage ring of `cp.async` copies (16 bytes each: 4 f32 or 8 bf16; 8
// bytes for bf16 rows that are not 16-byte aligned), so tile j+1 loads
// while tile j is computed; keys past kc or kv_len, the columns up to a
// multiple of 32 of D and all 128 columns of V past Dv are zero-filled by
// the copy itself (src-size 0), so the products run unguarded.  Fragments
// come from shared memory through `ldmatrix` (an f32 row of 4 reads as one
// 16-byte matrix row; V of bf16 through `.trans`); rows padded by 16 bytes
// make every ldmatrix phase hit 32 distinct banks.
//
// Products.  A tile of kc keys is computed in sub-steps of 64 keys (8
// n-tiles of the MMA).  f32: S = Q K^T and O += P V are each three
// `mma.sync.m16n8k8.tf32` passes, small*big, big*small, then big*big, with
// x = big + small, big = tf32(x), small = tf32(x - big), split on the fly;
// the dropped small*small term is ~2^-22 relative, so the result keeps f32
// accuracy (a single TF32 pass keeps ~3 digits).  The small terms go first,
// so that the big one does not swamp them.  bf16: one `mma.sync.m16n8k16`
// pass on the raw inputs, S scaled in f32 after, P rounded to bf16 as the A
// operand, as the TPU kernel does.  P never leaves registers: the f32 C
// fragment of S (columns 2t, 2t+1) serves as the tf32 A fragment (columns
// t, t+4) of P V once each 8-key group of V's rows is read in the same
// permuted order (key 2t as k = t, key 2t+1 as k = t+4); for bf16 the two
// fragments line up as they are.  The tensor cores truncate as they
// accumulate, so for f32 neither S nor O is one long chain of MMAs: each
// 32-deep slice of S and each sub-step's P V lands in fresh accumulators
// that the f32 units add up (over 2048 keys a single chain drifted 1.1e-5
// from exact f64 attention).  The online softmax (running max, sum,
// rescale) stays in f32 registers, with quad shuffles for the row max;
// masked logits take the finite MASK_VALUE, columns past the tile are
// excluded, and a sub-step that every row sees whole is not masked at all.
// A q-tile without a live KV tile writes zeros.  The kernel allocates
// nothing and runs on the caller's stream.
//
// What bounds it.  At the serving shapes (S = 512 rows against up to 2048
// live keys, D = 128) prefill attention does ~D/2 operations per byte it
// must move, so it is bound by operations: for f32 the three TF32 passes at
// 495 TFLOP/s, for bf16 one pass at 989.  mma.sync runs below the wgmma
// rate, the on-the-fly split costs three ALU operations per operand
// element, and with one 198 KiB CTA (8 warps) per SM the MMAs' own
// latencies show, so the kernel sits above that bound.  wgmma would need V
// transposed in shared memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPanel = 128;  // panel rows one CTA takes: 8 warps x 16
constexpr int kSub = 64;     // keys of one compute sub-step: 8 n-tiles of 8
constexpr int kMaxDv = 128;  // value columns a warp keeps in registers
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * log2(e))

// shared row padding, in elements: 4 words past a multiple of 32 elements
template <typename T> constexpr int kPad = 16 / (int)sizeof(T);

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared-memory geometry of one CTA, in elements of T.  Row strides are
// the padded widths.
template <typename T>
struct Smem {
  int RP, KCP, DP, DVP, QS, KS, VS;
  int q, k, v, stage, total;  // offsets of Q, K and V of stage 0; stage size
  __host__ __device__ Smem(int R, int kc, int D, int Dv) {
    RP = round_up(R < kPanel ? R : kPanel, 16);
    KCP = round_up(kc, kSub);
    DP = round_up(D, 32);  // whole 32-deep slices: the k-step loops run unguarded
    DVP = kMaxDv;  // all 16 n-tiles of P V run unguarded; columns past Dv are zeros
    QS = DP + kPad<T>;
    KS = DP + kPad<T>;
    VS = DVP + kPad<T>;
    q = 0;
    k = q + RP * QS;
    v = k + KCP * KS;
    stage = KCP * (KS + VS);
    total = k + 2 * stage;
  }
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int* counts;  // (B, Hkv, nq, nk) or null
  int B, S, T, Hkv, G, D, Dv;
  long long sq_b, sq_s, sq_h;
  long long sk_b, sk_t, sk_h;
  long long sv_b, sv_t, sv_h;
  long long so_b, so_s, so_h;
  int q_offset, kv_len, window, bidirectional;
  float scale;
  int qc, kc, nq, nk, npc;  // npc: 128-row chunks per panel
  int wide;                 // bf16 rows copied 8 elements (16 bytes) at a time
};

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

// ---- copies ------------------------------------------------------------

// One 4-element group global -> shared; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async8(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---- tensor-core products -------------------------------------------------

// Four 8 x 8 matrices of 16-bit pairs from shared memory (an f32 row of 4
// floats reads as one 16-byte matrix row); lane l names row l % 8 of
// matrix l / 8.  `.trans` hands each thread a column pair instead.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// x = big + small, both tf32
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

// The MMAs are plain asm (not volatile): they have no side effect, so the
// compiler may interleave independent ones and hide their latency.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// S (16 rows x 64 keys of the sub-step) = Q K^T.  All 8 n-tiles run
// unguarded (a sub-step's keys past kc are zero rows, masked after), so the
// loads of a k-step go out together ahead of its MMAs.  Q is pre-scaled for
// f32.  f32: per 8-deep k-step, all n-tiles' small*big products, then all
// big*small, then all big*big; each 32-deep slice of D is summed in a fresh
// accumulator (a chain of 12 MMAs) that the f32 units add to S, for the
// reason given at `pv`.
__device__ __forceinline__ void qk(float (&s)[8][4], const float* Qs, const float* Ks,
                                   const Smem<float> L, int slab, int lane) {
  const float* qrow = Qs + (slab + (lane & 7) + ((lane >> 3) & 1) * 8) * L.QS + (lane >> 4) * 4;
  const float* krow = Ks + ((lane >> 4) * 8 + (lane & 7)) * L.KS + ((lane >> 3) & 1) * 4;
  for (int kb = 0; kb < L.DP; kb += 32) {
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = kb + u * 8;
      // A: rows g / g+8, columns t / t+4; B: key g, columns t / t+4
      uint32_t qa[4], kb4[4][4], ab[4], as[4], bb[8][2], bs[8][2];
      ldsm_x4(qa, qrow + kk);
#pragma unroll
      for (int j = 0; j < 8; j += 2) ldsm_x4(kb4[j / 2], krow + j * 8 * L.KS + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(qa[i]), ab[i], as[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        split(__uint_as_float(kb4[j / 2][(j & 1) * 2]), bb[j][0], bs[j][0]);
        split(__uint_as_float(kb4[j / 2][(j & 1) * 2 + 1]), bb[j][1], bs[j][1]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_tf32(part[j], as, bb[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_tf32(part[j], ab, bs[j]);
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_tf32(part[j], ab, bb[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += part[j][e];
  }
}

__device__ __forceinline__ void qk(float (&s)[8][4], const __nv_bfloat16* Qs,
                                   const __nv_bfloat16* Ks, const Smem<__nv_bfloat16> L,
                                   int slab, int lane) {
  const __nv_bfloat16* qrow =
      Qs + (slab + (lane & 7) + ((lane >> 3) & 1) * 8) * L.QS + (lane >> 4) * 8;
  const __nv_bfloat16* krow = Ks + ((lane >> 4) * 8 + (lane & 7)) * L.KS + ((lane >> 3) & 1) * 8;
#pragma unroll 2
  for (int kk = 0; kk < L.DP; kk += 16) {  // DP is a multiple of 32
    uint32_t a[4], b[4][4];
    ldsm_x4(a, qrow + kk);
#pragma unroll
    for (int j = 0; j < 8; j += 2) ldsm_x4(b[j / 2], krow + j * 8 * L.KS + kk);
#pragma unroll
    for (int j = 0; j < 8; j += 2) {
      const uint32_t b0[2] = {b[j / 2][0], b[j / 2][1]}, b1[2] = {b[j / 2][2], b[j / 2][3]};
      mma_bf16(s[j], a, b0);
      mma_bf16(s[j + 1], a, b1);
    }
  }
}

// O += P V over the sub-step's keys (P in the C-fragment layout of S).
// f32: the tensor cores add into their f32 accumulator with truncation, so
// a long chain of MMAs drifts toward zero (over 2048 keys a single chain
// drifted 1.1e-5 from exact f64 attention); the sub-step's product lands in
// fresh accumulators (a chain of 24 MMAs) that the f32 units add to O.  The
// key groups are the outer loop and the 16 n-tiles the inner one, so each
// P fragment is split once and 16 independent MMAs follow each other.
// bf16 accumulates into O directly: the output keeps 8 bits.
__device__ __forceinline__ void pv(float (&o)[kMaxDv / 8][4], const float (&p)[8][4],
                                   const float* Vs, const Smem<float> L, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float acc[kMaxDv / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxDv / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    // key 2t of the group as k = t, key 2t+1 as k = t + 4
    uint32_t pb[4], ps[4];
    split(p[j][0], pb[0], ps[0]);
    split(p[j][2], pb[1], ps[1]);
    split(p[j][1], pb[2], ps[2]);
    split(p[j][3], pb[3], ps[3]);
    const float* v0 = Vs + (j * 8 + 2 * t) * L.VS + g;
#pragma unroll
    for (int n = 0; n < kMaxDv / 8; ++n) {
      uint32_t bb[2], bs[2];
      split(v0[n * 8], bb[0], bs[0]);
      split(v0[L.VS + n * 8], bb[1], bs[1]);
      mma_tf32(acc[n], ps, bb);
      mma_tf32(acc[n], pb, bs);
      mma_tf32(acc[n], pb, bb);
    }
  }
#pragma unroll
  for (int n = 0; n < kMaxDv / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] += acc[n][e];
}

__device__ __forceinline__ void pv(float (&o)[kMaxDv / 8][4], const float (&p)[8][4],
                                   const __nv_bfloat16* Vs, const Smem<__nv_bfloat16> L,
                                   int lane) {
  const __nv_bfloat16* vrow = Vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * L.VS + (lane >> 4) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t a[4] = {pack_bf16(p[2 * i][0], p[2 * i][1]),
                           pack_bf16(p[2 * i][2], p[2 * i][3]),
                           pack_bf16(p[2 * i + 1][0], p[2 * i + 1][1]),
                           pack_bf16(p[2 * i + 1][2], p[2 * i + 1][3])};
#pragma unroll
    for (int n = 0; n < kMaxDv / 8; n += 2) {
      // keys 2t, 2t+1 (and +8) of column g, for n-tiles n and n+1
      uint32_t b[4];
      ldsm_x4_trans(b, vrow + i * 16 * L.VS + n * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      mma_bf16(o[n], a, b0);
      mma_bf16(o[n + 1], a, b1);
    }
  }
}

// ---- element I/O ----------------------------------------------------------

template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

// Q's four elements at x, times the scale for f32 (the plain version's
// q.float() * scale); bf16 stays raw (scaled after the product).
__device__ __forceinline__ float4 q4(const float* x, float scale) {
  float4 v = *reinterpret_cast<const float4*>(x);
  v.x *= scale; v.y *= scale; v.z *= scale; v.w *= scale;
  return v;
}
__device__ __forceinline__ uint2 q4(const __nv_bfloat16* x, float) {
  return *reinterpret_cast<const uint2*>(x);
}

__device__ __forceinline__ void store2(float* x, float a, float b) {
  *reinterpret_cast<float2*>(x) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* x, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(x) = __floats2bfloat162_rn(a, b);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Output row of panel row r (head g = r / qc, query s_lo + r % qc).
template <typename T>
__device__ __forceinline__ T* out_row(const Params& p, T* o, int ib, int ih, int s_lo, int r) {
  return o + ib * p.so_b + (long long)(s_lo + r % p.qc) * p.so_s +
         (long long)(ih * p.G + r / p.qc) * p.so_h;
}

// Copy `rows` rows of `cols` elements (a multiple of W) from global rows at
// src + row * stride into shared rows at dst + row * ld, W elements (16 or
// 8 bytes) per cp.async; rows at or past `live` and columns at or past
// `valid` are zero-filled.  The thread's (row, column) walk advances by
// additions only: an integer division per copy costs more than the copy.
template <int W, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src, long long stride,
                                          int rows, int cols, int live, int valid, int tid) {
  const int groups = cols / W;
  int r = tid / groups, c = tid - r * groups;
  const int dr = kThreads / groups, dc = kThreads - dr * groups;
  while (r < rows) {
    const bool ok = r < live && c * W < valid;
    const T* from = ok ? src + r * stride + c * W : src;
    if constexpr (W == 4) cp_async4(dst + r * ld + c * W, from, ok);
    else cp_async8(dst + r * ld + c * W, from, ok);
    r += dr;
    c += dc;
    if (c >= groups) { c -= groups; ++r; }
  }
}

// Start the copies of KV tile ik into ring stage st: K and V rows of the
// tile's keys, zeros past kc or kv_hi and in the pad columns.
template <typename T>
__device__ __forceinline__ void start_tile(const Params& p, const Smem<T> L, T* sm, const T* k,
                                           const T* v, int ik, int st, int ib, int ih, int kv_hi,
                                           int tid) {
  const int k_lo = ik * p.kc;
  const int live = min(p.kc, kv_hi - k_lo);
  const T* ks = k + ib * p.sk_b + (long long)k_lo * p.sk_t + (long long)ih * p.sk_h;
  const T* vs = v + ib * p.sv_b + (long long)k_lo * p.sv_t + (long long)ih * p.sv_h;
  T* Ks = sm + L.k + st * L.stage;
  T* Vs = sm + L.v + st * L.stage;
  if constexpr (sizeof(T) == 2) {
    if (p.wide) {
      copy_rows<8>(Ks, L.KS, ks, p.sk_t, L.KCP, L.DP, live, p.D, tid);
      copy_rows<8>(Vs, L.VS, vs, p.sv_t, L.KCP, L.DVP, live, p.Dv, tid);
      return;
    }
  }
  copy_rows<4>(Ks, L.KS, ks, p.sk_t, L.KCP, L.DP, live, p.D, tid);
  copy_rows<4>(Vs, L.VS, vs, p.sv_t, L.KCP, L.DVP, live, p.Dv, tid);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) flash_mma_kernel(const Params p) {
  extern __shared__ float4 smem4[];
  T* sm = reinterpret_cast<T*>(smem4);
  const Smem<T> L(p.G * p.qc, p.kc, p.D, p.Dv);

  // last q-tiles first; then panel chunk, kv-head, batch
  const int per = p.npc * p.Hkv * p.B;
  const int iq = p.nq - 1 - (int)(blockIdx.x / per);
  int rem = blockIdx.x % per;
  const int pc = rem % p.npc;
  rem /= p.npc;
  const int ih = rem % p.Hkv, ib = rem / p.Hkv;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qc = p.qc, kc = p.kc, D = p.D, Dv = p.Dv;
  const int R = p.G * qc;
  const int r_lo = pc * kPanel;                 // first panel row of this CTA
  const int nrows = min(kPanel, R - r_lo);
  const int s_lo = iq * qc;                     // first query row of the tile
  const int q_lo = p.q_offset + s_lo;           // its absolute position

  int first, last;
  tile_bounds(p, q_lo, &first, &last);
  if (p.counts != nullptr && pc == 0) {
    int* row = p.counts + ((long long)(ib * p.Hkv + ih) * p.nq + iq) * p.nk;
    for (int ik = tid; ik < p.nk; ik += kThreads) row[ik] = (ik >= first && ik <= last);
  }

  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  T* o = static_cast<T*>(p.o);
  if (first > last) {  // no live KV tile: the rows are zeros
    for (int idx = tid; idx < nrows * Dv; idx += kThreads) {
      const int r = r_lo + idx / Dv;
      if (s_lo + r % qc < p.S) out_row(p, o, ib, ih, s_lo, r)[idx % Dv] = from_f32<T>(0.f);
    }
    return;
  }

  const int kv_hi = min(p.T, p.kv_len);  // keys past it are masked: not read
  start_tile(p, L, sm, k, v, first, 0, ib, ih, kv_hi, tid);
  cp_commit();

  // Q once: rows past the panel or past S, and pad columns, are zeros
  {
    T* Qs = sm + L.q;
    const int qg = L.DP / 4;
    for (int idx = tid; idx < L.RP * qg; idx += kThreads) {
      const int lr = idx / qg, d = (idx % qg) * 4, r = r_lo + lr;
      typename Vec4<T>::type x{};
      if (lr < nrows && d < D && s_lo + r % qc < p.S)
        x = q4(q + ib * p.sq_b + (long long)(s_lo + r % qc) * p.sq_s +
                   (long long)(ih * p.G + r / qc) * p.sq_h + d, p.scale);
      *reinterpret_cast<typename Vec4<T>::type*>(Qs + lr * L.QS + d) = x;
    }
  }

  const int slab = warp * 16;
  const bool active = slab < nrows;
  const float s_scale = sizeof(T) == 4 ? 1.f : p.scale;
  // panel rows and absolute query positions of this thread's two rows
  int prow[2], qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    prow[h] = r_lo + slab + g + 8 * h;
    qpos[h] = q_lo + prow[h] % qc;
  }
  float o_acc[kMaxDv / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxDv / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o_acc[n][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int ik = first; ik <= last; ++ik) {
    const int st = (ik - first) & 1;
    if (ik < last) start_tile(p, L, sm, k, v, ik + 1, st ^ 1, ib, ih, kv_hi, tid);
    cp_commit();
    cp_wait1();
    __syncthreads();
    if (active) {
      const T* Qs = sm + L.q;
      for (int sub = 0; sub * kSub < kc; ++sub) {
        const int ncols = min(kSub, kc - sub * kSub);
        const T* Ks = sm + L.k + st * L.stage + sub * kSub * L.KS;
        const T* Vs = sm + L.v + st * L.stage + sub * kSub * L.VS;
        float s[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
        qk(s, Qs, Ks, L, slab, lane);

        // mask, running max.  A sub-step whose 64 keys every row of the
        // panel sees (the causal interior, inside the window and kv_len) is
        // not masked: rows past the panel or past S hold zeros and are not
        // stored.
        const int key0 = ik * kc + sub * kSub;
        const bool interior =
            ncols == kSub && key0 + kSub <= p.kv_len &&
            (p.bidirectional || (key0 + kSub - 1 <= q_lo &&
                                 (p.window <= 0 || key0 > q_lo + qc - 1 - p.window)));
        float mx[2] = {-INFINITY, -INFINITY};
        if (interior) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              s[j][e] *= s_scale;
              mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
            }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int h = e >> 1, c = sub * kSub + j * 8 + 2 * t + (e & 1);
              const int key = key0 + j * 8 + 2 * t + (e & 1);
              float x;
              if (c >= kc) {
                x = -INFINITY;  // not in the tile
              } else {
                bool live = prow[h] < R && key < p.kv_len;
                if (!p.bidirectional) {
                  live = live && key <= qpos[h];
                  if (p.window > 0) live = live && key > qpos[h] - p.window;
                }
                x = live ? s[j][e] * s_scale : kMaskValue;
              }
              s[j][e] = x;
              mx[h] = fmaxf(mx[h], x);
            }
        }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
          mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
          const float m_next = fmaxf(m_run[h], mx[h]);
          alpha[h] = exp2f((m_run[h] - m_next) * kLog2e);
          m_run[h] = m_next;
          l_run[h] *= alpha[h];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            // 0 for columns past the tile
            const float pe = exp2f((s[j][e] - m_run[h]) * kLog2e);
            l_run[h] += pe;
            s[j][e] = pe;  // bf16: rounded to bf16 as pv packs it
          }
        if (!__all_sync(0xffffffffu, alpha[0] == 1.f && alpha[1] == 1.f)) {
#pragma unroll
          for (int n = 0; n < kMaxDv / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) o_acc[n][e] *= alpha[e >> 1];
        }
        pv(o_acc, s, Vs, L, lane);
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }

  if (!active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = prow[h];
    if (r >= R || s_lo + r % qc >= p.S) continue;
    const float inv = 1.f / fmaxf(l_run[h], 1e-30f);
    T* dst = out_row(p, o, ib, ih, s_lo, r);
#pragma unroll
    for (int n = 0; n < kMaxDv / 8; ++n) {
      const int j = n * 8 + 2 * t;
      if (j < Dv) store2(dst + j, o_acc[n][2 * h] * inv, o_acc[n][2 * h + 1] * inv);
    }
  }
}

template <typename T>
long long smem_bytes(int G, int qc, int kc, int D, int Dv) {
  return (long long)sizeof(T) * Smem<T>(G * qc, kc, D, Dv).total;
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t bytes = (size_t)smem_bytes<T>(p.G, p.qc, p.kc, p.D, p.Dv);
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)p.nq * p.npc * p.Hkv * p.B;
  flash_mma_kernel<T><<<(unsigned)blocks, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one CTA needs, in bytes (the wrapper checks it
// against the card's limit before launching).  dtype as below.
long long flash_attention_smem_bytes(int dtype, int G, int qc, int kc, int D, int Dv) {
  return dtype == 0 ? smem_bytes<float>(G, qc, kc, D, Dv)
                    : smem_bytes<__nv_bfloat16>(G, qc, kc, D, Dv);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o share it).  Strides are
// in elements; the last dimension of every tensor must be contiguous and
// every row 4-element aligned.  Returns the cudaError_t of the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int* counts,
                        int dtype, int B, int S, int H, int T, int Hkv, int D, int Dv,
                        long long sq_b, long long sq_s, long long sq_h, long long sk_b,
                        long long sk_t, long long sk_h, long long sv_b, long long sv_t,
                        long long sv_h, long long so_b, long long so_s, long long so_h,
                        int q_offset, int kv_len, int window, int bidirectional, float scale,
                        int qc, int kc, void* stream) {
  if (Dv > kMaxDv || D % 4 || Dv % 4 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o; p.counts = counts;
  p.B = B; p.S = S; p.T = T; p.Hkv = Hkv; p.G = H / Hkv; p.D = D; p.Dv = Dv;
  p.sq_b = sq_b; p.sq_s = sq_s; p.sq_h = sq_h;
  p.sk_b = sk_b; p.sk_t = sk_t; p.sk_h = sk_h;
  p.sv_b = sv_b; p.sv_t = sv_t; p.sv_h = sv_h;
  p.so_b = so_b; p.so_s = so_s; p.so_h = so_h;
  p.q_offset = q_offset; p.kv_len = kv_len; p.window = window;
  p.bidirectional = bidirectional; p.scale = scale;
  p.qc = qc; p.kc = kc;
  p.nq = (S + qc - 1) / qc;
  p.nk = (T + kc - 1) / kc;
  p.npc = (p.G * qc + kPanel - 1) / kPanel;
  auto a16 = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  p.wide = dtype == 1 && D % 8 == 0 && Dv % 8 == 0 && a16(k) && a16(v) &&
           (sk_b | sk_t | sk_h | sv_b | sv_t | sv_h) % 8 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, st);
  return (int)launch<__nv_bfloat16>(p, st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
