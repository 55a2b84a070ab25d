// The VTA GEMM core for Hopper (sm_90a): int8 (M, K) x int8 (K, N) with exact
// int32 accumulation on the int8 tensor cores, and the VTA ALU stage as a
// fused epilogue chosen by a template parameter:
//
//   none     store the int32 accumulator;
//   requant  + int32 bias, arithmetic right shift, optional ReLU, clip to
//            [-128, 127], store int8 (VTA's fixed-point path);
//   dequant  x f32 per-column scale, + optional f32 bias, act none / relu /
//            silu / gelu (tanh form), store f32 (the serving path).
//
// Replaces the Pallas TPU kernels `_gemm_kernel`, `_gemm_epilogue_kernel` and
// `_gemm_dequant_kernel` of src/repro/kernels/vta_gemm.py (`vta_gemm`, its
// three `pl.pallas_call`s).
//
// Design.  A pipelined `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`
// kernel.  Two CTA tiles of one template: 128 x 128 with 8 warps of 64 x 32
// and a ring of 4 shared-memory stages when those tiles alone fill at least
// half the card (M 2048), else 64 x 64 with 8 warps of 32 x 16 and 8 stages
// (M 512, decode).  K is walked in 64-deep steps; `cp.async` keeps all but
// one stage of the ring in flight while the last to land is computed.  The
// weights come K-major, as the port packs them (`optim.quant`): W is a
// (K, N) view of an (N, K)-contiguous tensor, so both operands have 16-byte
// K-contiguous rows that go to shared memory as they are and reach the
// MMAs through `ldmatrix.x4` (A: one 16 x 32 slab per call; W: two
// 8-column n-tiles per call).  Shared rows are padded to 80 bytes, so the
// 8 row addresses of each ldmatrix phase hit 32 distinct banks.  An
// N-contiguous W (a plain tensor, ResNet-18's conv weights) is also taken:
// its tile is copied as it is, (64 k) x (BN n), and each 4-byte K-run of a
// fragment is gathered with four byte loads from shared memory (the slower
// path; `chip_smoke.py` times both).  Every ragged M, N, K edge is masked
// in the kernel: an operand whose rows are 16-byte aligned goes by
// `cp.async` with the tail zero-filled by its src-size operand, one whose
// rows are not (K = 147) is gathered bytewise; nothing is padded on the
// host.  Warps skip the m-tiles that lie wholly past M (decode rows).
// The int32 sums are exact: the largest |sum| of a K = 4608 product is
// 128 * 128 * 4608 < 2^31.
//
// Epilogue.  The accumulators pass through shared memory (rows padded to
// BN + 8 words: the fragments' 8-byte writes are conflict-free), so that
// each thread then stores 16 bytes of consecutive columns of one output
// row: four f32 or int32 values, or sixteen int8.  The dequant epilogue
// rounds as the plain version does: one int -> f32 conversion, `__fmul_rn`
// by the scale, `__fadd_rn` of the bias (never contracted into an FMA), and
// silu / gelu step by step in the plain version's order, so on the card the
// kernel is bitwise equal to it.
//
// When the output tiles alone cannot fill the card (decode: M = 4, N = 1024
// gives 16 tiles for 132 SMs), K is split over `splits` CTAs per tile that
// add their int32 partial sums into a zeroed workspace with atomics (integer
// addition is exact in any order, so the result is bitwise that of one CTA),
// and a second launch applies the epilogue.
//
// What bounds it on this card.  In decode (M = 4 or 8) every weight byte is
// read once for a handful of operations: the bound is the weight bytes over
// 3.35 TB/s.  At the prefill chunks (M = 512, 2048) the f32 output is the
// largest byte stream and the bound is bytes too (at M 2048 about 3x the
// int8 operations' time at 1,979 TOP/s).  Measured with clock64 per phase,
// a K step goes mostly to waiting on its copies: every 64x64 or 128x128
// tile re-reads its operands from L2, and that traffic, not the way it is
// started, sets the pace; copy warps that keep the ring full apart from
// the MMA warps (mbarriers), and TMA box loads, did not shorten it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;            // K step
constexpr int kLds = BK + 16;     // K-major shared row stride, bytes

enum { kEpiNone = 0, kEpiRequant = 1, kEpiDequant = 2 };
enum { kActNone = 0, kActRelu = 1, kActSilu = 2, kActGelu = 3 };

// CTA tile BM x BN, warps WM x WN, a ring of STAGES shared-memory stages
template <int BM_, int BN_, int WM_, int WN_, int STAGES>
struct Cfg {
  static constexpr int BM = BM_, BN = BN_, WM = WM_, WN = WN_, kStages = STAGES;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int TM = BM / WM, TN = BN / WN;  // warp tile
  static constexpr int MT = TM / 16, NT = TN / 8;   // MMA tiles per warp
  static constexpr int kLdn = BN + 16;              // N-contiguous W stride, bytes
  static constexpr int kLde = BN + 8;               // epilogue row stride, words
  static constexpr int a_bytes = BM * kLds;
  static constexpr int e_bytes = BM * kLde * 4;
};

// one ring stage (A then W), and the dynamic shared memory of a CTA
template <typename C, bool KM>
constexpr int kStageBytes = C::a_bytes + (KM ? C::BN * kLds : BK * C::kLdn);
template <typename C, bool KM>
constexpr int kSmemBytes = C::kStages * kStageBytes<C, KM> > C::e_bytes
                               ? C::kStages * kStageBytes<C, KM>
                               : C::e_bytes;
using Large = Cfg<128, 128, 2, 4, 4>;  // warp tile 64 x 32
using Small = Cfg<64, 64, 2, 4, 8>;    // warp tile 32 x 16

struct Params {
  const int8_t* a;
  const int8_t* w;
  const void* bias;    // int32 (requant) or f32 (dequant) (N,), or null
  const float* scale;  // f32 (N,) (dequant)
  void* out;           // (M, N) int32 / int8 / f32, row-major
  int* ws;             // (M, N) int32 split-K workspace, or null
  int M, N, K;
  long long lda;       // row stride of a, in elements
  long long ldw;       // K-major: stride between W's columns; else between its rows
  int shift, relu, act;
  int k_per_split;     // a multiple of BK
  int vec_a, vec_w;    // every row of a / w starts 16-byte aligned
};

// plain asm (not volatile): independent MMAs may be interleaved
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const int8_t* p) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void cp_async16(int8_t* dst, const int8_t* src, int bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory from `n` (0..16) bytes at src, zeros after:
// one cp.async when the operand's rows are 16-byte aligned (`vec`, the
// same for every chunk of a call), else gathered bytewise.
__device__ __forceinline__ void load16(int8_t* dst, const int8_t* src, int n, bool vec,
                                       const int8_t* base) {
  if (vec) {
    cp_async16(dst, n > 0 ? src : base, n > 0 ? n : 0);
  } else {
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    for (int j = 0; j < n; ++j) v[j >> 2] |= (uint32_t)(uint8_t)src[j] << (8 * (j & 3));
    *reinterpret_cast<int4*>(dst) = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
  }
}

__device__ __forceinline__ float apply_act(float y, int act) {
  switch (act) {
    case kActRelu:
      return fmaxf(y, 0.f);
    case kActSilu:  // PyTorch's silu: x / (1 + exp(-x))
      return y / (1.f + expf(-y));
    case kActGelu: {  // the tanh form, each step rounded as the plain version
      const float y3 = __fmul_rn(__fmul_rn(y, y), y);
      const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(y, __fmul_rn(0.044715f, y3)));
      return __fmul_rn(__fmul_rn(0.5f, y), __fadd_rn(1.f, tanhf(inner)));
    }
    default:
      return y;
  }
}

// The epilogue of one accumulator, as a 32-bit word: the int32 itself, the
// int8 code (requant) or the f32 bits (dequant).
template <int EPI>
__device__ __forceinline__ uint32_t epilogue(const Params& p, int col, int acc) {
  if constexpr (EPI == kEpiNone) {
    return (uint32_t)acc;
  } else if constexpr (EPI == kEpiRequant) {
    // int32 add wraps as the reference's does; >> of a signed int is
    // arithmetic (rounds toward -inf); the shift is clamped to [0, 31]
    int v = (int)((unsigned)acc + (unsigned)static_cast<const int*>(p.bias)[col]);
    v >>= p.shift;
    if (p.relu) v = max(v, 0);
    return (uint32_t)min(max(v, -128), 127);
  } else {
    float y = __fmul_rn(__int2float_rn(acc), p.scale[col]);
    if (p.bias != nullptr) y = __fadd_rn(y, static_cast<const float*>(p.bias)[col]);
    return __float_as_uint(apply_act(y, p.act));
  }
}

template <int EPI>
__device__ __forceinline__ void store_word(const Params& p, long long o, uint32_t v) {
  if constexpr (EPI == kEpiRequant)
    static_cast<int8_t*>(p.out)[o] = (int8_t)(int)v;
  else
    static_cast<uint32_t*>(p.out)[o] = v;
}

// Start the copies of K step kt (k0 .. k0 + 63) into the stage at As (A's
// `rows` rows) and Ws (W's tile, K-major rows of n or N-contiguous rows of k).
template <typename C, bool KM>
__device__ __forceinline__ void load_stage(const Params& p, int8_t* As, int8_t* Ws, int k0,
                                           int k_end, int m0, int n0, int rows, int tid) {
  for (int c = tid; c < rows * (BK / 16); c += C::kThreads) {
    const int r = c >> 2, kc = (c & 3) * 16, gr = m0 + r, gk = k0 + kc;
    const int n = gr < p.M ? min(16, k_end - gk) : 0;
    load16(As + r * kLds + kc, p.a + (long long)gr * p.lda + gk, n, p.vec_a, p.a);
  }
  if constexpr (KM) {
    for (int c = tid; c < C::BN * (BK / 16); c += C::kThreads) {
      const int r = c >> 2, kc = (c & 3) * 16, gn = n0 + r, gk = k0 + kc;
      const int n = gn < p.N ? min(16, k_end - gk) : 0;
      load16(Ws + r * kLds + kc, p.w + (long long)gn * p.ldw + gk, n, p.vec_w, p.w);
    }
  } else {
    constexpr int per_row = C::BN / 16;
    for (int c = tid; c < BK * per_row; c += C::kThreads) {
      const int r = c / per_row, nc = (c % per_row) * 16, gk = k0 + r, gn = n0 + nc;
      const int n = gk < k_end ? min(16, p.N - gn) : 0;
      load16(Ws + r * C::kLdn + nc, p.w + (long long)gk * p.ldw + gn, n, p.vec_w, p.w);
    }
  }
}

// One 64-deep K step of a warp's MT x NT MMA tiles from a ring stage: A
// slabs and W n-tile pairs through ldmatrix (K-major W) or byte gathers
// (N-contiguous W).  m-tiles from m_live on lie wholly past M and are
// skipped; called with the constant MT for full tiles, the branch folds.
template <typename C, bool KM>
__device__ __forceinline__ void mma_step(int (&acc)[C::MT][C::NT][4], const int8_t* As,
                                         const int8_t* Ws, int m_live, int wm, int wn,
                                         int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 32) {
    uint32_t af[C::MT][4], bf[C::NT][2];
#pragma unroll
    for (int i = 0; i < C::MT; ++i) {
      if (i < m_live) {
        const int row = wm * C::TM + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af[i], As + row * kLds + kk + (lane >> 4) * 16);
      }
    }
    if constexpr (KM) {
#pragma unroll
      for (int j = 0; j < C::NT; j += 2) {
        const int col = wn * C::TN + j * 8 + (lane >> 4) * 8 + (lane & 7);
        uint32_t r[4];
        ldmatrix_x4(r, Ws + col * kLds + kk + ((lane >> 3) & 1) * 16);
        bf[j][0] = r[0]; bf[j][1] = r[1]; bf[j + 1][0] = r[2]; bf[j + 1][1] = r[3];
      }
    } else {
#pragma unroll
      for (int j = 0; j < C::NT; ++j) {
        const int8_t* src = Ws + (kk + 4 * t) * C::kLdn + wn * C::TN + j * 8 + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int8_t* s2 = src + h * 16 * C::kLdn;
          bf[j][h] = (uint32_t)(uint8_t)s2[0] | ((uint32_t)(uint8_t)s2[C::kLdn] << 8) |
                     ((uint32_t)(uint8_t)s2[2 * C::kLdn] << 16) |
                     ((uint32_t)(uint8_t)s2[3 * C::kLdn] << 24);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
      if (i < m_live)
#pragma unroll
        for (int j = 0; j < C::NT; ++j) mma_s8(acc[i][j], af[i], bf[j]);
  }
}

template <int EPI, typename C, bool KM>
__global__ void __launch_bounds__(C::kThreads) vta_gemm_kernel(Params p) {
  extern __shared__ int4 smem4[];
  int8_t* sm = reinterpret_cast<int8_t*>(smem4);
  constexpr int BM = C::BM, BN = C::BN;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;
  // A rows read by some live m-tile; rows past M among them are zeros
  const int rows = min(BM, (p.M - m0 + 15) / 16 * 16);

  constexpr int stage_bytes = kStageBytes<C, KM>;
  int acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // m-tiles of this warp that hold a row < M (whole tiles past M are skipped)
  const int m_live = min(C::MT, max(0, (p.M - m0 - wm * C::TM + 15) / 16));

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < nk)
      load_stage<C, KM>(p, sm + s * stage_bytes, sm + s * stage_bytes + C::a_bytes,
                        k_begin + s * BK, k_end, m0, n0, rows, tid);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<C::kStages - 2>();
    __syncthreads();
    const int nxt = kt + C::kStages - 1;
    if (nxt < nk) {
      int8_t* st = sm + (nxt % C::kStages) * stage_bytes;
      load_stage<C, KM>(p, st, st + C::a_bytes, k_begin + nxt * BK, k_end, m0, n0, rows, tid);
    }
    cp_commit();
    const int8_t* As = sm + (kt % C::kStages) * stage_bytes;
    if (m_live == C::MT)
      mma_step<C, KM>(acc, As, As + C::a_bytes, C::MT, wm, wn, lane);
    else if (m_live > 0)
      mma_step<C, KM>(acc, As, As + C::a_bytes, m_live, wm, wn, lane);
  }

  if (gridDim.z > 1) {  // split-K: int32 partial sums into the workspace
#pragma unroll
    for (int i = 0; i < C::MT; ++i)
#pragma unroll
      for (int j = 0; j < C::NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = m0 + wm * C::TM + i * 16 + g + (r >= 2 ? 8 : 0);
          const int col = n0 + wn * C::TN + j * 8 + t * 2 + (r & 1);
          if (row < p.M && col < p.N) atomicAdd(&p.ws[(long long)row * p.N + col], acc[i][j][r]);
        }
    return;
  }

  // the epilogue through shared memory: fragments -> words -> 16-byte stores
  cp_wait<0>();
  __syncthreads();
  uint32_t* Es = reinterpret_cast<uint32_t*>(sm);
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
    if (i >= m_live) break;
#pragma unroll
    for (int j = 0; j < C::NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * C::TM + i * 16 + g + 8 * h;
        const int c = wn * C::TN + j * 8 + 2 * t;
        uint2 v = make_uint2(0u, 0u);
        if (n0 + c < p.N) v.x = epilogue<EPI>(p, n0 + c, acc[i][j][2 * h]);
        if (n0 + c + 1 < p.N) v.y = epilogue<EPI>(p, n0 + c + 1, acc[i][j][2 * h + 1]);
        *reinterpret_cast<uint2*>(Es + r * C::kLde + c) = v;
      }
  }
  __syncthreads();
  constexpr int per = EPI == kEpiRequant ? 16 : 4;  // elements per 16-byte store
  const int esize = EPI == kEpiRequant ? 1 : 4;
  const bool vec = (p.N * esize) % 16 == 0;
  for (int idx = tid; idx < BM * (BN / per); idx += C::kThreads) {
    const int r = idx / (BN / per), c = (idx % (BN / per)) * per;
    const int row = m0 + r, col = n0 + c;
    if (row >= p.M || col >= p.N) continue;
    const uint32_t* src = Es + r * C::kLde + c;
    const long long o = (long long)row * p.N + col;
    if (vec && col + per <= p.N) {
      if constexpr (EPI == kEpiRequant) {
        uint32_t w[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          w[q] = (src[4 * q] & 0xffu) | ((src[4 * q + 1] & 0xffu) << 8) |
                 ((src[4 * q + 2] & 0xffu) << 16) | ((src[4 * q + 3] & 0xffu) << 24);
        *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) + o) =
            make_uint4(w[0], w[1], w[2], w[3]);
      } else {
        *reinterpret_cast<uint4*>(static_cast<uint32_t*>(p.out) + o) =
            *reinterpret_cast<const uint4*>(src);
      }
    } else {
      for (int e = 0; e < per && col + e < p.N; ++e) store_word<EPI>(p, o + e, src[e]);
    }
  }
}

// the split-K epilogue: one thread per output element
template <int EPI>
__global__ void vta_epilogue_kernel(Params p) {
  const long long total = (long long)p.M * p.N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    store_word<EPI>(p, i, epilogue<EPI>(p, (int)(i % p.N), p.ws[i]));
}

template <int EPI, typename C, bool KM>
cudaError_t launch_tile(const Params& p, int splits, cudaStream_t st) {
  constexpr int bytes = kSmemBytes<C, KM>;
  cudaError_t err = cudaFuncSetAttribute(vta_gemm_kernel<EPI, C, KM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + C::BN - 1) / C::BN, (p.M + C::BM - 1) / C::BM, splits);
  vta_gemm_kernel<EPI, C, KM><<<grid, C::kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int EPI>
cudaError_t launch(const Params& p, int large, int kmajor, int splits, cudaStream_t st) {
  cudaError_t err;
  if (splits > 1) {
    err = cudaMemsetAsync(p.ws, 0, (size_t)p.M * p.N * sizeof(int), st);
    if (err != cudaSuccess) return err;
  }
  if (large)
    err = kmajor ? launch_tile<EPI, Large, true>(p, splits, st)
                 : launch_tile<EPI, Large, false>(p, splits, st);
  else
    err = kmajor ? launch_tile<EPI, Small, true>(p, splits, st)
                 : launch_tile<EPI, Small, false>(p, splits, st);
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)p.M * p.N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  vta_epilogue_kernel<EPI><<<blocks, 256, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (M, K) int8 with contiguous rows (row stride lda, in elements); w (K, N)
// int8, K-major (kmajor = 1: column n at w + n * ldw, its K bytes
// contiguous) or N-contiguous (kmajor = 0: row k at w + k * ldw); out (M, N)
// contiguous: int32 (epilogue 0), int8 (1) or f32 (2).  bias: int32 (N,)
// for requant, f32 (N,) or null for dequant; scale f32 (N,) for dequant.
// large = 1 takes the 128 x 128 CTA tile, 0 the 64 x 64 one.  splits > 1
// needs ws, an (M, N) int32 scratch, and k_per_split a multiple of 64 with
// splits * k_per_split >= K.  shift is already clamped to [0, 31]; act: 0
// none, 1 relu, 2 silu, 3 gelu.  Returns the cudaError_t of the launches.
int vta_gemm_fwd(const void* a, const void* w, const void* bias, const void* scale, void* out,
                 void* ws, int M, int N, int K, long long lda, long long ldw, int kmajor,
                 int epilogue, int shift, int relu, int act, int large, int splits,
                 int k_per_split, void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || splits < 1 || k_per_split % BK != 0 ||
      (splits > 1 && ws == nullptr) || (long long)splits * k_per_split < K)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.a = static_cast<const int8_t*>(a);
  p.w = static_cast<const int8_t*>(w);
  p.bias = bias;
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.ws = static_cast<int*>(ws);
  p.M = M; p.N = N; p.K = K;
  p.lda = lda; p.ldw = ldw;
  p.shift = shift; p.relu = relu; p.act = act;
  p.k_per_split = k_per_split;
  p.vec_a = reinterpret_cast<uintptr_t>(a) % 16 == 0 && lda % 16 == 0;
  p.vec_w = reinterpret_cast<uintptr_t>(w) % 16 == 0 && ldw % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epilogue == kEpiNone) return (int)launch<kEpiNone>(p, large, kmajor, splits, st);
  if (epilogue == kEpiRequant) return (int)launch<kEpiRequant>(p, large, kmajor, splits, st);
  if (epilogue == kEpiDequant) return (int)launch<kEpiDequant>(p, large, kmajor, splits, st);
  return (int)cudaErrorInvalidValue;
}

const char* vta_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
