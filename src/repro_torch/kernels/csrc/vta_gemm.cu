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
// Design.  One CTA of four warps computes a 64 x 64 output tile; each warp a
// 32 x 32 quarter with `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`
// (2 x 4 MMAs per 32-deep step, int32 accumulators in registers, exact: the
// largest sum of a K = 4608 product is 128 * 128 * 4608 < 2^31).  K is walked
// in 64-deep tiles staged through shared memory; the next tile's global loads
// are issued into registers before the current tile's MMAs, so one tile is
// always in flight.  A (M, K) is K-contiguous and goes to shared memory as it
// is (16-byte loads).  W stays (K, N) N-contiguous at the public surface, as
// the reference lays it out, while the MMA wants each column K-contiguous: a
// thread loads a 4 x 4 byte block (four 4-byte row loads) and transposes it
// with `__byte_perm` into four 4-byte column words.  Shared rows are padded
// to 80 bytes, so the fragment reads of a warp hit 32 distinct banks.  The
// kernel masks its own ragged M, N and K edges (zero-filled loads, guarded
// stores); nothing is padded on the host.
//
// When the output tiles alone cannot fill the card (decode: M = 4, N = 1024
// gives 16 tiles for 132 SMs), K is split over `splits` CTAs per tile that
// add their int32 partial sums into a zeroed workspace with atomics (integer
// addition is exact in any order, so the result is bitwise that of one CTA),
// and a second launch applies the epilogue.
//
// The dequant epilogue rounds as the plain version does: one int -> f32
// conversion, `__fmul_rn` by the scale, `__fadd_rn` of the bias (never
// contracted into an FMA), and silu / gelu step by step in the plain
// version's order, so on the card the kernel is bitwise equal to it.
//
// What bounds it on this card.  In decode (M = 4 or 8) every weight byte is
// read once for a handful of operations: the bound is the weight bytes over
// 3.35 TB/s (a decode step's 440 MB of qwen3_0p6b projections take 0.131 ms).
// In prefill (M = 512 or 2048) the bound is the int8 operations over
// 1,979 TOP/s.  This simple version uses mma.sync without TMA, wgmma or a
// deeper pipeline; its tile loads wait on memory latency.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int kThreads = 128;
constexpr int kLds = BK + 16;  // shared row stride in bytes

enum { kEpiNone = 0, kEpiRequant = 1, kEpiDequant = 2 };
enum { kActNone = 0, kActRelu = 1, kActSilu = 2, kActGelu = 3 };

struct Params {
  const int8_t* a;
  const int8_t* w;
  const void* bias;    // int32 (requant) or f32 (dequant) (N,), or null
  const float* scale;  // f32 (N,) (dequant)
  void* out;           // (M, N) int32 / int8 / f32, row-major
  int* ws;             // (M, N) int32 split-K workspace, or null
  int M, N, K;
  long long lda, ldw;  // row strides of a and w, in elements
  int shift, relu, act;
  int k_per_split;     // a multiple of BK
  int vec_a, vec_w;    // 16-byte rows of a / 4-byte rows of w are aligned
};

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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

template <int EPI>
__device__ __forceinline__ void store_one(const Params& p, int row, int col, int acc) {
  const long long o = (long long)row * p.N + col;
  if constexpr (EPI == kEpiNone) {
    static_cast<int*>(p.out)[o] = acc;
  } else if constexpr (EPI == kEpiRequant) {
    // int32 add wraps as the reference's does; >> of a signed int is
    // arithmetic (rounds toward -inf); the shift is clamped to [0, 31]
    int v = (int)((unsigned)acc + (unsigned)static_cast<const int*>(p.bias)[col]);
    v >>= p.shift;
    if (p.relu) v = max(v, 0);
    static_cast<int8_t*>(p.out)[o] = (int8_t)min(max(v, -128), 127);
  } else {
    float y = __fmul_rn(__int2float_rn(acc), p.scale[col]);
    if (p.bias != nullptr) y = __fadd_rn(y, static_cast<const float*>(p.bias)[col]);
    static_cast<float*>(p.out)[o] = apply_act(y, p.act);
  }
}

// 4 bytes of row k at columns n .. n+3 of w, zero where out of range
__device__ __forceinline__ uint32_t load_w4(const Params& p, int k, int n) {
  if (k >= p.K) return 0u;
  const int8_t* src = p.w + (long long)k * p.ldw + n;
  if (p.vec_w && n + 4 <= p.N) return *reinterpret_cast<const uint32_t*>(src);
  uint32_t v = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < p.N) v |= (uint32_t)(uint8_t)src[j] << (8 * j);
  return v;
}

// 16 bytes of row r of a at columns k .. k+15, zero where out of range
__device__ __forceinline__ int4 load_a16(const Params& p, int r, int k) {
  if (r >= p.M) return make_int4(0, 0, 0, 0);
  const int8_t* src = p.a + (long long)r * p.lda + k;
  if (p.vec_a && k + 16 <= p.K) return *reinterpret_cast<const int4*>(src);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (k + j < p.K) v[j >> 2] |= (uint32_t)(uint8_t)src[j] << (8 * (j & 3));
  return make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
}

template <int EPI>
__global__ void __launch_bounds__(kThreads) vta_gemm_kernel(Params p) {
  __shared__ __align__(16) int8_t As[BM * kLds];  // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * kLds];  // [n][k]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * p.k_per_split;
  const int k_end = min(p.K, k_begin + p.k_per_split);
  const int nk = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // staging registers: A as two 16-byte row pieces, W as two 4 x 4 blocks
  int4 ra[2];
  uint32_t rw[2][4];

  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;  // 256 pieces: 64 rows x 4
      ra[i] = load_a16(p, m0 + (c >> 2), k0 + (c & 3) * 16);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = tid + i * kThreads;  // 256 blocks: 16 k-quads x 16 n-quads
      const int kb = blk >> 4, nb = blk & 15;
#pragma unroll
      for (int r = 0; r < 4; ++r) rw[i][r] = load_w4(p, k0 + kb * 4 + r, n0 + nb * 4);
    }
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * kThreads;
      *reinterpret_cast<int4*>(&As[(c >> 2) * kLds + (c & 3) * 16]) = ra[i];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int blk = tid + i * kThreads;
      const int kb = blk >> 4, nb = blk & 15;
      // rows r0..r3 (k) of columns n..n+3 -> columns n+j as k-quads
      const uint32_t t0 = __byte_perm(rw[i][0], rw[i][1], 0x5140);
      const uint32_t t1 = __byte_perm(rw[i][2], rw[i][3], 0x5140);
      const uint32_t t2 = __byte_perm(rw[i][0], rw[i][1], 0x7362);
      const uint32_t t3 = __byte_perm(rw[i][2], rw[i][3], 0x7362);
      const uint32_t col[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                               __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(&Bs[(nb * 4 + j) * kLds + kb * 4]) = col[j];
    }
  };

  if (nk > 0) load_tile(k_begin);
  for (int kt = 0; kt < nk; ++kt) {
    store_tile();
    __syncthreads();
    if (kt + 1 < nk) load_tile(k_begin + (kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int im = 0; im < 2; ++im) {
        const int row = wm * 32 + im * 16 + g;
        af[im][0] = *reinterpret_cast<const uint32_t*>(&As[row * kLds + kk + t * 4]);
        af[im][1] = *reinterpret_cast<const uint32_t*>(&As[(row + 8) * kLds + kk + t * 4]);
        af[im][2] = *reinterpret_cast<const uint32_t*>(&As[row * kLds + kk + 16 + t * 4]);
        af[im][3] = *reinterpret_cast<const uint32_t*>(&As[(row + 8) * kLds + kk + 16 + t * 4]);
      }
#pragma unroll
      for (int jn = 0; jn < 4; ++jn) {
        const int col = wn * 32 + jn * 8 + g;
        bf[jn][0] = *reinterpret_cast<const uint32_t*>(&Bs[col * kLds + kk + t * 4]);
        bf[jn][1] = *reinterpret_cast<const uint32_t*>(&Bs[col * kLds + kk + 16 + t * 4]);
      }
#pragma unroll
      for (int im = 0; im < 2; ++im)
#pragma unroll
        for (int jn = 0; jn < 4; ++jn) mma_s8(acc[im][jn], af[im], bf[jn]);
    }
    __syncthreads();
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int im = 0; im < 2; ++im)
#pragma unroll
    for (int jn = 0; jn < 4; ++jn)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm * 32 + im * 16 + g + (r >= 2 ? 8 : 0);
        const int col = n0 + wn * 32 + jn * 8 + t * 2 + (r & 1);
        if (row >= p.M || col >= p.N) continue;
        if (split)
          atomicAdd(&p.ws[(long long)row * p.N + col], acc[im][jn][r]);
        else
          store_one<EPI>(p, row, col, acc[im][jn][r]);
      }
}

// the split-K epilogue: one thread per output element
template <int EPI>
__global__ void vta_epilogue_kernel(Params p) {
  const long long total = (long long)p.M * p.N;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x)
    store_one<EPI>(p, (int)(i / p.N), (int)(i % p.N), p.ws[i]);
}

template <int EPI>
cudaError_t launch(const Params& p, int splits, cudaStream_t st) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, splits);
  cudaError_t err;
  if (splits > 1) {
    err = cudaMemsetAsync(p.ws, 0, (size_t)p.M * p.N * sizeof(int), st);
    if (err != cudaSuccess) return err;
  }
  vta_gemm_kernel<EPI><<<grid, kThreads, 0, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)p.M * p.N;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  vta_epilogue_kernel<EPI><<<blocks, 256, 0, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a (M, K) and w (K, N) int8 with contiguous rows (strides lda, ldw in
// elements); out (M, N) contiguous: int32 (epilogue 0), int8 (1) or f32 (2).
// bias: int32 (N,) for requant, f32 (N,) or null for dequant; scale f32 (N,)
// for dequant.  splits > 1 needs ws, an (M, N) int32 scratch, and
// k_per_split a multiple of 64 with splits * k_per_split >= K.  shift is
// already clamped to [0, 31]; act: 0 none, 1 relu, 2 silu, 3 gelu.
// Returns the cudaError_t of the launches.
int vta_gemm_fwd(const void* a, const void* w, const void* bias, const void* scale, void* out,
                 void* ws, int M, int N, int K, long long lda, long long ldw, int epilogue,
                 int shift, int relu, int act, int splits, int k_per_split, void* stream) {
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
  p.vec_a = (reinterpret_cast<uintptr_t>(a) % 16 == 0) && (lda % 16 == 0);
  p.vec_w = (reinterpret_cast<uintptr_t>(w) % 4 == 0) && (ldw % 4 == 0);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (epilogue == kEpiNone) return (int)launch<kEpiNone>(p, splits, st);
  if (epilogue == kEpiRequant) return (int)launch<kEpiRequant>(p, splits, st);
  if (epilogue == kEpiDequant) return (int)launch<kEpiDequant>(p, splits, st);
  return (int)cudaErrorInvalidValue;
}

const char* vta_gemm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
