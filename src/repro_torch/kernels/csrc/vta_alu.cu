// The VTA ALU for Hopper (sm_90a): VTA's register-file datapath as one
// element-wise pass over int32 tensors, the op a template parameter.
//
//   binary  add (x + y, wrapping at 2^32), max, min
//   unary   add_imm (x + imm, wrapping), max_imm (max(x, imm)),
//           relu (max(x, 0)), shr (arithmetic x >> shift)
//
// Replaces the Pallas TPU kernels `_alu_kernel` (binary) and
// `_alu_unary_kernel` (unary) of src/repro/kernels/vta_alu.py (`vta_alu`,
// its two `pl.pallas_call`s).
//
// Design.  The Pallas kernel walks (block, N) row blocks in a sequential
// grid, so its caller pads M to a block multiple.  Here the (M, N) tensor is
// one flat run of M * N elements cut into CTA tiles of 256 threads x kItems
// vectors of four elements (an int4 of int32, a char4 of int8): each thread
// issues all its loads before it combines and stores them, with no loop and
// one bounds test per vector, and the last CTA alone covers the ragged
// M * N % 4 elements.  Where a pointer is not aligned to its vector, a
// scalar variant walks kItems x 4 elements a thread the same way.  The grid
// is sized to the work.  The vector / scalar choice and 32- or 64-bit
// indices (32 where M * N < 2^31) are template parameters, so a thread's
// path holds no runtime branch between them.  No row masking, no padding
// copies: any M and N.  An operand is int8 (VTA's input type) or int32 (its
// accumulator type), each a template parameter, and is widened to int32 in
// registers, as the Pallas kernels' `astype(jnp.int32)` does in their body.
// The add ops run in unsigned arithmetic, so an int32 overflow wraps as
// XLA's does and hits no signed-overflow undefined behaviour.  The shift
// arrives clamped to [0, 31] (an arithmetic shift by 31 gives all sign bits,
// what XLA gives for 32 and more; shifting by 32 in C++ is undefined).
//
// What bounds it on this card.  A few integer operations per 8 (unary) or
// 12 (binary) bytes moved for int32 operands: device memory at 3.35 TB/s is
// the bound, 2.87 us (binary) and 1.92 us (unary) at ResNet-18's stem
// output (M 12544, N 64).  On the VTA path the operands were just written
// by the GEMM and sit in the 50 MB L2, so that byte bound is a floor the
// kernel cannot reach from device memory; at these sizes the launch and the
// CTAs' start-up cost about as much as the work.  Two vectors a thread (392
// CTAs at the stem output) measured at or below torch's own elementwise
// kernels on the card; one vector a thread in a 64-bit grid-stride loop (the
// first version, 784 CTAs) and four (196 CTAs, fewer than two an SM, so the
// SMs were unevenly loaded) were slower.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum { kAdd = 0, kMax = 1, kMin = 2, kAddImm = 3, kMaxImm = 4, kRelu = 5, kShr = 6 };

__host__ __device__ constexpr bool binary(int op) {
  return op == kAdd || op == kMax || op == kMin;
}

// four elements of T as one aligned vector load
template <typename T> struct Vec4;
template <> struct Vec4<int8_t> { using type = char4; };
template <> struct Vec4<int32_t> { using type = int4; };

__device__ __forceinline__ int4 widen(int4 v) { return v; }
__device__ __forceinline__ int4 widen(char4 v) { return make_int4(v.x, v.y, v.z, v.w); }

template <int OP>
__device__ __forceinline__ int32_t alu(int32_t x, int32_t y, int32_t imm, int shift) {
  if constexpr (OP == kAdd) return (int32_t)((uint32_t)x + (uint32_t)y);
  if constexpr (OP == kMax) return x > y ? x : y;
  if constexpr (OP == kMin) return x < y ? x : y;
  if constexpr (OP == kAddImm) return (int32_t)((uint32_t)x + (uint32_t)imm);
  if constexpr (OP == kMaxImm) return x > imm ? x : imm;
  if constexpr (OP == kRelu) return x > 0 ? x : 0;
  if constexpr (OP == kShr) return x >> shift;  // signed: arithmetic (shr.s32)
  return 0;
}

template <int OP>
__device__ __forceinline__ int4 alu4(int4 x, int4 y, int32_t imm, int shift) {
  return make_int4(alu<OP>(x.x, y.x, imm, shift), alu<OP>(x.y, y.y, imm, shift),
                   alu<OP>(x.z, y.z, imm, shift), alu<OP>(x.w, y.w, imm, shift));
}

constexpr int kThreads = 256;
constexpr int kItems = 2;  // vectors (or groups of four scalars) a thread

template <int OP, typename TX, typename TY, bool VEC, typename I>
__global__ void __launch_bounds__(kThreads) vta_alu_kernel(
    const TX* __restrict__ x, const TY* __restrict__ y, int32_t* __restrict__ out, I n,
    int32_t imm, int shift) {
  if constexpr (VEC) {
    using VX = typename Vec4<TX>::type;
    using VY = typename Vec4<TY>::type;
    const VX* x4 = reinterpret_cast<const VX*>(x);
    const VY* y4 = reinterpret_cast<const VY*>(y);
    int4* o4 = reinterpret_cast<int4*>(out);
    const I n4 = n / 4;
    const I base = (I)blockIdx.x * (kThreads * kItems) + threadIdx.x;
    int4 a[kItems], b[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const I v = base + i * kThreads;
      if (v < n4) {
        a[i] = widen(x4[v]);
        b[i] = a[i];
        if constexpr (binary(OP)) b[i] = widen(y4[v]);
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const I v = base + i * kThreads;
      if (v < n4) o4[v] = alu4<OP>(a[i], b[i], imm, shift);
    }
    if (blockIdx.x == gridDim.x - 1) {  // the ragged n % 4 elements
      const I e = 4 * n4 + threadIdx.x;
      if (e < n) {
        int32_t yy = 0;
        if constexpr (binary(OP)) yy = (int32_t)y[e];
        out[e] = alu<OP>((int32_t)x[e], yy, imm, shift);
      }
    }
  } else {
    constexpr int kScalars = 4 * kItems;
    const I base = (I)blockIdx.x * (kThreads * kScalars) + threadIdx.x;
    int32_t a[kScalars], b[kScalars];
#pragma unroll
    for (int i = 0; i < kScalars; ++i) {
      const I e = base + i * kThreads;
      if (e < n) {
        a[i] = (int32_t)x[e];
        b[i] = 0;
        if constexpr (binary(OP)) b[i] = (int32_t)y[e];
      }
    }
#pragma unroll
    for (int i = 0; i < kScalars; ++i) {
      const I e = base + i * kThreads;
      if (e < n) out[e] = alu<OP>(a[i], b[i], imm, shift);
    }
  }
}

template <int OP, typename TX, typename TY, bool VEC>
cudaError_t launch_idx(const void* x, const void* y, void* out, long long n, int imm, int shift,
                       cudaStream_t st) {
  // a CTA covers kThreads x kItems vectors, or as many groups of 4 scalars
  const long long per_cta = (long long)kThreads * kItems * (VEC ? 1 : 4);
  const long long units = VEC ? n / 4 : n;
  const long long grid = (units + per_cta - 1) / per_cta;
  const unsigned g = (unsigned)(grid > 0 ? grid : 1);  // n < 4: one CTA for the tail
  const TX* px = static_cast<const TX*>(x);
  const TY* py = static_cast<const TY*>(y);
  int32_t* po = static_cast<int32_t*>(out);
  // 32-bit indices while the last CTA's indices (< n + its span) fit
  if (n <= INT32_MAX - kThreads * kItems * 4)
    vta_alu_kernel<OP, TX, TY, VEC, int><<<g, kThreads, 0, st>>>(px, py, po, (int)n, imm, shift);
  else
    vta_alu_kernel<OP, TX, TY, VEC, long long><<<g, kThreads, 0, st>>>(px, py, po, n, imm, shift);
  return cudaGetLastError();
}

template <int OP, typename TX, typename TY>
cudaError_t launch(const void* x, const void* y, void* out, long long n, int imm, int shift,
                   cudaStream_t st) {
  const bool vec = reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TX)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (!binary(OP) || reinterpret_cast<uintptr_t>(y) % (4 * sizeof(TY)) == 0);
  return vec ? launch_idx<OP, TX, TY, true>(x, y, out, n, imm, shift, st)
             : launch_idx<OP, TX, TY, false>(x, y, out, n, imm, shift, st);
}

// the operands' element types: 1 byte int8, 4 bytes int32 (a unary op has no y)
template <int OP, typename TX>
cudaError_t by_y(int ybytes, const void* x, const void* y, void* out, long long n, int imm,
                 int shift, cudaStream_t st) {
  if constexpr (binary(OP)) {
    if (ybytes == 1) return launch<OP, TX, int8_t>(x, y, out, n, imm, shift, st);
    if (ybytes != 4) return cudaErrorInvalidValue;
  }
  return launch<OP, TX, int32_t>(x, y, out, n, imm, shift, st);
}

template <int OP>
cudaError_t by_x(int xbytes, int ybytes, const void* x, const void* y, void* out, long long n,
                 int imm, int shift, cudaStream_t st) {
  if (xbytes == 1) return by_y<OP, int8_t>(ybytes, x, y, out, n, imm, shift, st);
  if (xbytes == 4) return by_y<OP, int32_t>(ybytes, x, y, out, n, imm, shift, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (and y for ops 0-2): n contiguous elements of xbytes (ybytes) bytes
// each, 1 for int8 and 4 for int32; out: n contiguous int32.  op: 0 add,
// 1 max, 2 min, 3 add_imm, 4 max_imm, 5 relu, 6 shr; shift already clamped
// to [0, 31].  The grid is the kernel's own; the vector path is taken when
// every pointer is aligned to four of its elements.  Returns the
// cudaError_t of the launch.
int vta_alu_fwd(const void* x, const void* y, void* out, long long n, int op, int xbytes,
                int ybytes, int imm, int shift, void* stream) {
  if (n <= 0 || shift < 0 || shift > 31 || (binary(op) && y == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
#define VTA_ALU_CASE(OP) \
  case OP: return (int)by_x<OP>(xbytes, ybytes, x, y, out, n, imm, shift, st);
    VTA_ALU_CASE(kAdd)
    VTA_ALU_CASE(kMax)
    VTA_ALU_CASE(kMin)
    VTA_ALU_CASE(kAddImm)
    VTA_ALU_CASE(kMaxImm)
    VTA_ALU_CASE(kRelu)
    VTA_ALU_CASE(kShr)
#undef VTA_ALU_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* vta_alu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
