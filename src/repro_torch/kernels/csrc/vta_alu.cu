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
// one flat run of M * N elements, walked by a grid-stride loop: each thread
// loads four elements of each operand as one vector (an int4 of int32, a
// char4 of int8), combines them and stores an int4 of int32 per step where
// every pointer is aligned to its vector, and a scalar tail covers the last
// M * N % 4 elements (or all of them when a pointer is not aligned).  No
// row masking, no padding copies: any M and N.  An operand is int8 (VTA's
// input type) or int32 (its accumulator type), each a template parameter,
// and is widened to int32 in registers, as the Pallas kernels'
// `astype(jnp.int32)` does in their body.  The add ops run in unsigned
// arithmetic, so an int32 overflow wraps as XLA's does and hits no
// signed-overflow undefined behaviour.  The shift arrives clamped to
// [0, 31] (an arithmetic shift by 31 gives all sign bits, what XLA gives
// for 32 and more; shifting by 32 in C++ is undefined).
//
// What bounds it on this card.  A few integer operations per 8 (unary) or
// 12 (binary) bytes moved for int32 operands: device memory at 3.35 TB/s is
// the bound, 2.87 us (binary) and 1.92 us (unary) at ResNet-18's stem
// output (M 12544, N 64).  At sizes this small the launch itself costs as
// much as the work.

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

template <int OP, typename TX, typename TY>
__global__ void __launch_bounds__(256) vta_alu_kernel(
    const TX* __restrict__ x, const TY* __restrict__ y, int32_t* __restrict__ out,
    long long n, int32_t imm, int shift, int vec) {
  using VX = typename Vec4<TX>::type;
  using VY = typename Vec4<TY>::type;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  const VX* x4 = reinterpret_cast<const VX*>(x);
  const VY* y4 = reinterpret_cast<const VY*>(y);
  int4* o4 = reinterpret_cast<int4*>(out);
  for (long long i = tid; i < n4; i += stride) {
    const int4 a = widen(x4[i]);
    int4 b = a;
    if constexpr (binary(OP)) b = widen(y4[i]);
    o4[i] = alu4<OP>(a, b, imm, shift);
  }
  for (long long i = 4 * n4 + tid; i < n; i += stride) {
    int32_t b = 0;
    if constexpr (binary(OP)) b = (int32_t)y[i];
    out[i] = alu<OP>((int32_t)x[i], b, imm, shift);
  }
}

template <int OP, typename TX, typename TY>
cudaError_t launch(const void* x, const void* y, void* out, long long n, int imm, int shift,
                   int blocks, cudaStream_t st) {
  const int vec = reinterpret_cast<uintptr_t>(x) % (4 * sizeof(TX)) == 0 &&
                  reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                  (!binary(OP) || reinterpret_cast<uintptr_t>(y) % (4 * sizeof(TY)) == 0);
  vta_alu_kernel<OP, TX, TY><<<blocks, 256, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TY*>(y), static_cast<int32_t*>(out), n,
      imm, shift, vec);
  return cudaGetLastError();
}

// the operands' element types: 1 byte int8, 4 bytes int32 (a unary op has no y)
template <int OP, typename TX>
cudaError_t by_y(int ybytes, const void* x, const void* y, void* out, long long n, int imm,
                 int shift, int blocks, cudaStream_t st) {
  if constexpr (binary(OP)) {
    if (ybytes == 1) return launch<OP, TX, int8_t>(x, y, out, n, imm, shift, blocks, st);
    if (ybytes != 4) return cudaErrorInvalidValue;
  }
  return launch<OP, TX, int32_t>(x, y, out, n, imm, shift, blocks, st);
}

template <int OP>
cudaError_t by_x(int xbytes, int ybytes, const void* x, const void* y, void* out, long long n,
                 int imm, int shift, int blocks, cudaStream_t st) {
  if (xbytes == 1) return by_y<OP, int8_t>(ybytes, x, y, out, n, imm, shift, blocks, st);
  if (xbytes == 4) return by_y<OP, int32_t>(ybytes, x, y, out, n, imm, shift, blocks, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x (and y for ops 0-2): n contiguous elements of xbytes (ybytes) bytes
// each, 1 for int8 and 4 for int32; out: n contiguous int32.  op: 0 add,
// 1 max, 2 min, 3 add_imm, 4 max_imm, 5 relu, 6 shr; shift already clamped
// to [0, 31].  blocks: the grid of 256-thread CTAs (the loop strides over
// the rest).  The vector path is taken when every pointer is aligned to
// four of its elements.  Returns the cudaError_t of the launch.
int vta_alu_fwd(const void* x, const void* y, void* out, long long n, int op, int xbytes,
                int ybytes, int imm, int shift, int blocks, void* stream) {
  if (n <= 0 || blocks < 1 || shift < 0 || shift > 31 || (binary(op) && y == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
#define VTA_ALU_CASE(OP) \
  case OP: return (int)by_x<OP>(xbytes, ybytes, x, y, out, n, imm, shift, blocks, st);
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
