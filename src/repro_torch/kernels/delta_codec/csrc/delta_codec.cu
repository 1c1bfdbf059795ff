// Hand-written Hopper (sm_90a) kernels for the delta codec of the OPT-HSFL
// snapshots: blockwise absmax quantization of a (M, block) f32 view to int8
// (or int4 values stored in int8 lanes), and its inverse.
//
// They replace the two Pallas TPU kernels of
// src/repro/kernels/delta_codec/kernel.py:
//
//   quantize_blocks    (pallas_call at kernel.py:75) -> quantize_kernel
//   dequantize_blocks  (pallas_call at kernel.py:92) -> dequantize_kernel
//
// What bounds them.  Each element is read once and written once with one
// division (quantize) or one multiply (dequantize): a few operations per 5
// bytes moved, so both kernels are bounded by memory traffic (H100 SXM:
// 3.35 TB/s).  At the fused round's shape (M = 256*K rows of 512 lanes,
// K = 10) that is 6.56 MB and ~2 us per kernel; one user's tree (217 rows)
// moves 0.56 MB and is bounded by the launch itself.
//
// Design.  The TPU kernel quantizes a (256, block) tile per grid step in
// VMEM.  Here one warp owns one row: each lane reads 16-byte float4 chunks
// at a stride of 128 lanes (coalesced), the row's absmax is reduced with
// warp shuffles, and lane 0 writes the scale.  The row is then read a
// second time (from L1/L2) to write q, so no row has to fit in registers
// and any block width that is a multiple of 128 works.
//
// Numerics: the results must equal the reference bit for bit.
// - absmax: fmaxf(fabsf(.)) is exact, so the reduction order is free;
// - scale = absmax * fl(1/qmax), then fmaxf(scale, 1e-12f): XLA folds the
//   reference's division by the constant qmax into a multiply by its f32
//   reciprocal, and the port computes the scale the same way;
// - q = clip(rint(x / scale), -qmax, qmax): an IEEE division (__fdiv_rn,
//   never a multiply by 1/scale) and rounding half to even (rintf, never
//   roundf, which rounds half away from zero).  No --use_fast_math.
// - dequantize: (float)q * scale[row], one f32 multiply.
// All-zero rows (row padding, unchanged users) get scale 1e-12 and q = 0.
//
// Interface: plain C functions, bound with ctypes.  Each launches one
// __global__ function on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#define API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = 256;

__global__ void quantize_kernel(const float* __restrict__ x,
                                signed char* __restrict__ q,
                                float* __restrict__ scales, int M, int B,
                                int qmax) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;
  const float4* xr = reinterpret_cast<const float4*>(x + row * B);
  const int n4 = B / 4;

  float amax = 0.0f;
  for (int i = lane; i < n4; i += 32) {
    const float4 v = xr[i];
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                             fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));

  const float fq = (float)qmax;
  const float inv_qmax = __fdiv_rn(1.0f, fq);
  const float scale = fmaxf(__fmul_rn(amax, inv_qmax), 1e-12f);
  if (lane == 0) scales[row] = scale;

  char4* qr = reinterpret_cast<char4*>(q + row * B);
  for (int i = lane; i < n4; i += 32) {
    const float4 v = xr[i];
    char4 o;
    o.x = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.x, scale)), -fq), fq);
    o.y = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.y, scale)), -fq), fq);
    o.z = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.z, scale)), -fq), fq);
    o.w = (signed char)fminf(fmaxf(rintf(__fdiv_rn(v.w, scale)), -fq), fq);
    qr[i] = o;
  }
}

__global__ void dequantize_kernel(const signed char* __restrict__ q,
                                  const float* __restrict__ scales,
                                  float* __restrict__ out, long long n4,
                                  int B) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const float s = scales[(i * 4) / B];
  const char4 v = reinterpret_cast<const char4*>(q)[i];
  float4 o;
  o.x = __fmul_rn((float)v.x, s);
  o.y = __fmul_rn((float)v.y, s);
  o.z = __fmul_rn((float)v.z, s);
  o.w = __fmul_rn((float)v.w, s);
  reinterpret_cast<float4*>(out)[i] = o;
}

}  // namespace

API const char* dcodec_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x (M, B) f32 -> q (M, B) int8, scales (M, 1) f32.  B % 4 == 0 and all
// three pointers 16-byte aligned (the wrapper checks both).
API int dcodec_quantize(const float* x, signed char* q, float* scales, int M,
                        int B, int qmax, void* stream) {
  const unsigned grid = (unsigned)((M + kWarpsPerBlock - 1) / kWarpsPerBlock);
  quantize_kernel<<<grid, kWarpsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      x, q, scales, M, B, qmax);
  return (int)cudaGetLastError();
}

// q (M, B) int8, scales (M, 1) f32 -> out (M, B) f32.
API int dcodec_dequantize(const signed char* q, const float* scales,
                          float* out, int M, int B, void* stream) {
  const long long n4 = (long long)M * B / 4;
  const unsigned grid = (unsigned)((n4 + kThreads - 1) / kThreads);
  dequantize_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      q, scales, out, n4, B);
  return (int)cudaGetLastError();
}
