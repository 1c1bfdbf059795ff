// Hand-written Hopper (sm_90a) kernels for the delta codec of the OPT-HSFL
// snapshots: blockwise absmax quantization of a (M, block) f32 view to int8
// (or int4 values stored in int8 lanes), and its inverse.
//
// They replace the two Pallas TPU kernels of
// src/repro/kernels/delta_codec/kernel.py:
//
//   quantize_blocks    (pallas_call at kernel.py:75) -> quantize_row_kernel
//                                                       (quantize_loop_kernel
//                                                       for other widths)
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
// VMEM.  Here one warp owns one row and reads it once, into registers:
// lane l holds the V = block / 32 consecutive values [V l, V l + V) (at
// block = 512, 16 floats as 4 float4 loads, all issued before the first
// is used), the row's absmax is reduced with warp shuffles, and lane l
// writes its V int8 values as one store of V bytes (16 at block = 512,
// two of 16 at 1024).  The widths the repo runs, 128, 256, 512 and 1024,
// are template instantiations (quantize_row_kernel<V>); a wider row, or
// one that is no power of two, runs quantize_loop_kernel, which walks the
// row in pieces of 128 floats twice (absmax, then q, the second read from
// L2).  That is a dispatch on shape, not a fallback.  Blocks of 4 warps
// (4 rows), at most one wave of them (as many as the card holds at once),
// warps looping over rows with the grid's stride: at the fused round's
// 2560 rows every row's loads are in flight from the start.
// What is left of the time is the divisions: div.rn costs a MUFU.RCP, an
// FCHK and a branch to its slow path per element (the SASS), and the
// multi-function units retire 16 a clock an SM.  So the rounding and the
// conversion are one cvt.rni after the clip (not rintf, then a cvt), and
// an all-zero row (padding, an unchanged user: zero dividends take the
// slow path) writes q = 0 without dividing.  Its time on the card
// (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py) is in PERF.md.
//
// Numerics: the results must equal the reference bit for bit.
// - absmax: fmaxf(fabsf(.)) is exact, so the reduction order is free;
// - scale = absmax * fl(1/qmax), then fmaxf(scale, 1e-12f): XLA folds the
//   reference's division by the constant qmax into a multiply by its f32
//   reciprocal, and the port computes the scale the same way;
// - q = clip(rint(x / scale), -qmax, qmax): an IEEE division (__fdiv_rn,
//   never a multiply by 1/scale) and rounding half to even (cvt.rni, as
//   rintf; never roundf, which rounds half away from zero).  Clipping
//   before rounding gives the same integers: qmax is whole.  No
//   --use_fast_math.
// - dequantize: (float)q * scale[row], one f32 multiply.
// All-zero rows (row padding, unchanged users) get scale 1e-12 and q = 0.
//
// Interface: plain C functions, bound with ctypes.  Each launches one
// __global__ function on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>

#define API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kThreads = 256;        // dequantize
constexpr int kQuantWarps = 4;       // quantize: warps (rows) a block

// x / scale clipped to [-qmax, qmax] and rounded half to even: the same
// integers as rint-then-clip (qmax is whole), with one conversion
// (cvt.rni) rounding; a NaN quotient clips to -qmax in both orders
__device__ __forceinline__ int quant(float x, float scale, float fq) {
  return __float2int_rn(fminf(fmaxf(__fdiv_rn(x, scale), -fq), fq));
}

// the scale of a row from its absmax: absmax * fl(1/qmax), floored
__device__ __forceinline__ float row_scale(float amax, float fq) {
  const float inv_qmax = __fdiv_rn(1.0f, fq);
  return fmaxf(__fmul_rn(amax, inv_qmax), 1e-12f);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// four int8 values, the first in the lowest byte
__device__ __forceinline__ unsigned pack4(int a, int b, int c, int d) {
  return (unsigned)(a & 0xff) | (unsigned)(b & 0xff) << 8 |
         (unsigned)(c & 0xff) << 16 | (unsigned)(d & 0xff) << 24;
}

// rows of V * 32 floats (V in {4, 8, 16, 32}), each read once into a
// warp's registers; warps loop over rows with the grid's stride
template <int V>
__global__ void __launch_bounds__(32 * kQuantWarps)
quantize_row_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                    float* __restrict__ scales, int M, int qmax) {
  constexpr int B = 32 * V, N4 = V / 4;
  const int lane = threadIdx.x & 31;
  const float fq = (float)qmax;
  const long long stride = (long long)gridDim.x * kQuantWarps;
  for (long long row = (long long)blockIdx.x * kQuantWarps +
                       (threadIdx.x >> 5);
       row < M; row += stride) {
    const float4* xr = reinterpret_cast<const float4*>(x + row * B) +
                       lane * N4;
    float4 v[N4];
#pragma unroll
    for (int i = 0; i < N4; ++i) v[i] = xr[i];
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < N4; ++i)
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[i].x), fabsf(v[i].y)),
                               fmaxf(fabsf(v[i].z), fabsf(v[i].w))));
    amax = warp_max(amax);
    const float scale = row_scale(amax, fq);
    if (lane == 0) scales[row] = scale;
    // an all-zero row (padding, an unchanged user) is q = 0 without its
    // divisions, whose zero dividends take the slow path of div.rn
    unsigned w[N4];
    if (amax == 0.0f) {
#pragma unroll
      for (int i = 0; i < N4; ++i) w[i] = 0u;
    } else {
#pragma unroll
      for (int i = 0; i < N4; ++i)
        w[i] = pack4(quant(v[i].x, scale, fq), quant(v[i].y, scale, fq),
                     quant(v[i].z, scale, fq), quant(v[i].w, scale, fq));
    }
    signed char* qr = q + row * B + lane * V;
    if constexpr (N4 == 1) {
      *reinterpret_cast<unsigned*>(qr) = w[0];
    } else if constexpr (N4 == 2) {
      *reinterpret_cast<uint2*>(qr) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < N4; i += 4)
        reinterpret_cast<uint4*>(qr)[i / 4] =
            make_uint4(w[i], w[i + 1], w[i + 2], w[i + 3]);
    }
  }
}

// any row width B (a multiple of 4): pieces of 128 floats, a float4 a
// lane, read twice (absmax, then q)
__global__ void __launch_bounds__(32 * kQuantWarps)
quantize_loop_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                     float* __restrict__ scales, int M, int B, int qmax) {
  const int lane = threadIdx.x & 31;
  const float fq = (float)qmax;
  const int n4 = B / 4;
  const long long stride = (long long)gridDim.x * kQuantWarps;
  for (long long row = (long long)blockIdx.x * kQuantWarps +
                       (threadIdx.x >> 5);
       row < M; row += stride) {
    const float4* xr = reinterpret_cast<const float4*>(x + row * B);
    float amax = 0.0f;
    for (int i = lane; i < n4; i += 32) {
      const float4 v = xr[i];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                               fmaxf(fabsf(v.z), fabsf(v.w))));
    }
    amax = warp_max(amax);
    const float scale = row_scale(amax, fq);
    if (lane == 0) scales[row] = scale;
    unsigned* qr = reinterpret_cast<unsigned*>(q + row * B);
    for (int i = lane; i < n4; i += 32) {
      if (amax == 0.0f) {
        qr[i] = 0u;
        continue;
      }
      const float4 v = xr[i];
      qr[i] = pack4(quant(v.x, scale, fq), quant(v.y, scale, fq),
                    quant(v.z, scale, fq), quant(v.w, scale, fq));
    }
  }
}

// blocks of kQuantWarps warps for `rows` rows, a warp a row: at most one
// wave of the card (the blocks it holds at once); warps loop over the rest
template <typename K>
unsigned one_wave(K kernel, long long rows) {
  int dev = 0, nsm = 132, per_sm = 1;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                32 * kQuantWarps, 0);
  const long long need = (rows + kQuantWarps - 1) / kQuantWarps;
  const long long wave = (long long)nsm * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(need < wave ? need : wave);
}

template <int V>
int launch_rows(const float* x, signed char* q, float* scales, int M,
                int qmax, void* stream) {
  const auto kernel = quantize_row_kernel<V>;
  kernel<<<one_wave(kernel, M), 32 * kQuantWarps, 0,
           (cudaStream_t)stream>>>(
      x, q, scales, M, qmax);
  return (int)cudaGetLastError();
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
// three pointers 16-byte aligned (the wrapper checks both).  B of 128,
// 256, 512 or 1024 runs the register kernel, any other B the loop.
API int dcodec_quantize(const float* x, signed char* q, float* scales, int M,
                        int B, int qmax, void* stream) {
  switch (B) {
    case 128: return launch_rows<4>(x, q, scales, M, qmax, stream);
    case 256: return launch_rows<8>(x, q, scales, M, qmax, stream);
    case 512: return launch_rows<16>(x, q, scales, M, qmax, stream);
    case 1024: return launch_rows<32>(x, q, scales, M, qmax, stream);
    default: break;
  }
  quantize_loop_kernel<<<one_wave(quantize_loop_kernel, M),
                         32 * kQuantWarps, 0, (cudaStream_t)stream>>>(
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
