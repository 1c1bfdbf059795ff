// Hand-written Hopper (sm_90a) kernel for the RWKV6 "Finch" WKV recurrence
// of the model zoo's full-sequence time-mix (prefill).
//
// It replaces the Pallas TPU kernel of src/repro/kernels/wkv6/kernel.py:
//
//   wkv6_bh  (pallas_call at kernel.py:61) -> wkv6_kernel
//
// and computes the function of its _wkv_kernel (kernel.py:23-49): per
// (b, h), from a zero f32 state S (D x D),
//
//   y_t = r_t . (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
//
// every input widened to f32, y cast to r's dtype, the final state out in
// f32.  r, k, v come in one compute dtype (f32 or bf16); w and u are f32
// (the model's decay is f32 whatever the compute dtype).
//
// What bounds it.  At RWKV6-7B's prefill (B=2, 64 heads, S=2048, D=64,
// r/k/v/y bf16, w f32) the kernel must move ~203 MB (61 us at 3.35 TB/s).
// Since y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i, the bonus term is
// O(D) a step, and each state element and step needs 5 f32 operations
// (FMA = 2): an FMA for r.S, a product and an FMA for w S + k v^T.  That
// is 5.5 GFLOP, 81 us at the 67 TFLOP/s f32 rate: bounded by operations
// at bf16 r/k/v (by bytes at f32, ~338 MB, 101 us), and by the sequential
// dependence over t.  A chunked form of the recurrence would move most of
// the work into matrix products on the tensor cores and bring the bound
// down to the bytes, but only where those products may round at tf32 or
// bf16; the exact f32 function has no tensor core.
//
// Design.  Output column j depends only on column j of S:
// S_ij <- w_i S_ij + k_i v_j and y_j = sum_i r_i (S_ij + u_i k_i v_j).  So
// one block owns one (b, h) and nothing crosses blocks: no second pass, no
// atomics.  4 threads share a column, each holding D/4 state values of it
// in registers (rows g + 4 ii), and the column's y reduces over the 4
// lanes with two xor shuffles (every lane gets the same bits).  The block
// stages 32 timesteps of r, k, v, w at a time in shared memory as f32 and
// walks them with no barrier; the TPU's sequential chunk axis becomes that
// loop, so the reference's `chunk` changes nothing here.  Any S >= 1.
//
// Left for a later PR: at B*H = 128 blocks one block runs per SM with 8
// warps, so latency is poorly hidden; splitting a head's columns over
// blocks, vector loads of the staged inputs and a chunked (matrix) form of
// the recurrence on the tensor cores are the ways forward.
//
// Interface: plain C functions, bound with ctypes.  Each launches one
// __global__ function on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kG = 4;     // threads per state column
constexpr int kTC = 32;   // timesteps staged in shared memory at a time

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(kG * D)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ sfin, int S) {
  constexpr int R = D / kG;       // state rows per thread
  constexpr int NT = kG * D;      // threads per block
  __shared__ float rs[kTC][D], ks[kTC][D], vs[kTC][D], ws[kTC][D];

  const int bh = blockIdx.x;
  const int j = threadIdx.x / kG;           // state column
  const int g = threadIdx.x % kG;           // rows g + kG * ii
  const long long base = (long long)bh * S * D;

  float st[R], uu[R];
#pragma unroll
  for (int ii = 0; ii < R; ++ii) {
    st[ii] = 0.f;
    uu[ii] = u[(long long)bh * D + g + kG * ii];
  }

  for (int t0 = 0; t0 < S; t0 += kTC) {
    const int n = min(kTC, S - t0);
    __syncthreads();              // the previous chunk is spent
    const long long off = base + (long long)t0 * D;
    for (int e = threadIdx.x; e < n * D; e += NT) {
      const int t = e / D, i = e % D;
      rs[t][i] = to_f32(r[off + e]);
      ks[t][i] = to_f32(k[off + e]);
      vs[t][i] = to_f32(v[off + e]);
      ws[t][i] = w[off + e];
    }
    __syncthreads();

    for (int t = 0; t < n; ++t) {
      const float vj = vs[t][j];
      float acc = 0.f;
#pragma unroll
      for (int ii = 0; ii < R; ++ii) {
        const int i = g + kG * ii;
        const float kv = __fmul_rn(ks[t][i], vj);
        acc = fmaf(rs[t][i], fmaf(uu[ii], kv, st[ii]), acc);
        st[ii] = fmaf(ws[t][i], st[ii], kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (g == 0) store(y + off + (long long)t * D + j, acc);
    }
  }

#pragma unroll
  for (int ii = 0; ii < R; ++ii)
    sfin[(long long)bh * D * D + (g + kG * ii) * D + j] = st[ii];
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, void* y, float* sfin, int BH, int S,
           void* stream) {
  wkv6_kernel<T, D><<<BH, kG * D, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, static_cast<T*>(y), sfin, S);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* w,
             const float* u, void* y, float* sfin, int BH, int S, int D,
             void* stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(r, k, v, w, u, y, sfin, BH, S, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, y, sfin, BH, S, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

API const char* wkv6_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// r, k, v, y (BH, S, D) f32 (bf16 = 0) or bf16 (bf16 = 1); w (BH, S, D)
// and u (BH, D) f32; sfin (BH, D, D) f32; all contiguous; D in {32, 64}.
API int wkv6_fwd(const void* r, const void* k, const void* v, const float* w,
                 const float* u, void* y, float* sfin, int BH, int S, int D,
                 int bf16, void* stream) {
  if (bf16)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, y, sfin, BH, S, D, stream);
  return dispatch<float>(r, k, v, w, u, y, sfin, BH, S, D, stream);
}
