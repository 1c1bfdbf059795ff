// Hand-written Hopper (sm_90a) forward flash attention for the model zoo's
// full-sequence path (prefill): online-softmax attention with grouped kv
// heads, causal and sliding-window masks, f32 accumulation.
//
// It replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/kernel.py:
//
//   flash_attention_bh  (pallas_call at kernel.py:99) -> flash_fwd_kernel
//
// and computes the function of its _attn_kernel (kernel.py:26-76):
// q, k, v widened to f32; s = (q . k) * D**-0.5, the scale applied after
// the dot; masked entries out of the softmax; the row max m and sum l kept
// online with alpha = exp(m_prev - m_cur); out = acc / max(l, 1e-20) cast
// to q's dtype.  Query and key ends are aligned (query row r sits at key
// position r + Sk - Sq, Sq <= Sk).  The kv row of q row bh is bh / group.
//
// What bounds it.  At Llama-3.2-1B's prefill (B=2, S=2048, 32 q heads, 8
// kv heads, D=64, causal, bf16) the live (q, k) pairs need 34 GFLOP of
// products (q.k and p.v) against 42 MB of q, k, v and out: ~800 FLOP per
// byte, so the work is bounded by operations.  On bf16 inputs the least
// time is the tensor cores' (989 TFLOP/s, 35 us).  This kernel multiplies
// in f32 on the CUDA cores (67 TFLOP/s, 0.51 ms at best): it is the simple
// design that is right, not the fast one.
//
// Design.  One block of 256 threads owns one (bh, 64-row q tile).  The q
// tile is widened to f32 into shared memory once; the block then walks the
// 64-row k/v tiles in increasing order, only those inside the causal or
// window wavefront (kernel.py:46-50), staging each k and v tile in shared
// memory as f32.  The 256 threads form a 16 x 16 grid: thread (ty, tx)
// computes the scores of q rows ty + 16 i (i < 4) against keys tx + 16 j
// (j < 4) as 4 x 4 register tiles with float4 reads along D, and holds the
// output rows ty + 16 i at columns tx * D/16 .. + D/16 - 1.  A row's max
// and sum reduce over the 16 lanes that share ty (xor shuffles, which give
// every lane the same bits).  p goes through shared memory to the p.v
// product.  Heavy q tiles (late, under a causal mask) are scheduled first.
//
// Masked entries get p = 0 exactly.  The reference instead computes
// exp(NEG_INF - NEG_INF) = 1 for a row that has met no live key yet and
// wipes it later with alpha = exp(NEG_INF - m) = 0; with Sq <= Sk every
// row has a live key (its own position), so both give the same result.  A
// ragged tail (S not a multiple of 64) is masked here, so any S >= 1 works;
// q rows past Sq are computed on zeros and never stored.
//
// Left for a later PR: bf16 tensor-core products (wgmma, 64-row tiles),
// TMA loads into a ring of k/v tiles, a persistent grid.
//
// Interface: plain C functions, bound with ctypes.  Each launches one
// __global__ function on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kBQ = 64;           // q rows per block
constexpr int kBK = 64;           // k rows per tile
constexpr int kThreads = 256;     // 16 x 16
constexpr int kLS = kBK + 4;      // padded row stride of the p tile
// -0.7 * f32 max rounded to f32, the reference's NEG_INF
constexpr float kNegInf = -2.381976325e+38f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// rows [row0, row0 + 64) of a (rows, D) matrix -> f32 tile with row stride
// LD in shared memory; rows at or past `rows` are zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows) {
  constexpr int LD = D + 4;
  constexpr int C4 = D / 4;
  for (int e = threadIdx.x; e < kBK * C4; e += kThreads) {
    const int r = e / C4, c = (e % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) x = load4(src + (long long)(row0 + r) * D + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = x;
  }
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int group, int causal, int window, float scale) {
  constexpr int LD = D + 4;       // padded row stride of the q, k, v tiles
  constexpr int DJ = D / 16;      // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LD;
  float* Vs = Ks + kBK * LD;
  float* Ps = Vs + kBK * LD;      // [kBQ][kLS]

  const int nq = gridDim.x;
  const int qt = nq - 1 - blockIdx.x;       // heavy (late) tiles first
  const int bh = blockIdx.y;
  const int q0 = qt * kBQ;
  const int off = Sk - Sq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  const T* qb = q + (long long)bh * Sq * D;
  const T* kb = k + (long long)(bh / group) * Sk * D;
  const T* vb = v + (long long)(bh / group) * Sk * D;

  load_tile<T, D>(Qs, qb, q0, Sq);

  // the k tiles inside the wavefront of this q tile's live rows
  const int q_first = q0 + off;
  const int q_last = min(q0 + kBQ, Sq) - 1 + off;
  const int nk = (Sk + kBK - 1) / kBK;
  int j_lo = 0, j_hi = nk - 1;
  if (causal) j_hi = min(j_hi, q_last / kBK);
  if (window > 0) j_lo = max(0, q_first - window + 1) / kBK;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DJ; ++c) acc[i][c] = 0.f;
  }

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k0 = jt * kBK;
    __syncthreads();              // the previous tile's k, v, p are spent
    load_tile<T, D>(Ks, kb, k0, Sk);
    load_tile<T, D>(Vs, vb, k0, Sk);
    __syncthreads();

    // s = q . k for rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // mask, online max and sum; p to shared memory
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i + off;
      bool live[4];
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        live[j] = kp < Sk && (!causal || kp <= qp) &&
                  (window <= 0 || qp - kp < window);
        s[i][j] = __fmul_rn(s[i][j], scale);
        if (live[j]) mx = fmaxf(mx, s[i][j]);
      }
      mx = row_max16(mx);
      alpha[i] = expf(m[i] - mx);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live[j] ? expf(s[i][j] - mx) : 0.f;
        Ps[(ty + 16 * i) * kLS + tx + 16 * j] = p;
        rs += p;
      }
      rs = row_sum16(rs);
      l[i] = fmaf(l[i], alpha[i], rs);
      m[i] = mx;
    }
    __syncthreads();

    // acc = acc * alpha + p . v
    float pv[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DJ; ++c) pv[i][c] = 0.f;
#pragma unroll 2
    for (int c4 = 0; c4 < kBK; c4 += 4) {
      float p[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 pp =
            *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * kLS + c4);
        p[i][0] = pp.x; p[i][1] = pp.y; p[i][2] = pp.z; p[i][3] = pp.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DJ];
        const float* vrow = Vs + (c4 + cc) * LD + tx * DJ;
        if constexpr (DJ % 4 == 0) {
#pragma unroll
          for (int c = 0; c < DJ; c += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + c);
            vv[c] = x.x; vv[c + 1] = x.y; vv[c + 2] = x.z; vv[c + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int c = 0; c < DJ; c += 2) {
            const float2 x = *reinterpret_cast<const float2*>(vrow + c);
            vv[c] = x.x; vv[c + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < DJ; ++c) pv[i][c] = fmaf(p[i][cc], vv[c], pv[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < DJ; ++c) acc[i][c] = fmaf(acc[i][c], alpha[i], pv[i][c]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* orow = o + ((long long)bh * Sq + r) * D + tx * DJ;
#pragma unroll
    for (int c = 0; c < DJ; ++c) store(orow + c, __fdiv_rn(acc[i][c], denom));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int group, int causal, int window, float scale,
           void* stream) {
  constexpr int LD = D + 4;
  constexpr int smem = (kBQ * LD + 2 * kBK * LD + kBQ * kLS) * 4;
  // set on every launch: the attribute is per device, and the call costs
  // far less than the kernel
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((Sq + kBQ - 1) / kBQ), (unsigned)BH);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, group, causal,
      window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int BH,
             int Sq, int Sk, int D, int group, int causal, int window,
             float scale, void* stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, BH, Sq, Sk, group, causal, window,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, BH, Sq, Sk, group, causal, window,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, BH, Sq, Sk, group, causal, window,
                            scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

API const char* flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// q (BH, Sq, D), k and v (BH / group, Sk, D), o (BH, Sq, D), all
// contiguous, 16-byte aligned, f32 (bf16 = 0) or bf16 (bf16 = 1);
// D in {32, 64, 128}; 1 <= Sq <= Sk; BH <= 65535.
API int flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, int BH, int Sq, int Sk, int D,
                            int group, int causal, int window, float scale,
                            int bf16, void* stream) {
  if (bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, BH, Sq, Sk, D, group, causal,
                                   window, scale, stream);
  return dispatch<float>(q, k, v, o, BH, Sq, Sk, D, group, causal, window,
                         scale, stream);
}
