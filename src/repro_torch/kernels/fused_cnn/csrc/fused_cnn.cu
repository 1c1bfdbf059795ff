// Hand-written Hopper (sm_90a) kernels for the fused CNN training step of
// the OPT-HSFL simulation: one SGD step of the paper's 5-layer CNN, for a
// whole cohort of K users or for one user, in f32 or bf16.
//
// They replace the eight fused-CNN Pallas TPU kernels of
// src/repro/kernels/fused_cnn/kernel.py:
//
//   conv_pool_fwd_k  (pallas_call at kernel.py:291) -> conv_pool_fwd_kernel
//   conv_pool_bwd_k  (pallas_call at kernel.py:357) -> conv_bwd_partial_kernel
//                                                    + conv_bwd_finish_kernel
//   fc_chain_fwd_k   (pallas_call at kernel.py:398) -> fc_fwd_kernel
//   fc_chain_bwd_k   (pallas_call at kernel.py:441) -> fc_bwd_kernel
//   conv_pool_fwd    (pallas_call at kernel.py:117) \
//   conv_pool_bwd    (pallas_call at kernel.py:159)  | the same kernels at
//   fc_chain_fwd     (pallas_call at kernel.py:188)  | K = 1, through the
//   fc_chain_bwd     (pallas_call at kernel.py:224) /  fcnn_user_* entries
//
// The single-user kernels are the batch_users=False baseline: launched once
// per user slot, K launches where the blocked path makes one.  The blocked
// body at one user is the same contraction, so both share the device code.
//
// What bounds them.  At the paper's shapes (K=10 users, batch B=10, 28x28x1
// images) every kernel does well under a MFLOP per user and moves a few MB:
// the im2col patches and the pool tie mask are most of the bytes, so each
// kernel is bounded by memory traffic (H100 SXM: 3.35 TB/s; a few
// microseconds each), far from the 67 TFLOP/s f32 peak.  In practice a
// launch of a few microseconds is dominated by launch latency, and the
// round by the host loop around its 192 training launches (8 per SGD step;
// 1920 through the single-user kernels at K=10).  The fc forward and
// backward are each one launch that spreads a cohort over many SMs
// (fc_fwd_kernel, fc_bwd_kernel below): layer 1's 784-long sums are
// sequential chains, so their latency, not the card's rate, bounds them.
//
// Design.  The TPU kernels walk a sequential grid over user tiles and keep
// a whole user's layer in VMEM; here blocks run in parallel in no order, so
// - every output element is owned by exactly one thread and every sum is
//   taken in a fixed order: no float atomics (the fc forward's one integer
//   atomic only picks which block runs its last two layers), results are
//   identical run to run;
// - reductions across blocks (dW over B*H*W rows) go through a second
//   launch over per-block partial sums;
// - the conv product z is summed tap by tap in (i, j, c) order with
//   __fmul_rn/__fadd_rn, which the compiler never contracts into an FMA.
//   The plain PyTorch twin (ref.py) sums the same way, so tied pool maxima
//   (zero backgrounds, constant images) are found identically and the
//   1/count tie mask agrees bit for bit;
// - SAME padding is implicit: out-of-range taps are skipped, no padded copy
//   of the image is made;
// - the image gradient dx is a gather (each input pixel sums its 9 taps in
//   (i, j) order), not the padded-canvas scatter-add of the TPU kernel.
//
// Compute dtype.  Every kernel is a template on the compute type T, float
// or __nv_bfloat16.  Products accumulate in f32 in the same order at both
// types, and the grads of the weights and biases are written in f32.  At
// bf16 a value rounds to T (__float2bfloat16_rn, nearest even, as XLA's
// convert) where ref.py's docstring says the reference rounds: z once after
// its f32 sum, pre = T(pz + b), eq = T(1/count), dz = T(eq * dp), each fc
// product before its bias add, each dx tap before the fold adds it.  A
// product of two bf16 values is exact in f32, so fmaf and a separate
// multiply and add agree there.  rnd<float> is the identity, so the f32
// instantiation rounds nowhere but in its f32 operations.
// Weights in shared memory take half the bytes at bf16.  FMA code on the
// CUDA cores (the fc forward stages with TMA); the tensor cores are left
// for later work.
//
// Interface: plain C functions, bound with ctypes.  Each launches one
// __global__ function on the given stream and returns cudaGetLastError().
// The last int argument selects the compute type (0 = f32, 1 = bf16).

#include <cuda.h>          // CUtensorMap and its enums only; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#define API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kThreads = 256;
constexpr int kFcThreads = 128;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float f(float v) { return v; }
__device__ __forceinline__ float f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T to(float v);
template <>
__device__ __forceinline__ float to<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 to<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// round an f32 value to T and back: the identity at f32
template <typename T>
__device__ __forceinline__ float rnd(float v) { return f(to<T>(v)); }

inline int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// conv_pool_fwd: patches + product + 2x2 max pool + bias + ReLU (pool first)
// x (K,B,H,W,C), w (K,9C,O), bias (K,O) -> a (K,B,H/2,W/2,O);
// residuals pat (K,B*H*W,9C), eq (K,B,H,W,O), relu_m (K,B,H/2,W/2,O).
// One thread per pooled output (k, b, ph, pw, o); o is fastest, so the
// threads of a window share their image reads.  The user's weights sit in
// shared memory.  grid = (ceil(B*PH*PW*O / 256), K).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_pool_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ a,
                     T* __restrict__ pat, T* __restrict__ eq,
                     T* __restrict__ relu_m, int B, int H, int W, int C,
                     int O, int write_res) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.y;
  const int P = 9 * C;
  T* ws = reinterpret_cast<T*>(smem_raw);  // (P, O)
  T* bs = ws + P * O;                      // (O,)
  const T* wk = w + (size_t)k * P * O;
  for (int i = threadIdx.x; i < P * O; i += blockDim.x) ws[i] = wk[i];
  for (int i = threadIdx.x; i < O; i += blockDim.x)
    bs[i] = bias[(size_t)k * O + i];
  __syncthreads();

  const int PH = H / 2, PW = W / 2;
  const long long total = (long long)B * PH * PW * O;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int o = (int)(t % O);
  long long r = t / O;
  const int pw = (int)(r % PW);
  r /= PW;
  const int ph = (int)(r % PH);
  const int bb = (int)(r / PH);
  const T* xb = x + ((size_t)k * B + bb) * H * W * C;

  float z[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yy = 2 * ph + (q >> 1), xx = 2 * pw + (q & 1);
    float acc = 0.f;
    for (int i = 0; i < 3; ++i) {
      const int sy = yy + i - 1;
      if (sy < 0 || sy >= H) continue;
      for (int j = 0; j < 3; ++j) {
        const int sx = xx + j - 1;
        if (sx < 0 || sx >= W) continue;
        const T* xp = xb + ((size_t)sy * W + sx) * C;
        const T* wp = ws + (i * 3 + j) * C * O + o;
        for (int c = 0; c < C; ++c)
          acc = __fadd_rn(acc, __fmul_rn(f(xp[c]), f(wp[c * O])));
      }
    }
    z[q] = rnd<T>(acc);
  }
  const float pz = fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
  const float pre = rnd<T>(__fadd_rn(pz, f(bs[o])));
  const size_t pidx = ((((size_t)k * B + bb) * PH + ph) * PW + pw) * O + o;
  a[pidx] = to<T>(fmaxf(pre, 0.f));
  if (!write_res) return;
  relu_m[pidx] = to<T>(pre > 0.f ? 1.f : 0.f);

  int cnt = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) cnt += z[q] == pz;
  const float inv = rnd<T>(__fdiv_rn(1.f, (float)cnt));
  const size_t row0 = (size_t)k * B * H * W + (size_t)bb * H * W;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yy = 2 * ph + (q >> 1), xx = 2 * pw + (q & 1);
    eq[(row0 + (size_t)yy * W + xx) * O + o] = to<T>(z[q] == pz ? inv : 0.f);
  }
  // the window's 4 patch rows (4*P values), spread over its O threads
  for (int e = o; e < 4 * P; e += O) {
    const int q = e / P, p = e % P;
    const int tap = p / C, c = p % C;
    const int yy = 2 * ph + (q >> 1), xx = 2 * pw + (q & 1);
    const int sy = yy + tap / 3 - 1, sx = xx + tap % 3 - 1;
    const bool in = sy >= 0 && sy < H && sx >= 0 && sx < W;
    pat[(row0 + (size_t)yy * W + xx) * P + p] =
        in ? xb[((size_t)sy * W + sx) * C + c] : to<T>(0.f);
  }
}

// ---------------------------------------------------------------------------
// conv_pool_bwd, pass 1: dz = eq * (da * relu_m) upsampled, and per-chunk
// partial sums of dW = pat^T dz (f32) over R rows of the M = B*H*W patch
// rows.  grid = (nchunks, K).  dz is also written out for pass 2's dx
// gather.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bwd_partial_kernel(const T* __restrict__ pat, const T* __restrict__ eq,
                        const T* __restrict__ relu_m,
                        const T* __restrict__ da, T* __restrict__ dz,
                        float* __restrict__ part, int B, int H, int W, int C,
                        int O, int R, int nchunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.y, chunk = blockIdx.x;
  const int P = 9 * C, M = B * H * W;
  const int m0 = chunk * R;
  const int rows = min(R, M - m0);
  T* ps = reinterpret_cast<T*>(smem_raw);  // (R, P)
  T* zs = ps + R * P;                      // (R, O)
  const T* pk = pat + ((size_t)k * M + m0) * P;
  for (int i = threadIdx.x; i < rows * P; i += blockDim.x) ps[i] = pk[i];
  const int PH = H / 2, PW = W / 2;
  for (int i = threadIdx.x; i < rows * O; i += blockDim.x) {
    const int o = i % O, m = m0 + i / O;
    const int xx = m % W, yy = (m / W) % H, bb = m / (H * W);
    const size_t pi =
        ((((size_t)k * B + bb) * PH + yy / 2) * PW + xx / 2) * O + o;
    const float dp = rnd<T>(__fmul_rn(f(da[pi]), f(relu_m[pi])));
    const size_t zi = ((size_t)k * M + m) * O + o;
    const T v = to<T>(__fmul_rn(f(eq[zi]), dp));
    zs[i] = v;
    dz[zi] = v;
  }
  __syncthreads();
  float* out = part + ((size_t)k * nchunks + chunk) * P * O;
  for (int idx = threadIdx.x; idx < P * O; idx += blockDim.x) {
    const int p = idx / O, o = idx % O;
    float acc = 0.f;
    for (int r = 0; r < rows; ++r)
      acc = fmaf(f(ps[r * P + p]), f(zs[r * O + o]), acc);
    out[idx] = acc;
  }
}

// ---------------------------------------------------------------------------
// conv_pool_bwd, pass 2.  Blocks [0, K): dW[k] = sum of the chunk partials
// in chunk order, and db[k] = sum of da*relu_m over the pooled positions
// (a per-channel strided sum, then a fixed-order sum of the strides), both
// f32.  Blocks [K, ...): dx gather, one thread per input element
// (k,b,y,x,c): dx = sum over the 9 taps (i,j) of
// T(dz[pixel (y+1-i, x+1-j)] . W[(i,j,c), :]), rounding to T after each add.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv_bwd_finish_kernel(const float* __restrict__ part,
                       const T* __restrict__ dz, const T* __restrict__ da,
                       const T* __restrict__ relu_m, const T* __restrict__ w,
                       float* __restrict__ dw, float* __restrict__ db,
                       T* __restrict__ dx, int K, int B, int H, int W, int C,
                       int O, int nchunks) {
  __shared__ float red[kThreads];
  const int P = 9 * C;
  if ((int)blockIdx.x < K) {
    const int k = blockIdx.x;
    const float* pk = part + (size_t)k * nchunks * P * O;
    for (int idx = threadIdx.x; idx < P * O; idx += blockDim.x) {
      float acc = 0.f;
      for (int c = 0; c < nchunks; ++c)
        acc = __fadd_rn(acc, pk[(size_t)c * P * O + idx]);
      dw[(size_t)k * P * O + idx] = acc;
    }
    const int G = blockDim.x / O;
    const int NP = B * (H / 2) * (W / 2);
    const int o = threadIdx.x % O, g = threadIdx.x / O;
    float s = 0.f;
    if (g < G) {
      for (int p = g; p < NP; p += G) {
        const size_t i = ((size_t)k * NP + p) * O + o;
        s = __fadd_rn(s, rnd<T>(__fmul_rn(f(da[i]), f(relu_m[i]))));
      }
    }
    red[threadIdx.x] = s;
    __syncthreads();
    if ((int)threadIdx.x < O) {
      float tot = 0.f;
      for (int gg = 0; gg < G; ++gg) tot = __fadd_rn(tot, red[gg * O + threadIdx.x]);
      db[(size_t)k * O + threadIdx.x] = tot;
    }
    return;
  }
  if (dx == nullptr) return;
  const long long t = (long long)(blockIdx.x - K) * blockDim.x + threadIdx.x;
  if (t >= (long long)K * B * H * W * C) return;
  const int c = (int)(t % C);
  long long r = t / C;
  const int xx = (int)(r % W);
  r /= W;
  const int yy = (int)(r % H);
  r /= H;
  const int bb = (int)(r % B);
  const int k = (int)(r / B);
  const size_t M = (size_t)B * H * W;
  const T* wk = w + (size_t)k * P * O;
  float acc = 0.f;
  for (int tap = 0; tap < 9; ++tap) {
    const int sy = yy + 1 - tap / 3, sx = xx + 1 - tap % 3;
    if (sy < 0 || sy >= H || sx < 0 || sx >= W) continue;
    const T* zr = dz + ((size_t)k * M + ((size_t)bb * H + sy) * W + sx) * O;
    const T* wr = wk + (size_t)(tap * C + c) * O;
    float d = 0.f;
    for (int o = 0; o < O; ++o) d = fmaf(f(zr[o]), f(wr[o]), d);
    acc = rnd<T>(__fadd_rn(acc, rnd<T>(d)));
  }
  dx[t] = to<T>(acc);
}

// ---------------------------------------------------------------------------
// fc_chain_bwd, one launch.  grid = (nt + 1, K), 256 threads.  Every block
// first copies its user's W3, W2 and g into shared memory (cp.async, all
// in flight at once, rows padded so that the 4-wide reads of neighbouring
// lanes hit neighbouring banks) and recomputes dh2 = (g W3^T) * (h2 > 0)
// and dh1 = (dh2 W2^T) * (h1 > 0) there: ~90k FMAs, cheaper than a second
// launch.  Then block x < nt owns a slice of ft columns f of F: dW1[f, :] =
// sum_b x[b, f] dh1[b, :] (a thread per column j, the contiguous axis of
// dW1) and dx[:, f] = dh1 W1[f, :]^T (the slice's W1 rows copied in, a
// thread per f); block nt owns dW2, dW3 and db1..3.  Every sum runs over
// its index in ascending order, as the two-launch version of this kernel
// did, so the tiling (nt, ft) changes no bit and the result is the same
// on every run.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// elements of T in one 4-byte word
template <typename T>
constexpr int kWord = 4 / (int)sizeof(T);

// staged rows are padded by 4 elements: 4-wide reads of neighbouring rows
// (16 bytes at f32, 8 at bf16) then hit neighbouring banks
constexpr int kPad = 4;

// start copying rows x cols of src (row stride sld) into dst (row stride
// ld), 4 bytes per cp.async, a thread per word column; cols, sld and the
// offsets are whole words
template <typename T>
__device__ __forceinline__ void stage(T* dst, int ld, const T* src, int sld,
                                      int rows, int cols) {
  const int cw = cols / kWord<T>;
  const int per = kThreads / cw;
  if ((int)threadIdx.x >= per * cw) return;
  const int c = (threadIdx.x % cw) * kWord<T>;
  for (int r = threadIdx.x / cw; r < rows; r += per)
    cp_async4(dst + r * ld + c, src + (size_t)r * sld + c);
}

// four consecutive elements of a staged row, widened to f32 (16-byte
// aligned at f32, 8-byte at bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]);
  const float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

// acc[u] += sum_i a[u][i] w[i] for i < I in ascending order, U rows of a
// (row offsets ra[u]) against one row w, 4 elements a read when I % 4 == 0
template <int U, typename T>
__device__ __forceinline__ void dot_rows(float (&acc)[U], const T* a,
                                         const int (&ra)[U], const T* w,
                                         int I) {
  if (I % 4 == 0) {
    for (int i = 0; i < I; i += 4) {
      const float4 wv = load4(w + i);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float4 av = load4(a + ra[u] + i);
        acc[u] = fmaf(av.x, wv.x, acc[u]);
        acc[u] = fmaf(av.y, wv.y, acc[u]);
        acc[u] = fmaf(av.z, wv.z, acc[u]);
        acc[u] = fmaf(av.w, wv.w, acc[u]);
      }
    }
  } else {
    for (int i = 0; i < I; ++i) {
      const float wv = f(w[i]);
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = fmaf(f(a[ra[u] + i]), wv, acc[u]);
    }
  }
}

// out[b, j] = T(T(sum_i a[b, i] w[j, i]) * (h[b, j] > 0)) for b < B, j < N:
// a (B x I), w (N rows at stride lw) and h (B x N) in shared memory.  A
// thread owns column j and rows bq, bq + per, ... (per = threads per
// column), U sums in flight.
template <int U, typename T>
__device__ __forceinline__ void masked_product(const T* a, int I, const T* w,
                                               int lw, int N, const T* h,
                                               T* out, int B) {
  const int per = kThreads / N;
  if ((int)threadIdx.x >= per * N) return;
  const int j = threadIdx.x % N;
  for (int b0 = threadIdx.x / N; b0 < B; b0 += per * U) {
    float acc[U];
    int ra[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[u] = 0.f;
      ra[u] = min(b0 + u * per, B - 1) * I;
    }
    dot_rows<U>(acc, a, ra, w + j * lw, I);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = b0 + u * per;
      if (b >= B) break;
      const bool live = f(h[b * N + j]) > 0.f;
      out[b * N + j] = to<T>(__fmul_rn(rnd<T>(acc[u]), live ? 1.f : 0.f));
    }
  }
}

// out[r, c] = sum_b a[b * lda + r] bm[b * ldb + c] (f32) for r < R, c < C,
// out rows at stride C.  A thread owns column c and rows rq, rq + per, ...
template <int U, typename T>
__device__ __forceinline__ void batch_outer(const T* a, int lda, int R,
                                            const T* bm, int ldb, int C,
                                            int B, float* __restrict__ out) {
  const int per = kThreads / C;
  if ((int)threadIdx.x >= per * C) return;
  const int c = threadIdx.x % C;
  for (int r0 = threadIdx.x / C; r0 < R; r0 += per * U) {
    float acc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = 0.f;
    for (int b = 0; b < B; ++b) {
      const float bv = f(bm[b * ldb + c]);
#pragma unroll
      for (int u = 0; u < U; ++u)
        acc[u] = fmaf(f(a[b * lda + min(r0 + u * per, R - 1)]), bv, acc[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = r0 + u * per;
      if (r >= R) break;
      out[(size_t)r * C + c] = acc[u];
    }
  }
}

// the shared-memory regions of fc_bwd_kernel, in elements of T, each
// start a whole number of 8 elements (16-byte aligned at either dtype)
__host__ __device__ inline int up(int n) { return (n + 7) / 8 * 8; }

struct FcBwdSmem {
  int w3, w2, g, h1, h2, d2, d1, w1, xs, total;
  __host__ __device__ FcBwdSmem(int B, int D1, int D2, int D3, int ft) {
    w3 = 0;
    w2 = w3 + up(D2 * (D3 + kPad));
    g = w2 + up(D1 * (D2 + kPad));
    h1 = g + up(B * D3);
    h2 = h1 + up(B * D1);
    d2 = h2 + up(B * D2);
    d1 = d2 + up(B * D2);
    w1 = d1 + up(B * D1);
    xs = w1 + up(ft * (D1 + kPad));
    total = xs + up(B * ft);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fc_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
              const T* __restrict__ h1, const T* __restrict__ h2,
              const T* __restrict__ w1, const T* __restrict__ w2,
              const T* __restrict__ w3, float* __restrict__ dw1,
              float* __restrict__ db1, float* __restrict__ dw2,
              float* __restrict__ db2, float* __restrict__ dw3,
              float* __restrict__ db3, T* __restrict__ dx, int B, int F,
              int D1, int D2, int D3, int ft) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.y;
  const bool grads = blockIdx.x == gridDim.x - 1;  // dW2, dW3, db
  const int f0 = blockIdx.x * ft;
  const int nf = grads ? 0 : min(ft, F - f0);
  const int l1 = D1 + kPad, l2 = D2 + kPad, l3 = D3 + kPad;  // row strides
  const FcBwdSmem at(B, D1, D2, D3, ft);
  T* base = reinterpret_cast<T*>(smem_raw);
  T* w3s = base + at.w3;    // (D2, l3)
  T* w2s = base + at.w2;    // (D1, l2)
  T* gs = base + at.g;      // (B, D3)
  T* h1s = base + at.h1;    // (B, D1)
  T* h2s = base + at.h2;    // (B, D2)
  T* d2s = base + at.d2;    // (B, D2)
  T* d1s = base + at.d1;    // (B, D1)
  T* w1s = base + at.w1;    // (ft, l1), a slice block
  T* xs = base + at.xs;     // (B, ft), a slice block

  const size_t row = (size_t)k * B;
  stage(w3s, l3, w3 + (size_t)k * D2 * D3, D3, D2, D3);
  stage(w2s, l2, w2 + (size_t)k * D1 * D2, D2, D1, D2);
  stage(gs, D3, g + row * D3, D3, B, D3);
  stage(h1s, D1, h1 + row * D1, D1, B, D1);
  stage(h2s, D2, h2 + row * D2, D2, B, D2);
  if (!grads) {
    stage(w1s, l1, w1 + ((size_t)k * F + f0) * D1, D1, nf, D1);
    stage(xs, ft, x + row * F + f0, F, B, nf);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  masked_product<4>(gs, D3, w3s, l3, D2, h2s, d2s, B);
  __syncthreads();
  masked_product<8>(d2s, D2, w2s, l2, D1, h1s, d1s, B);
  __syncthreads();

  if (grads) {
    // dW2[i, j] = sum_b h1[b, i] dh2[b, j]; dW3[i, c] = sum_b h2[b, i] g[b, c]
    batch_outer<8>(h1s, D1, D1, d2s, D2, D2, B, dw2 + (size_t)k * D1 * D2);
    batch_outer<8>(h2s, D2, D2, gs, D3, D3, B, dw3 + (size_t)k * D2 * D3);
    // bias grads: column sums over the batch, a thread per column
    for (int t = threadIdx.x; t < D1 + D2 + D3; t += kThreads) {
      const T* src = t < D1 ? d1s : t < D1 + D2 ? d2s : gs;
      float* dst = t < D1 ? db1 + (size_t)k * D1
                          : t < D1 + D2 ? db2 + (size_t)k * D2
                                        : db3 + (size_t)k * D3;
      const int D = t < D1 ? D1 : t < D1 + D2 ? D2 : D3;
      const int j = t < D1 ? t : t < D1 + D2 ? t - D1 : t - D1 - D2;
      float acc = 0.f;
      for (int b = 0; b < B; ++b) acc = __fadd_rn(acc, f(src[b * D + j]));
      dst[j] = acc;
    }
    return;
  }

  // dW1[f0 + r, j] = sum_b x[b, f0 + r] dh1[b, j]
  batch_outer<8>(xs, ft, nf, d1s, D1, D1, B,
                 dw1 + ((size_t)k * F + f0) * D1);
  // dx[b, f0 + r] = T(sum_j dh1[b, j] W1[f0 + r, j]): a thread owns r and
  // rows bq, bq + per, ...
  constexpr int U = 4;
  const int per = kThreads / ft;
  const int r = threadIdx.x % ft;
  if ((int)threadIdx.x >= per * ft || r >= nf) return;
  for (int b0 = threadIdx.x / ft; b0 < B; b0 += per * U) {
    float acc[U];
    int ra[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[u] = 0.f;
      ra[u] = min(b0 + u * per, B - 1) * D1;
    }
    dot_rows<U>(acc, d1s, ra, w1s + r * l1, D1);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int b = b0 + u * per;
      if (b >= B) break;
      dx[(row + b) * F + f0 + r] = to<T>(acc[u]);
    }
  }
}

// ---------------------------------------------------------------------------
// fc_chain_fwd, one launch: h1 = relu(x W1 + b1), h2 = relu(h1 W2 + b2),
// out = h2 W3 + b3, saving h1 and h2.  grid = (nct, nrt, K), 128 threads;
// the wrapper picks the tile (rows <= 16 batch rows, cols <= 16 columns of
// D1; kernel.py fc_fwd_tiling).  Block (c, t, k) computes layer 1 for the
// rows of row tile t of user k and the D1 columns of column tile c, a
// thread holding two rows of one column: it streams F in chunks of kFc
// through a ring of kFcStages stages in shared memory, each chunk of its
// x rows and of its W1 slice one TMA box (3-D tensor maps over x and W1,
// thread 0 issuing, an mbarrier a stage); where a row is no whole 16
// bytes, with cp.async instead.  It writes its h1 tile, and the last of
// the nct blocks of (k, t) to finish (a counter per (k, t) in global
// memory, the last block sets it back to 0) copies the tile's whole h1
// rows (cp.async, through L2), W2 and W3 (a TMA bulk copy each) in and
// runs layers 2 and 3 for those rows.  Every output sums over its input
// index in ascending order, one fmaf per term, then rounds to T and adds
// its bias as the one-block-per-row-tile version of this kernel did, so
// the bits are that version's and the same on every run (the counter only
// picks which block runs the small layers).
// ---------------------------------------------------------------------------

constexpr int kFc = 128;        // F per staged chunk
constexpr int kFcStages = 3;    // chunks in the ring
constexpr int kFcMaxRows = 16;  // batch rows of a tile
constexpr int kFcMaxCols = 16;  // D1 columns of a tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// spin until the barrier's phase of this parity has completed; a wait that
// never ends (a pipeline fault) traps, so the launch fails instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  for (unsigned polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

// one box of a 3-D tensor map into shared memory (128-byte aligned),
// reported to the mbarrier `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         unsigned bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// one contiguous run of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory by the TMA unit, reported to the
// mbarrier `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 ldcg(const bf16* p) {
  return __ushort_as_bfloat16(
      __ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// copy rows x cols of src (row stride sld, global) to dst (row stride ld,
// shared) with the block's threads: 16-byte cp.async.cg where every row
// starts on 16 bytes and is whole 16-byte pieces, else element by element.
// Both read through L2 only (h1, which other blocks of this launch write,
// cannot hit a stale line in L1) and are visible after the next
// __syncthreads once waited for
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int ld, const T* src,
                                           int sld, int rows, int cols) {
  constexpr int V = 16 / (int)sizeof(T);
  const bool vec = cols % V == 0 && ld % V == 0 && sld % V == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const int step = vec ? V : 1;
  const int pieces = cols / step;
  // a thread keeps one piece of a row and walks the rows, `per` at a time
  const int per = max(1, (int)blockDim.x / pieces);
  for (int p0 = 0; p0 < pieces; p0 += blockDim.x) {
    const int p = p0 + (int)threadIdx.x % min(pieces, (int)blockDim.x);
    const int r0 = (int)threadIdx.x / min(pieces, (int)blockDim.x);
    if (p >= pieces || r0 >= per) continue;
    for (int r = r0; r < rows; r += per) {
      T* d = dst + r * ld + p * step;
      const T* sp = src + (size_t)r * sld + p * step;
      if (vec)
        cp_async16(d, sp);
      else
        *d = ldcg(sp);
    }
  }
}

// the x rows of the ring are padded by 16 bytes, so the two rows that a
// warp reads at once fall on different banks
template <typename T>
constexpr int kFcLdx = kFc + 16 / (int)sizeof(T);

template <typename T>
constexpr int kFcStage = kFcMaxRows * kFcLdx<T> + kFc * kFcMaxCols;

// out[r, j] = T(T(sum_i a[r, i] w[i, j]) + b[j]) (ReLU'd if relu) for r <
// rows, j < N: a (rows x I) in shared memory, w (I x N) in shared or
// global memory.  A thread owns column j and rows rq, rq + per, ... (U of
// them), reading 4 elements of a row at once where I allows
template <int U, typename T>
__device__ __forceinline__ void dense_tail(const T* a, int I, const T* w,
                                           const T* __restrict__ b, int N,
                                           bool relu, T* out_s,
                                           T* __restrict__ out_g, int rows) {
  const int cols = min(N, kFcThreads);
  const int per = kFcThreads / cols;
  const int rq = threadIdx.x / cols;
  if (rq >= per) return;
  for (int j = threadIdx.x % cols; j < N; j += cols) {
    float acc[U];
    const T* ar[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      acc[u] = 0.f;
      ar[u] = a + min(rq + u * per, rows - 1) * I;
    }
    int i = 0;
    if (I % 4 == 0) {
#pragma unroll 4
      for (; i < I; i += 4) {
        const float w0 = f(w[(size_t)i * N + j]);
        const float w1 = f(w[(size_t)(i + 1) * N + j]);
        const float w2 = f(w[(size_t)(i + 2) * N + j]);
        const float w3 = f(w[(size_t)(i + 3) * N + j]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float4 av = load4(ar[u] + i);
          acc[u] = fmaf(av.x, w0, acc[u]);
          acc[u] = fmaf(av.y, w1, acc[u]);
          acc[u] = fmaf(av.z, w2, acc[u]);
          acc[u] = fmaf(av.w, w3, acc[u]);
        }
      }
    }
    for (; i < I; ++i) {
      const float wv = f(w[(size_t)i * N + j]);
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = fmaf(f(ar[u][i]), wv, acc[u]);
    }
    const float bj = f(b[j]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = rq + u * per;
      if (r >= rows) break;
      float v = rnd<T>(__fadd_rn(rnd<T>(acc[u]), bj));
      if (relu) v = fmaxf(v, 0.f);
      if (out_s) out_s[r * N + j] = to<T>(v);
      out_g[(size_t)r * N + j] = to<T>(v);
    }
  }
}

// dense_tail with U = the chains a thread needs, rounded up to 1, 2, 4,
// 8 or 16 (rows <= 16)
template <typename T>
__device__ __forceinline__ void dense_tail_any(const T* a, int I, const T* w,
                                               const T* __restrict__ b, int N,
                                               bool relu, T* out_s,
                                               T* __restrict__ out_g,
                                               int rows) {
  const int per = kFcThreads / min(N, kFcThreads);
  const int need = (rows + per - 1) / per;
  if (need <= 1)
    dense_tail<1>(a, I, w, b, N, relu, out_s, out_g, rows);
  else if (need <= 2)
    dense_tail<2>(a, I, w, b, N, relu, out_s, out_g, rows);
  else if (need <= 4)
    dense_tail<4>(a, I, w, b, N, relu, out_s, out_g, rows);
  else if (need <= 8)
    dense_tail<8>(a, I, w, b, N, relu, out_s, out_g, rows);
  else
    dense_tail<16>(a, I, w, b, N, relu, out_s, out_g, rows);
}

// the regions of the tail (layers 2 and 3), in elements of T, over the
// ring once layer 1 is done: the h1 and h2 rows, then W2 and W3 where
// they fit (`staged`; else the tail reads them from global memory)
struct FcTail {
  int h1, h2, w2, w3, total, total_unstaged;
  __host__ __device__ FcTail(int rows, int D1, int D2, int D3) {
    h1 = 0;
    h2 = h1 + up(rows * D1);
    total_unstaged = h2 + up(rows * D2);
    w2 = total_unstaged;
    w3 = w2 + up(D1 * D2);
    total = w3 + up(D2 * D3);
  }
};

template <typename T>
__global__ void __launch_bounds__(kFcThreads)
fc_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
              const T* __restrict__ b1, const T* __restrict__ w2,
              const T* __restrict__ b2, const T* __restrict__ w3,
              const T* __restrict__ b3, T* __restrict__ out,
              T* __restrict__ h1, T* __restrict__ h2,
              int* __restrict__ counters, int B, int F, int D1, int D2,
              int D3, int rt, int ct, int staged, int tma,
              const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 128-byte aligned, as the TMA unit writes boxes
  T* base = reinterpret_cast<T*>(
      smem_raw + ((128 - smem_u32(smem_raw) % 128) % 128));
  // x rows in the ring: padded by 16 bytes for cp.async, dense as TMA
  // writes its box
  const int ldx = tma ? kFc : kFcLdx<T>;
  const int k = blockIdx.z, tile = blockIdx.y;
  const int r0 = tile * rt, rows = min(rt, B - r0);
  const int j0 = blockIdx.x * ct, cols = min(ct, D1 - j0);
  const size_t row = (size_t)k * B + r0;
  const T* xk = x + row * F;
  const T* w1k = w1 + (size_t)k * F * D1 + j0;

  // chunk ch of x's rows and of the W1 slice into its ring stage: with
  // `tma`, one box of each by thread 0 (boxes of rt x kFc and kFc x ct,
  // zeros past B, F and D1), the stage's mbarrier counting the bytes;
  // else cp.async pieces, a commit group a chunk
  __shared__ __align__(8) unsigned long long bars[kFcStages];
  auto issue = [&](int ch) {
    if (ch * kFc < F) {
      T* xs = base + (ch % kFcStages) * kFcStage<T>;
      T* ws = xs + kFcMaxRows * kFcLdx<T>;
      const int f0 = ch * kFc, n = min(kFc, F - f0);
      if (!tma) {
        stage_tile(xs, ldx, xk + f0, F, rows, n);
        stage_tile(ws, ct, w1k + (size_t)f0 * D1, D1, n, cols);
      } else if (threadIdx.x == 0) {
        const unsigned bar = smem_u32(&bars[ch % kFcStages]);
        mbar_expect_tx(bar, (rt + ct) * kFc * (int)sizeof(T));
        tma_load(xs, &tx, bar, f0, r0, k);
        tma_load(ws, &tw, bar, j0, f0, k);
      }
    }
    if (!tma) asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // layer 1: a thread holds rows 2 rp and 2 rp + 1 of column jj
  const int rp = threadIdx.x / ct, jj = threadIdx.x % ct;
  const bool live = rp < (rows + 1) / 2 && jj < cols;
  const int ra = min(2 * rp, rows - 1), rb = min(2 * rp + 1, rows - 1);
  float acc0 = 0.f, acc1 = 0.f;
  const int nch = (F + kFc - 1) / kFc;
  if (tma) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kFcStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
  issue(0);
  issue(1);
  for (int ch = 0; ch < nch; ++ch) {
    if (tma)
      mbar_wait(smem_u32(&bars[ch % kFcStages]), (ch / kFcStages) & 1);
    else
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    issue(ch + kFcStages - 1);
    if (!live) continue;
    const T* xs = base + (ch % kFcStages) * kFcStage<T>;
    const T* xa = xs + ra * ldx;
    const T* xb = xs + rb * ldx;
    const T* wc = xs + kFcMaxRows * kFcLdx<T> + jj;
    const int n = min(kFc, F - ch * kFc);
    int i = 0;
#pragma unroll 4
    for (; i + 4 <= n; i += 4) {
      const float4 pa = load4(xa + i), pb = load4(xb + i);
      const float v0 = f(wc[i * ct]), v1 = f(wc[(i + 1) * ct]);
      const float v2 = f(wc[(i + 2) * ct]), v3 = f(wc[(i + 3) * ct]);
      acc0 = fmaf(pa.x, v0, acc0);
      acc0 = fmaf(pa.y, v1, acc0);
      acc0 = fmaf(pa.z, v2, acc0);
      acc0 = fmaf(pa.w, v3, acc0);
      acc1 = fmaf(pb.x, v0, acc1);
      acc1 = fmaf(pb.y, v1, acc1);
      acc1 = fmaf(pb.z, v2, acc1);
      acc1 = fmaf(pb.w, v3, acc1);
    }
    for (; i < n; ++i) {
      const float v0 = f(wc[i * ct]);
      acc0 = fmaf(f(xa[i]), v0, acc0);
      acc1 = fmaf(f(xb[i]), v0, acc1);
    }
  }
  if (live) {
    const float bj = f(b1[(size_t)k * D1 + j0 + jj]);
    const float v0 = fmaxf(rnd<T>(__fadd_rn(rnd<T>(acc0), bj)), 0.f);
    const float v1 = fmaxf(rnd<T>(__fadd_rn(rnd<T>(acc1), bj)), 0.f);
    h1[(row + 2 * rp) * D1 + j0 + jj] = to<T>(v0);
    if (2 * rp + 1 < rows) h1[(row + 2 * rp + 1) * D1 + j0 + jj] = to<T>(v1);
  }

  // the last block of (k, tile) to get here runs layers 2 and 3: the
  // block's h1 stores are published by thread 0's fence after the barrier,
  // and the last block's thread 0 fences again before its block reads
  // the other blocks' h1 (through L2)
  __shared__ int last;
  __syncthreads();
  int* count = counters + (size_t)k * gridDim.y + tile;
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(count, 1) == (int)gridDim.x - 1;
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;

  const FcTail at(rows, D1, D2, D3);
  T* h1s = base + at.h1;
  T* h2s = base + at.h2;
  const T* w2k = w2 + (size_t)k * D1 * D2;
  const T* w3k = w3 + (size_t)k * D2 * D3;
  // W2 and W3, unchanged by this launch, come as one TMA bulk copy each
  // where their ends allow; h1, which other blocks wrote, by cp.async
  // through L2
  const unsigned n2 = D1 * D2 * sizeof(T), n3 = D2 * D3 * sizeof(T);
  const bool bulk = staged && n2 % 16 == 0 && n3 % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w2k) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w3k) % 16 == 0 &&
                    at.w2 * sizeof(T) % 16 == 0 && at.w3 * sizeof(T) % 16 == 0;
  __shared__ __align__(8) unsigned long long tailbar;
  if (bulk && threadIdx.x == 0) {
    const unsigned bar = smem_u32(&tailbar);
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, n2 + n3);
    bulk_copy(base + at.w2, w2k, n2, bar);
    bulk_copy(base + at.w3, w3k, n3, bar);
  }
  stage_tile(h1s, D1, h1 + row * D1, D1, rows, D1);
  if (staged && !bulk) {
    stage_tile(base + at.w2, D2, w2k, D2, D1, D2);
    stage_tile(base + at.w3, D3, w3k, D3, D2, D3);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  if (bulk) mbar_wait(smem_u32(&tailbar), 0);
  if (staged) {
    dense_tail_any<T>(h1s, D1, base + at.w2, b2 + (size_t)k * D2, D2, true,
                      h2s, h2 + row * D2, rows);
    __syncthreads();
    dense_tail_any<T>(h2s, D2, base + at.w3, b3 + (size_t)k * D3, D3, false,
                      nullptr, out + row * D3, rows);
  } else {
    dense_tail_any<T>(h1s, D1, w2k, b2 + (size_t)k * D2, D2, true, h2s,
                      h2 + row * D2, rows);
    __syncthreads();
    dense_tail_any<T>(h2s, D2, w3k, b3 + (size_t)k * D3, D3, false, nullptr,
                      out + row * D3, rows);
  }
  if (threadIdx.x == 0) *count = 0;
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// the library needs no link to libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (d2, d1, d0) array of T as a 3-D tensor map (d0 fastest) with boxes of
// b0 x b1 x 1, no swizzle, zeros past its ends; false where the map cannot
// be made (a stride or a box row not whole 16 bytes, no encoder)
template <typename T>
bool make_map3(CUtensorMap* map, const void* ptr, int d0, int d1, int d2,
               int b0, int b1) {
  const EncodeTiled encode = encode_tiled();
  const int sz = (int)sizeof(T);
  if (encode == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 ||
      d0 * sz % 16 || b0 * sz % 16)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1,
                              (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)d0 * sz,
                                 (cuuint64_t)d0 * d1 * sz};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map,
                sz == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline unsigned blocks_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

// ---------------------------------------------------------------------------
// host-side launchers, one per __global__ function and compute type
// ---------------------------------------------------------------------------
template <typename T>
int conv_pool_fwd(const void* x, const void* w, const void* b, void* a,
                  void* pat, void* eq, void* relu_m, int K, int B, int H,
                  int W, int C, int O, int write_res, void* stream) {
  const size_t smem = (size_t)(9 * C * O + O) * sizeof(T);
  int rc = set_smem((const void*)conv_pool_fwd_kernel<T>, smem);
  if (rc) return rc;
  dim3 grid(blocks_for((long long)B * (H / 2) * (W / 2) * O, kThreads), K);
  conv_pool_fwd_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)a, (T*)pat, (T*)eq,
      (T*)relu_m, B, H, W, C, O, write_res);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_bwd_partial(const void* pat, const void* eq, const void* relu_m,
                     const void* da, void* dz, float* part, int K, int B,
                     int H, int W, int C, int O, int R, int nchunks,
                     void* stream) {
  const size_t smem = (size_t)R * (9 * C + O) * sizeof(T);
  int rc = set_smem((const void*)conv_bwd_partial_kernel<T>, smem);
  if (rc) return rc;
  dim3 grid(nchunks, K);
  conv_bwd_partial_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)pat, (const T*)eq, (const T*)relu_m, (const T*)da, (T*)dz,
      part, B, H, W, C, O, R, nchunks);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_bwd_finish(const float* part, const void* dz, const void* da,
                    const void* relu_m, const void* w, float* dw, float* db,
                    void* dx, int K, int B, int H, int W, int C, int O,
                    int nchunks, void* stream) {
  const long long n_dx = dx ? (long long)K * B * H * W * C : 0;
  const unsigned grid = (unsigned)K + blocks_for(n_dx, kThreads);
  conv_bwd_finish_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      part, (const T*)dz, (const T*)da, (const T*)relu_m, (const T*)w, dw, db,
      (T*)dx, K, B, H, W, C, O, nchunks);
  return (int)cudaGetLastError();
}

template <typename T>
int fc_fwd(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out,
           void* h1, void* h2, int* counters, int K, int B, int F, int D1,
           int D2, int D3, int rt, int ct, void* stream) {
  if (rt < 1 || rt > kFcMaxRows || ct < 1 || ct > kFcMaxCols)
    return (int)cudaErrorInvalidValue;
  const int nct = (D1 + ct - 1) / ct, nrt = (B + rt - 1) / rt;
  if (nrt > 65535 || K > 65535) return (int)cudaErrorInvalidValue;
  // 227 KB less the static flag and barriers and the 128 bytes that align
  // the base; the tail stages W2 and W3 where they fit beside the h1 and
  // h2 rows
  const size_t limit = 227 * 1024 - 128 - 128;
  const size_t ring = (size_t)kFcStages * kFcStage<T> * sizeof(T);
  const FcTail at(rt, D1, D2, D3);
  int staged = 1;
  size_t smem = std::max(ring, (size_t)at.total * sizeof(T));
  if (smem > limit) {
    staged = 0;
    smem = std::max(ring, (size_t)at.total_unstaged * sizeof(T));
  }
  if (smem > limit) return (int)cudaErrorInvalidValue;
  // layer 1 stages by TMA where both maps can be made, else by cp.async
  CUtensorMap tx{}, tw{};
  const int tma = make_map3<T>(&tx, x, F, B, K, kFc, rt) &&
                  make_map3<T>(&tw, w1, D1, F, K, ct, kFc);
  smem += 128;
  int rc = set_smem((const void*)fc_fwd_kernel<T>, smem);
  if (rc) return rc;
  dim3 grid(nct, nrt, K);
  fc_fwd_kernel<T><<<grid, kFcThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
      (const T*)w3, (const T*)b3, (T*)out, (T*)h1, (T*)h2, counters, B, F,
      D1, D2, D3, rt, ct, staged, tma, tx, tw);
  return (int)cudaGetLastError();
}

template <typename T>
int fc_bwd(const void* x, const void* h1, const void* h2, const void* g,
           const void* w1, const void* w2, const void* w3, float* dw1,
           float* db1, float* dw2, float* db2, float* dw3, float* db3,
           void* dx, int K, int B, int F, int D1, int D2, int D3,
           void* stream) {
  // every width at most a thread per column, and a whole number of words
  if (D1 > kThreads || D2 > kThreads || D3 > kThreads || F % 2 || D1 % 2 ||
      D2 % 2 || D3 % 2)
    return (int)cudaErrorInvalidValue;
  // at most one block per SM over the cohort where it fits (a second
  // block on an SM doubles its time): slices of 16 to 256 columns, a whole
  // number of 8 (4-byte words at either dtype)
  int dev = 0, nsm = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  int nt = std::max(nsm / K - 1, (F + kThreads - 1) / kThreads);
  nt = std::min(nt, std::max(1, (F + 15) / 16));
  const int ft = std::min(kThreads, ((F + nt - 1) / nt + 7) / 8 * 8);
  nt = (F + ft - 1) / ft;
  const size_t smem = (size_t)FcBwdSmem(B, D1, D2, D3, ft).total * sizeof(T);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  int rc = set_smem((const void*)fc_bwd_kernel<T>, smem);
  if (rc) return rc;
  dim3 grid(nt + 1, K);
  fc_bwd_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)g, (const T*)x, (const T*)h1, (const T*)h2, (const T*)w1,
      (const T*)w2, (const T*)w3, dw1, db1, dw2, db2, dw3, db3, (T*)dx, B, F,
      D1, D2, D3, ft);
  return (int)cudaGetLastError();
}

}  // namespace

#define DISPATCH(is_bf16, fn, ...) \
  ((is_bf16) ? fn<bf16>(__VA_ARGS__) : fn<float>(__VA_ARGS__))

API const char* fcnn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// ---- blocked kernels: a cohort of K users per launch ----------------------

API int fcnn_conv_pool_fwd(const void* x, const void* w, const void* b,
                           void* a, void* pat, void* eq, void* relu_m, int K,
                           int B, int H, int W, int C, int O, int write_res,
                           int is_bf16, void* stream) {
  return DISPATCH(is_bf16, conv_pool_fwd, x, w, b, a, pat, eq, relu_m, K, B,
                  H, W, C, O, write_res, stream);
}

API int fcnn_conv_bwd_partial(const void* pat, const void* eq,
                              const void* relu_m, const void* da, void* dz,
                              float* part, int K, int B, int H, int W, int C,
                              int O, int R, int nchunks, int is_bf16,
                              void* stream) {
  return DISPATCH(is_bf16, conv_bwd_partial, pat, eq, relu_m, da, dz, part,
                  K, B, H, W, C, O, R, nchunks, stream);
}

API int fcnn_conv_bwd_finish(const float* part, const void* dz,
                             const void* da, const void* relu_m,
                             const void* w, float* dw, float* db, void* dx,
                             int K, int B, int H, int W, int C, int O,
                             int nchunks, int is_bf16, void* stream) {
  return DISPATCH(is_bf16, conv_bwd_finish, part, dz, da, relu_m, w, dw, db,
                  dx, K, B, H, W, C, O, nchunks, stream);
}

// counters: K * ceil(B / rows) ints, 0 on entry and on return
API int fcnn_fc_fwd(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* w3,
                    const void* b3, void* out, void* h1, void* h2,
                    int* counters, int K, int B, int F, int D1, int D2,
                    int D3, int rows, int cols, int is_bf16, void* stream) {
  return DISPATCH(is_bf16, fc_fwd, x, w1, b1, w2, b2, w3, b3, out, h1, h2,
                  counters, K, B, F, D1, D2, D3, rows, cols, stream);
}

API int fcnn_fc_bwd(const void* x, const void* h1, const void* h2,
                    const void* g, const void* w1, const void* w2,
                    const void* w3, float* dw1, float* db1, float* dw2,
                    float* db2, float* dw3, float* db3, void* dx, int K,
                    int B, int F, int D1, int D2, int D3, int is_bf16,
                    void* stream) {
  return DISPATCH(is_bf16, fc_bwd, x, h1, h2, g, w1, w2, w3, dw1, db1, dw2,
                  db2, dw3, db3, dx, K, B, F, D1, D2, D3, stream);
}

// ---- single-user kernels: one user's tensors (no K axis) per launch ------

API int fcnn_user_conv_pool_fwd(const void* x, const void* w, const void* b,
                                void* a, void* pat, void* eq, void* relu_m,
                                int B, int H, int W, int C, int O,
                                int is_bf16, void* stream) {
  return DISPATCH(is_bf16, conv_pool_fwd, x, w, b, a, pat, eq, relu_m, 1, B,
                  H, W, C, O, 1, stream);
}

API int fcnn_user_conv_bwd_partial(const void* pat, const void* eq,
                                   const void* relu_m, const void* da,
                                   void* dz, float* part, int B, int H, int W,
                                   int C, int O, int R, int nchunks,
                                   int is_bf16, void* stream) {
  return DISPATCH(is_bf16, conv_bwd_partial, pat, eq, relu_m, da, dz, part,
                  1, B, H, W, C, O, R, nchunks, stream);
}

API int fcnn_user_conv_bwd_finish(const float* part, const void* dz,
                                  const void* da, const void* relu_m,
                                  const void* w, float* dw, float* db,
                                  void* dx, int B, int H, int W, int C, int O,
                                  int nchunks, int is_bf16, void* stream) {
  return DISPATCH(is_bf16, conv_bwd_finish, part, dz, da, relu_m, w, dw, db,
                  dx, 1, B, H, W, C, O, nchunks, stream);
}

API int fcnn_user_fc_fwd(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* w3,
                         const void* b3, void* out, void* h1, void* h2,
                         int* counters, int B, int F, int D1, int D2, int D3,
                         int rows, int cols, int is_bf16, void* stream) {
  return DISPATCH(is_bf16, fc_fwd, x, w1, b1, w2, b2, w3, b3, out, h1, h2,
                  counters, 1, B, F, D1, D2, D3, rows, cols, stream);
}

API int fcnn_user_fc_bwd(const void* x, const void* h1, const void* h2,
                         const void* g, const void* w1, const void* w2,
                         const void* w3, float* dw1, float* db1, float* dw2,
                         float* db2, float* dw3, float* db3, void* dx, int B,
                         int F, int D1, int D2, int D3, int is_bf16,
                         void* stream) {
  return DISPATCH(is_bf16, fc_bwd, x, h1, h2, g, w1, w2, w3, dw1, db1, dw2,
                  db2, dw3, db3, dx, 1, B, F, D1, D2, D3, stream);
}
