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
// 1920 through the single-user kernels at K=10).  The fc backward is one
// launch that spreads a cohort over every SM (fc_bwd_kernel below).
//
// Design.  The TPU kernels walk a sequential grid over user tiles and keep
// a whole user's layer in VMEM; here blocks run in parallel in no order, so
// - every output element is owned by exactly one thread and every sum is
//   taken in a fixed order: no float atomics, results are identical run to
//   run;
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
// Weights in shared memory take half the bytes at bf16.  Simple FMA code;
// tensor cores, TMA and wgmma are left for later work.
//
// Interface: plain C functions, bound with ctypes.  Each launches one
// __global__ function on the given stream and returns cudaGetLastError().
// The last int argument selects the compute type (0 = f32, 1 = bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

#define API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kThreads = 256;
constexpr int kFcThreads = 128;
constexpr int kFcRows = 8;  // batch rows per fc block

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
// fc_chain_fwd: h1 = relu(x W1 + b1), h2 = relu(h1 W2 + b2), out = h2 W3 + b3.
// One block per (row tile of kFcRows batch rows, user); the tile's input
// rows and its h1/h2 stay in shared memory between the three products.
// Thread j owns output column j of each layer for all rows of the tile.
// grid = (ceil(B / kFcRows), K).
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void dense_rows(const T* in_s, int fin,
                                           const T* __restrict__ w,
                                           const T* __restrict__ b,
                                           int fout, bool relu, T* out_s,
                                           T* __restrict__ out_g, int rows) {
  for (int j = threadIdx.x; j < fout; j += blockDim.x) {
    float acc[kFcRows];
#pragma unroll
    for (int r = 0; r < kFcRows; ++r) acc[r] = 0.f;
    for (int ff = 0; ff < fin; ++ff) {
      const float wv = f(w[(size_t)ff * fout + j]);
#pragma unroll
      for (int r = 0; r < kFcRows; ++r)
        acc[r] = fmaf(f(in_s[r * fin + ff]), wv, acc[r]);
    }
    const float bj = f(b[j]);
#pragma unroll
    for (int r = 0; r < kFcRows; ++r) {
      float v = rnd<T>(__fadd_rn(rnd<T>(acc[r]), bj));
      if (relu) v = fmaxf(v, 0.f);
      if (out_s) out_s[r * fout + j] = to<T>(v);
      if (r < rows) out_g[(size_t)r * fout + j] = to<T>(v);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kFcThreads)
fc_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w1,
              const T* __restrict__ b1, const T* __restrict__ w2,
              const T* __restrict__ b2, const T* __restrict__ w3,
              const T* __restrict__ b3, T* __restrict__ out,
              T* __restrict__ h1, T* __restrict__ h2, int B, int F, int D1,
              int D2, int D3) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k = blockIdx.y, r0 = blockIdx.x * kFcRows;
  const int rows = min(kFcRows, B - r0);
  T* xs = reinterpret_cast<T*>(smem_raw);  // (kFcRows, F)
  T* h1s = xs + kFcRows * F;               // (kFcRows, D1)
  T* h2s = h1s + kFcRows * D1;             // (kFcRows, D2)
  const T* xk = x + ((size_t)k * B + r0) * F;
  for (int i = threadIdx.x; i < kFcRows * F; i += blockDim.x)
    xs[i] = i < rows * F ? xk[i] : to<T>(0.f);
  __syncthreads();
  const size_t row = (size_t)k * B + r0;
  dense_rows<T>(xs, F, w1 + (size_t)k * F * D1, b1 + (size_t)k * D1, D1,
                true, h1s, h1 + row * D1, rows);
  __syncthreads();
  dense_rows<T>(h1s, D1, w2 + (size_t)k * D1 * D2, b2 + (size_t)k * D2, D2,
                true, h2s, h2 + row * D2, rows);
  __syncthreads();
  dense_rows<T>(h2s, D2, w3 + (size_t)k * D2 * D3, b3 + (size_t)k * D3, D3,
                false, nullptr, out + row * D3, rows);
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
           void* h1, void* h2, int K, int B, int F, int D1, int D2, int D3,
           void* stream) {
  const size_t smem = (size_t)kFcRows * (F + D1 + D2) * sizeof(T);
  int rc = set_smem((const void*)fc_fwd_kernel<T>, smem);
  if (rc) return rc;
  dim3 grid(blocks_for(B, kFcRows), K);
  fc_fwd_kernel<T><<<grid, kFcThreads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w1, (const T*)b1, (const T*)w2, (const T*)b2,
      (const T*)w3, (const T*)b3, (T*)out, (T*)h1, (T*)h2, B, F, D1, D2, D3);
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

API int fcnn_fc_fwd(const void* x, const void* w1, const void* b1,
                    const void* w2, const void* b2, const void* w3,
                    const void* b3, void* out, void* h1, void* h2, int K,
                    int B, int F, int D1, int D2, int D3, int is_bf16,
                    void* stream) {
  return DISPATCH(is_bf16, fc_fwd, x, w1, b1, w2, b2, w3, b3, out, h1, h2, K,
                  B, F, D1, D2, D3, stream);
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
                         const void* b3, void* out, void* h1, void* h2, int B,
                         int F, int D1, int D2, int D3, int is_bf16,
                         void* stream) {
  return DISPATCH(is_bf16, fc_fwd, x, w1, b1, w2, b2, w3, b3, out, h1, h2, 1,
                  B, F, D1, D2, D3, stream);
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
