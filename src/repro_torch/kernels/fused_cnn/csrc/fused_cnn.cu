// Hand-written Hopper (sm_90a) kernels for the fused CNN training step of
// the OPT-HSFL simulation: one SGD step of the paper's 5-layer CNN, for a
// whole cohort of K users or for one user, in f32 or bf16.
//
// They replace the eight fused-CNN Pallas TPU kernels of
// src/repro/kernels/fused_cnn/kernel.py:
//
//   conv_pool_fwd_k  (pallas_call at kernel.py:291) -> conv_pool_fwd_kernel
//   conv_pool_bwd_k  (pallas_call at kernel.py:357) -> conv_pool_bwd_kernel
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
// round by the host loop around its 144 training launches (6 per SGD step,
// one per kernel call; 1440 through the single-user kernels at K=10).
// Every kernel is one launch that spreads a cohort over many SMs: the conv
// forward over bands of image rows, the conv backward over chunks of patch
// rows, the fc forward and backward over slices of fc1's columns.  Their
// long sums (layer 1's 784 terms, dW's rows) are sequential chains, so
// their latency, not the card's rate, bounds them.
//
// Design.  The TPU kernels walk a sequential grid over user tiles and keep
// a whole user's layer in VMEM; here blocks run in parallel in no order, so
// - every output element is owned by exactly one thread and every sum is
//   taken in a fixed order: no float atomics (the integer atomics of the
//   fc forward and the conv backward only pick which block runs the last
//   step), results are identical run to run;
// - a reduction across blocks (dW over B*H*W rows) sums per-block partials
//   in block order in the last block to finish, in the same launch;
// - the conv product z is summed tap by tap in (i, j, c) order with
//   __fmul_rn/__fadd_rn, which the compiler never contracts into an FMA.
//   The plain PyTorch twin (ref.py) sums the same way, so tied pool maxima
//   (zero backgrounds, constant images) are found identically and the
//   1/count tie mask agrees bit for bit;
// - SAME padding: the conv forward stages each band of the image with a
//   zero border in shared memory (a zero tap adds +-0, which changes no
//   sum of finite values); the backward's gather skips out-of-range taps;
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
// Staged as T, weights take half the shared memory at bf16 (the conv
// kernels widen their operands to f32 there).  FMA code on the CUDA cores
// (the fc forward stages with TMA); the tensor cores are left for later
// work.
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

// ---------------------------------------------------------------------------
// spans between global and shared memory.  A run of n elements is placed in
// a 16-byte aligned region of shared memory (n + 16 bytes long) at the same
// offset mod 16 bytes as its global end, so that all of it but a head and a
// tail of a few elements moves as whole 16-byte pieces.
// ---------------------------------------------------------------------------

// elements of T between the 16-byte boundary below p and p
template <typename T>
__device__ __forceinline__ int phase_of(const T* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) % 16) / (int)sizeof(T);
}

// start copying src[0, n) to region + phase_of(src) (cp.async for the
// 16-byte pieces; visible after cp.async.wait_all and a barrier); returns
// where it lands
template <typename T>
__device__ __forceinline__ T* copy_in(T* region, const T* src, int n) {
  constexpr int V = 16 / (int)sizeof(T);
  const int ph = phase_of(src);
  T* dst = region + ph;
  const int head = min(n, (V - ph) % V), nv = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    cp_async16(dst + head + i * V, src + head + i * V);
  for (int i = head + nv * V + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
  return dst;
}

// start copying src[0, n) to the 16-byte aligned region itself (cp.async
// where src is 16-byte aligned, else element by element)
template <typename T>
__device__ __forceinline__ T* copy_in_aligned(T* region, const T* src,
                                              int n) {
  if (phase_of(src)) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) region[i] = src[i];
    return region;
  }
  return copy_in(region, src, n);
}

// write src[0, n), a span in shared memory at phase_of(dst), to dst:
// consecutive threads store consecutive 16-byte pieces
template <typename T>
__device__ __forceinline__ void store_span(T* __restrict__ dst, const T* src,
                                           int n) {
  constexpr int V = 16 / (int)sizeof(T);
  const int head = min(n, (V - phase_of(dst)) % V), nv = (n - head) / V;
  for (int i = threadIdx.x; i < head; i += blockDim.x) dst[i] = src[i];
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = threadIdx.x; i < nv; i += blockDim.x) d4[i] = s4[i];
  for (int i = head + nv * V + threadIdx.x; i < n; i += blockDim.x)
    dst[i] = src[i];
}

// bytes of a span region: n elements of tsize bytes and 16 to spare, in
// whole 16 bytes
__host__ __device__ inline int span_bytes(int n, int tsize) {
  return (n * tsize + 31) / 16 * 16;
}

// ---------------------------------------------------------------------------
// conv_pool_fwd: patches + product + 2x2 max pool + bias + ReLU (pool first)
// x (K,B,H,W,C), w (K,9C,O), bias (K,O) -> a (K,B,H/2,W/2,O);
// residuals pat (K,B*H*W,9C), eq (K,B,H,W,O), relu_m (K,B,H/2,W/2,O).
//
// A block owns one (user k, image b, band of nph pooled rows); grid =
// K*B*bands blocks on one axis, bands fastest, 128 to 256 threads.  The
// launcher picks the bands: whole images where they alone give each SM 4
// blocks (the eval, K=1 B=1000), else a few pooled rows each (the round:
// conv1 5 bands of 3 rows, conv2 4 of 2; one user: a row each).  A block
// stages its input rows with their halo, the user's weights and the bias
// in shared memory once (cp.async) and spreads the input into f32 planes,
// one per channel, row parity and column parity, with a zero border: a
// warp's lanes, neighbouring pooled positions, then read neighbouring
// words (the next pooled row is HALF = W / 2 + 1 words on).
// A thread owns one pooled position and OT output channels: its 4 x OT
// sums z run tap by tap in (i, j, c) order with __fmul_rn/__fadd_rn, the
// weights of a tap read once for all four (one read that a warp shares).
// OT = 4 for whole images (fewer shared-memory reads a product), 2 for
// conv2's bands (twice the threads on a band, half the chain each).  A
// zero border tap adds x*w = +-0, which leaves every sum as skipping it
// did (a sum that starts at +0 is never -0) for finite weights.  C and O
// are compile-time for the paper's two layers, (1, 8) and (8, 16), so the
// tap and channel loops unroll; any other (C, O) runs the runtime-shape
// instantiation (CC = OO = 0, OT = 1).
//
// The band's pat, eq, a and relu_m rows are each one contiguous span of
// global memory, written as 16-byte pieces by consecutive threads: pat
// first, so its stores are in flight during the product (conv2: straight
// from the staged rows, a tap's 8 channels being whole pieces; conv1:
// built in shared memory first), then eq, a and relu_m, built in shared
// memory by the product's epilogue.  With write_res = 0 (the eval) only a
// is built and written.
// ---------------------------------------------------------------------------

// the shared-memory regions of conv_pool_fwd_kernel, in bytes from a
// 16-byte aligned base
struct ConvFwdSmem {
  int raw, xs, w, b, a, relu, eq, pat, total;
  __host__ __device__ ConvFwdSmem(int nph, int W, int C, int O, int tsize,
                                  int res) {
    const int tr = 2 * nph + 2;
    raw = 0;
    xs = raw + span_bytes(tr * W * C, tsize);
    w = xs + (tr * (W + 2) * C * 4 + 15) / 16 * 16;
    b = w + span_bytes(9 * C * O, tsize);
    a = b + span_bytes(O, tsize);
    relu = a + span_bytes(nph * (W / 2) * O, tsize);
    eq = relu + (res ? span_bytes(nph * (W / 2) * O, tsize) : 0);
    pat = eq + (res ? span_bytes(2 * nph * W * O, tsize) : 0);
    total = pat + (res ? span_bytes(2 * nph * W * 9 * C, tsize) : 0);
  }
};

// two consecutive elements widened to f32 (8-byte aligned at f32, 4 at
// bf16)
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

template <typename T, int CC, int OO, int OT>
__global__ void __launch_bounds__(kThreads)
conv_pool_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ bias, T* __restrict__ a,
                     T* __restrict__ pat, T* __restrict__ eq,
                     T* __restrict__ relu_m, int B, int H, int W, int Crt,
                     int Ort, int nph, int nbands, int write_res) {
  static_assert(OO % OT == 0, "O in whole groups of OT");
  const int C = CC ? CC : Crt, O = OO ? OO : Ort;
  const int P = 9 * C, PH = H / 2, PW = W / 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ConvFwdSmem L(nph, W, C, O, (int)sizeof(T), write_res);
  const int img = blockIdx.x / nbands;  // k * B + b
  const int ph0 = (blockIdx.x % nbands) * nph;
  const int k = img / B;
  const int rows = min(nph, PH - ph0);  // pooled rows of the band
  // the input tile: TR = 2 NR rows from image row y0, columns -1 .. W
  // (zeros outside the image); rows [ylo, yhi) come from x
  const int NR = nph + 1, TR = 2 * NR, HALF = PW + 1;
  const int y0 = 2 * ph0 - 1;
  const int ylo = max(y0, 0), yhi = min(2 * (ph0 + rows) + 1, H);

  const T* xr =
      copy_in(reinterpret_cast<T*>(smem_raw + L.raw),
              x + ((size_t)img * H + ylo) * W * C, (yhi - ylo) * W * C);
  const T* ws = copy_in_aligned(reinterpret_cast<T*>(smem_raw + L.w),
                                w + (size_t)k * P * O, P * O);
  const T* bs = copy_in_aligned(reinterpret_cast<T*>(smem_raw + L.b),
                                bias + (size_t)k * O, O);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // the planes: value (c, tile row tr, padded column pc) at
  // xs[(((c * 2 + tr % 2) * 2 + pc % 2) * NR + tr / 2) * HALF + pc / 2]
  float* xs = reinterpret_cast<float*>(smem_raw + L.xs);
  const int W2 = W + 2;
  for (int e = threadIdx.x; e < TR * W2; e += blockDim.x) {  // a pixel each
    const int tr = e / W2, pc = e - tr * W2;
    const int y = y0 + tr, xx = pc - 1;
    const bool in = y >= ylo && y < yhi && xx >= 0 && xx < W;
    const T* src = xr + ((y - ylo) * W + xx) * C;
    float* dst = xs + (((tr & 1) * 2 + (pc & 1)) * NR + (tr >> 1)) * HALF +
                 (pc >> 1);
    if (CC % 4 == 0 && CC > 0 && phase_of(xr) == 0) {
      // a pixel's channels as 4-wide reads (whole pixels of 4 channels
      // from a 16-byte aligned first row)
#pragma unroll
      for (int c = 0; c < C; c += 4) {
        const float4 v =
            in ? load4(src + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        dst[c * 4 * NR * HALF] = v.x;
        dst[(c + 1) * 4 * NR * HALF] = v.y;
        dst[(c + 2) * 4 * NR * HALF] = v.z;
        dst[(c + 3) * 4 * NR * HALF] = v.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
        dst[c * 4 * NR * HALF] = in ? f(src[c]) : 0.f;
    }
  }

  const size_t pooled0 = ((size_t)img * PH + ph0) * PW * O;
  T* ag = a + pooled0;
  T* a_s = reinterpret_cast<T*>(smem_raw + L.a) + phase_of(ag);
  T *rg = nullptr, *r_s = nullptr, *eg = nullptr, *e_s = nullptr;
  if (write_res) {
    rg = relu_m + pooled0;
    r_s = reinterpret_cast<T*>(smem_raw + L.relu) + phase_of(rg);
    eg = eq + ((size_t)img * H + 2 * ph0) * W * O;
    e_s = reinterpret_cast<T*>(smem_raw + L.eq) + phase_of(eg);
    // the band's patch rows (yl, xx): 9C values, taps in (i, j) order,
    // channels inside, copied from the staged rows and in flight during
    // the product.  Where a tap's C channels are whole 16-byte pieces
    // (conv2), consecutive threads store consecutive pieces straight from
    // the staged rows; else (conv1's one channel) the rows are built in
    // shared memory first
    T* pg = pat + ((size_t)img * H + 2 * ph0) * W * P;
    constexpr int V = 16 / (int)sizeof(T);
    if (C % V == 0 && phase_of(xr) == 0 && phase_of(pg) == 0) {
      const int CV = C / V;
      const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
      const uint4* xv = reinterpret_cast<const uint4*>(xr);
      uint4* pv = reinterpret_cast<uint4*>(pg);
      for (int yl = 0; yl < 2 * rows; ++yl)
        for (int u = threadIdx.x; u < W * 9 * CV; u += blockDim.x) {
          const int t = u / CV, cv = u - t * CV;
          const int xx = t / 9, tap = t - xx * 9;
          const int y = 2 * ph0 + yl + tap / 3 - 1, x1 = xx + tap % 3 - 1;
          pv[yl * W * 9 * CV + u] =
              y >= ylo && y < yhi && x1 >= 0 && x1 < W
                  ? xv[((y - ylo) * W + x1) * CV + cv]
                  : zero;
        }
      __syncthreads();
    } else {
      T* p_s = reinterpret_cast<T*>(smem_raw + L.pat) + phase_of(pg);
      for (int yl = 0; yl < 2 * rows; ++yl)
        for (int t = threadIdx.x; t < W * 9; t += blockDim.x) {
          const int xx = t / 9, tap = t - xx * 9;
          const int y = 2 * ph0 + yl + tap / 3 - 1, x1 = xx + tap % 3 - 1;
          const bool in = y >= ylo && y < yhi && x1 >= 0 && x1 < W;
          const T* src = xr + ((y - ylo) * W + x1) * C;
          T* dst = p_s + (yl * W * 9 + t) * C;
#pragma unroll
          for (int c = 0; c < C; ++c) dst[c] = in ? src[c] : to<T>(0.f);
        }
      __syncthreads();
      store_span(pg, p_s, 2 * rows * W * P);
    }
  } else {
    __syncthreads();
  }

  const int NPIX = rows * PW;
  for (int t = threadIdx.x; t < (O / OT) * NPIX; t += blockDim.x) {
    const int g = t / NPIX, p = t - g * NPIX;
    const int phl = p / PW, pw = p - phl * PW;
    const float* xb = xs + phl * HALF + pw;  // tile row 2 phl, col 2 pw
    const T* wg = ws + g * OT;
    float acc[4][OT];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int u = 0; u < OT; ++u) acc[q][u] = 0.f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const T* wt = wg + ((i * 3 + j) * C + c) * O;
          float wv[OT];
          if constexpr (OT == 4) {
            const float4 v = load4(wt);
            wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
          } else if constexpr (OT == 2) {
            const float2 v = load2(wt);
            wv[0] = v.x; wv[1] = v.y;
          } else {
            wv[0] = f(wt[0]);
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int rr = (q >> 1) + i, cc = (q & 1) + j;
            const float xv =
                xb[(((c * 2 + (rr & 1)) * 2 + (cc & 1)) * NR + (rr >> 1)) *
                       HALF +
                   (cc >> 1)];
#pragma unroll
            for (int u = 0; u < OT; ++u)
              acc[q][u] = __fadd_rn(acc[q][u], __fmul_rn(xv, wv[u]));
          }
        }
#pragma unroll
    for (int u = 0; u < OT; ++u) {
      const int o = g * OT + u;
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) z[q] = rnd<T>(acc[q][u]);
      const float pz = fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
      const float pre = rnd<T>(__fadd_rn(pz, f(bs[o])));
      a_s[p * O + o] = to<T>(fmaxf(pre, 0.f));
      if (!write_res) continue;
      r_s[p * O + o] = to<T>(pre > 0.f ? 1.f : 0.f);
      int cnt = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) cnt += z[q] == pz;
      const float inv = rnd<T>(__fdiv_rn(1.f, (float)cnt));
#pragma unroll
      for (int q = 0; q < 4; ++q)
        e_s[((2 * phl + (q >> 1)) * W + 2 * pw + (q & 1)) * O + o] =
            to<T>(z[q] == pz ? inv : 0.f);
    }
  }
  __syncthreads();
  store_span(ag, a_s, NPIX * O);
  if (write_res) {
    store_span(rg, r_s, NPIX * O);
    store_span(eg, e_s, 2 * rows * W * O);
  }
}

// ---------------------------------------------------------------------------
// conv_pool_bwd, one launch: dz = eq * (da * relu_m) upsampled, dW = pat^T
// dz (f32), db = sum of da * relu_m (f32), dx = the 9-tap gather of dz W^T.
// grid = (nchunks + 1 padded to whole clusters, K), 256 threads.  Block
// (c, k), c < nchunks, owns the R patch rows [c R, c R + R) of user k's
// M = B*H*W (R, from the wrapper, and the chunk boundaries fix dW's
// summation order, and so its bits):
// - it copies its rows' patches, and the eq, da and relu_m rows that dz
//   needs for its rows and, for dx, for the W + 1 rows on either side that
//   its gather reads, into shared memory at once (cp.async: one round trip
//   to memory), and computes dz there (dz is elementwise in eq, da and
//   relu_m): no dz in global memory;
// - it writes its dW partial (f32, rows in order, one fmaf a row) and its
//   rows of dx (the nine taps in (i, j) order, o in order, rounding to T
//   after each tap's add);
// - the block that counts user k's last partial (a counter per user in
//   global memory, which that block sets back to 0) sums the nchunks
//   partials in chunk order for dW: where dW is wide (conv2's 1152
//   columns, 143 KB of partials), the 8 blocks of its thread-block
//   cluster, co-scheduled, each a share of the columns; its loads 32 at a
//   time ahead of the adds.
// Block nchunks computes db, beside them: G = 256 / O strided group sums,
// then the groups in order (G fixes db's summation order).  No float
// atomics: the same bits on every run (the counter only picks which block
// finishes).
// ---------------------------------------------------------------------------

// the shared-memory regions of conv_pool_bwd_kernel, in bytes from a
// 16-byte aligned base.  L: the dz rows (the chunk's R and, with dx, W + 1
// on either side); NPR: the pooled rows that cover them
struct ConvBwdSmem {
  int ps, eq, da, rm, w, zs, wf, poff, total;
  __host__ __device__ ConvBwdSmem(int R, int W, int C, int O, int tsize,
                                  int dx) {
    const int L = R + (dx ? 2 * (W + 1) : 0);
    const int npr = (L + W - 1) / W / 2 + 2;
    const int lw = O % 4 ? O : O + 4;  // padded rows of the f32 weights
    ps = 0;
    eq = ps + span_bytes(R * 9 * C, tsize);
    da = eq + span_bytes(L * O, tsize);
    rm = da + span_bytes(npr * (W / 2) * O, tsize);
    w = rm + span_bytes(npr * (W / 2) * O, tsize);
    zs = w + (dx ? span_bytes(9 * C * O, tsize) : 0);
    wf = zs + (L * O * 4 + 15) / 16 * 16;
    poff = wf + (dx ? (9 * C * lw * 4 + 15) / 16 * 16 : 0);
    total = poff + (L * 4 + 15) / 16 * 16;
  }
};

constexpr int kBatch = 32;  // loads ahead of the adds in a chain
// conv backward blocks a cluster where dW is wide (conv2's 1152 columns:
// its 143 KB of partials through eight SMs, not one); else one
constexpr int kCluster = 8;
constexpr int kClusterMinCols = 512;

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ int cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return (int)n;
}

// every thread of every block of the cluster: memory operations before it
// are visible to the cluster after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the int at p in the shared memory of block `rank` of the cluster
__device__ __forceinline__ int ld_cluster(const int* p, int rank) {
  unsigned remote;
  int v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v) : "r"(remote) : "memory");
  return v;
}

// db of user k (block nchunks of the launch, beside the chunk blocks): a
// thread a group chain (group g of channel o sums T(da * relu_m) over the
// pooled positions g, g + G, ... in order, G = 256 / O), then the G group
// sums of each channel in order
template <typename T>
__device__ __forceinline__ void conv_db(const T* __restrict__ da,
                                        const T* __restrict__ relu_m,
                                        float* __restrict__ db, float* red,
                                        int k, int NP, int O) {
  const int G = kThreads / O, t = threadIdx.x;
  const size_t pk = (size_t)k * NP * O;
  float s = 0.f;
  if (t < G * O) {
    const int g = t / O, o = t - g * O;
    for (int p0 = g; p0 < NP; p0 += kBatch * G) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int p = p0 + u * G;
        const size_t i = pk + (size_t)p * O + o;
        v[u] = p < NP ? rnd<T>(__fmul_rn(f(da[i]), f(relu_m[i]))) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (p0 + u * G < NP) s = __fadd_rn(s, v[u]);
    }
  }
  red[t] = s;
  __syncthreads();
  if (t < O) {
    float tot = 0.f;
    for (int g = 0; g < G; ++g) tot = __fadd_rn(tot, red[g * O + t]);
    db[(size_t)k * O + t] = tot;
  }
}

// the work of chunk block (chunk, k) of conv_pool_bwd_kernel: dz, its dW
// partial and its rows of dx
template <typename T, int CC, int OO>
__device__ __forceinline__ void conv_bwd_chunk(
    const T* __restrict__ pat, const T* __restrict__ eq,
    const T* __restrict__ relu_m, const T* __restrict__ da,
    const T* __restrict__ w, float* __restrict__ part, T* __restrict__ dx,
    unsigned char* smem_raw, const ConvBwdSmem& L, int k, int chunk, int B,
    int H, int W, int Crt, int Ort, int R, int nchunks) {
  constexpr bool V4 = OO % 4 == 0 && OO > 0;  // dz and W rows as float4s
  constexpr int OB = OO % 8 == 0 && OO >= 16 ? 8 : 1;  // dW columns a thread
  const int C = CC ? CC : Crt, O = OO ? OO : Ort;
  const int P = 9 * C, M = B * H * W, PH = H / 2, PW = W / 2;
  const int NP = B * PH * PW, LW = O % 4 ? O : O + 4;
  const int m0 = chunk * R, rows = min(R, M - m0);
  const bool want_dx = dx != nullptr;
  const int halo = want_dx ? W + 1 : 0;
  const int mlo = max(0, m0 - halo), mhi = min(M, m0 + rows + halo);
  // pooled rows pr0 .. pr1 cover image rows mlo / W .. (mhi - 1) / W (a
  // pooled row is an image row / 2 across the images: H is even)
  const int pr0 = mlo / W / 2, pr1 = (mhi - 1) / W / 2;
  const size_t pk = (size_t)k * NP * O;

  const T* ps = copy_in(reinterpret_cast<T*>(smem_raw + L.ps),
                        pat + ((size_t)k * M + m0) * P, rows * P);
  const T* eqs = copy_in(reinterpret_cast<T*>(smem_raw + L.eq),
                         eq + ((size_t)k * M + mlo) * O, (mhi - mlo) * O);
  const int npool = (pr1 - pr0 + 1) * PW * O;
  const T* das = copy_in(reinterpret_cast<T*>(smem_raw + L.da),
                         da + pk + (size_t)pr0 * PW * O, npool);
  const T* rms = copy_in(reinterpret_cast<T*>(smem_raw + L.rm),
                         relu_m + pk + (size_t)pr0 * PW * O, npool);
  const T* wr = want_dx ? copy_in(reinterpret_cast<T*>(smem_raw + L.w),
                                  w + (size_t)k * P * O, P * O)
                        : nullptr;
  // each dz row's pooled offset into das / rms
  int* poff = reinterpret_cast<int*>(smem_raw + L.poff);
  for (int r = threadIdx.x; r < mhi - mlo; r += blockDim.x) {
    const int m = mlo + r, t = m / W;
    poff[r] = ((t / 2 - pr0) * PW + (m - t * W) / 2) * O;
  }

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // dz of rows [mlo, mhi) as f32 (the T value), and the weights widened
  float* zs = reinterpret_cast<float*>(smem_raw + L.zs);
  for (int e = threadIdx.x; e < (mhi - mlo) * O; e += blockDim.x) {
    const int r = e / O, o = e - r * O, pi = poff[r] + o;
    const float dp = rnd<T>(__fmul_rn(f(das[pi]), f(rms[pi])));
    zs[e] = rnd<T>(__fmul_rn(f(eqs[e]), dp));
  }
  float* wsm = reinterpret_cast<float*>(smem_raw + L.wf);  // (P, LW)
  if (want_dx)
    for (int e = threadIdx.x; e < P * O; e += blockDim.x) {
      const int p = e / O;
      wsm[p * LW + e - p * O] = f(wr[e]);
    }
  __syncthreads();

  // dW partial: pat^T dz over the chunk's rows in order, OB columns a thread
  float* out = part + ((size_t)k * nchunks + chunk) * P * O;
  const float* zc = zs + (m0 - mlo) * O;
  for (int t = threadIdx.x; t < P * (O / OB); t += blockDim.x) {
    const int p = t % P, o0 = t / P * OB;
    float acc[OB];
#pragma unroll
    for (int u = 0; u < OB; ++u) acc[u] = 0.f;
    int r = 0;
    if constexpr (OB == 1) {
      // one chain a thread: its operands 16 rows ahead of the FMAs
      for (; r + 16 <= rows; r += 16) {
        float pv[16], zv[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          pv[u] = f(ps[(r + u) * P + p]);
          zv[u] = zc[(r + u) * O + o0];
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) acc[0] = fmaf(pv[u], zv[u], acc[0]);
      }
    }
#pragma unroll 4
    for (; r < rows; ++r) {
      const float pv = f(ps[r * P + p]);
      const float* zr = zc + r * O + o0;
      if constexpr (OB == 8) {
        const float4 z0 = *reinterpret_cast<const float4*>(zr);
        const float4 z1 = *reinterpret_cast<const float4*>(zr + 4);
        acc[0] = fmaf(pv, z0.x, acc[0]);
        acc[1] = fmaf(pv, z0.y, acc[1]);
        acc[2] = fmaf(pv, z0.z, acc[2]);
        acc[3] = fmaf(pv, z0.w, acc[3]);
        acc[4] = fmaf(pv, z1.x, acc[4]);
        acc[5] = fmaf(pv, z1.y, acc[5]);
        acc[6] = fmaf(pv, z1.z, acc[6]);
        acc[7] = fmaf(pv, z1.w, acc[7]);
      } else {
        acc[0] = fmaf(pv, zr[0], acc[0]);
      }
    }
#pragma unroll
    for (int u = 0; u < OB; ++u) out[p * O + o0 + u] = acc[u];
  }

  // dx of the chunk's rows: element (m, c) gathers the nine taps
  if (want_dx) {
    for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
      const int r = e / C, c = e - r * C, m = m0 + r;
      const int t = m / W, xx = m - t * W, yy = t - t / H * H;
      float acc = 0.f;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int i = tap / 3, j = tap % 3;
        const int sy = yy + 1 - i, sx = xx + 1 - j;
        if (sy < 0 || sy >= H || sx < 0 || sx >= W) continue;
        const float* zr = zs + (m + (1 - i) * W + (1 - j) - mlo) * O;
        const float* wt = wsm + (tap * C + c) * LW;
        float d = 0.f;
        if constexpr (V4) {
#pragma unroll
          for (int o = 0; o < O; o += 4) {
            const float4 zv = *reinterpret_cast<const float4*>(zr + o);
            const float4 wv = *reinterpret_cast<const float4*>(wt + o);
            d = fmaf(zv.x, wv.x, d);
            d = fmaf(zv.y, wv.y, d);
            d = fmaf(zv.z, wv.z, d);
            d = fmaf(zv.w, wv.w, d);
          }
        } else {
          for (int o = 0; o < O; ++o) d = fmaf(zr[o], wt[o], d);
        }
        acc = rnd<T>(__fadd_rn(acc, rnd<T>(d)));
      }
      dx[((size_t)k * M + m) * C + c] = to<T>(acc);
    }
  }

}

template <typename T, int CC, int OO>
__global__ void __launch_bounds__(kThreads, 3)
conv_pool_bwd_kernel(const T* __restrict__ pat, const T* __restrict__ eq,
                     const T* __restrict__ relu_m, const T* __restrict__ da,
                     const T* __restrict__ w, float* __restrict__ part,
                     int* __restrict__ counters, float* __restrict__ dw,
                     float* __restrict__ db, T* __restrict__ dx, int B, int H,
                     int W, int Crt, int Ort, int R, int nchunks) {
  const int C = CC ? CC : Crt, O = OO ? OO : Ort;
  const int P = 9 * C, NP = B * (H / 2) * (W / 2);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int last, fin;  // counted user k's last partial; finishes dW
  if (threadIdx.x == 0) last = 0;
  const int k = blockIdx.y, chunk = blockIdx.x;
  const ConvBwdSmem L(R, W, C, O, (int)sizeof(T), dx != nullptr);
  if (chunk == nchunks)
    conv_db(da, relu_m, db, reinterpret_cast<float*>(smem_raw), k, NP, O);
  if (chunk < nchunks) {
    conv_bwd_chunk<T, CC, OO>(pat, eq, relu_m, da, w, part, dx, smem_raw, L,
                              k, chunk, B, H, W, Crt, Ort, R, nchunks);
    // the partial is counted: every thread's stores are published by its
    // fence before the barrier, and the block that counts the last
    // partial fences again
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) {
      last = atomicAdd(counters + k, 1) == nchunks - 1;
      if (last) __threadfence();
    }
  }

  // the cluster of the block that counted the last partial finishes dW,
  // its blocks a share of the columns each: every block's `last` is read
  // across the cluster (distributed shared memory) between two cluster
  // barriers, and the finishing blocks fence before they read the
  // partials (through L2)
  const int ncl = cluster_size();
  if (ncl == 1) {
    __syncthreads();
    if (!last) return;
  } else {
    cluster_sync();
    if (threadIdx.x == 0) {
      int any = 0;
      for (int r = 0; r < ncl; ++r) any |= ld_cluster(&last, r);
      fin = any;
    }
    cluster_sync();
    if (!fin) return;
    __threadfence();
  }

  // dW: every chunk's partial summed in chunk order, a thread a column,
  // 32 loads ahead of the adds (a share is at most 256 columns where dW
  // is wide, so one round trip to L2)
  const int PO = P * O;
  const int share = (PO + ncl - 1) / ncl;
  const int c0 = cluster_rank() * share, c1 = min(PO, c0 + share);
  const float* pu = part + (size_t)k * nchunks * PO;
  for (int i = c0 + threadIdx.x; i < c1; i += blockDim.x) {
    float s = 0.f;
    for (int b0 = 0; b0 < nchunks; b0 += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        v[u] = b0 + u < nchunks ? __ldcg(pu + (size_t)(b0 + u) * PO + i) : 0.f;
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (b0 + u < nchunks) s = __fadd_rn(s, v[u]);
    }
    dw[(size_t)k * PO + i] = s;
  }
  if (last && threadIdx.x == 0) counters[k] = 0;
}

// ---------------------------------------------------------------------------
// host-side launchers, one per __global__ function and compute type
// ---------------------------------------------------------------------------
// the SMs of the current device (132 on an H100 SXM)
inline int sm_count() {
  int dev = 0, nsm = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  return nsm;
}

template <typename T, int CC, int OO, int OT>
int conv_fwd_run(const void* x, const void* w, const void* b, void* a,
                 void* pat, void* eq, void* relu_m, int B, int H, int W,
                 int C, int O, int nph, int bands, long long blocks,
                 size_t smem, int write_res, void* stream) {
  const auto kernel = conv_pool_fwd_kernel<T, CC, OO, OT>;
  int rc = set_smem((const void*)kernel, smem);
  if (rc) return rc;
  // a thread per (pooled position, OT channels) of a band, 128 to 256
  // (the copies want the threads)
  const int items = O / OT * nph * (W / 2);
  const int threads =
      std::min(kThreads, std::max(128, (items + 31) / 32 * 32));
  kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)w, (const T*)b, (T*)a, (T*)pat, (T*)eq,
      (T*)relu_m, B, H, W, C, O, nph, bands, write_res);
  return (int)cudaGetLastError();
}

template <typename T, int CC, int OO>
int conv_fwd_launch(const void* x, const void* w, const void* b, void* a,
                    void* pat, void* eq, void* relu_m, int K, int B, int H,
                    int W, int C, int O, int write_res, void* stream) {
  // bands of nph pooled rows: whole images where there are enough of them
  // to give each SM 4 blocks (the eval's B = 1000), else as many bands as
  // that takes (the round's 100 images: 5 of conv1's 14 rows, 4 of
  // conv2's 7; one user's 10: a band a row)
  const int PH = H / 2, images = K * B;
  int bands =
      std::min(PH, std::max(1, (4 * sm_count() + images - 1) / images));
  const int nph = (PH + bands - 1) / bands;
  bands = (PH + nph - 1) / nph;
  const long long blocks = (long long)images * bands;
  const size_t smem =
      ConvFwdSmem(nph, W, C, O, (int)sizeof(T), write_res).total;
  if (smem > 227 * 1024 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if constexpr (OO == 16)
    if (bands > 1)
      return conv_fwd_run<T, CC, OO, 2>(x, w, b, a, pat, eq, relu_m, B, H,
                                        W, C, O, nph, bands, blocks, smem,
                                        write_res, stream);
  return conv_fwd_run<T, CC, OO, OO ? 4 : 1>(x, w, b, a, pat, eq, relu_m, B,
                                             H, W, C, O, nph, bands, blocks,
                                             smem, write_res, stream);
}

template <typename T>
int conv_pool_fwd(const void* x, const void* w, const void* b, void* a,
                  void* pat, void* eq, void* relu_m, int K, int B, int H,
                  int W, int C, int O, int write_res, void* stream) {
  if (C == 1 && O == 8)
    return conv_fwd_launch<T, 1, 8>(x, w, b, a, pat, eq, relu_m, K, B, H, W,
                                    C, O, write_res, stream);
  if (C == 8 && O == 16)
    return conv_fwd_launch<T, 8, 16>(x, w, b, a, pat, eq, relu_m, K, B, H,
                                     W, C, O, write_res, stream);
  return conv_fwd_launch<T, 0, 0>(x, w, b, a, pat, eq, relu_m, K, B, H, W, C,
                                  O, write_res, stream);
}

template <typename T, int CC, int OO>
int conv_bwd_launch(const void* pat, const void* eq, const void* relu_m,
                    const void* da, const void* w, float* part,
                    int* counters, float* dw, float* db, void* dx, int K,
                    int B, int H, int W, int C, int O, int R, int nchunks,
                    void* stream) {
  const size_t smem =
      ConvBwdSmem(R, W, C, O, (int)sizeof(T), dx != nullptr).total;
  if (smem > 227 * 1024 || O > kThreads || K > 65535 || nchunks < 1)
    return (int)cudaErrorInvalidValue;
  const auto kernel = conv_pool_bwd_kernel<T, CC, OO>;
  int rc = set_smem((const void*)kernel, smem);
  if (rc) return rc;
  // the nchunks chunk blocks of each user and its db block, padded to
  // whole clusters
  const unsigned ncl = 9 * C * O >= kClusterMinCols ? kCluster : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((nchunks + ncl) / ncl * ncl, K);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, (const T*)pat, (const T*)eq, (const T*)relu_m,
      (const T*)da, (const T*)w, part, counters, dw, db, (T*)dx, B, H, W, C,
      O, R, nchunks);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <typename T>
int conv_pool_bwd(const void* pat, const void* eq, const void* relu_m,
                  const void* da, const void* w, float* part, int* counters,
                  float* dw, float* db, void* dx, int K, int B, int H, int W,
                  int C, int O, int R, int nchunks, void* stream) {
  if (C == 1 && O == 8)
    return conv_bwd_launch<T, 1, 8>(pat, eq, relu_m, da, w, part, counters,
                                    dw, db, dx, K, B, H, W, C, O,
                                    R, nchunks, stream);
  if (C == 8 && O == 16)
    return conv_bwd_launch<T, 8, 16>(pat, eq, relu_m, da, w, part,
                                     counters, dw, db, dx, K, B, H, W, C, O,
                                     R, nchunks, stream);
  return conv_bwd_launch<T, 0, 0>(pat, eq, relu_m, da, w, part, counters,
                                  dw, db, dx, K, B, H, W, C, O, R, nchunks,
                                  stream);
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
  int nt = std::max(sm_count() / K - 1, (F + kThreads - 1) / kThreads);
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

// part: K * nchunks * 9C * O floats of scratch; counters: K ints, 0 on
// entry and on return
API int fcnn_conv_pool_bwd(const void* pat, const void* eq,
                           const void* relu_m, const void* da, const void* w,
                           float* part, int* counters, float* dw, float* db,
                           void* dx, int K, int B, int H, int W, int C, int O,
                           int R, int nchunks, int is_bf16, void* stream) {
  return DISPATCH(is_bf16, conv_pool_bwd, pat, eq, relu_m, da, w, part,
                  counters, dw, db, dx, K, B, H, W, C, O, R, nchunks, stream);
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

API int fcnn_user_conv_pool_bwd(const void* pat, const void* eq,
                                const void* relu_m, const void* da,
                                const void* w, float* part, int* counters,
                                float* dw, float* db, void* dx, int B, int H,
                                int W, int C, int O, int R, int nchunks,
                                int is_bf16, void* stream) {
  return DISPATCH(is_bf16, conv_pool_bwd, pat, eq, relu_m, da, w, part,
                  counters, dw, db, dx, 1, B, H, W, C, O, R, nchunks, stream);
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
