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
// bf16; the exact f32 function has no tensor core, so the state stays on
// the CUDA cores.
//
// Design.  Output column j depends only on column j of S:
// S_ij <- w_i S_ij + k_i v_j and y_j = sum_i r_i S_ij + v_j a with a =
// sum_i r_i u_i k_i.  So
// - a head's D columns are split over D / C blocks, C = 32 where D allows
//   (else 16; grid (B*H, D / C)), and the blocks exchange nothing: at
//   RWKV6-7B's shape 256 blocks of two warps, two to an SM;
// - a thread holds a register tile of 8 rows x 4 columns of S: rows 4g ..
//   4g+3 and D/2 + 4g .. D/2 + 4g+3 (row group g), so that the 4-wide
//   reads of r, k and w by the row groups of a warp fall on neighbouring
//   banks, each read feeding 4 columns.  Per element and step: one FFMA
//   (r S), one FMUL (k v) and one FFMA (w S + k v), 3 instructions; bf16
//   is widened to f32 in registers as it is read;
// - the block stages 16 timesteps of r, k, w (whole rows) and v (its C
//   columns) at a time with cp.async in a ring of 3 stages, so the next
//   two chunks land while one is consumed;
// - a thread writes its 4 partial sums over its 8 rows (ascending i) to
//   shared memory each step; after the chunk a pass adds the row groups'
//   partials in ascending g and adds v_j a, and writes y 8 columns (16
//   bytes at bf16) a thread.  a is 4 partial dots of D/4 rows each, a
//   (t, part) item a thread, added as (a0 + a1) + (a2 + a3); an item
//   starts 4 t rows into its part, so the items of a warp read distinct
//   banks.  The partial-sum rows are padded by 16 bytes for the same
//   reason.
// Every sum runs in a fixed order and there are no atomics, so the bits
// are the same on every run.  The TPU's sequential chunk axis becomes the
// loop over staged chunks, so the reference's `chunk` changes nothing
// here.  Any S >= 1; D in {16, 32, 48, 64, 80, 96, 128}.
//
// What still bounds it: the step loop, issued by one warp per scheduler
// (the shape has about as many warps as the card has schedulers) with
// nothing to hide its latencies, well below one instruction a cycle; the
// staging waits, the bonus pass and the y pass share the rest.  Splitting
// the rows over more warps (4 x 4 tiles), deeper rings, TMA bulk copies,
// widening bf16 in a separate pass and folding the bonus dot into the step
// loop were each slower on the card.  The tensor cores stay unused for the
// reason above.
//
// Interface: plain C functions, bound with ctypes.  Each launches one
// __global__ function on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define API extern "C" __attribute__((visibility("default")))

namespace {

constexpr int kRows = 8;       // state rows per thread
constexpr int kCols = 4;       // state columns per thread
// columns of a head per block: 32 where D allows (half the copies of r, k
// and w that the blocks of a head each stage), else 16
template <int D>
constexpr int kBlockCols = D % 32 == 0 ? 32 : 16;
constexpr int kT = 16;         // timesteps per staged chunk
constexpr int kStages = 3;     // chunks in the cp.async ring
constexpr int kParts = 4;      // partial dots of the bonus scalar a

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four consecutive elements at p, widened to f32 (16-byte aligned at f32,
// 8-byte at bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const bf16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

// the row of S that a thread of row group g holds in its slot ii: 4g ..
// 4g+3 and D/2 + 4g .. D/2 + 4g+3
template <int D>
__device__ __forceinline__ int row_of(int g, int ii) {
  return (ii < 4 ? 4 * g : D / 2 + 4 * g) + ii % 4;
}

// a thread's rows of one staged row of D elements, widened to f32
template <int D, typename T>
__device__ __forceinline__ void load_rows(const T* row, int g,
                                          float (&out)[kRows]) {
#pragma unroll
  for (int h = 0; h < kRows; h += 4) {
    const float4 a = load4(row + row_of<D>(g, h));
    out[h] = a.x; out[h + 1] = a.y; out[h + 2] = a.z; out[h + 3] = a.w;
  }
}

// 8 f32 values to 8 consecutive elements of T at p (16-byte aligned)
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 out;
  unsigned* o = &out.x;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    o[e] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = out;
}

// shared-memory layout of one block, in bytes; every region 16-aligned.
// The rows of the partial sums (one a timestep) are padded by 16 bytes, so
// that the pass over the chunk, a timestep per lane pair, reads them on
// distinct banks
template <typename T, int D>
struct Smem {
  static constexpr int kG = D / kRows;                   // row groups
  static constexpr int kBC = kBlockCols<D>;              // block's columns
  static constexpr int kPS = kG * kBC + 4;               // part row, floats
  static constexpr int r = 0;                            // [kT][D] T
  static constexpr int k = r + kT * D * (int)sizeof(T);  // [kT][D] T
  static constexpr int w = k + kT * D * (int)sizeof(T);  // [kT][D] f32
  static constexpr int v = w + kT * D * 4;               // [kT][16] T
  static constexpr int stage = v + kT * kBC * (int)sizeof(T);
  static constexpr int part = kStages * stage;           // [kT][kPS] f32
  static constexpr int bonus = part + kT * kPS * 4;      // [kT][4] f32
  static constexpr int u = bonus + kT * kParts * 4;      // [D] f32
  static constexpr int total = u + D * 4;
};

template <typename T, int D>
__global__ void __launch_bounds__(D / kRows * (kBlockCols<D> / kCols))
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ y,
            float* __restrict__ sfin, int S) {
  using L = Smem<T, D>;
  constexpr int BC = kBlockCols<D>;
  constexpr int NT = D / kRows * (BC / kCols);  // row groups x column quads
  constexpr int G = L::kG, PS = L::kPS;
  constexpr int DP = D / kParts;    // rows of a bonus part
  extern __shared__ __align__(16) unsigned char smem[];
  float* part = reinterpret_cast<float*>(smem + L::part);
  float* bonus = reinterpret_cast<float*>(smem + L::bonus);
  float* us = reinterpret_cast<float*>(smem + L::u);

  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * BC;   // the block's first column
  const int tid = threadIdx.x;
  constexpr int Q = BC / kCols;     // column quads of a block
  const int cq = tid % Q, g = tid / Q;
  const long long base = (long long)bh * S * D;
  const int nchunks = (S + kT - 1) / kT;

  // start copying chunk c (timesteps c*kT ..) into its ring stage
  auto issue = [&](int c) {
    if (c < nchunks) {
      unsigned char* st = smem + (c % kStages) * L::stage;
      const int t0 = c * kT, n = min(kT, S - t0);
      const long long off = base + (long long)t0 * D;
      constexpr int VT = 16 / (int)sizeof(T);  // elements of T in 16 bytes
      const int nrk = n * D / VT;              // 16-byte pieces of r, of k
      for (int e = tid; e < nrk; e += NT) {
        cp_async16(st + L::r + 16 * e, r + off + e * VT);
        cp_async16(st + L::k + 16 * e, k + off + e * VT);
      }
      for (int e = tid; e < n * D / 4; e += NT)
        cp_async16(st + L::w + 16 * e, w + off + e * 4);
      constexpr int VR = BC / VT;              // 16-byte pieces of a v row
      for (int e = tid; e < n * VR; e += NT) {
        const int t = e / VR, p = e % VR;
        cp_async16(st + L::v + 16 * e,
                   v + off + (long long)t * D + j0 + p * VT);
      }
    }
    cp_async_commit();             // an empty group keeps the count
  };

  for (int i = tid; i < D; i += NT) us[i] = u[(long long)bh * D + i];
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  float st[kRows][kCols];
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
    for (int c = 0; c < kCols; ++c) st[ii][c] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<kStages - 2>();  // chunk c has landed
    __syncthreads();               // ... for every thread; chunk c-1 spent
    issue(c + kStages - 1);
    const unsigned char* sb = smem + (c % kStages) * L::stage;
    const T* rs = reinterpret_cast<const T*>(sb + L::r);
    const T* ks = reinterpret_cast<const T*>(sb + L::k);
    const float* ws = reinterpret_cast<const float*>(sb + L::w);
    const T* vs = reinterpret_cast<const T*>(sb + L::v);
    const int t0 = c * kT, n = min(kT, S - t0);

    // the bonus scalar's partial dots, a (t, p) item a thread at a time:
    // a_p = sum_i r_i u_i k_i over the rows p D/4 .. (p + 1) D/4 - 1,
    // each item in a fixed order that starts 4 t rows into its part (so
    // the items of one warp read distinct banks); a = (a0 + a1) + (a2 + a3)
    for (int o = tid; o < n * kParts; o += NT) {
      const int t = o / kParts, i0 = (o % kParts) * DP;
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < DP; m += 4) {
        const int i = i0 + (m + 4 * t) % DP;
        const float4 rr = load4(rs + t * D + i), kk = load4(ks + t * D + i);
        const float4 uu = load4(us + i);
        acc = fmaf(__fmul_rn(rr.x, uu.x), kk.x, acc);
        acc = fmaf(__fmul_rn(rr.y, uu.y), kk.y, acc);
        acc = fmaf(__fmul_rn(rr.z, uu.z), kk.z, acc);
        acc = fmaf(__fmul_rn(rr.w, uu.w), kk.w, acc);
      }
      bonus[o] = acc;
    }

    // the recurrence: partial y over this thread's rows, then the update
    for (int t = 0; t < n; ++t) {
      float rr[kRows], kk[kRows], ww[kRows];
      load_rows<D>(rs + t * D, g, rr);
      load_rows<D>(ks + t * D, g, kk);
      load_rows<D>(ws + t * D, g, ww);
      const float4 vq = load4(vs + t * BC + 4 * cq);
      const float vv[kCols] = {vq.x, vq.y, vq.z, vq.w};
      float acc[kCols] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ii = 0; ii < kRows; ++ii)
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          acc[cc] = fmaf(rr[ii], st[ii][cc], acc[cc]);
          st[ii][cc] = fmaf(ww[ii], st[ii][cc], __fmul_rn(kk[ii], vv[cc]));
        }
      *reinterpret_cast<float4*>(part + t * PS + g * BC + 4 * cq) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();

    // y for the chunk: 8 of the block's columns a thread
    constexpr int E = BC / 8;
    for (int o = tid; o < n * E; o += NT) {
      const int t = o / E, h = (o % E) * 8;
      float yv[8];
      const float* p = part + t * PS + h;
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const float4 q = load4(p + e);
        yv[e] = q.x; yv[e + 1] = q.y; yv[e + 2] = q.z; yv[e + 3] = q.w;
      }
      for (int gg = 1; gg < G; ++gg) {
#pragma unroll
        for (int e = 0; e < 8; e += 4) {
          const float4 q = load4(p + gg * BC + e);
          yv[e] += q.x; yv[e + 1] += q.y; yv[e + 2] += q.z; yv[e + 3] += q.w;
        }
      }
      const float* bo = bonus + t * kParts;
      const float a = (bo[0] + bo[1]) + (bo[2] + bo[3]);
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        const float4 vq = load4(vs + t * BC + h + e);
        yv[e] = fmaf(vq.x, a, yv[e]);
        yv[e + 1] = fmaf(vq.y, a, yv[e + 1]);
        yv[e + 2] = fmaf(vq.z, a, yv[e + 2]);
        yv[e + 3] = fmaf(vq.w, a, yv[e + 3]);
      }
      store8(y + base + (long long)(t0 + t) * D + j0 + h, yv);
    }
  }

  float* sf = sfin + (long long)bh * D * D + j0 + 4 * cq;
#pragma unroll
  for (int ii = 0; ii < kRows; ++ii) {
    const int i = row_of<D>(g, ii);
    *reinterpret_cast<float4*>(sf + (long long)i * D) =
        make_float4(st[ii][0], st[ii][1], st[ii][2], st[ii][3]);
  }
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, void* y, float* sfin, int BH, int S,
           void* stream) {
  constexpr int smem = Smem<T, D>::total;
  // set on every launch: the attribute is per device, and the call costs
  // far less than the kernel
  const cudaError_t e = cudaFuncSetAttribute(
      wkv6_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int BC = kBlockCols<D>;
  const dim3 grid((unsigned)BH, D / BC);
  wkv6_kernel<T, D><<<grid, D / kRows * (BC / kCols), smem,
                      (cudaStream_t)stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, static_cast<T*>(y), sfin, S);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* r, const void* k, const void* v, const float* w,
             const float* u, void* y, float* sfin, int BH, int S, int D,
             void* stream) {
#define WKV6_CASE(d) \
  case d:            \
    return launch<T, d>(r, k, v, w, u, y, sfin, BH, S, stream);
  switch (D) {
    WKV6_CASE(16)
    WKV6_CASE(32)
    WKV6_CASE(48)
    WKV6_CASE(64)
    WKV6_CASE(80)
    WKV6_CASE(96)
    WKV6_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef WKV6_CASE
}

}  // namespace

API const char* wkv6_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// r, k, v, y (BH, S, D) f32 (bf16 = 0) or bf16 (bf16 = 1); w (BH, S, D)
// and u (BH, D) f32; sfin (BH, D, D) f32; all contiguous and 16-byte
// aligned; D in {16, 32, 48, 64, 80, 96, 128}; S >= 1.
API int wkv6_fwd(const void* r, const void* k, const void* v, const float* w,
                 const float* u, void* y, float* sfin, int BH, int S, int D,
                 int bf16, void* stream) {
  if (bf16)
    return dispatch<__nv_bfloat16>(r, k, v, w, u, y, sfin, BH, S, D, stream);
  return dispatch<float>(r, k, v, w, u, y, sfin, BH, S, D, stream);
}
