// Hand-written Hopper (sm_90a) kernels for the capacity dispatch and the
// combine of the mixture-of-experts FFN (models/moe.py, the scatter path on
// plain tensors outside autograd).
//
// They replace no TPU kernel: the JAX package computes the dispatch and the
// combine in jnp (src/repro/models/moe.py), and the port first did the same
// in plain PyTorch.  They were added because that plain code was 42.6% of
// the device time of a Granite-MoE prefill on the H100 (PERF.md): a one-hot
// cumsum for the slots, every token copied k times, a zero-filled buffer
// written again by index_copy_, a concatenated zero row and a (T·k, d)
// weighted intermediate in the combine, about 5.8 GB a layer at T = 18432,
// k = 8, E = 40, C = 4608, d = 1536 in bf16.
//
// What bounds them.  No arithmetic to speak of: bytes at 3.35 TB/s (H100
// SXM HBM3).  The dispatch needs x read once (T·d), the (E, C, d) buffer
// written once; the combine needs each kept expert row read once and y
// written once (T·d): about 1.1 GB a layer at that shape, ~0.33 ms.
//
//   moe_slots    -> slot_count_kernel, slot_scan_kernel, slot_rank_kernel
//   moe_scatter  -> scatter_kernel
//   moe_combine  -> combine_kernel<bf16 | float>
//
// Slots, exact.  A route's place in its expert is the number of earlier
// routes (token-major order) to the same expert; past the capacity C the
// route is dropped (slot E·C, keep 0): the plain path's rule bit for bit.
// The routes are cut into chunks of kChunk, one warp each.  (1) Each warp
// counts its chunk's routes per expert (shared-memory atomics: a count has
// no order).  (2) One warp per expert scans the chunks' counts into each
// chunk's exclusive offset and the expert's total.  (3) Each warp walks its
// chunk again, 32 routes at a time, in order: __match_any_sync groups the
// lanes that route to one expert, a lane's rank is the chunk's running
// count of that expert plus the popcount of its peers on lower lanes, and
// the lowest peer adds the group's size to the running count.  Each warp
// loads its whole chunk into registers before it walks it, so the walk
// waits on one load latency, not on one a step.
//
// Scatter.  One block a token reads the token's row of x once, a 16-byte
// vector a thread, and stores it to each of the token's kept slots.  The
// blocks after the T token blocks write zeros to each expert's unfilled
// tail [min(count_e, C), C), kZeroRows buffer rows a block: every byte of
// the buffer is written exactly once, and nothing else is written.
//
// Combine.  One block a token, a 16-byte vector of the output a thread:
// y[t] = sum_j w_j * out[slot_j] over the token's kept routes in route
// order j = 0..k-1, summed in f32 registers and rounded once to the
// output's dtype.  Each product is rounded to the dtype before it is
// added, as the reference (src/repro/models/moe.py, a bf16 product then a
// sum over k) and the plain path round it: the f32 product of two bf16
// values is exact, so its one rounding to bf16 gives their bits.  Summing
// the unrounded products instead moved a route of a later layer against
// the reference in the port's bf16 tests.  (__fmul_rn and __fadd_rn: the
// twin's separate multiply and add; no contraction into an FMA.)  A
// dropped route is skipped: it reads nothing.  A thread starts the loads
// of up to kUnroll routes before it adds any.
//
// Interface: plain C functions, bound with ctypes.  Each launches on the
// given stream and returns the first cudaGetLastError() that is not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define API extern "C" __attribute__((visibility("default")))

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kChunk = 512;         // routes a warp ranks in order
constexpr int kPerLane = kChunk / 32;
constexpr int kSlotWarps = 4;       // chunks a block (count and rank)
constexpr int kScanWarps = 8;       // experts a block (scan)
constexpr int kZeroRows = 128;      // buffer rows a zero block covers
constexpr int kMaxThreads = 256;    // threads a token block, at most
constexpr int kUnroll = 8;          // routes loaded ahead in the combine

// a route's expert, or -1 where it is out of range (such a route is
// counted nowhere and dropped; the router's top-k never makes one)
__device__ __forceinline__ int expert_of(const long long* flat_e,
                                         long long r, long long N, int E) {
  if (r >= N) return -1;
  const long long e = flat_e[r];
  return (e >= 0 && e < E) ? (int)e : -1;
}

__global__ void __launch_bounds__(32 * kSlotWarps)
slot_count_kernel(const long long* __restrict__ flat_e, long long N, int E,
                  int nchunks, int* __restrict__ chunk_counts) {
  extern __shared__ int hist_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kSlotWarps + warp;
  if (chunk >= nchunks) return;
  int* hist = hist_all + warp * E;
  for (int e = lane; e < E; e += 32) hist[e] = 0;
  const long long base = (long long)chunk * kChunk;
  int ev[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    ev[i] = expert_of(flat_e, base + i * 32 + lane, N, E);
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    if (ev[i] >= 0) atomicAdd(&hist[ev[i]], 1);
  __syncwarp();
  for (int e = lane; e < E; e += 32)
    chunk_counts[(long long)chunk * E + e] = hist[e];
}

// chunk_counts (nchunks, E): each chunk's count in, its exclusive offset
// (the routes to e in earlier chunks) out; counts[e] the total
__global__ void __launch_bounds__(32 * kScanWarps)
slot_scan_kernel(int* __restrict__ chunk_counts, int nchunks, int E,
                 int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kScanWarps + (threadIdx.x >> 5);
  if (e >= E) return;
  // lane l owns the consecutive chunks [c0, c1)
  const int per = (nchunks + 31) / 32;
  const int c0 = min(lane * per, nchunks), c1 = min(c0 + per, nchunks);
  int sum = 0;
  for (int c = c0; c < c1; ++c) sum += chunk_counts[(long long)c * E + e];
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += t;
  }
  int run = incl - sum;
  for (int c = c0; c < c1; ++c) {
    const long long i = (long long)c * E + e;
    const int v = chunk_counts[i];
    chunk_counts[i] = run;
    run += v;
  }
  if (lane == 31) counts[e] = incl;
}

__global__ void __launch_bounds__(32 * kSlotWarps)
slot_rank_kernel(const long long* __restrict__ flat_e, long long N, int E,
                 int C, int nchunks, const int* __restrict__ offsets,
                 long long* __restrict__ slot,
                 unsigned char* __restrict__ keep) {
  extern __shared__ int run_all[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kSlotWarps + warp;
  if (chunk >= nchunks) return;
  int* run = run_all + warp * E;
  for (int e = lane; e < E; e += 32)
    run[e] = offsets[(long long)chunk * E + e];
  const long long base = (long long)chunk * kChunk;
  const long long EC = (long long)E * C;
  int ev[kPerLane];
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    ev[i] = expert_of(flat_e, base + i * 32 + lane, N, E);
  __syncwarp();
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const long long r = base + i * 32 + lane;
    const int e = ev[i];
    // the lanes of this step that route to the same expert (the lanes
    // past N or out of range share -1, and take no rank)
    const unsigned peers = __match_any_sync(kFull, e);
    const int pos = e >= 0 ? run[e] + __popc(peers & lower) : 0;
    __syncwarp();
    if (e >= 0 && (__ffs(peers) - 1) == lane) run[e] += __popc(peers);
    __syncwarp();
    if (r < N) {
      const bool kept = e >= 0 && pos < C;
      slot[r] = kept ? (long long)e * C + pos : EC;
      keep[r] = kept ? 1 : 0;
    }
  }
}

// blocks [0, T): token t's row of x to each of its kept slots; blocks
// [T, T + ceil(E·C / kZeroRows)): zeros over the experts' unfilled tails
__global__ void __launch_bounds__(kMaxThreads)
scatter_kernel(const uint4* __restrict__ x, const long long* __restrict__ slot,
               const int* __restrict__ counts, uint4* __restrict__ buf,
               int T, int k, int E, int C, int nvec) {
  const long long EC = (long long)E * C;
  if ((int)blockIdx.x < T) {
    const long long t = blockIdx.x;
    const long long* st = slot + t * k;
    const uint4* xr = x + t * nvec;
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
      const uint4 val = __ldg(xr + v);
      for (int j = 0; j < k; ++j) {
        const long long s = __ldg(st + j);
        if (s < EC) buf[s * nvec + v] = val;
      }
    }
    return;
  }
  const long long r0 = (long long)(blockIdx.x - T) * kZeroRows;
  const long long r1 = min(r0 + kZeroRows, EC);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (long long e = r0 / C; e < E && e * C < r1; ++e) {
    const long long fill = min((long long)counts[e], (long long)C);
    const long long a = max(r0, e * C + fill), b = min(r1, (e + 1) * C);
    if (a >= b) continue;
    uint4* dst = buf + a * nvec;
    const long long n = (b - a) * nvec;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) dst[i] = zero;
  }
}

template <typename T>
struct Pack;

template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;    // values a 16-byte vector
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&p);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  static __device__ __forceinline__ float weight(const void* w, long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(w)[i]);
  }
  // a product as the dtype holds it
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

template <>
struct Pack<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  static __device__ __forceinline__ float weight(const void* w, long long i) {
    return static_cast<const float*>(w)[i];
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
combine_kernel(const uint4* __restrict__ out,
               const long long* __restrict__ slot,
               const void* __restrict__ w, uint4* __restrict__ y, int k,
               long long EC, int nvec) {
  using P = Pack<T>;
  const long long t = blockIdx.x;
  const long long* st = slot + t * k;
  for (int v = threadIdx.x; v < nvec; v += blockDim.x) {
    float acc[P::N];
#pragma unroll
    for (int i = 0; i < P::N; ++i) acc[i] = 0.0f;
    for (int j0 = 0; j0 < k; j0 += kUnroll) {
      uint4 row[kUnroll];
      float wj[kUnroll];
      bool ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + u;
        const long long s = j < k ? __ldg(st + j) : EC;
        ok[u] = s < EC;
        row[u] = ok[u] ? __ldg(out + s * nvec + v) : make_uint4(0u, 0u, 0u, 0u);
        wj[u] = ok[u] ? P::weight(w, t * k + j) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (!ok[u]) continue;
        float f[P::N];
        P::unpack(row[u], f);
#pragma unroll
        for (int i = 0; i < P::N; ++i)
          acc[i] = __fadd_rn(acc[i], P::round(__fmul_rn(wj[u], f[i])));
      }
    }
    y[t * nvec + v] = P::pack(acc);
  }
}

// threads of a token block: the row's 16-byte vectors, whole warps
int token_threads(int nvec) {
  const int warps = (nvec + 31) / 32;
  return warps * 32 < kMaxThreads ? warps * 32 : kMaxThreads;
}

}  // namespace

API const char* moe_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// flat_e (N,) int64 -> slot (N,) int64, keep (N,) uint8, counts (E,)
// int32; scratch: (ceil(N / 512) · E,) int32.  E <= 1024 (the wrapper
// checks).
API int moe_slots(const long long* flat_e, long long* slot,
                  unsigned char* keep, int* counts, int* scratch, long long N,
                  int E, int C, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nchunks = (int)((N + kChunk - 1) / kChunk);
  const unsigned blocks = (unsigned)((nchunks + kSlotWarps - 1) / kSlotWarps);
  const size_t smem = sizeof(int) * kSlotWarps * E;
  slot_count_kernel<<<blocks, 32 * kSlotWarps, smem, s>>>(flat_e, N, E,
                                                          nchunks, scratch);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  slot_scan_kernel<<<(E + kScanWarps - 1) / kScanWarps, 32 * kScanWarps, 0,
                     s>>>(scratch, nchunks, E, counts);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  slot_rank_kernel<<<blocks, 32 * kSlotWarps, smem, s>>>(
      flat_e, N, E, C, nchunks, scratch, slot, keep);
  return (int)cudaGetLastError();
}

// x (T, row_bytes) -> buf (E·C, row_bytes), from the slots of moe_slots;
// row_bytes % 16 == 0, both pointers 16-byte aligned.
API int moe_scatter(const void* x, const long long* slot, const int* counts,
                    void* buf, int T, int k, int E, int C, int row_bytes,
                    void* stream) {
  const int nvec = row_bytes / 16;
  const long long zero_blocks = ((long long)E * C + kZeroRows - 1) / kZeroRows;
  scatter_kernel<<<(unsigned)(T + zero_blocks), token_threads(nvec), 0,
                   (cudaStream_t)stream>>>(
      static_cast<const uint4*>(x), slot, counts, static_cast<uint4*>(buf), T,
      k, E, C, nvec);
  return (int)cudaGetLastError();
}

// out (E·C, d), slot (T·k,), w (T·k,) -> y (T, d), in bf16 (bf16 = 1) or
// f32; d·size % 16 == 0, out and y 16-byte aligned.
API int moe_combine(const void* out, const long long* slot, const void* w,
                    void* y, int T, int k, long long EC, int d, int bf16,
                    void* stream) {
  const int nvec = bf16 ? d / 8 : d / 4;
  const dim3 grid((unsigned)T), block(token_threads(nvec));
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    combine_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const uint4*>(out), slot, w, static_cast<uint4*>(y), k,
        EC, nvec);
  else
    combine_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const uint4*>(out), slot, w, static_cast<uint4*>(y), k,
        EC, nvec);
  return (int)cudaGetLastError();
}
