// Hand-written Hopper (sm_90a) forward flash attention for the model zoo's
// full-sequence path (prefill): online-softmax attention with grouped kv
// heads, causal and sliding-window masks, f32 accumulation.
//
// It replaces the Pallas TPU kernel of
// src/repro/kernels/flash_attention/kernel.py:
//
//   flash_attention_bh  (pallas_call at kernel.py:99) -> flash_fwd_tc_kernel
//                                                       (bf16 inputs)
//                                                       flash_fwd_kernel
//                                                       (f32 inputs)
//
// and computes the function of its _attn_kernel (kernel.py:26-76): s =
// (q . k) * D**-0.5, the scale applied after the dot; masked entries out of
// the softmax; the row max m and sum l kept online with alpha = exp(m_prev
// - m_cur); out = acc / max(l, 1e-20) cast to q's dtype.  Query and key
// ends are aligned (query row r sits at key position r + Sk - Sq, Sq <=
// Sk).  The kv row of q row bh is bh / group.
//
// The dtype picks the kernel, in flash_attention_fwd below.  This is a
// dispatch, not a fallback: a bf16 call never reaches the CUDA-core kernel,
// and a failed launch of either returns its error.
//
// What bounds it.  At Llama-3.2-1B's prefill (B=2, S=2048, 32 q heads, 8
// kv heads, D=64, causal, bf16) the live (q, k) pairs need 34 GFLOP of
// products (q.k and p.v) against 42 MB of q, k, v and out: ~800 FLOP per
// byte, so the work is bounded by operations: 35 us on the bf16 tensor
// cores (989 TFLOP/s), 0.51 ms in f32 on the CUDA cores (67 TFLOP/s).
//
// bf16: flash_fwd_tc_kernel, on the tensor cores.  A block owns one (bh,
// q tile) with one consumer warpgroup per 64 q rows and one producer warp
// (TcShape: one warpgroup and three blocks an SM for D = 32 and 64, two
// warpgroups sharing each k/v tile for D = 128).  Lane 0 of the producer
// loads the q tile once and the 64-row k and v tiles of the wavefront
// (kernel.py:46-50) with TMA into a ring of 3 stages in shared memory, each
// stage with a full and an empty mbarrier.  The tensor maps are 3-D over
// (D, S, heads), so TMA's zero fill stops at each head's ragged tail.
// Tiles are stored as TMA writes them: rows of 64 columns with the
// 128-byte swizzle (D = 64; D = 128 as two 64-column chunks) or rows of 32
// with the 64-byte swizzle (D = 32), and every wgmma descriptor names the
// same swizzle.  D = 80 (hubert-xlarge) runs on the D = 128 instantiation:
// its tensor maps keep the true 80 columns (rows of 160 bytes), so the
// second 64-column box reads columns 80-127 as TMA's zero fill; q . k^T
// adds exact zeros, p . v makes columns 80-127 that are never stored, and
// the epilogue stores the true 80 at the true row stride.  That is 1.6x
// the products of a native m64n80 layout, which would need a 64 + 16
// column split with two swizzle modes.
// - s = q . k^T: wgmma m64n64k16, bf16 in, f32 accumulators, q and k both
//   from shared memory, K-major as stored.
// - Softmax on the accumulator fragment, in base 2 (the scale times
//   log2 e folded into one FMA before ex2.approx): a row's max reduces over
//   the 4 lanes that hold it, the sum l stays a per-lane partial until the
//   end.
//   Only tiles on the causal diagonal, at the window's edge or on the
//   ragged tail are masked element by element; a masked entry is -inf, so
//   p = 0 exactly, and a row that has met no live key keeps m = NEG_INF,
//   alpha = 1 and l = 0.
// - o += p . v: p is rounded to bf16 in registers, where the f32 fragment
//   of s columns [16 k, 16 k + 16) is the A fragment of k-step k as it
//   stands; v is the B operand from shared memory in its stored (Sk, D)
//   layout, MN-major, with the descriptor's transpose bit.  The rounding of
//   p is the one place the kernel departs from the reference's arithmetic
//   (p . v in f32): it moves an output by at most 2**-9 of max |v|.
// - out = acc / max(l, 1e-20), stored as bf16; rows at or past Sq are not
//   stored.
// Heavy (late) causal q tiles of every head run first, and the q heads of
// one kv head run side by side, so they share its k and v tiles in L2.
// chip_smoke.py prints each instantiation's registers and spills from the
// build log (CUDA 12.8 for sm_90a: 95 at D = 32, 115 at D = 64, 147 at D =
// 128 and 146 at D = 80 on it, no spills).
//
// f32: flash_fwd_kernel, on the CUDA cores, all in f32 (FFMA products, an
// f32 softmax; no TF32, which would break its 1e-5 parity with the
// reference).  Bound: the 34.4 GFLOP of Llama's prefill over the 67
// TFLOP/s of f32 FFMA, 0.51 ms (hubert-xlarge's 23.0 GFLOP: 0.34 ms).  Its
// limits are the shared memory's 128 bytes a clock against 128 FMAs a
// clock, and keeping the FMA pipes fed between barriers, so:
// - a block owns 16 NW q rows (NW warps, F32Shape) and walks the 64-row
//   k/v tiles of their wavefront; warp w owns 16 rows, and lane (ty, tx)
//   holds s for 4 of them (16 w + ty + 4 i) x 8 keys (tx + 8 j) in
//   registers.  q, k and v stay row-major in shared memory, rows padded
//   by 4 floats, so each 16-byte read along D is conflict-free: a step of
//   4 d reads 4 q and 8 k float4s (one wavefront each) for 128 FMAs;
// - the k and v tiles load with 16-byte cp.async, one tile ahead of use:
//   the next k tile while this tile's softmax and p . v run, the next v
//   tile while the next s = q . k runs (the copies bypass the
//   registers); two block barriers a tile;
// - p stays with the warp that made it: each warp writes the p of its 16
//   rows into its own rows of a p tile and reads them back as float4s
//   after a __syncwarp; acc += p . v runs 4 keys a step, 4 p and NC / 4 v
//   float4s for 16 NC FMAs (NC = D / 8 output columns a lane: float4
//   groups 32 g + 4 tx, and at D = 80 a float2 at 64 + 2 tx);
// - a row's max reduces over the 8 lanes that hold it (xor shuffles, the
//   same bits in every lane), its sum l stays a per-lane partial until
//   the end; p = 2**((s - m) log2 e) and alpha = 2**((m_prev - m) log2 e)
//   by ex2.approx, the scale multiplied into s after the dot; only warps
//   whose rows meet the causal diagonal, the window's edge or the ragged
//   tail mask element by element, and a warp whose rows meet no live key
//   of a tile skips it.
// Registers (CUDA 12.8, sm_90a; chip_smoke.py prints them from the build
// log): 128 at D = 32 and 64 (two blocks an SM; 12 and 80 bytes spilled),
// 168 at D = 80 and 254 at D = 128 (one block an SM), no spills.
// On an NVIDIA H100 80GB HBM3 at 700 W (scripts/kernel_ab.py and
// chip_smoke.py; the numbers are in PERF.md) it runs at about 35 TFLOP/s,
// ahead of SDPA at both shapes.
//
// Both kernels: the reference computes exp(NEG_INF - NEG_INF) = 1 for a
// row that has met no live key yet and wipes it later with alpha =
// exp(NEG_INF - m) = 0; with Sq <= Sk every row has a live key (its own
// position), so both give the same result.  A ragged tail (S not a
// multiple of the tile) is masked, so any S >= 1 works; q rows past Sq are
// computed on zeros and never stored.
//
// Interface: plain C functions, bound with ctypes.  Each launches one
// __global__ function on the given stream and returns cudaGetLastError().

#include <cuda.h>          // CUtensorMap and its enums only; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define API extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBK = 64;           // k rows per tile (both kernels)
constexpr int kFP = kBK + 4;      // row stride of the p tile
// -0.7 * f32 max rounded to f32, the reference's NEG_INF
constexpr float kNegInf = -2.381976325e+38f;
constexpr float kLog2e = 1.4426950408889634f;

// warps a block (NW, each 16 q rows) and blocks an SM should hold (MINB,
// which caps the registers at 65536 / (32 NW MINB)) per head dim: the
// fastest of a sweep on the H100 (NW 8, 12 or 16; MINB 1 or 2).  D = 32
// and 64 run two 8-warp blocks an SM (128 registers, a few spilled; one
// block an SM without spills was slower); D = 80 one block of 12 warps;
// D = 128 one of 8, whose 254 registers 12 warps would spill
template <int D>
struct F32Shape {
  static constexpr int NW = D == 80 ? 12 : 8, MINB = D <= 64 ? 2 : 1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without registers; zeros where !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + ROWS) of a (rows, D) f32 matrix into shared memory
// with row stride LD, as 16-byte copies in flight (consecutive threads of
// the block's THREADS on consecutive 16 bytes); rows at or past `rows` are
// zeros
template <int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int row0, int rows) {
  constexpr int C4 = D / 4, N = ROWS * C4;
#pragma unroll
  for (int n = 0; n < (N + THREADS - 1) / THREADS; ++n) {
    const int e = threadIdx.x + n * THREADS;
    if (N % THREADS != 0 && e >= N) break;
    const int r = e / C4, c = (e - r * C4) * 4;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * LD + c, src + (long long)(ok ? row0 + r : 0) * D + c,
               ok);
  }
}

// 2**x in one MUFU instruction (2 ulp; subnormal results flushed to 0);
// 2**-inf = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// grid: ceil(Sq / (16 NW)) * BH blocks on one axis, heavy (late) q tiles of
// every head first, and within a tile row the heads in order, so that the
// `group` q heads of one kv head run side by side and share its tiles in
// L2.  Warp w owns q rows [16 w, 16 w + 16) of the tile; lane (ty, tx) =
// (lane / 8, lane % 8) holds s for rows 16 w + ty + 4 i (i < 4) and keys
// tx + 8 j (j < 8) of a k tile, and the output of the same rows at its NC
// columns: 32 g + 4 tx .. + 3 for g < D / 32 and, at D = 80, 64 + 2 tx
// and the next
template <int D, int NW, int MINB>
__global__ void __launch_bounds__(32 * NW, MINB)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int BH,
                 int Sq, int Sk, int group, int causal, int window,
                 float scale) {
  constexpr int LDQ = D + 4, LDK = D + 4, LDV = D;  // row strides (floats)
  constexpr int NF4 = D / 32;          // float4 column groups a lane
  constexpr int HALF = D % 32 != 0;    // D = 80: a float2 group more
  static_assert(D % 32 == 0 || D % 32 == 16, "D = 32 m or 32 m + 16");
  constexpr int NC = 4 * NF4 + 2 * HALF;  // output columns a lane
  constexpr int QR = 16 * NW, THREADS = 32 * NW;  // q rows, threads
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + QR * LDQ;
  float* Vs = Ks + kBK * LDK;
  float* Ps = Vs + kBK * LDV;          // [QR][kFP]

  const int nq = (Sq + QR - 1) / QR;
  const int qt = nq - 1 - (int)(blockIdx.x / (unsigned)BH);
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int q0 = qt * QR;
  const int off = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ty = lane >> 3, tx = lane & 7;
  const int wr = 16 * warp;            // the warp's first row in the tile

  const float* qb = q + (long long)bh * Sq * D;
  const float* kb = k + (long long)(bh / group) * Sk * D;
  const float* vb = v + (long long)(bh / group) * Sk * D;

  // the k tiles inside the wavefront of the block's live rows
  const int nk = (Sk + kBK - 1) / kBK;
  int j_lo = 0, j_hi = nk - 1;
  if (causal) j_hi = min(j_hi, (min(q0 + QR, Sq) - 1 + off) / kBK);
  if (window > 0) j_lo = max(0, q0 + off - window + 1) / kBK;
  // key positions of the warp's first and last rows
  const bool w_rows = q0 + wr < Sq;
  const int first = q0 + wr + off;
  const int last = min(q0 + wr + 16, Sq) - 1 + off;

  stage_rows<D, QR, LDQ, THREADS>(Qs, qb, q0, Sq);
  stage_rows<D, kBK, LDK, THREADS>(Ks, kb, j_lo * kBK, Sk);
  cp_commit();
  stage_rows<D, kBK, LDV, THREADS>(Vs, vb, j_lo * kBK, Sk);
  cp_commit();

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }
  const float* qrow = Qs + (wr + ty) * LDQ;      // + 4 i LDQ
  const float* krow = Ks + tx * LDK;             // + 8 j LDK
  float* prow = Ps + (wr + ty) * kFP;            // + 4 i kFP
  cp_wait<1>();                                  // q and the first k tile
  __syncthreads();

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int k0 = jt * kBK;
    // does the warp meet a live key in this tile?
    const bool live = w_rows && (!causal || k0 <= last) &&
                      (window <= 0 || first - (k0 + kBK - 1) < window);
    // s = q . k for the lane's 4 rows x 8 keys, d in order
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    if (live) {
#pragma unroll 4
      for (int d = 0; d < D; d += 4) {
        float4 a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(qrow + 4 * i * LDQ + d);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 b =
              *reinterpret_cast<const float4*>(krow + 8 * j * LDK + d);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
          }
        }
      }
    }
    cp_wait<0>();                 // this tile's v
    __syncthreads();              // ... visible; every warp done with k
    if (jt < j_hi) {
      stage_rows<D, kBK, LDK, THREADS>(Ks, kb, k0 + kBK, Sk);
      cp_commit();
    }

    if (live) {
      // scale after the dot; mask only where the warp's rows meet the
      // causal diagonal, the window's edge or the ragged tail: a masked
      // entry is -inf, so its p is 0 exactly
      const bool edge = k0 + kBK > Sk || (causal && k0 + kBK - 1 > first) ||
                        (window > 0 && last - k0 >= window);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = first + ty + 4 * i;
        float mx = m[i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float x = __fmul_rn(s[i][j], scale);
          if (edge) {
            const int kp = k0 + tx + 8 * j;
            if (!(kp < Sk && (!causal || kp <= qp) &&
                  (window <= 0 || qp - kp < window)))
              x = -INFINITY;
          }
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
        // the row's max over the 8 lanes that hold it (xor shuffles give
        // every lane the same bits)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        // alpha = exp(m_prev - m_cur); a row that has met no live key
        // keeps m = NEG_INF, alpha = 1 and l = 0
        const float alpha = ex2((m[i] - mx) * kLog2e);
        m[i] = mx;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p = ex2((s[i][j] - mx) * kLog2e);
          prow[4 * i * kFP + tx + 8 * j] = p;
          rs += p;
        }
        l[i] = fmaf(l[i], alpha, rs);   // a lane's partial; summed at the end
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      }
      __syncwarp();               // p of the warp's rows, all 64 keys

      // acc += p . v: 4 keys a step, p of the lane's rows as float4s
      const float* vcol = Vs + 4 * tx;
#pragma unroll 2
      for (int c = 0; c < kBK; c += 4) {
        float4 p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[i] = *reinterpret_cast<const float4*>(prow + 4 * i * kFP + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          const float* vr = vcol + (c + cc) * LDV;
          float vv[NC];
#pragma unroll
          for (int g = 0; g < NF4; ++g) {
            const float4 x = *reinterpret_cast<const float4*>(vr + 32 * g);
            vv[4 * g] = x.x; vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z; vv[4 * g + 3] = x.w;
          }
          if constexpr (HALF) {
            const float2 x = *reinterpret_cast<const float2*>(
                Vs + (c + cc) * LDV + 32 * NF4 + 2 * tx);
            vv[4 * NF4] = x.x; vv[4 * NF4 + 1] = x.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pi = cc == 0 ? p[i].x : cc == 1 ? p[i].y
                           : cc == 2 ? p[i].z : p[i].w;
#pragma unroll
            for (int col = 0; col < NC; ++col)
              acc[i][col] = fmaf(pi, vv[col], acc[i][col]);
          }
        }
      }
    }
    cp_wait<0>();                 // the next k tile
    __syncthreads();              // ... visible; every warp done with v, p
    if (jt < j_hi) {
      stage_rows<D, kBK, LDV, THREADS>(Vs, vb, k0 + kBK, Sk);
      cp_commit();
    }
  }

  // out = acc / max(l, 1e-20): l summed over the 8 lanes of the row
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lr = l[i];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    lr += __shfl_xor_sync(0xffffffffu, lr, 4);
    const int r = q0 + wr + ty + 4 * i;
    if (r >= Sq) continue;
    const float denom = fmaxf(lr, 1e-20f);
    float* orow = o + ((long long)bh * Sq + r) * D;
#pragma unroll
    for (int g = 0; g < NF4; ++g)
      *reinterpret_cast<float4*>(orow + 32 * g + 4 * tx) = make_float4(
          __fdiv_rn(acc[i][4 * g], denom), __fdiv_rn(acc[i][4 * g + 1], denom),
          __fdiv_rn(acc[i][4 * g + 2], denom),
          __fdiv_rn(acc[i][4 * g + 3], denom));
    if constexpr (HALF)
      *reinterpret_cast<float2*>(orow + 32 * NF4 + 2 * tx) =
          make_float2(__fdiv_rn(acc[i][4 * NF4], denom),
                      __fdiv_rn(acc[i][4 * NF4 + 1], denom));
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int Sq, int Sk, int group, int causal, int window, float scale,
           void* stream) {
  using S = F32Shape<D>;
  constexpr int QR = 16 * S::NW;
  const auto kernel = flash_fwd_kernel<D, S::NW, S::MINB>;
  constexpr int smem =
      ((D + 4) * QR + (D + 4) * kBK + D * kBK + kFP * QR) * 4;
  // set on every launch: the attribute is per device, and the call costs
  // far less than the kernel
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((Sq + QR - 1) / QR) * BH;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * S::NW, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), BH, Sq, Sk, group,
      causal, window, scale);
  return (int)cudaGetLastError();
}

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int BH,
                 int Sq, int Sk, int D, int group, int causal, int window,
                 float scale, void* stream) {
  switch (D) {
    case 32:
      return launch<32>(q, k, v, o, BH, Sq, Sk, group, causal, window, scale,
                        stream);
    case 64:
      return launch<64>(q, k, v, o, BH, Sq, Sk, group, causal, window, scale,
                        stream);
    case 80:
      return launch<80>(q, k, v, o, BH, Sq, Sk, group, causal, window, scale,
                        stream);
    case 128:
      return launch<128>(q, k, v, o, BH, Sq, Sk, group, causal, window,
                         scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel (TMA loads, wgmma products)
// ---------------------------------------------------------------------------

constexpr int kWG = 64;      // q rows per consumer warpgroup
constexpr int kStages = 3;   // k/v tiles in flight

// consumer warpgroups per block (NWG) and the blocks an SM should hold
// (MINB, which caps the registers) per head size: the fastest without
// spills of a sweep on the H100 (NWG 1-3, 64 or 128 k/v rows, MINB 1-4).
// D = 32 and 64 run three one-warpgroup blocks an SM, so one block's
// softmax overlaps another's products; D = 128 needs the registers of one
// two-warpgroup block an SM, whose warpgroups share each k/v tile
template <int D>
struct TcShape {
  static constexpr int NWG = 1, MINB = 3;
};
template <>
struct TcShape<128> {
  static constexpr int NWG = 2, MINB = 1;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// spin until the barrier's phase of this parity has completed; a wait that
// never ends (a pipeline fault) traps, so the launch fails instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  for (uint32_t polls = 0;; ++polls) {
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

// one box of a 3-D tensor map (column, row, head) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units), swizzle mode (1 = 128B, 2 = 64B)
template <int SW>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  constexpr uint64_t mode = SW == 128 ? 1 : 2;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (mode << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// S (64 x 64, f32) [+]= A (64 x 16, smem) . B (64 x 16, smem)^T, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// O (64 x N, f32) += A (64 x 16, registers) . B (16 x N, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// grid: ceil(Sq / (64 NWG)) * BH blocks, heavy (late) q tiles of every
// head first, and within a tile row the heads in order, so that the
// `group` q heads of one kv head run side by side and share its tiles in
// L2.  Threads [0, 128 NWG): NWG consumer warpgroups of 64 q rows each;
// the last 32: the producer warp, whose lane 0 issues every TMA load.
// DT: the true head dim of q, k, v and o (their row stride and the
// columns stored), DT <= D: D = 128 runs DT = 80
template <int D, int NWG, int MINB, int DT>
__global__ void __launch_bounds__(128 * NWG + 32, MINB)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    __nv_bfloat16* __restrict__ o, int BH, int Sq, int Sk,
                    int group, int causal, int window, float scale_log2) {
  constexpr int TQ = kWG * NWG;         // q rows per block
  constexpr int CONSUMERS = 128 * NWG;
  constexpr int CW = D < 64 ? D : 64;   // columns of one swizzled chunk
  constexpr int NCH = D / CW;           // chunks in a row
  constexpr int SW = CW * 2;            // bytes of a chunk row = swizzle
  static_assert(kWG == kBK, "q and k/v tiles share one layout");
  constexpr int CHUNK = kBK * SW;       // bytes of one chunk of a tile
  constexpr int TILE = kBK * D * 2;     // bytes of a 64-row tile
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[2 * kStages + 1];

  // 1024-byte aligned tiles (the 128B swizzle's period): q (a tile per
  // warpgroup), then the k ring, then the v ring
  const uint32_t qs = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t ks = qs + NWG * TILE;
  const uint32_t vs = ks + kStages * TILE;
  const uint32_t full = smem_u32(bars);        // + 8 * stage
  const uint32_t empty = full + 8 * kStages;   // + 8 * stage
  const uint32_t qbar = full + 16 * kStages;

  const int nq = (Sq + TQ - 1) / TQ;
  const int qt = nq - 1 - (int)(blockIdx.x / (unsigned)BH);
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int q0 = qt * TQ;
  const int off = Sk - Sq;

  // the k tiles inside the wavefront of the block's live rows
  const int nk = (Sk + kBK - 1) / kBK;
  int j_lo = 0, j_hi = nk - 1;
  if (causal) j_hi = min(j_hi, (min(q0 + TQ, Sq) - 1 + off) / kBK);
  if (window > 0) j_lo = max(0, q0 + off - window + 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS);
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // producer: the q tile once, then the k and v tiles into the ring
    if (threadIdx.x == CONSUMERS) {
      const int kvh = bh / group;
      mbar_expect_tx(qbar, NWG * TILE);
      for (int h = 0; h < NWG; ++h)
        for (int c = 0; c < NCH; ++c)
          tma_load(qs + h * TILE + c * CHUNK, &tq, qbar, c * CW,
                   q0 + h * kWG, bh);
      for (int jt = j_lo, i = 0; jt <= j_hi; ++jt, ++i) {
        const int st = i % kStages;
        mbar_wait(empty + 8 * st, ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full + 8 * st, 2 * TILE);
        for (int c = 0; c < NCH; ++c) {
          tma_load(ks + st * TILE + c * CHUNK, &tk, full + 8 * st, c * CW,
                   jt * kBK, kvh);
          tma_load(vs + st * TILE + c * CHUNK, &tv, full + 8 * st, c * CW,
                   jt * kBK, kvh);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg owns q rows [q0 + 64 wg, + 64); in the wgmma
  // fragments a thread holds rows r0 and r0 + 8, columns 8 j + c2 + {0, 1}
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int c2 = (lane % 4) * 2;
  const int w0 = q0 + wg * kWG;                   // the warpgroup's first row
  const int r0 = w0 + (t / 32) * 16 + lane / 4;
  const int first = w0 + off;                     // key positions of its rows
  const int last = min(w0 + kWG, Sq) - 1 + off;
  int wj_lo = j_lo, wj_hi = j_hi;                 // the tiles it computes
  if (causal) wj_hi = min(wj_hi, last / kBK);
  if (window > 0) wj_lo = max(j_lo, max(0, first - window + 1) / kBK);
  if (w0 >= Sq) wj_hi = wj_lo - 1;                // no live row: consume only

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const uint32_t qa = qs + wg * TILE;
  mbar_wait(qbar, 0);

  for (int jt = j_lo, i = 0; jt <= j_hi; ++jt, ++i) {
    const int st = i % kStages;
    mbar_wait(full + 8 * st, (i / kStages) & 1);
    if (jt >= wj_lo && jt <= wj_hi) {
      const uint32_t ka = ks + st * TILE, va = vs + st * TILE;
      // s = q . k^T over D in k-steps of 16 columns
      float s[kBK / 2];
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) s[e] = 0.f;
      reg_fence(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t ch = kk * 16 / CW, at = (kk * 16 % CW) * 2;
        wgmma_ss_n64(s, make_desc<SW>(qa + ch * CHUNK + at, 16, 8 * SW),
                     make_desc<SW>(ka + ch * CHUNK + at, 16, 8 * SW),
                     kk > 0);
      }
      wg_commit();
      wg_wait_all();
      reg_fence(s);

      // mask only the tiles on a causal diagonal, a window edge or the
      // ragged tail; a masked entry is -inf, so its p is 0 exactly
      const int k0 = jt * kBK;
      if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > first) ||
          (window > 0 && last - k0 >= window)) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qp = r0 + 8 * r + off;
#pragma unroll
          for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kp = k0 + 8 * j + c2 + e;
              if (!(kp < Sk && (!causal || kp <= qp) &&
                    (window <= 0 || qp - kp < window)))
                s[4 * j + 2 * r + e] = -INFINITY;
            }
        }
      }

      // online softmax on the fragment: a row's max reduces over the 4
      // lanes that share it; l stays a per-lane partial sum until the end
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        alpha[r] = ex2((m[r] - mx) * scale_log2);
        m[r] = mx;
        const float mb = mx * scale_log2;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p =
                ex2(fmaf(s[4 * j + 2 * r + e], scale_log2, -mb));
            s[4 * j + 2 * r + e] = p;
            rs += p;
          }
        l[r] = fmaf(l[r], alpha[r], rs);
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[4 * j + 2 * r] *= alpha[r];
          acc[4 * j + 2 * r + 1] *= alpha[r];
        }

      // p to bf16 in registers: the accumulator fragment of s columns
      // [16 kk, 16 kk + 16) is the A fragment of k-step kk as it stands
      uint32_t pa[kBK / 4];
#pragma unroll
      for (int x = 0; x < kBK / 4; ++x)
        pa[x] = pack_bf16(s[2 * x], s[2 * x + 1]);

      // o += p . v, v (k rows x D) MN-major: the transpose bit
      reg_fence(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_pv<D>(acc, pa + 4 * kk,
                    make_desc<SW>(va + kk * 16 * SW, CHUNK, 8 * SW));
      wg_commit();
      wg_wait_all();
      reg_fence(acc);
    }
    mbar_arrive(empty + 8 * st);
  }

  if (w0 >= Sq) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float denom = fmaxf(lr, 1e-20f);
    const int row = r0 + 8 * r;
    if (row >= Sq) continue;
    // rows of the true head dim DT; columns past it are never stored
    __nv_bfloat16* orow = o + ((long long)bh * Sq + row) * DT + c2;
#pragma unroll
    for (int j = 0; j < DT / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(__fdiv_rn(acc[4 * j + 2 * r], denom),
                    __fdiv_rn(acc[4 * j + 2 * r + 1], denom));
  }
}

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// that the library links against nothing but the runtime
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

// (heads, rows, D) bf16 as a 3-D map (D, rows, heads) with boxes of
// min(width, 64) columns x box_rows x 1 head, for the kernel instantiated
// at `width` >= D columns: rows past `rows` of a head, and columns past D
// (D = 80 on the 128-wide instantiation), are out of range and read as
// zeros, never as the next row's or head's values
int make_map(CUtensorMap* map, const void* ptr, int D, int width, int rows,
             int heads, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const int cw = width < 64 ? width : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cw, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      cw == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// the tensor-core kernel instantiated at D columns for q, k, v and o of
// DT <= D columns
template <int D, int DT = D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int BH,
              int Sq, int Sk, int group, int causal, int window, float scale,
              void* stream) {
  using S = TcShape<D>;
  const auto kernel =
      &flash_fwd_tc_kernel<D, S::NWG, S::MINB, DT>;
  constexpr int smem = 1024 + (S::NWG * kWG + 2 * kStages * kBK) * D * 2;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, DT, D, Sq, BH, kWG);
  if (!rc) rc = make_map(&tk, k, DT, D, Sk, BH / group, kBK);
  if (!rc) rc = make_map(&tv, v, DT, D, Sk, BH / group, kBK);
  if (rc) return rc;
  const unsigned blocks =
      (unsigned)((Sq + S::NWG * kWG - 1) / (S::NWG * kWG)) * (unsigned)BH;
  kernel<<<blocks, S::NWG * 128 + 32, smem, (cudaStream_t)stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), BH, Sq, Sk, group, causal,
      window, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  int BH, int Sq, int Sk, int D, int group, int causal,
                  int window, float scale, void* stream) {
  switch (D) {
    case 32:
      return launch_tc<32>(q, k, v, o, BH, Sq, Sk, group, causal, window,
                           scale, stream);
    case 64:
      return launch_tc<64>(q, k, v, o, BH, Sq, Sk, group, causal, window,
                           scale, stream);
    case 80:   // on the 128-wide layout: TMA zero-fills columns 80..127
      return launch_tc<128, 80>(q, k, v, o, BH, Sq, Sk, group, causal,
                                window, scale, stream);
    case 128:
      return launch_tc<128>(q, k, v, o, BH, Sq, Sk, group, causal, window,
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
// contiguous, 16-byte aligned, f32 (bf16 = 0: the CUDA-core kernel) or
// bf16 (bf16 = 1: the tensor-core kernel); D in {32, 64, 80, 128}; 1 <=
// Sq <= Sk.
API int flash_attention_fwd(const void* q, const void* k, const void* v,
                            void* o, int BH, int Sq, int Sk, int D,
                            int group, int causal, int window, float scale,
                            int bf16, void* stream) {
  if (bf16)
    return dispatch_bf16(q, k, v, o, BH, Sq, Sk, D, group, causal, window,
                         scale, stream);
  return dispatch_f32(q, k, v, o, BH, Sq, Sk, D, group, causal, window,
                      scale, stream);
}
