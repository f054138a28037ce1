// U-ConvBlock forward for Hopper (sm_90a), fp32 in and out.
//
// Replaces sudo_rm_rf_tpu/ops/pallas/uconv.py::fused_uconv_block (the TPU
// kernel: one program per batch element holding the whole (T, Ci) pyramid in
// VMEM, its two 1x1 convolutions as time-major MXU products). An H100 block
// has at most 227 KB of shared memory, while one batch element's level 0 at
// the flagship shape (Ci=512, T=3200) is 6.5 MB in fp32, and every GlobLN
// needs statistics over the full (Ci, T) plane before its output can be used.
// So the block is a short chain of launches on one stream, each GlobLN a
// reduction barrier between two of them:
//
//   split         W -> tf32 (hi, lo) pairs of both 1x1 weights, zero-padded
//   proj GEMM     y = W_p x + b_p; epilogue writes moments per 64x64 sub-tile
//   fold          moments -> per-(batch, channel) (a, b) with a*v + b == GlobLN(v)
//   ladder k      raw_k = dwconv_k(f_k(raw_{k-1})) + bias, f_0 = prelu(a_p y + b_p),
//                 f_k = a_{k-1} v + b_{k-1}; k=5, pad 2, stride 1 then 2,
//                 y[t] = sum_j w[j] x[s t + j - 2]; per-row moments; then fold
//   upsample-sum  acc[t] = sum_k (a_k raw_k[t >> k] + b_k) (the reverse
//                 nearest-2x chain in closed form); per-row moments; then fold
//   res GEMM      out = W_r prelu(a_f acc + b_f) + b_r + x; the prologue
//                 applies the folded norm and PReLU as operands are built.
//
// What bounds it on this card: the two GEMMs, 2 * 2 * B * Ci * Co * T flops
// (6.7 GFLOP at B=4, Co=256, Ci=512, T=3200). On the fp32 FMA pipes (67
// TFLOP/s) that alone is 0.10 ms; the tensor cores run TF32 at 495 TFLOP/s.
// The other kernels are memory-bound: the upsample-sum reads five levels and
// writes one plane (~77 MB at B=4, 23 us at 3.35 TB/s).
//
// What the design does about it:
// * GEMMs on the tensor cores in 3xTF32: each operand v is split into
//   hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), and the kernel accumulates
//   lo*hi + hi*lo + hi*hi in fp32, which keeps fp32-level accuracy. wgmma
//   takes tf32 operands from shared memory only K-major, and x's tile
//   (channels x time, time contiguous) is not, so the product is taken
//   transposed, as the TPU kernel does: out^T (time x channels) = x^T W^T.
//   x^T is wgmma's register operand: the consumer warps read the x tile from
//   shared memory into the fragment layout, applying the res GEMM's fold +
//   PReLU prologue and the hi/lo split as they go. W^T is the shared-memory
//   operand, K-major as W is stored, in the 128-byte swizzle; a small split
//   kernel writes W's hi and lo planes once per call, zero-padded to whole
//   tiles. A 2-stage cp.async ring (zero-fill for ragged edges) feeds both,
//   and each k step's fragments are built while the previous step's wgmmas
//   run. The epilogue transposes the tile through shared memory, so that
//   bias, residual and stores move 16 bytes a thread along T.
// * Two blocks share an SM (<= 128 registers a thread, ~101 KB of shared
//   memory a block), so one block's loads and epilogue overlap the other's
//   tensor-core work; the tile is 64 channels wide where 128 would leave SMs
//   idle (B=1 at the flagship shape).
// * The upsample-sum works on chunks of 8 outputs a thread: float4 loads of
//   level 0, one load per 2^k outputs of level k, float4 stores, and the
//   chunk's exact (mean, M2) merged with Chan's formula once per chunk.
//
// Statistics: every block writes (count, mean, M2) of its tiles, computed in
// registers and merged in a fixed order with Chan's formula; the fold kernel
// merges the tiles in float64 in a fixed order. No atomics, so the result is
// the same on every run; no one-pass E[x^2] - E[x]^2.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 256;             // threads of the non-GEMM kernels
constexpr int WG = 2;               // consumer warpgroups of a GEMM block
constexpr int GT = 128 * WG;        // threads of a GEMM block
constexpr int BT = 64 * WG;         // time rows of a GEMM block's tile
constexpr int BK = 32;              // reduction depth of a stage: one 128-byte swizzle row
constexpr int XP = BT + 8;          // x tile pitch in floats: conflict-free fragment reads
constexpr int STAGES = 2;           // cp.async ring depth: two blocks fit on an SM
constexpr int SUB = 64;             // statistics sub-tile: 64 channels x 64 time steps
constexpr int WPAD_M = 128;         // split weights: rows padded to the widest tile
constexpr int CHUNK = 8;            // upsample-sum outputs per thread and chunk

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return cdiv(a, b) * b; }

// Shared memory of one GEMM stage for a tile of 64 * NJ channels: W hi and lo
// (64 * NJ rows of 128 bytes each), the x tile, the fold's (a, b) of its BK
// channels; rounded to the 1024-byte swizzle atom.
__host__ __device__ constexpr int w_bytes(int nj) { return 64 * nj * 128; }
__host__ __device__ constexpr int x_off(int nj) { return 2 * w_bytes(nj); }
__host__ __device__ constexpr int ab_off(int nj) { return x_off(nj) + BK * XP * 4; }
__host__ __device__ constexpr int stage_bytes(int nj) { return (ab_off(nj) + 2 * BK * 4 + 1023) / 1024 * 1024; }
__host__ __device__ constexpr int gemm_smem(int nj) { return STAGES * stage_bytes(nj) + 1024; }

// Chan's parallel merge of (n, mean, M2) moments.
template <typename T>
__device__ inline void chan_merge(T& n, T& mean, T& m2, T nb, T meanb, T m2b) {
  if (nb == T(0)) return;
  if (n == T(0)) {
    n = nb; mean = meanb; m2 = m2b;
    return;
  }
  T nt = n + nb;
  T d = meanb - mean;
  mean += d * (nb / nt);
  m2 += m2b + d * d * (n * nb / nt);
  n = nt;
}

__device__ inline void welford(float& n, float& mean, float& m2, float v) {
  n += 1.f;
  float d = v - mean;
  mean += d / n;
  m2 += d * (v - mean);
}

// Fixed-order tree merge of one moment triple per thread; the block's total
// lands in every thread's (n, mean, m2). blockDim.x must be NT.
template <typename T>
__device__ void block_moments(T& n, T& mean, T& m2) {
  __shared__ T sn[NT], smu[NT], sm2[NT];
  const int tid = threadIdx.x;
  sn[tid] = n; smu[tid] = mean; sm2[tid] = m2;
  __syncthreads();
  for (int s = NT / 2; s > 0; s >>= 1) {
    if (tid < s) {
      T an = sn[tid], amu = smu[tid], am2 = sm2[tid];
      chan_merge(an, amu, am2, sn[tid + s], smu[tid + s], sm2[tid + s]);
      sn[tid] = an; smu[tid] = amu; sm2[tid] = am2;
    }
    __syncthreads();
  }
  n = sn[0]; mean = smu[0]; m2 = sm2[0];
}

// ---- PTX wrappers ---------------------------------------------------------

__device__ inline uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ inline void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte copy, zero-filled past `bytes` (0 or 16: whole chunk or none).
__device__ inline void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

// 4-byte copy, zero-filled when `bytes` is 0.
__device__ inline void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// Makes this thread's generic-proxy shared-memory writes (cp.async) visible
// to the async proxy, which wgmma reads shared memory through.
__device__ inline void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ inline void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ inline void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory"); }

// Keeps a register's value in place across an asynchronous wgmma.
__device__ inline void pin(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ inline void pin(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (stride byte
// offset), the leading byte offset unused; `addr` lies in a 1024-byte-aligned
// atom, advanced by 32 bytes per 8-deep k step.
__device__ inline uint64_t smem_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d(64x64, fp32) += a(64x8, tf32, registers) * b(8x64, tf32, shared memory).
__device__ inline void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d(64x128, fp32) += a(64x8, tf32, registers) * b(8x128, tf32, shared memory);
// d[j] holds columns 64 j .. 64 j + 63 in the m64n64 accumulator layout.
__device__ inline void wgmma_m64n128k8(float (&d)[2][32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]), "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]), "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]), "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]), "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]), "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]), "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- kernels --------------------------------------------------------------

// Blocks with blockIdx.y = 0 split W0 (M0, K0), those with 1 split W1, into
// S = (hi, lo) planes of (round_up(M, WPAD_M), round_up(K, BK)), zero-padded.
__global__ void __launch_bounds__(NT) split_kernel(
    const float* __restrict__ W0, int M0, int K0, float* __restrict__ S0,
    const float* __restrict__ W1, int M1, int K1, float* __restrict__ S1) {
  const bool second = blockIdx.y == 1;
  const float* W = second ? W1 : W0;
  float* S = second ? S1 : S0;
  const int M = second ? M1 : M0, K = second ? K1 : K0;
  const int kp = round_up(K, BK);
  const size_t n = (size_t)round_up(M, WPAD_M) * kp;
  for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n; i += (size_t)gridDim.x * NT) {
    const int m = (int)(i / kp), k = (int)(i % kp);
    const float v = (m < M && k < K) ? W[(size_t)m * K + k] : 0.f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    S[i] = __uint_as_float(hi);
    S[n + i] = __uint_as_float(lo);
  }
}

// out[b, m, t] = sum_k W[m, k] f(X[b, k, t]) + bias[m] (+ R[b, m, t]) for
// t < N, m < M, in 3xTF32 on the tensor cores. W comes as split_kernel's
// (hi, lo) planes S with row pitch kp. f is the identity, or (PRO)
// prelu(pa[b, k] v + pb[b, k], *slope). VEC: N % 4 == 0 and X, R, out 16-byte
// aligned, so x, R and out move in 16-byte chunks.
//
// Block (x, y, b) computes out^T for time rows [BT x, BT x + BT) and channels
// [64 NJ y, 64 NJ y + 64 NJ): warpgroup g takes time rows 64 g .. 64 g + 63
// with one m64n(64 NJ)k8 accumulator. With partials set, it writes the
// moments of each 64x64 sub-tile (channel tile i, time tile j) at
// partials[3 * ((b * cdiv(M, 64) + i) * cdiv(N, 64) + j)].
template <int NJ, bool PRO, bool VEC>
__global__ void __launch_bounds__(GT, 2) gemm_kernel(
    const float* __restrict__ S, int kp, const float* __restrict__ X,
    const float* __restrict__ bias, const float* __restrict__ pa,
    const float* __restrict__ pb, const float* __restrict__ slope,
    const float* __restrict__ R, float* __restrict__ out,
    float* __restrict__ partials, int M, int K, int N) {
  constexpr int BN = 64 * NJ, WB = w_bytes(NJ), XO = x_off(NJ), AO = ab_off(NJ);
  constexpr int STAGE = stage_bytes(NJ);
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[NJ][2][GT / 32][3];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  unsigned char* sbase = smem_raw + (base - raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3, wg = tid >> 7;
  const int t0 = blockIdx.x * BT, m0 = blockIdx.y * BN, b = blockIdx.z;
  const float* Xb = X + (size_t)b * K * N;
  const float* Shi = S;
  const float* Slo = S + (size_t)round_up(M, WPAD_M) * kp;
  const int KT = cdiv(K, BK);

  auto load = [&](int kt) {
    const int k0 = kt * BK;
    const uint32_t st = base + (kt % STAGES) * STAGE;
    // W hi and lo: BN rows x 8 chunks of 16 bytes, chunk c of row r at
    // r * 128 + 16 * (c ^ (r % 8)) (the 128-byte swizzle)
#pragma unroll
    for (int i = 0; i < BN * 8 / GT; ++i) {
      const int e = tid + GT * i, r = e >> 3, c = e & 7;
      const size_t g = (size_t)(m0 + r) * kp + k0 + 4 * c;
      const uint32_t d = st + r * 128 + ((c ^ (r & 7)) << 4);
      cp_async16(d, Shi + g, 16);
      cp_async16(d + WB, Slo + g, 16);
    }
    // x: BK channel rows x BT time steps, zero outside (K, N)
    const uint32_t xs = st + XO;
    if (VEC) {
#pragma unroll
      for (int i = 0; i < BK * BT / 4 / GT; ++i) {
        const int e = tid + GT * i, kk = e / (BT / 4), c = e % (BT / 4);
        const int gk = k0 + kk, gt = t0 + 4 * c;
        const bool ok = gk < K && gt < N;
        cp_async16(xs + (kk * XP + 4 * c) * 4, ok ? Xb + (size_t)gk * N + gt : Xb, ok ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < BK * BT / GT; ++i) {
        const int e = tid + GT * i, kk = e / BT, c = e % BT;
        const int gk = k0 + kk, gt = t0 + c;
        const bool ok = gk < K && gt < N;
        cp_async4(xs + (kk * XP + c) * 4, ok ? Xb + (size_t)gk * N + gt : Xb, ok ? 4 : 0);
      }
    }
    if (PRO && tid < 2 * BK) {  // the fold's (a, b) of the stage's channels
      const int gk = k0 + tid % BK;
      const float* src = (tid < BK ? pa : pb) + (size_t)b * K;
      cp_async4(st + AO + tid * 4, gk < K ? src + gk : src, gk < K ? 4 : 0);
    }
  };

  float acc[NJ][32];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[j][r] = 0.f;
  const float sl = PRO ? *slope : 0.f;
  // this thread's fragment rows and columns (wgmma's tf32 A layout)
  const int frag_t = 64 * wg + 16 * warp + (lane >> 2), frag_k = lane & 3;

  load(0);
  cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // stage kt landed; stage kt - 1's buffer is free
    if (kt + 1 < KT) load(kt + 1);
    cp_async_commit();

    const uint32_t st = base + (kt % STAGES) * STAGE;
    const float* xs = reinterpret_cast<const float*>(sbase + (kt % STAGES) * STAGE + XO);
    const float* ab = reinterpret_cast<const float*>(sbase + (kt % STAGES) * STAGE + AO);
    // one 8-deep k step: the x^T fragment (prologue applied) split into
    // tf32 hi and lo; a0: (t, k), a1: (t + 8, k), a2: (t, k + 4), a3: (t + 8, k + 4)
    auto frag = [&](int s, uint32_t (&h)[4], uint32_t (&l)[4]) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = 8 * s + frag_k + 4 * (q >> 1), t = frag_t + 8 * (q & 1);
        float v = xs[k * XP + t];
        if (PRO) {
          v = fmaf(ab[k], v, ab[BK + k]);
          v = v >= 0.f ? v : sl * v;
        }
        split_tf32(v, h[q], l[q]);
      }
    };
    // lo*hi + hi*lo + hi*hi of one k step into the accumulator
    auto mma = [&](int s, const uint32_t (&h)[4], const uint32_t (&l)[4]) {
      const uint64_t whi = smem_desc(st + 32 * s), wlo = smem_desc(st + WB + 32 * s);
      if constexpr (NJ == 2) {
        wgmma_m64n128k8(acc, l, whi);
        wgmma_m64n128k8(acc, h, wlo);
        wgmma_m64n128k8(acc, h, whi);
      } else {
        wgmma_m64n64k8(acc[0], l, whi);
        wgmma_m64n64k8(acc[0], h, wlo);
        wgmma_m64n64k8(acc[0], h, whi);
      }
    };
    // Fragments are double-buffered across k steps: step s + 1's are built
    // while step s's wgmmas run, once step s - 1's have released the buffer
    // (wgmma reads its register operand until it completes).
    uint32_t hi[2][4] = {}, lo[2][4] = {};
    frag(0, hi[0], lo[0]);
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      wgmma_fence();
      mma(s, hi[s & 1], lo[s & 1]);
      wgmma_commit();
      if (s + 1 < BK / 8) {
        wgmma_wait<1>();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pin(hi[(s + 1) & 1][q]);
          pin(lo[(s + 1) & 1][q]);
        }
        frag(s + 1, hi[(s + 1) & 1], lo[(s + 1) & 1]);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pin(hi[u][q]);
        pin(lo[u][q]);
      }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 32; ++r) pin(acc[j][r]);
  }
  cp_async_wait<0>();

  // Epilogue, through shared memory: the accumulators go to a (channel, time)
  // tile; then each thread takes 4 time steps of rows wid + 8 i, so that the
  // bias, residual and store move 16 bytes at a time along T, the residual
  // loads of 8 rows issued before their stores. Accumulator r of this thread
  // sits at time frag_t + 8 ((r >> 1) & 1), channel 64 j + 8 (r >> 2) +
  // 2 (lane & 3) + (r & 1).
  constexpr int TP = BT + 4;  // tile pitch: conflict-free writes
  float* tile = reinterpret_cast<float*>(sbase);
  __syncthreads();  // every warpgroup is done with the ring
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < 32; ++r)
      tile[(64 * j + 8 * (r >> 2) + 2 * (lane & 3) + (r & 1)) * TP + frag_t +
           8 * ((r >> 1) & 1)] = acc[j][r];
  __syncthreads();
  const int wid = tid >> 5, tq = 4 * lane, t = t0 + tq;
  const int valid = max(0, min(4, N - t));  // time steps of this thread's group
#pragma unroll
  for (int j = 0; j < NJ; ++j) {  // rows 64 j .. 64 j + 63: one sub-tile's channels
    float4 res[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + wid + 8 * (8 * j + i);
      const size_t o = ((size_t)b * M + m) * N + t;
      res[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!R || m >= M) continue;
      if (VEC && valid == 4) {
        res[i] = *reinterpret_cast<const float4*>(R + o);
      } else {
        if (valid > 0) res[i].x = R[o];
        if (valid > 1) res[i].y = R[o + 1];
        if (valid > 2) res[i].z = R[o + 2];
        if (valid > 3) res[i].w = R[o + 3];
      }
    }
    float cnt = 0.f, sum = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ml = wid + 8 * (8 * j + i), m = m0 + ml;
      if (m >= M) continue;
      const float bm = bias[m];
      float4 v = *reinterpret_cast<const float4*>(tile + ml * TP + tq);
      v.x += bm + res[i].x;
      v.y += bm + res[i].y;
      v.z += bm + res[i].z;
      v.w += bm + res[i].w;
      *reinterpret_cast<float4*>(tile + ml * TP + tq) = v;  // kept for the moments
      const size_t o = ((size_t)b * M + m) * N + t;
      if (VEC && valid == 4) {
        *reinterpret_cast<float4*>(out + o) = v;
      } else {
        if (valid > 0) out[o] = v.x;
        if (valid > 1) out[o + 1] = v.y;
        if (valid > 2) out[o + 2] = v.z;
        if (valid > 3) out[o + 3] = v.w;
      }
      cnt += (float)valid;
      sum += (v.x + (valid > 1 ? v.y : 0.f)) + ((valid > 2 ? v.z : 0.f) + (valid > 3 ? v.w : 0.f));
    }
    if (!partials) continue;
    // this thread's moments; then merged over each half-warp, whose lanes
    // hold time steps 0-63 (lanes 0-15) or 64-127 (16-31) of the tile
    float mean = cnt > 0.f ? sum / cnt : 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ml = wid + 8 * (8 * j + i);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (m0 + ml < M && e < valid) {
          const float d = tile[ml * TP + tq + e] - mean;
          m2 += d * d;
        }
    }
    float n = cnt;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(0xffffffffu, n, off);
      const float mb = __shfl_down_sync(0xffffffffu, mean, off);
      const float qb = __shfl_down_sync(0xffffffffu, m2, off);
      chan_merge(n, mean, m2, nb, mb, qb);
    }
    if ((lane & 15) == 0) {
      red[j][lane >> 4][wid][0] = n;
      red[j][lane >> 4][wid][1] = mean;
      red[j][lane >> 4][wid][2] = m2;
    }
  }
  if (!partials) return;
  __syncthreads();
  if (tid >= 2 * NJ) return;
  const int j = tid >> 1, half = tid & 1;  // one thread per sub-tile merges its warps
  const int mt = cdiv(M, SUB), nt = cdiv(N, SUB), mi = m0 / SUB + j, ti = t0 / SUB + half;
  if (mi >= mt || ti >= nt) return;
  float n = red[j][half][0][0], mean = red[j][half][0][1], m2 = red[j][half][0][2];
  for (int w = 1; w < GT / 32; ++w)
    chan_merge(n, mean, m2, red[j][half][w][0], red[j][half][w][1], red[j][half][w][2]);
  const size_t p = ((size_t)b * mt + mi) * nt + ti;
  partials[3 * p] = n;
  partials[3 * p + 1] = mean;
  partials[3 * p + 2] = m2;
}

// One block per batch element: merge its P moment triples in float64, then
// write the GlobLN fold a[b, c] = g[c] rstd, sh[b, c] = beta[c] - a[b, c] mean.
__global__ void __launch_bounds__(NT) fold_kernel(
    const float* __restrict__ partials, int P, const float* __restrict__ gamma,
    const float* __restrict__ beta, int C, float eps, float* __restrict__ fa,
    float* __restrict__ fb) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const float* pp = partials + (size_t)b * P * 3;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int p = tid; p < P; p += NT)
    chan_merge<double>(n, mean, m2, pp[3 * p], pp[3 * p + 1], pp[3 * p + 2]);
  block_moments(n, mean, m2);
  const float rstd = (float)(1.0 / sqrt(m2 / n + (double)eps));
  const float mu = (float)mean;
  for (int c = tid; c < C; c += NT) {
    const float a = gamma[c] * rstd;
    fa[(size_t)b * C + c] = a;
    fb[(size_t)b * C + c] = beta[c] - a * mu;
  }
}

// One block per (channel, batch) row: out[t] = bias + sum_j w[j] f(in[s t + j - 2])
// for t < Tout, zero outside [0, Tin); f(v) = fa v + fb, then PReLU when slope
// is set. Writes the row's moments at partials[3 * (b * C + c)].
__global__ void __launch_bounds__(NT) ladder_kernel(
    const float* __restrict__ in, int Tin, const float* __restrict__ fa,
    const float* __restrict__ fb, const float* __restrict__ slope,
    const float* __restrict__ w, const float* __restrict__ bias, int stride,
    float* __restrict__ out, int Tout, int C, float* __restrict__ partials) {
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t row = (size_t)b * C + c;
  const float* src = in + row * Tin;
  float* dst = out + row * Tout;
  const float a = fa[row], sh = fb[row];
  const bool act = slope != nullptr;
  const float sl = act ? *slope : 0.f;
  float wj[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) wj[j] = w[(size_t)c * 5 + j];
  const float bi = bias[c];
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int t = tid; t < Tout; t += NT) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int i = stride * t + j - 2;
      if (i >= 0 && i < Tin) {
        float v = fmaf(a, src[i], sh);
        if (act) v = v >= 0.f ? v : sl * v;
        acc = fmaf(wj[j], v, acc);
      }
    }
    acc += bi;
    dst[t] = acc;
    welford(n, mean, m2, acc);
  }
  block_moments(n, mean, m2);
  if (tid == 0) {
    partials[3 * row] = n;
    partials[3 * row + 1] = mean;
    partials[3 * row + 2] = m2;
  }
}

// One block per (channel, batch) row: acc[t] = sum_k (a_k raw_k[t >> k] + b_k),
// deepest level first, in chunks of CHUNK outputs a thread. raw_k are stored
// back to back in pyr (level k holds B * C * (T >> k) values); level k's fold
// is folds slot k + 1. VEC: T % 8 == 0, so every chunk is whole and level 0,
// 1, 2 and acc load and store as float4, float4, float2 and float4. Writes the
// row's moments at partials[3 * (b * C + c)]: each chunk's exact (mean, M2),
// merged with Chan's formula.
template <bool VEC>
__global__ void __launch_bounds__(NT) upsum_kernel(
    const float* __restrict__ pyr, const float* __restrict__ folds, int depth,
    int T, int C, int B, float* __restrict__ acc, float* __restrict__ partials) {
  extern __shared__ float sab[];  // (a_k, b_k) of this row, for k < depth
  const int c = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const size_t row = (size_t)b * C + c, plane = (size_t)B * C;
  for (int k = tid; k < depth; k += NT) {
    sab[2 * k] = folds[(size_t)(2 * (k + 1)) * plane + row];
    sab[2 * k + 1] = folds[(size_t)(2 * (k + 1) + 1) * plane + row];
  }
  __syncthreads();
  size_t end = 0;  // one past the deepest level
  for (int k = 0; k < depth; ++k) end += plane * (T >> k);
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int t0 = CHUNK * tid; t0 < T; t0 += CHUNK * NT) {
    float v[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) v[j] = 0.f;
    size_t off = end;
    for (int k = depth - 1; k >= 0; --k) {
      const int tk = T >> k;
      off -= plane * tk;
      const float a = sab[2 * k], sh = sab[2 * k + 1];
      const float* src = pyr + off + row * tk;
      if (VEC && k == 0) {
        const float4 p = __ldg(reinterpret_cast<const float4*>(src + t0));
        const float4 q = __ldg(reinterpret_cast<const float4*>(src + t0 + 4));
        const float u[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = fmaf(a, u[j], sh) + v[j];
      } else if (VEC && k == 1) {
        const float4 p = __ldg(reinterpret_cast<const float4*>(src + t0 / 2));
        const float u[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = fmaf(a, u[j / 2], sh) + v[j];
      } else if (VEC && k == 2) {
        const float2 p = __ldg(reinterpret_cast<const float2*>(src + t0 / 4));
        const float u0 = fmaf(a, p.x, sh), u1 = fmaf(a, p.y, sh);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = (j < 4 ? u0 : u1) + v[j];
      } else if (VEC) {  // one value of level k covers the whole chunk
        const float u = fmaf(a, __ldg(src + (t0 >> k)), sh);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = u + v[j];
      } else {
#pragma unroll
        for (int j = 0; j < CHUNK; ++j)
          if (t0 + j < T) v[j] = fmaf(a, __ldg(src + ((t0 + j) >> k)), sh) + v[j];
      }
    }
    float* dst = acc + row * T + t0;
    const int cnt = VEC ? CHUNK : min(CHUNK, T - t0);
    float s = 0.f;
    if (VEC) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(dst + 4) = make_float4(v[4], v[5], v[6], v[7]);
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) s += v[j];
    } else {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j)
        if (j < cnt) {
          dst[j] = v[j];
          s += v[j];
        }
    }
    const float mu = s / (float)cnt;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      if (j < cnt) q += (v[j] - mu) * (v[j] - mu);
    chan_merge(n, mean, m2, (float)cnt, mu, q);
  }
  block_moments(n, mean, m2);
  if (tid == 0) {
    partials[3 * row] = n;
    partials[3 * row + 1] = mean;
    partials[3 * row + 2] = m2;
  }
}

// ---- host side -------------------------------------------------------------

struct Layout {
  size_t y, pyr, folds, part, sp, sr, total;
};

size_t split_floats(int M, int K) { return 2 * (size_t)round_up(M, WPAD_M) * round_up(K, BK); }
size_t align64(size_t n) { return (n + 63) / 64 * 64; }  // 256-byte section starts

Layout layout(int B, int Co, int Ci, int T, int depth) {
  const size_t plane = (size_t)B * Ci;
  size_t pyr = 0;
  for (int k = 0; k < depth; ++k) pyr += plane * (T >> k);
  const size_t tiles = (size_t)cdiv(Ci, SUB) * cdiv(T, SUB);
  const size_t parts = 3 * (size_t)B * (tiles > (size_t)Ci ? tiles : (size_t)Ci);
  Layout L;
  L.y = 0;
  L.pyr = align64(L.y + plane * T);
  L.folds = align64(L.pyr + pyr);
  L.part = align64(L.folds + 2 * (size_t)(depth + 2) * plane);
  L.sp = align64(L.part + parts);
  L.sr = align64(L.sp + split_floats(Ci, Co));
  L.total = L.sr + split_floats(Co, Ci);
  return L;
}

int num_sms() {
  static const int n = [] {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

template <int NJ, bool PRO, bool VEC>
cudaError_t launch_gemm(cudaStream_t st, const float* S, const float* X,
                        const float* bias, const float* pa, const float* pb,
                        const float* slope, const float* R, float* out,
                        float* partials, int B, int M, int K, int N) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<NJ, PRO, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, gemm_smem(NJ));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(cdiv(N, BT), cdiv(M, 64 * NJ), B);
  gemm_kernel<NJ, PRO, VEC><<<grid, GT, gemm_smem(NJ), st>>>(
      S, round_up(K, BK), X, bias, pa, pb, slope, R, out, partials, M, K, N);
  return cudaGetLastError();
}

// Picks the tile width (64 or 128 channels) and the x load width. The wider
// tile halves W's traffic per output; the narrower one is taken when the
// wider would leave SMs idle.
template <bool PRO>
cudaError_t gemm(cudaStream_t st, const float* S, const float* X,
                 const float* bias, const float* pa, const float* pb,
                 const float* slope, const float* R, float* out,
                 float* partials, int B, int M, int K, int N) {
  const bool wide = (long long)cdiv(N, BT) * cdiv(M, 128) * B >= num_sms();
  const bool vec = N % 4 == 0 && (((uintptr_t)X | (uintptr_t)R | (uintptr_t)out) & 15) == 0;
  if (wide && vec)
    return launch_gemm<2, PRO, true>(st, S, X, bias, pa, pb, slope, R, out, partials, B, M, K, N);
  if (wide)
    return launch_gemm<2, PRO, false>(st, S, X, bias, pa, pb, slope, R, out, partials, B, M, K, N);
  if (vec)
    return launch_gemm<1, PRO, true>(st, S, X, bias, pa, pb, slope, R, out, partials, B, M, K, N);
  return launch_gemm<1, PRO, false>(st, S, X, bias, pa, pb, slope, R, out, partials, B, M, K, N);
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for uconv_block_forward.
long long uconv_workspace_floats(int B, int Co, int Ci, int T, int depth) {
  return (long long)layout(B, Co, Ci, T, depth).total;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// One U-ConvBlock forward on `stream`. x, out: (B, Co, T); proj_w (Ci, Co);
// dw_w (depth, Ci, 5); dw_b/dw_g/dw_beta (depth, Ci); res_w (Co, Ci); the
// slopes are device scalars; `work` is 256-byte aligned. T % 2^(depth-1) ==
// 0. Returns the first launch error, else cudaSuccess.
int uconv_block_forward(
    const float* x, float* out, const float* proj_w, const float* proj_b,
    const float* proj_g, const float* proj_beta, const float* proj_slope,
    const float* dw_w, const float* dw_b, const float* dw_g,
    const float* dw_beta, const float* final_g, const float* final_beta,
    const float* final_slope, const float* res_w, const float* res_b,
    float* work, int B, int Co, int Ci, int T, int depth, float eps,
    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Layout L = layout(B, Co, Ci, T, depth);
  const size_t plane = (size_t)B * Ci;
  float* y = work + L.y;
  float* pyr = work + L.pyr;
  float* folds = work + L.folds;
  float* part = work + L.part;
  auto fa = [&](int s) { return folds + (size_t)(2 * s) * plane; };
  auto fb = [&](int s) { return folds + (size_t)(2 * s + 1) * plane; };
  cudaError_t err;

  // one thread a value of the larger weight's plane, at most 1024 blocks
  const size_t wplane = std::max(split_floats(Ci, Co), split_floats(Co, Ci)) / 2;
  const int sblocks = (int)std::min<size_t>(wplane / NT + 1, 1024);
  split_kernel<<<dim3(sblocks, 2), NT, 0, st>>>(proj_w, Ci, Co, work + L.sp, res_w,
                                                 Co, Ci, work + L.sr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = gemm<false>(st, work + L.sp, x, proj_b, nullptr, nullptr, nullptr,
                         nullptr, y, part, B, Ci, Co, T)) != cudaSuccess)
    return (int)err;
  fold_kernel<<<B, NT, 0, st>>>(part, cdiv(Ci, SUB) * cdiv(T, SUB), proj_g,
                                proj_beta, Ci, eps, fa(0), fb(0));

  const dim3 rows(Ci, B);
  const float* in = y;
  int tin = T;
  size_t off = 0;
  for (int k = 0; k < depth; ++k) {
    const int s = k == 0 ? 1 : 2;
    const int tout = tin / s;
    float* rk = pyr + off;
    ladder_kernel<<<rows, NT, 0, st>>>(
        in, tin, fa(k), fb(k), k == 0 ? proj_slope : nullptr,
        dw_w + (size_t)k * Ci * 5, dw_b + (size_t)k * Ci, s, rk, tout, Ci, part);
    fold_kernel<<<B, NT, 0, st>>>(part, Ci, dw_g + (size_t)k * Ci,
                                  dw_beta + (size_t)k * Ci, Ci, eps, fa(k + 1),
                                  fb(k + 1));
    in = rk;
    tin = tout;
    off += plane * tout;
  }

  // y is dead after level 0: the upsample-sum reuses it for acc
  const size_t sab = 2 * (size_t)depth * sizeof(float);
  if (T % CHUNK == 0)
    upsum_kernel<true><<<rows, NT, sab, st>>>(pyr, folds, depth, T, Ci, B, y, part);
  else
    upsum_kernel<false><<<rows, NT, sab, st>>>(pyr, folds, depth, T, Ci, B, y, part);
  fold_kernel<<<B, NT, 0, st>>>(part, Ci, final_g, final_beta, Ci, eps,
                                fa(depth + 1), fb(depth + 1));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  return (int)gemm<true>(st, work + L.sr, y, res_b, fa(depth + 1), fb(depth + 1),
                         final_slope, x, out, nullptr, B, Co, Ci, T);
}

}  // extern "C"
