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
//                 y[t] = sum_j w[j] x[s t + j - 2]; moments per (row, time
//                 tile); the launch's last block of each batch element folds
//   upsample-sum  acc[t] = sum_k (a_k raw_k[t >> k] + b_k) (the reverse
//                 nearest-2x chain in closed form); per-row moments; then fold
//   res GEMM      out = W_r prelu(a_f acc + b_f) + b_r + x; the prologue
//                 applies the folded norm and PReLU as operands are built.
//
// What bounds it on this card: the two GEMMs, 2 * 2 * B * Ci * Co * T flops,
// taken in three TF32 passes (below). At the serving shapes they are bound
// by the tensor cores: at (32, 256, 512, 3200) the two products are 53.7
// GFLOP, three passes at 495 TFLOP/s take 0.325 ms, and their bytes (x,
// the proj output, the res input, the residual and out: 735 MB) 0.219 ms
// at 3.35 TB/s; at U36's (4, 512, 512, 6400) 0.163 ms against 0.078 ms.
// The other kernels are memory-bound: the ladder reads each level's input
// and writes its output once, 15,400 floats a (batch, channel) row at
// T=3200 (1.0 GB at B=32, 0.30 ms at 3.35 TB/s; its 10 flops an output take
// a twentieth of that); the upsample-sum reads five levels and writes one
// plane (~77 MB at B=4, 23 us).
//
// What the design does about it:
// * GEMMs on the tensor cores in 3xTF32: each operand v is split into
//   hi = tf32(v) and lo = tf32(v - hi) (rounded to nearest, ties away),
//   and the kernel sums lo*hi + hi*lo + hi*hi in fp32. The tensor cores add
//   into their accumulator without rounding to nearest, so a sum kept there
//   over the whole reduction drifts with its length (it was ~8x the fp32
//   reference's error against float64); each 32-deep stage is summed afresh
//   on the tensor cores and added to the running fp32 sum in registers,
//   which rounds to nearest, and the result is as accurate as an fp32 GEMM.
//   wgmma takes tf32 operands from shared memory only K-major, and x's tile
//   (channels x time, time contiguous) is not, so the product is taken
//   transposed, as the TPU kernel does: out^T (time x channels) = x^T W^T.
//   x^T is wgmma's register operand: the consumer warps read the x tile from
//   shared memory into the fragment layout, applying the res GEMM's fold +
//   PReLU prologue and the hi/lo split as they go, each k step's while the
//   step before runs. W^T is the shared-memory operand, K-major as W is
//   stored, in the 128-byte swizzle; a small split kernel writes W's hi and
//   lo planes once per call, zero-padded to whole tiles. The epilogue
//   transposes the tile through shared memory, so that bias, residual and
//   stores move 16 bytes a thread along T, and writes the moments of each
//   64x64 sub-tile in one order on either route.
// * Two routes, by the product's (M, K) alone (wide::route, mirrored by
//   ops/uconv.py::gemm_wide). From 128 output and 128 input channels the
//   wide GEMM (wide::gemm_kernel) takes tiles of 128 channels x 128 time
//   steps, so each x fragment serves twice the channels and the shared
//   memory that wgmma reads a flop is what it takes. A block an SM walks
//   over its tiles (a persistent grid) in three roles: the copy engine
//   loads W's planes and x's tile into rings of three stages, on mbarriers,
//   with zeros outside the tensors; two consumer warpgroups of 232
//   registers each (setmaxnreg) hold a running sum and two stage sums of 64
//   x 128, so a stage's sum is added while the next stage's wgmmas run and
//   the pipe drains once in eight stages; the epilogue has a tile of its
//   own, so the next tile's loads run under it. Narrower products, such as
//   GroupComm's folded 16- and 32-channel ones, cannot fill a 128-channel
//   tile and are bound by bytes: they keep gemm_kernel, 64-channel tiles
//   with a 2-stage cp.async ring and two blocks an SM (<= 128 registers a
//   thread, ~69 KB of shared memory a block), so one block's loads and
//   epilogue overlap the other's tensor-core work.
// * The ladder is a stencil: one warp takes one (row, time tile), in passes
//   of 8 outputs a lane. A lane loads its outputs' 8 (stride 1) or 16
//   (stride 2) inputs in 16-byte loads, applies the fold (and PReLU) once to
//   each, takes the 2 inputs before and the 1 or 2 after from its neighbour
//   lanes by shuffle, and stores its outputs 16 bytes at a time. Tiles are
//   chosen from the level's row count and length alone (ladder_work): long
//   rows are cut, a level with few rows is cut until its warps fill the
//   card, and a level of many short rows gives a warp several. Each lane
//   merges its chunks' exact (mean, M2) with Chan's formula, once a chunk
//   of 8, and the warp writes one triple for all it took. The fold runs
//   inside the level's launch: the last block of a batch element to finish
//   (an atomic count of its tiles) merges that element's triples and writes
//   the next level's (a, b), so a call launches the fold kernel only for the
//   proj GEMM and the upsample-sum.
// * The upsample-sum works on chunks of 8 outputs a thread: float4 loads of
//   level 0, one load per 2^k outputs of level k, float4 stores, and the
//   chunk's exact (mean, M2) merged with Chan's formula once per chunk.
//
// Statistics: every block writes (count, mean, M2) of its tiles, computed in
// registers and merged in a fixed order with Chan's formula; a fold merges
// the tiles in float64 in a fixed order. The ladder's atomic only elects the
// block that merges, never the order it merges in, so the result is the same
// on every run; no one-pass E[x^2] - E[x]^2.
//
// Pyramid type (the TPU kernel's pyramid_dtype): fp32 or bf16. With bf16 the
// ladder keeps the TPU kernel's semantics: each level's statistics come from
// its fp32 values, level k + 1 reads level k in fp32 (from a ping-pong pair
// of fp32 planes, the proj output's and one more), and only the stored
// pyramid, which the upsample-sum reads and upcasts, is bf16 (rounded to
// nearest even). That halves the bytes the upsample-sum reads; the ladder
// writes 6 bytes an output in place of 4.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int NT = 256;             // threads of the non-GEMM kernels
constexpr int WG = 2;               // consumer warpgroups of a GEMM block
constexpr int GT = 128 * WG;        // threads of a GEMM block
constexpr int BT = 64 * WG;         // time rows of a GEMM block's tile
constexpr int BK = 32;              // reduction depth of a stage: one 128-byte swizzle row
constexpr int XP = BT + 8;          // x tile pitch in floats: conflict-free fragment reads
constexpr int STAGES = 2;           // cp.async ring depth: two blocks fit on an SM
constexpr int SUB = 64;             // statistics sub-tile: 64 channels x 64 time steps
constexpr int BN = 64;              // channels of a GEMM block's tile
constexpr int WPAD_M = BN;          // split weights: rows padded to whole tiles
constexpr int CHUNK = 8;            // upsample-sum outputs per thread and chunk
constexpr int LANE_OUT = 8;         // ladder outputs a lane takes in one pass
constexpr int PASS = 32 * LANE_OUT;  // ladder outputs of one warp pass
constexpr int MAX_TILE = 64 * PASS;  // the longest ladder tile a warp takes
constexpr int MIN_WORK = 4 * PASS;  // ladder outputs a warp should take, rows allowing
constexpr int FILL = 4096;          // ladder warps that fill the card: 132 SMs x ~32

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int round_up(int a, int b) { return cdiv(a, b) * b; }

// Shared memory of one GEMM stage: W hi and lo (BN rows of 128 bytes each),
// the x tile, the fold's (a, b) of its BK channels; rounded to the 1024-byte
// swizzle atom.
constexpr int W_BYTES = BN * 128;
constexpr int X_OFF = 2 * W_BYTES;
constexpr int AB_OFF = X_OFF + BK * XP * 4;
constexpr int STAGE_BYTES = (AB_OFF + 2 * BK * 4 + 1023) / 1024 * 1024;
constexpr int GEMM_SMEM = STAGES * STAGE_BYTES + 1024;

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

// d(64x64, fp32) = a(64x8, tf32, registers) * b(8x64, tf32, shared memory)
// + (acc ? d : 0).
__device__ inline void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                      int acc) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// d(64x128, fp32) = a(64x8, tf32, registers) * b(8x128, tf32, shared memory)
// + (acc ? d : 0).
__device__ inline void wgmma_m64n128k8_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                          int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ inline void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// Makes the barriers' initialisation visible before any thread uses them.
__device__ inline void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ inline void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

// Waits until the barrier's phase of this parity has completed. The loop
// is the compiler's, not a branch inside the asm, so that threads of one
// warp may wait on different barriers (a loop the compiler cannot see let
// one waiter starve the others and hang the block).
__device__ inline bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
__device__ inline void mbar_wait(uint32_t bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Arrives on the barrier and expects `bytes` more of asynchronous copies.
__device__ inline void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Arrives on the barrier once this thread's cp.async copies so far landed.
__device__ inline void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(bar) : "memory");
}

// The box of a 3-D tensor map at coordinates (c0, c1, c2) into shared memory
// by the copy engine (zero-filled outside the tensor); it counts its bytes
// off the barrier's expected ones when it lands.
__device__ inline void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar) : "memory");
}

// A barrier among `threads` threads of the block (whole warps) under `id`.
__device__ inline void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// The registers a thread of this warpgroup holds from here on.
template <int N>
__device__ inline void regs_down() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N)); }
template <int N>
__device__ inline void regs_up() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N)); }

// ---- kernels --------------------------------------------------------------

// Blocks with blockIdx.y = 0 split W0 (M0, K0), those with 1 split W1, into
// S = (hi, lo) planes of (round_up(M, WPAD_M), round_up(K, BK)), zero-padded.
// Block (0, 0) also zeroes the ladder's nc counters.
__global__ void __launch_bounds__(NT) split_kernel(
    const float* __restrict__ W0, int M0, int K0, float* __restrict__ S0,
    const float* __restrict__ W1, int M1, int K1, float* __restrict__ S1,
    int* __restrict__ counters, int nc) {
  if (blockIdx.x == 0 && blockIdx.y == 0)
    for (int i = threadIdx.x; i < nc; i += NT) counters[i] = 0;
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
// [BN y, BN y + BN): warpgroup g takes time rows 64 g .. 64 g + 63 with one
// m64n64k8 accumulator. Each BK-deep stage is summed on the tensor cores from
// zero (part) and added to the running sum (acc) in fp32 registers. With
// partials set, it writes the moments of each 64x64 sub-tile (channel tile
// i, time tile j) at partials[3 * ((b * cdiv(M, 64) + i) * cdiv(N, 64) + j)].
template <bool PRO, bool VEC>
__global__ void __launch_bounds__(GT, 2) gemm_kernel(
    const float* __restrict__ S, int kp, const float* __restrict__ X,
    const float* __restrict__ bias, const float* __restrict__ pa,
    const float* __restrict__ pb, const float* __restrict__ slope,
    const float* __restrict__ R, float* __restrict__ out,
    float* __restrict__ partials, int M, int K, int N) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ float red[2][GT / 32][3];
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
    const uint32_t st = base + (kt % STAGES) * STAGE_BYTES;
    // W hi and lo: BN rows x 8 chunks of 16 bytes, chunk c of row r at
    // r * 128 + 16 * (c ^ (r % 8)) (the 128-byte swizzle)
#pragma unroll
    for (int i = 0; i < BN * 8 / GT; ++i) {
      const int e = tid + GT * i, r = e >> 3, c = e & 7;
      const size_t g = (size_t)(m0 + r) * kp + k0 + 4 * c;
      const uint32_t d = st + r * 128 + ((c ^ (r & 7)) << 4);
      cp_async16(d, Shi + g, 16);
      cp_async16(d + W_BYTES, Slo + g, 16);
    }
    // x: BK channel rows x BT time steps, zero outside (K, N)
    const uint32_t xs = st + X_OFF;
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
      cp_async4(st + AB_OFF + tid * 4, gk < K ? src + gk : src, gk < K ? 4 : 0);
    }
  };

  float acc[32], part[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = part[r] = 0.f;
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

    const uint32_t st = base + (kt % STAGES) * STAGE_BYTES;
    const float* xs = reinterpret_cast<const float*>(sbase + (kt % STAGES) * STAGE_BYTES + X_OFF);
    const float* ab = reinterpret_cast<const float*>(sbase + (kt % STAGES) * STAGE_BYTES + AB_OFF);
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
    // lo*hi + hi*lo + hi*hi of one k step into the stage's sum; the stage's
    // first product starts it afresh
    auto mma = [&](int s, const uint32_t (&h)[4], const uint32_t (&l)[4]) {
      const uint64_t whi = smem_desc(st + 32 * s), wlo = smem_desc(st + W_BYTES + 32 * s);
      wgmma_m64n64k8(part, l, whi, s != 0);
      wgmma_m64n64k8(part, h, wlo, 1);
      wgmma_m64n64k8(part, h, whi, 1);
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
    for (int r = 0; r < 32; ++r) {  // round to nearest, once a stage
      pin(part[r]);
      acc[r] += part[r];
    }
  }
  cp_async_wait<0>();

  // Epilogue, through shared memory: the accumulators go to a (channel, time)
  // tile; then each thread takes 4 time steps of rows wid + 8 i, so that the
  // bias, residual and store move 16 bytes at a time along T, the residual
  // loads of 8 rows issued before their stores. Accumulator r of this thread
  // sits at time frag_t + 8 ((r >> 1) & 1), channel 8 (r >> 2) +
  // 2 (lane & 3) + (r & 1).
  constexpr int TP = BT + 4;  // tile pitch: conflict-free writes
  float* tile = reinterpret_cast<float*>(sbase);
  __syncthreads();  // every warpgroup is done with the ring
#pragma unroll
  for (int r = 0; r < 32; ++r)
    tile[(8 * (r >> 2) + 2 * (lane & 3) + (r & 1)) * TP + frag_t + 8 * ((r >> 1) & 1)] = acc[r];
  __syncthreads();
  const int wid = tid >> 5, tq = 4 * lane, t = t0 + tq;
  const int valid = max(0, min(4, N - t));  // time steps of this thread's group
  float4 res[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + wid + 8 * i;
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
    const int ml = wid + 8 * i, m = m0 + ml;
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
  if (!partials) return;
  // this thread's moments; then merged over each half-warp, whose lanes
  // hold time steps 0-63 (lanes 0-15) or 64-127 (16-31) of the tile
  float mean = cnt > 0.f ? sum / cnt : 0.f, m2 = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int ml = wid + 8 * i;
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
    red[lane >> 4][wid][0] = n;
    red[lane >> 4][wid][1] = mean;
    red[lane >> 4][wid][2] = m2;
  }
  __syncthreads();
  if (tid >= 2) return;
  const int half = tid;  // one thread per sub-tile merges its warps
  const int mt = cdiv(M, SUB), nt = cdiv(N, SUB), mi = m0 / SUB, ti = t0 / SUB + half;
  if (mi >= mt || ti >= nt) return;
  n = red[half][0][0];
  mean = red[half][0][1];
  m2 = red[half][0][2];
  for (int w = 1; w < GT / 32; ++w)
    chan_merge(n, mean, m2, red[half][w][0], red[half][w][1], red[half][w][2]);
  const size_t p = ((size_t)b * mt + mi) * nt + ti;
  partials[3 * p] = n;
  partials[3 * p + 1] = mean;
  partials[3 * p + 2] = m2;
}

// The wide route: the same product for M >= 128 and K >= 128 (gemm_wide),
// in blocks of 128 channels x 128 time steps and three warpgroups with
// separate roles. Its kernel keeps the name gemm_kernel.
namespace wide {

constexpr int TN = 128;                    // channels of a tile
constexpr int TT = 128;                    // time rows of a tile
constexpr int THREADS = 384;               // a producer warpgroup, two consumers
constexpr int WS = 3;                      // stages of the W ring
constexpr int RS = 3;                      // stages of the raw x ring
constexpr int DRAIN = 8;                   // stages between two drains of the pipe
constexpr int PRODUCER_REGS = 40;          // 128 x 40 + 256 x 232 <= 65,536
constexpr int CONSUMER_REGS = 232;         // three accumulators of 64 and the rest
constexpr int PLANE = TN * BK * 4;         // one 128-row plane of W: 16 KB
constexpr int XP = TT + 8;                 // raw x row pitch: conflict-free fragment reads
constexpr int RAW_BYTES = BK * XP * 4;     // raw x stage: BK rows x XP, fp32
constexpr int W_OFF = 0;                   // W stage: hi plane, lo plane (TMA, swizzled)
constexpr int RAW_OFF = W_OFF + WS * 2 * PLANE;
constexpr int TILE_OFF = RAW_OFF + RS * RAW_BYTES;  // the epilogue tile
constexpr int AB_OFF = TILE_OFF + TN * TT * 4;      // the fold's (a, b) of a raw stage
constexpr int SMEM = AB_OFF + RS * 2 * BK * 4 + 1024;
static_assert(RAW_BYTES % 128 == 0, "the copy engine writes 128-byte aligned boxes");
static_assert(SMEM <= 232448 - 1024, "shared memory of one block");

bool route(int M, int K) { return M >= TN && K >= TN; }

// tf32(v), rounded to nearest with ties away from zero (cvt.rna.tf32.f32's
// rounding), by two integer operations on v's bits: the split runs on the
// ALU pipes, not the conversion unit.
__device__ inline uint32_t tf32_bits(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// A value that the compiler cannot compute ahead: keeps the wgmma
// descriptors of a stage from being hoisted out of the loop into 64
// registers.
__device__ inline uint64_t opaque(uint64_t v) {
  asm volatile("" : "+l"(v));
  return v;
}

// Float (c, t) of the epilogue tile (TN channels x TT time steps): 16-byte
// chunks of a row swizzled by the row, so that the accumulators' column
// writes and the rows' 16-byte reads are both free of bank conflicts.
__device__ inline int tile_at(int c, int t) {
  return c * TT + (((t >> 2) ^ (c & 7)) << 2) + (t & 3);
}

// out[b, m, t] = sum_k W[m, k] f(X[b, k, t]) + bias[m] (+ R[b, m, t]), as
// ::gemm_kernel computes it (the same f, VEC and partials), with W as
// split_kernel's (hi, lo) planes behind the tensor map wmap.
//
// The product is cut into tiles of TN channels x TT time rows, channel
// tiles first; block i takes tiles i, i + gridDim.x, ... (a persistent
// grid), and stage g of the block is stage g % KT of its (g / KT)-th tile.
// Warpgroup 0 produces: one thread of warp 3 has the copy engine load W's
// hi and lo tiles (TN x BK) into a ring of WS stages, already in wgmma's
// 128-byte swizzle; warps 0-2 load x's tiles (BK rows of XP time steps,
// zero outside the tensor: the copy engine by tensor map xmap where tma is
// set, else their cp.async) into a ring of RS raw stages, and 64 of their
// threads the fold's a and b beside them. Warpgroups 1 and 2 consume: each
// takes 64 time rows of a tile with one m64n128k8 accumulator, W^T from
// shared memory and x^T from registers: each 8-deep k step's fragment is
// read from the raw stage, f applied and split into hi and lo while the
// step before runs. Each BK-deep stage is summed afresh on the tensor
// cores, into two stage sums in turn, and added to the running sum (acc)
// in fp32 registers while the next stage's wgmmas run. The epilogue is
// ::gemm_kernel's, over the tile's two 64-channel sub-tiles in turn, so
// each sub-tile's moments are merged in the same order, through a tile of
// its own in shared memory, while the next tile's loads are in flight.
template <bool PRO, bool VEC>
__global__ void __launch_bounds__(THREADS, 1) gemm_kernel(
    const float* __restrict__ X, const float* __restrict__ bias,
    const float* __restrict__ pa, const float* __restrict__ pb,
    const float* __restrict__ slope, const float* __restrict__ R, float* __restrict__ out,
    float* __restrict__ partials, int B, int M, int K, int N,
    const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap xmap,
    int tma) {
  extern __shared__ unsigned char smem_raw[];
  // wfull, wfree (WS each), landed, rfree (RS each)
  __shared__ __align__(8) uint64_t bars[2 * WS + 2 * RS];
  __shared__ float red[2][2][8][3];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms are 1024-byte aligned
  unsigned char* sbase = smem_raw + (base - raw);
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int mtiles = cdiv(M, TN), ttiles = cdiv(N, TT);
  const int mine = cdiv(mtiles * ttiles * B - (int)blockIdx.x, (int)gridDim.x);
  const int KT = round_up(cdiv(K, BK), DRAIN);  // stages past K are zeros
  // the tile of the block's k-th: its first channel, time row and batch
  auto tile_of = [&](int k, int& m0, int& t0, int& b) {
    const int i = blockIdx.x + k * gridDim.x;
    m0 = (i % mtiles) * TN;
    t0 = (i / mtiles % ttiles) * TT;
    b = i / mtiles / ttiles;
  };
  const uint32_t wfull = smem_u32(bars), wfree = wfull + 8 * WS, landed = wfree + 8 * WS;
  const uint32_t rfree = landed + 8 * RS;
  if (tid == 0) {
    for (int j = 0; j < WS; ++j) {
      mbar_init(wfull + 8 * j, 1);  // the copy engine's bytes
      mbar_init(wfree + 8 * j, 8);  // lane 0 of every consumer warp
    }
    for (int j = 0; j < RS; ++j) {
      // the copy engine's bytes and the fold's 64 cp.async, or warps 0-2's
      mbar_init(landed + 8 * j, tma ? 1 + (PRO ? 2 * BK : 0) : 96);
      mbar_init(rfree + 8 * j, 8);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    regs_down<PRODUCER_REGS>();
    // Every wait below is made by whole warps (or by a lone thread whose
    // warp has left): a lane spinning on one barrier while another lane of
    // its warp has work to do could take all the warp's turns and hang the
    // block.
    const int p = tid;
    if (p >= 96) {  // warp 3: W's stage g into W slot g % WS, both planes,
                    // rows [m0, m0 + TN) x [k0, k0 + BK), zeros past the planes
      if (p != 96) return;
      for (int g = 0; g < mine * KT; ++g) {
        int m0, t0, b;
        tile_of(g / KT, m0, t0, b);
        if (g >= WS) mbar_wait(wfree + 8 * (g % WS), (g / WS - 1) & 1);
        mbar_expect_tx(wfull + 8 * (g % WS), 2 * PLANE);
        tma_load(base + W_OFF + (g % WS) * 2 * PLANE, &wmap, g % KT * BK, m0, 0,
                 wfull + 8 * (g % WS));
      }
      return;
    }
    // warps 0-2: x's stage g into raw slot g % RS, rows [k0, k0 + BK) x
    // [t0, t0 + XP), and the fold's a and b of [k0, k0 + BK). Only what
    // lies inside (K, N) is read; the fragments zero the rest.
    for (int g = 0; g < mine * KT; ++g) {
      int m0, t0, b;
      tile_of(g / KT, m0, t0, b);
      const int k0 = g % KT * BK, kn = min(BK, K - k0), tn = min(TT, N - t0);
      const uint32_t rx = base + RAW_OFF + (g % RS) * RAW_BYTES, bar = landed + 8 * (g % RS);
      if (g >= RS) mbar_wait(rfree + 8 * (g % RS), (g / RS - 1) & 1);
      if (PRO && p < 2 * BK) {
        const int k = p % BK;
        const float* src = (p < BK ? pa : pb) + (size_t)b * K;
        cp_async4(base + AB_OFF + (g % RS) * 2 * BK * 4 + 4 * p, k < kn ? src + k0 + k : src,
                  k < kn ? 4 : 0);
      }
      if (tma) {
        if (p == 0) {
          fence_proxy_async();  // the slot's last reads came before these writes
          mbar_expect_tx(bar, RAW_BYTES);
          tma_load(rx, &xmap, t0, k0, b, bar);
        }
        if (PRO && p < 2 * BK) cp_async_mbar_arrive(bar);
        continue;
      }
      const float* Xb = X + (size_t)b * K * N;
      for (int e = p; e < BK * TT; e += 96) {  // row e / TT, column e % TT
        const int k = e / TT, t = e % TT;
        const bool ok = k < kn && t < tn;
        cp_async4(rx + 4 * (k * XP + t), ok ? Xb + (size_t)(k0 + k) * N + t0 + t : Xb,
                  ok ? 4 : 0);
      }
      cp_async_mbar_arrive(bar);
    }
    return;
  }

  regs_up<CONSUMER_REGS>();
  const int cw = wg - 1, warp = (tid >> 5) & 3;
  const float sl = PRO ? *slope : 0.f;
  // this thread's fragment rows and columns (wgmma's tf32 A layout)
  const int frag_t = 64 * cw + 16 * warp + (lane >> 2), frag_k = lane & 3;
  float acc[64], s0[64], s1[64];  // a stage's first wgmma ignores s0's, s1's values
  uint32_t fh[2][4], fl[2][4];    // the fragments of two k steps, hi and lo
  // k step s of stage g: the x^T fragment (f applied, zero outside (K, N))
  // split into tf32 hi and lo; q = 0..3: (t, k), (t + 8, k), (t, k + 4),
  // (t + 8, k + 4)
  auto frag = [&](int g, int s, int t0, uint32_t (&h)[4], uint32_t (&l)[4]) {
    const int k0 = g % KT * BK;
    const float* xs = reinterpret_cast<const float*>(sbase + RAW_OFF + (g % RS) * RAW_BYTES);
    const float* ab = reinterpret_cast<const float*>(sbase + AB_OFF + (g % RS) * 2 * BK * 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = 8 * s + frag_k + 4 * (q >> 1), t = frag_t + 8 * (q & 1);
      float v = xs[k * XP + t];
      if (PRO) {
        v = fmaf(ab[k], v, ab[BK + k]);
        v = v >= 0.f ? v : sl * v;
      }
      if (k0 + k >= K || t0 + t >= N) v = 0.f;
      h[q] = tf32_bits(v);
      l[q] = tf32_bits(v - __uint_as_float(h[q]));
    }
  };
  // stage g's lo*hi + hi*lo + hi*hi into d, from zero; each k step's
  // fragment is built while the step before runs (wgmma reads its register
  // operand until it completes). With retire_prev, the stage before is in
  // flight: once the first step is issued it has completed, and its sum,
  // prev, goes into acc (round to nearest, once a stage) and its W stage
  // is free. The raw stage is free once the last fragment is read.
  auto stage = [&](int g, int t0, float (&d)[64], float (&prev)[64], bool retire_prev) {
    mbar_wait(wfull + 8 * (g % WS), (g / WS) & 1);
    mbar_wait(landed + 8 * (g % RS), (g / RS) & 1);
    const uint64_t w = opaque(smem_desc(base + W_OFF + (g % WS) * 2 * PLANE));
    if (retire_prev) {  // the stage before's third step released fragment 0
      wgmma_wait<1>();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pin(fh[0][q]);
        pin(fl[0][q]);
      }
    }
    frag(g, 0, t0, fh[0], fl[0]);
#pragma unroll
    for (int s = 0; s < BK / 8; ++s) {
      const uint64_t wh = w + ((32 * s) >> 4), wl = w + ((PLANE + 32 * s) >> 4);
      wgmma_fence();
      wgmma_m64n128k8_rs(d, fl[s & 1], wh, s != 0);
      wgmma_m64n128k8_rs(d, fh[s & 1], wl, 1);
      wgmma_m64n128k8_rs(d, fh[s & 1], wh, 1);
      wgmma_commit();
      if (s + 1 < BK / 8) {
        wgmma_wait<1>();
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          pin(fh[(s + 1) & 1][q]);
          pin(fl[(s + 1) & 1][q]);
        }
        if (s == 0 && retire_prev) {
#pragma unroll
          for (int r = 0; r < 64; ++r) {
            pin(prev[r]);
            acc[r] += prev[r];
          }
          if (lane == 0) mbar_arrive(wfree + 8 * ((g - 1) % WS));
        }
        frag(g, s + 1, t0, fh[(s + 1) & 1], fl[(s + 1) & 1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(rfree + 8 * (g % RS));
  };
  float* tile = reinterpret_cast<float*>(sbase + TILE_OFF);
  const int ctid = tid - 128, wid = ctid >> 5, tq = 4 * lane;

  for (int k = 0; k < mine; ++k) {
    int m0, t0, b;
    tile_of(k, m0, t0, b);
    const int g0 = k * KT;
#pragma unroll
    for (int r = 0; r < 64; ++r) acc[r] = 0.f;
    // Stages alternate between s0 and s1. No stage may be in flight where
    // two paths of the code join (a turn of the loop, its exit): a join
    // copies the registers, and ptxas then serializes every wgmma of the
    // kernel. So the pipe drains once every DRAIN stages.
    for (int s = 0; s < KT; s += DRAIN) {
      const int g = g0 + s;
#pragma unroll
      for (int j = 0; j < DRAIN; ++j) {  // DRAIN is even: the last stage is s1's
        if (j % 2 == 0)
          stage(g + j, t0, s0, s1, j > 0);
        else
          stage(g + j, t0, s1, s0, true);
      }
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        pin(fh[1][q]);
        pin(fl[1][q]);
      }
#pragma unroll
      for (int r = 0; r < 64; ++r) {
        pin(s1[r]);
        acc[r] += s1[r];
      }
      if (lane == 0) mbar_arrive(wfree + 8 * ((g + DRAIN - 1) % WS));
    }

    // Epilogue: ::gemm_kernel's, through the tile (channel, time);
    // accumulator r of this thread sits at time frag_t + 8 ((r >> 1) & 1),
    // channel 8 (r >> 2) + 2 (lane & 3) + (r & 1). The residual's loads
    // go out first.
    const int t = t0 + tq;
    const int valid = max(0, min(4, N - t));  // time steps of this thread's group
    float4 res[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int m = m0 + 64 * (i >> 3) + wid + 8 * (i & 7);
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
#pragma unroll
    for (int r = 0; r < 64; ++r)
      tile[tile_at(8 * (r >> 2) + 2 * (lane & 3) + (r & 1), frag_t + 8 * ((r >> 1) & 1))] = acc[r];
    named_sync(2, 256);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // the two 64-channel sub-tiles
      float cnt = 0.f, sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ml = 64 * h + wid + 8 * i, m = m0 + ml;
        if (m >= M) continue;
        const float bm = bias[m];
        float4* at = reinterpret_cast<float4*>(tile + tile_at(ml, tq));
        float4 v = *at;
        v.x += bm + res[8 * h + i].x;
        v.y += bm + res[8 * h + i].y;
        v.z += bm + res[8 * h + i].z;
        v.w += bm + res[8 * h + i].w;
        *at = v;  // kept for the moments
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
      float mean = cnt > 0.f ? sum / cnt : 0.f, m2 = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ml = 64 * h + wid + 8 * i;
        const float* at = tile + tile_at(ml, tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (m0 + ml < M && e < valid) {
            const float d = at[e] - mean;
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
        red[h][lane >> 4][wid][0] = n;
        red[h][lane >> 4][wid][1] = mean;
        red[h][lane >> 4][wid][2] = m2;
      }
    }
    named_sync(2, 256);  // the tile and red are read
    if (partials && ctid < 4) {
      const int h = ctid >> 1, half = ctid & 1;  // one thread per sub-tile merges its warps
      const int mt = cdiv(M, SUB), nt = cdiv(N, SUB), mi = m0 / SUB + h, ti = t0 / SUB + half;
      if (mi < mt && ti < nt) {
        float n = red[h][half][0][0], mean = red[h][half][0][1], m2 = red[h][half][0][2];
        for (int w = 1; w < 8; ++w)
          chan_merge(n, mean, m2, red[h][half][w][0], red[h][half][w][1], red[h][half][w][2]);
        const size_t q = ((size_t)b * mt + mi) * nt + ti;
        partials[3 * q] = n;
        partials[3 * q + 1] = mean;
        partials[3 * q + 2] = m2;
      }
    }
  }
}

}  // namespace wide

// One block: merge batch element b's P moment triples (at partials[3 P b])
// in float64, thread tid taking p = tid, tid + NT, ... in that order and
// the threads then merged by block_moments, then write the GlobLN fold
// a[b, c] = g[c] rstd, sh[b, c] = beta[c] - a[b, c] mean. The triples are
// read from L2 (__ldcg: in the ladder other blocks of the same launch wrote
// them), eight of a thread's in flight at once.
__device__ void fold_batch(const float* __restrict__ partials, int P, int b,
                           const float* __restrict__ gamma, const float* __restrict__ beta,
                           int C, float eps, float* __restrict__ fa, float* __restrict__ fb) {
  constexpr int AHEAD = 8;
  const int tid = threadIdx.x;
  const float* pp = partials + (size_t)b * P * 3;
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int p0 = tid; p0 < P; p0 += AHEAD * NT) {
    float q[AHEAD][3];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u)
#pragma unroll
      for (int e = 0; e < 3; ++e)  // a count of 0 merges nothing
        q[u][e] = p0 + u * NT < P ? __ldcg(pp + 3 * (p0 + u * NT) + e) : 0.f;
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) chan_merge<double>(n, mean, m2, q[u][0], q[u][1], q[u][2]);
  }
  block_moments(n, mean, m2);
  const float rstd = (float)(1.0 / sqrt(m2 / n + (double)eps));
  const float mu = (float)mean;
  for (int c = tid; c < C; c += NT) {
    const float a = gamma[c] * rstd;
    fa[(size_t)b * C + c] = a;
    fb[(size_t)b * C + c] = beta[c] - a * mu;
  }
}

// One block per batch element: fold_batch of its P moment triples.
__global__ void __launch_bounds__(NT) fold_kernel(
    const float* __restrict__ partials, int P, const float* __restrict__ gamma,
    const float* __restrict__ beta, int C, float eps, float* __restrict__ fa,
    float* __restrict__ fb) {
  fold_batch(partials, P, blockIdx.x, gamma, beta, C, eps, fa, fb);
}

// Four ladder outputs stored at p: 16 bytes in fp32; in bf16, rounded to
// nearest even, 8 bytes (the first value in the low half of the first word).
// p is aligned to that width.
__device__ inline void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ inline uint32_t bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ inline void store4(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2(v[0], v[1]), bf16x2(v[2], v[3]));
}
__device__ inline void store1(float* p, float v) { *p = v; }
__device__ inline void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The ladder's work a warp, from the level's row count (B * C) and output
// length alone: each warp takes `group` rows of one tile of `tile` outputs.
// A row is cut into at least cdiv(tout, MAX_TILE) tiles, and into up to
// cdiv(FILL, rows) where the rows alone leave the card short of warps, but
// no tile is cut shorter than one pass; the tile is a multiple of
// LANE_OUT, so a lane's outputs never straddle two tiles. Where whole rows
// are shorter than MIN_WORK and the level has warps to spare, a warp takes
// several, so that its fixed costs (the moments' merge, the count) are
// spread over more outputs.
struct LadderWork {
  int group, tile;
};
LadderWork ladder_work(int rows, int tout) {
  const int fill = std::min(cdiv(FILL, rows), cdiv(tout, PASS));
  const int tiles = std::max(cdiv(tout, MAX_TILE), fill);
  const int tile = round_up(cdiv(tout, tiles), LANE_OUT);
  const int group = tile < tout ? 1 : std::max(1, std::min(cdiv(MIN_WORK, tout), rows / FILL));
  return {group, tile};
}

// Level k of the ladder, stride S, on rows b * C + c of Tin inputs and Tout
// = Tin / S outputs: out[t] = bias[c] + sum_j w[c, j] f(in[S t + j - 2]),
// f(v) = fa v + fb (then PReLU when slope is set), f(in) zero outside
// [0, Tin). Stores out in the pyramid's type P at store, and in fp32 at
// next when next is set (a bf16 pyramid: the next level's input).
//
// Warp v of batch element b (blockIdx.y) takes tile v % tiles of the
// `group` rows from c = group (v / tiles) (ladder_work: several rows only
// where a row is one tile), in passes of PASS: lane l takes the LANE_OUT
// outputs from t = t0 + LANE_OUT l, loads their LANE_OUT S inputs, applies
// f once to each, and takes in[S t - 2], in[S t - 1] from lane l - 1 and
// in[S t + LANE_OUT S] (and + 1 at stride 1) from lane l + 1 by shuffle;
// lanes 0 and 31 load those from the row. Each lane merges each chunk's
// exact (mean, M2) with Chan's formula, the warp merges its lanes in a
// fixed order, and lane 0 writes the moments of the warp's outputs, of
// the fp32 values, at partials[3 (b nw + v)], nw = cdiv(C, group) tiles.
//
// The fold: thread 0 adds the block's warps to counter[b] once their
// moments are written (a barrier, then one fence: the pattern of a grid
// sync); the block that completes the count merges b's nw triples
// (fold_batch, a fixed order), writes the fold of the next level at ga, gb
// and sets counter[b] back to 0 for the next launch.
//
// VEC: Tin and Tout are multiples of 4 and in, next and store aligned, so
// inputs load 16 bytes at a time and outputs store 4 at a time.
template <typename P, int S, bool VEC>
__global__ void __launch_bounds__(NT) ladder_kernel(
    const float* __restrict__ in, int Tin, const float* __restrict__ fa,
    const float* __restrict__ fb, const float* __restrict__ slope,
    const float* __restrict__ w, const float* __restrict__ bias,
    float* __restrict__ next, P* __restrict__ store, int Tout, int C, int group,
    int tile, float* __restrict__ partials, const float* __restrict__ gamma,
    const float* __restrict__ beta, float eps, float* __restrict__ ga,
    float* __restrict__ gb, int* __restrict__ counter) {
  constexpr int WARPS = NT / 32, NI = S * LANE_OUT;
  constexpr unsigned FULL = 0xffffffffu;
  const int b = blockIdx.y, lane = threadIdx.x & 31;
  const int tiles = cdiv(Tout, tile), nw = cdiv(C, group) * tiles;
  const int v = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool act = slope != nullptr;
  const float sl = act ? *slope : 0.f;
  if (v < nw) {  // the whole warp, or none of it
    const int t_begin = (v % tiles) * tile, t_end = min(Tout, t_begin + tile);
    const int c_begin = (v / tiles) * group, c_end = min(C, c_begin + group);
    float n = 0.f, mean = 0.f, m2 = 0.f;
    for (int c = c_begin; c < c_end; ++c) {
      const size_t row = (size_t)b * C + c;
      const float* src = in + row * Tin;
      P* dst = store + row * Tout;
      float* nxt = next ? next + row * Tout : nullptr;
      const float a = fa[row], sh = fb[row];
      auto f = [&](float u) {
        u = fmaf(a, u, sh);
        return act && u < 0.f ? sl * u : u;
      };
      float wj[5];
#pragma unroll
      for (int j = 0; j < 5; ++j) wj[j] = w[(size_t)c * 5 + j];
      const float bi = bias[c];
      for (int t0 = t_begin; t0 < t_end; t0 += PASS) {
        const int t = t0 + LANE_OUT * lane, i0 = S * t;
        // the raw inputs: the lane's NI from i0, and for lanes 0 and 31 their
        // two halo inputs from hs = i0 - 2 or i0 + NI, all issued before any
        // is used
        const int hs = lane == 0 ? i0 - 2 : i0 + NI;
        float r[NI], h[2];
        if (VEC) {
#pragma unroll
          for (int q = 0; q < NI / 4; ++q) {
            float4 u = make_float4(0.f, 0.f, 0.f, 0.f);
            if (i0 + 4 * q < Tin)  // Tin % 4 == 0: four in the row, or none
              u = __ldg(reinterpret_cast<const float4*>(src + i0 + 4 * q));
            r[4 * q] = u.x;
            r[4 * q + 1] = u.y;
            r[4 * q + 2] = u.z;
            r[4 * q + 3] = u.w;
          }
        } else {
#pragma unroll
          for (int i = 0; i < NI; ++i) r[i] = i0 + i < Tin ? __ldg(src + i0 + i) : 0.f;
        }
        const bool edge = lane == 0 || lane == 31;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          h[e] = edge && hs + e >= 0 && hs + e < Tin ? __ldg(src + hs + e) : 0.f;
        // x[2 + i] = f(in[i0 + i]); x[0], x[1], x[NI + 2], x[NI + 3] the halo;
        // f(in) is zero outside the row
        float x[NI + 4], hf[2];
#pragma unroll
        for (int i = 0; i < NI; ++i) x[2 + i] = i0 + i < Tin ? f(r[i]) : 0.f;
#pragma unroll
        for (int e = 0; e < 2; ++e) hf[e] = hs + e >= 0 && hs + e < Tin ? f(h[e]) : 0.f;
        x[0] = __shfl_up_sync(FULL, x[NI], 1);
        x[1] = __shfl_up_sync(FULL, x[NI + 1], 1);
        x[NI + 2] = __shfl_down_sync(FULL, x[2], 1);
        x[NI + 3] = __shfl_down_sync(FULL, x[3], 1);
        if (lane == 0) {
          x[0] = hf[0];
          x[1] = hf[1];
        }
        if (lane == 31) {
          x[NI + 2] = hf[0];
          x[NI + 3] = hf[1];
        }
        float o[LANE_OUT];
#pragma unroll
        for (int j = 0; j < LANE_OUT; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int i = 0; i < 5; ++i) acc = fmaf(wj[i], x[S * j + i], acc);
          o[j] = acc + bi;
        }
        const int cnt = max(0, min(LANE_OUT, t_end - t));
        if (VEC) {  // t % 8 == 0 and t_end % 4 == 0: cnt is 0, 4 or 8
#pragma unroll
          for (int h = 0; h < LANE_OUT / 4; ++h)
            if (4 * h < cnt) {
              store4(dst + t + 4 * h, o + 4 * h);
              if (nxt) store4(nxt + t + 4 * h, o + 4 * h);
            }
        } else {
#pragma unroll
          for (int j = 0; j < LANE_OUT; ++j)
            if (j < cnt) {
              store1(dst + t + j, o[j]);
              if (nxt) nxt[t + j] = o[j];
            }
        }
        if (cnt > 0) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < LANE_OUT; ++j) s += j < cnt ? o[j] : 0.f;
          const float mu = s / (float)cnt;
          float q = 0.f;
#pragma unroll
          for (int j = 0; j < LANE_OUT; ++j)
            if (j < cnt) q += (o[j] - mu) * (o[j] - mu);
          chan_merge(n, mean, m2, (float)cnt, mu, q);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float nb = __shfl_down_sync(FULL, n, off);
      const float mb = __shfl_down_sync(FULL, mean, off);
      const float qb = __shfl_down_sync(FULL, m2, off);
      chan_merge(n, mean, m2, nb, mb, qb);
    }
    if (lane == 0) {
      float* p = partials + 3 * ((size_t)b * nw + v);
      p[0] = n;
      p[1] = mean;
      p[2] = m2;
    }
  }

  __shared__ bool last;
  __syncthreads();  // the block's moments are written
  if (threadIdx.x == 0) {
    const int mine = min(WARPS, nw - (int)blockIdx.x * WARPS);
    __threadfence();  // they reach every SM before the count does
    last = atomicAdd(counter + b, mine) == nw - mine;
    if (last) __threadfence();  // and the other blocks' before this block reads them
  }
  __syncthreads();
  if (!last) return;
  fold_batch(partials, nw, b, gamma, beta, C, eps, ga, gb);
  if (threadIdx.x == 0) counter[b] = 0;
}

// Aligned loads of 8, 4 or 2 consecutive pyramid values and of one, upcast to
// fp32: 32, 16 or 8 bytes in fp32, 16, 8 or 4 bytes in bf16.
__device__ inline void load8(const float* s, float (&u)[8]) {
  const float4 p = __ldg(reinterpret_cast<const float4*>(s));
  const float4 q = __ldg(reinterpret_cast<const float4*>(s + 4));
  u[0] = p.x; u[1] = p.y; u[2] = p.z; u[3] = p.w;
  u[4] = q.x; u[5] = q.y; u[6] = q.z; u[7] = q.w;
}
__device__ inline void load4(const float* s, float (&u)[4]) {
  const float4 p = __ldg(reinterpret_cast<const float4*>(s));
  u[0] = p.x; u[1] = p.y; u[2] = p.z; u[3] = p.w;
}
__device__ inline void load2(const float* s, float (&u)[2]) {
  const float2 p = __ldg(reinterpret_cast<const float2*>(s));
  u[0] = p.x; u[1] = p.y;
}
__device__ inline float load1(const float* s) { return __ldg(s); }

// the two bf16 values of a 32-bit word, upcast exactly (bf16 is the high
// half of an fp32); the first in memory is the low half
__device__ inline float2 bf2(uint32_t word) {
  return make_float2(__uint_as_float(word << 16), __uint_as_float(word & 0xffff0000u));
}
__device__ inline void load8(const __nv_bfloat16* s, float (&u)[8]) {
  const uint4 p = __ldg(reinterpret_cast<const uint4*>(s));
  const float2 f0 = bf2(p.x), f1 = bf2(p.y), f2 = bf2(p.z), f3 = bf2(p.w);
  u[0] = f0.x; u[1] = f0.y; u[2] = f1.x; u[3] = f1.y;
  u[4] = f2.x; u[5] = f2.y; u[6] = f3.x; u[7] = f3.y;
}
__device__ inline void load4(const __nv_bfloat16* s, float (&u)[4]) {
  const uint2 p = __ldg(reinterpret_cast<const uint2*>(s));
  const float2 f0 = bf2(p.x), f1 = bf2(p.y);
  u[0] = f0.x; u[1] = f0.y; u[2] = f1.x; u[3] = f1.y;
}
__device__ inline void load2(const __nv_bfloat16* s, float (&u)[2]) {
  const float2 f = bf2(__ldg(reinterpret_cast<const unsigned int*>(s)));
  u[0] = f.x; u[1] = f.y;
}
__device__ inline float load1(const __nv_bfloat16* s) {
  return __uint_as_float((uint32_t)__ldg(reinterpret_cast<const unsigned short*>(s)) << 16);
}

// One block per (channel, batch) row: acc[t] = sum_k (a_k raw_k[t >> k] + b_k),
// deepest level first, in chunks of CHUNK outputs a thread. raw_k are stored
// back to back in pyr, in type P (level k holds B * C * (T >> k) values);
// level k's fold is folds slot k + 1. VEC: T % 8 == 0, so every chunk is
// whole, levels 0, 1 and 2 load 8, 4 and 2 values at once and acc stores as
// float4. Writes the row's moments at partials[3 * (b * C + c)]: each
// chunk's exact (mean, M2), merged with Chan's formula.
template <bool VEC, typename P>
__global__ void __launch_bounds__(NT) upsum_kernel(
    const P* __restrict__ pyr, const float* __restrict__ folds, int depth,
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
      const P* src = pyr + off + row * tk;
      if (VEC && k == 0) {
        float u[8];
        load8(src + t0, u);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = fmaf(a, u[j], sh) + v[j];
      } else if (VEC && k == 1) {
        float u[4];
        load4(src + t0 / 2, u);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = fmaf(a, u[j / 2], sh) + v[j];
      } else if (VEC && k == 2) {
        float p[2];
        load2(src + t0 / 4, p);
        const float u0 = fmaf(a, p[0], sh), u1 = fmaf(a, p[1], sh);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = (j < 4 ? u0 : u1) + v[j];
      } else if (VEC) {  // one value of level k covers the whole chunk
        const float u = fmaf(a, load1(src + (t0 >> k)), sh);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = u + v[j];
      } else {
#pragma unroll
        for (int j = 0; j < CHUNK; ++j)
          if (t0 + j < T) v[j] = fmaf(a, load1(src + ((t0 + j) >> k)), sh) + v[j];
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

// Sections of the workspace, in floats: y (the proj output, then acc), ping
// (a bf16 pyramid's second fp32 ladder plane; empty for fp32), pyr (the
// levels, fp32 or bf16), folds, partials, the ladder's B counters (int),
// W's two split planes.
struct Layout {
  size_t y, ping, pyr, folds, part, cnt, sp, sr, total;
};

size_t split_floats(int M, int K) { return 2 * (size_t)round_up(M, WPAD_M) * round_up(K, BK); }
size_t align64(size_t n) { return (n + 63) / 64 * 64; }  // 256-byte section starts

Layout layout(int B, int Co, int Ci, int T, int depth, bool bf16) {
  const size_t plane = (size_t)B * Ci;
  size_t pyr = 0;
  for (int k = 0; k < depth; ++k) pyr += plane * (T >> k);
  // moment triples a batch element: the proj GEMM's sub-tiles, the ladder's
  // warps, the upsample-sum's rows
  size_t units = std::max((size_t)cdiv(Ci, SUB) * cdiv(T, SUB), (size_t)Ci);
  for (int k = 0; k < depth; ++k) {
    const LadderWork lw = ladder_work(B * Ci, T >> k);
    units = std::max(units, (size_t)cdiv(Ci, lw.group) * cdiv(T >> k, lw.tile));
  }
  Layout L;
  L.y = 0;
  L.ping = align64(L.y + plane * T);
  L.pyr = align64(L.ping + (bf16 ? plane * T : 0));
  L.folds = align64(L.pyr + (bf16 ? (pyr + 1) / 2 : pyr));
  L.part = align64(L.folds + 2 * (size_t)(depth + 2) * plane);
  L.cnt = align64(L.part + 3 * (size_t)B * units);
  L.sp = align64(L.cnt + B);
  L.sr = align64(L.sp + split_floats(Ci, Co));
  L.total = L.sr + split_floats(Co, Ci);
  return L;
}

template <bool PRO, bool VEC>
cudaError_t launch_gemm(cudaStream_t st, const float* S, const float* X,
                        const float* bias, const float* pa, const float* pb,
                        const float* slope, const float* R, float* out,
                        float* partials, int B, int M, int K, int N) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gemm_kernel<PRO, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, GEMM_SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(cdiv(N, BT), cdiv(M, BN), B);
  gemm_kernel<PRO, VEC><<<grid, GT, GEMM_SMEM, st>>>(
      S, round_up(K, BK), X, bias, pa, pb, slope, R, out, partials, M, K, N);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled of the driver, found at first use (null where the
// driver has none)
using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                            const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                            const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
Encode tensor_map_encoder() {
  static const Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) ==
                   cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  return encode;
}

// The wide route: a block an SM (a persistent grid), the tensor map of
// W's split planes S ((kp, round_up(M, WPAD_M), 2), a stage's box in the
// 128-byte swizzle) and, where x moves in 16-byte chunks (VEC), that of X
// ((N, K, B), a stage's box as it lies).
template <bool PRO, bool VEC>
cudaError_t launch_gemm_wide(cudaStream_t st, const float* S, const float* X,
                             const float* bias, const float* pa, const float* pb,
                             const float* slope, const float* R, float* out,
                             float* partials, int B, int M, int K, int N) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      wide::gemm_kernel<PRO, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, wide::SMEM);
  if (attr != cudaSuccess) return attr;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  const Encode encode = tensor_map_encoder();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t ones[3] = {1, 1, 1};
  const int kp = round_up(K, BK), mp = round_up(M, WPAD_M);
  const cuuint64_t wdim[3] = {(cuuint64_t)kp, (cuuint64_t)mp, 2};
  const cuuint64_t wstride[2] = {4ull * kp, 4ull * kp * mp};
  const cuuint32_t wbox[3] = {BK, wide::TN, 2};
  CUtensorMap wmap = {}, xmap = {};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(S), wdim, wstride, wbox,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  bool tma = VEC;
  if (tma) {
    const cuuint64_t xdim[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)B};
    const cuuint64_t xstride[2] = {4ull * N, 4ull * N * K};
    const cuuint32_t xbox[3] = {wide::XP, BK, 1};
    tma = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<float*>(X), xdim, xstride,
                 xbox, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                 CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
          CUDA_SUCCESS;
  }
  const int tiles = cdiv(M, wide::TN) * cdiv(N, wide::TT) * B;
  wide::gemm_kernel<PRO, VEC><<<std::min(tiles, sms), wide::THREADS, wide::SMEM, st>>>(
      X, bias, pa, pb, slope, R, out, partials, B, M, K, N, wmap, xmap, tma ? 1 : 0);
  return cudaGetLastError();
}

// Picks the route from (M, K) (wide::route) and the x load width: 16
// bytes where N and the pointers allow.
template <bool PRO>
cudaError_t gemm(cudaStream_t st, const float* S, const float* X,
                 const float* bias, const float* pa, const float* pb,
                 const float* slope, const float* R, float* out,
                 float* partials, int B, int M, int K, int N) {
  const bool vec = N % 4 == 0 && (((uintptr_t)X | (uintptr_t)R | (uintptr_t)out) & 15) == 0;
  if (wide::route(M, K)) {
    if (vec)
      return launch_gemm_wide<PRO, true>(st, S, X, bias, pa, pb, slope, R, out, partials, B, M,
                                         K, N);
    return launch_gemm_wide<PRO, false>(st, S, X, bias, pa, pb, slope, R, out, partials, B, M,
                                        K, N);
  }
  if (vec)
    return launch_gemm<PRO, true>(st, S, X, bias, pa, pb, slope, R, out, partials, B, M, K, N);
  return launch_gemm<PRO, false>(st, S, X, bias, pa, pb, slope, R, out, partials, B, M, K, N);
}

// Launches level k of the ladder (stride S) with its fold (see
// ladder_kernel), its warps' work from ladder_work, 16-byte accesses where
// the lengths and pointers allow.
template <typename P, int S>
void launch_ladder(cudaStream_t st, const float* in, int tin, const float* fa,
                   const float* fb, const float* slope, const float* w, const float* bias,
                   float* next, P* store, int B, int C, float* part, const float* gamma,
                   const float* beta, float eps, float* ga, float* gb, int* counter) {
  const int tout = tin / S;
  const LadderWork lw = ladder_work(B * C, tout);
  const dim3 grid(cdiv(cdiv(C, lw.group) * cdiv(tout, lw.tile), NT / 32), B);
  const bool aligned = ((uintptr_t)in | (uintptr_t)next) % 16 == 0 &&
                       (uintptr_t)store % (4 * sizeof(P)) == 0;
  if (tin % 4 == 0 && tout % 4 == 0 && aligned)
    ladder_kernel<P, S, true><<<grid, NT, 0, st>>>(in, tin, fa, fb, slope, w, bias, next, store,
                                                  tout, C, lw.group, lw.tile, part, gamma,
                                                  beta, eps, ga, gb, counter);
  else
    ladder_kernel<P, S, false><<<grid, NT, 0, st>>>(in, tin, fa, fb, slope, w, bias, next,
                                                   store, tout, C, lw.group, lw.tile, part,
                                                   gamma, beta, eps, ga, gb, counter);
}

// The ladder (depth levels, each folding into folds slot k + 1 in its own
// launch) and the upsample-sum into y with its moments in part, over a
// pyramid of type P. An fp32 pyramid feeds level k + 1 from level k's
// stored values; a bf16 one from its fp32 values, which alternate between
// ping (even levels) and y (odd levels; y is dead once level 0 has read
// it); the last level's are not kept.
template <typename P>
void ladder_upsum(cudaStream_t st, float* y, float* ping, P* pyr, float* folds,
                  float* part, int* counter, const float* proj_slope, const float* dw_w,
                  const float* dw_b, const float* dw_g, const float* dw_beta,
                  int B, int Ci, int T, int depth, float eps) {
  constexpr bool narrow = !std::is_same<P, float>::value;
  const size_t plane = (size_t)B * Ci;
  auto fa = [&](int s) { return folds + (size_t)(2 * s) * plane; };
  auto fb = [&](int s) { return folds + (size_t)(2 * s + 1) * plane; };
  const float* in = y;
  int tin = T;
  size_t off = 0;
  for (int k = 0; k < depth; ++k) {
    P* rk = pyr + off;
    float* next = narrow && k + 1 < depth ? (k % 2 == 0 ? ping : y) : nullptr;
    const float *w = dw_w + (size_t)k * Ci * 5, *bias = dw_b + (size_t)k * Ci;
    const float *g = dw_g + (size_t)k * Ci, *beta = dw_beta + (size_t)k * Ci;
    if (k == 0)
      launch_ladder<P, 1>(st, in, tin, fa(k), fb(k), proj_slope, w, bias, next, rk, B, Ci,
                          part, g, beta, eps, fa(k + 1), fb(k + 1), counter);
    else
      launch_ladder<P, 2>(st, in, tin, fa(k), fb(k), nullptr, w, bias, next, rk, B, Ci, part,
                          g, beta, eps, fa(k + 1), fb(k + 1), counter);
    const int tout = k == 0 ? tin : tin / 2;
    if constexpr (narrow) {
      in = next;
    } else {
      in = rk;
    }
    tin = tout;
    off += plane * tout;
  }

  // y is dead after the ladder: the upsample-sum reuses it for acc
  const dim3 rows(Ci, B);
  const size_t sab = 2 * (size_t)depth * sizeof(float);
  if (T % CHUNK == 0)
    upsum_kernel<true, P><<<rows, NT, sab, st>>>(pyr, folds, depth, T, Ci, B, y, part);
  else
    upsum_kernel<false, P><<<rows, NT, sab, st>>>(pyr, folds, depth, T, Ci, B, y, part);
}

}  // namespace

extern "C" {

// Floats of scratch the caller allocates for uconv_block_forward.
long long uconv_workspace_floats(int B, int Co, int Ci, int T, int depth, int pyramid_bf16) {
  return (long long)layout(B, Co, Ci, T, depth, pyramid_bf16 != 0).total;
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The work a warp of the ladder's level of `rows` (B * Ci) rows and `tout`
// outputs takes (ladder_work): its rows, and its time tile's outputs.
// Returns the time tiles a row.
int ladder_tiles(int rows, int tout, int* warp_rows, int* tile) {
  const LadderWork lw = ladder_work(rows, tout);
  *warp_rows = lw.group;
  *tile = lw.tile;
  return cdiv(tout, lw.tile);
}

// 1 where a product of M output and K input channels takes the wide GEMM
// (wide::route), else 0.
int gemm_wide(int M, int K) { return wide::route(M, K) ? 1 : 0; }

// One U-ConvBlock forward on `stream`. x, out: (B, Co, T); proj_w (Ci, Co);
// dw_w (depth, Ci, 5); dw_b/dw_g/dw_beta (depth, Ci); res_w (Co, Ci); the
// slopes are device scalars; `work` is 256-byte aligned and sized by
// uconv_workspace_floats with the same pyramid_bf16 (0: fp32 pyramid, 1:
// bf16). T % 2^(depth-1) == 0. Returns the first launch error, else
// cudaSuccess.
int uconv_block_forward(
    const float* x, float* out, const float* proj_w, const float* proj_b,
    const float* proj_g, const float* proj_beta, const float* proj_slope,
    const float* dw_w, const float* dw_b, const float* dw_g,
    const float* dw_beta, const float* final_g, const float* final_beta,
    const float* final_slope, const float* res_w, const float* res_b,
    float* work, int B, int Co, int Ci, int T, int depth, float eps,
    int pyramid_bf16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const Layout L = layout(B, Co, Ci, T, depth, pyramid_bf16 != 0);
  const size_t plane = (size_t)B * Ci;
  float* y = work + L.y;
  float* folds = work + L.folds;
  float* part = work + L.part;
  auto fa = [&](int s) { return folds + (size_t)(2 * s) * plane; };
  auto fb = [&](int s) { return folds + (size_t)(2 * s + 1) * plane; };
  cudaError_t err;

  // one thread a value of the larger weight's plane, at most 1024 blocks
  const size_t wplane = std::max(split_floats(Ci, Co), split_floats(Co, Ci)) / 2;
  const int sblocks = (int)std::min<size_t>(wplane / NT + 1, 1024);
  int* counter = reinterpret_cast<int*>(work + L.cnt);
  split_kernel<<<dim3(sblocks, 2), NT, 0, st>>>(proj_w, Ci, Co, work + L.sp, res_w,
                                                 Co, Ci, work + L.sr, counter, B);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  if ((err = gemm<false>(st, work + L.sp, x, proj_b, nullptr, nullptr, nullptr,
                         nullptr, y, part, B, Ci, Co, T)) != cudaSuccess)
    return (int)err;
  fold_kernel<<<B, NT, 0, st>>>(part, cdiv(Ci, SUB) * cdiv(T, SUB), proj_g,
                                proj_beta, Ci, eps, fa(0), fb(0));

  if (pyramid_bf16)
    ladder_upsum(st, y, work + L.ping, reinterpret_cast<__nv_bfloat16*>(work + L.pyr), folds,
                 part, counter, proj_slope, dw_w, dw_b, dw_g, dw_beta, B, Ci, T, depth, eps);
  else
    ladder_upsum(st, y, work + L.ping, work + L.pyr, folds, part, counter, proj_slope, dw_w,
                 dw_b, dw_g, dw_beta, B, Ci, T, depth, eps);
  fold_kernel<<<B, NT, 0, st>>>(part, Ci, final_g, final_beta, Ci, eps,
                                fa(depth + 1), fb(depth + 1));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  return (int)gemm<true>(st, work + L.sr, y, res_b, fa(depth + 1), fb(depth + 1),
                         final_slope, x, out, nullptr, B, Co, Ci, T);
}

}  // extern "C"
