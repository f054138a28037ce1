// TAC (transform-average-concatenate across channel groups) for Hopper
// (sm_90a), fp32 in and out: the step before each block of GroupComm
// SuDoRM-RF v2. Over x (B, G, n, T), hidden h = 3n:
//
//   y_g   = prelu(W_in x_g + b_in)                    (h channels a group)
//   m     = prelu(W_mean (1/G sum_g y_g) + b_mean)     (h channels)
//   o_g   = prelu(W_oy y_g + W_om m + b_out)           (n channels a group)
//   out_g = x_g + GlobLN(o_g)                          (per (batch, group) over (n, T))
//
// with W_out = [W_oy | W_om] (n, 2h) split along its input axis by offset,
// as ops/tac.py::tac_plain splits it; GlobLN with the population variance
// and eps 1e-8, as ops.glob_ln.
//
// It replaces no TPU kernel: the JAX package runs TAC in plain XLA
// (sudo_rm_rf_tpu/models/fast_inference.py::_tac_fast). It was added
// because, as some 30 eager PyTorch passes, TAC took 71 % of the device
// time of GroupComm U16/512's serving forward on the H100 (66 ms of a 94 ms
// batch of 32 x 4 s at 8 kHz, group 16): those passes move about 6.6 GB a
// TAC, 12x the bytes TAC needs.
//
// What bounds it on this card: bytes. TAC has to read x and write its result;
// GlobLN's statistics span all T frames of a (batch, group), so one pass
// cannot finish it. Two passes move 5 x 4 B an element: 524 MB a TAC at
// (32, 16, 16, 3200), 0.157 ms at 3.35 TB/s. The arithmetic is 5.66 GFLOP
// (2 B T (G (h n + n h) + h h + n h)), 8.2 GFLOP with y computed twice, as
// here: 0.122 ms on the fp32 pipes (67 TFLOP/s), so on the fp32 pipes the
// first pass would be bound by its arithmetic, not by its 210 MB (0.063
// ms). Its products therefore run on the tensor cores in 3xTF32, which
// keeps fp32's accuracy at a third of TF32's rate (495 TFLOP/s).
//
//   mix  (tac_mix_kernel)   reads x, writes o (pre-norm) and, per tile of
//                           TILE frames and group, the tile's exact
//                           (count, mean, M2)
//   fold (tac_fold_kernel)  only where a plane has more than FOLD_TILES
//                           tiles (the 10-minute pass: 7,500): merges each
//                           (batch, group)'s tiles once into (mean, rstd)
//   norm (tac_norm_kernel)  reads x and o, writes x + gamma (o - mean) rstd
//                           + beta over o, in place; merges its plane's
//                           tiles itself where there was no fold launch
//
// What the design keeps out of device memory: the hidden y (B, G, h, T),
// three times x's size, and the group mean. A warp of the mix kernel owns
// 16 frames of one batch row across all G groups, as the rows of its mma's
// (m16n8k8: frames x channels, so every product is x^T W^T). It sums y
// over the groups in registers, takes m and W_om m + b_out once, and then,
// group by group, computes y_g again from x_g (read twice; the second read
// mostly from L2) and W_oy y_g + c. One product's accumulators feed the
// next as its A operand where they are, with the k-step's channels taken in
// the order the accumulator layout holds them (d_to_a); the weights' B
// fragments are stored in that order. Each block splits its weights into
// tf32 (hi, lo) fragments in shared memory once (37 KB at n = 16),
// zero-padded to NP channels (8, 16 or 32), so that any n up to 32 takes
// whole k-steps. The PReLU slopes are read on the device.
//
// Statistics: a lane's values of one group give an exact (mean, M2); a
// warp merges its lanes with Chan's formula in a fixed shuffle tree and
// thread 0 the block's warps in order; the norm (or fold) kernel merges a
// plane's tiles in float64 in a fixed order: thread t takes tiles t, t +
// 256, ... in turn, each warp is a fixed shuffle tree, warp 0 merges the
// eight warps in order. The fold kernel and the norm kernel call the same
// merge, so a plane's statistics have the same bits either way. No
// atomics: two calls on one input are bit-identical.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 32;            // the widest group (channels) the kernel takes
constexpr int MIX_WARPS = 4;         // warps of a mix block
constexpr int MIX_THREADS = 32 * MIX_WARPS;
constexpr int TILE = MIX_WARPS * 16;  // a mix block's frames (16 a warp, an mma's rows)
constexpr int NORM_THREADS = 256;    // threads of a norm or fold block
constexpr int NORM_ITER = 4;         // float4s (or groups of 4 floats) a norm thread takes
constexpr int NORM_CHUNK = NORM_THREADS * 4 * NORM_ITER;  // floats of a plane a norm block takes
constexpr int FOLD_TILES = NORM_THREADS;  // beyond this many tiles a plane, a fold launch
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The group width padded to whole mma k-steps (8 channels): 8, 16 or 32.
inline int padded_n(int n) { return n <= 8 ? 8 : n <= 16 ? 16 : 32; }

// B fragments of the four products (W_in, W_oy, W_mean, W_om) for NP
// channels a group: (h/8)(n/8) + (n/8)(h/8) + (h/8)^2 + (n/8)(h/8), h = 3 NP.
__host__ __device__ constexpr int mix_frags(int np) {
  return 3 * (3 * np / 8) * (np / 8) + (3 * np / 8) * (3 * np / 8);
}
// a mix block's shared memory: the fragments (16 bytes a lane each) and
// b_in, b_mean (3 NP), b_out (NP)
__host__ __device__ constexpr int mix_smem_bytes(int np) {
  return mix_frags(np) * 32 * 16 + (7 * np) * 4;
}

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

// Fixed shuffle tree over a warp: lane 0 ends with the warp's moments.
template <typename T>
__device__ inline void warp_moments(T& n, T& mean, T& m2) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T nb = __shfl_down_sync(FULL, n, off);
    const T mb = __shfl_down_sync(FULL, mean, off);
    const T qb = __shfl_down_sync(FULL, m2, off);
    chan_merge(n, mean, m2, nb, mb, qb);
  }
}

__device__ inline float prelu(float v, float s) { return v >= 0.f ? v : s * v; }

__device__ inline void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
  const float rest = v - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// d = a b + d on the tensor cores: m16n8k8, tf32 in, fp32 accumulate.
__device__ inline void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a b for one 8-deep k-step in 3xTF32: lo hi + hi lo + hi hi summed
// afresh on the tensor cores, which do not round to nearest as they
// accumulate, and added to acc in fp32, which does (csrc/uconv.cu's GEMMs
// keep their sums the same way). b = (hi b0, hi b1, lo b0, lo b1).
__device__ inline void mma3(float (&acc)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                            const uint4 b) {
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(d, al, b.x, b.y);
  mma_tf32(d, ah, b.z, b.w);
  mma_tf32(d, ah, b.x, b.y);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// acc += a b for one k-step in 3xTF32 kept in the tensor cores' sum: for
// the first product, whose reduction is only n channels deep.
__device__ inline void mma3_direct(float (&acc)[4], const uint32_t (&ah)[4],
                                   const uint32_t (&al)[4], const uint4 b) {
  mma_tf32(acc, al, b.x, b.y);
  mma_tf32(acc, ah, b.z, b.w);
  mma_tf32(acc, ah, b.x, b.y);
}

// An accumulator tile (frames x 8 channels, the mma's D layout: rows r and r
// + 8, columns 2q and 2q + 1) as the A operand of the next product over
// those channels, split into (hi, lo). The A layout wants columns q and q +
// 4, so the next product takes its k-step's channels in the order 0, 2, 4,
// 6, 1, 3, 5, 7; its B fragments are stored in that order too.
__device__ inline void d_to_a(const float (&d)[4], uint32_t (&ah)[4], uint32_t (&al)[4]) {
  split_tf32(d[0], ah[0], al[0]);
  split_tf32(d[2], ah[1], al[1]);
  split_tf32(d[1], ah[2], al[2]);
  split_tf32(d[3], ah[3], al[3]);
}

// The A fragments of one group's x (frames x NP channels), xg pointing at
// the group's channel 0, for a warp's rows fr and fr + 8: k-step ks holds
// channels 8 ks + q and 8 ks + q + 4; 0 past n or T. Offsets within the
// group's (n, T) plane are 32-bit.
template <int KN>
__device__ __forceinline__ void load_x(const float* __restrict__ xg, int n, int T, int q,
                                       int fr, float (&a)[KN][4]) {
  const bool ok0 = fr < T, ok1 = fr + 8 < T;
#pragma unroll
  for (int ks = 0; ks < KN; ++ks) {
    const int c0 = 8 * ks + q, c1 = c0 + 4;
    const float* p0 = xg + c0 * T + fr;
    const float* p1 = xg + c1 * T + fr;
    a[ks][0] = c0 < n && ok0 ? __ldg(p0) : 0.f;
    a[ks][1] = c0 < n && ok1 ? __ldg(p0 + 8) : 0.f;
    a[ks][2] = c1 < n && ok0 ? __ldg(p1) : 0.f;
    a[ks][3] = c1 < n && ok1 ? __ldg(p1 + 8) : 0.f;
  }
}

// acc[nt] = the bias of channels 8 nt + 2q and + 1 (the D layout's columns)
template <int NO>
__device__ __forceinline__ void init_bias(const float* __restrict__ bias, int q,
                                          float (&acc)[NO][4]) {
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
    const float2 v = *reinterpret_cast<const float2*>(bias + 8 * nt + 2 * q);
    acc[nt][0] = acc[nt][2] = v.x;
    acc[nt][1] = acc[nt][3] = v.y;
  }
}

template <int NO>
__device__ __forceinline__ void prelu_all(float (&v)[NO][4], float slope) {
#pragma unroll
  for (int nt = 0; nt < NO; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) v[nt][e] = prelu(v[nt][e], slope);
}

// y_g^T (frames x h) = x_g^T W_in^T + b_in, then PReLU: y[nt] is hidden
// channels [8 nt, 8 nt + 8) in the D layout.
template <int KN, int KH>
__device__ __forceinline__ void hidden(const float (&xa)[KN][4], const uint4* __restrict__ fw,
                                       const float* __restrict__ s_bin, int lane, float slope,
                                       float (&y)[KH][4]) {
  uint32_t ah[KN][4], al[KN][4];
#pragma unroll
  for (int ks = 0; ks < KN; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(xa[ks][e], ah[ks][e], al[ks][e]);
  init_bias<KH>(s_bin, lane & 3, y);
#pragma unroll
  for (int nt = 0; nt < KH; ++nt)
#pragma unroll
    for (int ks = 0; ks < KN; ++ks)
      mma3_direct(y[nt], ah[ks], al[ks], fw[(nt * KN + ks) * 32 + lane]);
  prelu_all<KH>(y, slope);
}

// acc[nt] += a^T W^T over KI k-steps of 8 channels, a in the D layout
// (a[ks] is the k-step's accumulator tile), W's fragments fw[(nt KI + ks)
// 32 + lane] in d_to_a's channel order; NO output tiles.
template <int KI, int NO>
__device__ __forceinline__ void chain(const float (&a)[KI][4], const uint4* __restrict__ fw,
                                      int lane, float (&acc)[NO][4]) {
#pragma unroll
  for (int ks = 0; ks < KI; ++ks) {
    uint32_t ah[4], al[4];
    d_to_a(a[ks], ah, al);
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) mma3(acc[nt], ah, al, fw[(nt * KI + ks) * 32 + lane]);
  }
}

// Block (tile, batch row): warp w takes frames [TILE tile + 16 w, + 16) as
// the rows of its mma's; lane l has rows fr = TILE tile + 16 w + l / 4 and
// fr + 8, and, in the D layout, channels 2 q and 2 q + 1 of each 8, q = l %
// 4. Writes o (B, G, n, T) and part[((b G + g) P + tile)] = (count, mean,
// M2) of the tile's o_g.
//
// Shared memory: the B fragments of W_in^T (KH x KN of them), W_oy^T (KN x
// KH), W_mean^T (KH x KH) and W_om^T (KN x KH), each lane's two weights of
// a fragment split into tf32 (hi, lo) once a block, zero past n and h; the
// biases, zero-padded.
template <int NP>
__global__ void __launch_bounds__(MIX_THREADS) tac_mix_kernel(
    const float* __restrict__ x, float* __restrict__ out, float* __restrict__ part,
    const float* __restrict__ w_in, const float* __restrict__ b_in,
    const float* __restrict__ s_in, const float* __restrict__ w_mean,
    const float* __restrict__ b_mean, const float* __restrict__ s_mean,
    const float* __restrict__ w_out, const float* __restrict__ b_out,
    const float* __restrict__ s_out, int G, int n, int T, int P) {
  constexpr int HP = 3 * NP, KN = NP / 8, KH = HP / 8;
  constexpr int F_IN = 0, F_OY = KH * KN, F_MEAN = F_OY + KN * KH, F_OM = F_MEAN + KH * KH,
                NF = F_OM + KN * KH;
  extern __shared__ uint4 smem[];
  uint4* frag = smem;
  float* s_bin = reinterpret_cast<float*>(frag + NF * 32);
  float* s_bmean = s_bin + HP;
  float* s_bout = s_bmean + HP;
  __shared__ float red[2][MIX_WARPS][3];
  const int h = 3 * n, tid = threadIdx.x;
  for (int e = tid; e < NF * 32; e += MIX_THREADS) {
    const int fi = e >> 5, r = (e & 31) >> 2, q = e & 3;
    float v0, v1;
    if (fi < F_OY) {  // W_in^T: k = input channel 8 ks + q (+ 4), n = hidden 8 nt + r
      const int j = 8 * (fi / KN) + r, i = 8 * (fi % KN) + q;
      v0 = j < h && i < n ? w_in[j * n + i] : 0.f;
      v1 = j < h && i + 4 < n ? w_in[j * n + i + 4] : 0.f;
    } else if (fi < F_MEAN || fi >= F_OM) {  // W_oy^T, W_om^T: k = hidden 8 ks + 2q (+ 1)
      const int f = fi < F_MEAN ? fi - F_OY : fi - F_OM, off = fi < F_MEAN ? 0 : h;
      const int i = 8 * (f / KH) + r, j = 8 * (f % KH) + 2 * q;
      v0 = i < n && j < h ? w_out[(size_t)i * 2 * h + off + j] : 0.f;
      v1 = i < n && j + 1 < h ? w_out[(size_t)i * 2 * h + off + j + 1] : 0.f;
    } else {  // W_mean^T: k = hidden 8 ks + 2q (+ 1), n = hidden 8 nt + r
      const int f = fi - F_MEAN, j = 8 * (f / KH) + r, k = 8 * (f % KH) + 2 * q;
      v0 = j < h && k < h ? w_mean[j * h + k] : 0.f;
      v1 = j < h && k + 1 < h ? w_mean[j * h + k + 1] : 0.f;
    }
    uint4 w;
    split_tf32(v0, w.x, w.z);
    split_tf32(v1, w.y, w.w);
    frag[e] = w;
  }
  for (int j = tid; j < HP; j += MIX_THREADS) {
    s_bin[j] = j < h ? b_in[j] : 0.f;
    s_bmean[j] = j < h ? b_mean[j] : 0.f;
  }
  for (int i = tid; i < NP; i += MIX_THREADS) s_bout[i] = i < n ? b_out[i] : 0.f;
  const float sl_in = *s_in, sl_mean = *s_mean, sl_out = *s_out;
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5, q = lane & 3;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int fr = tile * TILE + warp * 16 + (lane >> 2);
  const size_t row0 = (size_t)b * G * n;  // x's row of (b, group 0, channel 0)

  // the group sum of y, in the D layout
  float macc[KH][4];
#pragma unroll
  for (int nt = 0; nt < KH; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) macc[nt][e] = 0.f;
  float xn[KN][4];
  load_x<KN>(x + row0 * T, n, T, q, fr, xn);
  for (int g = 0; g < G; ++g) {
    float xa[KN][4], y[KH][4];
#pragma unroll
    for (int ks = 0; ks < KN; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[ks][e] = xn[ks][e];
    if (g + 1 < G) load_x<KN>(x + (row0 + (size_t)(g + 1) * n) * T, n, T, q, fr, xn);
    hidden<KN, KH>(xa, frag + F_IN * 32, s_bin, lane, sl_in, y);
#pragma unroll
    for (int nt = 0; nt < KH; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) macc[nt][e] += y[nt][e];
  }
  const float inv_g = 1.f / (float)G;
#pragma unroll
  for (int nt = 0; nt < KH; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) macc[nt][e] *= inv_g;

  // m^T = prelu(mean^T W_mean^T + b_mean); c^T = m^T W_om^T + b_out
  float m[KH][4], c[KN][4];
  init_bias<KH>(s_bmean, q, m);
  chain<KH, KH>(macc, frag + F_MEAN * 32, lane, m);
  prelu_all<KH>(m, sl_mean);
  init_bias<KN>(s_bout, q, c);
  chain<KH, KN>(m, frag + F_OM * 32, lane, c);

  // group by group: y_g again, o_g = prelu(y_g^T W_oy^T + c^T), its moments
  load_x<KN>(x + row0 * T, n, T, q, fr, xn);
  for (int g = 0; g < G; ++g) {
    float xa[KN][4], y[KH][4], o[KN][4];
#pragma unroll
    for (int ks = 0; ks < KN; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) xa[ks][e] = xn[ks][e];
    if (g + 1 < G) load_x<KN>(x + (row0 + (size_t)(g + 1) * n) * T, n, T, q, fr, xn);
    hidden<KN, KH>(xa, frag + F_IN * 32, s_bin, lane, sl_in, y);
#pragma unroll
    for (int nt = 0; nt < KN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nt][e] = c[nt][e];
    chain<KH, KN>(y, frag + F_OY * 32, lane, o);
    prelu_all<KN>(o, sl_out);
    float* og = out + (row0 + (size_t)g * n) * T;
    float cnt = 0.f, sum = 0.f;
#pragma unroll
    for (int nt = 0; nt < KN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = 8 * nt + 2 * q + (e & 1), t = fr + (e < 2 ? 0 : 8);
        if (ch < n && t < T) {
          og[ch * T + t] = o[nt][e];
          sum += o[nt][e];
          cnt += 1.f;
        }
      }
    float mu = cnt > 0.f ? sum / cnt : 0.f, m2 = 0.f;
#pragma unroll
    for (int nt = 0; nt < KN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ch = 8 * nt + 2 * q + (e & 1), t = fr + (e < 2 ? 0 : 8);
        if (ch < n && t < T) {
          const float d = o[nt][e] - mu;
          m2 = fmaf(d, d, m2);
        }
      }
    warp_moments(cnt, mu, m2);
    if (lane == 0) {
      red[g & 1][warp][0] = cnt;
      red[g & 1][warp][1] = mu;
      red[g & 1][warp][2] = m2;
    }
    __syncthreads();
    if (tid == 0) {  // the tile's moments: its warps merged in order
      for (int w = 1; w < MIX_WARPS; ++w)
        chan_merge(cnt, mu, m2, red[g & 1][w][0], red[g & 1][w][1], red[g & 1][w][2]);
      float* p = part + 3 * (((size_t)b * G + g) * P + tile);
      p[0] = cnt;
      p[1] = mu;
      p[2] = m2;
    }
  }
}

// A plane's P tile moments (at p) merged in float64 in a fixed order:
// thread t takes tiles t, t + NORM_THREADS, ... in turn, each warp is a
// fixed shuffle tree, and thread 0 merges the warps in order. Every thread
// of the block must call it; the (mean, rstd) of GlobLN land in *mu and
// *rstd (shared memory) after its closing barrier.
__device__ void merge_plane(const float* __restrict__ p, int P, float eps, float* mu,
                            float* rstd) {
  __shared__ double red[NORM_THREADS / 32][3];
  double n = 0.0, mean = 0.0, m2 = 0.0;
  for (int q = threadIdx.x; q < P; q += NORM_THREADS)
    chan_merge<double>(n, mean, m2, p[3 * q], p[3 * q + 1], p[3 * q + 2]);
  warp_moments(n, mean, m2);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red[warp][0] = n;
    red[warp][1] = mean;
    red[warp][2] = m2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NORM_THREADS / 32; ++w)
      chan_merge(n, mean, m2, red[w][0], red[w][1], red[w][2]);
    *mu = (float)mean;
    *rstd = (float)(1.0 / sqrt(m2 / n + (double)eps));
  }
  __syncthreads();
}

// One block a (batch, group) plane: its (mean, rstd) into folded[2 bg].
__global__ void __launch_bounds__(NORM_THREADS) tac_fold_kernel(
    const float* __restrict__ part, int P, float eps, float* __restrict__ folded) {
  __shared__ float mu, rstd;
  const size_t bg = blockIdx.x;
  merge_plane(part + 3 * bg * P, P, eps, &mu, &rstd);
  if (threadIdx.x == 0) {
    folded[2 * bg] = mu;
    folded[2 * bg + 1] = rstd;
  }
}

// Block (plane bg, chunk): o = x + gamma[c] (o - mean) rstd + beta[c] over
// the chunk's NORM_CHUNK floats of the plane (n rows of T), in place. The
// statistics come from `folded` where a fold launch made them, else from the
// plane's tiles. VEC (T % 4 == 0, x and o 16-byte aligned): float4 loads
// and stores, one channel a float4.
template <bool VEC>
__global__ void __launch_bounds__(NORM_THREADS) tac_norm_kernel(
    const float* __restrict__ x, float* __restrict__ o, const float* __restrict__ part,
    const float* __restrict__ folded, const float* __restrict__ gamma,
    const float* __restrict__ beta, int n, int T, int P, float eps) {
  __shared__ float mu, rstd;
  const size_t bg = blockIdx.x;
  if (folded != nullptr) {
    if (threadIdx.x == 0) {
      mu = folded[2 * bg];
      rstd = folded[2 * bg + 1];
    }
    __syncthreads();
  } else {
    merge_plane(part + 3 * bg * P, P, eps, &mu, &rstd);
  }
  const float m = mu, r = rstd;
  const unsigned plane = (unsigned)n * (unsigned)T;
  const float* xp = x + bg * plane;
  float* op = o + bg * plane;
  const unsigned e0 = blockIdx.y * (unsigned)NORM_CHUNK;
  if (VEC) {
#pragma unroll
    for (int it = 0; it < NORM_ITER; ++it) {
      const unsigned e = e0 + 4u * (it * NORM_THREADS + threadIdx.x);
      if (e >= plane) break;
      const unsigned c = e / (unsigned)T;
      const float a = __ldg(gamma + c) * r, sh = __ldg(beta + c);
      const float4 xv = __ldg(reinterpret_cast<const float4*>(xp + e));
      float4 ov = *reinterpret_cast<const float4*>(op + e);
      ov.x = xv.x + fmaf(ov.x - m, a, sh);
      ov.y = xv.y + fmaf(ov.y - m, a, sh);
      ov.z = xv.z + fmaf(ov.z - m, a, sh);
      ov.w = xv.w + fmaf(ov.w - m, a, sh);
      *reinterpret_cast<float4*>(op + e) = ov;
    }
  } else {
#pragma unroll
    for (int it = 0; it < 4 * NORM_ITER; ++it) {
      const unsigned e = e0 + it * NORM_THREADS + threadIdx.x;
      if (e >= plane) break;
      const unsigned c = e / (unsigned)T;
      op[e] = __ldg(xp + e) + fmaf(op[e] - m, __ldg(gamma + c) * r, __ldg(beta + c));
    }
  }
}

template <int NP>
cudaError_t launch_mix(cudaStream_t st, const float* x, float* out, float* part,
                       const float* w_in, const float* b_in, const float* s_in,
                       const float* w_mean, const float* b_mean, const float* s_mean,
                       const float* w_out, const float* b_out, const float* s_out, int B,
                       int G, int n, int T, int P) {
  const int smem = mix_smem_bytes(NP);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tac_mix_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  tac_mix_kernel<NP><<<dim3(P, B), MIX_THREADS, smem, st>>>(
      x, out, part, w_in, b_in, s_in, w_mean, b_mean, s_mean, w_out, b_out, s_out, G, n, T, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Warp tiles of T frames a (batch, group) plane: tile moments a plane.
int tac_tiles(int T) { return cdiv(T, TILE); }

// Floats of scratch the caller allocates for tac_forward: the tile moments
// and the fold's (mean, rstd) of every plane.
long long tac_workspace_floats(int B, int G, int T) {
  return (long long)B * G * (3LL * cdiv(T, TILE) + 2);
}

// Launches of one tac_forward: 2, or 3 with the fold.
int tac_launches(int T) { return cdiv(T, TILE) > FOLD_TILES ? 3 : 2; }

// One TAC on `stream`. x, out: (B, G, n, T), 1 <= n <= 32; w_in (3n, n),
// b_in (3n,), w_mean (3n, 3n), b_mean (3n,), w_out (n, 6n), b_out, gamma,
// beta (n,); the slopes are device scalars; `work` holds
// tac_workspace_floats(B, G, T) floats. n T <= 65535 x 4096, and n
// padded to 8, 16 or 32 times T < 2^31.
// Returns the first launch error, else cudaSuccess.
int tac_forward(const float* x, float* out, const float* w_in, const float* b_in,
                const float* s_in, const float* w_mean, const float* b_mean,
                const float* s_mean, const float* w_out, const float* b_out,
                const float* s_out, const float* gamma, const float* beta, float* work, int B,
                int G, int n, int T, float eps, void* stream) {
  if (n < 1 || n > MAX_N || B < 1 || B > 65535 || G < 1 || T < 1 ||
      (long long)n * T > 65535LL * NORM_CHUNK || (long long)padded_n(n) * T >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int P = cdiv(T, TILE);
  float* part = work;
  float* folded = work + 3LL * B * G * P;
  cudaError_t err;
  switch (padded_n(n)) {
    case 8:
      err = launch_mix<8>(st, x, out, part, w_in, b_in, s_in, w_mean, b_mean, s_mean, w_out,
                          b_out, s_out, B, G, n, T, P);
      break;
    case 16:
      err = launch_mix<16>(st, x, out, part, w_in, b_in, s_in, w_mean, b_mean, s_mean, w_out,
                           b_out, s_out, B, G, n, T, P);
      break;
    default:
      err = launch_mix<32>(st, x, out, part, w_in, b_in, s_in, w_mean, b_mean, s_mean, w_out,
                           b_out, s_out, B, G, n, T, P);
  }
  if (err != cudaSuccess) return (int)err;
  const bool fold = P > FOLD_TILES;
  if (fold) {
    tac_fold_kernel<<<B * G, NORM_THREADS, 0, st>>>(part, P, eps, folded);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const dim3 grid(B * G, cdiv(n * T, NORM_CHUNK));
  if (T % 4 == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)out % 16 == 0)
    tac_norm_kernel<true><<<grid, NORM_THREADS, 0, st>>>(x, out, part, fold ? folded : nullptr,
                                                         gamma, beta, n, T, P, eps);
  else
    tac_norm_kernel<false><<<grid, NORM_THREADS, 0, st>>>(x, out, part, fold ? folded : nullptr,
                                                          gamma, beta, n, T, P, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
