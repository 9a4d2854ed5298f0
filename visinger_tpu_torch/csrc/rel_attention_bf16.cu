// K1 and K3 in bfloat16: the relative-position attention forward and
// backward for bf16 q, k, v (the bf16 compute recipes), for sm_90a.
//
// They compute what visinger_tpu/ops/pallas/attention_kernel.py's
// _attn_fwd_kernel and _attn_bwd_kernel compute when q, k and v are bf16,
// with the rounding points of that kernel:
//   forward:  S = Q K^T accumulated in float32; the band bias from the
//             float32 emb_rel_k (q is exact in float32); softmax and dropout
//             in float32; P rounded to bf16 (:137); out = P V + band(P)
//             emb_rel_v accumulated in float32 (:141-143) and written in bf16
//             (:145).  Each row's max and sum are saved in float32, as the
//             float32 build (rel_attention.cu) saves them.
//   backward: g in bf16 (:280); p in float32 from the saved max and sum; the
//             dropped P rounded to bf16 (:176) for dv and d emb_rel_v; every
//             other product and dS in float32; dq, dk, dv written in bf16
//             (:284), d emb_rel_k/v in float32.
// The math, the mask (-1e4 at a pair whose query or key is at or past len,
// not -inf) and the dropout hash are those of rel_attention.cu's note.
//
// Products.  A bf16 x bf16 product is exact in a float32 accumulator, so
// Q K^T, G V^T, P V and P^T G each take one bf16 mma.sync m16n8k16 per k-step
// (the tensor core's bf16 path).  dS K and dS^T Q have a float32 operand dS:
// they run on mma.sync m16n8k8 in TF32 with dS split into hi and lo TF32
// parts (tf32x3.cuh); the bf16 operand is exact in TF32, so its lo part is
// zero and two products (lo * b, hi * b) give float32 accuracy.  Every
// k-step's products start from zero and are added to the running sum with a
// float32 add (the tensor core truncates its running sum; tf32x3.cuh).
//
// Design: simple first.  A block owns 16 query rows (K1, K3's row pass) or
// 16 keys (K3's column pass) of one (item, head) and four warps; tiles of 64
// keys (or query rows) come into shared memory by plain loads, one buffer,
// and warp w takes keys (rows) [16 w, 16 w + 16) of each tile.  Each warp
// keeps its own partial sums (row max and sum, D_i, O, dq, dk, dv), merged
// through shared memory in warp order at the end.  Because P is rounded
// after the softmax is normalised, K1 takes two passes over the keys: the
// first gives each row's max and sum (online per warp, then merged), the
// second P = exp(s - max) / sum, rounded, times V.  K3 needs
// D_i = sum_j dp_ij p_ij over the float32 p (g . out is not that sum here:
// out was built from the rounded P and rounded itself), so its row pass
// takes two passes over the keys too (D, then dS and dq); its column pass
// recomputes S and dP for dk and dv.  A tile of rows all below len visits
// the keys below len only (a key at or past len weighs exp(-1e4 - max) = 0
// in float32).  No atomics: the emb gradients are per-block partials summed
// in a fixed order, so a rerun gives the same bits.  The head width dk is a
// multiple of 8, at most 128; tiles are zero-padded to a multiple of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int MAX_DK = 128;
constexpr int MAXN = MAX_DK / 8;  // n8 tiles of dk
constexpr float MASK_VAL = -1e4f;
constexpr uint32_t GOLD = 0x9E3779B9u;
constexpr int ROWS = 16;          // query rows (or keys) per block
constexpr int KS = 4;             // warps per block, each a share of the keys
constexpr int NT = 32 * KS;       // threads per block
constexpr int KT = 16 * KS;       // keys (or query rows) per tile, 16 a warp

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ uint32_t row_key(uint32_t seed, int bh, int i) {
  return fmix32(fmix32(seed + GOLD * (uint32_t)(bh + 1)) ^ (uint32_t)i);
}

__device__ __forceinline__ uint32_t keep_bits(uint32_t rk, int j) {
  return fmix32(rk + (uint32_t)j * GOLD);
}

struct Drop {
  const int* seed;   // device scalar; read only when on
  uint32_t thr;      // keep when bits >= thr
  float keep_scale;  // 1 / (1 - rate)
  int on;
};

__host__ __device__ __forceinline__ int dk_pad(int dk) {
  return (dk + 15) / 16 * 16;
}
// row stride of a bf16 tile, in elements: 8 past the padded width, so that
// the fragment reads of 8 rows fall in distinct banks
__host__ __device__ __forceinline__ int ld_of(int dk) { return dk_pad(dk) + 8; }

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// x rounded to bf16 and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *(const uint32_t*)p;
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// two floats already exact in bf16 -> one register, the first in the low half
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

// d = a * b, bf16 operands, float32 result (the accumulator input is zero).
// With g = lane / 4 and c = lane % 4 a thread holds
//   A (16x16): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..), a3 (g+8, 2c+8..)
//   B (16x8):  b0 (k 2c..2c+1, n g), b1 (k 2c+8..2c+9, n g)
//   D (16x8):  d0 (g, 2c), d1 (g, 2c+1), d2 (g+8, 2c), d3 (g+8, 2c+1)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// s = A B^T for 16 rows of A and 8 rows of B (both [rows][ld] bf16 tiles in
// shared memory) over nk16 k-steps of 16
__device__ __forceinline__ void tile_dot(float (&s)[4], const bf16* A,
                                         const bf16* Bn, int ld, int nk16) {
  const int g = tf32x3::lane_g(), c = tf32x3::lane_c();
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = 0.f;
  for (int kk = 0; kk < 16 * nk16; kk += 16) {
    const uint32_t a[4] = {ld32(A + g * ld + kk + 2 * c),
                           ld32(A + (g + 8) * ld + kk + 2 * c),
                           ld32(A + g * ld + kk + 2 * c + 8),
                           ld32(A + (g + 8) * ld + kk + 2 * c + 8)};
    float d[4];
    mma_bf16(d, a, ld32(Bn + g * ld + kk + 2 * c),
             ld32(Bn + g * ld + kk + 2 * c + 8));
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] += d[e];
  }
}

// acc += P B over 16 keys: P the bf16-exact values of two m16n8 accumulator
// tiles (keys 0-7 and 8-15), B[key][n] = s[key * ld + n] (s at column n0)
__device__ __forceinline__ void mma_pb(float (&acc)[4], const float (&p0)[4],
                                       const float (&p1)[4], const bf16* s,
                                       int ld) {
  const int g = tf32x3::lane_g(), c = tf32x3::lane_c();
  const uint32_t a[4] = {pack_f(p0[0], p0[1]), pack_f(p0[2], p0[3]),
                         pack_f(p1[0], p1[1]), pack_f(p1[2], p1[3])};
  float d[4];
  mma_bf16(d, a, pack(s[2 * c * ld + g], s[(2 * c + 1) * ld + g]),
           pack(s[(2 * c + 8) * ld + g], s[(2 * c + 9) * ld + g]));
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// an m16n8 float32 accumulator tile over 8 keys, split into TF32 hi and lo
// as the A fragment of a product over those keys: k-index c is key 2c and
// c + 4 is key 2c + 1 (the order mma_xb reads B in)
struct SplitA {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ SplitA split_acc(const float (&x)[4]) {
  SplitA f;
  tf32x3::split(x[0], f.hi[0], f.lo[0]);
  tf32x3::split(x[2], f.hi[1], f.lo[1]);
  tf32x3::split(x[1], f.hi[2], f.lo[2]);
  tf32x3::split(x[3], f.hi[3], f.lo[3]);
  return f;
}

// acc += X B over 8 keys: X float32 (split_acc), B[key][n] = s[key * ld + n]
// bf16, exact in TF32, so two products give float32 accuracy
__device__ __forceinline__ void mma_xb(float (&acc)[4], const SplitA& x,
                                       const bf16* s, int ld) {
  const int g = tf32x3::lane_g(), c = tf32x3::lane_c();
  const uint32_t b[2] = {__float_as_uint(bf(s[2 * c * ld + g])),
                         __float_as_uint(bf(s[(2 * c + 1) * ld + g]))};
  float d[4];
  tf32x3::mma_zero(d, x.lo, b);
  tf32x3::mma(d, x.hi, b);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// rows [r0, r0 + n) of one head of a [B, T, C] bf16 tensor (src at the
// head's first channel of the item) -> an [n][ld] tile, zero past T and in
// the columns [dk, dk_pad)
__device__ void load_tile(bf16* dst, int ld, const bf16* src, int r0, int n,
                          int T, int C, int dk) {
  const int vec = dk_pad(dk) / 8;
  for (int idx = threadIdx.x; idx < n * vec; idx += blockDim.x) {
    const int r = idx / vec, c8 = idx % vec, t = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T && c8 * 8 < dk)
      val = *(const uint4*)(src + (size_t)t * C + c8 * 8);
    *(uint4*)(dst + r * ld + c8 * 8) = val;
  }
}

// scale * (row . table[m]) for every row of a bf16 tile and band entry m
__device__ void band_dots(float* dst, const bf16* tile, int ld,
                          const float* table, int dk, int nb, float scale) {
  for (int idx = threadIdx.x; idx < ROWS * nb; idx += blockDim.x) {
    const bf16* row = tile + idx / nb * ld;
    const float* e = table + idx % nb * dk;
    float s = 0.f;
    for (int d = 0; d < dk; ++d) s = fmaf(bf(row[d]), e[d], s);
    dst[idx] = s * scale;
  }
}

// ---- K1-bf16 -------------------------------------------------------------

size_t fwd_smem(int dk, int window) {
  const size_t ld = ld_of(dk), nb = 2 * window + 1;
  return (ROWS + 2 * KT) * ld * 2 +
         (2 * nb * dk + 2 * ROWS * nb + 2 * KS * ROWS) * 4;
}

// one block per (16 query rows, head, item); warp ks takes keys
// [16 ks, 16 ks + 16) of every tile of 64
__global__ void __launch_bounds__(NT)
rel_attention_bf16_fwd_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const float* __restrict__ ek,
                              const float* __restrict__ ev,
                              const int* __restrict__ lengths,
                              bf16* __restrict__ out,
                              float* __restrict__ stats, Drop drop, int T,
                              int C, int dk, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, bh = b * H + h;
  const int q0 = blockIdx.x * ROWS;
  const int len = max(0, min(lengths[b], T));
  const int ld = ld_of(dk), nb = 2 * window + 1, nk16 = dk_pad(dk) / 16;
  const int n_dk = dk / 8;
  bf16* Qs = (bf16*)smem_raw;            // [ROWS][ld]
  bf16* Ks = Qs + ROWS * ld;             // [KT][ld]; then the O partials
  bf16* Vs = Ks + KT * ld;               // [KT][ld]
  float* Eks = (float*)(Vs + KT * ld);   // [nb][dk]
  float* Evs = Eks + nb * dk;            // [nb][dk]
  float* Rel = Evs + nb * dk;            // [ROWS][nb] scale q . emb_rel_k
  float* Band = Rel + ROWS * nb;         // [ROWS][nb] the rounded band P
  float* Ms = Band + ROWS * nb;          // [KS][ROWS] each warp's row max
  float* Ls = Ms + KS * ROWS;            // [KS][ROWS] each warp's row sum
  const size_t head = (size_t)b * T * C + (size_t)h * dk;

  load_tile(Qs, ld, q + head, q0, ROWS, T, C, dk);
  for (int idx = threadIdx.x; idx < nb * dk; idx += NT) {
    Eks[idx] = ek[idx];
    Evs[idx] = ev[idx];
  }
  for (int idx = threadIdx.x; idx < ROWS * nb; idx += NT) Band[idx] = 0.f;
  __syncthreads();
  band_dots(Rel, Qs, ld, Eks, dk, nb, scale);
  __syncthreads();

  const int ks = threadIdx.x >> 5, g = tf32x3::lane_g(),
            c = tf32x3::lane_c();
  const int kend = q0 + ROWS <= len ? len : T;
  const int n_tiles = (kend + KT - 1) / KT;
  const uint32_t seed = drop.on ? (uint32_t)*drop.seed : 0u;
  uint32_t rk[2] = {0u, 0u};
  if (drop.on) {
    rk[0] = row_key(seed, bh, q0 + g);
    rk[1] = row_key(seed, bh, q0 + g + 8);
  }

  // masked scores of this thread's rows (g, g + 8) and this warp's 16 keys
  // from j0
  auto scores = [&](int j0, const bf16* Kw, float (&x)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float s[4];
      tile_dot(s, Qs, Kw + 8 * n * ld, ld, nk16);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), i = q0 + r;
        const int j = j0 + 8 * n + 2 * c + (e & 1), off = j - i;
        float xe = s[e] * scale;
        if (off >= -window && off <= window) xe += Rel[r * nb + off + window];
        if (i >= len || j >= len) xe = MASK_VAL;
        if (j >= T) xe = -INFINITY;      // keys past T do not exist
        x[n][e] = xe;
      }
    }
  };

  // pass 1: each warp's row max and sum over its keys, online
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile(Ks, ld, k + head, t * KT, KT, T, C, dk);
    __syncthreads();
    const int j0 = t * KT + 16 * ks;
    if (j0 >= kend) continue;            // warp-uniform
    float x[2][4];
    scores(j0, Ks + 16 * ks * ld, x);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = fmaxf(fmaxf(x[0][2 * rr], x[0][2 * rr + 1]),
                       fmaxf(x[1][2 * rr], x[1][2 * rr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[rr], mx);  // key j0 < T: finite
      float l = l_run[rr] * expf(m_run[rr] - m_new);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        l += expf(x[n][2 * rr] - m_new) + expf(x[n][2 * rr + 1] - m_new);
      l_run[rr] = l;
      m_run[rr] = m_new;
    }
  }
  // merge the warps' (max, sum) in a fixed order (warp 0 first)
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 1);
    l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 2);
    if (c == 0) {
      Ms[ks * ROWS + g + 8 * rr] = m_run[rr];
      Ls[ks * ROWS + g + 8 * rr] = l_run[rr];
    }
  }
  __syncthreads();
  float m_row[2], l_row[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + 8 * rr;
    float m = -INFINITY, l = 0.f;
    for (int w = 0; w < KS; ++w) m = fmaxf(m, Ms[w * ROWS + r]);
    for (int w = 0; w < KS; ++w)  // a warp without keys: max -inf, sum 0
      l += Ls[w * ROWS + r] * expf(Ms[w * ROWS + r] - m);
    m_row[rr] = m;
    l_row[rr] = l;
  }

  // pass 2: P = exp(s - max) / sum, dropped, rounded to bf16; this warp's
  // share of O = P V
  float o[MAXN][4];
#pragma unroll
  for (int n = 0; n < MAXN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile(Ks, ld, k + head, t * KT, KT, T, C, dk);
    load_tile(Vs, ld, v + head, t * KT, KT, T, C, dk);
    __syncthreads();
    const int j0 = t * KT + 16 * ks;
    if (j0 >= kend) continue;            // warp-uniform
    float x[2][4];
    scores(j0, Ks + 16 * ks * ld, x);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), i = q0 + r, rr = e >> 1;
        const int j = j0 + 8 * n + 2 * c + (e & 1), off = j - i;
        float p = expf(x[n][e] - m_row[rr]) / l_row[rr];
        if (drop.on)
          p = keep_bits(rk[rr], j) >= drop.thr ? p * drop.keep_scale : 0.f;
        p = round_bf16(p);
        if (off >= -window && off <= window && j < T)
          Band[r * nb + off + window] = p;
        x[n][e] = p;
      }
#pragma unroll
    for (int n = 0; n < MAXN; ++n)
      if (n < n_dk)
        mma_pb(o[n], x[0], x[1], Vs + 16 * ks * ld + 8 * n, ld);
  }
  __syncthreads();  // the K/V tiles are free; every band weight stashed
  float* Op = (float*)Ks;                // [KS][ROWS][dk]
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n >= n_dk) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      Op[(ks * ROWS + g + 8 * (e >> 1)) * dk + 8 * n + 2 * c + (e & 1)] =
          o[n][e];
  }
  __syncthreads();

  // out = the warps' O summed in a fixed order + band(P) emb_rel_v, bf16
  for (int idx = threadIdx.x; idx < ROWS * dk / 2; idx += NT) {
    const int r = idx / (dk / 2), col = idx % (dk / 2) * 2, i = q0 + r;
    if (i >= T) continue;
    float val[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float acc = 0.f, bsum = 0.f;
      for (int w = 0; w < KS; ++w) acc += Op[(w * ROWS + r) * dk + col + u];
      for (int m = 0; m < nb; ++m)
        bsum = fmaf(Band[r * nb + m], Evs[m * dk + col + u], bsum);
      val[u] = acc + bsum;
    }
    *(__nv_bfloat162*)(out + head + (size_t)i * C + col) =
        __floats2bfloat162_rn(val[0], val[1]);
  }
  if (ks == 0 && c == 0) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = q0 + g + 8 * rr;
      if (i < T) {
        stats[((size_t)bh * T + i) * 2] = m_row[rr];
        stats[((size_t)bh * T + i) * 2 + 1] = l_row[rr];
      }
    }
  }
}

// ---- K3-bf16 -------------------------------------------------------------

size_t round4(size_t n) { return (n + 3) / 4 * 4; }

struct BwdScratch {
  size_t d, relk, relg, dek_part, dev_part, total;
};

BwdScratch bwd_scratch(int B, int T, int C, int dk, int window) {
  const size_t rows = (size_t)B * (C / dk) * T, nb = 2 * window + 1;
  const size_t nblk = (size_t)B * (C / dk) * ((T + ROWS - 1) / ROWS);
  BwdScratch s;
  size_t at = 0;
  s.d = at;         at += round4(rows);            // D_i = sum_j dp_ij p_ij
  s.relk = at;      at += round4(rows * nb);       // scale q_i . emb_rel_k[m]
  s.relg = at;      at += round4(rows * nb);       // g_i . emb_rel_v[m]
  s.dek_part = at;  at += round4(nblk * nb * dk);  // per-block emb partials
  s.dev_part = at;  at += round4(nblk * nb * dk);
  s.total = at;
  return s;
}

size_t rows_smem(int dk, int window) {
  const size_t ld = ld_of(dk), nb = 2 * window + 1;
  return (2 * ROWS + 2 * KT) * ld * 2 +
         (2 * nb * dk + 4 * ROWS * nb + KS * ROWS) * 4;
}

size_t cols_smem(int dk, int window) {
  const size_t ld = ld_of(dk), nb = 2 * window + 1;
  return (2 * ROWS + 2 * KT) * ld * 2 + (2 * KT * nb + 3 * KT) * 4;
}

// the float32 p, the dropped p rounded to bf16, dp and the keep decision of
// pair (i, j), from the masked score x, dP's dense term plus band dd, and
// the row's max, sum (the softmax of K1) and dropout key
struct Pair {
  float p, pdc, dp;
};
__device__ __forceinline__ Pair pair(float x, float dd, float m, float l,
                                     const Drop& drop, uint32_t rk, int j) {
  Pair r;
  r.p = expf(x - m) / l;
  float pd = r.p;
  r.dp = dd;
  if (drop.on) {
    const bool keep = keep_bits(rk, j) >= drop.thr;
    pd = keep ? pd * drop.keep_scale : 0.f;
    r.dp = keep ? dd * drop.keep_scale : 0.f;
  }
  r.pdc = round_bf16(pd);
  return r;
}

// this block's [ROWS][dk] partials of the KS warps (acc in mma layout)
// summed in a fixed order into sum(r, col); buf holds KS * ROWS * dk floats
__device__ __forceinline__ void stash_partial(float* buf, int ks,
                                              const float (&acc)[MAXN][4],
                                              int dk) {
  const int g = tf32x3::lane_g(), c = tf32x3::lane_c(), n_dk = dk / 8;
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n >= n_dk) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      buf[(ks * ROWS + g + 8 * (e >> 1)) * dk + 8 * n + 2 * c + (e & 1)] =
          acc[n][e];
  }
}

__device__ __forceinline__ float sum_partials(const float* buf, int r,
                                              int col, int dk) {
  float s = 0.f;
  for (int w = 0; w < KS; ++w) s += buf[(w * ROWS + r) * dk + col];
  return s;
}

// K3 row pass: one block per (16 query rows, head, item), warp ks taking
// keys [16 ks, 16 ks + 16) of every tile of 64.  The band biases (kept for
// the column pass), D_i, then dS over the keys: dq and each block's band
// partials of d emb_rel_k and d emb_rel_v.
__global__ void __launch_bounds__(NT)
rel_attention_bf16_bwd_rows_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g_in,
    const float* __restrict__ ek, const float* __restrict__ ev,
    const int* __restrict__ lengths, const float* __restrict__ stats,
    Drop drop, bf16* __restrict__ dq, float* __restrict__ dbuf,
    float* __restrict__ relk, float* __restrict__ relg,
    float* __restrict__ dek_part, float* __restrict__ dev_part, int T, int C,
    int dk, int window, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, bh = b * H + h;
  const int q0 = blockIdx.x * ROWS;
  const int len = max(0, min(lengths[b], T));
  const int ld = ld_of(dk), nb = 2 * window + 1, nk16 = dk_pad(dk) / 16;
  const int n_dk = dk / 8;
  bf16* Qs = (bf16*)smem_raw;            // [ROWS][ld]
  bf16* Gs = Qs + ROWS * ld;             // [ROWS][ld]
  bf16* Ks = Gs + ROWS * ld;             // [KT][ld]; then the dq partials
  bf16* Vs = Ks + KT * ld;               // [KT][ld]
  float* Eks = (float*)(Vs + KT * ld);   // [nb][dk]
  float* Evs = Eks + nb * dk;            // [nb][dk]
  float* RelK = Evs + nb * dk;           // [ROWS][nb]
  float* RelG = RelK + ROWS * nb;        // [ROWS][nb]
  float* BandS = RelG + ROWS * nb;       // [ROWS][nb] band(dS)
  float* BandP = BandS + ROWS * nb;      // [ROWS][nb] band(rounded pd)
  float* Dp = BandP + ROWS * nb;         // [KS][ROWS] each warp's share of D
  const size_t head = (size_t)b * T * C + (size_t)h * dk;
  const size_t row0 = (size_t)bh * T;

  load_tile(Qs, ld, q + head, q0, ROWS, T, C, dk);
  load_tile(Gs, ld, g_in + head, q0, ROWS, T, C, dk);
  for (int idx = threadIdx.x; idx < nb * dk; idx += NT) {
    Eks[idx] = ek[idx];
    Evs[idx] = ev[idx];
  }
  for (int idx = threadIdx.x; idx < ROWS * nb; idx += NT)
    BandS[idx] = BandP[idx] = 0.f;
  __syncthreads();
  band_dots(RelK, Qs, ld, Eks, dk, nb, scale);
  band_dots(RelG, Gs, ld, Evs, dk, nb, 1.f);
  __syncthreads();
  for (int idx = threadIdx.x; idx < ROWS * nb; idx += NT) {
    const int i = q0 + idx / nb;
    if (i < T) {
      relk[(row0 + i) * nb + idx % nb] = RelK[idx];
      relg[(row0 + i) * nb + idx % nb] = RelG[idx];
    }
  }

  const int ks = threadIdx.x >> 5, g = tf32x3::lane_g(),
            c = tf32x3::lane_c();
  const int kend = q0 + ROWS <= len ? len : T;
  const int n_tiles = (kend + KT - 1) / KT;
  const uint32_t seed = drop.on ? (uint32_t)*drop.seed : 0u;
  uint32_t rk[2];
  float m_row[2], l_row[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = q0 + g + 8 * rr;
    rk[rr] = drop.on ? row_key(seed, bh, i) : 0u;
    m_row[rr] = i < T ? stats[(row0 + i) * 2] : 0.f;
    l_row[rr] = i < T ? stats[(row0 + i) * 2 + 1] : 1.f;
  }

  // p, pdc and dp of this thread's pairs with this warp's 16 keys from j0
  auto pairs = [&](int j0, const bf16* Kw, const bf16* Vw,
                   Pair (&pr)[2][4]) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float s[4], dd[4];
      tile_dot(s, Qs, Kw + 8 * n * ld, ld, nk16);
      tile_dot(dd, Gs, Vw + 8 * n * ld, ld, nk16);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), i = q0 + r, rr = e >> 1;
        const int j = j0 + 8 * n + 2 * c + (e & 1), off = j - i;
        float x = s[e] * scale, d = dd[e];
        if (off >= -window && off <= window) {
          x += RelK[r * nb + off + window];
          d += RelG[r * nb + off + window];
        }
        if (i >= len || j >= len) x = MASK_VAL;
        if (j >= T || i >= T) {
          pr[n][e] = Pair{0.f, 0.f, 0.f};
        } else {
          pr[n][e] = pair(x, d, m_row[rr], l_row[rr], drop, rk[rr], j);
        }
      }
    }
  };

  // pass 1: D_i = sum_j dp_ij p_ij, each warp over its keys, then summed
  // over the warps in a fixed order
  float dsum[2] = {0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile(Ks, ld, k + head, t * KT, KT, T, C, dk);
    load_tile(Vs, ld, v + head, t * KT, KT, T, C, dk);
    __syncthreads();
    const int j0 = t * KT + 16 * ks;
    if (j0 >= kend) continue;            // warp-uniform
    Pair pr[2][4];
    pairs(j0, Ks + 16 * ks * ld, Vs + 16 * ks * ld, pr);
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dsum[e >> 1] = fmaf(pr[n][e].dp, pr[n][e].p, dsum[e >> 1]);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 1);
    dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 2);
    if (c == 0) Dp[ks * ROWS + g + 8 * rr] = dsum[rr];
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = g + 8 * rr;
    float d = 0.f;
    for (int w = 0; w < KS; ++w) d += Dp[w * ROWS + r];
    dsum[rr] = d;
    if (ks == 0 && c == 0 && q0 + r < T) dbuf[row0 + q0 + r] = d;
  }

  // pass 2: dS = p (dp - D), zero where the row or the key is masked; this
  // warp's share of dq = dS K
  float acc[MAXN][4];
#pragma unroll
  for (int n = 0; n < MAXN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_tile(Ks, ld, k + head, t * KT, KT, T, C, dk);
    load_tile(Vs, ld, v + head, t * KT, KT, T, C, dk);
    __syncthreads();
    const int j0 = t * KT + 16 * ks;
    if (j0 >= kend) continue;            // warp-uniform
    const bf16* Kw = Ks + 16 * ks * ld;
    Pair pr[2][4];
    pairs(j0, Kw, Vs + 16 * ks * ld, pr);
    float ds[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g + 8 * (e >> 1), i = q0 + r;
        const int j = j0 + 8 * n + 2 * c + (e & 1), off = j - i;
        float d = pr[n][e].p * (pr[n][e].dp - dsum[e >> 1]);
        if (i >= len || j >= len) d = 0.f;
        ds[n][e] = d;
        if (off >= -window && off <= window && j < T && i < T) {
          BandS[r * nb + off + window] = d;
          BandP[r * nb + off + window] = pr[n][e].pdc;
        }
      }
#pragma unroll
    for (int k8 = 0; k8 < 2; ++k8) {
      const SplitA xa = split_acc(ds[k8]);
#pragma unroll
      for (int n = 0; n < MAXN; ++n)
        if (n < n_dk) mma_xb(acc[n], xa, Kw + 8 * k8 * ld + 8 * n, ld);
    }
  }
  __syncthreads();  // the K/V tiles are free; every band entry stashed
  float* part = (float*)Ks;              // [KS][ROWS][dk]
  stash_partial(part, ks, acc, dk);
  __syncthreads();

  // dq = scale (dS K + band(dS) emb_rel_k), in bf16
  for (int idx = threadIdx.x; idx < ROWS * dk / 2; idx += NT) {
    const int r = idx / (dk / 2), col = idx % (dk / 2) * 2, i = q0 + r;
    if (i >= T) continue;
    float val[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float bsum = 0.f;
      for (int m = 0; m < nb; ++m)
        bsum = fmaf(BandS[r * nb + m], Eks[m * dk + col + u], bsum);
      val[u] = sum_partials(part, r, col + u, dk) * scale + bsum * scale;
    }
    *(__nv_bfloat162*)(dq + head + (size_t)i * C + col) =
        __floats2bfloat162_rn(val[0], val[1]);
  }
  // this block's emb partials: band(dS)^T q scale and band(pd)^T g
  const size_t blk = ((size_t)bh * gridDim.x + blockIdx.x) * nb * dk;
  for (int idx = threadIdx.x; idx < nb * dk; idx += NT) {
    const int m = idx / dk, d = idx % dk;
    float sk = 0.f, sv = 0.f;
    for (int r = 0; r < ROWS; ++r) {
      sk = fmaf(BandS[r * nb + m], bf(Qs[r * ld + d]), sk);
      sv = fmaf(BandP[r * nb + m], bf(Gs[r * ld + d]), sv);
    }
    dek_part[blk + idx] = sk * scale;
    dev_part[blk + idx] = sv;
  }
}

// K3 column pass: one block per (16 keys, head, item), looping over the
// query rows in tiles of 64, warp ks taking rows [16 ks, 16 ks + 16) of
// each: dk = scale dS^T Q and dv = pd^T G (pd rounded to bf16), the warps'
// shares summed in a fixed order, in bf16.
__global__ void __launch_bounds__(NT)
rel_attention_bf16_bwd_cols_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g_in,
    const int* __restrict__ lengths, const float* __restrict__ stats,
    const float* __restrict__ dbuf, const float* __restrict__ relk,
    const float* __restrict__ relg, Drop drop, bf16* __restrict__ dk_out,
    bf16* __restrict__ dv_out, int T, int C, int dk, int window,
    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int h = blockIdx.y, b = blockIdx.z, H = gridDim.y, bh = b * H + h;
  const int k0 = blockIdx.x * ROWS;
  const int len = max(0, min(lengths[b], T));
  const int ld = ld_of(dk), nb = 2 * window + 1, nk16 = dk_pad(dk) / 16;
  const int n_dk = dk / 8;
  bf16* Kb = (bf16*)smem_raw;            // [ROWS][ld] this block's keys
  bf16* Vb = Kb + ROWS * ld;             // [ROWS][ld]
  bf16* Qs = Vb + ROWS * ld;             // [KT][ld] a tile of query rows;
  bf16* Gs = Qs + KT * ld;               // [KT][ld]  then the partials
  float* RelK = (float*)(Gs + KT * ld);  // [KT][nb]
  float* RelG = RelK + KT * nb;          // [KT][nb]
  float* Ms = RelG + KT * nb;            // [KT] row max
  float* Ls = Ms + KT;                   // [KT] row sum
  float* Ds = Ls + KT;                   // [KT] D_i
  const size_t head = (size_t)b * T * C + (size_t)h * dk;
  const size_t row0 = (size_t)bh * T;

  load_tile(Kb, ld, k + head, k0, ROWS, T, C, dk);
  load_tile(Vb, ld, v + head, k0, ROWS, T, C, dk);

  const int ks = threadIdx.x >> 5, g = tf32x3::lane_g(),
            c = tf32x3::lane_c();
  const uint32_t seed = drop.on ? (uint32_t)*drop.seed : 0u;
  float acc_k[MAXN][4], acc_v[MAXN][4];
#pragma unroll
  for (int n = 0; n < MAXN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int i0 = 0; i0 < T; i0 += KT) {
    __syncthreads();
    load_tile(Qs, ld, q + head, i0, KT, T, C, dk);
    load_tile(Gs, ld, g_in + head, i0, KT, T, C, dk);
    for (int idx = threadIdx.x; idx < KT * nb; idx += NT) {
      const int i = i0 + idx / nb;
      RelK[idx] = i < T ? relk[(row0 + i) * nb + idx % nb] : 0.f;
      RelG[idx] = i < T ? relg[(row0 + i) * nb + idx % nb] : 0.f;
    }
    for (int r = threadIdx.x; r < KT; r += NT) {
      const int i = i0 + r;
      Ms[r] = i < T ? stats[(row0 + i) * 2] : 0.f;
      Ls[r] = i < T ? stats[(row0 + i) * 2 + 1] : 1.f;
      Ds[r] = i < T ? dbuf[row0 + i] : 0.f;
    }
    __syncthreads();
    if (i0 + 16 * ks >= T) continue;     // warp-uniform
    const bf16* Qw = Qs + 16 * ks * ld;
    const bf16* Gw = Gs + 16 * ks * ld;
    // S^T and dP^T: rows are the block's keys, columns this warp's rows
    float pt[2][4], st[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      float s[4], dd[4];
      tile_dot(s, Kb, Qw + 8 * n * ld, ld, nk16);
      tile_dot(dd, Vb, Gw + 8 * n * ld, ld, nk16);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = k0 + g + 8 * (e >> 1);
        const int il = 16 * ks + 8 * n + 2 * c + (e & 1);
        const int i = i0 + il, off = j - i;
        float x = s[e] * scale, d = dd[e];
        if (off >= -window && off <= window) {
          x += RelK[il * nb + off + window];
          d += RelG[il * nb + off + window];
        }
        if (i >= len || j >= len) x = MASK_VAL;
        if (i >= T || j >= T) {
          pt[n][e] = st[n][e] = 0.f;
          continue;
        }
        const uint32_t rk = drop.on ? row_key(seed, bh, i) : 0u;
        const Pair pr = pair(x, d, Ms[il], Ls[il], drop, rk, j);
        pt[n][e] = pr.pdc;
        st[n][e] = i >= len || j >= len ? 0.f : pr.p * (pr.dp - Ds[il]);
      }
    }
    // dv += pd^T G (bf16 exact), dk += dS^T Q (TF32, Q exact)
#pragma unroll
    for (int n = 0; n < MAXN; ++n)
      if (n < n_dk) mma_pb(acc_v[n], pt[0], pt[1], Gw + 8 * n, ld);
#pragma unroll
    for (int k8 = 0; k8 < 2; ++k8) {
      const SplitA xa = split_acc(st[k8]);
#pragma unroll
      for (int n = 0; n < MAXN; ++n)
        if (n < n_dk) mma_xb(acc_k[n], xa, Qw + 8 * k8 * ld + 8 * n, ld);
    }
  }

  // the warps' shares summed in a fixed order: dk, then dv
  float* part = (float*)Qs;              // [KS][ROWS][dk]
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
    if (which)
      stash_partial(part, ks, acc_v, dk);
    else
      stash_partial(part, ks, acc_k, dk);
    __syncthreads();
    bf16* dst = which ? dv_out : dk_out;
    const float mul = which ? 1.f : scale;
    for (int idx = threadIdx.x; idx < ROWS * dk / 2; idx += NT) {
      const int r = idx / (dk / 2), col = idx % (dk / 2) * 2, j = k0 + r;
      if (j >= T) continue;
      *(__nv_bfloat162*)(dst + head + (size_t)j * C + col) =
          __floats2bfloat162_rn(sum_partials(part, r, col, dk) * mul,
                                sum_partials(part, r, col + 1, dk) * mul);
    }
  }
}

// out[i] = sum over blocks of part[blk][i], in block order
__global__ void sum_partials_kernel(const float* __restrict__ part, int nblk,
                                    int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int blk = 0; blk < nblk; ++blk) s += part[(size_t)blk * n + i];
  out[i] = s;
}

bool bad_args(int B, int T, int C, int dk, int window) {
  return dk <= 0 || dk > MAX_DK || dk % 8 != 0 || C % dk != 0 || window < 0 ||
         T <= 0 || B <= 0;
}

Drop make_drop(const int* seed, unsigned thr, float keep_scale, int on) {
  Drop d;
  d.seed = seed;
  d.thr = thr;
  d.keep_scale = keep_scale;
  d.on = on;
  return d;
}

}  // namespace

extern "C" int rel_attention_bf16_fwd(
    const bf16* q, const bf16* k, const bf16* v, const float* emb_rel_k,
    const float* emb_rel_v, const int* lengths, const int* seed, unsigned thr,
    float keep_scale, int drop, bf16* out, float* stats, int B, int T, int C,
    int dk, int window, float scale, cudaStream_t stream) {
  if (bad_args(B, T, C, dk, window) || (drop && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(dk, window);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_bf16_fwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + ROWS - 1) / ROWS, C / dk, B);
  rel_attention_bf16_fwd_kernel<<<grid, NT, smem, stream>>>(
      q, k, v, emb_rel_k, emb_rel_v, lengths, out, stats,
      make_drop(seed, thr, keep_scale, drop), T, C, dk, window, scale);
  return (int)cudaGetLastError();
}

// Floats of scratch one backward call needs, or -1 if the backward does not
// take these sizes.
extern "C" long long rel_attention_bf16_bwd_scratch(int B, int T, int C,
                                                    int dk, int window) {
  if (bad_args(B, T, C, dk, window)) return -1;
  return (long long)bwd_scratch(B, T, C, dk, window).total;
}

extern "C" int rel_attention_bf16_bwd(
    const bf16* q, const bf16* k, const bf16* v, const float* emb_rel_k,
    const float* emb_rel_v, const int* lengths, const int* seed, unsigned thr,
    float keep_scale, int drop, const bf16* g, const float* stats, bf16* dq,
    bf16* dk_out, bf16* dv_out, float* d_emb_rel_k, float* d_emb_rel_v,
    float* scratch, int B, int T, int C, int dk, int window, float scale,
    cudaStream_t stream) {
  if (bad_args(B, T, C, dk, window) || (drop && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const int H = C / dk, nb = 2 * window + 1;
  const Drop dr = make_drop(seed, thr, keep_scale, drop);
  const BwdScratch s = bwd_scratch(B, T, C, dk, window);
  const size_t smem_r = rows_smem(dk, window), smem_c = cols_smem(dk, window);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_bf16_bwd_rows_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_r);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rel_attention_bf16_bwd_cols_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T + ROWS - 1) / ROWS;
  const dim3 grid(n_tiles, H, B);
  rel_attention_bf16_bwd_rows_kernel<<<grid, NT, smem_r, stream>>>(
      q, k, v, g, emb_rel_k, emb_rel_v, lengths, stats, dr, dq,
      scratch + s.d, scratch + s.relk, scratch + s.relg,
      scratch + s.dek_part, scratch + s.dev_part, T, C, dk, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_attention_bf16_bwd_cols_kernel<<<grid, NT, smem_c, stream>>>(
      q, k, v, g, lengths, stats, scratch + s.d, scratch + s.relk,
      scratch + s.relg, dr, dk_out, dv_out, T, C, dk, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = nb * dk, nblk = B * H * n_tiles;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      scratch + s.dek_part, nblk, n, d_emb_rel_k);
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      scratch + s.dev_part, nblk, n, d_emb_rel_v);
  return (int)cudaGetLastError();
}

// Registers, dynamic shared memory and resident blocks per SM of kernel i
// (0 K1-bf16, 1 K3-bf16 row pass, 2 K3-bf16 column pass, 3 emb sum) at head
// width dk and window; its name into name[0:n).  Returns a cudaError_t, or
// -1 past the end.
extern "C" int rel_attention_bf16_info(int i, int dk, int window, char* name,
                                       int n, int* regs, int* smem,
                                       int* blocks) {
  switch (i) {
    case 0:
      return tf32x3::kernel_info((const void*)rel_attention_bf16_fwd_kernel,
                                 "rel_attention_bf16_fwd_kernel", NT,
                                 fwd_smem(dk, window), name, n, regs, smem,
                                 blocks);
    case 1:
      return tf32x3::kernel_info(
          (const void*)rel_attention_bf16_bwd_rows_kernel,
          "rel_attention_bf16_bwd_rows_kernel", NT, rows_smem(dk, window),
          name, n, regs, smem, blocks);
    case 2:
      return tf32x3::kernel_info(
          (const void*)rel_attention_bf16_bwd_cols_kernel,
          "rel_attention_bf16_bwd_cols_kernel", NT, cols_smem(dk, window),
          name, n, regs, smem, blocks);
    case 3:
      return tf32x3::kernel_info((const void*)sum_partials_kernel,
                                 "sum_partials_kernel", 256, 0, name, n, regs,
                                 smem, blocks);
    default:
      return -1;
  }
}
