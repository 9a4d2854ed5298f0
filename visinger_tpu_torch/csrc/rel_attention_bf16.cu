// K1 and K3 in bfloat16: the relative-position attention forward and
// backward for bf16 q, k, v (the bf16 compute recipes), for sm_90a.
//
// They compute what visinger_tpu/ops/pallas/attention_kernel.py's
// _attn_fwd_kernel and _attn_bwd_kernel compute when q, k and v are bf16,
// with the rounding points of that kernel:
//   forward:  S = Q K^T accumulated in float32; the band bias from the
//             float32 emb_rel_k (q is exact in float32); softmax and dropout
//             in float32; P rounded to bf16 after it is normalised (:137);
//             out = P V + band(P) emb_rel_v accumulated in float32 (:141-143)
//             and written in bf16 (:145).  Each row's max and sum are saved
//             in float32, as the float32 build (rel_attention.cu) saves them.
//   backward: g in bf16 (:280); p in float32 from the saved max and sum; the
//             dropped P rounded to bf16 (:176) for dv and d emb_rel_v;
//             D_i = sum_j dp_ij p_ij over the float32 p (:201); dS and every
//             other product in float32; dq, dk, dv written in bf16 (:284),
//             d emb_rel_k/v in float32.
// The math, the mask (-1e4 at a pair whose query or key is at or past len,
// not -inf) and the dropout hash are those of rel_attention.cu's note.
//
// What bounds them.  At [4, 640, 192] (T <= 1280, dk = 96, 2 heads in the
// model) the forward needs 0.9 GFLOP and 3.6 MB (bf16 q, k, v, out): 1.1
// us at 3.35 TB/s, just above its 0.9 us at the bf16 dense tensor-core
// rate; the backward 2.2 GFLOP and 7.2 MB: 2.3 us, bound by operations.
// What a kernel really waits on at these sizes is latency: the trip of
// every K/V tile from L2, the barriers around it, the softmax's exp and
// divisions, and the launches.  The design answers each:
//
// Products.  Every product runs on the tensor cores as bf16 mma.sync
// m16n8k16 with float32 accumulation, its fragments read from shared memory
// by ldmatrix (.trans for the operands stored k-major: V in P V, Q and G in
// dK and dV, K in dS K).  A bf16 x bf16 product is exact in float32, so
// Q K^T, G V^T, P V and P^T G are one mma per k-step.  dS K and dS^T Q have
// the float32 operand dS: it is split into three bf16 pieces (hi, mid, lo;
// 8 + 8 + 8 significand bits carry a float32 exactly down to 2^-110, near
// float32's underflow), three mma per k-step.  The products accumulate
// inside the mma across k-steps: the tensor core truncates its running sum
// (rel_attention.cu's 3xTF32 starts every k-step from zero for that), which
// costs ~2^-23 of a partial sum a step, far inside the bf16 limits (one
// bf16 ulp of the peak, and 1e-5 on the row statistics).
//
// K1-bf16: one Q K^T per (row, key) pair.  P must be normalised before it
// is rounded, so it cannot be rounded inside an online softmax.  A block
// owns (16 RG query rows, head, item) and RG x 8 warps: RG row groups of 16
// rows times 8 key splits, split s taking keys [16 s, 16 s + 16) of every
// 128-key tile.  32-row tiles (16 warps) unless they would leave SMs idle
// or not fit; then 16-row tiles (8 warps).  Three steps over the keys:
//   (A) K tiles by cp.async, double-buffered, one barrier a tile: the
//       masked scores (bias, mask) go to a score buffer, each thread's own
//       entries in its own slots (16-byte stores, no bank conflicts, no
//       barrier), and each thread keeps its rows' running max;
//   (B) the row max merged over the splits; each thread turns its scores
//       into e = exp(s - max) in place and sums them; the sums merged over
//       the splits in a fixed order (split 0 first);
//   (C) V tiles by cp.async, double-buffered (the first issued during (B)):
//       P = e / sum, dropped, rounded to bf16, packed from the accumulator
//       layout straight into P's A fragment, times V.
// The score buffer takes 16 RG rows x T keys (rounded up to a tile) of
// shared memory: 80 KB at [*, 640] with 32 rows and at [*, 1280] with 16;
// the row count is taken from T before the launch.  A T too long for even
// 16 rows (past 2,560 keys at dk = 96) takes the same kernel with the
// buffer in a global scratch (each thread still reads only its own slots),
// also chosen before the launch.  The splits' O partials are summed in a fixed order,
// then the band term.  The key loop stops at each item's length for tiles
// of valid rows (a key at or past len weighs exp(-1e4 - max) = 0); a tile
// of masked rows without dropout takes the closed form p = 1/T rounded to
// bf16: out = bf16(1/T) (sum_j v_j + the band keys' emb_rel_v), no Q K^T;
// with dropout P V alone.  Tiles are taken longest first (straddling len,
// valid, masked; items by length), as in rel_attention.cu.  The head width
// is a template constant for the model's dk = 96; a generic build takes
// any multiple of 8 up to 128.
//
// K3-bf16: S and dP twice per pair, not three times.  Four launches:
//   (R) row pass, per (32 query rows, head, item), 8 warps (2 row groups x
//       4 key splits of 64-key tiles, K and V double-buffered): S and dP
//       for the valid pairs, D_i = sum_j dp_ij p_ij (fixed-order merge of
//       the splits), the band biases scale q_i . emb_rel_k and
//       g_i . emb_rel_v, the band tables of dS and of the rounded dropped
//       P (masked rows: p = 1/T), and the block's emb partials;
//   (C) key pass, per (32 keys, head, item), 8 warps, looping over 64-row
//       query tiles (Q, G and the row data double-buffered by cp.async):
//       S^T = K Q^T and dP^T = V G^T (keys as rows, so each warp's 16 x 16
//       tiles need no transpose), p from K1's saved max and sum, dS; dS
//       goes to a float32 [B, H, T, T] scratch (13 MB at [4, 640, 192],
//       L2-resident) and, with the rounded P, to bf16 planes in shared
//       memory, from which dV += P^T G and dK += dS^T Q accumulate in
//       registers (each warp 16 keys x a quarter of dk);
//   (Q) dq pass, per (32 query rows, head, item): dq = scale (dS K +
//       band(dS) emb_rel_k), dS and K tiles double-buffered, over the keys
//       below len (rows at or past len: dq = 0);
//   (S) the emb partials summed in a fixed order.
// Work the data does not need is skipped: S, dP, dS and dK only where
// i < len and j < len; a key block at or past len meets only the masked
// rows (dV alone).  No atomics: every output element has one writer and
// every sum a fixed order, so a rerun gives the same bits.  Every K3-bf16
// kernel runs 8 warps at 2 blocks an SM, so at most 128 registers a thread.
// Head width: a multiple of 8, at most 128 (tiles zero-padded to 16).
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py and
// tools/kernel_ab.py, device time at [4, 640, 192], dropout off): K1-bf16
// 0.042 ms, of which a grid whose blocks return after choosing their tile
// takes 0.008 and exp and the division 0.004; K3-bf16 0.138 ms: row pass
// 0.046, key pass 0.058, dq pass 0.020, emb sum 0.006, of which exp and
// division 0.015 and the emb partials 0.003.  The rest is the latency of
// the tile trips and barriers: ~40x and ~60x the bounds above.  At dk = 96,
// window 4 (-Xptxas -v, cudaOccupancy): K1-bf16 104 registers, 32-row
// tiles 177,664 B of shared memory at T = 640 with one block (16 warps) an
// SM, 16-row tiles 147,584 B at T = 1280 (8 warps); K3-bf16 row pass 82
// registers and 79,872 B, key pass 124 and 95,744 B, dq pass 90 and
// 49,664 B, each 2 blocks an SM; no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

typedef __nv_bfloat16 bf16;
using tf32x3::cp_async16;
using tf32x3::cp_async4;
using tf32x3::cp_async8;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int MAX_DK = 128;
constexpr float MASK_VAL = -1e4f;
constexpr uint32_t GOLD = 0x9E3779B9u;

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
// the 16-byte rows ldmatrix reads of 8 rows fall in distinct banks
__host__ __device__ __forceinline__ int ld_of(int dk) { return dk_pad(dk) + 8; }

__host__ __device__ __forceinline__ size_t r16(size_t bytes) {
  return (bytes + 15) / 16 * 16;
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// x rounded to bf16 and back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// two floats rounded to bf16 -> one register, the first in the low half
__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  return as_u32(__floats2bfloat162_rn(lo, hi));
}

// (x0, x1) = hi + mid + lo, three bf16 pairs; exact while |x| >= 2^-110
// (x - bf16(x) is exact in float32 and has at most 16 significant bits,
// its remainder at most 8)
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(a), r1 = x1 - __high2float(a);
  const __nv_bfloat162 b = __floats2bfloat162_rn(r0, r1);
  hi = as_u32(a);
  mid = as_u32(b);
  lo = pack_f(r0 - __low2float(b), r1 - __high2float(b));
}

// d += a * b, bf16 operands, float32 accumulator.  With g = lane / 4 and
// c = lane % 4 a thread holds
//   A (16x16): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..), a3 (g+8, 2c+8..)
//   B (16x8):  b0 (k 2c..2c+1, n g), b1 (k 2c+8..2c+9, n g)
//   D (16x8):  d0 (g, 2c), d1 (g, 2c+1), d2 (g+8, 2c), d3 (g+8, 2c+1)
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm2_t(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// A fragment of a 16x16 tile stored A[m][k] at s[m * ld + k]
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int ld) {
  const int l = threadIdx.x & 31;
  ldsm4(a, s + (l & 15) * ld + (l >> 4) * 8);
}
// B fragments of two n8 tiles (n 0-7 in b[0..1], 8-15 in b[2..3]) over one
// k16 step, stored n-major: B[k][n] at s[n * ld + k] (keys as rows)
__device__ __forceinline__ void frag_b2_n(uint32_t (&b)[4], const bf16* s,
                                          int ld) {
  const int l = threadIdx.x & 31;
  ldsm4(b, s + ((l & 7) + ((l >> 4) << 3)) * ld + ((l >> 3) & 1) * 8);
}
// the same stored k-major: B[k][n] at s[k * ld + n]
__device__ __forceinline__ void frag_b2_k(uint32_t (&b)[4], const bf16* s,
                                          int ld) {
  const int l = threadIdx.x & 31;
  ldsm4_t(b, s + ((l & 7) + (((l >> 3) & 1) << 3)) * ld + (l >> 4) * 8);
}
// one n8 tile stored k-major
__device__ __forceinline__ void frag_b1_k(uint32_t (&b)[2], const bf16* s,
                                          int ld) {
  const int l = threadIdx.x & 31;
  ldsm2_t(b, s + ((l & 7) + (((l >> 3) & 1) << 3)) * ld);
}

// rows [r0, r0 + n) of one head of a [B, T, C] bf16 tensor (src at the
// head's first channel of the item) -> an [n][ld] tile by cp.async, zero
// past T and in the columns [dk, dk_pad)
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          int r0, int n, int T, int C,
                                          int dk) {
  const int vec = dk_pad(dk) / 8;
  for (int idx = threadIdx.x; idx < n * vec; idx += blockDim.x) {
    const int r = idx / vec, c8 = idx % vec, t = r0 + r;
    const bool in = t < T && c8 * 8 < dk;
    cp_async16((float*)(dst + r * ld + c8 * 8),
               (const float*)(src + (in ? (size_t)t * C + c8 * 8 : 0)), in);
  }
}

// row . table for a bf16 row and a float32 table row of dk entries
__device__ __forceinline__ float dot_bf(const bf16* row, const float* e,
                                        int dk) {
  float s[2] = {0.f, 0.f};
  for (int d = 0; d < dk; d += 2) {
    const float2 x = __bfloat1622float2(*(const __nv_bfloat162*)(row + d));
    s[0] = fmaf(x.x, e[d], s[0]);
    s[1] = fmaf(x.y, e[d + 1], s[1]);
  }
  return s[0] + s[1];
}

__device__ __forceinline__ int item_len(const int* lengths, int b, int T) {
  return max(0, min(lengths[b], T));
}

// ---- K1-bf16 -------------------------------------------------------------

template <int RG, int KS>
struct K1Tile {
  static constexpr int ROWS = 16 * RG;  // query rows per block
  static constexpr int NW = RG * KS;    // warps
  static constexpr int NT = 32 * NW;    // threads
  static constexpr int KT = 16 * KS;    // keys per tile, 16 a split
};

// keys of the score buffer: T rounded up to a whole tile
template <int RG, int KS>
__host__ __device__ __forceinline__ size_t k1_kcap(int T) {
  return (size_t)(T + K1Tile<RG, KS>::KT - 1) / K1Tile<RG, KS>::KT *
         K1Tile<RG, KS>::KT;
}

// K1-bf16's dynamic shared memory, offsets in bytes
struct K1Smem {
  size_t kv, q, big, ek, ev, rel, band, red, total;
};

// scr: the score buffer lives in a global scratch, and `big` holds only the
// splits' O partials and the closed form's column sums (otherwise also the
// scores)
template <int RG, int KS>
__host__ __device__ K1Smem k1_smem(int T, int dk, int window, bool scr) {
  using S = K1Tile<RG, KS>;
  const size_t ld = ld_of(dk), nb = 2 * window + 1;
  const size_t opart = (size_t)S::NW * 16 * (dk + 8);
  const size_t colsum = (size_t)S::NT / (dk / 8) * dk + dk;
  const size_t scores = scr ? 0 : (size_t)S::ROWS * k1_kcap<RG, KS>(T);
  size_t big = opart > scores ? opart : scores;
  if (big < colsum) big = colsum;
  K1Smem s;
  size_t at = 0;
  s.kv = at;   at += r16(2 * S::KT * ld * 2);   // K, then V, x 2 buffers
  s.q = at;    at += r16(S::ROWS * ld * 2);
  s.big = at;  at += r16(big * 4);
  s.ek = at;   at += r16(nb * dk * 4);
  s.ev = at;   at += r16(nb * dk * 4);
  s.rel = at;  at += r16(S::ROWS * nb * 4);     // scale q . emb_rel_k
  s.band = at; at += r16(S::ROWS * nb * 4);     // the rounded band P
  s.red = at;  at += r16(2 * S::NW * 16 * 4);   // each split's row max, sum
  s.total = at;
  return s;
}

// K1-bf16 on a tile whose rows are all at or past len, without dropout:
// every score is -1e4, so p = 1/T at each of the T keys, rounded to bf16:
// out = bf16(1/T) sum_j v_j + bf16(1/T) sum of emb_rel_v over the band keys
// inside [0, T); max -1e4, sum T.  part: phases x dk + dk floats.
template <int NT>
__device__ void k1_masked_tile(float* part, const bf16* __restrict__ v,
                               const float* __restrict__ ev,
                               bf16* __restrict__ out,
                               float* __restrict__ stats, size_t head,
                               size_t row0, int q0, int rows, int T, int C,
                               int dk, int window) {
  // column sums of v: threads in row phases of dk / 8 16-byte columns each
  const int n8 = dk / 8, phases = NT / n8;
  float* vsum = part + phases * dk;
  const int c8 = threadIdx.x % n8, ph = threadIdx.x / n8;
  if (ph < phases) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = ph; j < T; j += phases) {
      const uint4 raw = *(const uint4*)(v + head + (size_t)j * C + 8 * c8);
      const __nv_bfloat162* e = (const __nv_bfloat162*)&raw;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 x = __bfloat1622float2(e[u]);
        acc[2 * u] += x.x;
        acc[2 * u + 1] += x.y;
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) part[ph * dk + 8 * c8 + u] = acc[u];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < dk; d += NT) {
    float s = 0.f;
    for (int p = 0; p < phases; ++p) s += part[p * dk + d];
    vsum[d] = s;
  }
  __syncthreads();
  const float pb = round_bf16(1.f / (float)T);
  for (int idx = threadIdx.x; idx < rows * (dk / 2); idx += NT) {
    const int r = idx / (dk / 2), col = idx % (dk / 2) * 2, i = q0 + r;
    if (i >= T) continue;
    float o0 = pb * vsum[col], o1 = pb * vsum[col + 1];
    for (int m = 0; m <= 2 * window; ++m) {
      const int j = i + m - window;
      if (j >= 0 && j < T) {
        o0 = fmaf(pb, ev[m * dk + col], o0);
        o1 = fmaf(pb, ev[m * dk + col + 1], o1);
      }
    }
    *(__nv_bfloat162*)(out + head + (size_t)i * C + col) =
        __floats2bfloat162_rn(o0, o1);
  }
  for (int r = threadIdx.x; r < rows; r += NT)
    if (q0 + r < T) {
      stats[(row0 + q0 + r) * 2] = MASK_VAL;
      stats[(row0 + q0 + r) * 2 + 1] = (float)T;
    }
}

// K1-bf16: one block per (16 RG query rows, head, item); see the note.
// DK: the head width fixed at compile time (96), or 0 for any dk the kernel
// takes (dk_arg).  SCR: the score buffer in `scratch` (a T too long for
// shared memory) instead of shared memory.
template <int RG, int KS, int DK, bool SCR>
__global__ void __launch_bounds__(K1Tile<RG, KS>::NT,
                                   512 / K1Tile<RG, KS>::NT)
rel_attention_bf16_fwd_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const float* __restrict__ ek,
                              const float* __restrict__ ev,
                              const int* __restrict__ lengths,
                              bf16* __restrict__ out,
                              float* __restrict__ stats,
                              float* __restrict__ scratch, Drop drop, int T,
                              int C, int dk_arg, int window, float scale) {
  using S = K1Tile<RG, KS>;
  constexpr int MAXN = DK ? DK / 8 : MAX_DK / 8;    // n8 tiles of O
  constexpr int MAXK = DK ? (DK + 15) / 16 : MAX_DK / 16;  // k16 steps
  const int dk = DK ? DK : dk_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  const K1Smem L = k1_smem<RG, KS>(T, dk, window, SCR);
  const int ld = ld_of(dk), nb = 2 * window + 1, n_dk = dk / 8;
  const int nk16 = dk_pad(dk) / 16, LO = dk + 8;
  bf16* KV = (bf16*)(smem + L.kv);       // [2][KT][ld]
  bf16* Qs = (bf16*)(smem + L.q);        // [ROWS][ld]
  float* Big = (float*)(smem + L.big);   // scores; then [NW][16][LO] O
  float* Eks = (float*)(smem + L.ek);    // [nb][dk]
  float* Evs = (float*)(smem + L.ev);    // [nb][dk]
  float* Rel = (float*)(smem + L.rel);   // [ROWS][nb]
  float* Band = (float*)(smem + L.band); // [ROWS][nb]
  float* RedM = (float*)(smem + L.red);  // [NW][16]
  float* RedL = RedM + S::NW * 16;       // [NW][16]

  // Which tile this block takes: the longest first (straddling len, then
  // valid, then masked; items by length, ties by index; tiles in order,
  // heads innermost), as in rel_attention.cu.  order[] lives in the K/V
  // buffers until the barrier.
  const int H = C / dk, nx = (T + S::ROWS - 1) / S::ROWS;
  const int B = gridDim.x / (nx * H);
  int* order = (int*)KV;
  for (int i = threadIdx.x; i < B; i += S::NT) {
    const int li = item_len(lengths, i, T);
    int rank = 0;
    for (int j = 0; j < B; ++j) {
      const int lj = item_len(lengths, j, T);
      rank += lj > li || (lj == li && j < i);
    }
    order[rank] = i;
  }
  __syncthreads();
  int id = blockIdx.x, b = 0, x = 0;
  for (int cls = 0, r = 0;; ++r) {
    if (r == B) r = 0, ++cls;
    b = order[r];
    const int lb = item_len(lengths, b, T);
    const int nv = lb / S::ROWS, ns = lb % S::ROWS != 0;
    const int n = (cls == 0 ? ns : cls == 1 ? nv : nx - nv - ns) * H;
    if (id < n) {
      x = (cls == 0 ? nv : cls == 1 ? 0 : nv + ns) + id / H;
      break;
    }
    id -= n;
  }
  const int q0 = x * S::ROWS, h = id % H, bh = b * H + h;
  __syncthreads();  // order[] read: the K/V buffers are free
  const int len = item_len(lengths, b, T);
  const size_t head = (size_t)b * T * C + (size_t)h * dk;
  const size_t row0 = (size_t)bh * T;
  const bool masked = q0 >= len;             // every row at or past len
  const bool valid = q0 + S::ROWS <= len;    // every row below len
  if (masked && !drop.on) {
    k1_masked_tile<S::NT>(Big, v, ev, out, stats, head, row0, q0, S::ROWS,
                          T, C, dk, window);
    return;
  }
  const int kend = valid ? len : T;          // the keys this tile visits
  const int n_tiles = (kend + S::KT - 1) / S::KT;
  float* Sb = SCR ? scratch + (size_t)blockIdx.x * S::ROWS *
                                  k1_kcap<RG, KS>(T)
                  : Big;
  const uint32_t seed = drop.on ? (uint32_t)*drop.seed : 0u;

  // a key tile wholly at or past len needs no Q K^T: every pair in it is
  // masked (a straddling tile's valid rows give it weight 0)
  auto needs_s = [&](int t) { return !masked && t * S::KT < len; };
  if (!masked) load_rows(Qs, ld, q + head, q0, S::ROWS, T, C, dk);
  if (needs_s(0)) load_rows(KV, ld, k + head, 0, S::KT, T, C, dk);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < nb * dk; idx += S::NT) {
    Eks[idx] = ek[idx];
    Evs[idx] = ev[idx];
  }
  for (int idx = threadIdx.x; idx < S::ROWS * nb; idx += S::NT)
    Band[idx] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  if (!masked)
    for (int idx = threadIdx.x; idx < S::ROWS * nb; idx += S::NT)
      Rel[idx] = dot_bf(Qs + idx / nb * ld, Eks + idx % nb * dk, dk) * scale;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp / KS, ks = warp % KS, g = lane >> 2, c = lane & 3;
  const int r_lo = 16 * rg + g;          // this thread's rows: r_lo, r_lo + 8
  const int rw = q0 + 16 * rg;           // the warp's first row
  uint32_t rk[2] = {0u, 0u};
  if (drop.on) {
    rk[0] = row_key(seed, bh, q0 + r_lo);
    rk[1] = row_key(seed, bh, q0 + r_lo + 8);
  }
  const bf16* Qw = Qs + 16 * rg * ld;
  // this thread's 8 scores of tile t: two float4 slots, 32 lanes apart
  auto slot = [&](int t) {
    return (float4*)Sb + ((size_t)t * S::NW + warp) * 64 + lane;
  };

  // (A) masked scores to the buffer, each thread's running row max
  float mx[2] = {-INFINITY, -INFINITY};
  for (int t = 0; t < n_tiles; ++t) {
    const bf16* Kt = KV + (t & 1) * S::KT * ld;
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles && needs_s(t + 1))
      load_rows(KV + ((t + 1) & 1) * S::KT * ld, ld, k + head,
                (t + 1) * S::KT, S::KT, T, C, dk);
    cp_async_commit();
    const int j0 = t * S::KT + 16 * ks;  // this split's 16 keys
    if (j0 >= kend) continue;            // warp-uniform
    const bool ns = needs_s(t);
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (ns) {
#pragma unroll
      for (int kk = 0; kk < MAXK; ++kk) {
        if (kk < nk16) {
          uint32_t a[4], bb[4];
          frag_a(a, Qw + 16 * kk, ld);
          frag_b2_n(bb, Kt + 16 * ks * ld + 16 * kk, ld);
          mma(s[0], a, bb[0], bb[1]);
          mma(s[1], a, bb[2], bb[3]);
        }
      }
    }
    const bool near = ns && j0 <= rw + 15 + window && j0 + 15 >= rw - window;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_lo + 8 * (e >> 1), i = q0 + r;
        const int j = j0 + 8 * n + 2 * c + (e & 1), off = j - i;
        float xe = MASK_VAL;
        if (ns && i < len && j < len) {
          xe = s[n][e] * scale;
          if (near && off >= -window && off <= window)
            xe += Rel[r * nb + off + window];
        }
        if (j >= T) xe = -INFINITY;      // keys past T do not exist
        s[n][e] = xe;
        mx[e >> 1] = fmaxf(mx[e >> 1], xe);
      }
    float4* sp = slot(t);
    sp[0] = make_float4(s[0][0], s[0][1], s[0][2], s[0][3]);
    sp[32] = make_float4(s[1][0], s[1][1], s[1][2], s[1][3]);
  }
  // the V tiles' ring starts in the buffer tile n_tiles - 2 used: every
  // warp is past the barrier of the last tile
  const int vb = n_tiles & 1;
  load_rows(KV + vb * S::KT * ld, ld, v + head, 0, S::KT, T, C, dk);
  cp_async_commit();

  // (B) row max over the splits; e = exp(s - max) in place; row sums
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    if (c == 0) RedM[warp * 16 + g + 8 * rr] = mx[rr];
  }
  __syncthreads();
  float m_row[2], l_row[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float m = -INFINITY;
    for (int sp = 0; sp < KS; ++sp)
      m = fmaxf(m, RedM[(rg * KS + sp) * 16 + g + 8 * rr]);
    m_row[rr] = m;  // finite: key 0 is in every row's range
  }
  float lsum[2] = {0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    if (t * S::KT + 16 * ks >= kend) continue;
    float4* sp = slot(t);
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float4 a = sp[32 * u];
      a.x = expf(a.x - m_row[0]);
      a.y = expf(a.y - m_row[0]);
      a.z = expf(a.z - m_row[1]);
      a.w = expf(a.w - m_row[1]);
      lsum[0] += a.x + a.y;
      lsum[1] += a.z + a.w;
      sp[32 * u] = a;
    }
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    lsum[rr] += __shfl_xor_sync(0xffffffffu, lsum[rr], 1);
    lsum[rr] += __shfl_xor_sync(0xffffffffu, lsum[rr], 2);
    if (c == 0) RedL[warp * 16 + g + 8 * rr] = lsum[rr];
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float l = 0.f;  // the splits' sums in a fixed order
    for (int sp = 0; sp < KS; ++sp) l += RedL[(rg * KS + sp) * 16 + g + 8 * rr];
    l_row[rr] = l;
    const int i = q0 + r_lo + 8 * rr;
    if (ks == 0 && c == 0 && i < T) {
      stats[(row0 + i) * 2] = m_row[rr];
      stats[(row0 + i) * 2 + 1] = l;
    }
  }

  // (C) P = e / sum, dropped, rounded to bf16; this split's share of P V
  float o[MAXN][4];
#pragma unroll
  for (int n = 0; n < MAXN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const bf16* Vt = KV + ((vb + t) & 1) * S::KT * ld;
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles)
      load_rows(KV + ((vb + t + 1) & 1) * S::KT * ld, ld, v + head,
                (t + 1) * S::KT, S::KT, T, C, dk);
    cp_async_commit();
    const int j0 = t * S::KT + 16 * ks;
    if (j0 >= kend) continue;            // warp-uniform
    const float4* sp = slot(t);
    const float4 e0 = sp[0], e1 = sp[32];
    float p[2][4] = {{e0.x, e0.y, e0.z, e0.w}, {e1.x, e1.y, e1.z, e1.w}};
    const bool near = j0 <= rw + 15 + window && j0 + 15 >= rw - window;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, r = r_lo + 8 * rr, i = q0 + r;
        const int j = j0 + 8 * n + 2 * c + (e & 1), off = j - i;
        float pe = p[n][e] / l_row[rr];
        if (drop.on)
          pe = keep_bits(rk[rr], j) >= drop.thr ? pe * drop.keep_scale : 0.f;
        pe = round_bf16(pe);
        if (near && off >= -window && off <= window && j < T)
          Band[r * nb + off + window] = pe;
        p[n][e] = pe;
      }
    // S's accumulator layout is P's A fragment over these 16 keys
    const uint32_t af[4] = {pack_f(p[0][0], p[0][1]), pack_f(p[0][2], p[0][3]),
                            pack_f(p[1][0], p[1][1]), pack_f(p[1][2], p[1][3])};
    const bf16* Vw = Vt + 16 * ks * ld;
#pragma unroll
    for (int n = 0; n < MAXN; n += 2) {
      if (n + 1 < n_dk) {
        uint32_t bb[4];
        frag_b2_k(bb, Vw + 8 * n, ld);
        mma(o[n], af, bb[0], bb[1]);
        mma(o[n + 1], af, bb[2], bb[3]);
      } else if (n < n_dk) {
        uint32_t bb[2];
        frag_b1_k(bb, Vw + 8 * n, ld);
        mma(o[n], af, bb[0], bb[1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the scores and the V tiles
  float* Op = Big;  // [NW][16][LO]
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n < n_dk) {
      *(float2*)(Op + (warp * 16 + g) * LO + 8 * n + 2 * c) =
          make_float2(o[n][0], o[n][1]);
      *(float2*)(Op + (warp * 16 + g + 8) * LO + 8 * n + 2 * c) =
          make_float2(o[n][2], o[n][3]);
    }
  }
  __syncthreads();
  // out = the splits' O summed in a fixed order + band(P) emb_rel_v, bf16
  for (int idx = threadIdx.x; idx < S::ROWS * (dk / 2); idx += S::NT) {
    const int r = idx / (dk / 2), col = idx % (dk / 2) * 2, i = q0 + r;
    if (i >= T) continue;
    const float* o0 = Op + ((r / 16) * KS * 16 + r % 16) * LO + col;
    float a0 = 0.f, a1 = 0.f;
    for (int sp = 0; sp < KS; ++sp) {
      const float2 w = *(const float2*)(o0 + sp * 16 * LO);
      a0 += w.x;
      a1 += w.y;
    }
    for (int m = 0; m < nb; ++m) {
      const float bw = Band[r * nb + m];
      a0 = fmaf(bw, Evs[m * dk + col], a0);
      a1 = fmaf(bw, Evs[m * dk + col + 1], a1);
    }
    *(__nv_bfloat162*)(out + head + (size_t)i * C + col) =
        __floats2bfloat162_rn(a0, a1);
  }
}

// ---- K3-bf16 -------------------------------------------------------------

constexpr int BT = 32;     // rows per row-pass and dq block, keys per key block
constexpr int NT3 = 256;   // threads of every K3-bf16 kernel: 8 warps
constexpr int RKT = 64;    // row pass: keys per tile (4 splits of 16)
constexpr int CQT = 64;    // key pass: query rows per tile
constexpr int QKT = 64;    // dq pass: keys per tile
constexpr int LDP = CQT + 8;   // bf16 planes [32 keys][LDP]
constexpr int LDD = QKT + 8;   // float32 dS tiles [32 rows][LDD]
constexpr int MAXNT = MAX_DK / 32;  // n8 tiles of dk per warp (a quarter)

// Scratch of one backward call, in floats, carved from one buffer.
struct BwdScratch {
  size_t ds, d, relk, relg, bands, bandp, dek_part, dev_part, total;
};

size_t round4(size_t n) { return (n + 3) / 4 * 4; }

BwdScratch bwd_scratch(int B, int T, int C, int dk, int window) {
  const size_t rows = (size_t)B * (C / dk) * T, nb = 2 * window + 1;
  const size_t nblk = (size_t)B * (C / dk) * ((T + BT - 1) / BT);
  BwdScratch s;
  size_t at = 0;
  s.ds = at;        at += round4(rows * ((T + 3) / 4 * 4));  // dS [B,H,T,Tp]
  s.d = at;         at += round4(rows);            // D_i = sum_j dp_ij p_ij
  s.relk = at;      at += round4(rows * nb);       // scale q_i . emb_rel_k[m]
  s.relg = at;      at += round4(rows * nb);       // g_i . emb_rel_v[m]
  s.bands = at;     at += round4(rows * nb);       // band(dS)
  s.bandp = at;     at += round4(rows * nb);       // band(rounded pd)
  s.dek_part = at;  at += round4(nblk * nb * dk);  // per-block emb partials
  s.dev_part = at;  at += round4(nblk * nb * dk);
  s.total = at;
  return s;
}

size_t rows_smem(int dk, int window) {
  const size_t ld = ld_of(dk), nb = 2 * window + 1;
  return r16(4 * RKT * ld * 2)           // K, V x 2 buffers
         + 2 * r16(BT * ld * 2)          // Q, G
         + 2 * r16(nb * dk * 4)          // emb_rel_k, emb_rel_v
         + 5 * r16(BT * nb * 4)          // relk, relg, band p, dp, pd
         + r16((8 * 16 + BT) * 4);       // D partials, D
}

size_t cols_smem(int dk, int window) {
  const size_t ld = ld_of(dk), nb = 2 * window + 1;
  return 2 * r16(BT * ld * 2)            // K, V of the block's keys
         + 4 * r16(CQT * ld * 2)         // Q, G x 2 buffers
         + 4 * r16(BT * LDP * 2)         // rounded pd, dS hi, mid, lo
         + 2 * r16(CQT * 3 * 4)          // row max, sum, D x 2 buffers
         + 4 * r16(CQT * nb * 4);        // relk, relg x 2 buffers
}

size_t dq_smem(int dk, int window) {
  const size_t ld = ld_of(dk), nb = 2 * window + 1;
  return 2 * r16(BT * LDD * 4)           // dS x 2 buffers
         + 2 * r16(QKT * ld * 2)         // K x 2 buffers
         + r16(BT * nb * 4)              // band(dS)
         + r16(nb * dk * 4);             // emb_rel_k
}

// K3 row pass (R): one block per (32 query rows, head, item), warps
// (row group rg of 16 rows) x (split ks taking keys [16 ks, 16 ks + 16) of
// every 64-key tile).  S and dP for the valid pairs (keys below len), D_i,
// the band biases, the band tables of dS and of the rounded dropped P, and
// the block's emb partials.
template <int DK>
__global__ void __launch_bounds__(NT3, 2) rel_attention_bf16_bwd_rows_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g_in,
    const float* __restrict__ ek, const float* __restrict__ ev,
    const int* __restrict__ lengths, const float* __restrict__ stats,
    Drop drop, float* __restrict__ dbuf, float* __restrict__ relk,
    float* __restrict__ relg, float* __restrict__ bands,
    float* __restrict__ bandp, float* __restrict__ dek_part,
    float* __restrict__ dev_part, int T, int C, int dk_arg, int window,
    float scale) {
  constexpr int MAXK = DK ? (DK + 15) / 16 : MAX_DK / 16;
  const int dk = DK ? DK : dk_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = ld_of(dk), nb = 2 * window + 1, nk16 = dk_pad(dk) / 16;
  size_t at = 0;
  auto carve = [&](size_t bytes) {
    unsigned char* p = smem + at;
    at += r16(bytes);
    return p;
  };
  bf16* KV = (bf16*)carve(4 * RKT * ld * 2);  // [2][K, V][RKT][ld]
  bf16* Qs = (bf16*)carve(BT * ld * 2);
  bf16* Gs = (bf16*)carve(BT * ld * 2);
  float* Eks = (float*)carve(nb * dk * 4);
  float* Evs = (float*)carve(nb * dk * 4);
  float* RelK = (float*)carve(BT * nb * 4);
  float* RelG = (float*)carve(BT * nb * 4);
  float* Bp = (float*)carve(BT * nb * 4);     // band p; then band(dS)
  float* Bd = (float*)carve(BT * nb * 4);     // band dp
  float* Bpd = (float*)carve(BT * nb * 4);    // band rounded pd
  float* Dpart = (float*)carve((8 * 16 + BT) * 4);  // [8][16]; D [BT]
  float* Drow = Dpart + 8 * 16;

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, bh = b * H + h;
  const int len = item_len(lengths, b, T);
  const size_t head = (size_t)b * T * C + (size_t)h * dk;
  const size_t row0 = (size_t)bh * T;
  const int kend = q0 < len ? len : 0;  // keys with weight for valid rows
  const int n_tiles = (kend + RKT - 1) / RKT;
  auto load_kv = [&](int t, int buf) {
    bf16* base = KV + buf * 2 * RKT * ld;
    load_rows(base, ld, k + head, t * RKT, RKT, T, C, dk);
    load_rows(base + RKT * ld, ld, v + head, t * RKT, RKT, T, C, dk);
  };
  load_rows(Qs, ld, q + head, q0, BT, T, C, dk);
  load_rows(Gs, ld, g_in + head, q0, BT, T, C, dk);
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < nb * dk; idx += NT3) {
    Eks[idx] = ek[idx];
    Evs[idx] = ev[idx];
  }
  for (int idx = threadIdx.x; idx < BT * nb; idx += NT3)
    Bp[idx] = Bd[idx] = Bpd[idx] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  for (int idx = threadIdx.x; idx < BT * nb; idx += NT3) {
    const int r = idx / nb, m = idx % nb, i = q0 + r;
    const float rk_ = dot_bf(Qs + r * ld, Eks + m * dk, dk) * scale;
    const float rg_ = dot_bf(Gs + r * ld, Evs + m * dk, dk);
    RelK[idx] = rk_;
    RelG[idx] = rg_;
    if (i < T) {
      relk[(row0 + i) * nb + m] = rk_;
      relg[(row0 + i) * nb + m] = rg_;
    }
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp >> 2, ks = warp & 3, g = lane >> 2, c = lane & 3;
  const int r_lo = 16 * rg + g, rw = q0 + 16 * rg;
  const uint32_t seed = drop.on ? (uint32_t)*drop.seed : 0u;
  uint32_t rk[2];
  float m_row[2], l_row[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = q0 + r_lo + 8 * rr;
    rk[rr] = drop.on ? row_key(seed, bh, i) : 0u;
    m_row[rr] = i < T ? stats[(row0 + i) * 2] : 0.f;
    l_row[rr] = i < T ? stats[(row0 + i) * 2 + 1] : 1.f;
  }
  const bf16* Qw = Qs + 16 * rg * ld;
  const bf16* Gw = Gs + 16 * rg * ld;
  float dsum[2] = {0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    const bf16* Kt = KV + (t & 1) * 2 * RKT * ld;
    const bf16* Vt = Kt + RKT * ld;
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    const int j0 = t * RKT + 16 * ks;
    if (j0 >= kend || rw >= len) continue;  // warp-uniform
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < MAXK; ++kk) {
      if (kk < nk16) {
        uint32_t a[4], bb[4];
        frag_a(a, Qw + 16 * kk, ld);
        frag_b2_n(bb, Kt + 16 * ks * ld + 16 * kk, ld);
        mma(s[0], a, bb[0], bb[1]);
        mma(s[1], a, bb[2], bb[3]);
        frag_a(a, Gw + 16 * kk, ld);
        frag_b2_n(bb, Vt + 16 * ks * ld + 16 * kk, ld);
        mma(dd[0], a, bb[0], bb[1]);
        mma(dd[1], a, bb[2], bb[3]);
      }
    }
    const bool near = j0 <= rw + 15 + window && j0 + 15 >= rw - window;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rr = e >> 1, r = r_lo + 8 * rr, i = q0 + r;
        const int j = j0 + 8 * n + 2 * c + (e & 1), off = j - i;
        if (i >= len || j >= len) continue;  // p = 0 or a masked pair
        const bool band = near && off >= -window && off <= window;
        float x = s[n][e] * scale, d = dd[n][e];
        if (band) {
          x += RelK[r * nb + off + window];
          d += RelG[r * nb + off + window];
        }
        const float p = expf(x - m_row[rr]) / l_row[rr];
        float pd = p;
        if (drop.on) {
          const bool keep = keep_bits(rk[rr], j) >= drop.thr;
          pd = keep ? p * drop.keep_scale : 0.f;
          d = keep ? d * drop.keep_scale : 0.f;
        }
        dsum[rr] = fmaf(d, p, dsum[rr]);
        if (band) {
          Bp[r * nb + off + window] = p;
          Bd[r * nb + off + window] = d;
          Bpd[r * nb + off + window] = round_bf16(pd);
        }
      }
  }
  // D_i: each split's share, then the splits in a fixed order
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 1);
    dsum[rr] += __shfl_xor_sync(0xffffffffu, dsum[rr], 2);
    if (c == 0) Dpart[warp * 16 + g + 8 * rr] = dsum[rr];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < BT; r += NT3) {
    float d = 0.f;
    for (int sp = 0; sp < 4; ++sp) d += Dpart[((r >> 4) * 4 + sp) * 16 + (r & 15)];
    const int i = q0 + r;
    d = i < len ? d : 0.f;
    Drow[r] = d;
    if (i < T) dbuf[row0 + i] = d;
  }
  __syncthreads();
  // the band tables: dS = p (dp - D) at a valid pair; the rounded dropped P
  // at every pair whose key exists (a masked row is uniform, p = 1/sum)
  for (int idx = threadIdx.x; idx < BT * nb; idx += NT3) {
    const int r = idx / nb, m = idx % nb, i = q0 + r, j = i + m - window;
    float bs = 0.f, bpv = 0.f;
    if (i < T && j >= 0 && j < T) {
      if (i >= len) {
        float pd = 1.f / stats[(row0 + i) * 2 + 1];
        if (drop.on)
          pd = keep_bits(row_key(seed, bh, i), j) >= drop.thr
                   ? pd * drop.keep_scale
                   : 0.f;
        bpv = round_bf16(pd);
      } else if (j < len) {
        bs = Bp[idx] * (Bd[idx] - Drow[r]);
        bpv = Bpd[idx];
      }
    }
    Bp[idx] = bs;
    Bpd[idx] = bpv;
    if (i < T) {
      bands[(row0 + i) * nb + m] = bs;
      bandp[(row0 + i) * nb + m] = bpv;
    }
  }
  __syncthreads();
  // this block's emb partials: band(dS)^T q scale and band(pd)^T g
  const size_t blk = ((size_t)bh * gridDim.x + blockIdx.x) * nb * dk;
  for (int idx = threadIdx.x; idx < nb * dk; idx += NT3) {
    const int m = idx / dk, d = idx % dk;
    float sk = 0.f, sv = 0.f;
    for (int r = 0; r < BT; ++r) {
      sk = fmaf(Bp[r * nb + m], bf(Qs[r * ld + d]), sk);
      sv = fmaf(Bpd[r * nb + m], bf(Gs[r * ld + d]), sv);
    }
    dek_part[blk + idx] = sk * scale;
    dev_part[blk + idx] = sv;
  }
}

// K3 key pass (C): one block per (32 keys, head, item), looping over the
// 64-row query tiles.  Step 1, warp (kg, rq): S^T and dP^T of keys
// [16 kg, +16) x rows [16 rq, +16).  Step 2: p, the rounded dropped P, dS;
// dS to the scratch; P and dS's three bf16 pieces to the planes.  Step 3,
// warp (kg, cq): dV += P^T G and dK += dS^T Q for keys [16 kg, +16) and
// the n8 tiles cq, cq + 4, ... of dk.
template <int DK>
__global__ void __launch_bounds__(NT3, 2) rel_attention_bf16_bwd_cols_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ g_in,
    const int* __restrict__ lengths, const float* __restrict__ stats,
    const float* __restrict__ dbuf, const float* __restrict__ relk,
    const float* __restrict__ relg, Drop drop, bf16* __restrict__ dk_out,
    bf16* __restrict__ dv_out, float* __restrict__ ds_buf, int T, int C,
    int dk_arg, int window, float scale) {
  constexpr int MAXK = DK ? (DK + 15) / 16 : MAX_DK / 16;
  const int dk = DK ? DK : dk_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = ld_of(dk), nb = 2 * window + 1, nk16 = dk_pad(dk) / 16;
  const int n_dk = dk / 8;
  size_t at = 0;
  auto carve = [&](size_t bytes) {
    unsigned char* p = smem + at;
    at += r16(bytes);
    return p;
  };
  bf16* Kb = (bf16*)carve(BT * ld * 2);
  bf16* Vb = (bf16*)carve(BT * ld * 2);
  bf16* Qt = (bf16*)carve(2 * CQT * ld * 2);  // [2][CQT][ld]
  bf16* Gt = (bf16*)carve(2 * CQT * ld * 2);
  bf16* Pl = (bf16*)carve(4 * BT * LDP * 2);  // [4][BT][LDP]: pd, hi, mid, lo
  float* Rows = (float*)carve(2 * CQT * 3 * 4);  // [2][CQT][max, sum, D]
  float* RelKs = (float*)carve(2 * CQT * nb * 4);
  float* RelGs = (float*)carve(2 * CQT * nb * 4);

  const int j0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, bh = b * H + h;
  const int len = item_len(lengths, b, T);
  const size_t head = (size_t)b * T * C + (size_t)h * dk;
  const size_t row0 = (size_t)bh * T;
  const int Tp = (T + 3) / 4 * 4, nQ = (T + CQT - 1) / CQT;
  // a key block at or past len meets only the masked rows (dV alone)
  const int it0 = j0 < len ? 0 : len / CQT;
  const uint32_t seed = drop.on ? (uint32_t)*drop.seed : 0u;

  auto load_tile = [&](int i0, int buf) {
    load_rows(Qt + buf * CQT * ld, ld, q + head, i0, CQT, T, C, dk);
    load_rows(Gt + buf * CQT * ld, ld, g_in + head, i0, CQT, T, C, dk);
    float* R = Rows + buf * CQT * 3;
    for (int il = threadIdx.x; il < CQT; il += NT3) {
      const int i = i0 + il;
      const bool in = i < T;
      cp_async8(R + il * 2, stats + (row0 + (in ? i : 0)) * 2, in);
      cp_async4(R + 2 * CQT + il, dbuf + row0 + (in ? i : 0), in);
    }
    for (int idx = threadIdx.x; idx < CQT * nb; idx += NT3) {
      const bool in = i0 + idx / nb < T;
      const size_t src = in ? (row0 + i0) * nb + idx : row0 * nb;
      cp_async4(RelKs + buf * CQT * nb + idx, relk + src, in);
      cp_async4(RelGs + buf * CQT * nb + idx, relg + src, in);
    }
  };
  load_rows(Kb, ld, k + head, j0, BT, T, C, dk);
  load_rows(Vb, ld, v + head, j0, BT, T, C, dk);
  load_tile(it0 * CQT, 0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kg = warp & 1, wq = warp >> 1, g = lane >> 2, c = lane & 3;
  float acck[MAXNT][4], accv[MAXNT][4];
#pragma unroll
  for (int x = 0; x < MAXNT; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[x][e] = accv[x][e] = 0.f;

  for (int it = it0; it < nQ; ++it) {
    const int i0 = it * CQT, buf = (it - it0) & 1;
    if (it + 1 < nQ) {
      load_tile(i0 + CQT, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Qb = Qt + buf * CQT * ld;
    const bf16* Gb = Gt + buf * CQT * ld;
    const float* R = Rows + buf * CQT * 3;
    const float* RelK = RelKs + buf * CQT * nb;
    const float* RelG = RelGs + buf * CQT * nb;
    const bool sd = j0 < len && i0 < len;   // any pair with S and dP

    // step 1: S^T and dP^T, keys [16 kg, +16) x rows [16 wq, +16)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float dd[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    if (sd) {
#pragma unroll
      for (int kk = 0; kk < MAXK; ++kk) {
        if (kk < nk16) {
          uint32_t a[4], bb[4];
          frag_a(a, Kb + 16 * kg * ld + 16 * kk, ld);
          frag_b2_n(bb, Qb + 16 * wq * ld + 16 * kk, ld);
          mma(s[0], a, bb[0], bb[1]);
          mma(s[1], a, bb[2], bb[3]);
          frag_a(a, Vb + 16 * kg * ld + 16 * kk, ld);
          frag_b2_n(bb, Gb + 16 * wq * ld + 16 * kk, ld);
          mma(dd[0], a, bb[0], bb[1]);
          mma(dd[1], a, bb[2], bb[3]);
        }
      }
    }
    // step 2: element (key kl = 16 kg + g + 8 (e >> 1), row
    // il = 16 wq + 8 n + 2 c + (e & 1))
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      uint32_t rkey[2] = {0u, 0u};
      if (drop.on)
#pragma unroll
        for (int u = 0; u < 2; ++u)
          rkey[u] = row_key(seed, bh, i0 + 16 * wq + 8 * n + 2 * c + u);
      float pdb[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = 16 * kg + g + 8 * (e >> 1);
        const int il = 16 * wq + 8 * n + 2 * c + (e & 1);
        const int j = j0 + kl, i = i0 + il;
        pdb[e] = ds[e] = 0.f;
        if (i < T && j < T) {
          const int off = j - i;
          const bool band = off >= -window && off <= window;
          const bool valid = i < len && j < len;
          float x = MASK_VAL, d = dd[n][e];
          if (valid) {
            x = s[n][e] * scale;
            if (band) {
              x += RelK[il * nb + off + window];
              d += RelG[il * nb + off + window];
            }
          }
          const float p = expf(x - R[il * 2]) / R[il * 2 + 1];
          float pd = p;
          if (drop.on) {
            const bool keep = keep_bits(rkey[e & 1], j) >= drop.thr;
            pd = keep ? p * drop.keep_scale : 0.f;
            d = keep ? d * drop.keep_scale : 0.f;
          }
          pdb[e] = pd;
          if (valid) ds[e] = p * (d - R[2 * CQT + il]);
        }
        // dS rows have a stride of T rounded up to 4 (16-byte loads in the
        // dq pass); the columns past T are written as zeros
        if (sd && i < T && j < Tp) ds_buf[(row0 + i) * Tp + j] = ds[e];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int at_ = (16 * kg + g + 8 * hh) * LDP + 16 * wq + 8 * n + 2 * c;
        *(uint32_t*)(Pl + at_) = pack_f(pdb[2 * hh], pdb[2 * hh + 1]);
        if (sd) {
          uint32_t hi, mid, lo;
          split3(ds[2 * hh], ds[2 * hh + 1], hi, mid, lo);
          *(uint32_t*)(Pl + BT * LDP + at_) = hi;
          *(uint32_t*)(Pl + 2 * BT * LDP + at_) = mid;
          *(uint32_t*)(Pl + 3 * BT * LDP + at_) = lo;
        }
      }
    }
    __syncthreads();

    // step 3: dV += P^T G, dK += dS^T Q over the tile's rows
#pragma unroll
    for (int kk = 0; kk < CQT / 16; ++kk) {
      uint32_t ap[4], a1[4], a2[4], a3[4];
      const int pa = 16 * kg * LDP + 16 * kk;
      frag_a(ap, Pl + pa, LDP);
      if (sd) {
        frag_a(a1, Pl + BT * LDP + pa, LDP);
        frag_a(a2, Pl + 2 * BT * LDP + pa, LDP);
        frag_a(a3, Pl + 3 * BT * LDP + pa, LDP);
      }
#pragma unroll
      for (int x = 0; x < MAXNT; ++x) {
        const int nt = wq + 4 * x;
        if (nt < n_dk) {
          uint32_t bb[2];
          frag_b1_k(bb, Gb + 16 * kk * ld + 8 * nt, ld);
          mma(accv[x], ap, bb[0], bb[1]);
          if (sd) {
            frag_b1_k(bb, Qb + 16 * kk * ld + 8 * nt, ld);
            mma(acck[x], a1, bb[0], bb[1]);
            mma(acck[x], a2, bb[0], bb[1]);
            mma(acck[x], a3, bb[0], bb[1]);
          }
        }
      }
    }
    __syncthreads();  // tiles and planes consumed before they are reused
  }

#pragma unroll
  for (int x = 0; x < MAXNT; ++x) {
    const int nt = wq + 4 * x;
    if (nt >= n_dk) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int j = j0 + 16 * kg + g + 8 * hh, d = 8 * nt + 2 * c;
      if (j < T) {
        *(__nv_bfloat162*)(dk_out + head + (size_t)j * C + d) =
            __floats2bfloat162_rn(acck[x][2 * hh] * scale,
                                  acck[x][2 * hh + 1] * scale);
        *(__nv_bfloat162*)(dv_out + head + (size_t)j * C + d) =
            __floats2bfloat162_rn(accv[x][2 * hh], accv[x][2 * hh + 1]);
      }
    }
  }
}

// K3 dq pass (Q): one block per (32 query rows, head, item), warps
// (row group rg of 16) x (n8 tiles cq, cq + 4, ... of dk).  dq = scale
// (dS K + band(dS) emb_rel_k), dS K over the key tiles below len with dS
// split into three bf16 pieces; rows at or past len have dS = 0: dq = 0.
template <int DK>
__global__ void __launch_bounds__(NT3, 2) rel_attention_bf16_bwd_dq_kernel(
    const bf16* __restrict__ k, const float* __restrict__ ek,
    const int* __restrict__ lengths, const float* __restrict__ ds_buf,
    const float* __restrict__ bands, bf16* __restrict__ dq, int T, int C,
    int dk_arg, int window, float scale) {
  const int dk = DK ? DK : dk_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ld = ld_of(dk), nb = 2 * window + 1, n_dk = dk / 8;
  size_t at = 0;
  auto carve = [&](size_t bytes) {
    unsigned char* p = smem + at;
    at += r16(bytes);
    return p;
  };
  float* DSt = (float*)carve(2 * BT * LDD * 4);  // [2][BT][LDD]
  bf16* Kt = (bf16*)carve(2 * QKT * ld * 2);     // [2][QKT][ld]
  float* Bs = (float*)carve(BT * nb * 4);
  float* Ek = (float*)carve(nb * dk * 4);

  const int q0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, bh = b * H + h;
  const int len = item_len(lengths, b, T);
  const size_t head = (size_t)b * T * C + (size_t)h * dk;
  const size_t row0 = (size_t)bh * T;
  const int Tp = (T + 3) / 4 * 4;
  if (q0 >= len) {  // every row masked
    for (int idx = threadIdx.x; idx < BT * (dk / 2); idx += NT3) {
      const int i = q0 + idx / (dk / 2), d = idx % (dk / 2) * 2;
      if (i < T)
        *(__nv_bfloat162*)(dq + head + (size_t)i * C + d) =
            __floats2bfloat162_rn(0.f, 0.f);
    }
    return;
  }
  const int nK = (len + QKT - 1) / QKT;
  // dS was written for every key below len (and as zeros past it, up to
  // the key block's end, a multiple of 4): a 16-byte chunk starting below
  // len is whole
  auto load_keys = [&](int jt, int buf) {
    for (int idx = threadIdx.x; idx < BT * (QKT / 4); idx += NT3) {
      const int r = idx / (QKT / 4), c4 = idx % (QKT / 4) * 4;
      const int i = q0 + r, j = jt * QKT + c4;
      const bool in = i < T && j < len;
      cp_async16(DSt + buf * BT * LDD + r * LDD + c4,
                 ds_buf + (in ? (row0 + i) * Tp + j : 0), in);
    }
    load_rows(Kt + buf * QKT * ld, ld, k + head, jt * QKT, QKT, T, C, dk);
  };
  load_keys(0, 0);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < BT * nb; idx += NT3) {
    const int i = q0 + idx / nb;
    Bs[idx] = i < T ? bands[row0 * nb + (size_t)q0 * nb + idx] : 0.f;
  }
  for (int idx = threadIdx.x; idx < nb * dk; idx += NT3) Ek[idx] = ek[idx];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp & 1, cq = warp >> 1, g = lane >> 2, c = lane & 3;
  float acc[MAXNT][4];
#pragma unroll
  for (int x = 0; x < MAXNT; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.f;
  for (int jt = 0; jt < nK; ++jt) {
    const int buf = jt & 1;
    if (jt + 1 < nK) {
      load_keys(jt + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* D = DSt + buf * BT * LDD + 16 * rg * LDD;
    const bf16* Kb = Kt + buf * QKT * ld;
#pragma unroll
    for (int kk = 0; kk < QKT / 16; ++kk) {
      // dS's A fragment, float32, split into three bf16 pieces
      uint32_t a1[4], a2[4], a3[4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float2 xv = *(const float2*)(D + (g + 8 * (f & 1)) * LDD +
                                           16 * kk + 2 * c + 8 * (f >> 1));
        split3(xv.x, xv.y, a1[f], a2[f], a3[f]);
      }
#pragma unroll
      for (int x = 0; x < MAXNT; ++x) {
        const int nt = cq + 4 * x;
        if (nt < n_dk) {
          uint32_t bb[2];
          frag_b1_k(bb, Kb + 16 * kk * ld + 8 * nt, ld);
          mma(acc[x], a1, bb[0], bb[1]);
          mma(acc[x], a2, bb[0], bb[1]);
          mma(acc[x], a3, bb[0], bb[1]);
        }
      }
    }
    __syncthreads();  // tiles consumed before the next load overwrites them
  }
  cp_async_wait<0>();
  __syncthreads();  // band(dS) and emb_rel_k in shared memory

#pragma unroll
  for (int x = 0; x < MAXNT; ++x) {
    const int nt = cq + 4 * x;
    if (nt >= n_dk) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int il = 16 * rg + g + 8 * hh, i = q0 + il, d = 8 * nt + 2 * c;
      if (i >= T) continue;
      float o0 = acc[x][2 * hh], o1 = acc[x][2 * hh + 1];
      for (int m = 0; m < nb; ++m) {
        o0 = fmaf(Bs[il * nb + m], Ek[m * dk + d], o0);
        o1 = fmaf(Bs[il * nb + m], Ek[m * dk + d + 1], o1);
      }
      *(__nv_bfloat162*)(dq + head + (size_t)i * C + d) =
          __floats2bfloat162_rn(o0 * scale, o1 * scale);
    }
  }
}

// K3 (S): the [nblk, n] emb partials of d emb_rel_k (blockIdx.y 0) and
// d emb_rel_v (1) summed over the blocks in a fixed order: eight running
// sums over the partials p = u mod 8, added in a fixed tree
__global__ void sum_partials_kernel(const float* __restrict__ part_k,
                                    const float* __restrict__ part_v,
                                    int nblk, int n,
                                    float* __restrict__ out_k,
                                    float* __restrict__ out_v) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float* part = blockIdx.y ? part_v : part_k;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int p = 0;
  for (; p + 8 <= nblk; p += 8)
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] += part[(size_t)(p + u) * n + idx];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (p + u < nblk) s[u] += part[(size_t)(p + u) * n + idx];
  (blockIdx.y ? out_v : out_k)[idx] =
      ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
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

int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, val = fallback;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&val, attr, dev) != cudaSuccess)
    return fallback;
  return val;
}

// K1-bf16's build for a shape, chosen before the launch: 0 32-row tiles
// (unless they would leave SMs idle or not fit), 1 16-row tiles, 2 16-row
// tiles with the score buffer in a global scratch (T too long for shared
// memory)
int k1_build(int B, int T, int C, int dk, int window) {
  const size_t lim =
      device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 232448);
  const int n_sm = device_attr(cudaDevAttrMultiProcessorCount, 132);
  if ((T + 31) / 32 * (C / dk) * B >= n_sm &&
      k1_smem<2, 8>(T, dk, window, false).total <= lim)
    return 0;
  if (k1_smem<1, 8>(T, dk, window, false).total <= lim) return 1;
  return 2;
}

size_t fwd_scratch(int B, int T, int C, int dk, int window) {
  if (k1_build(B, T, C, dk, window) != 2) return 0;
  return (size_t)B * (C / dk) * ((T + 15) / 16) * 16 * k1_kcap<1, 8>(T);
}

template <int RG, int KS, int DK, bool SCR>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, const float* ek,
               const float* ev, const int* lengths, Drop drop, bf16* out,
               float* stats, float* scratch, int B, int T, int C, int dk,
               int window, float scale, cudaStream_t stream) {
  using S = K1Tile<RG, KS>;
  const size_t smem = k1_smem<RG, KS>(T, dk, window, SCR).total;
  auto fn = rel_attention_bf16_fwd_kernel<RG, KS, DK, SCR>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (T + S::ROWS - 1) / S::ROWS * (C / dk) * B;
  fn<<<grid, S::NT, smem, stream>>>(q, k, v, ek, ev, lengths, out, stats,
                                    scratch, drop, T, C, dk, window, scale);
  return (int)cudaGetLastError();
}

template <int DK>
int launch_fwd_dk(int build, const bf16* q, const bf16* k, const bf16* v,
                  const float* ek, const float* ev, const int* lengths,
                  Drop drop, bf16* out, float* stats, float* scratch, int B,
                  int T, int C, int dk, int window, float scale,
                  cudaStream_t stream) {
  if (build == 0)
    return launch_fwd<2, 8, DK, false>(q, k, v, ek, ev, lengths, drop, out,
                                       stats, scratch, B, T, C, dk, window,
                                       scale, stream);
  if (build == 1)
    return launch_fwd<1, 8, DK, false>(q, k, v, ek, ev, lengths, drop, out,
                                       stats, scratch, B, T, C, dk, window,
                                       scale, stream);
  return launch_fwd<1, 8, DK, true>(q, k, v, ek, ev, lengths, drop, out,
                                    stats, scratch, B, T, C, dk, window,
                                    scale, stream);
}

template <int DK>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v, const float* ek,
               const float* ev, const int* lengths, Drop dr, const bf16* g,
               const float* stats, bf16* dq, bf16* dk_out, bf16* dv_out,
               float* d_ek, float* d_ev, float* scratch, int B, int T, int C,
               int dk, int window, float scale, cudaStream_t stream) {
  const int H = C / dk, nb = 2 * window + 1;
  const BwdScratch s = bwd_scratch(B, T, C, dk, window);
  auto rows = rel_attention_bf16_bwd_rows_kernel<DK>;
  auto cols = rel_attention_bf16_bwd_cols_kernel<DK>;
  auto dqk = rel_attention_bf16_bwd_dq_kernel<DK>;
  const size_t sm_r = rows_smem(dk, window), sm_c = cols_smem(dk, window),
               sm_q = dq_smem(dk, window);
  cudaError_t err = cudaFuncSetAttribute(
      rows, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_r);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        cols, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_c);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sm_q);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T + BT - 1) / BT;
  const dim3 grid(n_tiles, H, B);
  rows<<<grid, NT3, sm_r, stream>>>(
      q, k, v, g, ek, ev, lengths, stats, dr, scratch + s.d, scratch + s.relk,
      scratch + s.relg, scratch + s.bands, scratch + s.bandp,
      scratch + s.dek_part, scratch + s.dev_part, T, C, dk, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cols<<<grid, NT3, sm_c, stream>>>(
      q, k, v, g, lengths, stats, scratch + s.d, scratch + s.relk,
      scratch + s.relg, dr, dk_out, dv_out, scratch + s.ds, T, C, dk, window,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<grid, NT3, sm_q, stream>>>(k, ek, lengths, scratch + s.ds,
                                   scratch + s.bands, dq, T, C, dk, window,
                                   scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = nb * dk, nblk = B * H * n_tiles;
  sum_partials_kernel<<<dim3((n + 255) / 256, 2), 256, 0, stream>>>(
      scratch + s.dek_part, scratch + s.dev_part, nblk, n, d_ek, d_ev);
  return (int)cudaGetLastError();
}

// a build whose shared memory does not fit at T (k1_build never takes it
// there) reports its registers, the bytes it would need and 0 blocks
template <int RG, int KS, int DK, bool SCR>
int fwd_info(const char* label, int T, int dk, int window, char* name, int n,
             int* regs, int* smem, int* blocks) {
  const size_t need = k1_smem<RG, KS>(T, dk, window, SCR).total;
  const bool fits =
      need <= (size_t)device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                  232448);
  const int err = tf32x3::kernel_info(
      (const void*)rel_attention_bf16_fwd_kernel<RG, KS, DK, SCR>, label,
      K1Tile<RG, KS>::NT, fits ? need : 0, name, n, regs, smem, blocks);
  if (!fits) {
    *smem = (int)need;
    *blocks = 0;
  }
  return err;
}

}  // namespace

// Floats of scratch one forward call needs (0 unless T is too long for the
// score buffer in shared memory), or -1 if the kernel does not take these
// sizes.
extern "C" long long rel_attention_bf16_fwd_scratch(int B, int T, int C,
                                                    int dk, int window) {
  if (bad_args(B, T, C, dk, window)) return -1;
  return (long long)fwd_scratch(B, T, C, dk, window);
}

extern "C" int rel_attention_bf16_fwd(
    const bf16* q, const bf16* k, const bf16* v, const float* emb_rel_k,
    const float* emb_rel_v, const int* lengths, const int* seed, unsigned thr,
    float keep_scale, int drop, bf16* out, float* stats, float* scratch,
    int B, int T, int C, int dk, int window, float scale,
    cudaStream_t stream) {
  if (bad_args(B, T, C, dk, window) || (drop && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const int build = k1_build(B, T, C, dk, window);
  if (build == 2 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const Drop dr = make_drop(seed, thr, keep_scale, drop);
  return dk == 96
             ? launch_fwd_dk<96>(build, q, k, v, emb_rel_k, emb_rel_v,
                                 lengths, dr, out, stats, scratch, B, T, C,
                                 dk, window, scale, stream)
             : launch_fwd_dk<0>(build, q, k, v, emb_rel_k, emb_rel_v,
                                lengths, dr, out, stats, scratch, B, T, C, dk,
                                window, scale, stream);
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
  const Drop dr = make_drop(seed, thr, keep_scale, drop);
  return dk == 96
             ? launch_bwd<96>(q, k, v, emb_rel_k, emb_rel_v, lengths, dr, g,
                              stats, dq, dk_out, dv_out, d_emb_rel_k,
                              d_emb_rel_v, scratch, B, T, C, dk, window,
                              scale, stream)
             : launch_bwd<0>(q, k, v, emb_rel_k, emb_rel_v, lengths, dr, g,
                             stats, dq, dk_out, dv_out, d_emb_rel_k,
                             d_emb_rel_v, scratch, B, T, C, dk, window, scale,
                             stream);
}

// Registers, dynamic shared memory and resident blocks per SM of kernel i
// at T, head width dk and window (the build for dk, 96 or generic): 0-2
// K1-bf16 with 32-row tiles, 16-row tiles, 16-row tiles with the scores in
// scratch; 3 K3-bf16 row pass, 4 key pass, 5 dq pass, 6 emb sum; its name
// into name[0:n).  Returns a cudaError_t, or -1 past the end.
extern "C" int rel_attention_bf16_info(int i, int T, int dk, int window,
                                       char* name, int n, int* regs,
                                       int* smem, int* blocks) {
  const bool c96 = dk == 96;
  switch (i) {
    case 0:
      return c96 ? fwd_info<2, 8, 96, false>(
                       "rel_attention_bf16_fwd_kernel<2,8,96> 32-row tiles",
                       T, dk, window, name, n, regs, smem, blocks)
                 : fwd_info<2, 8, 0, false>(
                       "rel_attention_bf16_fwd_kernel<2,8,0> 32-row tiles",
                       T, dk, window, name, n, regs, smem, blocks);
    case 1:
      return c96 ? fwd_info<1, 8, 96, false>(
                       "rel_attention_bf16_fwd_kernel<1,8,96> 16-row tiles",
                       T, dk, window, name, n, regs, smem, blocks)
                 : fwd_info<1, 8, 0, false>(
                       "rel_attention_bf16_fwd_kernel<1,8,0> 16-row tiles",
                       T, dk, window, name, n, regs, smem, blocks);
    case 2:
      return c96 ? fwd_info<1, 8, 96, true>(
                       "rel_attention_bf16_fwd_kernel<1,8,96,scratch>", T,
                       dk, window, name, n, regs, smem, blocks)
                 : fwd_info<1, 8, 0, true>(
                       "rel_attention_bf16_fwd_kernel<1,8,0,scratch>", T, dk,
                       window, name, n, regs, smem, blocks);
    case 3:
      return tf32x3::kernel_info(
          c96 ? (const void*)rel_attention_bf16_bwd_rows_kernel<96>
              : (const void*)rel_attention_bf16_bwd_rows_kernel<0>,
          "rel_attention_bf16_bwd_rows_kernel", NT3, rows_smem(dk, window),
          name, n, regs, smem, blocks);
    case 4:
      return tf32x3::kernel_info(
          c96 ? (const void*)rel_attention_bf16_bwd_cols_kernel<96>
              : (const void*)rel_attention_bf16_bwd_cols_kernel<0>,
          "rel_attention_bf16_bwd_cols_kernel", NT3, cols_smem(dk, window),
          name, n, regs, smem, blocks);
    case 5:
      return tf32x3::kernel_info(
          c96 ? (const void*)rel_attention_bf16_bwd_dq_kernel<96>
              : (const void*)rel_attention_bf16_bwd_dq_kernel<0>,
          "rel_attention_bf16_bwd_dq_kernel", NT3, dq_smem(dk, window), name,
          n, regs, smem, blocks);
    case 6:
      return tf32x3::kernel_info((const void*)sum_partials_kernel,
                                 "sum_partials_kernel", 256, 0, name, n, regs,
                                 smem, blocks);
    default:
      return -1;
  }
}
