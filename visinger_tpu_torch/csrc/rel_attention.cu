// K1 and K3: fused relative-position self-attention, forward and backward,
// float32, for sm_90a.
//
// K1 replaces visinger_tpu/ops/pallas/attention_kernel.py::_attn_fwd_kernel
// (host side _attn_pallas_fwd); K3 replaces ::_attn_bwd_kernel (host side
// _attn_bwd_rule).  For every query row i of head h:
//   s[i, j] = scale * (q_i . k_j) + [|j - i| <= w] scale * (q_i . emb_rel_k[j - i + w])
//   s[i, j] = -1e4 where i >= len or j >= len   (not -inf: fully masked rows
//                                               are uniform, as in the JAX path)
//   p = softmax_j(s)
//   pd[i, j] = p[i, j] * keep[i, j] / (1 - rate)         (attention dropout)
//   out_i = sum_j pd[i, j] v_j + sum_m pd[i, i + m - w] emb_rel_v[m]
//
// Layout: q, k, v, out, g and the gradients are [B, T, C] row-major with
// head h in channels [h*dk, (h+1)*dk); emb tables are [2w+1, dk]; lengths
// int32 [B]; stats float [B, H, T, 2] (each row's softmax max and sum).
// There is no 128-lane padding and dk need not be a power of two (K1 and K3
// take dk in multiples of 8, at most 128).
//
// Dropout.  The TPU kernel drew its keep mask from the TPU's own generator,
// which no GPU reproduces.  Here keep[i, j] comes from a counter-based hash
// of (seed, b*H + h, i, j) (murmur3's 32-bit finaliser, `keep_bits` below),
// so the forward, the backward and the plain PyTorch version in
// ops/rel_attention.py compute the same bits: keep when bits >= thr,
// thr = floor(rate * 2^32).  The seed is read from device memory, so a fresh
// seed per call needs no host synchronisation.
//
// K1 design.  The TPU kernel held a whole [q_blk, T] score row in VMEM.
// Here a block owns (16 * RG query rows, head, item) and RG x KS warps: RG
// row groups of 16 rows times KS key splits.  32-row tiles with 2 x 8
// warps, unless they would leave SMs idle; then 16-row tiles with 1 x 8
// (at [4, 640, 192] 160 blocks of 32 rows; at [4, 192, 192] 96 blocks of
// 16 rows, where 32-row tiles would give 48 on the H100's 132 SMs).  Key
// and value tiles of 8 * KS keys come into shared memory by cp.async,
// double-buffered, one barrier per tile; split s of a row group takes keys
// [8s, 8s + 8) of every tile and keeps its own online softmax (m, l, O) in
// registers.  Every product runs on the tensor cores in 3xTF32 (tf32x3.cuh,
// mma.sync m16n8k8, each k-step's three products summed from zero):
//   S = Q K^T, per warp 16 rows x 8 keys over dk / 8 k-steps.  Q is split
//     into TF32 hi/lo planes once, in shared memory, and re-read at every
//     k-step (8 loads, no cvt): kept in registers it would take 12 x 8 = 96
//     of them a thread at dk = 96, of the 128 a thread has when 16 warps
//     share an SM;
//   P V without a trip through shared memory: V's 8 keys are read in the
//     order c <-> 2c, c + 4 <-> 2c + 1 (load_b_pairs), so S's accumulator
//     registers {d0, d2, d1, d3} are P's A fragment; P and V are split for
//     3xTF32 like any operand.
// Row max and sum reduce over the 4 threads of a quad (shfl_xor 1, 2); the
// sum runs over the undropped p, the P V product sees the dropped pd.  At
// the end the splits' (m, l, O) are merged in shared memory in a fixed order
// (split 0 first): no atomics, the same bits from run to run.  The head
// width is a template argument for the model's dk = 96 (a generic build
// takes any multiple of 8 up to 128), so addresses, loop bounds and
// divisors fold to constants (15% of the time at [4, 640, 192], PERF.md).
// Work the data does not need is skipped, by the tile's place against len:
//   every row below len: keys below len only (a key at or past len weighs
//     exp(-1e4 - max) = 0 in float32, exactly);
//   every row at or past len: no Q K^T and no q or k read.  Without dropout
//     out is the mean of v over the T keys plus (1/T) times the sum of
//     emb_rel_v over the band keys inside [0, T) (column sums of v on the
//     CUDA cores); with dropout pd = keep / (T (1 - rate)), so only the
//     hash and P V run;
//   a tile that straddles len: every key below T, with Q K^T only on the
//     key tiles below len (past it every pair is masked).
// Blocks take the tiles longest first (straddling, valid, masked; items by
// length): at [4, 640, 192] 134 tiles have work for 132 SMs, and the two
// left over should be the shortest.
// Band terms without re-reading K: rel = scale q . emb_rel_k (2w+1 dot
// products a row, float32 FMAs from shared memory) is computed once and
// added only in the key groups that meet the diagonal band; each band score
// (bias and mask in) is stashed in shared memory as it is computed, and
// after the merge the normalised, dropped band weights come from the final
// (max, sum) and the hash, times emb_rel_v.  K1 also writes each row's max
// and sum for K3: kept apart, not folded into one log-sum-exp, because a
// fully masked row has max -1e4, and -1e4 + log(T) in float32 (ulp ~1e-3
// there) would cost p 5e-4 of its value.  At dk = 96, window 4 (-Xptxas -v
// and cudaOccupancy, sm_90a): 32-row tiles 128 registers, 140,288 B of
// shared memory, one block (16 warps) per SM; 16-row tiles 128 registers,
// 124,800 B, one block (8 warps) per SM; no spills.
//
// K3 design.  The TPU kernel ran its grid in order and accumulated dk, dv
// and the emb gradients across q tiles in revisited output blocks; Hopper
// blocks run in no order.  So that q.k and g.v are computed once (not once
// for dq and again for dk/dv), the dk/dv pass writes dS out for the dq
// pass; every product runs on the tensor cores in 3xTF32 (tf32x3.cuh).
// Four launches on one stream:
//   (0) prep, one warp per row: D_i = g_i . out_i (sum_j dP_ij pd_ij = g.out
//       because out includes the band term, so no second softmax pass), the
//       band biases scale q_i . emb_rel_k and g_i . emb_rel_v, and the band
//       tables zeroed;
//   (a) per (32 keys, head, item), looping over 32-row query tiles (Q and G
//       double-buffered with cp.async): S = Q K^T and dP = G V^T, p from K1's
//       saved row max and sum, dropout, dS = p (dP keep/(1-rate) - D_i),
//       zeroed where the row or the column is invalid; dS goes to a
//       [B, H, T, T] scratch (13 MB at [4, 640, 192], L2-resident) and the
//       band entries of dS and pd to [B, H, T, 2w+1] tables; dK += dS^T Q and
//       dV += pd^T G accumulate in registers.  Fully masked rows are uniform
//       over the T keys and reach dv, as in the XLA path.  Work the data does
//       not need is skipped: S, dP, dS and dK only where i < len and j < len;
//       a key tile at or past len sees only the masked rows (dV only);
//   (b) per (32 query rows, head, item): dq = scale (dS K + band(dS)
//       emb_rel_k), dS K on the tensor cores over the key tiles below len,
//       and the block's emb partials band(dS)^T q scale and band(pd)^T g;
//   (c) the emb partials summed in a fixed order.
// No atomics: every output element has one writer and every sum a fixed
// order, so every gradient is the same from run to run.  32-key tiles give
// (T/32) * H * B = 160 blocks of 8 warps at [4, 640, 192], so all run in
// one wave on the 132 SMs; each warp holds a 16 x 8 tile of S and dP and a
// 16-key x dk/4 slice of dK and dV.  At dk = 96, window 4 (-Xptxas -v and
// cudaOccupancy, sm_90a): (a) 128 registers, 94,592 B of shared memory,
// 2 blocks per SM; (b) 64 registers, 68,224 B, 3 per SM; (0) 40 registers;
// (c) 36 registers; no spills.
//
// Bound on the H100: at the model's shapes (T <= 640, dk = 96) the work the
// functions need is ~4 * H * dk * sum_b len_b^2 flops forward (a key at or
// past len gets exp(-1e4 - max) = 0, and every masked row is the same
// uniform mean of v) and ~2.5x that backward, against a few MB of q/k/v/g
// traffic, so both are bound by operations: 165 TFLOP/s in 3xTF32 on the
// tensor cores, where both run (67 TFLOP/s on the float32 CUDA cores).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int MAX_DK = 128;
constexpr float MASK_VAL = -1e4f;
constexpr uint32_t GOLD = 0x9E3779B9u;

// a . b over n (a multiple of 4) floats, both 16-byte aligned, in four
// running sums
__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < n; d += 4) {
    const float4 x = *(const float4*)(a + d), y = *(const float4*)(b + d);
    s[0] = fmaf(x.x, y.x, s[0]);
    s[1] = fmaf(x.y, y.y, s[1]);
    s[2] = fmaf(x.z, y.z, s[2]);
    s[3] = fmaf(x.w, y.w, s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// per-row key of the dropout hash; keep_bits(row_key(seed, bh, i), j)
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

// row strides of [rows][dk] tiles: 4 mod 32 for tiles read by rows (keys and
// values as the B operand of S and dP), 8 mod 32 for tiles read by columns
// (q and g as the B operand of dK and dV, k in the dq pass)
__host__ __device__ __forceinline__ int ld_rows(int dk) {
  return (dk + 31) / 32 * 32 + 4;
}
__host__ __device__ __forceinline__ int ld_cols(int dk) {
  return (dk + 31) / 32 * 32 + 8;
}

// rows [r0, r0 + n) of one head of a [B, T, C] tensor (base at the head's
// first channel of item b) -> an [n][ld] tile; zero past T
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int r0, int n, int T, int C,
                                          int dk) {
  const int vec = dk / 4;
  for (int idx = threadIdx.x; idx < n * vec; idx += blockDim.x) {
    const int r = idx / vec, c4 = idx % vec, t = r0 + r;
    const bool in = t < T;
    tf32x3::cp_async16(dst + r * ld + c4 * 4,
                       src + (size_t)(in ? t : 0) * C + c4 * 4, in);
  }
}

// ---- K1: the attention forward on the tensor cores (3xTF32) ----------------

// RG row groups of 16 query rows times KS key splits, one warp each
template <int RG, int KS>
struct K1Tile {
  static constexpr int ROWS = 16 * RG;     // query rows per block
  static constexpr int KT = 8 * KS;        // keys per shared-memory tile
  static constexpr int NW = RG * KS;       // warps
  static constexpr int NT = 32 * NW;       // threads
  static_assert(RG <= 2, "the merge reuses the K/V buffers");
};

// K1's dynamic shared memory, offsets in floats
struct K1Smem {
  size_t kv, qh, ql, emb, rel, band, ms, ls, fs, row, total;
};

template <int RG, int KS>
__host__ __device__ K1Smem k1_smem(int dk, int window) {
  using S = K1Tile<RG, KS>;
  const size_t ld = ld_rows(dk), nb = 2 * window + 1;
  K1Smem s;
  size_t at = 0;
  s.kv = at;   at += 2 * 2 * S::KT * ld;  // K, V x 2; then the splits' O
  s.qh = at;   at += S::ROWS * ld;        // q's TF32 hi plane (raw q first)
  s.ql = at;   at += S::ROWS * ld;        // q's TF32 lo plane
  s.emb = at;  at += 2 * nb * (dk + 4);   // emb_rel_k, emb_rel_v
  s.rel = at;  at += S::ROWS * nb;        // scale q . emb_rel_k
  s.band = at; at += S::ROWS * nb;        // band scores, then band weights
  s.ms = at;   at += S::NW * 16;          // each split's row max
  s.ls = at;   at += S::NW * 16;          // each split's row sum
  s.fs = at;   at += S::NW * 16;          // each split's merge factor
  s.row = at;  at += S::ROWS * 2;         // each row's merged max, 1 / sum
  s.total = at;
  return s;
}

// K1 on a tile whose rows are all at or past len, without dropout: every
// score is -1e4, so p = 1/T at each of the T keys: out = mean_j v_j +
// (1/T) sum of emb_rel_v over the band keys inside [0, T); max -1e4, sum T.
template <int RG, int KS>
__device__ void k1_masked_tile(float* smem, const float* __restrict__ v,
                               const float* __restrict__ ev,
                               float* __restrict__ out,
                               float* __restrict__ stats, size_t head,
                               size_t row0, int q0, int T, int C, int dk,
                               int window) {
  using S = K1Tile<RG, KS>;
  // column sums of v over the T keys: threads in row phases of dk / 4
  // float4 columns each, several loads in flight, then the phases' partial
  // sums added in a fixed order
  const int n4 = dk / 4, phases = S::NT / n4;
  float* part = smem;                  // [phases][dk]
  float* vmean = part + phases * dk;
  const int c4 = threadIdx.x % n4, ph = threadIdx.x / n4;
  if (ph < phases) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = ph; j < T; j += phases) {
      const float4 x = *(const float4*)(v + head + (size_t)j * C + 4 * c4);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *(float4*)(part + ph * dk + 4 * c4) = acc;
  }
  __syncthreads();
  const float inv_t = 1.f / T;
  for (int d = threadIdx.x; d < dk; d += S::NT) {
    float s = 0.f;
    for (int p = 0; p < phases; ++p) s += part[p * dk + d];
    vmean[d] = s * inv_t;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < S::ROWS * dk; idx += S::NT) {
    const int i = q0 + idx / dk, d = idx % dk;
    if (i >= T) continue;
    float o = vmean[d];
    for (int m = 0; m <= 2 * window; ++m) {
      const int j = i + m - window;
      if (j >= 0 && j < T) o = fmaf(inv_t, ev[m * dk + d], o);
    }
    out[head + (size_t)i * C + d] = o;
  }
  for (int r = threadIdx.x; r < S::ROWS; r += S::NT)
    if (q0 + r < T) {
      stats[(row0 + q0 + r) * 2] = MASK_VAL;
      stats[(row0 + q0 + r) * 2 + 1] = (float)T;
    }
}

// K1: one block per (16 * RG query rows, head, item); see the note above.
// DK: the head width fixed at compile time (the model's 96: every address,
// loop bound and divisor folds to a constant, and the P V loop needs no
// guards), or 0 for any dk the kernel takes (dk_arg, a multiple of 8).
template <int RG, int KS, int DK>
__global__ void __launch_bounds__(K1Tile<RG, KS>::NT,
                                   512 / K1Tile<RG, KS>::NT)
rel_attention_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ ek,
                         const float* __restrict__ ev,
                         const int* __restrict__ lengths,
                         float* __restrict__ out, float* __restrict__ stats,
                         Drop drop, int T, int C, int dk_arg, int window,
                         float scale) {
  using namespace tf32x3;
  using S = K1Tile<RG, KS>;
  constexpr int MAXN = DK ? DK / 8 : MAX_DK / 8;  // n8 tiles of a warp's O
  const int dk = DK ? DK : dk_arg;
  extern __shared__ float smem[];
  const K1Smem L = k1_smem<RG, KS>(dk, window);
  const int LD = ld_rows(dk), nb = 2 * window + 1, n_dk = dk / 8;
  float* Ks = smem + L.kv;               // [2][KT][LD]
  float* Vs = Ks + 2 * S::KT * LD;       // [2][KT][LD]
  float* Qh = smem + L.qh;               // [ROWS][LD]
  float* Ql = smem + L.ql;               // [ROWS][LD]
  // emb rows dk + 4 apart: the rel dot products' 16-byte reads of nine
  // rows by neighbouring threads fall in distinct banks
  const int LE = dk + 4;
  float* Eks = smem + L.emb;             // [nb][LE] emb_rel_k
  float* Evs = Eks + nb * LE;            // [nb][LE] emb_rel_v
  float* Rel = smem + L.rel;             // [ROWS][nb]
  float* Band = smem + L.band;           // [ROWS][nb]
  float* Ms = smem + L.ms;               // [NW][16]
  float* Ls = smem + L.ls;               // [NW][16]
  float* Fs = smem + L.fs;               // [NW][16]
  float* Row = smem + L.row;             // [ROWS][2]

  // Which tile this block takes: the longest first, so that the tiles left
  // waiting for a free SM, when there are more tiles than SMs (160 of 32
  // rows at [4, 640, 192], one block per SM), are the shortest.  First the
  // tiles that straddle len (len keys with Q K^T, the rest P V alone), then
  // the tiles of valid rows, then the tiles of masked rows (the closed form;
  // P V alone with dropout); within each, items by length, longest first
  // (ties by index), tiles in order, heads innermost.  order[] lives in the
  // K/V buffers until the barrier.
  const int H = C / dk, nx = (T + S::ROWS - 1) / S::ROWS;
  const int B = gridDim.x / (nx * H);
  int* order = (int*)Ks;                 // [B] items by length, longest first
  auto item_len = [&](int i) { return max(0, min(lengths[i], T)); };
  for (int i = threadIdx.x; i < B; i += S::NT) {
    const int li = item_len(i);
    int rank = 0;
    for (int j = 0; j < B; ++j) {
      const int lj = item_len(j);
      rank += lj > li || (lj == li && j < i);
    }
    order[rank] = i;
  }
  __syncthreads();
  int id = blockIdx.x, b = 0, x = 0;
  for (int cls = 0, r = 0;; ++r) {
    if (r == B) r = 0, ++cls;
    b = order[r];
    const int nv = item_len(b) / S::ROWS, ns = item_len(b) % S::ROWS != 0;
    const int n = (cls == 0 ? ns : cls == 1 ? nv : nx - nv - ns) * H;
    if (id < n) {
      x = (cls == 0 ? nv : cls == 1 ? 0 : nv + ns) + id / H;
      break;
    }
    id -= n;
  }
  const int q0 = x * S::ROWS, h = id % H, bh = b * H + h;
  __syncthreads();  // order[] read: the K/V buffers are free
  const int len = max(0, min(lengths[b], T));
  const size_t head = (size_t)b * T * C + (size_t)h * dk;
  const size_t row0 = (size_t)bh * T;    // this (item, head)'s first stats row
  const bool masked = q0 >= len;             // every row at or past len
  const bool valid = q0 + S::ROWS <= len;    // every row below len
  if (masked && !drop.on) {
    k1_masked_tile<RG, KS>(smem, v, ev, out, stats, head, row0, q0, T, C, dk,
                           window);
    return;
  }
  const int kend = valid ? len : T;      // the keys this tile visits
  const int n_tiles = (kend + S::KT - 1) / S::KT;
  const uint32_t seed = drop.on ? (uint32_t)*drop.seed : 0u;

  // a key tile wholly at or past len needs no Q K^T: every pair in it is
  // masked (a straddling tile's valid rows give it weight 0)
  auto needs_s = [&](int t) { return !masked && t * S::KT < len; };
  auto load_tile = [&](int t, int buf) {
    if (needs_s(t))
      load_rows(Ks + buf * S::KT * LD, LD, k + head, t * S::KT, S::KT, T, C,
                dk);
    load_rows(Vs + buf * S::KT * LD, LD, v + head, t * S::KT, S::KT, T, C, dk);
  };
  if (!masked) load_rows(Qh, LD, q + head, q0, S::ROWS, T, C, dk);
  for (int idx = threadIdx.x; idx < nb * dk / 4; idx += S::NT) {
    const int at = idx / (dk / 4) * LE + idx % (dk / 4) * 4;
    if (!masked) cp_async16(Eks + at, ek + 4 * idx, true);
    cp_async16(Evs + at, ev + 4 * idx, true);
  }
  load_tile(0, 0);
  cp_async_commit();
  // band scores the key loop does not compute: -1e4 for a masked pair whose
  // key exists, -inf (no weight) for a key outside [0, T); a valid row's key
  // past len weighs 0 either way.  The loop overwrites every valid pair.
  for (int idx = threadIdx.x; idx < S::ROWS * nb; idx += S::NT) {
    const int i = q0 + idx / nb, j = i + idx % nb - window;
    Band[idx] = j >= 0 && j < T && (i >= len || j >= len) ? MASK_VAL
                                                           : -INFINITY;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!masked) {
    for (int idx = threadIdx.x; idx < S::ROWS * nb; idx += S::NT)
      Rel[idx] = dot(Qh + idx / nb * LD, Eks + idx % nb * LE, dk) * scale;
    __syncthreads();  // raw q read; split it in place into hi and lo
    for (int idx = threadIdx.x; idx < S::ROWS * dk; idx += S::NT) {
      const int at = idx / dk * LD + idx % dk;
      uint32_t hi, lo;
      split(Qh[at], hi, lo);
      Qh[at] = __uint_as_float(hi);
      Ql[at] = __uint_as_float(lo);
    }
  }

  const int warp = threadIdx.x >> 5, rg = warp / KS, ks = warp % KS;
  const int g = lane_g(), c = lane_c();
  const int r_lo = 16 * rg + g;          // this thread's rows: r_lo, r_lo + 8
  const int i_lo = q0 + r_lo;
  uint32_t rk[2] = {0u, 0u};
  if (drop.on) {
    rk[0] = row_key(seed, bh, i_lo);
    rk[1] = row_key(seed, bh, i_lo + 8);
  }
  const float kscale = drop.on ? drop.keep_scale : 1.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  float o[MAXN][4];
#pragma unroll
  for (int n = 0; n < MAXN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const float* Qhw = Qh + 16 * rg * LD;
  const float* Qlw = Ql + 16 * rg * LD;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile t landed; every warp is done with tile t - 1
    if (t + 1 < n_tiles) load_tile(t + 1, buf ^ 1);
    cp_async_commit();
    const int j0 = t * S::KT + 8 * ks;   // this warp's 8 keys
    if (j0 >= kend) continue;            // warp-uniform
    const float* Kt = Ks + (buf * S::KT + 8 * ks) * LD;
    const float* Vt = Vs + (buf * S::KT + 8 * ks) * LD;

    // scores of rows (r_lo, r_lo + 8) x keys (j0 + 2c, j0 + 2c + 1)
    float x[4];
    if (needs_s(t)) {
      float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int kk = 0; kk < dk; kk += 8)
        mma3(s, load_a_split(Qhw + kk, Qlw + kk, LD), load_b_t(Kt + kk, LD));
      const int rw = q0 + 16 * rg;       // the warp's first row
      const bool near = j0 <= rw + 15 + window && j0 + 7 >= rw - window;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r_lo + 8 * (e >> 1), i = q0 + r;
        const int j = j0 + 2 * c + (e & 1), off = j - i;
        const bool band = near && off >= -window && off <= window;
        float xe = s[e] * scale;
        if (band) xe += Rel[r * nb + off + window];
        if (i >= len || j >= len) xe = MASK_VAL;
        if (j >= T) xe = -INFINITY;      // keys past T do not exist
        else if (band) Band[r * nb + off + window] = xe;
        x[e] = xe;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = j0 + 2 * c + (e & 1) < T ? MASK_VAL : -INFINITY;
    }

    // online softmax; key j0 < T is in the quad, so each row max is finite
    float alpha[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mx = fmaxf(x[2 * rr], x[2 * rr + 1]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[rr], mx);
      alpha[rr] = expf(m_run[rr] - m_new);
      m_run[rr] = m_new;
      l_run[rr] *= alpha[rr];
    }
    float pd[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 2 * c + (e & 1);
      const float p = expf(x[e] - m_run[e >> 1]);
      l_run[e >> 1] += p;
      pd[e] = drop.on && keep_bits(rk[e >> 1], j) < drop.thr ? 0.f
                                                             : p * kscale;
    }
    FragA a;  // P's A fragment: the accumulator in the order d0, d2, d1, d3
    split(pd[0], a.hi[0], a.lo[0]);
    split(pd[2], a.hi[1], a.lo[1]);
    split(pd[1], a.hi[2], a.lo[2]);
    split(pd[3], a.hi[3], a.lo[3]);
#pragma unroll
    for (int n = 0; n < MAXN; ++n) {
      if (n < n_dk) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
        mma3(o[n], a, load_b_pairs(Vt + 8 * n, LD));
      }
    }
  }

  // merge the key splits in a fixed order
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 1);
    l_run[rr] += __shfl_xor_sync(0xffffffffu, l_run[rr], 2);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the K/V tiles: the O partials
  float* Ow = Ks + warp * 16 * LD;       // [NW][16][LD]
#pragma unroll
  for (int n = 0; n < MAXN; ++n) {
    if (n < n_dk) {
      Ow[g * LD + 8 * n + 2 * c] = o[n][0];
      Ow[g * LD + 8 * n + 2 * c + 1] = o[n][1];
      Ow[(g + 8) * LD + 8 * n + 2 * c] = o[n][2];
      Ow[(g + 8) * LD + 8 * n + 2 * c + 1] = o[n][3];
    }
  }
  if (c == 0) {
    Ms[warp * 16 + g] = m_run[0];
    Ms[warp * 16 + g + 8] = m_run[1];
    Ls[warp * 16 + g] = l_run[0];
    Ls[warp * 16 + g + 8] = l_run[1];
  }
  __syncthreads();
  // per row: the merged max and sum (K1's stats)
  for (int r = threadIdx.x; r < S::ROWS; r += S::NT) {
    const int at = r / 16 * KS * 16 + r % 16, i = q0 + r;
    float m = -INFINITY, l = 0.f;
    for (int s = 0; s < KS; ++s) m = fmaxf(m, Ms[at + 16 * s]);
    for (int s = 0; s < KS; ++s) l += Ls[at + 16 * s] * expf(Ms[at + 16 * s] - m);
    Row[2 * r] = m;
    Row[2 * r + 1] = 1.f / l;
    if (i < T) {
      stats[(row0 + i) * 2] = m;
      stats[(row0 + i) * 2 + 1] = l;
    }
  }
  __syncthreads();
  // per (row, split) the merge factor exp(m_s - m) / l; per (row, band key)
  // the normalised, dropped band weight
  for (int idx = threadIdx.x; idx < S::ROWS * (KS + nb); idx += S::NT) {
    const int r = idx / (KS + nb), k = idx % (KS + nb), i = q0 + r;
    const float m = Row[2 * r], inv_l = Row[2 * r + 1];
    if (k < KS) {
      const int at = r / 16 * KS * 16 + r % 16 + 16 * k;
      Fs[at] = expf(Ms[at] - m) * inv_l;
    } else {
      const int mb = k - KS;
      float w = expf(Band[r * nb + mb] - m) * inv_l;
      if (drop.on)
        w = keep_bits(row_key(seed, bh, i), i + mb - window) >= drop.thr
                ? w * drop.keep_scale
                : 0.f;
      Band[r * nb + mb] = w;
    }
  }
  __syncthreads();
  // out, four columns a thread: sum_s O_s f_s + sum_m w_m emb_rel_v[m]
  for (int idx = threadIdx.x; idx < S::ROWS * (dk / 4); idx += S::NT) {
    const int r = idx / (dk / 4), d = idx % (dk / 4) * 4, i = q0 + r;
    if (i >= T) continue;
    const int at = r / 16 * KS * 16 + r % 16;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    auto fma4 = [&](float w, const float* src) {
      const float4 e = *(const float4*)src;
      acc.x = fmaf(e.x, w, acc.x);
      acc.y = fmaf(e.y, w, acc.y);
      acc.z = fmaf(e.z, w, acc.z);
      acc.w = fmaf(e.w, w, acc.w);
    };
    for (int s = 0; s < KS; ++s)
      fma4(Fs[at + 16 * s], Ks + (at + 16 * s) * LD + d);
    for (int mb = 0; mb < nb; ++mb) fma4(Band[r * nb + mb], Evs + mb * LE + d);
    *(float4*)(out + head + (size_t)i * C + d) = acc;
  }
}

// ---- K3: the attention backward on the tensor cores (3xTF32) ---------------

constexpr int BT = 32;        // K3 tiles: 32 keys per block, 32 query rows per
                              // step (and 32 rows per dq block)
constexpr int BW = 256;       // K3 threads per block: 8 warps, 2 x 4
constexpr int MAXNT = MAX_DK / 32;  // n8 tiles of dk per warp (four warps
                                    // share the dk columns)
constexpr int LDT = BT + 8;   // [32][32] pd / dS tiles read transposed
constexpr int LDS_T = BT + 4; // [32][32] dS tiles read by rows (dq pass)
constexpr int PREP_ROWS = 8;  // rows per prep block, one warp each

size_t round4(size_t n) { return (n + 3) / 4 * 4; }

// Scratch of one backward call, in floats, carved from one buffer.
struct BwdScratch {
  size_t ds, d, relk, relg, bands, bandp, dek_part, dev_part, total;
};

BwdScratch bwd_scratch(int B, int T, int C, int dk, int window) {
  const size_t rows = (size_t)B * (C / dk) * T, nb = 2 * window + 1;
  const size_t nblk = (size_t)B * (C / dk) * ((T + BT - 1) / BT);
  BwdScratch s;
  size_t at = 0;
  s.ds = at;        at += round4(rows * ((T + 3) / 4 * 4));  // dS [B,H,T,Tp]
  s.d = at;         at += round4(rows);           // D_i = g_i . out_i
  s.relk = at;      at += round4(rows * nb);      // scale q_i . emb_rel_k[m]
  s.relg = at;      at += round4(rows * nb);      // g_i . emb_rel_v[m]
  s.bands = at;     at += round4(rows * nb);      // band(dS)
  s.bandp = at;     at += round4(rows * nb);      // band(pd)
  s.dek_part = at;  at += round4(nblk * nb * dk); // per-block emb partials
  s.dev_part = at;  at += round4(nblk * nb * dk);
  s.total = at;
  return s;
}

size_t dkv_smem(int dk, int window) {
  const int nb = 2 * window + 1;
  return sizeof(float) * (2 * (size_t)BT * ld_rows(dk)       // K, V
                          + 4 * (size_t)BT * ld_cols(dk)     // Q, G x 2
                          + 2 * (size_t)BT * LDT             // pd, dS
                          + 6 * (size_t)BT                   // stats, D x 2
                          + 4 * (size_t)BT * nb              // biases x 2
                          + (size_t)BT);                     // row keys
}

size_t dq_smem(int dk, int window) {
  const int nb = 2 * window + 1;
  return sizeof(float) * (2 * (size_t)BT * LDS_T             // dS x 2
                          + 2 * (size_t)BT * ld_cols(dk)     // K x 2
                          + 2 * (size_t)BT * ld_cols(dk)     // Q, G
                          + 2 * (size_t)BT * nb              // band dS, pd
                          + (size_t)nb * dk);                // emb_rel_k
}

// K3 (0): per row i of each (item, head): D_i = g_i . out_i,
// relk = scale q_i . emb_rel_k, relg = g_i . emb_rel_v, and the band
// tables zeroed (entries no tile computes are zero: their keys are past T,
// or the pair is masked with p = 0).  One warp per row.
__global__ void __launch_bounds__(PREP_ROWS * 32) rel_attention_bwd_prep_kernel(
    const float* __restrict__ q, const float* __restrict__ g,
    const float* __restrict__ out, const float* __restrict__ ek,
    const float* __restrict__ ev, float* __restrict__ Dbuf,
    float* __restrict__ relk, float* __restrict__ relg,
    float* __restrict__ bands, float* __restrict__ bandp, int n_rows, int H,
    int T, int C, int dk, int window, float scale) {
  const int row = blockIdx.x * PREP_ROWS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int nb = 2 * window + 1;
  const int i = row % T, bh = row / T, h = bh % H, b = bh / H;
  const size_t base = ((size_t)b * T + i) * C + (size_t)h * dk;
  float dsum = 0.f;
  for (int d = lane; d < dk; d += 32) dsum = fmaf(g[base + d], out[base + d], dsum);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
  if (lane == 0) Dbuf[row] = dsum;
  for (int m = 0; m < nb; ++m) {
    float sk = 0.f, sv = 0.f;
    for (int d = lane; d < dk; d += 32) {
      sk = fmaf(q[base + d], ek[m * dk + d], sk);
      sv = fmaf(g[base + d], ev[m * dk + d], sv);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      sk += __shfl_xor_sync(0xffffffffu, sk, o);
      sv += __shfl_xor_sync(0xffffffffu, sv, o);
    }
    if (lane == 0) {
      relk[(size_t)row * nb + m] = sk * scale;
      relg[(size_t)row * nb + m] = sv;
    }
  }
  for (int m = lane; m < nb; m += 32)
    bands[(size_t)row * nb + m] = bandp[(size_t)row * nb + m] = 0.f;
}

// K3 (a): one block per (32 keys, head, item), looping over the query tiles.
// S = Q K^T and dP = G V^T on the tensor cores; p from K1's saved row max
// and sum, dropout, dS = p (dP keep / (1 - rate) - D_i); dS to the scratch
// (read by the dq pass), the band entries of dS and pd to the band tables;
// dK += dS^T Q and dV += pd^T G in registers.  Tiles that need no work are
// skipped: for a valid row i < len a key j >= len has p = exp(-1e4 - max)
// = 0, so a key tile past len meets only the masked rows (uniform p, dV
// only), and S, dP, dS and dK are needed only where i < len and j < len.
__global__ void __launch_bounds__(BW) rel_attention_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ g,
    const int* __restrict__ lengths, const float* __restrict__ stats,
    const float* __restrict__ Dbuf, const float* __restrict__ relk,
    const float* __restrict__ relg, Drop drop, float* __restrict__ dk_out,
    float* __restrict__ dv_out, float* __restrict__ ds_buf,
    float* __restrict__ bands, float* __restrict__ bandp, int T, int C,
    int dk, int window, float scale) {
  using namespace tf32x3;
  extern __shared__ float smem[];
  const int LR = ld_rows(dk), LC = ld_cols(dk), nb = 2 * window + 1;
  float* Ks = smem;                         // [BT][LR]
  float* Vs = Ks + BT * LR;                 // [BT][LR]
  float* Qs = Vs + BT * LR;                 // [2][BT][LC]
  float* Gs = Qs + 2 * BT * LC;             // [2][BT][LC]
  float* Ps = Gs + 2 * BT * LC;             // [BT][LDT]  pd[i][j]
  float* DSs = Ps + BT * LDT;               // [BT][LDT]  dS[i][j]
  float* Sts = DSs + BT * LDT;              // [2][BT][2] row max and sum
  float* Drs = Sts + 2 * BT * 2;            // [2][BT] D_i
  float* RelKs = Drs + 2 * BT;              // [2][BT][nb]
  float* RelGs = RelKs + 2 * BT * nb;       // [2][BT][nb]
  uint32_t* RKrow = (uint32_t*)(RelGs + 2 * BT * nb);  // [BT] row keys

  const int j0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, bh = b * H + h;
  const int len = lengths[b];
  const size_t head = (size_t)b * T * C + (size_t)h * dk;
  const size_t rows0 = (size_t)bh * T;
  const uint32_t seed = drop.on ? (uint32_t)*drop.seed : 0u;
  const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
  const int n_dk = dk / 8;                  // n8 tiles of dk
  const int nQ = (T + BT - 1) / BT, Tp = (T + 3) / 4 * 4;
  const int it0 = j0 < len ? 0 : len / BT;  // first query tile with work

  // one query tile's operands and row data -> buffer buf
  auto load_tile = [&](int i0, int buf) {
    load_rows(Qs + buf * BT * LC, LC, q + head, i0, BT, T, C, dk);
    load_rows(Gs + buf * BT * LC, LC, g + head, i0, BT, T, C, dk);
    for (int il = threadIdx.x; il < BT; il += BW) {
      const int i = i0 + il;
      const bool in = i < T;
      cp_async8(Sts + (buf * BT + il) * 2, stats + (rows0 + (in ? i : 0)) * 2,
                in);
      cp_async4(Drs + buf * BT + il, Dbuf + rows0 + (in ? i : 0), in);
    }
    for (int idx = threadIdx.x; idx < BT * nb; idx += BW) {
      const bool in = i0 + idx / nb < T;
      const size_t at = in ? (rows0 + i0) * nb + idx : rows0 * nb;
      cp_async4(RelKs + buf * BT * nb + idx, relk + at, in);
      cp_async4(RelGs + buf * BT * nb + idx, relg + at, in);
    }
  };
  load_rows(Ks, LR, k + head, j0, BT, T, C, dk);
  load_rows(Vs, LR, v + head, j0, BT, T, C, dk);
  load_tile(it0 * BT, 0);
  cp_async_commit();

  float acck[MAXNT][4], accv[MAXNT][4];
#pragma unroll
  for (int x = 0; x < MAXNT; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[x][e] = accv[x][e] = 0.f;

  for (int it = it0; it < nQ; ++it) {
    const int i0 = it * BT, buf = (it - it0) & 1;
    if (it + 1 < nQ) {
      load_tile(i0 + BT, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    for (int il = threadIdx.x; il < BT; il += BW)
      RKrow[il] = drop.on ? row_key(seed, bh, i0 + il) : 0u;
    __syncthreads();
    const float* Qt = Qs + buf * BT * LC;
    const float* Gt = Gs + buf * BT * LC;
    const float* St = Sts + buf * BT * 2;
    const float* RelK = RelKs + buf * BT * nb;
    const float* RelG = RelGs + buf * BT * nb;
    const bool sd = j0 < len && i0 < len;

    // S and dP for this warp's 16 query rows x 8 keys
    float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
    if (sd) {
#pragma unroll 4
      for (int kk = 0; kk < dk; kk += 8) {
        mma3(s, load_a(Qt + 16 * wm * LC + kk, LC),
             load_b_t(Ks + 8 * wn * LR + kk, LR));
        mma3(dp, load_a(Gt + 16 * wm * LC + kk, LC),
             load_b_t(Vs + 8 * wn * LR + kk, LR));
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int il = 16 * wm + lane_g() + (e >> 1) * 8;
      const int jl = 8 * wn + 2 * lane_c() + (e & 1);
      const int i = i0 + il, j = j0 + jl;
      float pd = 0.f, ds = 0.f;
      if (i < T && j < T) {
        const int off = j - i;
        const bool band = off >= -window && off <= window;
        float x = s[e] * scale, dpv = dp[e];
        if (band) {
          x += RelK[il * nb + off + window];
          dpv += RelG[il * nb + off + window];
        }
        const bool valid = i < len && j < len;
        if (!valid) x = MASK_VAL;
        const float p = expf(x - St[il * 2]) * (1.f / St[il * 2 + 1]);
        pd = p;
        if (drop.on) {
          const bool kp = keep_bits(RKrow[il], j) >= drop.thr;
          pd = kp ? p * drop.keep_scale : 0.f;
          dpv = kp ? dpv * drop.keep_scale : 0.f;
        }
        if (valid) ds = p * (dpv - Drs[buf * BT + il]);
        if (band) {
          bands[(rows0 + i) * nb + off + window] = ds;
          bandp[(rows0 + i) * nb + off + window] = pd;
        }
      }
      // dS rows have a stride of T rounded up to 4 (16-byte loads in the
      // dq pass); the columns past T are written as zeros
      if (sd && i < T && j < Tp) ds_buf[(rows0 + i) * Tp + j] = ds;
      Ps[il * LDT + jl] = pd;
      DSs[il * LDT + jl] = ds;
    }
    __syncthreads();

    // dV += pd^T G, dK += dS^T Q: this warp's 16 keys x every fourth n8 tile
#pragma unroll
    for (int kk = 0; kk < BT; kk += 8) {
      const FragA apd = load_a_t(Ps + kk * LDT + 16 * wm, LDT);
      FragA ads;
      if (sd) ads = load_a_t(DSs + kk * LDT + 16 * wm, LDT);
#pragma unroll
      for (int x = 0; x < MAXNT; ++x) {
        const int nt = wn + 4 * x;
        if (nt < n_dk) {
          mma3(accv[x], apd, load_b(Gt + kk * LC + 8 * nt, LC));
          if (sd) mma3(acck[x], ads, load_b(Qt + kk * LC + 8 * nt, LC));
        }
      }
    }
    __syncthreads();  // tiles consumed before the next step overwrites them
  }

#pragma unroll
  for (int x = 0; x < MAXNT; ++x) {
    const int nt = wn + 4 * x;
    if (nt >= n_dk) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = j0 + 16 * wm + lane_g() + (e >> 1) * 8;
      const int d = 8 * nt + 2 * lane_c() + (e & 1);
      if (j < T) {
        dk_out[head + (size_t)j * C + d] = acck[x][e] * scale;
        dv_out[head + (size_t)j * C + d] = accv[x][e];
      }
    }
  }
}

// K3 (b): one block per (32 query rows, head, item).  dq = scale (dS K +
// band(dS) emb_rel_k) with dS K on the tensor cores over the keys below
// len (dS is zero elsewhere), and the block's emb partials
// band(dS)^T q scale and band(pd)^T g for the fixed-order sum.
__global__ void __launch_bounds__(BW) rel_attention_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ g, const float* __restrict__ ek,
    const int* __restrict__ lengths, const float* __restrict__ ds_buf,
    const float* __restrict__ bands, const float* __restrict__ bandp,
    float* __restrict__ dq, float* __restrict__ dek_part,
    float* __restrict__ dev_part, int T, int C, int dk, int window,
    float scale) {
  using namespace tf32x3;
  extern __shared__ float smem[];
  const int LC = ld_cols(dk), nb = 2 * window + 1;
  float* DSt = smem;                    // [2][BT][LDS_T]  dS[i][j]
  float* Kt = DSt + 2 * BT * LDS_T;     // [2][BT][LC]     k[j][d]
  float* Qs = Kt + 2 * BT * LC;         // [BT][LC]
  float* Gs = Qs + BT * LC;             // [BT][LC]
  float* Bs = Gs + BT * LC;             // [BT][nb]  band(dS)
  float* Bp = Bs + BT * nb;             // [BT][nb]  band(pd)
  float* Ek = Bp + BT * nb;             // [nb][dk]

  const int i0 = blockIdx.x * BT, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y, bh = b * H + h;
  const int len = lengths[b];
  const size_t head = (size_t)b * T * C + (size_t)h * dk;
  const size_t rows0 = (size_t)bh * T;
  const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
  const int n_dk = dk / 8, Tp = (T + 3) / 4 * 4;
  // key tiles with dS: those below len, when these rows are below len
  const int nK = i0 < len ? (min(len, T) + BT - 1) / BT : 0;

  auto load_keys = [&](int jt, int buf) {
    const int j0 = jt * BT;
    for (int idx = threadIdx.x; idx < BT * (BT / 4); idx += BW) {
      const int r = idx / (BT / 4), c4 = idx % (BT / 4) * 4;
      const int i = i0 + r, j = j0 + c4;
      const bool in = i < T && j < T;
      cp_async16(DSt + buf * BT * LDS_T + r * LDS_T + c4,
                 ds_buf + (rows0 + (in ? i : 0)) * Tp + (in ? j : 0), in);
    }
    load_rows(Kt + buf * BT * LC, LC, k + head, j0, BT, T, C, dk);
  };

  load_rows(Qs, LC, q + head, i0, BT, T, C, dk);
  load_rows(Gs, LC, g + head, i0, BT, T, C, dk);
  if (nK > 0) load_keys(0, 0);
  cp_async_commit();
  for (int idx = threadIdx.x; idx < BT * nb; idx += BW) {
    const int i = i0 + idx / nb;
    Bs[idx] = i < T ? bands[rows0 * nb + (size_t)i0 * nb + idx] : 0.f;
    Bp[idx] = i < T ? bandp[rows0 * nb + (size_t)i0 * nb + idx] : 0.f;
  }
  for (int idx = threadIdx.x; idx < nb * dk; idx += BW) Ek[idx] = ek[idx];

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
    const float* D = DSt + buf * BT * LDS_T;
    const float* Kb = Kt + buf * BT * LC;
#pragma unroll
    for (int kk = 0; kk < BT; kk += 8) {
      const FragA a = load_a(D + 16 * wm * LDS_T + kk, LDS_T);
#pragma unroll
      for (int x = 0; x < MAXNT; ++x) {
        const int nt = wn + 4 * x;
        if (nt < n_dk) mma3(acc[x], a, load_b(Kb + kk * LC + 8 * nt, LC));
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
  __syncthreads();  // Q, G, band tables and emb_rel_k in shared memory

#pragma unroll
  for (int x = 0; x < MAXNT; ++x) {
    const int nt = wn + 4 * x;
    if (nt >= n_dk) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int il = 16 * wm + lane_g() + (e >> 1) * 8;
      const int d = 8 * nt + 2 * lane_c() + (e & 1);
      if (i0 + il >= T) continue;
      float o = acc[x][e];
      for (int m = 0; m < nb; ++m) o = fmaf(Bs[il * nb + m], Ek[m * dk + d], o);
      dq[head + (size_t)(i0 + il) * C + d] = o * scale;
    }
  }
  // emb partials of this block: rows past T hold zeros in Qs/Gs/Bs/Bp
  const size_t blk = (size_t)bh * gridDim.x + blockIdx.x;
  for (int idx = threadIdx.x; idx < nb * dk; idx += BW) {
    const int m = idx / dk, d = idx % dk;
    float sk = 0.f, sv = 0.f;
    for (int r = 0; r < BT; ++r) {
      sk = fmaf(Bs[r * nb + m], Qs[r * LC + d], sk);
      sv = fmaf(Bp[r * nb + m], Gs[r * LC + d], sv);
    }
    dek_part[blk * nb * dk + idx] = sk * scale;
    dev_part[blk * nb * dk + idx] = sv;
  }
}

// K3 (c): sum the [nblk, nb*dk] emb partials in a fixed order: eight
// running sums over the partials p = u mod 8 (eight loads in flight), then
// added in a fixed tree.
__global__ void sum_partials_kernel(const float* __restrict__ part, int nblk,
                                    int n, float* __restrict__ dst) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int p = 0;
  for (; p + 8 <= nblk; p += 8)
#pragma unroll
    for (int u = 0; u < 8; ++u) s[u] += part[(size_t)(p + u) * n + idx];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (p + u < nblk) s[u] += part[(size_t)(p + u) * n + idx];
  dst[idx] = ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]));
}

// K1 and K3 take dk in whole n8 tiles
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

// 16-row tiles when 32-row tiles would leave SMs idle (the token shape)
bool k1_rows16(int T, int H, int B) {
  int dev = 0, n_sm = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  return (T + 31) / 32 * H * B < n_sm;
}

template <int RG, int KS, int DK>
int launch_fwd(const float* q, const float* k, const float* v, const float* ek,
               const float* ev, const int* lengths, Drop drop, float* out,
               float* stats, int B, int T, int C, int dk, int window,
               float scale, cudaStream_t stream) {
  using S = K1Tile<RG, KS>;
  const size_t smem = sizeof(float) * k1_smem<RG, KS>(dk, window).total;
  auto fn = rel_attention_fwd_kernel<RG, KS, DK>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (T + S::ROWS - 1) / S::ROWS * (C / dk) * B;
  fn<<<grid, S::NT, smem, stream>>>(q, k, v, ek, ev, lengths, out, stats,
                                    drop, T, C, dk, window, scale);
  return (int)cudaGetLastError();
}

template <int RG, int KS, int DK>
int fwd_info(const char* label, int dk, int window, char* name, int n,
             int* regs, int* smem, int* blocks) {
  return tf32x3::kernel_info(
      (const void*)rel_attention_fwd_kernel<RG, KS, DK>, label,
      K1Tile<RG, KS>::NT, sizeof(float) * k1_smem<RG, KS>(dk, window).total,
      name, n, regs, smem, blocks);
}

}  // namespace

extern "C" int rel_attention_fwd(const float* q, const float* k, const float* v,
                                 const float* emb_rel_k, const float* emb_rel_v,
                                 const int* lengths, const int* seed,
                                 unsigned thr, float keep_scale, int drop,
                                 float* out, float* stats, int B, int T, int C,
                                 int dk, int window, float scale,
                                 cudaStream_t stream) {
  if (bad_args(B, T, C, dk, window) || (drop && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const Drop dr = make_drop(seed, thr, keep_scale, drop);
  if (k1_rows16(T, C / dk, B))
    return dk == 96 ? launch_fwd<1, 8, 96>(q, k, v, emb_rel_k, emb_rel_v,
                                          lengths, dr, out, stats, B, T, C,
                                          dk, window, scale, stream)
                    : launch_fwd<1, 8, 0>(q, k, v, emb_rel_k, emb_rel_v,
                                          lengths, dr, out, stats, B, T, C,
                                          dk, window, scale, stream);
  return dk == 96 ? launch_fwd<2, 8, 96>(q, k, v, emb_rel_k, emb_rel_v,
                                        lengths, dr, out, stats, B, T, C, dk,
                                        window, scale, stream)
                  : launch_fwd<2, 8, 0>(q, k, v, emb_rel_k, emb_rel_v,
                                        lengths, dr, out, stats, B, T, C, dk,
                                        window, scale, stream);
}

// Floats of scratch one backward call needs (the caller allocates them), or
// -1 if the backward does not take these sizes.
extern "C" long long rel_attention_bwd_scratch(int B, int T, int C, int dk,
                                               int window) {
  if (bad_args(B, T, C, dk, window)) return -1;
  return (long long)bwd_scratch(B, T, C, dk, window).total;
}

extern "C" int rel_attention_bwd(const float* q, const float* k, const float* v,
                                 const float* emb_rel_k, const float* emb_rel_v,
                                 const int* lengths, const int* seed,
                                 unsigned thr, float keep_scale, int drop,
                                 const float* g, const float* out,
                                 const float* stats, float* dq, float* dk_out,
                                 float* dv_out, float* d_emb_rel_k,
                                 float* d_emb_rel_v, float* scratch, int B,
                                 int T, int C, int dk, int window, float scale,
                                 cudaStream_t stream) {
  if (bad_args(B, T, C, dk, window) || (drop && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const int H = C / dk, nb = 2 * window + 1;
  const Drop dr = make_drop(seed, thr, keep_scale, drop);
  const BwdScratch s = bwd_scratch(B, T, C, dk, window);
  float* ds = scratch + s.ds;
  float* dbuf = scratch + s.d;
  float* relk = scratch + s.relk;
  float* relg = scratch + s.relg;
  float* bands = scratch + s.bands;
  float* bandp = scratch + s.bandp;
  float* dek_part = scratch + s.dek_part;
  float* dev_part = scratch + s.dev_part;
  const size_t smem_dkv = dkv_smem(dk, window), smem_dq = dq_smem(dk, window);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_bwd_dkv_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rel_attention_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dq);
  if (err != cudaSuccess) return (int)err;

  const int n_rows = B * H * T;
  rel_attention_bwd_prep_kernel<<<(n_rows + PREP_ROWS - 1) / PREP_ROWS,
                                  PREP_ROWS * 32, 0, stream>>>(
      q, g, out, emb_rel_k, emb_rel_v, dbuf, relk, relg, bands, bandp, n_rows,
      H, T, C, dk, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T + BT - 1) / BT;
  const dim3 grid(n_tiles, H, B);
  rel_attention_bwd_dkv_kernel<<<grid, BW, smem_dkv, stream>>>(
      q, k, v, g, lengths, stats, dbuf, relk, relg, dr, dk_out, dv_out, ds,
      bands, bandp, T, C, dk, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_attention_bwd_dq_kernel<<<grid, BW, smem_dq, stream>>>(
      q, k, g, emb_rel_k, lengths, ds, bands, bandp, dq, dek_part, dev_part, T,
      C, dk, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = nb * dk, nblk = B * H * n_tiles;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(dek_part, nblk, n,
                                                           d_emb_rel_k);
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(dev_part, nblk, n,
                                                           d_emb_rel_v);
  return (int)cudaGetLastError();
}

// Registers, dynamic shared memory and resident blocks per SM of kernel i
// (0 K1 with 32-row tiles, 1 K1 with 16-row tiles, 2 K3 prep, 3 K3 dk/dv,
// 4 K3 dq, 5 K3 emb sum) at head width dk and window; its name into
// name[0:n).  Returns a cudaError_t, or -1 past the end.
extern "C" int rel_attention_info(int i, int dk, int window, char* name,
                                  int n, int* regs, int* smem, int* blocks) {
  switch (i) {
    case 0:
      return dk == 96 ? fwd_info<2, 8, 96>("rel_attention_fwd_kernel<2,8,96> "
                                           "32-row tiles", dk, window, name,
                                           n, regs, smem, blocks)
                      : fwd_info<2, 8, 0>("rel_attention_fwd_kernel<2,8,0> "
                                           "32-row tiles", dk, window, name,
                                           n, regs, smem, blocks);
    case 1:
      return dk == 96 ? fwd_info<1, 8, 96>("rel_attention_fwd_kernel<1,8,96> "
                                           "16-row tiles", dk, window, name,
                                           n, regs, smem, blocks)
                      : fwd_info<1, 8, 0>("rel_attention_fwd_kernel<1,8,0> "
                                           "16-row tiles", dk, window, name,
                                           n, regs, smem, blocks);
    case 2:
      return tf32x3::kernel_info((const void*)rel_attention_bwd_prep_kernel,
                                 "rel_attention_bwd_prep_kernel",
                                 PREP_ROWS * 32, 0, name, n, regs, smem,
                                 blocks);
    case 3:
      return tf32x3::kernel_info((const void*)rel_attention_bwd_dkv_kernel,
                                 "rel_attention_bwd_dkv_kernel", BW,
                                 dkv_smem(dk, window), name, n, regs, smem,
                                 blocks);
    case 4:
      return tf32x3::kernel_info((const void*)rel_attention_bwd_dq_kernel,
                                 "rel_attention_bwd_dq_kernel", BW,
                                 dq_smem(dk, window), name, n, regs, smem,
                                 blocks);
    case 5:
      return tf32x3::kernel_info((const void*)sum_partials_kernel,
                                 "sum_partials_kernel", 256, 0, name, n, regs,
                                 smem, blocks);
    default:
      return -1;
  }
}
