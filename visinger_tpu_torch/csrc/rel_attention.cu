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
// There is no 128-lane padding and dk need not be a power of two (K3 takes
// dk in multiples of 8).
//
// Dropout.  The TPU kernel drew its keep mask from the TPU's own generator,
// which no GPU reproduces.  Here keep[i, j] comes from a counter-based hash
// of (seed, b*H + h, i, j) (murmur3's 32-bit finaliser, `keep_bits` below),
// so the forward, the backward and the plain PyTorch version in
// ops/rel_attention.py compute the same bits: keep when bits >= thr,
// thr = floor(rate * 2^32).  The seed is read from device memory, so a fresh
// seed per call needs no host synchronisation.
//
// K1 design.  The TPU kernel held a whole [q_blk, T] score row in VMEM.  Here
// one block owns (32 query rows, head, batch item), loops over 32-key tiles
// held in shared memory and keeps a running (online) softmax in registers:
// 8 threads share a query row, each holds 4 scores of the tile and dk/8
// output columns.  The softmax sum runs over the undropped p; only the P.V
// product sees the dropped pd.  The band term needs the *normalised* pd at
// the 9 band keys; those are recomputed after the key loop from the final row
// max and sum.  K1 also writes each row's max and sum for K3: kept apart, not
// folded into one log-sum-exp, because a fully masked row has max -1e4, and
// -1e4 + log(T) in float32 (ulp ~1e-3 there) would cost p 5e-4 of its value.
// K1 still runs on the float32 CUDA cores.
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
// traffic, so both are bound by operations: 67 TFLOP/s on the CUDA cores,
// 165 TFLOP/s in 3xTF32 on the tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int QB = 32;           // query rows per block
constexpr int KB = 32;           // keys per tile
constexpr int TPR = 8;           // threads per row
constexpr int NT = QB * TPR;     // threads per block
constexpr int MAX_DK = 128;
constexpr int NCOL = MAX_DK / TPR;  // output columns per thread
constexpr int SPT = KB / TPR;       // scores per thread per tile
constexpr float MASK_VAL = -1e4f;
constexpr uint32_t GOLD = 0x9E3779B9u;

__device__ __forceinline__ float dot(const float* a, const float* b, int n) {
  float s = 0.f;
  for (int d = 0; d < n; ++d) s = fmaf(a[d], b[d], s);
  return s;
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

__global__ void __launch_bounds__(NT) rel_attention_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ ek,
    const float* __restrict__ ev, const int* __restrict__ lengths,
    float* __restrict__ out, float* __restrict__ stats, Drop drop, int T,
    int C, int dk, int window, float scale) {
  extern __shared__ float smem[];
  const int ld = dk + 1;  // odd row stride: rows of one warp hit distinct banks
  const int nb = 2 * window + 1;
  float* Qs = smem;                   // [QB][ld]
  float* Ks = Qs + QB * ld;           // [KB][ld]
  float* Vs = Ks + KB * ld;           // [KB][dk]
  float* Ps = Vs + KB * dk;           // [QB][KB + 1]
  float* Rel = Ps + QB * (KB + 1);    // [QB][nb]  scale * q . emb_rel_k
  float* Bw = Rel + QB * nb;          // [QB][nb]  normalised band weights

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int len = lengths[b];
  const size_t base = (size_t)b * T * C + (size_t)h * dk;

  for (int idx = tid; idx < QB * dk; idx += NT) {
    const int r = idx / dk, d = idx % dk, i = q0 + r;
    Qs[r * ld + d] = i < T ? q[base + (size_t)i * C + d] : 0.f;
  }
  __syncthreads();
  for (int idx = tid; idx < QB * nb; idx += NT) {
    const int r = idx / nb, m = idx % nb;
    Rel[idx] = dot(Qs + r * ld, ek + m * dk, dk) * scale;
  }

  const int r = tid / TPR, c = tid % TPR, i = q0 + r;
  const float* qrow = Qs + r * ld;
  const uint32_t rk = drop.on ? row_key((uint32_t)*drop.seed, b * H + h, i)
                              : 0u;
  float m_run = -INFINITY, l_run = 0.f;
  float acc[NCOL];
#pragma unroll
  for (int n = 0; n < NCOL; ++n) acc[n] = 0.f;

  for (int k0 = 0; k0 < T; k0 += KB) {
    __syncthreads();  // previous tile fully consumed (and Rel written)
    for (int idx = tid; idx < KB * dk; idx += NT) {
      const int jl = idx / dk, d = idx % dk, j = k0 + jl;
      const bool in = j < T;
      Ks[jl * ld + d] = in ? k[base + (size_t)j * C + d] : 0.f;
      Vs[jl * dk + d] = in ? v[base + (size_t)j * C + d] : 0.f;
    }
    __syncthreads();

    float s[SPT];
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < SPT; ++n) {
      const int jl = c + TPR * n, j = k0 + jl;
      float x = -INFINITY;  // keys past T do not exist
      if (j < T) {
        x = dot(qrow, Ks + jl * ld, dk) * scale;
        const int off = j - i;
        if (off >= -window && off <= window) x += Rel[r * nb + off + window];
        if (i >= len || j >= len) x = MASK_VAL;
      }
      s[n] = x;
      mx = fmaxf(mx, x);
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m_run, mx);  // finite: key k0 < T is in the tile
    const float alpha = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int n = 0; n < SPT; ++n) {
      const int jl = c + TPR * n;
      const float p = expf(s[n] - m_new);
      psum += p;
      float pd = p;
      if (drop.on)
        pd = keep_bits(rk, k0 + jl) >= drop.thr ? p * drop.keep_scale : 0.f;
      Ps[r * (KB + 1) + jl] = pd;
    }
#pragma unroll
    for (int o = TPR / 2; o > 0; o >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, o);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    __syncwarp();  // the row's 8 threads share one warp

#pragma unroll
    for (int n = 0; n < NCOL; ++n) acc[n] *= alpha;
    for (int jl = 0; jl < KB; ++jl) {
      const float p = Ps[r * (KB + 1) + jl];
#pragma unroll
      for (int n = 0; n < NCOL; ++n) {
        const int d = c + TPR * n;
        if (d < dk) acc[n] = fmaf(p, Vs[jl * dk + d], acc[n]);
      }
    }
  }

  // normalised (dropped) p at the band keys, from the final row max and sum
  const float inv_l = 1.f / l_run;
  for (int m = c; m < nb; m += TPR) {
    const int j = i + m - window;
    float w = 0.f;
    if (j >= 0 && j < T) {
      float x = dot(qrow, k + base + (size_t)j * C, dk) * scale + Rel[r * nb + m];
      if (i >= len || j >= len) x = MASK_VAL;
      w = expf(x - m_run) * inv_l;
      if (drop.on)
        w = keep_bits(rk, j) >= drop.thr ? w * drop.keep_scale : 0.f;
    }
    Bw[r * nb + m] = w;
  }
  __syncwarp();
  if (i >= T) return;
  if (c == 0) {
    float* st = stats + (((size_t)b * H + h) * T + i) * 2;
    st[0] = m_run;
    st[1] = l_run;
  }
#pragma unroll
  for (int n = 0; n < NCOL; ++n) {
    const int d = c + TPR * n;
    if (d < dk) {
      float o = acc[n] * inv_l;
      for (int m = 0; m < nb; ++m) o = fmaf(Bw[r * nb + m], ev[m * dk + d], o);
      out[base + (size_t)i * C + d] = o;
    }
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

// row strides of [32][dk] tiles: 4 mod 32 for tiles read by rows (keys and
// values as the B operand of S and dP), 8 mod 32 for tiles read by columns
// (q and g as the B operand of dK and dV, k in the dq pass)
__host__ __device__ __forceinline__ int ld_rows(int dk) {
  return (dk + 31) / 32 * 32 + 4;
}
__host__ __device__ __forceinline__ int ld_cols(int dk) {
  return (dk + 31) / 32 * 32 + 8;
}

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

// rows [r0, r0 + BT) of one head of a [B, T, C] tensor (base at the head's
// first channel of item b) -> a [BT][ld] tile; zero past T
__device__ __forceinline__ void load_head_rows(float* dst, int ld,
                                               const float* src, int r0,
                                               int T, int C, int dk) {
  const int vec = dk / 4;
  for (int idx = threadIdx.x; idx < BT * vec; idx += blockDim.x) {
    const int r = idx / vec, c4 = idx % vec, t = r0 + r;
    const bool in = t < T;
    tf32x3::cp_async16(dst + r * ld + c4 * 4,
                       src + (size_t)(in ? t : 0) * C + c4 * 4, in);
  }
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
    load_head_rows(Qs + buf * BT * LC, LC, q + head, i0, T, C, dk);
    load_head_rows(Gs + buf * BT * LC, LC, g + head, i0, T, C, dk);
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
  load_head_rows(Ks, LR, k + head, j0, T, C, dk);
  load_head_rows(Vs, LR, v + head, j0, T, C, dk);
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
    load_head_rows(Kt + buf * BT * LC, LC, k + head, j0, T, C, dk);
  };

  load_head_rows(Qs, LC, q + head, i0, T, C, dk);
  load_head_rows(Gs, LC, g + head, i0, T, C, dk);
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

bool bad_args(int B, int T, int C, int dk, int window) {
  return dk <= 0 || dk > MAX_DK || C % dk != 0 || window < 0 || T <= 0 ||
         B <= 0;
}

// the backward's tiles take dk in whole n8 tiles
bool bad_bwd_args(int B, int T, int C, int dk, int window) {
  return bad_args(B, T, C, dk, window) || dk % 8 != 0;
}

size_t fwd_smem(int dk, int window) {
  const int nb = 2 * window + 1;
  return sizeof(float) *
      ((size_t)QB * (dk + 1) + (size_t)KB * (dk + 1) + (size_t)KB * dk +
       (size_t)QB * (KB + 1) + 2 * (size_t)QB * nb);
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

extern "C" int rel_attention_fwd(const float* q, const float* k, const float* v,
                                 const float* emb_rel_k, const float* emb_rel_v,
                                 const int* lengths, const int* seed,
                                 unsigned thr, float keep_scale, int drop,
                                 float* out, float* stats, int B, int T, int C,
                                 int dk, int window, float scale,
                                 cudaStream_t stream) {
  if (bad_args(B, T, C, dk, window) || (drop && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(dk, window);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + QB - 1) / QB, C / dk, B);
  rel_attention_fwd_kernel<<<grid, NT, smem, stream>>>(
      q, k, v, emb_rel_k, emb_rel_v, lengths, out, stats,
      make_drop(seed, thr, keep_scale, drop), T, C, dk, window, scale);
  return (int)cudaGetLastError();
}

// Floats of scratch one backward call needs (the caller allocates them), or
// -1 if the backward does not take these sizes.
extern "C" long long rel_attention_bwd_scratch(int B, int T, int C, int dk,
                                               int window) {
  if (bad_bwd_args(B, T, C, dk, window)) return -1;
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
  if (bad_bwd_args(B, T, C, dk, window) || (drop && seed == nullptr))
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
// (0 K1, 1 K3 prep, 2 K3 dk/dv, 3 K3 dq, 4 K3 emb sum) at head width dk and
// window; its name into name[0:n).  Returns a cudaError_t, or -1 past the
// end.
extern "C" int rel_attention_info(int i, int dk, int window, char* name,
                                  int n, int* regs, int* smem, int* blocks) {
  switch (i) {
    case 0:
      return tf32x3::kernel_info((const void*)rel_attention_fwd_kernel,
                                 "rel_attention_fwd_kernel", NT,
                                 fwd_smem(dk, window), name, n, regs, smem,
                                 blocks);
    case 1:
      return tf32x3::kernel_info((const void*)rel_attention_bwd_prep_kernel,
                                 "rel_attention_bwd_prep_kernel",
                                 PREP_ROWS * 32, 0, name, n, regs, smem,
                                 blocks);
    case 2:
      return tf32x3::kernel_info((const void*)rel_attention_bwd_dkv_kernel,
                                 "rel_attention_bwd_dkv_kernel", BW,
                                 dkv_smem(dk, window), name, n, regs, smem,
                                 blocks);
    case 3:
      return tf32x3::kernel_info((const void*)rel_attention_bwd_dq_kernel,
                                 "rel_attention_bwd_dq_kernel", BW,
                                 dq_smem(dk, window), name, n, regs, smem,
                                 blocks);
    case 4:
      return tf32x3::kernel_info((const void*)sum_partials_kernel,
                                 "sum_partials_kernel", 256, 0, name, n, regs,
                                 smem, blocks);
    default:
      return -1;
  }
}
