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
// There is no 128-lane padding and dk need not be a power of two.
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
//
// K3 design.  The TPU kernel ran its grid in order and accumulated dk, dv and
// the emb gradients across q tiles in revisited output blocks; Hopper blocks
// run in no order, so K3 is three kernels on one stream:
//   (a) per (32 query rows, head, item): recompute p from the saved stats,
//       dP = g.v^T + band(g . emb_rel_v^T), dS = p (dP * keep/(1-rate) - D_i)
//       with D_i = g_i . out_i (sum_j dP_d pd = g . out because out includes
//       the band term, so no second softmax pass is needed), zeroed where the
//       row or the column is invalid; dq = scale (dS k + band(dS) emb_rel_k);
//       the block's emb partials band(dS)^T q and band(pd)^T g go to scratch;
//   (b) per (32 keys, head, item): loop over all query tiles for
//       dk = scale dS^T q and dv = pd^T g (fully masked rows are uniform over
//       the T keys and reach dv, as in the XLA path);
//   (c) the emb partials summed in a fixed order (no atomics), so every
//       gradient is the same from run to run.
//
// Bound on the H100: at the model's shapes (T <= 640, dk = 96) the work the
// functions need is ~4 * H * dk * sum_b len_b^2 flops forward (a key at or
// past len gets exp(-1e4 - max) = 0, and every masked row is the same
// uniform mean of v) and ~2.5x that backward, against a few MB of q/k/v/g
// traffic, so both are bound by operations; these first versions run on the
// float32 CUDA cores (no tensor cores, no TMA), the limit they are measured
// against.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// K3 (a): dq, D_i and the per-block emb partials.
__global__ void __launch_bounds__(NT) rel_attention_bwd_dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ ek,
    const float* __restrict__ ev, const int* __restrict__ lengths,
    const float* __restrict__ g, const float* __restrict__ out,
    const float* __restrict__ stats, Drop drop, float* __restrict__ dq,
    float* __restrict__ Dbuf, float* __restrict__ dek_part,
    float* __restrict__ dev_part, int T, int C, int dk, int window,
    float scale) {
  extern __shared__ float smem[];
  const int ld = dk + 1;
  const int nb = 2 * window + 1;
  float* Qs = smem;                   // [QB][ld]
  float* Gs = Qs + QB * ld;           // [QB][ld]
  float* Ks = Gs + QB * ld;           // [KB][ld]
  float* Vs = Ks + KB * ld;           // [KB][ld]
  float* DSs = Vs + KB * ld;          // [QB][KB + 1]  dS tile
  float* RelK = DSs + QB * (KB + 1);  // [QB][nb]  scale * q . emb_rel_k
  float* RelG = RelK + QB * nb;       // [QB][nb]  g . emb_rel_v
  float* Bds = RelG + QB * nb;        // [QB][nb]  band(dS)
  float* Bp = Bds + QB * nb;          // [QB][nb]  band(pd)

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * QB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int len = lengths[b];
  const size_t base = (size_t)b * T * C + (size_t)h * dk;

  for (int idx = tid; idx < QB * dk; idx += NT) {
    const int r = idx / dk, d = idx % dk, i = q0 + r;
    const bool in = i < T;
    Qs[r * ld + d] = in ? q[base + (size_t)i * C + d] : 0.f;
    Gs[r * ld + d] = in ? g[base + (size_t)i * C + d] : 0.f;
  }
  for (int idx = tid; idx < QB * nb; idx += NT) Bds[idx] = Bp[idx] = 0.f;
  __syncthreads();
  for (int idx = tid; idx < QB * nb; idx += NT) {
    const int r = idx / nb, m = idx % nb;
    RelK[idx] = dot(Qs + r * ld, ek + m * dk, dk) * scale;
    RelG[idx] = dot(Gs + r * ld, ev + m * dk, dk);
  }

  const int r = tid / TPR, c = tid % TPR, i = q0 + r;
  const bool row_in = i < T;
  const float* qrow = Qs + r * ld;
  const float* grow = Gs + r * ld;
  const uint32_t rk = drop.on ? row_key((uint32_t)*drop.seed, b * H + h, i)
                              : 0u;
  // D_i = g_i . out_i over this head's channels
  float Di = 0.f;
  if (row_in)
    for (int d = c; d < dk; d += TPR)
      Di = fmaf(grow[d], out[base + (size_t)i * C + d], Di);
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1)
    Di += __shfl_xor_sync(0xffffffffu, Di, o);
  const float* st = stats + (((size_t)b * H + h) * T + (row_in ? i : 0)) * 2;
  const float m_i = row_in ? st[0] : 0.f;
  const float inv_l_i = row_in ? 1.f / st[1] : 0.f;
  if (row_in && c == 0) Dbuf[((size_t)b * H + h) * T + i] = Di;

  float acc[NCOL];
#pragma unroll
  for (int n = 0; n < NCOL; ++n) acc[n] = 0.f;

  for (int k0 = 0; k0 < T; k0 += KB) {
    __syncthreads();
    for (int idx = tid; idx < KB * dk; idx += NT) {
      const int jl = idx / dk, d = idx % dk, j = k0 + jl;
      const bool in = j < T;
      Ks[jl * ld + d] = in ? k[base + (size_t)j * C + d] : 0.f;
      Vs[jl * ld + d] = in ? v[base + (size_t)j * C + d] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < SPT; ++n) {
      const int jl = c + TPR * n, j = k0 + jl;
      float ds = 0.f;
      if (row_in && j < T) {
        const int off = j - i;
        const bool band = off >= -window && off <= window;
        float x = dot(qrow, Ks + jl * ld, dk) * scale;
        float dp = dot(grow, Vs + jl * ld, dk);
        if (band) {
          x += RelK[r * nb + off + window];
          dp += RelG[r * nb + off + window];
        }
        const bool valid = i < len && j < len;
        if (!valid) x = MASK_VAL;
        const float p = expf(x - m_i) * inv_l_i;
        float pd = p;
        if (drop.on) {
          const bool kp = keep_bits(rk, j) >= drop.thr;
          pd = kp ? p * drop.keep_scale : 0.f;
          dp = kp ? dp * drop.keep_scale : 0.f;
        }
        if (valid) ds = p * (dp - Di);
        if (band) {
          Bds[r * nb + off + window] = ds;
          Bp[r * nb + off + window] = pd;
        }
      }
      DSs[r * (KB + 1) + jl] = ds;
    }
    __syncwarp();  // the row's 8 threads share one warp
    for (int jl = 0; jl < KB; ++jl) {
      const float ds = DSs[r * (KB + 1) + jl];
#pragma unroll
      for (int n = 0; n < NCOL; ++n) {
        const int d = c + TPR * n;
        if (d < dk) acc[n] = fmaf(ds, Ks[jl * ld + d], acc[n]);
      }
    }
  }
  __syncthreads();  // band tables complete for every row

  if (row_in) {
#pragma unroll
    for (int n = 0; n < NCOL; ++n) {
      const int d = c + TPR * n;
      if (d < dk) {
        float o = acc[n];
        for (int m = 0; m < nb; ++m) o = fmaf(Bds[r * nb + m], ek[m * dk + d], o);
        dq[base + (size_t)i * C + d] = o * scale;
      }
    }
  }
  // emb partials of this block: rows past T hold zeros in Qs/Gs/Bds/Bp
  const size_t blk = ((size_t)b * H + h) * gridDim.x + blockIdx.x;
  for (int idx = tid; idx < nb * dk; idx += NT) {
    const int m = idx / dk, d = idx % dk;
    float sk = 0.f, sv = 0.f;
    for (int rr = 0; rr < QB; ++rr) {
      sk = fmaf(Bds[rr * nb + m], Qs[rr * ld + d], sk);
      sv = fmaf(Bp[rr * nb + m], Gs[rr * ld + d], sv);
    }
    dek_part[blk * nb * dk + idx] = sk * scale;
    dev_part[blk * nb * dk + idx] = sv;
  }
}

// K3 (b): dk and dv, one block per 32 keys, looping over every query tile.
__global__ void __launch_bounds__(NT) rel_attention_bwd_dkv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ ek,
    const float* __restrict__ ev, const int* __restrict__ lengths,
    const float* __restrict__ g, const float* __restrict__ stats,
    const float* __restrict__ Dbuf, Drop drop, float* __restrict__ dk_out,
    float* __restrict__ dv_out, int T, int C, int dk, int window,
    float scale) {
  extern __shared__ float smem[];
  const int ld = dk + 1;
  const int nb = 2 * window + 1;
  float* Ks = smem;                   // [KB][ld]  this block's keys
  float* Vs = Ks + KB * ld;           // [KB][ld]
  float* Qs = Vs + KB * ld;           // [QB][ld]  current query tile
  float* Gs = Qs + QB * ld;           // [QB][ld]
  float* PDs = Gs + QB * ld;          // [KB][QB + 1]  pd^T tile
  float* DSs = PDs + KB * (QB + 1);   // [KB][QB + 1]  dS^T tile
  float* RelK = DSs + KB * (QB + 1);  // [QB][nb]
  float* RelG = RelK + QB * nb;       // [QB][nb]
  float* Ms = RelG + QB * nb;         // [QB] row max
  float* ILs = Ms + QB;               // [QB] 1 / row sum
  float* Ds = ILs + QB;               // [QB] D
  uint32_t* RK = (uint32_t*)(Ds + QB);  // [QB] dropout row keys

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * KB;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int H = gridDim.y;
  const int len = lengths[b];
  const size_t base = (size_t)b * T * C + (size_t)h * dk;
  const size_t row_base = ((size_t)b * H + h) * T;
  const uint32_t seed = drop.on ? (uint32_t)*drop.seed : 0u;

  for (int idx = tid; idx < KB * dk; idx += NT) {
    const int jl = idx / dk, d = idx % dk, j = j0 + jl;
    const bool in = j < T;
    Ks[jl * ld + d] = in ? k[base + (size_t)j * C + d] : 0.f;
    Vs[jl * ld + d] = in ? v[base + (size_t)j * C + d] : 0.f;
  }

  const int r = tid / TPR, c = tid % TPR, j = j0 + r;
  const float* krow = Ks + r * ld;
  const float* vrow = Vs + r * ld;
  float adk[NCOL], adv[NCOL];
#pragma unroll
  for (int n = 0; n < NCOL; ++n) adk[n] = adv[n] = 0.f;

  for (int i0 = 0; i0 < T; i0 += QB) {
    __syncthreads();  // previous query tile fully consumed
    for (int idx = tid; idx < QB * dk; idx += NT) {
      const int il = idx / dk, d = idx % dk, i = i0 + il;
      const bool in = i < T;
      Qs[il * ld + d] = in ? q[base + (size_t)i * C + d] : 0.f;
      Gs[il * ld + d] = in ? g[base + (size_t)i * C + d] : 0.f;
    }
    for (int il = tid; il < QB; il += NT) {
      const int i = i0 + il;
      Ms[il] = i < T ? stats[(row_base + i) * 2] : 0.f;
      ILs[il] = i < T ? 1.f / stats[(row_base + i) * 2 + 1] : 0.f;
      Ds[il] = i < T ? Dbuf[row_base + i] : 0.f;
      RK[il] = drop.on ? row_key(seed, b * H + h, i) : 0u;
    }
    __syncthreads();
    for (int idx = tid; idx < QB * nb; idx += NT) {
      const int il = idx / nb, m = idx % nb;
      RelK[idx] = dot(Qs + il * ld, ek + m * dk, dk) * scale;
      RelG[idx] = dot(Gs + il * ld, ev + m * dk, dk);
    }
    __syncthreads();
#pragma unroll
    for (int n = 0; n < SPT; ++n) {
      const int il = c + TPR * n, i = i0 + il;
      float pd = 0.f, ds = 0.f;
      if (i < T && j < T) {
        const int off = j - i;
        const bool band = off >= -window && off <= window;
        float x = dot(Qs + il * ld, krow, dk) * scale;
        float dp = dot(Gs + il * ld, vrow, dk);
        if (band) {
          x += RelK[il * nb + off + window];
          dp += RelG[il * nb + off + window];
        }
        const bool valid = i < len && j < len;
        if (!valid) x = MASK_VAL;
        const float p = expf(x - Ms[il]) * ILs[il];
        pd = p;
        if (drop.on) {
          const bool kp = keep_bits(RK[il], j) >= drop.thr;
          pd = kp ? p * drop.keep_scale : 0.f;
          dp = kp ? dp * drop.keep_scale : 0.f;
        }
        if (valid) ds = p * (dp - Ds[il]);
      }
      PDs[r * (QB + 1) + il] = pd;
      DSs[r * (QB + 1) + il] = ds;
    }
    __syncwarp();  // the key row's 8 threads share one warp
    for (int il = 0; il < QB; ++il) {
      const float pd = PDs[r * (QB + 1) + il];
      const float ds = DSs[r * (QB + 1) + il];
#pragma unroll
      for (int n = 0; n < NCOL; ++n) {
        const int d = c + TPR * n;
        if (d < dk) {
          adv[n] = fmaf(pd, Gs[il * ld + d], adv[n]);
          adk[n] = fmaf(ds, Qs[il * ld + d], adk[n]);
        }
      }
    }
  }
  if (j >= T) return;
#pragma unroll
  for (int n = 0; n < NCOL; ++n) {
    const int d = c + TPR * n;
    if (d < dk) {
      dk_out[base + (size_t)j * C + d] = adk[n] * scale;
      dv_out[base + (size_t)j * C + d] = adv[n];
    }
  }
}

// K3 (c): sum the [nblk, nb*dk] emb partials in a fixed order.
__global__ void sum_partials_kernel(const float* __restrict__ part, int nblk,
                                    int n, float* __restrict__ dst) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int p = 0; p < nblk; ++p) s += part[(size_t)p * n + idx];
  dst[idx] = s;
}

bool bad_args(int B, int T, int C, int dk, int window) {
  return dk <= 0 || dk > MAX_DK || C % dk != 0 || window < 0 || T <= 0 ||
         B <= 0;
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
  const int nb = 2 * window + 1;
  const size_t smem = sizeof(float) *
      ((size_t)QB * (dk + 1) + (size_t)KB * (dk + 1) + (size_t)KB * dk +
       (size_t)QB * (KB + 1) + 2 * (size_t)QB * nb);
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

// Scratch, allocated by the caller: Dbuf [B*H*T]; dek_part and dev_part
// [B*H*ceil(T/32), (2w+1)*dk] each.
extern "C" int rel_attention_bwd(const float* q, const float* k, const float* v,
                                 const float* emb_rel_k, const float* emb_rel_v,
                                 const int* lengths, const int* seed,
                                 unsigned thr, float keep_scale, int drop,
                                 const float* g, const float* out,
                                 const float* stats, float* dq, float* dk_out,
                                 float* dv_out, float* d_emb_rel_k,
                                 float* d_emb_rel_v, float* Dbuf,
                                 float* dek_part, float* dev_part, int B, int T,
                                 int C, int dk, int window, float scale,
                                 cudaStream_t stream) {
  if (bad_args(B, T, C, dk, window) || (drop && seed == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nb = 2 * window + 1;
  const Drop dr = make_drop(seed, thr, keep_scale, drop);
  const size_t ld = dk + 1;
  const size_t smem_dq = sizeof(float) *
      (4 * QB * ld + (size_t)QB * (KB + 1) + 4 * (size_t)QB * nb);
  const size_t smem_dkv = sizeof(float) *
      (4 * QB * ld + 2 * (size_t)KB * (QB + 1) + 2 * (size_t)QB * nb +
       4 * (size_t)QB);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rel_attention_bwd_dkv_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T + QB - 1) / QB;
  const dim3 grid(n_tiles, C / dk, B);
  rel_attention_bwd_dq_kernel<<<grid, NT, smem_dq, stream>>>(
      q, k, v, emb_rel_k, emb_rel_v, lengths, g, out, stats, dr, dq, Dbuf,
      dek_part, dev_part, T, C, dk, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_attention_bwd_dkv_kernel<<<grid, NT, smem_dkv, stream>>>(
      q, k, v, emb_rel_k, emb_rel_v, lengths, g, stats, Dbuf, dr, dk_out, dv_out,
      T, C, dk, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = nb * dk, nblk = B * (C / dk) * n_tiles;
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(dek_part, nblk, n,
                                                           d_emb_rel_k);
  sum_partials_kernel<<<(n + 255) / 256, 256, 0, stream>>>(dev_part, nblk, n,
                                                           d_emb_rel_v);
  return (int)cudaGetLastError();
}
