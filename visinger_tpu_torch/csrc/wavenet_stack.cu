// K2: fused gated WaveNet stack, forward, float32, for sm_90a.
//
// Replaces visinger_tpu/ops/pallas/wavenet_kernel.py::_wavenet_kernel (host
// side _pallas_forward).  L layers, dilation 1, kernel K.  Per layer l:
//   a   = sum_tap h[t + tap - K/2] @ w_in[l, tap] + g_all[b, l]    (C -> 2C)
//   z   = tanh(a[:C]) * sigmoid(a[C:])
//   rs  = z @ w_rs[l] + b_rs[l]                                     (C -> 2C)
//   h   = (h + rs[:C]) * mask          for l < L - 1
//   out += rs[C:]
// g_all is the conv bias plus the per-(item, layer) conditioning.  Frames
// outside [0, T) are zero, as in the TPU kernel's padded input.
//
// Layout: x, out [B, T, C]; mask [B, T]; w_in [L, K, C, 2C];
// w_rs [L, C, 2C]; g_all [B, L, 2C]; b_rs [L, 2C].
//
// Design.  One block per (time tile of `tt` frames, batch item).  The tile is
// loaded with an L*(K/2)-frame halo on each side, which is the stack's
// receptive field, so every layer runs on the padded tile without touching
// other blocks and the tt centre frames come out exact.  The activation
// tile h, the gate tile and the skip sum stay in shared memory across all L
// layers (~100 KB at C=192, tt=32, L=4; opt-in dynamic shared memory);
// only the weights are read from global memory (L2-resident, each element
// once per block and layer).  One thread owns an output channel and a
// 16-frame register tile of both gate halves, so the tanh*sigmoid gate is
// fused into the conv epilogue and the residual/skip update into the 1x1
// epilogue.  The block is two-dimensional: x runs over output channels,
// y over the 16-frame register tiles of the padded tile, so a block holds
// C * ceil(R/16) threads (576 at C=192, tt=32, L=4) and enough warps to
// hide the L2 latency of the weight reads.
//
// Bound on the H100: ~2*B*T*(L*(K+1)*C*2C - C*C) flops (the last layer's
// 1x1 is C -> C; its residual half of w_rs is zero padding) against ~1.5 MB
// of weights per layer plus x/mask/out, so it is bound by operations; this
// first version runs on the float32 CUDA cores (no tensor cores), the limit
// it is measured against.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int RC = 16;           // frames per register tile
constexpr int MAX_THREADS = 576;  // caps registers at 113 a thread
constexpr int TILE_FRAMES = 32;   // centre frames per block: 80 blocks at
                                  // B=4, T=640

__global__ void __launch_bounds__(MAX_THREADS) wavenet_stack_fwd_kernel(
    const float* __restrict__ x, const float* __restrict__ mask,
    const float* __restrict__ w_in, const float* __restrict__ g_all,
    const float* __restrict__ w_rs, const float* __restrict__ b_rs,
    float* __restrict__ out, int T, int C, int L, int K, int tt) {
  extern __shared__ float smem[];
  const int half = K / 2;
  const int halo = L * half;
  const int R = tt + 2 * halo;              // padded tile rows
  const int Rp = (R + RC - 1) / RC * RC;    // rounded to whole register tiles
  const int C2 = 2 * C;
  float* Hs = smem;                  // [Rp + 2*half][C]; tile row r at r + half
  float* Gs = Hs + (Rp + 2 * half) * C;  // [Rp][C] gates
  float* Ss = Gs + Rp * C;               // [tt][C] skip sum
  float* Ms = Ss + tt * C;               // [Rp] mask

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const int row0 = threadIdx.y * RC, row_step = blockDim.y * RC;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * tt - halo;  // frame of tile row 0

  for (int idx = tid; idx < (Rp + 2 * half) * C; idx += nt) {
    const int r = idx / C - half, ch = idx % C, t = t0 + r;
    const bool in = r >= 0 && r < R && t >= 0 && t < T;
    Hs[idx] = in ? x[((size_t)b * T + t) * C + ch] : 0.f;
  }
  for (int r = tid; r < Rp; r += nt) {
    const int t = t0 + r;
    Ms[r] = (r < R && t >= 0 && t < T) ? mask[(size_t)b * T + t] : 0.f;
  }
  for (int idx = tid; idx < tt * C; idx += nt) Ss[idx] = 0.f;
  __syncthreads();

  for (int l = 0; l < L; ++l) {
    const float* wl = w_in + (size_t)l * K * C * C2;
    const float* gl = g_all + ((size_t)b * L + l) * C2;
    for (int o = threadIdx.x; o < C; o += blockDim.x) {
      for (int rc = row0; rc < Rp; rc += row_step) {
        float aa[RC], ab[RC];
        const float ga = gl[o], gb = gl[C + o];
#pragma unroll
        for (int j = 0; j < RC; ++j) { aa[j] = ga; ab[j] = gb; }
        for (int tap = 0; tap < K; ++tap) {
          const float* wt = wl + (size_t)tap * C * C2;
          // tile row rc + j + tap - half lives at smem row rc + j + tap
          const float* hb = Hs + (rc + tap) * C;
#pragma unroll 4
          for (int c = 0; c < C; ++c) {
            const float wa = __ldg(wt + (size_t)c * C2 + o);
            const float wb = __ldg(wt + (size_t)c * C2 + C + o);
#pragma unroll
            for (int j = 0; j < RC; ++j) {
              const float hv = hb[j * C + c];
              aa[j] = fmaf(hv, wa, aa[j]);
              ab[j] = fmaf(hv, wb, ab[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < RC; ++j)
          Gs[(rc + j) * C + o] = tanhf(aa[j]) * (1.f / (1.f + expf(-ab[j])));
      }
    }
    __syncthreads();  // all gates written; all reads of h for this layer done

    const float* wr = w_rs + (size_t)l * C * C2;
    const float* br = b_rs + (size_t)l * C2;
    const bool last = l == L - 1;
    for (int o = threadIdx.x; o < C; o += blockDim.x) {
      for (int rc = row0; rc < Rp; rc += row_step) {
        float ar[RC], as[RC];
        const float bres = br[o], bskip = br[C + o];
#pragma unroll
        for (int j = 0; j < RC; ++j) { ar[j] = bres; as[j] = bskip; }
        const float* zb = Gs + rc * C;
#pragma unroll 4
        for (int c = 0; c < C; ++c) {
          const float wres = __ldg(wr + (size_t)c * C2 + o);
          const float wskip = __ldg(wr + (size_t)c * C2 + C + o);
#pragma unroll
          for (int j = 0; j < RC; ++j) {
            const float zv = zb[j * C + c];
            ar[j] = fmaf(zv, wres, ar[j]);
            as[j] = fmaf(zv, wskip, as[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < RC; ++j) {
          const int r = rc + j;
          if (r >= halo && r < halo + tt) Ss[(r - halo) * C + o] += as[j];
          if (!last && r < R) {
            float* hp = Hs + (r + half) * C + o;
            *hp = (*hp + ar[j]) * Ms[r];
          }
        }
      }
    }
    __syncthreads();  // h updated before the next layer's conv reads it
  }

  for (int idx = tid; idx < tt * C; idx += nt) {
    const int r = idx / C, ch = idx % C, t = blockIdx.x * tt + r;
    if (t < T) out[((size_t)b * T + t) * C + ch] = Ss[idx];
  }
}

}  // namespace

extern "C" int wavenet_stack_fwd(const float* x, const float* mask,
                                 const float* w_in, const float* g_all,
                                 const float* w_rs, const float* b_rs,
                                 float* out, int B, int T, int C, int L, int K,
                                 cudaStream_t stream) {
  if (B <= 0 || T <= 0 || C <= 0 || L <= 0 || K <= 0 || K % 2 == 0)
    return (int)cudaErrorInvalidValue;
  const int tt = TILE_FRAMES;
  // x: one thread per output channel (whole warps, at most 256); y: as many
  // 16-frame register tiles as MAX_THREADS leaves room for
  const int cw = (C + 31) / 32 * 32;
  const int threads = cw < 256 ? cw : 256;
  const int half = K / 2;
  const int R = tt + 2 * L * half;
  const int Rp = (R + RC - 1) / RC * RC;
  const size_t smem = sizeof(float) *
      ((size_t)(Rp + 2 * half) * C + (size_t)Rp * C + (size_t)tt * C + Rp);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_stack_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int row_tiles = Rp / RC;
  const int ny = row_tiles < MAX_THREADS / threads ? row_tiles
                                                   : MAX_THREADS / threads;
  const dim3 grid((T + tt - 1) / tt, B);
  const dim3 block(threads, ny > 0 ? ny : 1);
  wavenet_stack_fwd_kernel<<<grid, block, smem, stream>>>(
      x, mask, w_in, g_all, w_rs, b_rs, out, T, C, L, K, tt);
  return (int)cudaGetLastError();
}
