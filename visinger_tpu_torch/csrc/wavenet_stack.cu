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
// w_rs [L, C, 2C]; g_all [B, L, 2C]; b_rs [L, 2C]; scratch h, z [B, T, C].
//
// Bound on the H100: ~2*B*T*(L*(K+1)*C*2C - C*C) flops (the last layer's
// 1x1 is C -> C) against ~1.5 MB of weights per layer plus x/mask/out, so
// it is bound by operations: 67 TFLOP/s on the float32 CUDA cores, 165 in
// float32-accurate 3xTF32 on the tensor cores (tf32x3.cuh).
//
// Design.  A time tile that carried its L*(K/2)-frame halo through all
// layers would recompute the halo (3x the work at L=16) and give only
// (T/32) * B = 80 blocks, so the stack runs layer by layer over the whole
// [B, T, C] activation instead: h, z and the skip sum (2 MB each at B=4,
// T=640, C=192) stay resident in the 50 MB L2 between the launches.  Each layer is
// two tensor-core GEMMs in 3xTF32, M = frames, N = 2C, tiles of 64 frames x
// 64 columns, so (T/64) * (C/32) * B = 240 blocks of 128 threads each:
//   (A) gate: depth K*C, done as K shifted taps over one shared-memory tile
//       of 64 + K - 1 rows of h, loaded once with cp.async and read by all
//       K taps.  A tile's 64 columns are the tanh columns of 32 channels
//       and the sigmoid columns of the same 32, and each warp holds both
//       halves of 16 channels, so the bias and the tanh * sigmoid gate run
//       on the accumulators in registers; z is written out.
//   (B) res/skip: depth C, the same tiling over z.  The epilogue applies
//       h = (h + res) * mask on every layer but the last (the last layer
//       computes the skip half only) and adds skip into the skip sum.
// The weights stream through shared memory in 32-row chunks, a ring of
// four loaded with cp.async, one barrier per chunk.  At C = 192, K = 5
// (-Xptxas -v and cudaOccupancy, sm_90a): gate 136 registers, 90,176 B of
// shared memory; res/skip 96 registers, 87,040 B; no spills; two blocks
// resident per SM, so all 240 run in one wave.  On the H100, 128-frame
// tiles with 8 warps and an 8-deep ring, or the two small products kept in
// a long-lived accumulator, each moved the time by under 5% (PERF.md);
// the three mma per product are the firm part of it, and wgmma is the next
// step.  Every output element has one owning thread, so the result is the
// same from run to run.  2*L launches from one C call.

#include <cuda_runtime.h>
#include <math.h>

#include "tf32x3.cuh"

namespace {

using namespace tf32x3;

constexpr int TM = 64;          // frames per block tile
constexpr int CH = 32;          // channels per block tile
constexpr int TN = 2 * CH;      // columns per block tile: both halves
constexpr int KC = 32;          // weight rows per streamed chunk
constexpr int NSTAGE = 4;       // weight chunks in the ring
constexpr int NTHREADS = 128;   // 4 warps: 2 (32 frames) x 2 (16 channels)
constexpr int LDB = TN + 8;     // weight chunk row stride, 8 mod 32

__host__ __device__ __forceinline__ int lda(int C) { return C + 4; }

size_t gate_smem(int C, int K) {
  return sizeof(float) * ((size_t)(TM + K - 1) * lda(C) + NSTAGE * KC * LDB);
}
size_t res_skip_smem(int C) {
  return sizeof(float) * ((size_t)TM * lda(C) + NSTAGE * KC * LDB);
}

// rows [0, nrows) of the A tile <- frames r0 + r of item b of src [B, T, C],
// zero outside [0, T)
__device__ __forceinline__ void load_rows(float* As, const float* src, int b,
                                          int r0, int nrows, int T, int C) {
  const int vec = C / 4;
  for (int idx = threadIdx.x; idx < nrows * vec; idx += NTHREADS) {
    const int r = idx / vec, c4 = idx % vec, t = r0 + r;
    const bool in = t >= 0 && t < T;
    cp_async16(As + r * lda(C) + c4 * 4,
               src + ((size_t)b * T + (in ? t : 0)) * C + c4 * 4, in);
  }
}

// KC weight rows (row stride wld) -> Bs; local column lc < CH is column
// col_a + lc, lc >= CH is col_b + lc - CH
__device__ __forceinline__ void load_w(float* Bs, const float* W, int wld,
                                       int col_a, int col_b) {
  for (int idx = threadIdx.x; idx < KC * (TN / 4); idx += NTHREADS) {
    const int r = idx / (TN / 4), lc = idx % (TN / 4) * 4;
    const int col = lc < CH ? col_a + lc : col_b + lc - CH;
    cp_async16(Bs + r * LDB + lc, W + (size_t)r * wld + col, true);
  }
}

// acc[mt][nt] of warp (wm, wn): frames 32 wm + 16 mt; nt 0, 1 the first
// half's columns 16 wn + 8 nt, nt 2, 3 the second half's CH + 16 wn + 8 (nt-2).
// Runs the chunk loop: chunk ch covers weight rows [ch * KC, (ch+1) * KC),
// i.e. tap ch / (C / KC), channels (ch % (C / KC)) * KC.  The caller has
// issued (not committed) the A tile's copies.  With !first_half only the
// second half is computed.
__device__ __forceinline__ void gemm(float (&acc)[2][4][4], const float* As,
                                     int C, int nchunks, const float* W,
                                     int col_a, int col_b, float* Bs,
                                     bool first_half) {
  const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
  const int wld = 2 * C, cpt = C / KC, ld = lda(C);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[mt][nt][v] = 0.f;

  // a ring of NSTAGE chunk buffers with NSTAGE - 1 chunks in flight and
  // one barrier per chunk; every step commits a group (empty near the end)
  // so that wait<NSTAGE - 2> always means "chunk ch has landed"
  for (int ch = 0; ch < NSTAGE - 1; ++ch) {
    if (ch < nchunks)
      load_w(Bs + ch * KC * LDB, W + (size_t)ch * KC * wld, wld, col_a, col_b);
    cp_async_commit();
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();  // chunk ch landed; every warp is done with ch - 1
    const int next = ch + NSTAGE - 1;
    if (next < nchunks)
      load_w(Bs + next % NSTAGE * KC * LDB, W + (size_t)next * KC * wld, wld,
             col_a, col_b);
    cp_async_commit();
    const float* Bc = Bs + ch % NSTAGE * KC * LDB;
    const int tap = ch / cpt, k0 = (ch % cpt) * KC;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 8) {
      FragA a[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        a[mt] = load_a(As + (32 * wm + 16 * mt + tap) * ld + k0 + kk, ld);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt < 2 && !first_half) continue;
        const int col = nt < 2 ? 16 * wn + 8 * nt : CH + 16 * wn + 8 * (nt - 2);
        const FragB bf = load_b(Bc + kk * LDB + col, LDB);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma3(acc[mt][nt], a[mt], bf);
      }
    }
  }
}

// (A) z = tanh(a[:C]) * sigmoid(a[C:]) for one layer
__global__ void __launch_bounds__(NTHREADS) wavenet_gate_kernel(
    const float* __restrict__ h, const float* __restrict__ w,
    const float* __restrict__ g_all, int g_stride, float* __restrict__ z,
    int T, int C, int K) {
  extern __shared__ float smem[];
  float* As = smem;                          // [TM + K - 1][lda(C)]
  float* Bs = As + (TM + K - 1) * lda(C);    // [NSTAGE][KC][LDB]
  const int t0 = blockIdx.x * TM, o0 = blockIdx.y * CH, b = blockIdx.z;
  load_rows(As, h, b, t0 - K / 2, TM + K - 1, T, C);
  float acc[2][4][4];
  gemm(acc, As, C, K * C / KC, w, o0, C + o0, Bs, true);

  const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
  const float* gl = g_all + (size_t)b * g_stride;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int t = t0 + 32 * wm + 16 * mt + lane_g() + (v >> 1) * 8;
        const int o = o0 + 16 * wn + 8 * nt + 2 * lane_c() + (v & 1);
        if (t >= T) continue;
        const float ta = tanhf(acc[mt][nt][v] + gl[o]);
        const float sg = 1.f / (1.f + expf(-(acc[mt][nt + 2][v] + gl[C + o])));
        z[((size_t)b * T + t) * C + o] = ta * sg;
      }
}

// (B) rs = z @ w_rs + b_rs; h = (h_in + rs[:C]) * mask unless last;
// out = (first ? 0 : out) + rs[C:].  h_in may alias h_out: each element is
// read and written by the same thread.
__global__ void __launch_bounds__(NTHREADS) wavenet_res_skip_kernel(
    const float* __restrict__ z, const float* __restrict__ w,
    const float* __restrict__ bias, const float* h_in, float* h_out,
    const float* __restrict__ mask, float* __restrict__ out, int T, int C,
    int first, int last) {
  extern __shared__ float smem[];
  float* As = smem;                 // [TM][lda(C)]
  float* Bs = As + TM * lda(C);     // [NSTAGE][KC][LDB]
  const int t0 = blockIdx.x * TM, o0 = blockIdx.y * CH, b = blockIdx.z;
  load_rows(As, z, b, t0, TM, T, C);
  float acc[2][4][4];
  gemm(acc, As, C, C / KC, w, o0, C + o0, Bs, !last);

  const int warp = threadIdx.x >> 5, wm = warp & 1, wn = warp >> 1;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int t = t0 + 32 * wm + 16 * mt + lane_g() + (v >> 1) * 8;
        const int o = o0 + 16 * wn + 8 * nt + 2 * lane_c() + (v & 1);
        if (t >= T) continue;
        const size_t idx = ((size_t)b * T + t) * C + o;
        if (!last)
          h_out[idx] = (h_in[idx] + acc[mt][nt][v] + bias[o])
                       * mask[(size_t)b * T + t];
        const float skip = acc[mt][nt + 2][v] + bias[C + o];
        out[idx] = first ? skip : out[idx] + skip;
      }
}

bool bad_args(int B, int T, int C, int L, int K) {
  return B <= 0 || T <= 0 || C <= 0 || C % CH != 0 || L <= 0 || K <= 0 ||
         K % 2 == 0;
}

}  // namespace

// One stack call: 2*L launches on `stream`.  h and z are [B, T, C] scratch
// allocated by the caller; out is the skip sum.
extern "C" int wavenet_stack_fwd(const float* x, const float* mask,
                                 const float* w_in, const float* g_all,
                                 const float* w_rs, const float* b_rs,
                                 float* out, float* h, float* z, int B, int T,
                                 int C, int L, int K, cudaStream_t stream) {
  if (bad_args(B, T, C, L, K)) return (int)cudaErrorInvalidValue;
  const size_t smem_a = gate_smem(C, K), smem_b = res_skip_smem(C);
  if (smem_a > 232448 || smem_b > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wavenet_gate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(wavenet_res_skip_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TM - 1) / TM, C / CH, B);
  const size_t c2 = 2 * (size_t)C;
  for (int l = 0; l < L; ++l) {
    const float* h_src = l == 0 ? x : h;
    wavenet_gate_kernel<<<grid, NTHREADS, smem_a, stream>>>(
        h_src, w_in + (size_t)l * K * C * c2, g_all + l * c2, (int)(L * c2),
        z, T, C, K);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    wavenet_res_skip_kernel<<<grid, NTHREADS, smem_b, stream>>>(
        z, w_rs + (size_t)l * C * c2, b_rs + l * c2, h_src, h, mask, out, T,
        C, l == 0, l == L - 1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Registers, dynamic shared memory and resident blocks per SM of kernel i
// (0 gate, 1 res/skip) at channel width C and kernel size K; its name into
// name[0:n).  Returns a cudaError_t, or -1 past the end.
extern "C" int wavenet_stack_info(int i, int C, int K, char* name, int n,
                                  int* regs, int* smem, int* blocks) {
  if (i == 0)
    return kernel_info((const void*)wavenet_gate_kernel, "wavenet_gate_kernel",
                       NTHREADS, gate_smem(C, K), name, n, regs, smem, blocks);
  if (i == 1)
    return kernel_info((const void*)wavenet_res_skip_kernel,
                       "wavenet_res_skip_kernel", NTHREADS, res_skip_smem(C),
                       name, n, regs, smem, blocks);
  return -1;
}
