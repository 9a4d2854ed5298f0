// Zero padding of the widths the other kernels take, and its inverse, for
// sm_90a: float32 or bf16, several tensors in one launch.
//
// The TPU kernels take any head width dk <= 128 and any channel count C:
// the JAX package pads each head to one 128-lane slab
// (visinger_tpu/modules/transformer.py:92-103, the emb tables at
// visinger_tpu/ops/pallas/attention_kernel.py:342-345) and K2's channels to
// a multiple of 128 (visinger_tpu/ops/pallas/wavenet_kernel.py:140-166),
// each gate half on its own.  K1 and K3 (rel_attention.cu,
// rel_attention_bf16.cu) take dk in multiples of 8, K2 (wavenet_stack.cu)
// C in multiples of 32, so for other widths the wrappers pad to the next
// multiple here, run the kernel on the padded tensors and cut the results
// back.  Zero columns change no result: a zero head column adds 0 to every
// q.k and q.emb_rel_k product and gives a zero output column (the softmax
// scale stays the real dk^-0.5, the row statistics and the dropout hash do
// not depend on dk); a zero channel gets a zero gate input in both halves,
// tanh(0) * sigmoid(0) = 0, and zero res/skip weights keep it at 0.
//
// One job is a tensor viewed as [A, R, G, D] padded to [A, Rp, G, Dp] with
// zeros (rows R -> Rp, each of the G groups' widths D -> Dp), or the
// inverse, which keeps the first R rows and D columns:
//   heads of q, k, v, g, out [B, T, H*dk]  A = B*T, R = 1, G = H, D = dk
//   emb tables [2w+1, dk]                  A = 2w+1, R = 1, G = 1, D = dk
//   K2's x [B, T, C]                       A = B*T, R = 1, G = 1, D = C
//   K2's w_in [L, K, C, 2C]                A = L*K, R = C, G = 2, D = C
//   K2's w_rs [L, C, 2C]                   A = L, R = C, G = 2, D = C
//   K2's biases [.., 2C]                   A = rows, R = 1, G = 2, D = C
// Up to MAX_JOBS jobs run in one launch, blockIdx.y the job.
//
// Bound on the H100: bytes, each input element read once and each output
// element written once at 3.35 TB/s; no arithmetic beyond the indices.
// Design: one thread an output element, consecutive threads on consecutive
// elements (coalesced writes; the reads are coalesced along D), 32-bit
// indices (the host refuses a job of 2^31 elements or more), a grid-stride
// loop over at most 16 blocks per SM.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_JOBS = 8;
constexpr int NTHREADS = 256;

struct Job {
  const void* src;
  void* dst;
  uint32_t n;                   // elements of dst
  uint32_t rows, src_rows;      // R of dst and of src (one is Rp)
  uint32_t width, src_width;    // D of dst and of src (one is Dp)
  uint32_t groups;              // G
  int elem;                     // bytes: 4 (float32) or 2 (bf16)
};

struct Jobs {
  Job job[MAX_JOBS];
};

template <typename T>
__device__ __forceinline__ void copy_job(const Job& j) {
  const T* __restrict__ src = (const T*)j.src;
  T* __restrict__ dst = (T*)j.dst;
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < j.n;
       i += stride) {
    const uint32_t d = i % j.width;
    uint32_t t = i / j.width;
    const uint32_t g = t % j.groups;
    t /= j.groups;
    const uint32_t r = t % j.rows, a = t / j.rows;
    T v = 0;  // all-zero bits: +0.0 in float32 and in bf16
    if (r < j.src_rows && d < j.src_width)
      v = src[((a * j.src_rows + r) * j.groups + g) * j.src_width + d];
    dst[i] = v;
  }
}

__global__ void __launch_bounds__(NTHREADS) pad_pack_kernel(Jobs jobs) {
  const Job j = jobs.job[blockIdx.y];
  if (j.elem == 4)
    copy_job<uint32_t>(j);
  else
    copy_job<uint16_t>(j);
}

}  // namespace

// n_jobs jobs on `stream`: job i copies src[i] into dst[i], both
// contiguous, with dims[5 i .. 5 i + 4] = (R, Rp, G, D, Dp) and elem[i]
// bytes per element; unpack = 0 pads [A, R, G, D] -> [A, Rp, G, Dp],
// unpack = 1 cuts [A, Rp, G, Dp] -> [A, R, G, D].  a[i] is A.  Returns a
// cudaError_t.
extern "C" int pad_pack(int n_jobs, const void* const* src,
                        void* const* dst, const long long* a, const int* dims,
                        const int* elem, int unpack, cudaStream_t stream) {
  if (n_jobs <= 0 || n_jobs > MAX_JOBS) return (int)cudaErrorInvalidValue;
  Jobs jobs = {};
  long long most = 0;
  for (int i = 0; i < n_jobs; ++i) {
    const int* d = dims + 5 * i;
    const long long r = d[0], rp = d[1], g = d[2], w = d[3], wp = d[4];
    if (a[i] <= 0 || r <= 0 || rp < r || g <= 0 || w <= 0 || wp < w ||
        (elem[i] != 2 && elem[i] != 4))
      return (int)cudaErrorInvalidValue;
    const long long n_pad = a[i] * rp * g * wp;
    if (n_pad >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    Job& j = jobs.job[i];
    j.src = src[i];
    j.dst = dst[i];
    j.groups = (uint32_t)g;
    j.elem = elem[i];
    j.rows = (uint32_t)(unpack ? r : rp);
    j.src_rows = (uint32_t)(unpack ? rp : r);
    j.width = (uint32_t)(unpack ? w : wp);
    j.src_width = (uint32_t)(unpack ? wp : w);
    j.n = (uint32_t)(a[i] * j.rows * g * j.width);
    if (j.n > most) most = j.n;
  }
  int sms = 132;
  int device = 0;
  if (cudaGetDevice(&device) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (most + NTHREADS - 1) / NTHREADS;
  if (blocks > 16LL * sms) blocks = 16LL * sms;
  if (blocks < 1) blocks = 1;
  pad_pack_kernel<<<dim3((unsigned)blocks, n_jobs), NTHREADS, 0, stream>>>(
      jobs);
  return (int)cudaGetLastError();
}
