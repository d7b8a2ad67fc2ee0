// FACADE step 2c on Hopper: mean cross-entropy of every candidate head of
// every node, over the node's cached core features, in one launch.
//
// Replaces the TPU kernel src/repro/kernels/head_select/kernel.py ::
// head_select_losses (body _kernel), adding a leading node axis:
//   feats [n, T, D], heads [n, K, D, V], labels [n, T] int32 (< 0: excluded)
//   -> out [n, K] fp32, the mean NLL over valid tokens, denominator
//      max(valid, 1) (the TPU wrapper ops.py::facade_head_losses divides
//      the kernel's sums the same way).
// Inputs fp32 or bf16; every product and sum is accumulated in fp32.
//
// Design. One block per (node, head); its warps take tokens in turn. For a
// token, the warp walks the vocabulary in chunks of 32 columns, one column
// per lane: each lane forms its logit as an fp32 dot over D (the feature
// value is the same address for all lanes, a broadcast; the head row is 32
// consecutive columns, a coalesced read), and the warp folds the chunk into
// an online max / sum-exp / gold-logit triple with butterfly shuffles. The
// in-block loop over chunks takes the place of the TPU's sequential vocab
// grid axis, and the [T, V] logits never leave registers. Any D and V work:
// the ragged last chunk is masked, with no padding and no V % block rule.
// Per-warp sums and counts are combined by one thread in warp order, with
// no atomics, so the result is deterministic: two bit-identical heads give
// bit-identical losses, and an argmin then picks the lower index.
//
// Bound on this card. At the main path's shapes (n = 32, K = 2, T = 8,
// D = 513, V = 10, fp32) the kernel reads 1.84 MB (heads 1.31 MB, features
// 0.53 MB) and does 5.3 MFLOP: about 0.55 us of HBM traffic at 3.35 TB/s
// and less of fp32 arithmetic, so the launch itself bounds it. The simple
// lane-per-column layout leaves 22 of 32 lanes idle at V = 10; packing
// several tokens into a warp is the first step when the time matters.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
head_losses_kernel(const T* __restrict__ feats, const T* __restrict__ heads,
                   const int32_t* __restrict__ labels,
                   float* __restrict__ out, int k, int t, int d, int v) {
  const int node = blockIdx.x / k;
  const int head = blockIdx.x % k;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* f_node = feats + static_cast<size_t>(node) * t * d;
  const T* w = heads + (static_cast<size_t>(node) * k + head) *
                           static_cast<size_t>(d) * v;
  const int32_t* lab = labels + static_cast<size_t>(node) * t;

  // the butterfly reductions leave every lane with the same values
  float nll_sum = 0.f;
  float n_valid = 0.f;
  for (int tok = warp; tok < t; tok += kWarps) {
    const int y = lab[tok];
    if (y < 0) continue;  // uniform across the warp
    const T* f = f_node + static_cast<size_t>(tok) * d;
    float m = -INFINITY, s = 0.f, gold = 0.f;
    for (int v0 = 0; v0 < v; v0 += 32) {
      const int col = v0 + lane;
      float z = -INFINITY;
      if (col < v) {
        const T* wc = w + col;
        float acc = 0.f;
        for (int i = 0; i < d; ++i)
          acc = fmaf(to_f32(f[i]), to_f32(wc[static_cast<size_t>(i) * v]),
                     acc);
        z = acc;
      }
      const float m_new = fmaxf(m, warp_max(z));
      const float e = col < v ? expf(z - m_new) : 0.f;
      s = s * expf(m - m_new) + warp_sum(e);
      gold += warp_sum(col == y ? z : 0.f);
      m = m_new;
    }
    nll_sum += m + logf(s) - gold;
    n_valid += 1.f;
  }

  __shared__ float part_nll[kWarps];
  __shared__ float part_cnt[kWarps];
  if (lane == 0) {
    part_nll[warp] = nll_sum;
    part_cnt[warp] = n_valid;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f, count = 0.f;
    for (int i = 0; i < kWarps; ++i) {  // fixed order: deterministic
      total += part_nll[i];
      count += part_cnt[i];
    }
    out[blockIdx.x] = total / fmaxf(count, 1.f);
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int hs_head_losses(const void* feats, const void* heads,
                              const void* labels, void* out, int n, int k,
                              int t, int d, int v, int dtype, void* stream) {
  const dim3 grid(static_cast<unsigned>(n) * static_cast<unsigned>(k));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    head_losses_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const float*>(heads),
        lab, o, k, t, d, v);
  } else if (dtype == 1) {
    head_losses_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(feats),
        static_cast<const __nv_bfloat16*>(heads), lab, o, k, t, d, v);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
