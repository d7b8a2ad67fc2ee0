// The RWKV6 wkv recurrence on Hopper, from a zero state: the time mixing of
// every RWKV layer at prefill and forward.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py :: wkv_kernel
// (body _kernel):
//   r, k, v, w [B, S, H, hd] fp32, u [H, hd] fp32
//   -> y [B, S, H, hd] fp32 and the final state [B, H, hd, hd] fp32, with
//   y_t[j] = sum_i r_t[i] S[i][j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//   (S read before the update) and then S[i][j] <- w_t[i] S[i][j] +
//   k_t[i] v_t[j]. hd in {32, 64} (a template parameter); any S, with no
//   block_t rule (the TPU kernel asserted S % block_t == 0).
//
// Design. One block of hd threads per (b, h). Thread j keeps column j of
// the state in hd registers for the whole sequence, so the state never
// touches memory until the end (the TPU kernel kept it in VMEM scratch
// across its sequential time grid; here one in-block loop over time takes
// the place of that grid axis). Each step, thread j stages r_t[j], k_t[j],
// w_t[j] and r_t[j] u[j] k_t[j] in shared memory (double-buffered, so one
// barrier per step suffices) and loads step t + 1's inputs while it works
// on step t; every thread then reads the staged vectors as broadcasts.
//
// Bound on this card. At rwkv6-1.6b's serving shape (B 4, S 512, H 32,
// hd 64) the kernel moves 86 MB (r, k, v, w and y, 16.8 MB each, and the
// 2.1 MB state), about 26 us at 3.35 TB/s. But the S steps depend on one
// another: each is a chain of shared-memory reads and fp32 FMAs across the
// block and a barrier, some hundreds of cycles, so the serial latency of
// 512 steps (near 100 us) bounds it more tightly than the bytes, and only
// B * H = 128 blocks of 64 threads are in flight, one per SM. Splitting the
// sequence into chunks (the chunked form of the recurrence) is the way past
// that floor.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int HD>
__global__ void __launch_bounds__(HD)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_out, int s, int h) {
  __shared__ float sr[2][HD], sk[2][HD], sw[2][HD], sb[2][HD];
  const int b = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int j = threadIdx.x;
  const size_t step = static_cast<size_t>(h) * HD;   // between positions
  const size_t base = static_cast<size_t>(b) * s * step + hh * HD + j;
  const float uj = u[hh * HD + j];

  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i] = 0.f;

  float rj = 0.f, kj = 0.f, vj = 0.f, wj = 0.f;
  if (s > 0) {
    rj = r[base];
    kj = k[base];
    vj = v[base];
    wj = w[base];
  }
  for (int t = 0; t < s; ++t) {
    const int buf = t & 1;
    sr[buf][j] = rj;
    sk[buf][j] = kj;
    sw[buf][j] = wj;
    sb[buf][j] = rj * uj * kj;
    const float vt = vj;
    __syncthreads();
    if (t + 1 < s) {  // next step's inputs, in flight during this step
      const size_t nx = base + (t + 1) * step;
      rj = r[nx];
      kj = k[nx];
      vj = v[nx];
      wj = w[nx];
    }
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    float bonus[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      acc[i % 4] = fmaf(sr[buf][i], st[i], acc[i % 4]);
      bonus[i % 4] += sb[buf][i];
      st[i] = fmaf(sw[buf][i], st[i], sk[buf][i] * vt);
    }
    y[base + t * step] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                         ((bonus[0] + bonus[1]) + (bonus[2] + bonus[3])) * vt;
  }

  float* so = s_out + static_cast<size_t>(blockIdx.x) * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) so[i * HD] = st[i];
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 when the launch was accepted).
extern "C" int wkv_forward(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* y,
                           void* s_out, int b, int s, int h, int hd,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(h));
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(s_out);
  if (hd == 32) {
    wkv_kernel<32><<<grid, 32, 0, st>>>(rf, kf, vf, wf, uf, yf, sf, s, h);
  } else if (hd == 64) {
    wkv_kernel<64><<<grid, 64, 0, st>>>(rf, kf, vf, wf, uf, yf, sf, s, h);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
