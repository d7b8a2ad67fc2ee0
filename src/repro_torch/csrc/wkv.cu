// The RWKV6 wkv recurrence on Hopper, from a zero state: the time mixing of
// every RWKV layer at prefill and forward.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py :: wkv_kernel
// (body _kernel):
//   r, k, v, w [B, S, H, hd] fp32, u [H, hd] fp32
//   -> y [B, S, H, hd] fp32 and the final state [B, H, hd, hd] fp32, with
//   y_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   (S read before the update) and then S[i][j] <- w_t[i] S[i][j] +
//   k_t[i] v_t[j]. hd in {32, 64} (a template parameter); any S, with no
//   block_t rule (the TPU kernel asserted S % block_t == 0).
//
// Design. The sequential form, in fp32 (the chunked form would put its
// intra-chunk products on the tensor cores only in TF32, which the 1e-5
// check on y and the state rules out). One block of hd / 4 warps per
// (b, h): warp g owns state rows 4g .. 4g + 3, lane l columns (hd / 32) l
// and on, held in registers for the whole sequence (the TPU kernel kept
// the state in VMEM scratch across its sequential time grid; here one
// in-block loop over time takes the place of that grid axis). Each step a
// thread adds its rows' part of y_j, sum_{i in g} r_i S_ij + b_g v_j, with
// the group's bonus b_g = sum_{i in g} r_i u_i k_i folded in, and updates
// its rows, S_ij <- w_i S_ij + k_i v_j: 3 fp32 instructions per element.
// - r, k, w and v for the next chunk of kTc steps come into a ring of
//   kStages chunks in shared memory by 16-byte cp.async copies (a step's hd
//   floats of each are contiguous, steps H * hd apart), issued a chunk
//   ahead, so global latency is paid once per chunk, not once per step.
// - A warp's lanes all read the same 4 rows of r, k and w: one float4
//   broadcast each per step. (A layout with the row groups of a column in
//   one warp, summed by shuffles, read several rows per float4 and took
//   1.7 times as long.)
// - After a chunk lands, each warp forms its steps' bonuses (shuffle sums
//   over 4 lanes). The parts of y go to shared memory; after the next
//   chunk's first barrier the block sums them in group order and writes y
//   with 16-byte stores. Two barriers per chunk, none per step. The final
//   state is written once at the end.
//
// Bound on this card. At rwkv6-1.6b's serving shape (B 4, S 512, H 32,
// hd 64) the kernel moves 86 MB (r, k, v, w and y, 16.8 MB each, and the
// 2.1 MB state), 25.7 us at 3.35 TB/s. The work is 5 B S H hd^2 = 1.34
// GFLOP in fp32 (20 us at 67 TFLOP/s). The steps of one (b, h) depend on
// one another, so the B * H = 128 blocks each hold one SM: each step is
// 3 hd^2 fp32 instructions over the SM's 128 lanes, 96 issue cycles, an
// issue floor near 25 us at 1.98 GHz, about the byte bound. What bounds
// the kernel now is the rest of each step's instructions (the shared
// broadcasts, the parts' stores, the loop) and their latency in the 16
// warps of one block: about 3.5 times the issue floor.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;       // state rows per thread (and per warp)
constexpr int kTc = 16;        // steps per chunk
constexpr int kStages = 2;     // chunks in the ring

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int HD>
struct Layout {
  static constexpr int kCols = HD / 32;           // state columns per lane
  static constexpr int kWarps = HD / kRows;       // one row group each
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kStep = 4 * HD;            // r, k, w, v of one step
  static constexpr int kRing = kStages * kTc * kStep;
  static constexpr int kParts = kTc * kWarps * HD;    // y parts of a chunk
  static constexpr int kBonus = kTc * kWarps;
  static constexpr size_t kBytes =
      sizeof(float) * static_cast<size_t>(kRing + kParts + kBonus);
};

// Chunk c of r, k, w and v (steps c * kTc on) into ring stage c % kStages.
template <int HD>
__device__ __forceinline__ void load_chunk(
    float* ring, const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ w, const float* __restrict__ v, size_t base,
    size_t step, int s, int c, int tid) {
  using L = Layout<HD>;
  constexpr int kQuads = HD / 4;      // 16-byte pieces of one vector
  const int t0 = c * kTc;
  const int n = min(kTc, s - t0);
  float* stage = ring + (c % kStages) * kTc * L::kStep;
  for (int i = tid; i < n * 4 * kQuads; i += L::kThreads) {
    const int t = i / (4 * kQuads);
    const int which = (i / kQuads) % 4;
    const int e = (i % kQuads) * 4;   // first element of the piece
    const float* src = which == 0 ? r : which == 1 ? k : which == 2 ? w : v;
    cp_async16(smem_addr(stage + t * L::kStep + which * HD + e),
               src + base + (t0 + t) * step + e);
  }
}

// y of chunk c: the sum of its row groups' parts, in group order, written
// to global memory 16 bytes a store.
template <int HD>
__device__ __forceinline__ void store_chunk(const float* parts,
                                            float* __restrict__ y,
                                            size_t base, size_t step, int s,
                                            int c, int tid) {
  using L = Layout<HD>;
  constexpr int kQuads = HD / 4;
  const int t0 = c * kTc;
  const int n = min(kTc, s - t0);
  for (int i = tid; i < n * kQuads; i += L::kThreads) {
    const int t = i / kQuads;
    const int e = (i % kQuads) * 4;
    const float* src = parts + t * L::kWarps * HD + e;
    float4 acc = *reinterpret_cast<const float4*>(src);
#pragma unroll
    for (int g = 1; g < L::kWarps; ++g) {
      const float4 x = *reinterpret_cast<const float4*>(src + g * HD);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    *reinterpret_cast<float4*>(y + base + (t0 + t) * step + e) = acc;
  }
}

// The bonus of each step of a chunk and each row group, sum over the
// group's rows of r u k: warp q takes steps q, q + kWarps, ...; lane l
// rows l + 32 i, summed over the group's lanes by shuffles.
template <int HD>
__device__ __forceinline__ void chunk_bonus(const float* stage,
                                            const float (&ul)[HD / 32],
                                            float* bonus, int n, int warp,
                                            int lane) {
  using L = Layout<HD>;
  for (int t = warp; t < n; t += L::kWarps) {
    const float* sp = stage + t * L::kStep;
#pragma unroll
    for (int i = 0; i < HD / 32; ++i) {
      float x = sp[lane + 32 * i] * ul[i] * sp[HD + lane + 32 * i];
#pragma unroll
      for (int o = 1; o < kRows; o <<= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane % kRows == 0)
        bonus[t * L::kWarps + (lane + 32 * i) / kRows] = x;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::kThreads)
wkv_kernel(const float* __restrict__ r, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ w,
           const float* __restrict__ u, float* __restrict__ y,
           float* __restrict__ s_out, int s, int h) {
  using L = Layout<HD>;
  constexpr int C = L::kCols;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // [kStages][kTc][kStep]
  float* parts = ring + L::kRing;                  // [kTc][kWarps][HD]
  float* bonus = parts + L::kParts;                // [kTc][kWarps]
  const int b = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int tid = threadIdx.x;
  const int warp = tid / 32;        // row group: rows kRows warp ..
  const int lane = tid % 32;        // columns C lane ..
  const int row0 = warp * kRows;
  const int col0 = lane * C;
  const size_t step = static_cast<size_t>(h) * HD;   // between positions
  const size_t base = static_cast<size_t>(b) * s * step + hh * HD;

  float ul[C];                      // u at rows lane + 32 i, for the bonus
#pragma unroll
  for (int i = 0; i < C; ++i) ul[i] = u[hh * HD + lane + 32 * i];
  float st[kRows][C];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) st[m][c] = 0.f;

  const int n_chunks = (s + kTc - 1) / kTc;
#pragma unroll
  for (int ch = 0; ch < kStages - 1; ++ch) {
    if (ch < n_chunks)
      load_chunk<HD>(ring, r, k, w, v, base, step, s, ch, tid);
    cp_async_commit();
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<kStages - 2>();   // chunk ch has landed
    __syncthreads();      // for every thread, and chunk ch - 1 is done with
    if (ch + kStages - 1 < n_chunks)
      load_chunk<HD>(ring, r, k, w, v, base, step, s, ch + kStages - 1,
                     tid);
    cp_async_commit();
    if (ch > 0) store_chunk<HD>(parts, y, base, step, s, ch - 1, tid);
    const float* stage = ring + (ch % kStages) * kTc * L::kStep;
    const int n = min(kTc, s - ch * kTc);
    chunk_bonus<HD>(stage, ul, bonus, n, warp, lane);
    __syncthreads();      // the bonuses are in; the parts of ch - 1 are out
#pragma unroll 2
    for (int t = 0; t < n; ++t) {
      const float* sp = stage + t * L::kStep;
      const float4 rr = *reinterpret_cast<const float4*>(sp + row0);
      const float4 kk = *reinterpret_cast<const float4*>(sp + HD + row0);
      const float4 ww = *reinterpret_cast<const float4*>(sp + 2 * HD + row0);
      const float ra[kRows] = {rr.x, rr.y, rr.z, rr.w};
      const float ka[kRows] = {kk.x, kk.y, kk.z, kk.w};
      const float wa[kRows] = {ww.x, ww.y, ww.z, ww.w};
      float vv[C], part[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vv[c] = sp[3 * HD + col0 + c];
      const float bo = bonus[t * L::kWarps + warp];
#pragma unroll
      for (int c = 0; c < C; ++c) part[c] = bo * vv[c];
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          part[c] = fmaf(ra[m], st[m][c], part[c]);
          st[m][c] = fmaf(wa[m], st[m][c], ka[m] * vv[c]);
        }
      float* dst = parts + (t * L::kWarps + warp) * HD + col0;
#pragma unroll
      for (int c = 0; c < C; ++c) dst[c] = part[c];
    }
  }
  __syncthreads();
  if (n_chunks > 0)
    store_chunk<HD>(parts, y, base, step, s, n_chunks - 1, tid);

  float* so = s_out + static_cast<size_t>(blockIdx.x) * HD * HD +
              static_cast<size_t>(row0) * HD + col0;
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c) so[m * HD + c] = st[m][c];
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, float* y, float* s_out,
                   int b, int s, int h, cudaStream_t stream) {
  using L = Layout<HD>;
  static bool ready = false;   // the attribute is set once per instance
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(h));
  wkv_kernel<HD><<<grid, L::kThreads, L::kBytes, stream>>>(r, k, v, w, u, y,
                                                           s_out, s, h);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (0 when the launch was accepted). Every pointer but u is 16-byte aligned.
extern "C" int wkv_forward(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* y,
                           void* s_out, int b, int s, int h, int hd,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* rf = static_cast<const float*>(r);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* wf = static_cast<const float*>(w);
  const float* uf = static_cast<const float*>(u);
  float* yf = static_cast<float*>(y);
  float* sf = static_cast<float*>(s_out);
  cudaError_t err;
  if (hd == 32) {
    err = launch<32>(rf, kf, vf, wf, uf, yf, sf, b, s, h, st);
  } else if (hd == 64) {
    err = launch<64>(rf, kf, vf, wf, uf, yf, sf, b, s, h, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* wkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
