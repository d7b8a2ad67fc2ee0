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
// Design. One block per (node, head); its 8 warps take tokens in turn, one
// token a warp in each round. The block walks the vocabulary in chunks of
// kChunk = 16 columns (the last one masked at V, so any V works and V = 10
// is one chunk) and D in tiles of up to 544 rows (D = 513 is one tile). D
// is split over the lanes: lane l takes rows d = l, l + 32, ... of a tile
// and keeps the chunk's 16 partial logits in registers, 16 independent FMA
// chains, each in the order of d. The head's [544 x 16] tile and each
// warp's token's features of the tile are staged in shared memory, all
// copies in flight at once (cp.async in fp32), one round trip to L2: the
// warps all read the whole tile, and read through L1 instead the 32 lanes
// of a load would fetch one column of 32 rows, 10 distinct 128-byte lines
// at V = 10 and 32 at V >= 32. A staged head row is 20 words, so a lane's
// 16-byte reads of its row hit distinct bank quads in each quarter warp.
// The features stay staged over the chunks while D is one tile. Loops are
// kept rolled: at the FACADE path's shape each block runs its code about
// once, and a fully unrolled body costs more in instruction fetch than it
// saves. A transposing halving reduction (8 + 4 + 2 + 1 + 1 = 16 shuffles)
// then leaves column c's total on lanes 2c and 2c + 1, and the warp folds
// the chunk into an online max / sum-exp / gold-logit triple with 4-step
// butterflies over the lane pairs. The in-block loop over chunks takes the
// place of the TPU's sequential vocab grid axis, and the [T, V] logits
// never leave registers. Global reads are 4 bytes (2 in bf16): at D = 513,
// V = 10 a feature row starts every 2,052 bytes and a head row every 40, so
// neither is 16-byte aligned throughout, and no read passes a row or a
// tensor. Per-warp sums and counts are combined by one thread in warp
// order, with no atomics, and every sum runs in a fixed order, so two
// bit-identical heads give bit-identical losses and an argmin then picks
// the lower index.
//
// Bound on this card. At the main path's shapes (n = 32, K = 2, T = 8,
// D = 513, V = 10, fp32) the kernel reads 1.84 MB (heads 1.31 MB, features
// 0.53 MB) and does 5.3 MFLOP: about 0.55 us of HBM traffic at 3.35 TB/s
// and less of fp32 arithmetic, so at that size the launch itself bounds it.
// In the LM regime (V of 65k-128k) the K x T x D x V products dominate and
// want tensor-core tiles; this kernel is correct there but not built for it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;     // vocab columns per pass, one register each
constexpr int kTileRows = 544;  // head rows staged at once, 17 a lane
constexpr int kPitch = kChunk + 4;  // words per staged head row
constexpr int kHeadWords = kTileRows * kPitch;
constexpr size_t kSmemBytes =
    sizeof(float) * (kHeadWords + kWarps * kTileRows);  // 60,928
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// dst = valid ? *src : 0 into shared memory. In fp32 an asynchronous
// 4-byte copy (cp.async; zero-filled when !valid), completed by
// stage_wait(); in bf16 a load, a conversion and a store.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, bool valid) {
  if constexpr (std::is_same_v<T, float>) {
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to),
                 "l"(src), "r"(valid ? 4 : 0));
  } else {
    *dst = valid ? to_f32(*src) : 0.f;
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One step of the transposing halving reduction: a lane keeps N of its 2N
// partial columns (the upper half where lane & 2N is set), hands the other
// N to lane ^ 2N and adds what that lane hands back.
template <int N>
__device__ __forceinline__ void fold_columns(float (&acc)[kChunk], int lane) {
  const bool upper = lane & (2 * N);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float keep = upper ? acc[j + N] : acc[j];
    const float send = upper ? acc[j] : acc[j + N];
    acc[j] = keep + __shfl_xor_sync(kFull, send, 2 * N);
  }
  if constexpr (N > 1) fold_columns<N / 2>(acc, lane);
}

// Sums acc[c] over the warp's lanes for each of the kChunk columns and
// returns column (lane >> 1)'s total, equal on lanes 2c and 2c + 1.
__device__ __forceinline__ float column_totals(float (&acc)[kChunk],
                                               int lane) {
  static_assert(kChunk == 16, "the folds take 32 lanes to 16 columns");
  fold_columns<kChunk / 2>(acc, lane);
  return acc[0] + __shfl_xor_sync(kFull, acc[0], 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
head_losses_kernel(const T* __restrict__ feats, const T* __restrict__ heads,
                   const int32_t* __restrict__ labels,
                   float* __restrict__ out, int k, int t, int d, int v) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                                   // [rows][kPitch]
  const int node = blockIdx.x / k;
  const int head = blockIdx.x % k;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* ftile = smem + kHeadWords + warp * kTileRows;  // this warp's token
  const T* f_node = feats + static_cast<size_t>(node) * t * d;
  const T* w = heads + (static_cast<size_t>(node) * k + head) *
                           static_cast<size_t>(d) * v;
  const int32_t* lab = labels + static_cast<size_t>(node) * t;
  // a thread stages column c of rows r0, r0 + 16, ... of each head tile
  const int c = threadIdx.x % kChunk;
  const int r0 = threadIdx.x / kChunk;

  // the butterflies leave every lane with the same values
  float nll_sum = 0.f;
  float n_valid = 0.f;
  for (int tok0 = 0; tok0 < t; tok0 += kWarps) {
    const int tok = tok0 + warp;
    const int y = tok < t ? lab[tok] : -1;  // uniform across the warp
    const T* f = f_node + static_cast<size_t>(min(tok, t - 1)) * d;
    float m = -INFINITY, s = 0.f, gold = 0.f;
    for (int v0 = 0; v0 < v; v0 += kChunk) {
      const int vc = min(kChunk, v - v0);
      float acc[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
      for (int d0 = 0; d0 < d; d0 += kTileRows) {
        const int rows = min(kTileRows, d - d0);
        __syncthreads();  // the previous tile is consumed
        const T* src = w + static_cast<size_t>(d0) * v + v0 + (c < vc ? c : 0);
        for (int r = r0; r < rows; r += kThreads / kChunk)
          stage(tile + r * kPitch + c, src + static_cast<size_t>(r) * v,
                c < vc);
        // tok < t, not y >= 0: the copies need not wait for the label
        if (v0 == 0 || d > kTileRows)  // else staged in an earlier chunk
          for (int r = lane; r < rows; r += 32)
            stage(ftile + r, f + d0 + r, tok < t);
        stage_wait();
        __syncthreads();
        if (y < 0) continue;
#pragma unroll 2
        for (int r = lane; r < rows; r += 32) {
          const float fr = ftile[r];
          const float4* row =
              reinterpret_cast<const float4*>(tile + r * kPitch);
#pragma unroll
          for (int q = 0; q < kChunk / 4; ++q) {
            if (4 * q >= vc) break;  // uniform across the warp
            const float4 h = row[q];
            acc[4 * q] = fmaf(fr, h.x, acc[4 * q]);
            acc[4 * q + 1] = fmaf(fr, h.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(fr, h.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(fr, h.w, acc[4 * q + 3]);
          }
        }
      }
      if (y < 0) continue;
      const int col = lane >> 1;
      const float total = column_totals(acc, lane);
      const float z = col < vc ? total : -INFINITY;
      float zmax = z;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1)
        zmax = fmaxf(zmax, __shfl_xor_sync(kFull, zmax, o));
      const float m_new = fmaxf(m, zmax);
      float e = col < vc ? expf(z - m_new) : 0.f;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) e += __shfl_xor_sync(kFull, e, o);
      s = s * expf(m - m_new) + e;
      m = m_new;
      if (y >= v0 && y < v0 + vc)  // uniform across the warp
        gold = __shfl_sync(kFull, total, 2 * (y - v0));
    }
    if (y >= 0) {
      nll_sum += m + logf(s) - gold;
      n_valid += 1.f;
    }
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

template <typename T>
int launch(const void* feats, const void* heads, const int32_t* labels,
           float* out, int n, int k, int t, int d, int v, cudaStream_t s) {
  // the staging buffers exceed the 48 KB a launch gets without asking
  const cudaError_t attr = cudaFuncSetAttribute(
      head_losses_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(n) * static_cast<unsigned>(k));
  head_losses_kernel<T><<<grid, kThreads, kSmemBytes, s>>>(
      static_cast<const T*>(feats), static_cast<const T*>(heads), labels,
      out, k, t, d, v);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int hs_head_losses(const void* feats, const void* heads,
                              const void* labels, void* out, int n, int k,
                              int t, int d, int v, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(feats, heads, lab, o, n, k, t, d, v, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, heads, lab, o, n, k, t, d, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
