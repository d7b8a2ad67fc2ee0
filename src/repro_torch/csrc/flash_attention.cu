// Causal (optionally sliding-window) GQA attention over a full sequence on
// Hopper: the prefill and forward attention of the language models.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// flash_attention (body _attn_kernel):
//   q [B, S, Hq, D], k/v [B, S, Hkv, D] (the model's layout; the TPU
//   kernel takes [B, H, S, D]), positions arange(S)
//   -> o [B, S, Hq, D] in q's dtype; query head h reads kv head
//      h / (Hq / Hkv), with no repeated k/v.
// Inputs fp32 or bf16; D in {32, 64, 128} (a template parameter). Scores,
// the running max and sum and the accumulator are fp32; masked scores are
// -1e30 as in the reference, and the row sum is clamped at 1e-30.
//
// Design. One block of 256 threads per (b * Hq + h, tile of 64 query rows).
// The block stages its query tile in shared memory as fp32, then walks the
// key/value tiles of 64 rows that the causal and window limits leave (fully
// masked tiles are skipped). For each tile the threads form a 16 x 16 grid:
// thread (ty, tx) computes the scores of rows ty + 16i and columns
// tx + 16j (i, j < 4) from shared memory, the 16 threads of a row fold them
// into the online max and sum with shuffles, the probabilities go to shared
// memory, and each thread adds P V to its rows' D / 16 output columns
// tx + 16n, held in registers. Rows are padded by one float so that the
// column-wise reads hit distinct banks. The block masks the ragged tail
// itself (rows and keys at or past S), so any S works: the TPU kernel's
// n_q = S / block_q dropped the rows of a last partial tile.
//
// Bound on this card. At llama3.2-1b's serving shape (B 4, S 512, Hq 32,
// Hkv 8, D 64, bf16) the kernel moves 21 MB (q and o 8.4 MB each, k and v
// 2.1 MB each), about 6.3 us at 3.35 TB/s, and does about 2 B Hq S^2 D =
// 4.3 GFLOP (the causal half of the 4 B Hq S^2 D of the full products),
// about 4.3 us on the bf16 tensor cores. This first kernel runs its
// products on the fp32 FMA units (67 TFLOP/s, so at least 64 us), reading
// both operands from shared memory: it is bound by the FMA and shared-memory
// issue rate, not by memory. mma / wgmma tiles for bf16 are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key rows per tile
constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (static_cast<size_t>(kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 1));
}

// the 16 threads of a row are lanes 0-15 or 16-31 of one warp
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ bool visible(int qp, int kp, int s, int causal,
                                        int window) {
  return kp < s && (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int s, int hq, int hkv,
          int causal, int window, float scale) {
  constexpr int LD = D + 1;     // padded row stride of the q, k, v tiles
  constexpr int LP = kBK + 1;   // padded row stride of the probabilities
  constexpr int NC = D / 16;    // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;             // [kBQ][LD]
  float* sk = sq + kBQ * LD;    // [kBK][LD]
  float* sv = sk + kBK * LD;    // [kBK][LD]
  float* sp = sv + kBK * LD;    // [kBQ][LP]

  const int b = blockIdx.y / hq;
  const int h = blockIdx.y % hq;
  const int hk = h / (hq / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int tid = threadIdx.x;
  const int ty = tid / 16;
  const int tx = tid % 16;
  const size_t q_step = static_cast<size_t>(hq) * D;    // between positions
  const size_t kv_step = static_cast<size_t>(hkv) * D;
  const T* qb = q + static_cast<size_t>(b) * s * q_step + h * D;
  const T* kb = k + static_cast<size_t>(b) * s * kv_step + hk * D;
  const T* vb = v + static_cast<size_t>(b) * s * kv_step + hk * D;
  T* ob = o + static_cast<size_t>(b) * s * q_step + h * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    sq[r * LD + c] = row < s ? to_f32(qb[row * q_step + c]) : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
  }

  const int kv_end = causal ? min(s, q0 + kBQ) : s;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  for (int k0 = kv_begin; k0 < kv_end; k0 += kBK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const int row = k0 + r;
      const bool in = row < s;
      sk[r * LD + c] = in ? to_f32(kb[row * kv_step + c]) : 0.f;
      sv[r * LD + c] = in ? to_f32(vb[row * kv_step + c]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sq[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sk[(tx + 16 * j) * LD + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        sc[i][j] = visible(qp, kp, s, causal, window) ? sc[i][j] * scale
                                                      : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = visible(qp, kp, s, causal, window)
                            ? expf(sc[i][j] - m_new) : 0.f;
        sp[(ty + 16 * i) * LP + tx + 16 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NC; ++n) acc[i][n] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4], va[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sp[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int n = 0; n < NC; ++n) va[n] = sv[kk * LD + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(pa[i], va[n], acc[i][n]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float li = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < NC; ++n)
      put(ob + row * q_step + tx + 16 * n, acc[i][n] / li);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int s, int hq, int hkv, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool ready = false;   // the attribute is set once per instance
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((s + kBQ - 1) / kBQ, static_cast<unsigned>(b * hq));
  fa_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), s, hq, hkv, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int b, int s, int hq, int hkv, int d, int causal,
                     int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, s, hq, hkv, causal, window, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, s, hq, hkv, causal, window, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, s, hq, hkv, causal, window, scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Launches on `stream`, does not synchronise,
// and returns cudaGetLastError() (0 when the launch was accepted).
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* o, int b, int s, int hq, int hkv, int d,
                          int causal, int window, int dtype, float scale,
                          void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || b * hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch<float>(q, k, v, o, b, s, hq, hkv, d, causal, window,
                          scale, st);
  } else if (dtype == 1) {
    err = dispatch<__nv_bfloat16>(q, k, v, o, b, s, hq, hkv, d, causal,
                                  window, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
