// The backward of the RWKV6 wkv recurrence on Hopper: the gradients of y
// and of the final state with respect to r, k, v, w and u, for training.
//
// Replaces no TPU kernel. The TPU kernel
// src/repro/kernels/rwkv6/kernel.py :: wkv_kernel is forward-only: the
// reference differentiates the recurrence with jax.grad through its
// chunked lax.scan, which keeps the state at each 256-step chunk boundary
// and recomputes inside each chunk under jax.checkpoint
// (src/repro/models/rwkv.py:87-131). The port trains through K3's forward
// (csrc/wkv.cu) and needs the matching gradient on the card
// (kernels/rwkv6/ops.py :: WkvFunction.backward); this kernel is that
// gradient. Without it, the backward was the plain loop recomputed and
// differentiated eagerly: S steps of small launches from the host.
//
// The function. Forward, from S_0 = 0: y_t = r_t (S_{t-1} + diag(u)
// k_t^T v_t), then S_t = diag(w_t) S_{t-1} + k_t^T v_t. Given dy and dS =
// the final state's gradient (or 0), for t = S .. 1, with dS the gradient
// of S_t while step t is walked:
//   dr_t[i] = sum_j dy_t[j] S_{t-1}[i][j] + u[i] k_t[i] a_t,  a_t = dy_t . v_t
//   dk_t[i] = sum_j dS[i][j] v_t[j] + r_t[i] u[i] a_t
//   dv_t[j] = sum_i dS[i][j] k_t[i] + b_t dy_t[j],   b_t = sum_i r_t[i] u[i] k_t[i]
//   dw_t[i] = sum_j dS[i][j] S_{t-1}[i][j]
//   du[i]  += r_t[i] k_t[i] a_t
//   then dS <- diag(w_t) dS + r_t^T dy_t.
// r, k, v, w, dy [B, S, H, hd] fp32, u [H, hd], dS [B, H, hd, hd] or none;
// out dr, dk, dv, dw [B, S, H, hd] and du's partial sums [B, H, hd] (the
// wrapper sums them over b: a fixed order, no atomics, so two calls give
// the same bits). hd in {32, 64} (a template parameter); any S >= 1.
//
// Design. The sweep is sequential in t and independent per (b, h): one
// block per (b, h) with K3's forward layout, hd / 4 warps, warp g owning
// state rows 4g .. 4g + 3 and lane l columns (hd / 32) l and on, so a
// thread holds its elements of S and dS in registers.
// - S_{t-1} in the reverse order is the hard part. Rebuilding it backwards
//   as (S_t - k_t^T v_t) / w_t divides by w, which runs down to near 0, so
//   the kernel keeps states instead, as the reference does: a first sweep
//   forward writes the state at the start of each chunk of kTc steps to a
//   workspace [B, H, ceil(S / kTc), hd, hd] (the wrapper's torch.empty);
//   the second sweep walks the chunks from the last, recomputes a chunk's
//   kTc states forward from its boundary into registers (kTc * 8 floats a
//   thread at hd 64: kTc = 8 there and 16 at hd 32, 64 registers either
//   way), then walks them backward.
// - A chunk's r, k, w, v and dy and its boundary state come into a ring of
//   two stages in shared memory by 16-byte cp.async copies, the next
//   chunk's issued before the current one is walked. No barrier per step.
// - dv sums over rows: each warp adds its 4 rows in registers and leaves
//   its part in shared memory, summed in group order after the chunk, as
//   K3's forward sums y. dk, dw and dr sum over columns, across the warp's
//   lanes: each lane's 12 partial sums (3 gradients x 4 rows, padded to
//   16) are reduced and scattered in 16 shuffles, lane l ending with the
//   sum of value l / 2.
// - The per-step scalars a_t and b_t, the bonus terms and du's sums over
//   t are taken a chunk at a time from the staged inputs; the chunk's four
//   gradients leave in 16-byte stores.
//
// Bound on this card. At the RWKV FACADE round's shape (B 4, S 256, H 32,
// hd 64) the function reads r, k, v, w and dy and writes dr, dk, dv and
// dw, 8.39 MB each: 75.5 MB, 22.5 us at 3.35 TB/s. Its work is 14 B S H
// hd^2 fp32 operations (the state 3 hd^2 a step; dr, dk, dv, dw 2 hd^2
// each; dS 3 hd^2): 1.88 GFLOP, 28.0 us at 67 TFLOP/s, so operations bound
// it. The design does the state twice (its first sweep and the chunk's
// recompute), 17 hd^2 a step, and moves the workspace (16 KB a chunk per
// (b, h)) out and back. As in K3's forward, the steps of one (b, h)
// depend on one another and B * H = 128 blocks hold one SM each, so what
// bounds it in practice is each SM's issue rate over the 16 warps of its
// one block, not the card's peak.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;       // state rows per thread (and per warp)
// the five vectors of one step, in their order in a ring stage
constexpr int kR = 0, kK = 1, kW = 2, kV = 3, kDy = 4, kVectors = 5;

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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int HD>
struct Layout {
  static constexpr int kCols = HD / 32;           // state columns per lane
  static constexpr int kWarps = HD / kRows;       // one row group each
  static constexpr int kThreads = 32 * kWarps;
  // steps a chunk: its states take kTc * kRows * kCols = 64 registers
  static constexpr int kTc = 64 / (kRows * kCols);
  static constexpr int kStep = kVectors * HD;
  static constexpr int kState = HD * HD;
  static constexpr int kStage = kTc * kStep + kState;  // + boundary state
  static constexpr int kRing = 2 * kStage;
  static constexpr int kParts = kTc * kWarps * HD;    // dv parts of a chunk
  static constexpr int kRowOut = kTc * 3 * HD;        // dk, dw, dr sums
  static constexpr int kScal = 2 * kTc;               // a_t, then b_t
  static constexpr size_t kBytes =
      sizeof(float) *
      static_cast<size_t>(kRing + kParts + kRowOut + kScal + HD);
};

// Steps of chunk c, vectors lo .. hi - 1 of each, into `stage`.
template <int HD>
__device__ __forceinline__ void load_steps(
    float* stage, const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ w, const float* __restrict__ v,
    const float* __restrict__ dy, size_t base, size_t step, int s, int c,
    int lo, int hi, int tid) {
  using L = Layout<HD>;
  constexpr int kQuads = HD / 4;      // 16-byte pieces of one vector
  const int t0 = c * L::kTc;
  const int n = min(L::kTc, s - t0);
  const int per = (hi - lo) * kQuads;
  for (int i = tid; i < n * per; i += L::kThreads) {
    const int t = i / per;
    const int which = lo + (i % per) / kQuads;
    const int e = (i % kQuads) * 4;
    const float* src = which == kR   ? r
                       : which == kK ? k
                       : which == kW ? w
                       : which == kV ? v
                                     : dy;
    cp_async16(smem_addr(stage + t * L::kStep + which * HD + e),
               src + base + static_cast<size_t>(t0 + t) * step + e);
  }
}

template <int HD>
__device__ __forceinline__ void load_state(float* dst,
                                           const float* __restrict__ src,
                                           int tid) {
  using L = Layout<HD>;
  for (int i = tid; i < L::kState / 4; i += L::kThreads)
    cp_async16(smem_addr(dst + 4 * i), src + 4 * i);
}

// One step of the state on a thread's elements: to = diag(w) from + k^T v.
template <int HD>
__device__ __forceinline__ void state_step(
    const float (&from)[kRows][HD / 32], float (&to)[kRows][HD / 32],
    const float* sp, int row0, int col0) {
  constexpr int C = HD / 32;
  const float4 kk = *reinterpret_cast<const float4*>(sp + kK * HD + row0);
  const float4 ww = *reinterpret_cast<const float4*>(sp + kW * HD + row0);
  const float ka[kRows] = {kk.x, kk.y, kk.z, kk.w};
  const float wa[kRows] = {ww.x, ww.y, ww.z, ww.w};
  float vv[C];
#pragma unroll
  for (int c = 0; c < C; ++c) vv[c] = sp[kV * HD + col0 + c];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c)
      to[m][c] = fmaf(wa[m], from[m][c], ka[m] * vv[c]);
}

// One halving of a reduce-scatter over the warp: lanes whose bit 2 HALF is
// clear keep values 0 .. HALF - 1, the others HALF .. 2 HALF - 1, each
// summed with the partner lane's.
template <int HALF>
__device__ __forceinline__ void fold(float (&x)[16], int lane) {
  const bool hi = (lane & (2 * HALF)) != 0;
#pragma unroll
  for (int q = 0; q < HALF; ++q) {
    const float send = hi ? x[q] : x[q + HALF];
    const float keep = hi ? x[q + HALF] : x[q];
    x[q] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * HALF);
  }
}

// Each of a lane's 16 values summed over the warp's 32 lanes: lane l
// returns the sum of value l / 2.
__device__ __forceinline__ float reduce_scatter16(float (&x)[16], int lane) {
  fold<8>(x, lane);
  fold<4>(x, lane);
  fold<2>(x, lane);
  fold<1>(x, lane);
  return x[0] + __shfl_xor_sync(0xffffffffu, x[0], 1);
}

// The gradients of the chunk's n steps from t0 on: dk and dr with their
// bonus terms, dw, and dv as its row groups' parts summed in group order
// plus its bonus term; 16 bytes a store.
template <int HD>
__device__ __forceinline__ void store_grads(
    const float* stage, const float* parts, const float* rowout,
    const float* scal, const float* uu, float* __restrict__ dr,
    float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dw,
    size_t base, size_t step, int t0, int n, int tid) {
  using L = Layout<HD>;
  constexpr int kQuads = HD / 4;
  for (int i = tid; i < n * 4 * kQuads; i += L::kThreads) {
    const int t = i / (4 * kQuads);
    const int kind = (i / kQuads) % 4;   // dk, dw, dr, dv
    const int e = (i % kQuads) * 4;
    const float* sp = stage + t * L::kStep;
    const float a = scal[t];
    float4 out;
    float* dst;
    if (kind == 3) {
      const float* src = parts + t * L::kWarps * HD + e;
      out = *reinterpret_cast<const float4*>(src);
#pragma unroll
      for (int g = 1; g < L::kWarps; ++g) {
        const float4 x = *reinterpret_cast<const float4*>(src + g * HD);
        out.x += x.x;
        out.y += x.y;
        out.z += x.z;
        out.w += x.w;
      }
      const float b = scal[L::kTc + t];
      const float4 gy = *reinterpret_cast<const float4*>(sp + kDy * HD + e);
      out.x = fmaf(b, gy.x, out.x);
      out.y = fmaf(b, gy.y, out.y);
      out.z = fmaf(b, gy.z, out.z);
      out.w = fmaf(b, gy.w, out.w);
      dst = dv;
    } else {
      out = *reinterpret_cast<const float4*>(rowout + (t * 3 + kind) * HD + e);
      if (kind != 1) {
        // dk: r u a; dr: u k a
        const float4 x = *reinterpret_cast<const float4*>(
            sp + (kind == 0 ? kR : kK) * HD + e);
        const float4 uq = *reinterpret_cast<const float4*>(uu + e);
        out.x = fmaf(x.x * uq.x, a, out.x);
        out.y = fmaf(x.y * uq.y, a, out.y);
        out.z = fmaf(x.z * uq.z, a, out.z);
        out.w = fmaf(x.w * uq.w, a, out.w);
      }
      dst = kind == 0 ? dk : kind == 1 ? dw : dr;
    }
    *reinterpret_cast<float4*>(dst + base + static_cast<size_t>(t0 + t) *
                                                step + e) = out;
  }
}

template <int HD>
__global__ void __launch_bounds__(Layout<HD>::kThreads)
wkv_backward_kernel(const float* __restrict__ r, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ w,
                    const float* __restrict__ u,
                    const float* __restrict__ dy,
                    const float* __restrict__ ds_final,
                    float* __restrict__ dr, float* __restrict__ dk,
                    float* __restrict__ dv, float* __restrict__ dw,
                    float* __restrict__ du_part, float* __restrict__ ws,
                    int s, int h) {
  using L = Layout<HD>;
  constexpr int C = L::kCols;
  constexpr int kTc = L::kTc;
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // [2][kStage]
  float* parts = ring + L::kRing;                  // [kTc][kWarps][HD]
  float* rowout = parts + L::kParts;               // [kTc][3][HD]
  float* scal = rowout + L::kRowOut;               // a [kTc], b [kTc]
  float* uu = scal + L::kScal;                     // u [HD]
  const int b = blockIdx.x / h;
  const int hh = blockIdx.x % h;
  const int tid = threadIdx.x;
  const int warp = tid / 32;        // row group: rows kRows warp ..
  const int lane = tid % 32;        // columns C lane ..
  const int row0 = warp * kRows;
  const int col0 = lane * C;
  const size_t step = static_cast<size_t>(h) * HD;   // between positions
  const size_t base = static_cast<size_t>(b) * s * step + hh * HD;
  const int n_chunks = (s + kTc - 1) / kTc;
  float* ws_blk = ws + static_cast<size_t>(blockIdx.x) * n_chunks * L::kState;
  for (int i = tid; i < HD; i += L::kThreads) uu[i] = u[hh * HD + i];

  // Sweep 1, forward: the state at each chunk's start into the workspace.
  {
    float st[kRows][C];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
#pragma unroll
      for (int c = 0; c < C; ++c) st[m][c] = 0.f;
    load_steps<HD>(ring, r, k, w, v, dy, base, step, s, 0, kK, kV + 1, tid);
    cp_async_commit();
    for (int ch = 0; ch < n_chunks; ++ch) {
      cp_async_wait_all();    // chunk ch has landed
      __syncthreads();        // for every thread; chunk ch - 1 is done with
      float* dst = ws_blk + static_cast<size_t>(ch) * L::kState +
                   row0 * HD + col0;
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < C; ++c) dst[m * HD + c] = st[m][c];
      if (ch + 1 == n_chunks) break;   // the last chunk's steps: not needed
      load_steps<HD>(ring + ((ch + 1) & 1) * L::kStage, r, k, w, v, dy, base,
                     step, s, ch + 1, kK, kV + 1, tid);
      cp_async_commit();
      const float* stage = ring + (ch & 1) * L::kStage;
#pragma unroll 2
      for (int t = 0; t < kTc; ++t)
        state_step<HD>(st, st, stage + t * L::kStep, row0, col0);
    }
  }
  __syncthreads();   // the ring is free; the workspace is written

  // Sweep 2, backward, chunk by chunk from the last.
  float ds[kRows][C];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int c = 0; c < C; ++c)
      ds[m][c] = ds_final == nullptr
                     ? 0.f
                     : ds_final[static_cast<size_t>(blockIdx.x) * L::kState +
                                (row0 + m) * HD + col0 + c];
  float du_acc = 0.f;
  load_steps<HD>(ring, r, k, w, v, dy, base, step, s, n_chunks - 1, kR,
                 kVectors, tid);
  load_state<HD>(ring + kTc * L::kStep,
                 ws_blk + static_cast<size_t>(n_chunks - 1) * L::kState, tid);
  cp_async_commit();
  for (int q = 0; q < n_chunks; ++q) {
    const int ch = n_chunks - 1 - q;
    cp_async_wait_all();      // chunk ch has landed
    __syncthreads();          // for every thread; chunk ch + 1 is stored
    if (ch > 0) {
      float* next = ring + ((q + 1) & 1) * L::kStage;
      load_steps<HD>(next, r, k, w, v, dy, base, step, s, ch - 1, kR,
                     kVectors, tid);
      load_state<HD>(next + kTc * L::kStep,
                     ws_blk + static_cast<size_t>(ch - 1) * L::kState, tid);
    }
    cp_async_commit();
    const float* stage = ring + (q & 1) * L::kStage;
    const int t0 = ch * kTc;
    const int n = min(kTc, s - t0);

    // a_t = dy_t . v_t and b_t = sum r_t u k_t of the chunk's steps
    for (int t = warp; t < n; t += L::kWarps) {
      const float* sp = stage + t * L::kStep;
      float a = 0.f, bsum = 0.f;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const int e = lane + 32 * i;
        a = fmaf(sp[kDy * HD + e], sp[kV * HD + e], a);
        bsum = fmaf(sp[kR * HD + e] * uu[e], sp[kK * HD + e], bsum);
      }
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        bsum += __shfl_xor_sync(0xffffffffu, bsum, o);
      }
      if (lane == 0) {
        scal[t] = a;
        scal[kTc + t] = bsum;
      }
    }

    // the chunk's states: sts[i] = S_{t0 + i - 1}, from its boundary
    float sts[kTc][kRows][C];
    {
      const float* bnd = stage + kTc * L::kStep + row0 * HD + col0;
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < C; ++c) sts[0][m][c] = bnd[m * HD + c];
    }
#pragma unroll
    for (int i = 1; i < kTc; ++i)
      if (i < n)
        state_step<HD>(sts[i - 1], sts[i], stage + (i - 1) * L::kStep, row0,
                       col0);

    // the walk back over the chunk's steps
#pragma unroll
    for (int i = kTc - 1; i >= 0; --i) {
      if (i >= n) continue;
      const float* sp = stage + i * L::kStep;
      const float4 rr = *reinterpret_cast<const float4*>(sp + kR * HD + row0);
      const float4 kk = *reinterpret_cast<const float4*>(sp + kK * HD + row0);
      const float4 ww = *reinterpret_cast<const float4*>(sp + kW * HD + row0);
      const float ra[kRows] = {rr.x, rr.y, rr.z, rr.w};
      const float ka[kRows] = {kk.x, kk.y, kk.z, kk.w};
      const float wa[kRows] = {ww.x, ww.y, ww.z, ww.w};
      float vv[C], gy[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        vv[c] = sp[kV * HD + col0 + c];
        gy[c] = sp[kDy * HD + col0 + c];
      }
      // dv: this row group's part, sum over its rows of dS k
      float* dst = parts + (i * L::kWarps + warp) * HD + col0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float part = ds[0][c] * ka[0];
#pragma unroll
        for (int m = 1; m < kRows; ++m) part = fmaf(ds[m][c], ka[m], part);
        dst[c] = part;
      }
      // dk, dw and dr: this lane's columns, then over the warp's lanes
      float x[16];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        float xk = 0.f, xw = 0.f, xr = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          xk = fmaf(ds[m][c], vv[c], xk);
          xw = fmaf(ds[m][c], sts[i][m][c], xw);
          xr = fmaf(gy[c], sts[i][m][c], xr);
        }
        x[m] = xk;
        x[kRows + m] = xw;
        x[2 * kRows + m] = xr;
        x[3 * kRows + m] = 0.f;
      }
      const float tot = reduce_scatter16(x, lane);
      const int idx = lane >> 1;
      if (!(lane & 1) && idx < 3 * kRows)
        rowout[(i * 3 + idx / kRows) * HD + row0 + idx % kRows] = tot;
      // dS <- diag(w_t) dS + r_t^T dy_t
#pragma unroll
      for (int m = 0; m < kRows; ++m)
#pragma unroll
        for (int c = 0; c < C; ++c)
          ds[m][c] = fmaf(wa[m], ds[m][c], ra[m] * gy[c]);
    }
    __syncthreads();   // the chunk's parts, sums and scalars are in
    store_grads<HD>(stage, parts, rowout, scal, uu, dr, dk, dv, dw, base,
                    step, t0, n, tid);
    if (tid < HD) {
      for (int t = 0; t < n; ++t) {
        const float* sp = stage + t * L::kStep;
        du_acc = fmaf(sp[kR * HD + tid] * sp[kK * HD + tid], scal[t], du_acc);
      }
    }
  }
  if (tid < HD) du_part[static_cast<size_t>(blockIdx.x) * HD + tid] = du_acc;
}

template <int HD>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* w, const float* u, const float* dy,
                   const float* ds_final, float* dr, float* dk, float* dv,
                   float* dw, float* du_part, float* ws, int b, int s, int h,
                   cudaStream_t stream) {
  using L = Layout<HD>;
  static bool ready = false;   // the attribute is set once per instance
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        wkv_backward_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::kBytes));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid(static_cast<unsigned>(b) * static_cast<unsigned>(h));
  wkv_backward_kernel<HD><<<grid, L::kThreads, L::kBytes, stream>>>(
      r, k, v, w, u, dy, ds_final, dr, dk, dv, dw, du_part, ws, s, h);
  return cudaGetLastError();
}

}  // namespace

// Steps a chunk at head dim `hd` (the workspace holds ceil(S / chunk)
// states per (b, h)); 0 for a head dim the kernel does not take.
extern "C" int wkv_backward_chunk(int hd) {
  return hd == 32 ? Layout<32>::kTc : hd == 64 ? Layout<64>::kTc : 0;
}

// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when the launch was accepted). Every pointer but
// u, du_part and ds_final is 16-byte aligned; ds_final may be null (a zero
// gradient of the final state); ws holds b * h * ceil(s / chunk) states.
extern "C" int wkv_backward(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* dy,
                            const void* ds_final, void* dr, void* dk,
                            void* dv, void* dw, void* du_part, void* ws,
                            int b, int s, int h, int hd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* args[7] = {
      static_cast<const float*>(r),  static_cast<const float*>(k),
      static_cast<const float*>(v),  static_cast<const float*>(w),
      static_cast<const float*>(u),  static_cast<const float*>(dy),
      static_cast<const float*>(ds_final)};
  float* outs[6] = {static_cast<float*>(dr), static_cast<float*>(dk),
                    static_cast<float*>(dv), static_cast<float*>(dw),
                    static_cast<float*>(du_part), static_cast<float*>(ws)};
  if (hd == 32)
    return static_cast<int>(launch<32>(
        args[0], args[1], args[2], args[3], args[4], args[5], args[6],
        outs[0], outs[1], outs[2], outs[3], outs[4], outs[5], b, s, h, st));
  if (hd == 64)
    return static_cast<int>(launch<64>(
        args[0], args[1], args[2], args[3], args[4], args[5], args[6],
        outs[0], outs[1], outs[2], outs[3], outs[4], outs[5], b, s, h, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* wkv_backward_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
