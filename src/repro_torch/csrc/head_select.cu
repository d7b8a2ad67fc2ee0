// FACADE step 2c on Hopper: mean cross-entropy of every candidate head of
// every node, over the node's cached core features.
//
// Replaces the TPU kernel src/repro/kernels/head_select/kernel.py ::
// head_select_losses (body _kernel), adding a leading node axis:
//   feats [n, T, D], heads [n, K, D, V], labels [n, T] int32 (< 0: excluded)
//   -> out [n, K] fp32, the mean NLL over valid tokens, denominator
//      max(valid, 1) (the TPU wrapper ops.py::facade_head_losses divides
//      the kernel's sums the same way).
// Inputs fp32 or bf16; every product and sum is accumulated in fp32.
//
// Two bodies behind one entry, hs_head_losses, picked from the shape:
// - the LM regime (lm_body below: bf16 with D and V multiples of 8, at
//   any T > 0; ragged token and vocab tiles are masked) runs on the
//   tensor cores, in two launches (a tile kernel and a merge kernel) and
//   with a workspace whose size hs_workspace_bytes gives; an input that
//   body cannot take (a feature or head pointer off 16-byte alignment) is
//   refused;
// - every other input (the FACADE/GN-LeNet path: fp32, D = 513, V = 10)
//   runs on the FMA kernel described next, in one launch.
//
// FMA body. One block per (node, head); its 8 warps take tokens in turn, one
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
// Bound on this card. At the FACADE path's shapes (n = 32, K = 2, T = 8,
// D = 513, V = 10, fp32) the kernel reads 1.84 MB (heads 1.31 MB, features
// 0.53 MB) and does 5.3 MFLOP: about 0.55 us of HBM traffic at 3.35 TB/s
// and less of fp32 arithmetic, so at that size the launch itself bounds it.
// In the LM regime (V of 65k-128k) the K x T x D x V products dominate:
// at n * K = 4, T = 1024, D = 2048, V = 128,256 in bf16 they are 2.15
// TFLOP, 2.18 ms at the 989 TFLOP/s of the bf16 tensor cores, against
// 0.63 ms to read the 2.1 GB of heads once. The LM body is described at
// its kernel below.
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

// ---- LM regime: the tensor-core body ----
//
// Design. The [T, V] logits of a row r = node * K + head are cut into
// tiles of 64 tokens x 128 vocab columns. A block of 4 warps takes one
// (row, 64-token tile, range of vocab tiles); the ranges (V-splits) are as
// many as fill one wave of the card at the kernel's occupancy, so at
// n * K = 4, T = 1024 every SM is busy. For each vocab tile the block
// walks D in chunks of 64: the features [64 x 64] (D contiguous) and the
// head's slab [64 x 128] (V contiguous) go by 16-byte cp.async copies into
// a double-buffered ring in shared memory (chunk j + 1 loads while chunk j
// is multiplied; rows past T or D and columns past V are zero-filled, so
// V % 8 == 0 and D % 8 == 0 suffice). Each 16-byte chunk's place in its
// 128-byte line is XORed with the row, so every ldmatrix is free of bank
// conflicts. Warp w owns tokens 32 (w / 2) .. + 32 and columns
// 64 (w % 2) .. + 64 of the tile: features by ldmatrix, the head by
// ldmatrix.trans (as the attention kernel loads V for P V), and
// mma.sync m16n8k16 bf16 x bf16 -> fp32. After the last D chunk of a
// vocab tile each thread folds its 4 token rows' 16 logits into running
// (max, sum-exp, gold) triples, reduced over the 4 lanes of a row with
// shuffles; columns past V are masked. The vocab tiles run in order, so
// the fold is in a fixed order. At the end the two column halves of a
// row merge through shared memory (half 0, then half 1) and one triple per
// (row, token, V-split) goes to the workspace. A second kernel, one block
// per row, merges each token's V-splits in index order, takes
// max + log(sum) - gold for the valid tokens, and sums them in a fixed
// tree. No atomics: two bit-identical heads give bit-identical losses.
//
// Bound. The products (2 n K T D V FLOP) at the bf16 tensor-core rate, or
// the heads read once, whichever is larger. This first tensor-core body
// uses mma.sync, which reaches well under that rate (only wgmma does), and
// reads each head slab once per 64-token tile (16 times at T = 1024, from
// L2 when the blocks of one row and V-split run together, as the one-wave
// grid makes them) and each feature tile once per vocab tile. wgmma with
// TMA loads and larger token tiles are the next steps.

constexpr int kLmBT = 64;        // tokens per tile
constexpr int kLmBV = 128;       // vocab columns per tile
constexpr int kLmBD = 64;        // D per stage of the ring
constexpr int kLmThreads = 128;  // 4 warps: 2 token halves x 2 column halves
constexpr int kLmMinBlocks = 4;  // per SM: caps registers at 128 a thread
constexpr uint32_t kLmABytes = 2u * kLmBT * kLmBD;  // 8 KB of features
constexpr uint32_t kLmBBytes = 2u * kLmBD * kLmBV;  // 16 KB of head
constexpr uint32_t kLmStage = kLmABytes + kLmBBytes;
constexpr int kLmSmemBytes = 2 * kLmStage;          // 48 KB, two stages
constexpr int kMergeThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !in
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] b[16x8], bf16 inputs, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile of rows of
// `W` bf16 values: the chunk's place in its 128-byte line XORed with the
// row, so the 8 rows one ldmatrix matrix reads fall on 8 distinct places.
template <int W>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return 2u * static_cast<uint32_t>(row * W + ((chunk ^ (row & 7)) << 3));
}

// (m, s) <- the log-sum-exp pair of (m, s) and (mb, sb); -inf max = empty
__device__ __forceinline__ void lse_merge(float& m, float& s, float mb,
                                          float sb) {
  const float mx = fmaxf(m, mb);
  if (mx == -INFINITY) return;
  s = s * expf(m - mx) + sb * expf(mb - mx);
  m = mx;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// Stage `step` (vocab tile vt0 + step / d_steps, D chunk step % d_steps)
// into the ring's stage at byte address `a`: features [64 x 64], then the
// head slab [64 x 128].
__device__ __forceinline__ void lm_load(uint32_t a,
                                        const __nv_bfloat16* f_node,
                                        const __nv_bfloat16* w_row, int step,
                                        int d_steps, int vt0, int t0, int t,
                                        int d, int v, int tid) {
  const int d0 = (step % d_steps) * kLmBD;
  const int v0 = (vt0 + step / d_steps) * kLmBV;
#pragma unroll
  for (int i = tid; i < kLmBT * kLmBD / 8; i += kLmThreads) {
    const int row = i / (kLmBD / 8), c = i % (kLmBD / 8);
    const int tok = t0 + row, dd = d0 + 8 * c;
    const bool in = tok < t && dd < d;
    cp_async16(a + swz<kLmBD>(row, c),
               f_node + (in ? static_cast<size_t>(tok) * d + dd : 0), in);
  }
  const uint32_t b = a + kLmABytes;
#pragma unroll
  for (int i = tid; i < kLmBD * kLmBV / 8; i += kLmThreads) {
    const int row = i / (kLmBV / 8), c = i % (kLmBV / 8);
    const int dd = d0 + row, vv = v0 + 8 * c;
    const bool in = dd < d && vv < v;
    cp_async16(b + swz<kLmBV>(row, c),
               w_row + (in ? static_cast<size_t>(dd) * v + vv : 0), in);
  }
}

// ws holds three planes [splits][rows][t]: running max, sum-exp (relative
// to the max) and the gold logit (0 where the label is in another split)
__global__ void __launch_bounds__(kLmThreads, kLmMinBlocks)
head_losses_lm_kernel(const __nv_bfloat16* __restrict__ feats,
                      const __nv_bfloat16* __restrict__ heads,
                      const int32_t* __restrict__ labels,
                      float* __restrict__ ws, int k, int t, int d, int v,
                      int rows, int vt_per_split) {
  extern __shared__ __align__(128) unsigned char lm_smem[];
  const uint32_t sbase = smem_addr(lm_smem);
  const int t_tiles = (t + kLmBT - 1) / kLmBT;
  const int tt = blockIdx.x % t_tiles;       // token tiles of one row and
  const int r = (blockIdx.x / t_tiles) % rows;  // split are neighbours
  const int split = blockIdx.x / (t_tiles * rows);
  const int node = r / k;
  const int t0 = tt * kLmBT;
  const int v_tiles = (v + kLmBV - 1) / kLmBV;
  const int vt0 = split * vt_per_split;
  const int d_steps = (d + kLmBD - 1) / kLmBD;
  const int steps = (min(v_tiles, vt0 + vt_per_split) - vt0) * d_steps;
  const __nv_bfloat16* f_node = feats + static_cast<size_t>(node) * t * d;
  const __nv_bfloat16* w_row = heads + static_cast<size_t>(r) * d * v;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wt = warp >> 1;         // token half of the tile
  const int wv = warp & 1;          // column half of the tile
  const int g = lane / 4;           // row within an 8-row group
  const int q = lane % 4;           // column pair within an 8-column block

  // this thread's 4 token rows: wt * 32 + 16 mi + g + 8 h
  int y[2][2];
  float m_run[2][2], s_run[2][2], gold[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = t0 + wt * 32 + 16 * mi + g + 8 * h;
      y[mi][h] = tok < t ? labels[static_cast<size_t>(node) * t + tok] : -1;
      m_run[mi][h] = -INFINITY;
      s_run[mi][h] = 0.f;
      gold[mi][h] = 0.f;
    }
  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;

  lm_load(sbase, f_node, w_row, 0, d_steps, vt0, t0, t, d, v, tid);
  cp_async_commit();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps)       // the next chunk loads while this one runs
      lm_load(sbase + ((step + 1) & 1) * kLmStage, f_node, w_row, step + 1,
              d_steps, vt0, t0, t, d, v, tid);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint32_t a = sbase + (step & 1) * kLmStage;
    const uint32_t b = a + kLmABytes;
#pragma unroll
    for (int kk = 0; kk < kLmBD / 16; ++kk) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a + swz<kLmBD>(wt * 32 + 16 * mi + (lane & 15),
                               2 * kk + (lane >> 4)),
                af[mi]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(b + swz<kLmBV>(16 * kk + (lane & 7) +
                                         (((lane >> 3) & 1) << 3),
                                     8 * wv + 2 * np + (lane >> 4)),
                      bf);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();            // every warp is done with this stage

    if (step % d_steps != d_steps - 1) continue;
    // the vocab tile is complete: fold its logits into the triples
    const int c0 = (vt0 + step / d_steps) * kLmBV + 64 * wv + 2 * q;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * nj + e;
            const float x = acc[mi][nj][2 * h + e];
            if (col < v) mx = fmaxf(mx, x);
            if (col == y[mi][h]) gold[mi][h] = x;
          }
        // -inf: no column of this half has been below V yet
        const float m_new = fmaxf(m_run[mi][h], quad_max(mx));
        float se = 0.f;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (c0 + 8 * nj + e < v && m_new != -INFINITY)
              se += expf(acc[mi][nj][2 * h + e] - m_new);
        se = quad_sum(se);
        if (m_new != -INFINITY) {
          s_run[mi][h] = s_run[mi][h] * expf(m_run[mi][h] - m_new) + se;
          m_run[mi][h] = m_new;
        }
      }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int nj = 0; nj < 8; ++nj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
  }

  // merge the two column halves of each token row (half 0, then half 1)
  float* red = reinterpret_cast<float*>(lm_smem);   // [2][kLmBT][3]
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float gs = quad_sum(gold[mi][h]);  // one lane holds the label
      if (q == 0) {
        float* slot = red + 3 * (wv * kLmBT + wt * 32 + 16 * mi + g + 8 * h);
        slot[0] = m_run[mi][h];
        slot[1] = s_run[mi][h];
        slot[2] = gs;
      }
    }
  __syncthreads();
  if (tid < kLmBT && t0 + tid < t) {
    const float* lo = red + 3 * tid;
    const float* hi = red + 3 * (kLmBT + tid);
    float m = lo[0], s = lo[1];
    lse_merge(m, s, hi[0], hi[1]);
    const size_t plane = static_cast<size_t>(gridDim.x / t_tiles) * t;
    const size_t idx = (static_cast<size_t>(split) * rows + r) * t + t0 + tid;
    ws[idx] = m;
    ws[plane + idx] = s;
    ws[2 * plane + idx] = lo[2] + hi[2];
  }
}

// One block per row: merge each token's V-splits in index order, then sum
// the valid tokens' NLL in a fixed tree.
__global__ void __launch_bounds__(kMergeThreads)
head_losses_lm_merge(const float* __restrict__ ws,
                     const int32_t* __restrict__ labels,
                     float* __restrict__ out, int k, int t, int rows,
                     int splits) {
  __shared__ float part_nll[kMergeThreads];
  __shared__ float part_cnt[kMergeThreads];
  const int r = blockIdx.x;
  const int node = r / k;
  const size_t plane = static_cast<size_t>(splits) * rows * t;
  float nll = 0.f, cnt = 0.f;
  for (int tok = threadIdx.x; tok < t; tok += kMergeThreads) {
    if (labels[static_cast<size_t>(node) * t + tok] < 0) continue;
    float m = -INFINITY, s = 0.f, gsum = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const size_t idx = (static_cast<size_t>(sp) * rows + r) * t + tok;
      lse_merge(m, s, ws[idx], ws[plane + idx]);
      gsum += ws[2 * plane + idx];
    }
    nll += m + logf(s) - gsum;
    cnt += 1.f;
  }
  part_nll[threadIdx.x] = nll;
  part_cnt[threadIdx.x] = cnt;
  for (int stride = kMergeThreads / 2; stride > 0; stride >>= 1) {
    __syncthreads();
    if (threadIdx.x < stride) {
      part_nll[threadIdx.x] += part_nll[threadIdx.x + stride];
      part_cnt[threadIdx.x] += part_cnt[threadIdx.x + stride];
    }
  }
  if (threadIdx.x == 0) out[r] = part_nll[0] / fmaxf(part_cnt[0], 1.f);
}

// The dispatch rule: the tensor-core body takes bf16 whose feature and
// head rows are whole 16-byte chunks (D and V multiples of 8), at any
// T > 0 (T = 0 or V = 0 would make an empty grid; the FMA body takes them).
bool lm_body(int t, int d, int v, int dtype) {
  return dtype == 1 && t > 0 && v > 0 && d % 8 == 0 && v % 8 == 0;
}

// Blocks resident per SM (set once; the attribute is set first)
int lm_blocks_per_sm(cudaError_t* err) {
  static int per_sm = 0;
  if (per_sm == 0) {
    *err = cudaFuncSetAttribute(head_losses_lm_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kLmSmemBytes);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, head_losses_lm_kernel, kLmThreads, kLmSmemBytes);
    if (*err != cudaSuccess) return 0;
  }
  *err = cudaSuccess;
  return per_sm;
}

// Vocab tiles per V-split: as many splits as fill one wave of the card
int lm_vt_per_split(int rows, int t, int v, cudaError_t* err) {
  const int per_sm = lm_blocks_per_sm(err);
  if (*err != cudaSuccess) return 0;
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  const int v_tiles = (v + kLmBV - 1) / kLmBV;
  const long long base =
      static_cast<long long>(rows) * ((t + kLmBT - 1) / kLmBT);
  const long long fill = static_cast<long long>(per_sm) * sms / base;
  const int splits = static_cast<int>(
      fill < 1 ? 1 : (fill > v_tiles ? v_tiles : fill));
  return (v_tiles + splits - 1) / splits;
}

int lm_splits(int v, int vt_per_split) {
  return ((v + kLmBV - 1) / kLmBV + vt_per_split - 1) / vt_per_split;
}

int launch_lm(const void* feats, const void* heads, const int32_t* labels,
              float* out, float* ws, int n, int k, int t, int d, int v,
              cudaStream_t s) {
  if (reinterpret_cast<uintptr_t>(feats) % 16 ||
      reinterpret_cast<uintptr_t>(heads) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n * k;
  cudaError_t err;
  const int per = lm_vt_per_split(rows, t, v, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = lm_splits(v, per);
  const long long blocks =
      static_cast<long long>(splits) * rows * ((t + kLmBT - 1) / kLmBT);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  head_losses_lm_kernel<<<static_cast<unsigned>(blocks), kLmThreads,
                          kLmSmemBytes, s>>>(
      static_cast<const __nv_bfloat16*>(feats),
      static_cast<const __nv_bfloat16*>(heads), labels, ws, k, t, d, v, rows,
      per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  head_losses_lm_merge<<<rows, kMergeThreads, 0, s>>>(ws, labels, out, k, t,
                                                      rows, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Bytes of the workspace hs_head_losses needs for this input (0 for the
// FMA body), or -1 with the CUDA error unreadable here: a later launch
// reports it.
extern "C" long long hs_workspace_bytes(int n, int k, int t, int d, int v,
                                        int dtype) {
  if (!lm_body(t, d, v, dtype) || n * k == 0) return 0;
  cudaError_t err;
  const int per = lm_vt_per_split(n * k, t, v, &err);
  if (err != cudaSuccess) return -1;
  return 3LL * sizeof(float) * lm_splits(v, per) * n * k * t;
}

// dtype: 0 = fp32, 1 = bf16. The body is picked by lm_body: the LM regime
// takes `workspace` (hs_workspace_bytes of it) and launches twice, the FMA
// body ignores it and launches once. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 when the launches were
// accepted).
extern "C" int hs_head_losses(const void* feats, const void* heads,
                              const void* labels, void* out, void* workspace,
                              int n, int k, int t, int d, int v, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float* o = static_cast<float*>(out);
  if (lm_body(t, d, v, dtype))
    return launch_lm(feats, heads, lab, o, static_cast<float*>(workspace), n,
                     k, t, d, v, s);
  if (dtype == 0) return launch<float>(feats, heads, lab, o, n, k, t, d, v, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(feats, heads, lab, o, n, k, t, d, v, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* hs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
