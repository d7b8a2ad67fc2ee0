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
//   tensor cores (wgmma fed by TMA under warp specialisation), in two
//   launches (a tile kernel and a merge kernel) and
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
#include <cuda.h>  // CUtensorMap and its enums (no libcuda linked)
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
      // a term at the running max is exp(0) = 1, written so that an
      // infinite max gives 1 and not exp(inf - inf) = NaN: a +inf logit
      // then makes the loss +inf, as the plain version's logsumexp does
      // (fmaxf drops a NaN logit from the max; it still reaches s through
      // expf(NaN) and makes the loss NaN). Finite values take the same
      // bits either way.
      float e = col < vc ? (z == m_new ? 1.f : expf(z - m_new)) : 0.f;
#pragma unroll
      for (int o = 2; o < 32; o <<= 1) e += __shfl_xor_sync(kFull, e, o);
      s = (m == m_new ? s : s * expf(m - m_new)) + e;
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
// Bound. The products (2 n K T D V FLOP) at the bf16 tensor-core rate, or
// the heads read once, whichever is larger: at n * K = 4, T = 1024,
// D = 2048, V = 128,256 that is 2.18 ms of operations against 0.63 ms of
// HBM. Only wgmma reaches that rate, and only if its operands arrive fast
// enough: a tile of BT tokens x BV columns reads (BT + BV) x 2 bytes from
// L2 for every BT x BV x 2 FLOP, so small tiles make L2, not the tensor
// cores, the limit.
//
// Design. The [T, V] logits of a row r = node * K + head are cut into
// tiles of 128 tokens x 256 vocab columns. A block takes one (row,
// 128-token tile, range of vocab tiles); the ranges (V-splits) are as many
// as fill one wave of the card at one block an SM (4 at the shape above:
// 4 rows x 8 token tiles x 4 splits = 128 blocks on 132 SMs). Its three
// warpgroups are specialised:
// - a producer (one thread issues, registers cut to 40 by setmaxnreg)
//   keeps a ring of kLmStages = 4 stages of 48 KB in flight by TMA: for
//   each (vocab tile, D chunk of 64) the features [128 x 64] and the head
//   slab [64 x 256] (four boxes of 64 columns), both with the 128-byte
//   swizzle; each stage completes on its "full" mbarrier. The tensor maps
//   are 3-D, (D, T, node) and (V, D, row), so TMA's zero fill covers
//   ragged T, D and V inside each node's or row's own data;
// - two consumers (registers raised to 232), one per 64-token half, run
//   wgmma m64n256k16 bf16 x bf16 -> fp32 on each stage that has arrived,
//   four per D chunk, A K-major and B MN-major (the head is [D, V], V
//   contiguous, and stays so: the transpose-B immediate reads it), and
//   hand the stage back on its "empty" mbarrier once the next chunk's
//   products are issued (wgmma.wait_group 1), so the tensor cores are
//   never idle for a load. The 64 x 256 fp32 accumulator is 128 registers
//   a thread.
// After a vocab tile's last D chunk each consumer thread folds its two
// token rows' 64 logits each into running (max, sum-exp, gold) triples,
// exp2 with a log2(e) pre-scale, reduced over the 4 lanes of a row with
// shuffles; columns past V are set to -inf first. The vocab tiles run in
// order, so the fold is in a fixed order. Each (row, token, V-split)
// triple goes to the workspace; a second kernel, one block per row, merges
// each token's V-splits in index order, takes max + log(sum) - gold for
// the valid tokens, and sums them in a fixed tree. No atomics: two
// bit-identical heads give bit-identical losses.
//
// Against the L2 limit: each head slab is read T / 128 times (8 at
// T = 1024) and each feature tile once per 256 columns, about 25 GB from
// L2 at the shape above.
//
// Measured at that shape on an H100 SXM (80 GB HBM3, 700 W limit): 2.9 to
// 3.3 ms a call, as long as the per (node, head) bf16 matmul alone takes
// there. Under this load the card runs at its power limit with the SM
// clock near 1.4 GHz, where the tensor cores' rate gives 2.9 ms. The TMA
// ring alone (products and fold cut out) takes 1.8 ms; the fold adds about
// 0.3 ms that the products do not hide (tools/hs_lm_ablate.py).

constexpr int kLmBT = 128;       // tokens per tile: 64 per consumer
constexpr int kLmBV = 256;       // vocab columns per tile: one wgmma's N
constexpr int kLmBD = 64;        // D per stage: 128-byte rows
constexpr int kLmBox = 64;       // columns per head TMA box (128 bytes)
constexpr int kLmStages = 4;
constexpr int kLmConsumers = 2;  // warpgroups running wgmma
constexpr int kLmThreads = 128 * (kLmConsumers + 1);
constexpr uint32_t kLmABytes = 2u * kLmBT * kLmBD;   // 16 KB of features
constexpr uint32_t kLmBoxBytes = 2u * kLmBD * kLmBox;  // 8 KB
constexpr uint32_t kLmBBytes = 2u * kLmBD * kLmBV;   // 32 KB of head
constexpr uint32_t kLmStage = kLmABytes + kLmBBytes;
// the ring, its barriers, and slack to put the ring on a 1024-byte
// boundary (the period of the 128-byte swizzle)
constexpr int kLmSmemBytes = kLmStages * kLmStage + 16 * kLmStages + 1024;
constexpr float kLog2e = 1.4426950408889634f;
// Parts of the body cut out, for tools/hs_lm_ablate.py's split of its time;
// 0, nothing cut, in the port's build. Bit 1: the fold; bit 2: the products.
#ifndef HS_LM_ABLATE
#define HS_LM_ABLATE 0
#endif
constexpr int kLmAblate = HS_LM_ABLATE;
constexpr int kMergeThreads = 256;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box at coordinates (c0, c1, c2) of `map` into shared memory at `dst`,
// completing on the mbarrier `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor with the 128-byte swizzle: start
// address, leading and stride byte offsets (all >> 4)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

// d[128] (+)= A[64 x 16] B[16 x 256] in bf16, fp32 accumulator; A K-major,
// B MN-major (the transpose-B immediate); scale_d == 0 starts from zero
#define HS_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HS_D16(i) HS_D4(i), HS_D4(i + 4), HS_D4(i + 8), HS_D4(i + 12)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63, %64, %65, %66, %67, %68, %69,"
      " %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89,"
      " %90, %91, %92, %93, %94, %95, %96, %97, %98, %99,"
      " %100, %101, %102, %103, %104, %105, %106, %107, %108, %109,"
      " %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : HS_D16(0), HS_D16(16), HS_D16(32), HS_D16(48), HS_D16(64),
        HS_D16(80), HS_D16(96), HS_D16(112)
      : "l"(da), "l"(db), "r"(scale_d));
}
#undef HS_D16
#undef HS_D4

// Keeps the compiler from moving reads or writes of the accumulator across
// the wgmma fence or wait that precedes this
__device__ __forceinline__ void acc_fence(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (m, s) <- the log-sum-exp pair of (m, s) and (mb, sb); -inf max = empty.
// A pair at the max keeps its sum (exp(0) = 1), written so that a +inf
// max keeps it too and not exp(inf - inf) = NaN.
__device__ __forceinline__ void lse_merge(float& m, float& s, float mb,
                                          float sb) {
  const float mx = fmaxf(m, mb);
  if (mx == -INFINITY) return;
  s = (m == mx ? s : s * expf(m - mx)) + (mb == mx ? sb : sb * expf(mb - mx));
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

// ws holds three planes [splits][rows][t]: running max, sum-exp (relative
// to the max) and the gold logit (0 where the label is in another split).
// fmap: the features as (D, T, node), box (64, 128, 1); hmap: the heads as
// (V, D, row), box (64, 64, 1).
__global__ void __launch_bounds__(kLmThreads, 1)
head_losses_lm_kernel(const __grid_constant__ CUtensorMap fmap,
                      const __grid_constant__ CUtensorMap hmap,
                      const int32_t* __restrict__ labels,
                      float* __restrict__ ws, int k, int t, int d, int v,
                      int rows, int vt_per_split) {
  extern __shared__ unsigned char lm_smem[];
  const uint32_t ring = (smem_addr(lm_smem) + 1023u) & ~1023u;
  const uint32_t full = ring + kLmStages * kLmStage;  // kLmStages mbarriers
  const uint32_t empty = full + 8 * kLmStages;        // and kLmStages more
  const int t_tiles = (t + kLmBT - 1) / kLmBT;
  const int tt = blockIdx.x % t_tiles;          // token tiles of one row and
  const int r = (blockIdx.x / t_tiles) % rows;  // split are neighbours
  const int split = blockIdx.x / (t_tiles * rows);
  const int node = r / k;
  const int t0 = tt * kLmBT;
  const int v_tiles = (v + kLmBV - 1) / kLmBV;
  const int vt0 = split * vt_per_split;
  const int vt1 = min(v_tiles, vt0 + vt_per_split);
  const int d_steps = (d + kLmBD - 1) / kLmBD;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kLmStages; ++s) {
      mbar_init(full + 8 * s, 1);                     // the producer's
      mbar_init(empty + 8 * s, 4 * kLmConsumers);     // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kLmConsumers) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x % 128 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int vt = vt0; vt < vt1; ++vt)
        for (int j = 0; j < d_steps; ++j) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes
          const uint32_t a = ring + stage * kLmStage;
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kLmStage);
          tma_load(a, &fmap, bar, j * kLmBD, t0, node);
#pragma unroll
          for (int c = 0; c < kLmBV / kLmBox; ++c)
            tma_load(a + kLmABytes + c * kLmBoxBytes, &hmap, bar,
                     vt * kLmBV + c * kLmBox, j * kLmBD, r);
          if (++stage == kLmStages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
  } else {
    // ---- consumers: warpgroup wg takes tokens t0 + 64 wg .. + 64 ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane / 4;  // row within an 8-row group
    const int q = lane % 4;  // column pair within an 8-column block
    // this thread's token rows: 64 wg + 16 warp + g + 8 h
    int y[2];
    float m_run[2], s_run[2], gold[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tok = t0 + 64 * wg + 16 * warp + g + 8 * h;
      y[h] = tok < t ? labels[static_cast<size_t>(node) * t + tok] : -1;
      m_run[h] = -INFINITY;
      s_run[h] = 0.f;
      gold[h] = 0.f;
    }
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    const uint32_t a_half = wg * (kLmABytes / kLmConsumers);
    int stage = 0;
    uint32_t phase = 0;
    for (int vt = vt0; vt < vt1; ++vt) {
      int prev = -1;
      for (int j = 0; j < d_steps; ++j) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t a = ring + stage * kLmStage;
        if constexpr (!(kLmAblate & 2)) {
          acc_fence(acc);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kLmBD / 16; ++kk)
            // A: +32 bytes a 16-column step inside its swizzled 128-byte
            // rows, 8-row groups 1024 bytes apart. B: +16 rows (2048 bytes)
            // a step; 8-row groups 1024 bytes apart, the 64-column boxes
            // kLmBoxBytes apart.
            wgmma_m64n256k16(acc, gmma_desc(a + a_half + 32 * kk, 16, 1024),
                             gmma_desc(a + kLmABytes + 2048 * kk,
                                       kLmBoxBytes, 1024),
                             j > 0 || kk > 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous chunk's products are done
          acc_fence(acc);
        }
        if (prev >= 0 && lane == 0) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == kLmStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      acc_fence(acc);
      if (lane == 0) mbar_arrive(empty + 8 * prev);

      // the vocab tile is complete: fold its logits into the triples
      if constexpr (kLmAblate & 1) {
        m_run[0] = fmaxf(m_run[0], acc[0]);  // keeps the products live
        continue;
      }
      const int v0 = vt * kLmBV;
      if (v0 + kLmBV > v) {
#pragma unroll
        for (int i = 0; i < 128; ++i)
          if (v0 + 8 * (i / 4) + 2 * q + (i % 2) >= v) acc[i] = -INFINITY;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int jn = 0; jn < 32; ++jn)
          mx = fmaxf(mx, fmaxf(acc[4 * jn + 2 * h], acc[4 * jn + 2 * h + 1]));
        // finite: column v0 < V lies in every quad's columns
        const float m_new = fmaxf(m_run[h], quad_max(mx));
        const float ml = m_new * kLog2e;
        float se = 0.f;
        if (!isinf(m_new)) {
#pragma unroll
          for (int jn = 0; jn < 32; ++jn)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              se += ex2(fmaf(acc[4 * jn + 2 * h + e], kLog2e, -ml));
        } else {
          // an infinite max (a +inf logit): a term at it is exp(0) = 1,
          // not exp2(inf - inf) = NaN, as the FMA body and the plain
          // version's logsumexp count it; a +inf logit then makes the
          // loss +inf (a NaN logit still reaches the sum and makes it NaN)
#pragma unroll
          for (int jn = 0; jn < 32; ++jn)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float z = acc[4 * jn + 2 * h + e];
              se += z == m_new ? 1.f : ex2(fmaf(z, kLog2e, -ml));
            }
        }
        se = quad_sum(se);
        // the running sum's factor is 1 where an infinite max stays
        const float alpha = isinf(m_new) && m_run[h] == m_new
                                ? 1.f
                                : ex2((m_run[h] - m_new) * kLog2e);
        s_run[h] = fmaf(s_run[h], alpha, se);
        m_run[h] = m_new;
        const int c = y[h] - v0;  // the label's column in this tile
        if (c >= 0 && c < kLmBV) {
#pragma unroll
          for (int jn = 0; jn < 32; ++jn)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (8 * jn + 2 * q + e == c) gold[h] = acc[4 * jn + 2 * h + e];
        }
      }
    }

    const size_t plane = static_cast<size_t>(gridDim.x / t_tiles) * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float gs = quad_sum(gold[h]);  // one lane holds the label
      const int tok = t0 + 64 * wg + 16 * warp + g + 8 * h;
      if (q == 0 && tok < t) {
        const size_t idx = (static_cast<size_t>(split) * rows + r) * t + tok;
        ws[idx] = m_run[h];
        ws[plane + idx] = s_run[h];
        ws[2 * plane + idx] = gs;
      }
    }
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

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled(cudaError_t* err) {
  static EncodeTiled fn = nullptr;
  *err = cudaSuccess;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    *err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                            12000, cudaEnableDefault, &found);
#else
    *err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                   cudaEnableDefault, &found);
#endif
    if (*err == cudaSuccess &&
        (found != cudaDriverEntryPointSuccess || p == nullptr))
      *err = cudaErrorNotSupported;
    if (*err != cudaSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor [outer][mid][inner] as a 3-D map with boxes of (64, box_mid,
// 1), the 128-byte swizzle and zero fill out of bounds
cudaError_t make_map(EncodeTiled fn, CUtensorMap* map, const void* base,
                     int inner, int mid, int outer, int box_mid) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {2ull * inner, 2ull * inner * mid};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(kLmBox),
                             static_cast<cuuint32_t>(box_mid), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  const EncodeTiled fn = encode_tiled(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap fmap, hmap;
  err = make_map(fn, &fmap, feats, d, t, n, kLmBT);
  if (err == cudaSuccess) err = make_map(fn, &hmap, heads, v, d, rows, kLmBD);
  if (err != cudaSuccess) return static_cast<int>(err);
  head_losses_lm_kernel<<<static_cast<unsigned>(blocks), kLmThreads,
                          kLmSmemBytes, s>>>(fmap, hmap, labels, ws, k, t, d,
                                             v, rows, per);
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
