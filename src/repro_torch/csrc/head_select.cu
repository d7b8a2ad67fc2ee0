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
// Four bodies behind one entry, hs_head_losses, picked by body_for (below;
// hs_body returns its answer, and ops.py::body_for mirrors it):
// - tensor cores (bf16 with D and V multiples of 8, or with V of at least
//   one 256-column vocab tile, at any T > 0): wgmma fed by TMA under warp
//   specialisation, a tile kernel and a merge kernel, with a workspace whose
//   size hs_workspace_bytes gives. A ragged D or V is copied first into a
//   padded buffer in that workspace (rows of a multiple of 8 values, one
//   more launch each); otherwise a feature or head pointer off 16-byte
//   alignment is refused;
// - fp32 on the tensor cores (fp32 with V of at least kF32MinV columns
//   and D of at least kF32TcMinD, any T > 0): the products split 3xTF32
//   (fp32's accuracy from three TF32 products) on wgmma, the head slab as
//   A from registers, the features split first into two TF32 planes of the
//   workspace and fed as B by TMA under warp specialisation, the same fold
//   of triples and merge kernel; a ragged V is copied first into rows of a
//   multiple of 4 values;
// - fp32 tiled (the other fp32 inputs with V of at least kF32MinV
//   columns, any T > 0): a register-blocked SIMT product on tiles of 128
//   tokens x 128 columns fed by a cp.async ring, the same fold, workspace
//   and merge kernel;
// - FMA (every other input: the CNN paths' step 2c, fp32, D 513 or 65, V
//   10 or 41) in one launch.
// Every sum runs in a fixed order with no atomics in all four, so two
// bit-identical heads give bit-identical losses and an argmin then picks
// the lower index; a +inf logit gives a +inf loss, not NaN.
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
// order.
//
// Bound on this card. At the FACADE path's shapes (n = 32, K = 2, T = 8,
// D = 513, V = 10, fp32) the kernel reads 1.84 MB (heads 1.31 MB, features
// 0.53 MB) and does 5.3 MFLOP: about 0.55 us of HBM traffic at 3.35 TB/s
// and less of fp32 arithmetic, so at that size the launch itself bounds it.
// At an LM's shapes the K x T x D x V products dominate: at n * K = 4,
// T = 1024, D = 2048, V = 128,256 they are 2.15 TFLOP, 2.18 ms at the
// 989 TFLOP/s of the bf16 tensor cores, against 0.63 ms to read the 2.1 GB
// of bf16 heads once; in fp32 the same products take 32.1 ms at the 67
// TFLOP/s of the fp32 pipes (the 4.2 GB of heads 1.25 ms), and three TF32
// products of them 13.0 ms at the 495 TFLOP/s of the TF32 tensor cores.
// The three tiled bodies are described at their kernels below.
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
//   ragged T, D and V inside each node's or row's own data. A map's row
//   stride must be a multiple of 16 bytes: where D (or V) is not a
//   multiple of 8, the launcher first copies the features (or heads) into
//   a buffer of the workspace whose rows hold D8 (V8) values, D (V)
//   rounded up to 8 (head_losses_pad_kernel), and the map keeps the
//   logical D (V) as its extent with the padded row as its stride, so the
//   pad is never read: TMA fills past D (V) with zeros, as at any edge;
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
template <int N>
__device__ __forceinline__ void acc_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// ---- fp32 at LM shapes: the tiled SIMT body ----
//
// Bound. The products (2 n K T D V FLOP) at the fp32 pipes' 67 TFLOP/s (no
// TF32: run_experiment and LMFacade run with TF32 off, and the function is
// fp32's), or the heads read once: at n * K = 2, T = 2048, D = 2048,
// V = 128,256 that is 32.1 ms of operations (28.8 ms for the 90% of tokens
// whose label counts) against 0.63 ms of HBM. One PyTorch call of the same
// function (an fp32 matmul and cross_entropy) also writes the [T, V] logits
// and reads them back, 1.05 GB a row; this body keeps them in registers.
//
// Design. The LM body's grid and V-split rule: a block takes one (row,
// 128-token tile, range of 128-column vocab tiles), as many V-splits as
// fill one wave at the blocks an SM holds (kF32Blocks = 2: 48 KB of shared
// memory and at most 128 registers a thread). A first launch copies the
// features transposed, [n][D][T4] with T4 = T rounded up to 4 and zeros
// past T, into the workspace (head_losses_f32_transpose_kernel; 16 MB a
// node at T 2048, D 2048, microseconds). The block's 256 threads form a
// 16 x 16 grid over the [128, 128] logit tile: thread (ty, tx) holds tokens
// 4 ty + c + 64 h and columns 4 tx + c + 64 h (c < 4, h < 2), 8 x 8 fp32
// accumulators, each one FMA chain in the order of d (plain fmaf, no
// TF32). D walks in chunks of kF32BK = 16 through a ring of kF32Stages = 3
// stages of shared memory ([16][128 tokens] of the transposed features and
// [16][128 columns] of the head, 16 KB), filled by cp.async: 16-byte
// copies of the features, and of the head where V is a multiple of 4 and
// the head 16-byte aligned (else 4-byte ones), zero-filled past T, D and
// V. The ring runs on across vocab tiles, so the next tile's copies are in
// flight while a tile is folded. For each d a thread reads its 8 tokens'
// features and its 8 columns as four 16-byte words (the tokens two ty of a
// warp read are 16 bytes apart; the columns 16 tx are 256 contiguous
// bytes), for 64 FMAs. tools/hs_f32_tune.py times this body against
// builds with other chunk depths and blocks an SM (PERF.md).
//
// Fold. After a vocab tile's last chunk, each token's 128 logits sit in
// the 16 lanes of a half warp: each lane takes the max of its 8 (columns
// past V are -inf), the half warp a butterfly max, then each lane sums
// exp2 of its 8 in column order after the log2(e) pre-scale and the half
// warp a butterfly sum; the running (max, sum-exp) pair and the gold
// logit (the lane that holds the label's column, summed with zeros) are
// updated as in the LM body, the +inf rule included. Lane i < 8 of a half
// warp keeps token ty + 16 i's triple and label; the others read it by
// shuffle. The triples go to the same three workspace planes as the LM
// body's, and head_losses_lm_merge merges them.
//
// Order. Every sum is in a fixed order: the FMA chains in d, the fold in
// column order and butterflies, the vocab tiles in order inside a split,
// the merge in split order and its fixed tree.

constexpr int kF32BT = 128;       // tokens per tile
constexpr int kF32BV = 128;       // vocab columns per tile
constexpr int kF32Cols = kF32BV / 16;  // columns a thread: 4 every 64
constexpr int kF32BK = 16;        // D per ring stage
constexpr int kF32Stages = 3;
constexpr int kF32Threads = 256;
constexpr int kF32Blocks = 2;     // blocks an SM, for __launch_bounds__
constexpr int kF32AWords = kF32BK * kF32BT;  // features [16][128 tokens]
constexpr int kF32BWords = kF32BK * kF32BV;  // head [16][128 columns]
constexpr int kF32StageWords = kF32AWords + kF32BWords;
constexpr int kF32SmemBytes = 4 * kF32Stages * kF32StageWords;
// the least V for which fp32 takes a tiled body: below it, and at the CNN
// paths' V 10 and 41, the FMA body (PERF.md: the bodies' times at
// HS_SHAPES and at V 128)
constexpr int kF32MinV = 128;
// the least D for which fp32 takes the tensor cores (3xTF32) rather than
// this body: on an H100 the tensor cores' body is the slower at D 64 and
// 128 and the faster from D 192 up, at the smoke LM step 2c and at the LM
// shapes (PERF.md, PR 35: chip_smoke.py's HS_TC32_SWEEP and HS_F32_TIMED)
constexpr int kF32TcMinD = 192;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// max and sum over the 16 lanes of a half warp (xor 1, 2, 4, 8)
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// fT [n][D][tp] = feats [n][T][D] transposed, zero past T (tp: T rounded up
// to 4, so that a 16-byte copy along T never passes a row): 32 x 32 tiles
// through shared memory, both sides coalesced
__global__ void __launch_bounds__(256)
head_losses_f32_transpose_kernel(const float* __restrict__ feats,
                                 float* __restrict__ ft, int t, int d,
                                 int tp) {
  __shared__ float tile[32][33];
  const int t0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const float* src = feats + static_cast<size_t>(blockIdx.z) * t * d;
  float* dst = ft + static_cast<size_t>(blockIdx.z) * d * tp;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int tok = t0 + r, col = d0 + threadIdx.x;
    tile[r][threadIdx.x] =
        tok < t && col < d ? src[static_cast<size_t>(tok) * d + col] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int row = d0 + r, tok = t0 + threadIdx.x;
    if (row < d && tok < tp)
      dst[static_cast<size_t>(row) * tp + tok] = tile[threadIdx.x][r];
  }
}

// Stage s of the flattened (vocab tile, D chunk) walk into ring slot
// s % kF32Stages; commits a (possibly empty) group either way. The
// features come from their transposed copy ft [D][tp] in 16-byte copies;
// the head's columns in copies of VEC floats (4 where V and the pointer
// allow 16-byte copies, else 1).
template <int VEC>
__device__ __forceinline__ void f32_stage(float* ring, const float* ft,
                                          const float* w, int s, int steps,
                                          int d_steps, int vt0, int t0,
                                          int t, int tp, int d, int v) {
  if (s < steps) {
    float* a = ring + (s % kF32Stages) * kF32StageWords;
    float* b = a + kF32AWords;
    const int d0 = (s % d_steps) * kF32BK;
    const int v0 = (vt0 + s / d_steps) * kF32BV;
#pragma unroll
    for (int p = 0; p < kF32AWords / (kF32Threads * 4); ++p) {
      const int i = threadIdx.x + kF32Threads * p;
      // features: D row i / 32, tokens 4 (i % 32) .. + 3
      const int row = d0 + i / (kF32BT / 4), tok = t0 + 4 * (i % (kF32BT / 4));
      const bool ok = row < d && tok < t;
      cp_async16(a + 4 * i, ok ? ft + static_cast<size_t>(row) * tp + tok : ft,
                 ok);
    }
#pragma unroll
    for (int p = 0; p < kF32BWords / (kF32Threads * VEC); ++p) {
      const int i = threadIdx.x + kF32Threads * p;
      // head: D row i / (128 / VEC), vocab columns VEC (i % (128 / VEC)) ..
      const int row = d0 + i / (kF32BV / VEC);
      const int vc = v0 + VEC * (i % (kF32BV / VEC));
      const bool ok = row < d && vc < v;
      const float* src = ok ? w + static_cast<size_t>(row) * v + vc : w;
      if constexpr (VEC == 4)
        cp_async16(b + 4 * i, src, ok);
      else
        cp_async4(b + i, src, ok);
    }
  }
  cp_async_commit();
}

// ft: the features transposed ([n][D][tp], head_losses_f32_transpose_kernel);
// ws: the LM body's three planes [splits][rows][t]
template <int VEC>
__global__ void __launch_bounds__(kF32Threads, kF32Blocks)
head_losses_f32_kernel(const float* __restrict__ ft,
                       const float* __restrict__ heads,
                       const int32_t* __restrict__ labels,
                       float* __restrict__ ws, int k, int t, int tp, int d,
                       int v, int rows, int vt_per_split) {
  extern __shared__ __align__(16) float f32_ring[];
  const int t_tiles = (t + kF32BT - 1) / kF32BT;
  const int tt = blockIdx.x % t_tiles;          // token tiles of one row and
  const int r = (blockIdx.x / t_tiles) % rows;  // split are neighbours
  const int split = blockIdx.x / (t_tiles * rows);
  const int node = r / k;
  const int t0 = tt * kF32BT;
  const int v_tiles = (v + kF32BV - 1) / kF32BV;
  const int vt0 = split * vt_per_split;
  const int vt1 = min(v_tiles, vt0 + vt_per_split);
  const int d_steps = (d + kF32BK - 1) / kF32BK;
  const int steps = (vt1 - vt0) * d_steps;
  const float* f = ft + static_cast<size_t>(node) * d * tp;
  const float* w = heads + static_cast<size_t>(r) * d * v;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int half = threadIdx.x % 32 & 16;  // this half warp's first lane

  // thread (ty, tx) holds tokens 4 ty + c + 64 h (i = 4 h + c) and columns
  // 4 tx + c + 64 h (j = 4 h + c); lane i < 8 of a half warp keeps token
  // i's label and triple
  const int my_tok = t0 + 4 * ty + (tx & 3) + 64 * ((tx & 7) >> 2);
  const int y_st =
      tx < 8 && my_tok < t ? labels[static_cast<size_t>(node) * t + my_tok]
                           : -1;
  float m_st = -INFINITY, s_st = 0.f, g_st = 0.f;
  float acc[8][kF32Cols];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kF32Cols; ++j) acc[i][j] = 0.f;

  f32_stage<VEC>(f32_ring, f, w, 0, steps, d_steps, vt0, t0, t, tp, d, v);
  f32_stage<VEC>(f32_ring, f, w, 1, steps, d_steps, vt0, t0, t, tp, d, v);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<1>();  // stage s has landed (for this thread's copies)
    __syncthreads();     // ... for every thread's, and slot s - 1 is free
    f32_stage<VEC>(f32_ring, f, w, s + 2, steps, d_steps, vt0, t0, t, tp, d,
                   v);
    const float* a = f32_ring + (s % kF32Stages) * kF32StageWords;
    const float* b = a + kF32AWords;
#pragma unroll
    for (int kk = 0; kk < kF32BK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(a + kk * kF32BT + 4 * ty);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a + kk * kF32BT + 64 + 4 * ty);
      const float fv[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float hv[kF32Cols];
#pragma unroll
      for (int h = 0; h < kF32Cols / 4; ++h) {
        const float4 bh = *reinterpret_cast<const float4*>(
            b + kk * kF32BV + 64 * h + 4 * tx);
        hv[4 * h] = bh.x;
        hv[4 * h + 1] = bh.y;
        hv[4 * h + 2] = bh.z;
        hv[4 * h + 3] = bh.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kF32Cols; ++j)
          acc[i][j] = fmaf(fv[i], hv[j], acc[i][j]);
    }
    if ((s + 1) % d_steps != 0) continue;

    // the vocab tile is complete: fold its logits into the triples
    const int v0 = (vt0 + s / d_steps) * kF32BV;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float m_run = __shfl_sync(kFull, m_st, half | i);
      const float s_run = __shfl_sync(kFull, s_st, half | i);
      const int y = __shfl_sync(kFull, y_st, half | i);
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kF32Cols; ++j) {
        if (v0 + 4 * tx + (j & 3) + 64 * (j >> 2) >= v) acc[i][j] = -INFINITY;
        mx = fmaxf(mx, acc[i][j]);
      }
      // finite unless the logits are: column v0 < V lies in the tile
      const float m_new = fmaxf(m_run, half_max(mx));
      const float ml = m_new * kLog2e;
      float se = 0.f;
      if (!isinf(m_new)) {
#pragma unroll
        for (int j = 0; j < kF32Cols; ++j)
          se += ex2(fmaf(acc[i][j], kLog2e, -ml));
      } else {
        // an infinite max (a +inf logit): a term at it is exp(0) = 1, as
        // in the LM body
#pragma unroll
        for (int j = 0; j < kF32Cols; ++j)
          se += acc[i][j] == m_new ? 1.f : ex2(fmaf(acc[i][j], kLog2e, -ml));
      }
      se = half_sum(se);
      const float alpha = isinf(m_new) && m_run == m_new
                              ? 1.f
                              : ex2((m_run - m_new) * kLog2e);
      const float s_new = fmaf(s_run, alpha, se);
      const int c = y - v0 - 4 * tx;  // the label's column among this lane's
      float gv = 0.f;
#pragma unroll
      for (int j = 0; j < kF32Cols; ++j)
        if (c == (j & 3) + 64 * (j >> 2)) gv = acc[i][j];
      gv = half_sum(gv);  // one lane holds the label, or none
      if (tx == i) {
        m_st = m_new;
        s_st = s_new;
        if (y >= v0 && y < v0 + kF32BV) g_st = gv;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < kF32Cols; ++j) acc[i][j] = 0.f;
  }

  if (tx < 8 && my_tok < t) {
    const size_t plane = static_cast<size_t>(gridDim.x / t_tiles) * t;
    const size_t idx = (static_cast<size_t>(split) * rows + r) * t + my_tok;
    ws[idx] = m_st;
    ws[plane + idx] = s_st;
    ws[2 * plane + idx] = g_st;
  }
}

// ---- fp32 at LM shapes on the tensor cores: 3xTF32 ----
//
// Bound. The TF32 tensor cores run 495 TFLOP/s dense, the fp32 pipes 67.
// One TF32 product keeps 10 mantissa bits of each operand (logits off by
// about 1e-3 at an LM's shapes), so the function stays fp32's only through
// the 3xTF32 split: x = big + small with big = tf32(x), small =
// tf32(x - big), and x y ~ small_x big_y + big_x small_y + big_x big_y
// (the small x small term and small's own rounding are below fp32's
// rounding of the sum). Three TF32 products of 2 n K T D V FLOP each: at
// n * K = 2, T = 2048 (or n * K = 4, T = 1024), D = 2048, V = 128,256 that
// is 6.45 TFLOP, 13.0 ms at 495 TFLOP/s, against 32.1 ms for the fp32
// pipes' one product and 1.25 ms to read the heads once.
//
// Constraint. wgmma reads a tf32 operand from shared memory only K-major
// (the transpose immediates exist for 16-bit types alone), and the heads
// are [D, V] with V contiguous, MN-major. So the logit tile is computed
// transposed, [vocab x tokens] = heads^T feats^T: A, the head slab, comes
// from registers (wgmma takes a tf32 A there at m64nNk8), B, the features,
// from shared memory, K-major as they lie ([T][D], D contiguous).
//
// Design. A first launch (head_losses_tf32_split_kernel) splits the
// features into two planes of TF32 words, big and small, [2][n][T][D4]
// with D4 = D rounded up to 4 and zeros past D, in the workspace (16 MB a
// plane and node at T 2048, D 2048). Where V is not a multiple of 4 the
// heads are copied into rows of V4 values (head_losses_pad_kernel), so a
// head row is whole 16-byte chunks as TMA needs; a head pointer off
// 16-byte alignment with V a multiple of 4 is refused. The tile kernel
// has the tensor-core body's grid, V-split and warp specialisation: a
// block takes one (row, 128-token tile, range of 128-column vocab tiles);
// a producer warpgroup (registers cut by setmaxnreg) keeps kTcStages = 4
// stages of 48 KB in flight by TMA, each one D chunk of 32: the two
// feature planes [128 tokens][32] (16 KB each) and the head slab
// [32][128 columns] as four boxes of 32 columns, all with the 128-byte
// swizzle. Two consumer warpgroups each own 64 of the tile's columns (the
// wgmma's M) and all 128 tokens (its N): for each D chunk a thread loads
// its A fragments of four 8-deep k-steps from the head slab, splits each
// value into big and small in registers (cvt.rna.tf32.f32, tf32_split:
// a non-finite value goes whole into small, so that a +inf weight gives
// +inf logits and not inf 0 = NaN), and issues per k-step three wgmma
// m64n128k8 into one fp32 accumulator of 64 registers, small_head
// big_feat, then big_head small_feat, then big_head big_feat; then it
// waits for them (wgmma.wait_group 0: A's registers are read
// asynchronously), hands the stage back and adds the stage's sums into a
// second accumulator of 64 registers by fp32 adds. The tensor cores add
// into their accumulator with truncation: a single accumulator over D
// 1600 or 2048 (600 or 768 steps) failed chip_smoke.py's float64 witness
// gate on the card (PERF.md, PR 35); restarted each stage (12 steps over
// 32 rows of D) and summed to nearest outside, the logits keep fp32's
// accuracy (the numpy model of both in tests/test_torch_head_select_tc32.py).
// The fragment rows are a fixed permutation of the
// warp's 16 columns chosen so that a fragment load's 32 lanes, four d rows
// of eight columns, hit 32 distinct banks under the swizzle.
//
// Fold. A token's 64 logits of a consumer lie in one column of its
// accumulator, over the 8 lanes of a quad column in each of its 4 warps.
// After a vocab tile's last chunk, in three named-barrier steps: each
// warp's max by shuffles (xor 4, 8, 16) to shared memory; thread i of the
// warpgroup takes token i's new running max over the 4 warps' and its old;
// each thread sums exp2 of its 2 logits a token after the log2(e)
// pre-scale (a term at a +inf max counts 1), the warp by the same
// shuffles, and thread i adds the 4 warps' sums in warp order and updates
// token i's (max, sum-exp) pair as the other tiled bodies do, and the gold
// logit where the label lies in the consumer's columns (picked, summed
// with zeros). Columns past V are -inf; a consumer whose columns are all
// past V keeps (-inf, 0). Each (split, consumer, row, token) triple goes
// to the workspace, and head_losses_lm_merge merges them in that index
// order.
//
// Order. Every sum is in a fixed order: the three products a k-step and
// the k-steps of a stage in the order of d into the tensor cores'
// accumulator, the stages in the order of d into the second, the fold in
// warp
// order and butterflies, the vocab tiles in order inside a split, the
// merge in split order and its fixed tree. No atomics.

constexpr int kTcBT = 128;                // tokens per tile: the wgmma's N
constexpr int kTcConsumers = 2;           // warpgroups running wgmma
constexpr int kTcBV = 64 * kTcConsumers;  // vocab columns per tile
constexpr int kTcBK = 32;                 // D per stage: 128-byte rows
constexpr int kTcStages = 4;
constexpr int kTcThreads = 128 * (kTcConsumers + 1);
// registers a producer and a consumer thread keep after setmaxnreg (the
// 65,536 of an SM over the block's 384 threads)
constexpr int kTcProducerRegs = 40;
constexpr int kTcConsumerRegs = 232;
constexpr uint32_t kTcPlaneBytes = 4u * kTcBT * kTcBK;  // 16 KB a plane
constexpr uint32_t kTcBoxBytes = 4u * kTcBK * 32;       // 4 KB a head box
constexpr uint32_t kTcStage = 2 * kTcPlaneBytes + 4u * kTcBK * kTcBV;
// a consumer's fold scratch: the warps' maxes, sums and gold logits [4][BT],
// the new maxes [BT] and the labels [BT]
constexpr int kTcFoldWords = 14 * kTcBT;
constexpr int kTcSmemBytes = kTcStages * kTcStage + 16 * kTcStages +
                             4 * kTcFoldWords * kTcConsumers + 1024;

// x rounded to TF32 (round to nearest, ties away), its low 13 bits zero
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(y) : "f"(x));
  return y & 0xffffe000u;
}

// x = big + small to about 22 bits, both TF32 words, big truncated where
// rounding would pass FLT_MAX. A non-finite x goes whole into small (NaN as
// a NaN whose top 10 mantissa bits are not all 0) and big is 0: of the
// three products, small_x big_y carries x y where y is finite, and
// big_x small_y and big_x big_y are 0 (with x in big they would be
// x small_y = inf 0 = NaN wherever y is exact in TF32, as a feature of 1
// is); the same rule for y makes the products of a finite x and a
// non-finite y x y too. Only inf times inf gives NaN, not inf.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  if (!isfinite(x)) {
    big = 0u;
    small = tf32_rna(x);
    return;
  }
  uint32_t b = tf32_rna(x);
  if (!isfinite(__uint_as_float(b))) b = __float_as_uint(x) & 0xffffe000u;
  big = b;
  small = tf32_rna(x - __uint_as_float(b));
}

// planes [2][rows][d4] = (big, small) of x [rows][d], zero past d
__global__ void __launch_bounds__(256)
head_losses_tf32_split_kernel(const float* __restrict__ x,
                              uint32_t* __restrict__ planes, long long rows,
                              int d, int d4) {
  const long long total = rows * d4;
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * 256) {
    const long long row = i / d4;
    const int c = static_cast<int>(i % d4);
    uint32_t big = 0, small = 0;
    if (c < d) tf32_split(x[row * d + c], big, small);
    planes[i] = big;
    planes[total + i] = small;
  }
}

// d[64] (+)= A[64 x 8] B[8 x 128] in tf32, fp32 accumulator; A from
// registers, B K-major in shared memory; scale_d == 0 starts from zero
#define HS_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HS_D16(i) HS_D4(i), HS_D4(i + 4), HS_D4(i + 8), HS_D4(i + 12)
__device__ __forceinline__ void wgmma_tf32_m64n128k8(float (&d)[64],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %68, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9,"
      " %10, %11, %12, %13, %14, %15, %16, %17, %18, %19,"
      " %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      " %30, %31, %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %69, p, 1, 1;\n}\n"
      : HS_D16(0), HS_D16(16), HS_D16(32), HS_D16(48)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(scale_d), "l"(db));
}
#undef HS_D16
#undef HS_D4

__device__ __forceinline__ float ld_shared(uint32_t addr) {
  float x;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(x) : "r"(addr) : "memory");
  return x;
}

// the 128 threads of consumer warpgroup `wg` meet (barrier 0 is the
// block's)
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// exp(z - m) for a logit z against the running max m (ml = m log2(e)): a
// term at a +inf max counts 1 (not exp(inf - inf) = NaN), under a -inf max
// (columns past V, or NaN alone) a -inf term counts 0, and a NaN stays NaN
__device__ __forceinline__ float tc_term(float z, float m, float ml) {
  if (m == -INFINITY) return z == m ? 0.f : z;
  if (m == INFINITY && z == m) return 1.f;
  return ex2(fmaf(z, kLog2e, -ml));
}

// pf: the feature planes as (D, T, 2 n), box (32, 128, 1), the small plane
// of node i at i + n; hmap: the heads as (V, D, row), box (32, 32, 1). ws:
// three planes [splits][consumers][rows][t] of (max, sum-exp, gold).
__global__ void __launch_bounds__(kTcThreads, 1)
head_losses_f32tc_kernel(const __grid_constant__ CUtensorMap pf,
                         const __grid_constant__ CUtensorMap hmap,
                         const int32_t* __restrict__ labels,
                         float* __restrict__ ws, int n, int k, int t, int d,
                         int v, int rows, int vt_per_split) {
  extern __shared__ unsigned char tc_smem[];
  const uint32_t ring = (smem_addr(tc_smem) + 1023u) & ~1023u;
  const uint32_t full = ring + kTcStages * kTcStage;  // kTcStages mbarriers
  const uint32_t empty = full + 8 * kTcStages;        // and kTcStages more
  float* scratch = reinterpret_cast<float*>(
      tc_smem + (ring - smem_addr(tc_smem)) + kTcStages * kTcStage +
      16 * kTcStages);
  const int t_tiles = (t + kTcBT - 1) / kTcBT;
  const int tt = blockIdx.x % t_tiles;          // token tiles of one row and
  const int r = (blockIdx.x / t_tiles) % rows;  // split are neighbours
  const int split = blockIdx.x / (t_tiles * rows);
  const int node = r / k;
  const int t0 = tt * kTcBT;
  const int v_tiles = (v + kTcBV - 1) / kTcBV;
  const int vt0 = split * vt_per_split;
  const int vt1 = min(v_tiles, vt0 + vt_per_split);
  const int d_steps = (d + kTcBK - 1) / kTcBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(full + 8 * s, 1);                  // the producer's
      mbar_init(empty + 8 * s, 4 * kTcConsumers);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kTcConsumers) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kTcProducerRegs));
    if (threadIdx.x % 128 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int vt = vt0; vt < vt1; ++vt)
        for (int j = 0; j < d_steps; ++j) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // the first round passes
          const uint32_t a = ring + stage * kTcStage;
          const uint32_t bar = full + 8 * stage;
          mbar_expect_tx(bar, kTcStage);
          tma_load(a, &pf, bar, j * kTcBK, t0, node);
          tma_load(a + kTcPlaneBytes, &pf, bar, j * kTcBK, t0, n + node);
#pragma unroll
          for (int c = 0; c < kTcBV / 32; ++c)
            tma_load(a + 2 * kTcPlaneBytes + c * kTcBoxBytes, &hmap, bar,
                     vt * kTcBV + 32 * c, j * kTcBK, r);
          if (++stage == kTcStages) {
            stage = 0;
            phase ^= 1;
          }
        }
    }
    return;
  }

  // ---- consumers: warpgroup wg takes columns 64 wg .. + 64 of a tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kTcConsumerRegs));
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4;  // row of the fragment within an 8-row group
  const int q = lane % 4;  // its k (A) or column pair (accumulator)
  float* wmax = scratch + wg * kTcFoldWords;  // [4][BT]
  float* wsum = wmax + 4 * kTcBT;             // [4][BT]
  float* wgold = wsum + 4 * kTcBT;            // [4][BT]
  float* mnew = wgold + 4 * kTcBT;            // [BT]
  int* lab = reinterpret_cast<int*>(mnew + kTcBT);  // [BT]
  // token tid's triple and label (thread tid keeps them)
  const int my_tok = t0 + tid;
  const int y_own =
      my_tok < t ? labels[static_cast<size_t>(node) * t + my_tok] : -1;
  lab[tid] = y_own;
  float m_run = -INFINITY, s_run = 0.f, g_run = 0.f;
  // Accumulator row 16 warp + g + 8 h (the A fragment's row too) is the
  // consumer's column 32 (warp / 2) + col[h]: a permutation of the 16 rows
  // that puts a fragment load's 32 lanes (rows q and q + 4 of a k-step,
  // eight columns) on distinct banks of the swizzled box.
  int col[2];
  uint32_t off[4];  // a0..a3's byte offsets in the box at k-step 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int chunk = 2 * (warp % 2) + h + 4 * (g / 4);
    col[h] = 32 * (warp / 2) + 4 * chunk + g % 4;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {  // a0, a1: row q; a2, a3: row q + 4
      const int row = q + 4 * hi;
      off[2 * hi + h] =
          row * 128 + ((chunk ^ row) << 4) + 4 * (g % 4);
    }
  }
  const uint32_t box = (2 * wg + warp / 2) * kTcBoxBytes;

  // acc: the tensor cores' sum over one stage's 32 rows of D; sum: the
  // vocab tile's logits, the stages' sums added in order by fp32 adds
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int vt = vt0; vt < vt1; ++vt) {
    for (int j = 0; j < d_steps; ++j) {
      mbar_wait(full + 8 * stage, phase);
      const uint32_t a = ring + stage * kTcStage;
      const uint32_t hb = a + 2 * kTcPlaneBytes + box;
      uint32_t big[kTcBK / 8][4], small[kTcBK / 8][4];
#pragma unroll
      for (int kk = 0; kk < kTcBK / 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          tf32_split(ld_shared(hb + 1024 * kk + off[i]), big[kk][i],
                     small[kk][i]);
      acc_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcBK / 8; ++kk) {
        // B: +32 bytes a k-step inside the swizzled 128-byte rows, 8-row
        // groups 1024 bytes apart; the small plane kTcPlaneBytes on
        const uint64_t fb = gmma_desc(a + 32 * kk, 16, 1024);
        const uint64_t fs = gmma_desc(a + kTcPlaneBytes + 32 * kk, 16, 1024);
        wgmma_tf32_m64n128k8(acc, small[kk], fb, kk > 0);
        wgmma_tf32_m64n128k8(acc, big[kk], fs, 1);
        wgmma_tf32_m64n128k8(acc, big[kk], fb, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();  // A's registers are free, the stage consumed
      acc_fence(acc);
      if (lane == 0) mbar_arrive(empty + 8 * stage);
      if (++stage == kTcStages) {
        stage = 0;
        phase ^= 1;
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) sum[i] = j > 0 ? sum[i] + acc[i] : acc[i];
    }

    // the vocab tile is complete: fold its logits into the triples
    const int c0 = vt * kTcBV + 64 * wg;  // the consumer's first column
    if (c0 + 64 > v) {
#pragma unroll
      for (int i = 0; i < 64; ++i)
        if (c0 + col[(i / 2) % 2] >= v) sum[i] = -INFINITY;
    }
    // sum i holds row 16 warp + g + 8 ((i / 2) % 2), token
    // 8 (i / 4) + 2 q + i % 2
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = fmaxf(sum[4 * jn + e], sum[4 * jn + 2 + e]);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
        if (g == 0) wmax[warp * kTcBT + 8 * jn + 2 * q + e] = mx;
      }
    consumer_sync(wg);
    const float m_new =
        fmaxf(m_run, fmaxf(fmaxf(wmax[tid], wmax[kTcBT + tid]),
                           fmaxf(wmax[2 * kTcBT + tid],
                                 wmax[3 * kTcBT + tid])));
    mnew[tid] = m_new;
    consumer_sync(wg);
#pragma unroll
    for (int jn = 0; jn < 16; ++jn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int tok = 8 * jn + 2 * q + e;
        const float m = mnew[tok];
        const float ml = m * kLog2e;
        const float z0 = sum[4 * jn + e], z1 = sum[4 * jn + 2 + e];
        float se = tc_term(z0, m, ml) + tc_term(z1, m, ml);
        const int c = lab[tok] - c0;  // the label's column among the 64
        float gv = c == col[0] ? z0 : (c == col[1] ? z1 : 0.f);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          se += __shfl_xor_sync(kFull, se, o);
          gv += __shfl_xor_sync(kFull, gv, o);
        }
        if (g == 0) {
          wsum[warp * kTcBT + tok] = se;
          wgold[warp * kTcBT + tok] = gv;
        }
      }
    consumer_sync(wg);
    const float se = ((wsum[tid] + wsum[kTcBT + tid]) +
                      wsum[2 * kTcBT + tid]) + wsum[3 * kTcBT + tid];
    // the running sum's factor is 1 where the max stays (an infinite one
    // too)
    const float alpha =
        m_run == m_new ? 1.f : ex2((m_run - m_new) * kLog2e);
    s_run = fmaf(s_run, alpha, se);
    m_run = m_new;
    if (y_own >= c0 && y_own < c0 + 64)
      g_run = ((wgold[tid] + wgold[kTcBT + tid]) + wgold[2 * kTcBT + tid]) +
              wgold[3 * kTcBT + tid];
  }

  if (my_tok < t) {
    const size_t plane =
        static_cast<size_t>(gridDim.x / t_tiles) * kTcConsumers * t;
    const size_t idx =
        ((static_cast<size_t>(split) * kTcConsumers + wg) * rows + r) * t +
        my_tok;
    ws[idx] = m_run;
    ws[plane + idx] = s_run;
    ws[2 * plane + idx] = g_run;
  }
}

// dst [rows][pitch] = src [rows][cols] (E of 2 or 4 bytes, pitch a multiple
// of 16 bytes and at least cols; the pad zeroed): one thread writes 16
// bytes
template <typename E>
__global__ void head_losses_pad_kernel(const E* __restrict__ src,
                                       E* __restrict__ dst, long long rows,
                                       int cols, int pitch) {
  constexpr int kPer = 16 / sizeof(E);
  const long long chunks = pitch / kPer;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < rows * chunks; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long row = i / chunks;
    const int c0 = static_cast<int>(i % chunks) * kPer;
    const E* s = src + row * cols;
    alignas(16) E out[kPer];
#pragma unroll
    for (int e = 0; e < kPer; ++e) out[e] = c0 + e < cols ? s[c0 + e] : 0;
    *reinterpret_cast<uint4*>(dst + row * pitch + c0) =
        *reinterpret_cast<const uint4*>(out);
  }
}

// ---- dispatch and launch ----

enum Body { kFma = 0, kF32Tiled = 1, kTensorCore = 2, kF32TensorCore = 3 };

// The dispatch rule (ops.py::body_for mirrors it). bf16 goes to the tensor
// cores where its rows are whole 16-byte chunks (D and V multiples of 8,
// no copy) or V is at least one of their 256-column vocab tiles (a ragged
// D or V then padded); fp32 goes to the tiled bodies from one of their
// 128-column vocab tiles up: to the tensor cores (3xTF32) from
// kF32TcMinD rows of D up, else to the SIMT body. Everything else, and T,
// D or V of 0 (an empty tile grid), takes the FMA body.
int body_for(int t, int d, int v, int dtype) {
  if (t <= 0 || d <= 0 || v <= 0) return kFma;
  if (dtype == 1 && ((d % 8 == 0 && v % 8 == 0) || v >= kLmBV))
    return kTensorCore;
  if (dtype == 0 && v >= kF32MinV)
    return d >= kF32TcMinD ? kF32TensorCore : kF32Tiled;
  return kFma;
}

// whether `body` takes this input (the FMA body takes every one)
bool body_takes(int body, int t, int d, int v, int dtype) {
  if (body == kFma) return dtype == 0 || dtype == 1;
  if (t <= 0 || d <= 0 || v <= 0) return false;
  return ((body == kF32Tiled || body == kF32TensorCore) && dtype == 0) ||
         (body == kTensorCore && dtype == 1);
}

// Blocks resident per SM of `kernel` (set once; the shared-memory
// attribute is set first)
template <typename K>
int blocks_per_sm(K kernel, int threads, int smem, int* cache,
                  cudaError_t* err) {
  if (*cache == 0) {
    *err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(cache, kernel,
                                                         threads, smem);
    if (*err != cudaSuccess) return 0;
  }
  *err = cudaSuccess;
  return *cache;
}

// Blocks resident per SM of the tensor-core kernels, or of the fp32 SIMT
// kernel with `vec4` copies (the 16-byte one sets the split count of both:
// they take the same shared memory and register cap)
int body_blocks_per_sm(int body, bool vec4, cudaError_t* err) {
  static int lm = 0, tc = 0, f32_1 = 0, f32_4 = 0;
  if (body == kTensorCore)
    return blocks_per_sm(head_losses_lm_kernel, kLmThreads, kLmSmemBytes, &lm,
                         err);
  if (body == kF32TensorCore)
    return blocks_per_sm(head_losses_f32tc_kernel, kTcThreads, kTcSmemBytes,
                         &tc, err);
  return vec4 ? blocks_per_sm(head_losses_f32_kernel<4>, kF32Threads,
                              kF32SmemBytes, &f32_4, err)
              : blocks_per_sm(head_losses_f32_kernel<1>, kF32Threads,
                              kF32SmemBytes, &f32_1, err);
}

// Tokens and vocab columns of a tiled body's tile
int tile_tokens(int body) {
  return body == kTensorCore ? kLmBT : body == kF32TensorCore ? kTcBT
                                                              : kF32BT;
}

int tile_columns(int body) {
  return body == kTensorCore ? kLmBV : body == kF32TensorCore ? kTcBV
                                                              : kF32BV;
}

// Vocab tiles per V-split: as many splits as fill one wave of the card
int vt_per_split(int body, int rows, int t, int v, cudaError_t* err) {
  const int per_sm = body_blocks_per_sm(body, true, err);
  if (*err != cudaSuccess) return 0;
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  const int bt = tile_tokens(body);
  const int v_tiles = (v + tile_columns(body) - 1) / tile_columns(body);
  const long long base = static_cast<long long>(rows) * ((t + bt - 1) / bt);
  const long long fill = static_cast<long long>(per_sm) * sms / base;
  const int splits = static_cast<int>(
      fill < 1 ? 1 : (fill > v_tiles ? v_tiles : fill));
  return (v_tiles + splits - 1) / splits;
}

int splits_of(int body, int v, int vt_per_split) {
  const int bv = tile_columns(body);
  return ((v + bv - 1) / bv + vt_per_split - 1) / vt_per_split;
}

long long round256(long long bytes) { return (bytes + 255) / 256 * 256; }

int round8(int x) { return (x + 7) / 8 * 8; }

int round4(int x) { return (x + 3) / 4 * 4; }

// 16-byte copies of the heads in the fp32 body: rows of whole 16-byte
// chunks, aligned
bool f32_vec4(const void* heads, int v) {
  return v % 4 == 0 && reinterpret_cast<uintptr_t>(heads) % 16 == 0;
}

// The workspace of a tiled body: the three planes of triples (the fp32
// tensor-core body's a consumer a split), then the features transposed
// (the fp32 SIMT body), split into two TF32 planes (the fp32 tensor-core
// body) or padded (the bf16 tensor-core body with a ragged D), and the
// heads padded (a ragged V on the tensor cores), each on a 256-byte
// boundary.
struct Workspace {
  int per, splits;
  long long triples, feats, heads;  // bytes of each part
};

Workspace workspace_of(int body, int n, int k, int t, int d, int v,
                       cudaError_t* err) {
  Workspace w{};
  const int rows = n * k;
  w.per = vt_per_split(body, rows, t, v, err);
  if (*err != cudaSuccess) return w;
  w.splits = splits_of(body, v, w.per);
  const int entries = w.splits * (body == kF32TensorCore ? kTcConsumers : 1);
  w.triples = round256(3LL * sizeof(float) * entries * rows * t);
  if (body == kF32Tiled) w.feats = round256(4LL * n * d * round4(t));
  if (body == kTensorCore) {
    if (d % 8) w.feats = round256(2LL * n * t * round8(d));
    if (v % 8) w.heads = round256(2LL * rows * d * round8(v));
  }
  if (body == kF32TensorCore) {
    w.feats = round256(8LL * n * t * round4(d));
    if (v % 4) w.heads = round256(4LL * rows * d * round4(v));
  }
  return w;
}

// A grid-stride launch's blocks of 256 threads for `work` items
unsigned stride_grid(long long work) {
  const long long blocks = (work + 255) / 256;
  return static_cast<unsigned>(
      blocks < 132 * 16 ? (blocks > 0 ? blocks : 1) : 132 * 16);
}

// dst [rows][pitch] = src [rows][cols] of E (bf16 as uint16_t, fp32 as
// uint32_t), the pad zeroed
template <typename E>
cudaError_t pad_rows(const void* src, void* dst, long long rows, int cols,
                     int pitch, cudaStream_t s) {
  head_losses_pad_kernel<E><<<stride_grid(rows * (pitch * sizeof(E) / 16)),
                              256, 0, s>>>(static_cast<const E*>(src),
                                           static_cast<E*>(dst), rows, cols,
                                           pitch);
  return cudaGetLastError();
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

// A tensor [outer][mid][inner] of bf16 (`fp32` false) or 4-byte words whose
// rows are `pitch` >= inner values apart, as a 3-D map of extent (inner,
// mid, outer) with boxes of (128 bytes, box_mid, 1), the 128-byte swizzle
// and zero fill out of bounds
cudaError_t make_map(EncodeTiled fn, CUtensorMap* map, const void* base,
                     bool fp32, int inner, int pitch, int mid, int outer,
                     int box_mid) {
  const cuuint64_t es = fp32 ? 4 : 2;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(mid),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[2] = {es * pitch, es * pitch * mid};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / es),
                             static_cast<cuuint32_t>(box_mid), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = fn(
      map,
      fp32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

int launch_lm(const void* feats, const void* heads, const int32_t* labels,
              float* out, float* ws, int n, int k, int t, int d, int v,
              cudaStream_t s) {
  const bool pad_f = d % 8 != 0, pad_h = v % 8 != 0;
  if ((!pad_f && reinterpret_cast<uintptr_t>(feats) % 16) ||
      (!pad_h && reinterpret_cast<uintptr_t>(heads) % 16))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n * k;
  cudaError_t err;
  const Workspace w = workspace_of(kTensorCore, n, k, t, d, v, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(w.splits) * rows * ((t + kLmBT - 1) / kLmBT);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  char* base = reinterpret_cast<char*>(ws);
  const void* fsrc = feats;
  const void* hsrc = heads;
  if (pad_f) {
    fsrc = base + w.triples;
    err = pad_rows<uint16_t>(feats, base + w.triples,
                             static_cast<long long>(n) * t, d, round8(d), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (pad_h) {
    hsrc = base + w.triples + w.feats;
    err = pad_rows<uint16_t>(heads, base + w.triples + w.feats,
                             static_cast<long long>(rows) * d, v, round8(v),
                             s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const EncodeTiled fn = encode_tiled(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap fmap, hmap;
  err = make_map(fn, &fmap, fsrc, false, d, pad_f ? round8(d) : d, t, n,
                 kLmBT);
  if (err == cudaSuccess)
    err = make_map(fn, &hmap, hsrc, false, v, pad_h ? round8(v) : v, d, rows,
                   kLmBD);
  if (err != cudaSuccess) return static_cast<int>(err);
  head_losses_lm_kernel<<<static_cast<unsigned>(blocks), kLmThreads,
                          kLmSmemBytes, s>>>(fmap, hmap, labels, ws, k, t, d,
                                             v, rows, w.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  head_losses_lm_merge<<<rows, kMergeThreads, 0, s>>>(ws, labels, out, k, t,
                                                      rows, w.splits);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const void* feats, const void* heads, const int32_t* labels,
               float* out, float* ws, int n, int k, int t, int d, int v,
               cudaStream_t s) {
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n * k;
  const bool vec4 = f32_vec4(heads, v);
  cudaError_t err;
  const Workspace w = workspace_of(kF32Tiled, n, k, t, d, v, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!vec4) {
    body_blocks_per_sm(kF32Tiled, false, &err);  // sets its smem attribute
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks =
      static_cast<long long>(w.splits) * rows * ((t + kF32BT - 1) / kF32BT);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid.z
  const int tp = round4(t);
  float* ft = reinterpret_cast<float*>(reinterpret_cast<char*>(ws) +
                                       w.triples);
  const dim3 tgrid((tp + 31) / 32, (d + 31) / 32, n);
  head_losses_f32_transpose_kernel<<<tgrid, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(feats), ft, t, d, tp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* h = static_cast<const float*>(heads);
  if (vec4)
    head_losses_f32_kernel<4><<<static_cast<unsigned>(blocks), kF32Threads,
                                kF32SmemBytes, s>>>(ft, h, labels, ws, k, t,
                                                    tp, d, v, rows, w.per);
  else
    head_losses_f32_kernel<1><<<static_cast<unsigned>(blocks), kF32Threads,
                                kF32SmemBytes, s>>>(ft, h, labels, ws, k, t,
                                                    tp, d, v, rows, w.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  head_losses_lm_merge<<<rows, kMergeThreads, 0, s>>>(ws, labels, out, k, t,
                                                      rows, w.splits);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32tc(const void* feats, const void* heads, const int32_t* labels,
                 float* out, float* ws, int n, int k, int t, int d, int v,
                 cudaStream_t s) {
  const bool pad_h = v % 4 != 0;
  if (!pad_h && reinterpret_cast<uintptr_t>(heads) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (ws == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = n * k;
  cudaError_t err;
  const Workspace w = workspace_of(kF32TensorCore, n, k, t, d, v, &err);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks =
      static_cast<long long>(w.splits) * rows * ((t + kTcBT - 1) / kTcBT);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  char* base = reinterpret_cast<char*>(ws);
  const long long feat_rows = static_cast<long long>(n) * t;
  head_losses_tf32_split_kernel<<<stride_grid(feat_rows * round4(d)), 256, 0,
                                  s>>>(static_cast<const float*>(feats),
                                       reinterpret_cast<uint32_t*>(
                                           base + w.triples),
                                       feat_rows, d, round4(d));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* hsrc = heads;
  if (pad_h) {
    hsrc = base + w.triples + w.feats;
    err = pad_rows<uint32_t>(heads, base + w.triples + w.feats,
                             static_cast<long long>(rows) * d, v, round4(v),
                             s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const EncodeTiled fn = encode_tiled(&err);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap pf, hmap;
  err = make_map(fn, &pf, base + w.triples, true, d, round4(d), t, 2 * n,
                 kTcBT);
  if (err == cudaSuccess)
    err = make_map(fn, &hmap, hsrc, true, v, pad_h ? round4(v) : v, d, rows,
                   kTcBK);
  if (err != cudaSuccess) return static_cast<int>(err);
  head_losses_f32tc_kernel<<<static_cast<unsigned>(blocks), kTcThreads,
                             kTcSmemBytes, s>>>(pf, hmap, labels, ws, n, k, t,
                                                d, v, rows, w.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  head_losses_lm_merge<<<rows, kMergeThreads, 0, s>>>(
      ws, labels, out, k, t, rows, w.splits * kTcConsumers);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The body hs_head_losses runs for this input: 0 = FMA, 1 = fp32 tiled
// (SIMT), 2 = tensor cores (bf16), 3 = fp32 on the tensor cores (3xTF32)
// (ops.py::body_for gives the same answer).
extern "C" int hs_body(int n, int k, int t, int d, int v, int dtype) {
  (void)n;
  (void)k;
  return body_for(t, d, v, dtype);
}

// Bytes of the workspace that `body` needs for this input (0 for the FMA
// body), or -1 with the CUDA error unreadable here: a later launch reports
// it.
extern "C" long long hs_workspace_bytes_for(int body, int n, int k, int t,
                                            int d, int v, int dtype) {
  if (body == kFma || n * k == 0 || !body_takes(body, t, d, v, dtype))
    return 0;
  cudaError_t err;
  const Workspace w = workspace_of(body, n, k, t, d, v, &err);
  if (err != cudaSuccess) return -1;
  return w.triples + w.feats + w.heads;
}

extern "C" long long hs_workspace_bytes(int n, int k, int t, int d, int v,
                                        int dtype) {
  return hs_workspace_bytes_for(body_for(t, d, v, dtype), n, k, t, d, v,
                                dtype);
}

// dtype: 0 = fp32, 1 = bf16. Runs `body` (which must take the input, else
// cudaErrorInvalidValue): the tiled bodies take `workspace`
// (hs_workspace_bytes_for of it) and launch twice (the bf16 tensor-core
// body, or three or four times where it pads D or V) or three times (the
// fp32 bodies: a first pass over the features, and the fp32 tensor-core
// body four where it pads V); the FMA body ignores it and launches once. Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when the launches were accepted).
extern "C" int hs_head_losses_for(int body, const void* feats,
                                  const void* heads, const void* labels,
                                  void* out, void* workspace, int n, int k,
                                  int t, int d, int v, int dtype,
                                  void* stream) {
  if (!body_takes(body, t, d, v, dtype))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float* o = static_cast<float*>(out);
  float* ws = static_cast<float*>(workspace);
  if (body == kTensorCore)
    return launch_lm(feats, heads, lab, o, ws, n, k, t, d, v, s);
  if (body == kF32Tiled)
    return launch_f32(feats, heads, lab, o, ws, n, k, t, d, v, s);
  if (body == kF32TensorCore)
    return launch_f32tc(feats, heads, lab, o, ws, n, k, t, d, v, s);
  if (dtype == 0) return launch<float>(feats, heads, lab, o, n, k, t, d, v, s);
  return launch<__nv_bfloat16>(feats, heads, lab, o, n, k, t, d, v, s);
}

// hs_head_losses_for with the body hs_body picks
extern "C" int hs_head_losses(const void* feats, const void* heads,
                              const void* labels, void* out, void* workspace,
                              int n, int k, int t, int d, int v, int dtype,
                              void* stream) {
  return hs_head_losses_for(body_for(t, d, v, dtype), feats, heads, labels,
                            out, workspace, n, k, t, d, v, dtype, stream);
}

// The tensor-core body's copy of a ragged D or V alone, for timing it:
// dst [rows][pitch] bf16 = src [rows][cols], the pad zeroed.
extern "C" int hs_pad_rows(const void* src, void* dst, long long rows,
                           int cols, int pitch, void* stream) {
  if (pitch % 8 || pitch < cols ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(pad_rows<uint16_t>(
      src, dst, rows, cols, pitch, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* hs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
