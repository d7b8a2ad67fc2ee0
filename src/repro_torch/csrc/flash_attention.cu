// Causal (optionally sliding-window) GQA attention over a full sequence on
// Hopper: the prefill and forward attention of the language models.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py ::
// flash_attention (body _attn_kernel):
//   q [B, S, Hq, D], k/v [B, S, Hkv, D] (the model's layout; the TPU
//   kernel takes [B, H, S, D]), positions arange(S)
//   -> o [B, S, Hq, D] in q's dtype; query head h reads kv head
//      h / (Hq / Hkv), with no repeated k/v.
// D in {32, 64, 128, 160} (a template parameter; 160 is stablelm-12b's
// head, and MLA's q.k 96 and v 64 reach the kernel zero-padded to 128 by
// the caller). Scores, the running max and
// sum and the accumulator are fp32; masked scores drop out of the softmax
// as the reference's -1e30 does, and the row sum is clamped at 1e-30. Both
// kernels mask the ragged tail (rows and keys at or past S) themselves, so
// any S works (the TPU kernel's n_q = S / block_q dropped the rows of a
// last partial tile), and skip the kv tiles that the causal and window
// limits mask entirely.
//
// bf16 inputs (the serving path): fa_bf16_kernel, on the tensor cores.
// One block of 4 warps per (b * Hq + h, tile of 64 query rows); each warp
// owns 16 query rows. The grid puts the query tiles in y, last tile first,
// so under the causal mask the blocks with the most kv tiles start first.
// - K and V tiles of 64 rows x D come straight from the model's layout, in
//   bf16, by 16-byte cp.async copies into a ring of two stages: tile j + 1
//   loads while tile j is computed. Rows at or past S are zero-filled. The
//   shared layout XORs each 16-byte chunk's place in its 128-byte line with
//   the row, so that every ldmatrix below is free of bank conflicts (at D
//   160 too, whose 320-byte rows are not whole lines: see swz).
// - Q's A fragments are loaded once, by ldmatrix, into registers.
// - S = Q K^T runs as mma.sync m16n8k16 bf16 x bf16 -> fp32, K's B
//   fragments by ldmatrix. The products of bf16 are exact, but the tensor
//   cores' fp32 sums are a little less exact than a chain of fp32 FMAs:
//   with scores of tens (q and k at 3 randn), a few outputs in ten
//   million miss one bf16 ulp of the fp32 answer where the FMA kernel
//   misses none (tools/fa_accuracy.py). The scale is applied to the fp32
//   scores, and exp(x - m) is taken as exp2((x - m) log2 e), so that
//   x - m is exact near the max, where the weights count.
// - The online max and sum run in registers, reduced over the 4 lanes of a
//   row with shuffles. The m16n8 accumulator layout of the scores is the A
//   fragment layout of P V, so P never leaves registers.
// - P V runs as three mma.sync per fragment on the same V fragment (from
//   ldmatrix.trans), one for each bf16 term of P = P_0 + P_1 + P_2 (P_0 =
//   bf16(P), P_1 = bf16(P - P_0), ...; each difference is exact, so the
//   terms carry P's 24 bits), smallest first. Rounding P to bf16 once (as
//   library flash attention does) puts about a quarter of the outputs more
//   than one bf16 ulp from the fp32 answer; two terms (P to about 2^-17)
//   still miss it at large scores. The row sum is taken from the fp32 P.
// - The output is divided by the row sum, rounded to bf16 once, staged in
//   the Q tile's shared memory and written with 16-byte stores.
//
// fp32 inputs: fa_kernel, on the FMA units. One block of 256 threads per
// (b * Hq + h, tile of 64 query rows) stages its query tile in shared
// memory, then walks the key/value tiles of 64 rows; for each tile the
// threads form a 16 x 16 grid: thread (ty, tx) computes the scores of rows
// ty + 16i and columns tx + 16j (i, j < 4) from shared memory, the 16
// threads of a row fold them into the online max and sum with shuffles,
// the probabilities go to shared memory, and each thread adds P V to its
// rows' D / 16 output columns tx + 16n, held in registers. Rows are padded
// by one float so that the column-wise reads hit distinct banks.
//
// Bound on this card. At llama3.2-1b's serving shape (B 4, S 512, Hq 32,
// Hkv 8, D 64, bf16) the kernel moves 21 MB (q and o 8.4 MB each, k and v
// 2.1 MB each), about 6.3 us at 3.35 TB/s, and the causal half of the
// products is 4.3 GFLOP, about 4.3 us on the bf16 tensor cores (8.6 GFLOP
// with the three-term P V, 8.7 us): it is bound by bytes. What bounds the
// bf16 kernel now is latency and issue in its 12 warps per SM: mma.sync
// reaches well under the tensor cores' peak (only wgmma does), the
// softmax's exponentials, shuffles and the split of P run between the
// products in the same warps, and every warp re-reads K and V from shared
// memory. wgmma with TMA loads is the next step. The fp32 kernel is bound
// by the FMA and shared-memory issue rate (4.3 GFLOP at 67 TFLOP/s is at
// least 64 us).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // key rows per tile
constexpr int kThreads = 256;   // fp32 kernel: a 16 x 16 grid
constexpr int kTcThreads = 128; // bf16 kernel: 4 warps of 16 query rows
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

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

// ---- bf16 kernel on the tensor cores ----

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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p of two neighbouring columns as three bf16 terms, p = t[0] + t[1] +
// t[2]: each difference is exact in fp32, so the terms carry p's 24 bits
__device__ __forceinline__ void split3(float p0, float p1,
                                       uint32_t (&t)[3][4], int i) {
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
    t[n][i] = as_u32(h);
    p0 -= __low2float(h);
    p1 -= __high2float(h);
  }
}

// Element offset of 16-byte chunk `chunk` of row `row` in a [rows][D] bf16
// tile: the chunk's place in its 128-byte line is XORed with the row (with
// the row pair at D = 32, where a line holds two rows), so that the 8 rows
// an ldmatrix reads at one chunk fall on 8 distinct places of a line.
// D = 160 has 20 chunks a row: two whole groups of 8, swizzled as at D 64,
// and a tail of 4 (chunks 16-19), swizzled within itself by the row pair
// as at D 32, so that no chunk leaves its row. A 320-byte row starts half
// a line (4 places) on from the row before, so the place of chunk c of row
// r is (c ^ f(r)) ^ 4 (r & 1) with f(r) = r & 7 in a whole group and
// (r >> 1) & 3 in the tail: 8 distinct places for rows 0-7 either way.
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  if constexpr (D % 64 == 0) {
    return row * D + ((chunk ^ (row & 7)) << 3);
  } else if constexpr (D == 32) {
    return row * D + ((chunk ^ ((row >> 1) & 3)) << 3);
  } else {
    static_assert(D == 160, "swz: D must be 32, a multiple of 64 or 160");
    const int c = chunk < 16 ? chunk ^ (row & 7)
                             : 16 + ((chunk - 16) ^ ((row >> 1) & 3));
    return row * D + (c << 3);
  }
}

// 64 rows x D of a [., S, H, D] tensor from row0 on (row step `step`
// elements) into a swizzled shared tile; rows at or past s are zeros.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src, int row0,
                                          int s, size_t step, int tid) {
  constexpr int kChunks = D / 8;                 // 16-byte chunks per row
  static_assert(kBK * kChunks % kTcThreads == 0, "load_tile: ragged pass");
  // chunk i of the tile is row i / kChunks, chunk i % kChunks (at D 160 a
  // pass of 128 threads covers 6.4 rows, so threads walk chunks, not rows)
#pragma unroll
  for (int i = tid; i < kBK * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = row0 + r;
    const bool in = row < s;
    cp_async16(tile + 2 * swz<D>(r, c),
               src + static_cast<size_t>(in ? row : 0) * step + c * 8, in);
  }
}

template <int D>
constexpr size_t tc_smem_bytes() {   // Q tile, two K and two V stages
  return sizeof(__nv_bfloat16) * static_cast<size_t>(kBQ + 4 * kBK) * D;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
fa_bf16_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int s, int hq, int hkv,
               int causal, int window, float scale) {
  constexpr int KD = D / 16;        // k steps of Q K^T
  constexpr int ND = D / 8;         // n blocks of the output
  constexpr int kChunks = D / 8;
  constexpr uint32_t kTileBytes = 2u * kBK * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const uint32_t sq_a = smem_addr(sq);
  const uint32_t sk_a = sq_a + 2u * kBQ * D;     // [2][kBK][D]
  const uint32_t sv_a = sk_a + 2u * kTileBytes;  // [2][kBK][D]

  const int b = blockIdx.x / hq;
  const int h = blockIdx.x % hq;
  const int hk = h / (hq / hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // last tiles first
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;           // row within an 8-row half of the warp
  const int t = lane % 4;           // column pair within an 8-column block
  const size_t q_step = static_cast<size_t>(hq) * D;    // between positions
  const size_t kv_step = static_cast<size_t>(hkv) * D;
  const __nv_bfloat16* qb = q + static_cast<size_t>(b) * s * q_step + h * D;
  const __nv_bfloat16* kb =
      k + static_cast<size_t>(b) * s * kv_step + hk * D;
  const __nv_bfloat16* vb =
      v + static_cast<size_t>(b) * s * kv_step + hk * D;
  __nv_bfloat16* ob = o + static_cast<size_t>(b) * s * q_step + h * D;

  const int kv_end = causal ? min(s, q0 + kBQ) : s;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) / kBK * kBK : 0;
  const int n_tiles = (kv_end - kv_begin + kBK - 1) / kBK;
  const int qp[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  load_tile<D>(sq_a, qb, q0, s, q_step, tid);
  load_tile<D>(sk_a, kb, kv_begin, s, kv_step, tid);
  load_tile<D>(sv_a, vb, kv_begin, s, kv_step, tid);
  cp_async_commit();

  uint32_t qf[KD][4];
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of rows g and g + 8
  float l[2] = {0.f, 0.f};          // this lane's part of the running sum

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = kv_begin + jt * kBK;
    if (jt + 1 < n_tiles) {     // the next tile loads while this one runs
      const uint32_t next = ((jt + 1) & 1) * kTileBytes;
      load_tile<D>(sk_a + next, kb, k0 + kBK, s, kv_step, tid);
      load_tile<D>(sv_a + next, vb, k0 + kBK, s, kv_step, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();         // this tile (and Q) have landed
    __syncthreads();
    if (jt == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(sq_a + 2 * swz<D>(warp * 16 + (lane & 15),
                                  2 * kk + (lane >> 4)),
                qf[kk]);
    }
    const uint32_t kt = sk_a + (jt & 1) * kTileBytes;
    const uint32_t vt = sv_a + (jt & 1) * kTileBytes;

    // scores: 16 query rows x 64 keys, 8 blocks of 8 keys
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t kf[4];
        ldsm_x4(kt + 2 * swz<D>(np * 16 + (lane & 7) + ((lane >> 4) << 3),
                                2 * kk + ((lane >> 3) & 1)),
                kf);
        mma_bf16(sc[2 * np], qf[kk], kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // online softmax; masked scores -> -inf -> p = 0. exp(x - m) is
    // exp2((x - m) log2 e): x - m is exact near the max, where it counts
    const bool masked = k0 + kBK > s || (causal && k0 + kBK - 1 > q0) ||
                        (window > 0 && q0 + kBQ - 1 - k0 >= window);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * scale;
        if (masked && !visible(qp[e >> 1], k0 + n * 8 + 2 * t + (e & 1), s,
                               causal, window))
          x = -INFINITY;
        sc[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = fast_exp2((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2((sc[n][e] - m[e >> 1]) * kLog2e);
        sc[n][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // O += P V, P from registers as three bf16 terms (smallest first)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {     // 16 keys: score blocks 2kk, 2kk+1
      uint32_t pt[3][4];
      split3(sc[2 * kk][0], sc[2 * kk][1], pt, 0);
      split3(sc[2 * kk][2], sc[2 * kk][3], pt, 1);
      split3(sc[2 * kk + 1][0], sc[2 * kk + 1][1], pt, 2);
      split3(sc[2 * kk + 1][2], sc[2 * kk + 1][3], pt, 3);
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vt + 2 * swz<D>(kk * 16 + (lane & 7) +
                                          (((lane >> 3) & 1) << 3),
                                      2 * dp + (lane >> 4)),
                      vf);
#pragma unroll
        for (int n = 2; n >= 0; --n) {
          mma_bf16(acc[2 * dp], pt[n], vf[0], vf[1]);
          mma_bf16(acc[2 * dp + 1], pt[n], vf[2], vf[3]);
        }
      }
    }
    __syncthreads();    // every warp is done with this stage
  }

  // o = acc / l, rounded once, staged in this warp's rows of the Q tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      *reinterpret_cast<__nv_bfloat162*>(sq + swz<D>(row, n) + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] / l[r],
                                acc[n][2 * r + 1] / l[r]);
    }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int row = warp * 16 + i / kChunks;
    const int c = i % kChunks;
    if (q0 + row < s)
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(q0 + row) * q_step +
                                c * 8) =
          *reinterpret_cast<const uint4*>(sq + swz<D>(row, c));
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int b, int s, int hq, int hkv, int causal, int window,
                        float scale, cudaStream_t stream) {
  constexpr size_t bytes = tc_smem_bytes<D>();
  static bool ready = false;   // the attribute is set once per instance
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid(static_cast<unsigned>(b * hq), (s + kBQ - 1) / kBQ);
  fa_bf16_kernel<D><<<grid, kTcThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      s, hq, hkv, causal, window, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int s, int hq, int hkv, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  static bool ready = false;   // the attribute is set once per instance
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        fa_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    ready = true;
  }
  const dim3 grid((s + kBQ - 1) / kBQ, static_cast<unsigned>(b * hq));
  fa_kernel<float, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), s, hq, hkv,
      causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32 (fa_kernel), 1 = bf16 (fa_bf16_kernel). Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() (0 when
// the launch was accepted).
extern "C" int fa_forward(const void* q, const void* k, const void* v,
                          void* o, int b, int s, int hq, int hkv, int d,
                          int causal, int window, int dtype, float scale,
                          void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || b * hq > 65535 || (dtype != 0 &&
                                                       dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == 1;
  switch (d) {
    case 32:
      return static_cast<int>(
          bf16 ? launch_bf16<32>(q, k, v, o, b, s, hq, hkv, causal, window,
                                 scale, st)
               : launch<32>(q, k, v, o, b, s, hq, hkv, causal, window,
                            scale, st));
    case 64:
      return static_cast<int>(
          bf16 ? launch_bf16<64>(q, k, v, o, b, s, hq, hkv, causal, window,
                                 scale, st)
               : launch<64>(q, k, v, o, b, s, hq, hkv, causal, window,
                            scale, st));
    case 128:
      return static_cast<int>(
          bf16 ? launch_bf16<128>(q, k, v, o, b, s, hq, hkv, causal, window,
                                  scale, st)
               : launch<128>(q, k, v, o, b, s, hq, hkv, causal, window,
                             scale, st));
    case 160:
      return static_cast<int>(
          bf16 ? launch_bf16<160>(q, k, v, o, b, s, hq, hkv, causal, window,
                                  scale, st)
               : launch<160>(q, k, v, o, b, s, hq, hkv, causal, window,
                             scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
