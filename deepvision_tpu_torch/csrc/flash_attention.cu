// Flash-attention forward for Hopper (sm_90a): softmax(Q K^T * scale) V.
//
// Replaces the Pallas TPU kernel deepvision_tpu/ops/attention.py:73
// (`_flash_kernel`, launched by `_fused_forward` at :128). It computes what
// that kernel computes, not its block layout: one block per (query tile,
// head, batch); K/V tiles staged through shared memory; an online softmax
// with a running max m, a running sum l and an accumulator rescaled by
// exp(m_old - m_new), all in f32; keys >= N masked to -inf before the max;
// the output cast to the input dtype once at the end. The (N, N) score
// matrix never leaves registers. The TPU rules for padding D to 128 lanes
// and N to a 128 tile are not carried over: ragged N and D <= 128 are
// handled by masking and zero-filling inside the block.
//
// What bounds it on this card. At the vit_small bucket of 32,
// (32, 6, 197, 64) bf16, the call must move Q, K, V and O once: 4 x
// 4.84 MB = 19.4 MB, 5.8 us at 3.35 TB/s (H100 SXM data sheet), for
// 2 x 2 x 32*6*197*197*64 = 1.9 GFLOP, 1.9 us at 989 TFLOP/s in bf16. So
// the function's bound is set by bytes, and the kernel keeps its bytes at
// that floor: each Q row is read once, O is written once, and the query
// tiles of one (batch, head) are neighbours in launch order (blockIdx.x is
// fastest), so their shared K/V panel (197 x 64 bf16 x 2 = 50 KB) comes
// from HBM about once and from L2 after that.
//
// Two paths, chosen by dtype:
//
// bf16 (`flash_attention_fwd_tc`, what vit_small serves). Both products run
// on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate); at
// these shapes that is far above the rate the work needs. What bounds it on
// the card is the issue of each warp's per-tile chain (ldmatrix, mma,
// shuffles, ex2, rescale), not bytes: at the bucket-32 shape a build with
// the products and softmax alone took most of the kernel's time and a
// build with the loads alone under half (PERF.md). So the design keeps that chain short and in one basic block. A block is
// 4 warps over a 64-row query tile, 16 rows a warp; the grid is ceil(N/64)
// x H x B.
// - Loads: Q, K and V tiles of 64 rows x DMAX go to shared memory with
//   16-byte cp.async.cg, zero-filling rows >= N and columns >= D through
//   the src-size operand, in kStages stages so the next K/V tile is in
//   flight while the current one computes (one __syncthreads per tile).
//   Rows are XOR-swizzled in 16-byte chunks (chunk ^ row % 8), so the 8
//   rows one ldmatrix phase reads sit in 8 different bank groups. An input
//   whose rows do not start on 16 bytes (the wrapper checks data_ptr, the
//   b/h/n strides and D) takes the same kernel with scalar 2-byte copies
//   (kVec = false). TMA is not used: its tensor map would have to be
//   encoded on the host for every call (the pointers change), a host cost
//   the latency-bound buckets 1 and 8 would pay in full.
// - S = Q K^T: the warp's Q fragments are read once with ldmatrix.x4 and
//   kept in registers for the whole key loop; K fragments come with
//   ldmatrix.x4. D is zero-padded to DMAX (64 or 128) in shared memory.
// - Only the last K/V tile can reach past N: it alone masks keys >= N to
//   -inf and skips key pairs wholly past N. Every other tile runs
//   straight-line code with no branch, which ptxas schedules as one block
//   (with the skips on every tile the kernel took 1.5x as long).
// - Online softmax on the f32 accumulator fragments: S is scaled by
//   scale * log2(e) in one multiply, each row's max and sum are taken with
//   two xor shuffles inside the quad that owns it, 2^x is the SFU's
//   ex2.approx, and m, l and the rescale 2^(m_old - m_new) stay in f32.
// - O += P V: the f32 P fragments, rounded to bf16 pairs, are exactly the A
//   fragments of the next m16n8k16, so P never touches shared memory; V
//   fragments come with ldmatrix.x4.trans. Rounding P to bf16 is what the
//   reference does (deepvision_tpu/ops/attention.py:70, p.astype(v.dtype)).
// - Epilogue: O / l in f32, one cast to bf16, staged through the warp's
//   own rows of the Q tile and written row by row with 16-byte stores.
// - Why not wgmma: at these shapes mma.sync is not what limits the kernel
//   (above); wgmma with TMA and a producer warp is for a later version.

// f32 (`flash_attention_fwd`, the first version of this kernel, kept as
// it was). Both products run as f32 FMAs on the CUDA cores: the f32 bound
// against the JAX package is 2e-5, and TF32's 10-bit mantissa cannot meet
// it. At 67 TFLOP/s that sets a floor near 28 us at the bucket-32 shape;
// no full-width served path takes it (vit_small computes in bf16).
//
// Layout: Q, K, V and O are (B, H, N, D) tensors addressed through element
// strides for b, h and n; the d stride must be 1. So the model's head split
// (a (B, N, H, D) view permuted to (B, H, N, D)) needs no copy.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() so a refused launch is reported to the caller. The
// kernel launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

struct Strides {
  long long b, h, n;  // element strides; the d stride is 1
};

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs, 4 threads per query row.
//
// 4 threads share one query row, each owning D/4 of its dims in interleaved
// float4 chunks (chunk part + 4 j), so the 4 lanes of a row read 64
// contiguous bytes of a shared-memory K/V row in one conflict-free LDS.128
// and the 8 rows of a warp read the same address (broadcast). A row's
// partial dot products are summed with two xor shuffles.

constexpr int kThreadsPerRow = 4;
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kThreadsPerRow * kRowsPerBlock;  // 128
constexpr int kChunk = 8;  // keys per online-softmax update

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int n_keys,
                    int d_head, Strides sq, Strides sk, Strides sv,
                    Strides so, float scale) {
  constexpr int kDimsPerThread = DMAX / kThreadsPerRow;
  constexpr int kVec = kDimsPerThread / 4;  // float4 chunks per thread
  constexpr int kTileKeys = 4096 / DMAX;    // K + V tile = 32 KB of f32
  static_assert(kTileKeys % kChunk == 0, "tile must hold whole chunks");
  __shared__ __align__(16) float ks[kTileKeys][DMAX];
  __shared__ __align__(16) float vs[kTileKeys][DMAX];

  const int tid = threadIdx.x;
  const int row = tid / kThreadsPerRow;
  const int part = tid % kThreadsPerRow;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int qi = blockIdx.x * kRowsPerBlock + row;
  const bool row_valid = qi < n_keys;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;

  // this thread's slice of its query row, pre-scaled as the TPU kernel does
  float qr[kDimsPerThread];
  float acc[kDimsPerThread];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + kThreadsPerRow * j) + e;
      qr[4 * j + e] = (row_valid && d < d_head)
                          ? to_f32(qb[qi * sq.n + d]) * scale
                          : 0.f;
      acc[4 * j + e] = 0.f;
    }
  }
  float m = -INFINITY;
  float l = 0.f;

  for (int k0 = 0; k0 < n_keys; k0 += kTileKeys) {
    __syncthreads();  // every thread is done with the previous tile
    for (int i = tid; i < kTileKeys * DMAX; i += kThreads) {
      const int r = i / DMAX;
      const int d = i % DMAX;
      const int key = k0 + r;
      const bool ok = key < n_keys && d < d_head;
      ks[r][d] = ok ? to_f32(kb[key * sk.n + d]) : 0.f;
      vs[r][d] = ok ? to_f32(vb[key * sv.n + d]) : 0.f;
    }
    __syncthreads();
    const int tile_keys = min(kTileKeys, n_keys - k0);
    // the loop bounds are uniform over the block, so every lane reaches
    // every shuffle
    for (int c0 = 0; c0 < tile_keys; c0 += kChunk) {
      float s[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float4* kr = reinterpret_cast<const float4*>(ks[c0 + c]);
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float4 kv = kr[part + kThreadsPerRow * j];
          dot = fmaf(qr[4 * j + 0], kv.x, dot);
          dot = fmaf(qr[4 * j + 1], kv.y, dot);
          dot = fmaf(qr[4 * j + 2], kv.z, dot);
          dot = fmaf(qr[4 * j + 3], kv.w, dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        s[c] = (c0 + c < tile_keys) ? dot : -INFINITY;  // mask keys >= N
      }
      float chunk_max = s[0];  // key c0 is valid, so this is finite
#pragma unroll
      for (int c = 1; c < kChunk; ++c) chunk_max = fmaxf(chunk_max, s[c]);
      const float m_new = fmaxf(m, chunk_max);
      const float alpha = expf(m - m_new);  // 0 on the first chunk
      float p_sum = 0.f;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        s[c] = expf(s[c] - m_new);
        p_sum += s[c];
      }
      l = l * alpha + p_sum;
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) acc[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const float4* vr = reinterpret_cast<const float4*>(vs[c0 + c]);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float4 vv = vr[part + kThreadsPerRow * j];
          acc[4 * j + 0] = fmaf(s[c], vv.x, acc[4 * j + 0]);
          acc[4 * j + 1] = fmaf(s[c], vv.y, acc[4 * j + 1]);
          acc[4 * j + 2] = fmaf(s[c], vv.z, acc[4 * j + 2]);
          acc[4 * j + 3] = fmaf(s[c], vv.w, acc[4 * j + 3]);
        }
      }
      m = m_new;
    }
  }

  if (!row_valid) return;
  T* ob = o + b * so.b + h * so.h + qi * so.n;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 4 * (part + kThreadsPerRow * j) + e;
      if (d < d_head) ob[d] = from_f32<T>(acc[4 * j + e] / l);
    }
  }
}

template <int DMAX>
void launch_f32(const void* q, const void* k, const void* v, void* o,
                int batch, int heads, int n, int d, Strides sq, Strides sk,
                Strides sv, Strides so, float scale, cudaStream_t stream) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, batch);
  flash_attention_fwd<float, DMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), n, d, sq, sk, sv,
      so, scale);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16), cp.async tiles, ldmatrix.

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;  // 128
constexpr int kBlockQ = 16 * kTcWarps;     // 64 query rows, 16 per warp
constexpr int kBlockK = 64;                // keys per K/V tile
constexpr int kStages = 2;                 // K/V tiles in flight
constexpr int kMaxDevices = 64;            // device ordinals with an opt-in flag
constexpr float kLog2e = 1.4426950408889634f;

template <int DMAX>
struct TcShape {
  static_assert(DMAX == 64 || DMAX == 128, "the swizzle needs >= 8 chunks");
  static constexpr int kChunks = DMAX / 8;  // 16-byte chunks per tile row
  static constexpr int kQBytes = kBlockQ * DMAX * 2;
  static constexpr int kKVBytes = kBlockK * DMAX * 2;
  static constexpr int kSmemBytes = kQBytes + 2 * kStages * kKVBytes;
};

// Byte offset of 16-byte chunk `chunk` of row `row` in a tile: the chunk
// index is XORed with row % 8, so the 8 rows an ldmatrix phase reads at one
// logical chunk land in 8 different bank groups.
template <int DMAX>
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return static_cast<uint32_t>(
      (row * TcShape<DMAX>::kChunks + (chunk ^ (row & 7))) * 16);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of two bf16, `lo` in the low half (the lower
// column, as mma fragments hold them)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x with the SFU's approximation (relative error about 2^-22, far below
// the bf16 rounding P takes next); 2^-inf = 0
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copy rows [row0, row0 + kRows) x [0, DMAX) of a (rows, D) bf16 matrix
// with row stride `ld` into a swizzled tile, zero-filling rows >= n_rows and
// columns >= d_head. kVec: 16-byte cp.async (rows start on 16 bytes and D %
// 8 == 0, so a chunk is wholly in or out); else scalar 2-byte loads, one
// chunk at a time (unrolled, they would hold a tile's worth of registers).
template <int DMAX, bool kVec, int kRows>
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const __nv_bfloat16* base,
                                          long long ld, int row0, int n_rows,
                                          int d_head, int tid) {
  constexpr int kChunks = TcShape<DMAX>::kChunks;
  constexpr int kIters = kRows * kChunks / kTcThreads;
  static_assert(kRows * kChunks % kTcThreads == 0, "whole iterations");
  if constexpr (kVec) {
#pragma unroll
    for (int i = 0; i < kIters; ++i) {
      const int idx = tid + i * kTcThreads;
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const int row = row0 + r;
      const bool ok = row < n_rows && c * 8 < d_head;
      // a zero-byte copy reads nothing; the base keeps the address valid
      cp_async_16(smem_addr(tile) + swz<DMAX>(r, c),
                  ok ? base + static_cast<long long>(row) * ld + c * 8 : base,
                  ok ? 16 : 0);
    }
  } else {
#pragma unroll 1
    for (int i = 0; i < kIters; ++i) {
      const int idx = tid + i * kTcThreads;
      const int r = idx / kChunks;
      const int c = idx % kChunks;
      const int row = row0 + r;
      const bool ok = row < n_rows && c * 8 < d_head;
      const unsigned short* s16 = reinterpret_cast<const unsigned short*>(
          base + static_cast<long long>(row) * ld + c * 8);
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = c * 8 + 2 * e;
        const uint32_t lo = (ok && d < d_head) ? s16[2 * e] : 0u;
        const uint32_t hi = (ok && d + 1 < d_head) ? s16[2 * e + 1] : 0u;
        w[e] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(tile + swz<DMAX>(r, c)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// K and V tile `t` of this (batch, head) into pipeline stage `st`
template <int DMAX, bool kVec>
__device__ __forceinline__ void load_kv(unsigned char* k_s,
                                        unsigned char* v_s, int st, int t,
                                        const __nv_bfloat16* kb, long long lk,
                                        const __nv_bfloat16* vb, long long lv,
                                        int n, int d_head, int tid) {
  constexpr int kBytes = TcShape<DMAX>::kKVBytes;
  load_tile<DMAX, kVec, kBlockK>(k_s + st * kBytes, kb, lk, t * kBlockK, n,
                                 d_head, tid);
  load_tile<DMAX, kVec, kBlockK>(v_s + st * kBytes, vb, lv, t * kBlockK, n,
                                 d_head, tid);
}

// One K/V tile of the online softmax for this warp's 16 query rows: S = Q
// K^T on the tensor cores, the rescale of the running max m (log2 units),
// sum l (this lane's share of rows g and g + 8) and accumulator, and O +=
// P V. kPartial: the tile reaches past N, so its keys >= N are masked to
// -inf and key pairs wholly past N are skipped (a uniform branch).
template <int DMAX, bool kPartial>
__device__ __forceinline__ void attend_tile(
    const uint32_t (&qf)[DMAX / 16][4], float (&acc)[DMAX / 8][4],
    float (&m)[2], float (&l)[2], uint32_t ks, uint32_t vs, int k0, int n,
    float scale_log2, int lane) {
  constexpr int kKSteps = DMAX / 16;      // k-steps of Q K^T over dims
  constexpr int kDTiles = DMAX / 8;       // 8-wide n-tiles of P V over dims
  constexpr int kKeyTiles = kBlockK / 8;  // 8-wide n-tiles of Q K^T
  const int tig = lane & 3;  // fragment column pair
  const int mi = lane >> 3;  // which 8x8 matrix this lane addresses
  const int mr = lane & 7;   // which row of it

  // S = Q K^T for 16 rows x 64 keys
  float s[kKeyTiles][4];
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
    for (int p = 0; p < kKeyTiles / 2; ++p) {
      if (kPartial && k0 + 16 * p >= n) break;
      uint32_t kf[4];  // b0, b1 of key tiles 2p and 2p + 1
      ldmatrix_x4(kf, ks + swz<DMAX>(16 * p + 8 * (mi >> 1) + mr,
                                     2 * kk + (mi & 1)));
      mma_bf16(s[2 * p], qf[kk], kf[0], kf[1]);
      mma_bf16(s[2 * p + 1], qf[kk], kf[2], kf[3]);
    }
  }

  // online softmax in log2 units
  float m_new[2] = {m[0], m[1]};
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[t][e] * scale_log2;
      if (kPartial && k0 + 8 * t + 2 * tig + (e & 1) >= n) x = -INFINITY;
      s[t][e] = x;
      m_new[e >> 1] = fmaxf(m_new[e >> 1], x);
    }
  }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 1));
    m_new[i] = fmaxf(m_new[i], __shfl_xor_sync(0xffffffffu, m_new[i], 2));
    alpha[i] = fast_exp2(m[i] - m_new[i]);  // 0 on the first tile
    m[i] = m_new[i];                        // finite: key k0 is valid
  }
  uint32_t pf[kBlockK / 16][4];  // P as the A fragments of P V
  float row_sum[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < kKeyTiles; ++t) {
    const float p0 = fast_exp2(s[t][0] - m[0]);
    const float p1 = fast_exp2(s[t][1] - m[0]);
    const float p2 = fast_exp2(s[t][2] - m[1]);
    const float p3 = fast_exp2(s[t][3] - m[1]);
    row_sum[0] += p0 + p1;
    row_sum[1] += p2 + p3;
    pf[t / 2][2 * (t & 1)] = pack_bf16(p0, p1);
    pf[t / 2][2 * (t & 1) + 1] = pack_bf16(p2, p3);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + row_sum[i];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t) {
    acc[t][0] *= alpha[0];
    acc[t][1] *= alpha[0];
    acc[t][2] *= alpha[1];
    acc[t][3] *= alpha[1];
  }

  // O += P V
#pragma unroll
  for (int kk = 0; kk < kBlockK / 16; ++kk) {
    if (kPartial && k0 + 16 * kk >= n) break;  // P is 0 there
#pragma unroll
    for (int p = 0; p < kDTiles / 2; ++p) {
      uint32_t vf[4];  // b0, b1 of dim tiles 2p and 2p + 1
      ldmatrix_x4_trans(vf, vs + swz<DMAX>(16 * kk + 8 * (mi & 1) + mr,
                                           2 * p + (mi >> 1)));
      mma_bf16(acc[2 * p], pf[kk], vf[0], vf[1]);
      mma_bf16(acc[2 * p + 1], pf[kk], vf[2], vf[3]);
    }
  }
}

// The minimum of 1 block per SM, though it is the default, changes what
// ptxas does: 163 registers instead of 139 for the 16-byte DMAX-64 kernel,
// and less device time at vit_small's shapes (PERF.md).
template <int DMAX, bool kVec>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_attention_fwd_tc(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int n, int d_head,
                       Strides sq, Strides sk, Strides sv, Strides so,
                       float scale_log2) {
  using Shape = TcShape<DMAX>;
  constexpr int kKV = Shape::kKVBytes;
  constexpr int kKSteps = DMAX / 16;  // k-steps of Q K^T over dims
  constexpr int kDTiles = DMAX / 8;   // 8-wide n-tiles of P V over dims
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* q_s = smem;
  unsigned char* k_s = smem + Shape::kQBytes;
  unsigned char* v_s = k_s + kStages * kKV;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;   // fragment row (and row + 8)
  const int tig = lane & 3;  // fragment column pair
  const int mi = lane >> 3;  // which 8x8 matrix this lane addresses
  const int mr = lane & 7;   // which row of it
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;

  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (n + kBlockK - 1) / kBlockK;

  // prologue: Q and the first kStages - 1 K/V tiles, one group per tile
  // (Q rides with tile 0); a group is committed even when empty, so the
  // count the wait below relies on never changes
  load_tile<DMAX, kVec, kBlockQ>(q_s, qb, sq.n, q0, n, d_head, tid);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles)
      load_kv<DMAX, kVec>(k_s, v_s, s, s, kb, sk.n, vb, sv.n, n, d_head, tid);
    cp_async_commit();
  }

  uint32_t qf[kKSteps][4];
  float acc[kDTiles][4];
#pragma unroll
  for (int t = 0; t < kDTiles; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  // running max (log2 units) and this lane's share of the running sum of
  // rows g and g + 8 of the warp's 16
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  // every branch below depends only on j, n and d_head: uniform over the
  // block, so every lane reaches every mma, shuffle and barrier
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<kStages - 2>();  // tile j (and Q) has landed
    __syncthreads();               // ... for every thread; tile j-1 is free
    const int jn = j + kStages - 1;
    if (jn < n_tiles)
      load_kv<DMAX, kVec>(k_s, v_s, jn % kStages, jn, kb, sk.n, vb, sv.n, n,
                          d_head, tid);
    cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
        ldmatrix_x4(qf[kk], smem_addr(q_s) +
                                swz<DMAX>(16 * warp + mr + 8 * (mi & 1),
                                          2 * kk + (mi >> 1)));
    }
    const int k0 = j * kBlockK;
    const uint32_t ks = smem_addr(k_s + (j % kStages) * kKV);
    const uint32_t vs = smem_addr(v_s + (j % kStages) * kKV);
    // only the last tile can hold keys >= N: the others take straight-line
    // code, which ptxas can schedule as one block
    if (k0 + kBlockK <= n) {
      attend_tile<DMAX, false>(qf, acc, m, l, ks, vs, k0, n, scale_log2, lane);
    } else {
      attend_tile<DMAX, true>(qf, acc, m, l, ks, vs, k0, n, scale_log2, lane);
    }
  }

  // epilogue: finish l over the quad, O / l in f32, one cast to bf16,
  // staged in this warp's own 16 rows of the Q tile (its Q fragments have
  // been in registers since tile 0, and no other warp touches those rows)
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / l[i];
  }
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int t = 0; t < kDTiles; ++t) {
    *reinterpret_cast<uint32_t*>(q_s + swz<DMAX>(r0, t) + 4 * tig) =
        pack_bf16(acc[t][0] * inv[0], acc[t][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(q_s + swz<DMAX>(r0 + 8, t) + 4 * tig) =
        pack_bf16(acc[t][2] * inv[1], acc[t][3] * inv[1]);
  }
  __syncwarp();
  constexpr int kChunks = Shape::kChunks;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
  static_assert(16 * kChunks % 32 == 0, "whole iterations");
#pragma unroll
  for (int it = 0; it < 16 * kChunks / 32; ++it) {
    const int i = lane + 32 * it;
    const int r = 16 * warp + i / kChunks;
    const int c = i % kChunks;
    const int qi = q0 + r;
    if (qi >= n || 8 * c >= d_head) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(q_s + swz<DMAX>(r, c));
    __nv_bfloat16* dst = ob + static_cast<long long>(qi) * so.n + 8 * c;
    if constexpr (kVec) {
      *reinterpret_cast<uint4*>(dst) = val;
    } else {
      const __nv_bfloat16* e8 = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (8 * c + e < d_head) dst[e] = e8[e];
    }
  }
}

template <int DMAX, bool kVec>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int batch, int heads, int n, int d, Strides sq,
                      Strides sk, Strides sv, Strides so, float scale,
                      cudaStream_t stream) {
  constexpr int kBytes = TcShape<DMAX>::kSmemBytes;
  auto kernel = flash_attention_fwd_tc<DMAX, kVec>;
  if (kBytes > 48 * 1024) {
    // above 48 KB only as opted-in dynamic shared memory, which is set per
    // device: remember it for each device ordinal. Setting it twice (two
    // threads on one device's first call) is harmless.
    static std::atomic<bool> opted_in[kMaxDevices];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
    if (!opted_in[dev].load(std::memory_order_acquire)) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
      if (err != cudaSuccess) return err;
      opted_in[dev].store(true, std::memory_order_release);
    }
  }
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kTcThreads, kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      n, d, sq, sk, sv, so, scale * kLog2e);
  return cudaSuccess;
}

template <bool kVec>
cudaError_t launch_tc_for_d(const void* q, const void* k, const void* v,
                            void* o, int batch, int heads, int n, int d,
                            Strides sq, Strides sk, Strides sv, Strides so,
                            float scale, cudaStream_t stream) {
  if (d <= 64) {
    return launch_tc<64, kVec>(q, k, v, o, batch, heads, n, d, sq, sk, sv,
                               so, scale, stream);
  }
  return launch_tc<128, kVec>(q, k, v, o, batch, heads, n, d, sq, sk, sv, so,
                              scale, stream);
}

bool rows_start_on_16_bytes(const void* p, const Strides& s) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 &&
         s.h % 8 == 0 && s.n % 8 == 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vec16 (bf16 only): 1 takes the 16-byte
// cp.async copies, which needs every tensor's pointer on 16 bytes, its b/h/n
// strides in multiples of 8 elements and d % 8 == 0 (checked here too);
// 0 takes scalar copies in the same kernel. Strides are in elements.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int dv_flash_attention_forward(
    int dtype, int vec16, const void* q, const void* k, const void* v,
    void* o, int batch, int heads, int n, int d, long long q_sb,
    long long q_sh, long long q_sn, long long k_sb, long long k_sh,
    long long k_sn, long long v_sb, long long v_sh, long long v_sn,
    long long o_sb, long long o_sh, long long o_sn, float scale,
    void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || n < 1 ||
      d < 1 || d > 128 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{q_sb, q_sh, q_sn};
  const Strides sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn};
  const Strides so{o_sb, o_sh, o_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (dtype == 0) {
    if (d <= 32) {
      launch_f32<32>(q, k, v, o, batch, heads, n, d, sq, sk, sv, so, scale, s);
    } else if (d <= 64) {
      launch_f32<64>(q, k, v, o, batch, heads, n, d, sq, sk, sv, so, scale, s);
    } else {
      launch_f32<128>(q, k, v, o, batch, heads, n, d, sq, sk, sv, so, scale,
                      s);
    }
  } else if (vec16) {
    if (d % 8 != 0 || !rows_start_on_16_bytes(q, sq) ||
        !rows_start_on_16_bytes(k, sk) || !rows_start_on_16_bytes(v, sv) ||
        !rows_start_on_16_bytes(o, so)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    err = launch_tc_for_d<true>(q, k, v, o, batch, heads, n, d, sq, sk, sv,
                                so, scale, s);
  } else {
    err = launch_tc_for_d<false>(q, k, v, o, batch, heads, n, d, sq, sk, sv,
                                 so, scale, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
