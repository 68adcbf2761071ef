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
// handled by masking inside the block.
//
// What bounds it on this card. At the vit_small bucket of 32,
// (32, 6, 197, 64) bf16, the call must move Q, K, V and O once: 4 x
// 4.84 MB = 19.4 MB, 5.8 us at 3.35 TB/s (H100 SXM data sheet), for
// 2 x 2 x 32*6*197*197*64 = 1.9 GFLOP, 1.9 us at 989 TFLOP/s in bf16. So
// the function is memory-bound. The design keeps the bytes at that floor:
// each Q row is read once, O is written once, and the query tiles of one
// (batch, head) are neighbours in launch order (blockIdx.x is fastest), so
// their shared K/V panel (197 x 64 bf16 x 2 = 50 KB) comes from HBM about
// once and from L2 after that. This first version does both products with
// f32 FMAs on the CUDA cores, one exact path for f32 and bf16 inputs; at
// 67 TFLOP/s that sets its own floor near 28 us at bucket 32, about five
// times the memory floor. Moving QK^T and PV onto the tensor cores
// (mma/wgmma on bf16 tiles) is the next step for speed.
//
// Layout: Q, K, V and O are (B, H, N, D) tensors addressed through element
// strides for b, h and n; the d stride must be 1. So the model's head split
// (a (B, N, H, D) view permuted to (B, H, N, D)) needs no copy.
//
// Threads: 4 threads share one query row, each owning D/4 of its dims in
// interleaved float4 chunks (chunk part + 4 j), so the 4 lanes of a row read
// 64 contiguous bytes of a shared-memory K/V row in one conflict-free
// LDS.128 and the 8 rows of a warp read the same address (broadcast). A
// row's partial dot products are summed with two xor shuffles.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() so a refused launch is reported to the caller. The
// kernel launches on the caller's stream and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreadsPerRow = 4;
constexpr int kRowsPerBlock = 32;
constexpr int kThreads = kThreadsPerRow * kRowsPerBlock;  // 128
constexpr int kChunk = 8;  // keys per online-softmax update

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's cast
}

struct Strides {
  long long b, h, n;  // element strides; the d stride is 1
};

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

template <typename T, int DMAX>
void launch(const void* q, const void* k, const void* v, void* o, int batch,
            int heads, int n, int d, Strides sq, Strides sk, Strides sv,
            Strides so, float scale, cudaStream_t stream) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, heads, batch);
  flash_attention_fwd<T, DMAX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), n, d, sq, sk, sv, so,
      scale);
}

template <typename T>
void launch_for_d(const void* q, const void* k, const void* v, void* o,
                  int batch, int heads, int n, int d, Strides sq, Strides sk,
                  Strides sv, Strides so, float scale, cudaStream_t stream) {
  if (d <= 32) {
    launch<T, 32>(q, k, v, o, batch, heads, n, d, sq, sk, sv, so, scale,
                  stream);
  } else if (d <= 64) {
    launch<T, 64>(q, k, v, o, batch, heads, n, d, sq, sk, sv, so, scale,
                  stream);
  } else {
    launch<T, 128>(q, k, v, o, batch, heads, n, d, sq, sk, sv, so, scale,
                   stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int dv_flash_attention_forward(
    int dtype, const void* q, const void* k, const void* v, void* o,
    int batch, int heads, int n, int d, long long q_sb, long long q_sh,
    long long q_sn, long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn, long long o_sb,
    long long o_sh, long long o_sn, float scale, void* stream) {
  if (batch < 1 || batch > 65535 || heads < 1 || heads > 65535 || n < 1 ||
      d < 1 || d > 128 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides sq{q_sb, q_sh, q_sn};
  const Strides sk{k_sb, k_sh, k_sn};
  const Strides sv{v_sb, v_sh, v_sn};
  const Strides so{o_sb, o_sh, o_sn};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch_for_d<float>(q, k, v, o, batch, heads, n, d, sq, sk, sv, so, scale,
                        s);
  } else {
    launch_for_d<__nv_bfloat16>(q, k, v, o, batch, heads, n, d, sq, sk, sv,
                                so, scale, s);
  }
  return static_cast<int>(cudaGetLastError());
}
