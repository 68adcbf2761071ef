// Best IoU of every predicted box against a list of ground-truth boxes, for
// Hopper (sm_90a): out[b, n] = max_m IoU(pred[b, n], gt[b, m]), for one or
// more segments of predicted boxes (the YOLO scales) against one GT list,
// all in one launch.
//
// Replaces the Pallas TPU kernel deepvision_tpu/ops/pallas_kernels.py:33
// (`_best_iou_kernel`, launched by `best_iou` at :84), which the YOLO loss
// runs once per scale for its ignore mask (deepvision_tpu/ops/yolo.py:213).
// It computes what that kernel computes, not its block layout: corner boxes
// (x1, y1, x2, y2) in f32; the overlap width and height clipped to [0, 1];
// IoU = inter / (area_p + area_g - inter + 1e-7), summed in that order; a
// max from -inf, as jnp.max; all-zero GT rows (padding) give IoU 0. The
// (B, N, M) IoU tensor never exists. The TPU kernel's transpose of the GT
// to (B, 4, M), its 128-lane padding of M and its block padding of N are
// TPU layout, not math, and are not carried over: any N >= 1 and M >= 1.
//
// What bounds it on this card. At the three YOLOv3 scales at 416 px,
// B = 16, N = 3 * (52^2 + 26^2 + 13^2) = 10647, M = 100 (MAX_BOXES): the
// call must read B*N*16 + B*M*16 bytes and write B*N*4, 3.4 MB, 1.0 us at
// 3.35 TB/s (H100 SXM data sheet). It does 16 f32 operations per (n, m)
// pair (4 max/min for the overlap corners, 2 subtractions, 4 max/min for
// the clip, 1 product, 2 additions and 1 subtraction for the union, 1
// division, 1 running max; the pred area is per box and the GT area per
// block), 0.27 GFLOP, 4.1 us at 67 TFLOP/s f32 without tensor cores. That
// rate counts an FMA as two operations and none of these is an FMA: at
// one operation per lane per clock (132 SMs x 128 lanes x 1.98 GHz, 33.5
// T/s) the same work takes 8.1 us. Either way it is bound by operations:
// no matrix product, no tensor-core form. On the
// CUDA cores it is issue- and latency-bound, and the design is about that:
//
// - One launch for all segments. The segment table (each segment's pred
//   and out pointers, its N and the first block of its tiles) travels by
//   value in the kernel's parameters, built by the launcher from host
//   arrays, so there is no device copy of the table and no concatenation
//   of the segments; the launch is capturable in a CUDA graph. The grid is
//   (sum over segments of ceil(N_s / kBoxes), B) and each block finds its
//   segment by comparing its block index with the table's prefixes.
// - M split over the lanes: each group of kGroup lanes of one warp takes
//   kPreds predicted boxes, lane l takes GT boxes l, l + kGroup, ..., and
//   the group ends with a NaN-propagating max over __shfl_xor_sync. That
//   cuts each thread's serial chain by kGroup and puts kGroup times the
//   threads on the card; kPreds boxes share each GT load. Max is
//   order-free for non-NaN values and a NaN anywhere still gives NaN, so
//   the split changes no result beyond the sign of a zero IoU (+0 and -0
//   compare equal).
// - Few instructions per pair: one-instruction NaN-propagating
//   min.NaN / max.NaN (PTX, sm_80 and up) where an isnan + compare + select
//   would take three; the GT staged in shared memory as one float4 per box
//   plus its area (a 16-byte and a 4-byte shared load per pair); the inner
//   loop unrolled by kUnroll with a masked remainder, so independent pairs
//   interleave and hide the division's latency.
// - Bit for bit the plain PyTorch version (ops/best_iou.py): products with
//   __fmul_rn and the quotient with __fdiv_rn (IEEE, not contracted into
//   FMAs), sums in the plain version's order; no fast-math.
//
// The block sizes (kThreads, kGroup, kPreds, kUnroll) were chosen by timing
// copies of this file with other values on the card, each held bit for
// bit against the plain version first (PERF.md says what won and why).
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() so a refused launch is reported to the caller. The
// kernel launches on the caller's stream and allocates nothing.

#include <climits>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // threads per block
constexpr int kGroup = 4;      // lanes that share predicted boxes
constexpr int kPreds = 2;      // predicted boxes a group takes
constexpr int kUnroll = 8;     // GT boxes a lane takes per unrolled step
constexpr int kChunk = 256;    // GT boxes staged in shared memory at a time
constexpr int kMaxSegments = 8;
constexpr int kGroups = kThreads / kGroup;  // groups per block
constexpr int kBoxes = kGroups * kPreds;    // predicted boxes per block
static_assert(32 % kGroup == 0, "a group lies within one warp");

struct Segments {
  const float* pred[kMaxSegments];  // (B, n[s], 4)
  float* out[kMaxSegments];         // (B, n[s])
  int n[kMaxSegments];
  int first_block[kMaxSegments];    // prefix sum of ceil(n / kBoxes)
  int count;
};

// max / min that return NaN when either operand is NaN (torch.maximum,
// jnp.maximum), one instruction each; fmaxf / fminf would drop the NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// IoU of the predicted box (p, area_p) with the GT box (g, area_g), in the
// plain version's operations and order
__device__ __forceinline__ float pair_iou(float4 p, float area_p, float4 g,
                                          float area_g) {
  const float left = max_nan(p.x, g.x);
  const float top = max_nan(p.y, g.y);
  const float right = min_nan(p.z, g.z);
  const float bot = min_nan(p.w, g.w);
  const float iw = min_nan(max_nan(right - left, 0.f), 1.f);
  const float ih = min_nan(max_nan(bot - top, 0.f), 1.f);
  const float inter = __fmul_rn(iw, ih);
  const float uni = ((area_p + area_g) - inter) + 1e-7f;
  // __fdiv_rn leaves its fast path (FCHK) for a zero numerator, and most
  // pairs do not overlap. 0 / uni is +-0, or NaN where uni is 0 or NaN:
  // so a zero overlap divides 2^-24 instead and scales the quotient by 0.
  // 2^-24 / uni is finite for every finite nonzero uni (down to 2^-149),
  // +-0 for +-inf, +-inf for +-0 and NaN for NaN, so 0 * it is +-0
  // exactly where 0 / uni is +-0 and NaN where it is NaN.
  const bool none = inter == 0.f;
  const float q = __fdiv_rn(none ? 0x1p-24f : inter, uni);
  return none ? __fmul_rn(0.f, q) : q;
}

__global__ void __launch_bounds__(kThreads)
best_iou_kernel(const Segments segs, const float* __restrict__ gt,
                int n_gt) {
  __shared__ float4 gbox[kChunk];
  __shared__ float garea[kChunk];

  // this block's segment: the last whose first block is at or before it
  // (static indices, so the table is read from the parameter bank)
  const float* pred = segs.pred[0];
  float* out = segs.out[0];
  int n_pred = segs.n[0];
  int first = 0;
  const int block = blockIdx.x;
#pragma unroll
  for (int s = 1; s < kMaxSegments; ++s) {
    if (s < segs.count && block >= segs.first_block[s]) {
      pred = segs.pred[s];
      out = segs.out[s];
      n_pred = segs.n[s];
      first = segs.first_block[s];
    }
  }
  const int b = blockIdx.y;
  const int lane = threadIdx.x % kGroup;
  // the group's boxes n0, n0 + kGroups, ...: neighbouring groups take
  // neighbouring boxes
  const int n0 = (block - first) * kBoxes + threadIdx.x / kGroup;
  const bool valid = n0 < n_pred;  // the group's first box
  const float* g = gt + static_cast<long long>(b) * n_gt * 4;

  float4 p[kPreds];
  float area_p[kPreds], best[kPreds];
#pragma unroll
  for (int i = 0; i < kPreds; ++i) {
    const int n = n0 + i * kGroups;
    p[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n < n_pred) {
      const float* r = pred + (static_cast<long long>(b) * n_pred + n) * 4;
      p[i] = make_float4(r[0], r[1], r[2], r[3]);
    }
    area_p[i] = __fmul_rn(p[i].z - p[i].x, p[i].w - p[i].y);
    best[i] = -INFINITY;
  }

  for (int m0 = 0; m0 < n_gt; m0 += kChunk) {
    const int count = min(kChunk, n_gt - m0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const float* r = g + static_cast<long long>(m0 + j) * 4;
      const float4 box = make_float4(r[0], r[1], r[2], r[3]);
      gbox[j] = box;
      garea[j] = __fmul_rn(box.z - box.x, box.w - box.y);
    }
    __syncthreads();
    if (valid) {
      int j = lane;
      for (; j + (kUnroll - 1) * kGroup < count; j += kUnroll * kGroup) {
        float iou[kPreds][kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const float4 gb = gbox[j + u * kGroup];
          const float ga = garea[j + u * kGroup];
#pragma unroll
          for (int i = 0; i < kPreds; ++i) {
            iou[i][u] = pair_iou(p[i], area_p[i], gb, ga);
          }
        }
        // a tree, so the running max waits on one result, not kUnroll
#pragma unroll
        for (int i = 0; i < kPreds; ++i) {
#pragma unroll
          for (int w = 1; w < kUnroll; w *= 2) {
#pragma unroll
            for (int u = 0; u + w < kUnroll; u += 2 * w) {
              iou[i][u] = max_nan(iou[i][u], iou[i][u + w]);
            }
          }
          best[i] = max_nan(best[i], iou[i][0]);
        }
      }
      for (; j < count; j += kGroup) {
        const float4 gb = gbox[j];
        const float ga = garea[j];
#pragma unroll
        for (int i = 0; i < kPreds; ++i) {
          best[i] = max_nan(best[i], pair_iou(p[i], area_p[i], gb, ga));
        }
      }
    }
  }
  // each box's max over its group; every lane of the warp takes part,
  // valid or not (a group lies in one warp and its lanes share its boxes)
#pragma unroll
  for (int i = 0; i < kPreds; ++i) {
#pragma unroll
    for (int off = kGroup / 2; off > 0; off /= 2) {
      best[i] = max_nan(best[i], __shfl_xor_sync(0xffffffffu, best[i], off));
    }
    const int n = n0 + i * kGroups;
    if (n < n_pred && lane == 0) {
      out[static_cast<long long>(b) * n_pred + n] = best[i];
    }
  }
}

}  // namespace

// Segment s: preds[s] (B, ns[s], 4) and outs[s] (B, ns[s]) contiguous f32;
// gt (B, M, 4) contiguous f32; 1 <= n_segments <= kMaxSegments. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int dv_best_iou(const void* const* preds, void* const* outs,
                           const int* ns, int n_segments, const void* gt,
                           int batch, int n_gt, void* stream) {
  if (n_segments < 1 || n_segments > kMaxSegments || batch < 1 ||
      batch > 65535 || n_gt < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Segments segs = {};
  long long blocks = 0;
  for (int s = 0; s < n_segments; ++s) {
    if (ns[s] < 1) return static_cast<int>(cudaErrorInvalidValue);
    segs.pred[s] = static_cast<const float*>(preds[s]);
    segs.out[s] = static_cast<float*>(outs[s]);
    segs.n[s] = ns[s];
    segs.first_block[s] = static_cast<int>(blocks);
    blocks += (static_cast<long long>(ns[s]) + kBoxes - 1) / kBoxes;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  segs.count = n_segments;
  const dim3 grid(static_cast<unsigned>(blocks), batch);
  best_iou_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      segs, static_cast<const float*>(gt), n_gt);
  return static_cast<int>(cudaGetLastError());
}
