// Best IoU of every predicted box against a list of ground-truth boxes, for
// Hopper (sm_90a): out[b, n] = max_m IoU(pred[b, n], gt[b, m]).
//
// Replaces the Pallas TPU kernel deepvision_tpu/ops/pallas_kernels.py:33
// (`_best_iou_kernel`, launched by `best_iou` at :84), which the YOLO loss
// runs once per scale for its ignore mask (deepvision_tpu/ops/yolo.py:213).
// It computes what that kernel computes, not its block layout: corner boxes
// (x1, y1, x2, y2) in f32; the overlap width and height clipped to [0, 1];
// IoU = inter / (area_p + area_g - inter + 1e-7), summed in that order; a
// running max from -inf, as jnp.max; all-zero GT rows (padding) give IoU 0.
// The (B, N, M) IoU tensor never exists. The TPU kernel's transpose of the
// GT to (B, 4, M), its 128-lane padding of M and its block padding of N are
// TPU layout, not math, and are not carried over: any N >= 1 and M >= 1.
//
// Design: one thread per predicted box, 128 boxes of one image per block
// (grid = (ceil(N / 128), B)). The image's GT boxes are staged once per
// block in shared memory as four structure-of-arrays rows plus their areas
// (M = 100 is 2 KB), in chunks of kChunk boxes for larger M; every thread
// of the warp then reads the same GT address (a broadcast). One f32 store
// per box. Products use __fmul_rn and the quotient __fdiv_rn, so nvcc does
// not contract them into FMAs and the division is IEEE: the result is bit
// for bit that of the plain PyTorch version (ops/best_iou.py), which runs
// the same operations in the same order. Max and min propagate NaN, as
// torch.maximum and jnp.maximum do.
//
// What bounds it on this card. At the finest YOLOv3 scale at 416 px,
// B = 16, N = 3 * 52 * 52 = 8112, M = 100 (MAX_BOXES): the call must read
// B*N*16 + B*M*16 bytes and write B*N*4, 2.6 MB, 0.78 us at 3.35 TB/s
// (H100 SXM data sheet). It does 17 f32 operations per (n, m) pair
// (4 max/min for the overlap corners, 2 subtractions, 4 max/min for the
// clip, 1 product, 2 additions and 1 subtraction for the union, 1 division,
// 1 running max; the pred area is per box and the GT area per block), 0.22
// GFLOP, 3.3 us at 67 TFLOP/s f32 without tensor cores. So the function is
// bound by operations, and at these sizes the launch latency (a few us)
// dominates both floors. No tensor-core form exists for it; a faster
// version would fuse the three scales into one launch.
//
// Plain C interface, loaded with ctypes: the launcher returns
// cudaGetLastError() so a refused launch is reported to the caller. The
// kernel launches on the caller's stream and allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // predicted boxes per block
constexpr int kChunk = 256;    // GT boxes staged in shared memory at a time

// max / min that return NaN when either operand is NaN (torch.maximum,
// jnp.maximum); fmaxf / fminf would drop it
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
best_iou_kernel(const float* __restrict__ pred, const float* __restrict__ gt,
                float* __restrict__ out, int n_pred, int n_gt) {
  __shared__ float gx1[kChunk], gy1[kChunk], gx2[kChunk], gy2[kChunk];
  __shared__ float garea[kChunk];

  const int b = blockIdx.y;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = n < n_pred;
  const float* g = gt + static_cast<long long>(b) * n_gt * 4;

  float px1 = 0.f, py1 = 0.f, px2 = 0.f, py2 = 0.f;
  if (valid) {
    const float* p = pred + (static_cast<long long>(b) * n_pred + n) * 4;
    px1 = p[0];
    py1 = p[1];
    px2 = p[2];
    py2 = p[3];
  }
  const float area_p = __fmul_rn(px2 - px1, py2 - py1);
  float best = -INFINITY;

  for (int m0 = 0; m0 < n_gt; m0 += kChunk) {
    const int count = min(kChunk, n_gt - m0);
    __syncthreads();  // the previous chunk is no longer read
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const float* r = g + static_cast<long long>(m0 + j) * 4;
      const float x1 = r[0], y1 = r[1], x2 = r[2], y2 = r[3];
      gx1[j] = x1;
      gy1[j] = y1;
      gx2[j] = x2;
      gy2[j] = y2;
      garea[j] = __fmul_rn(x2 - x1, y2 - y1);
    }
    __syncthreads();
    if (valid) {
      for (int j = 0; j < count; ++j) {
        const float left = max_nan(px1, gx1[j]);
        const float top = max_nan(py1, gy1[j]);
        const float right = min_nan(px2, gx2[j]);
        const float bot = min_nan(py2, gy2[j]);
        const float iw = min_nan(max_nan(right - left, 0.f), 1.f);
        const float ih = min_nan(max_nan(bot - top, 0.f), 1.f);
        const float inter = __fmul_rn(iw, ih);
        const float iou =
            __fdiv_rn(inter, ((area_p + garea[j]) - inter) + 1e-7f);
        best = max_nan(best, iou);
      }
    }
  }
  if (valid) out[static_cast<long long>(b) * n_pred + n] = best;
}

}  // namespace

// pred (B, N, 4) and gt (B, M, 4) contiguous f32, out (B, N) f32. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
extern "C" int dv_best_iou(const void* pred, const void* gt, void* out,
                           int batch, int n_pred, int n_gt, void* stream) {
  if (batch < 1 || batch > 65535 || n_pred < 1 || n_gt < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_pred + kThreads - 1) / kThreads, batch);
  best_iou_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<const float*>(gt),
      static_cast<float*>(out), n_pred, n_gt);
  return static_cast<int>(cudaGetLastError());
}
