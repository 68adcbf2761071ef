// The input path's device half: JPEG decode with nvJPEG, the fused
// crop/resize/flip/normalise resample, and TFRecord's CRC32C on the host.
//
// This is not the port of a TPU kernel. The JAX pipelines decode with
// TensorFlow's host libjpeg (tf.io.decode_jpeg, outside any pallas_call)
// and resize with tf.image.resize / PIL on the host; on the card the
// whole chain after the record read runs here, and a batch leaves as a
// CUDA tensor. Plain C interface, loaded with ctypes
// (deepvision_tpu_torch/data/jpeg.py); built by ops/_build.py with
// -lnvjpeg, -msse4.2 and -fmad=false (the resample's weights must be
// computed with the same float roundings as data/util.py's plain
// version and TensorFlow's table, so no multiply-add contraction).
//
// Decode: baseline JPEGs that nvjpegDecodeBatchedSupported accepts go
// through the hardware decoder (NVJPEG_BACKEND_HARDWARE, the H100's JPEG
// engines) as one batch; other sequential streams (or all of them where
// the hardware backend cannot be created) as one batch through the
// GPU-assisted backend (NVJPEG_BACKEND_GPU_HYBRID: Huffman decoded on the
// card for batches above 50); the rest (progressive) one by one through
// the default backend (Huffman on the host). Output: interleaved RGB
// (NVJPEG_OUTPUT_RGBI, grayscale replicated to three channels) into
// buffers torch allocated, on torch's current stream. Chroma is upsampled with interpolation
// (NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION) where the backend takes
// the flag, as libjpeg's default "fancy" upsampling does.
//
// Resample: one thread per output pixel of the batch, all three channels.
// Bounded by bytes (the decoded images read once, the batch written
// once); its taps are a handful of multiply-adds per byte.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

// the data CRC below is SSE4.2's crc32 instruction: ops/_build.py passes
// -msse4.2 for this source (the CPU side of the port has records.crc32c_py)
#if !defined(__SSE4_2__)
#error "jpeg_decode.cu needs SSE4.2 (build it with -Xcompiler -msse4.2)"
#endif
#include <nmmintrin.h>

namespace {

struct Decoder {
  nvjpegHandle_t hw = nullptr;       // hardware backend (may be null)
  nvjpegJpegState_t hw_state = nullptr;
  nvjpegJpegStream_t hw_stream = nullptr;
  nvjpegHandle_t gpu = nullptr;      // GPU-assisted Huffman (may be null)
  nvjpegJpegState_t gpu_state = nullptr;
  nvjpegHandle_t sw = nullptr;       // default backend
  nvjpegJpegState_t sw_state = nullptr;
  nvjpegJpegStream_t sw_stream = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int hw_batch = 0, gpu_batch = 0;   // batch sizes the states hold
  char error[512] = {0};
};

int fail(Decoder* d, const char* what, int status) {
  std::snprintf(d->error, sizeof(d->error), "%s failed with status %d",
                what, status);
  return status == 0 ? -1 : status;
}

#define NVJ(d, call)                                        \
  do {                                                      \
    nvjpegStatus_t s_ = (call);                             \
    if (s_ != NVJPEG_STATUS_SUCCESS) return fail(d, #call, (int)s_); \
  } while (0)

nvjpegStatus_t create_handle(nvjpegBackend_t backend, nvjpegHandle_t* h,
                             int* interp) {
  nvjpegStatus_t s = nvjpegCreateEx(
      backend, nullptr, nullptr, NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION,
      h);
  *interp = (s == NVJPEG_STATUS_SUCCESS);
  if (s != NVJPEG_STATUS_SUCCESS) {
    s = nvjpegCreateEx(backend, nullptr, nullptr, NVJPEG_FLAGS_DEFAULT, h);
  }
  return s;
}

// -- TensorFlow's bicubic (a = -0.5, 1/1024 table), half-pixel bilinear,
// PIL's antialiased bilinear: the weights of one output coordinate -------

constexpr int kMaxTaps = 64;

__device__ __forceinline__ float cubic_near(int i) {
  const float x = static_cast<float>(i) / 1024.0f;
  return ((1.5f * x - 2.5f) * x) * x + 1.0f;
}

__device__ __forceinline__ float cubic_far(int i) {
  const float a = -0.5f;
  const float x = static_cast<float>(i) / 1024.0f + 1.0f;
  return ((a * x - (-2.5f)) * x + (-4.0f)) * x - (-2.0f);
}

// Fills idx/w for output coordinate `o` of an in_size -> out_size axis;
// returns the tap count.
__device__ int axis_taps(int mode, int in_size, int out_size, int o,
                         int* idx, float* w) {
  const float scale = static_cast<float>(in_size) /
                      static_cast<float>(out_size);
  if (mode == 0) {                                   // bicubic
    const float loc = (static_cast<float>(o) + 0.5f) * scale - 0.5f;
    const float fl = floorf(loc);
    const int base = static_cast<int>(fl);
    const float delta = loc - fl;
    const int off = static_cast<int>(rintf(delta * 1024.0f));
    const float tab[4] = {cubic_far(off), cubic_near(off),
                          cubic_near(1024 - off), cubic_far(1024 - off)};
    float total = 0.0f;
    float wt[4];
    for (int k = 0; k < 4; ++k) {
      const int i = base - 1 + k;
      wt[k] = (i >= 0 && i < in_size) ? tab[k] : 0.0f;
      total = total + wt[k];
    }
    const float inv = 1.0f / total;
    int n = 0;
    for (int k = 0; k < 4; ++k) {
      const int i = base - 1 + k;
      if (i >= 0 && i < in_size) {
        idx[n] = i;
        w[n] = wt[k] * inv;
        ++n;
      }
    }
    return n;
  }
  if (mode == 1) {                                   // bilinear
    float loc = (static_cast<float>(o) + 0.5f) * scale - 0.5f;
    loc = fmaxf(loc, 0.0f);
    const float fl = floorf(loc);
    const int i0 = static_cast<int>(fl);
    const float lerp = loc - fl;
    idx[0] = i0;
    w[0] = 1.0f - lerp;
    idx[1] = min(i0 + 1, in_size - 1);
    w[1] = lerp;
    return 2;
  }
  // bilinear_aa
  const float support = scale >= 1.0f ? scale : 1.0f;
  const float inv = scale >= 1.0f ? 1.0f / scale : 1.0f;
  const float center = scale * (static_cast<float>(o) + 0.5f);
  const int lo = max(static_cast<int>(center - support + 0.5f), 0);
  const int hi = min(static_cast<int>(center + support + 0.5f), in_size);
  float total = 0.0f;
  int n = 0;
  for (int j = lo; j < hi && n < kMaxTaps; ++j) {
    const float t = fabsf((static_cast<float>(j) - center + 0.5f) * inv);
    const float wt = t < 1.0f ? 1.0f - t : 0.0f;
    idx[n] = j;
    w[n] = wt;
    total = total + wt;
    ++n;
  }
  if (total != 0.0f) {
    for (int k = 0; k < n; ++k) w[k] = w[k] / total;
  }
  return n;
}

// desc, per image (int32): h, w, crop y, crop x, crop h, crop w,
// resize h, resize w, window y, window x, flip, (unused)
constexpr int kDesc = 12;

struct Emit {
  int uint8_out, clip;
  float div, mean[3], std[3];
};

__global__ void resample_kernel(const unsigned char* __restrict__ src,
                                const long long* __restrict__ offsets,
                                const int* __restrict__ desc, int n_images,
                                int out_h, int out_w, int mode, Emit em,
                                void* out) {
  const long long pix = static_cast<long long>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
  const long long per_image = static_cast<long long>(out_h) * out_w;
  if (pix >= per_image * n_images) return;
  const int b = static_cast<int>(pix / per_image);
  const int rem = static_cast<int>(pix - b * per_image);
  const int y = rem / out_w, x = rem - (rem / out_w) * out_w;
  const int* d = desc + b * kDesc;
  const int width = d[1];
  const int cy = d[2], cx = d[3], ch = d[4], cw = d[5];
  const int rh = d[6], rw = d[7], oy = d[8], ox = d[9], flip = d[10];
  int yy = y + oy;
  int xx = x + ox;
  if (flip) xx = rw - 1 - xx;
  int yi[kMaxTaps], xi[kMaxTaps];
  float yw[kMaxTaps], xw[kMaxTaps];
  const int ny = axis_taps(mode, ch, rh, yy, yi, yw);
  const int nx = axis_taps(mode, cw, rw, xx, xi, xw);
  const unsigned char* img = src + offsets[b];
  float acc[3] = {0.0f, 0.0f, 0.0f};
  for (int ty = 0; ty < ny; ++ty) {
    const unsigned char* row =
        img + (static_cast<long long>(cy + yi[ty]) * width + cx) * 3;
    float r[3] = {0.0f, 0.0f, 0.0f};
    for (int tx = 0; tx < nx; ++tx) {
      const unsigned char* p = row + xi[tx] * 3;
      r[0] = r[0] + xw[tx] * static_cast<float>(p[0]);
      r[1] = r[1] + xw[tx] * static_cast<float>(p[1]);
      r[2] = r[2] + xw[tx] * static_cast<float>(p[2]);
    }
    acc[0] = acc[0] + yw[ty] * r[0];
    acc[1] = acc[1] + yw[ty] * r[1];
    acc[2] = acc[2] + yw[ty] * r[2];
  }
  const long long o = pix * 3;
  if (em.uint8_out) {
    unsigned char* dst = static_cast<unsigned char*>(out);
    for (int c = 0; c < 3; ++c) {
      dst[o + c] = static_cast<unsigned char>(
          rintf(fminf(fmaxf(acc[c], 0.0f), 255.0f)));
    }
  } else {
    float* dst = static_cast<float*>(out);
    for (int c = 0; c < 3; ++c) {
      float v = acc[c];
      if (em.clip) v = fminf(fmaxf(v, 0.0f), 255.0f);
      dst[o + c] = (v / em.div - em.mean[c]) / em.std[c];
    }
  }
}

}  // namespace

extern "C" {

const char* dv_jpeg_error(void* handle) {
  return static_cast<Decoder*>(handle)->error;
}

// Creates the decoder. *backends: bit 2 the hardware backend, bit 1 the
// GPU-assisted one, bit 0 the default; *interp the same bits for the
// handles that took NVJPEG_FLAGS_UPSAMPLING_WITH_INTERPOLATION;
// *hw_status the hardware backend's creation status.
int dv_jpeg_create(void** out, int* backends, int* interp, int* hw_status) {
  Decoder* d = new Decoder();
  *out = d;
  *backends = 0;
  *interp = 0;
  int flag = 0;
  nvjpegStatus_t s = create_handle(NVJPEG_BACKEND_HARDWARE, &d->hw, &flag);
  *hw_status = (int)s;
  if (s == NVJPEG_STATUS_SUCCESS &&
      nvjpegJpegStateCreate(d->hw, &d->hw_state) == NVJPEG_STATUS_SUCCESS &&
      nvjpegJpegStreamCreate(d->hw, &d->hw_stream) == NVJPEG_STATUS_SUCCESS) {
    *backends |= 4;
    *interp |= flag ? 4 : 0;
  } else {
    if (d->hw_state) nvjpegJpegStateDestroy(d->hw_state);
    if (s == NVJPEG_STATUS_SUCCESS) nvjpegDestroy(d->hw);
    d->hw = nullptr;
    d->hw_state = nullptr;
  }
  s = create_handle(NVJPEG_BACKEND_GPU_HYBRID, &d->gpu, &flag);
  if (s == NVJPEG_STATUS_SUCCESS &&
      nvjpegJpegStateCreate(d->gpu, &d->gpu_state) == NVJPEG_STATUS_SUCCESS) {
    *backends |= 2;
    *interp |= flag ? 2 : 0;
  } else {
    if (s == NVJPEG_STATUS_SUCCESS) nvjpegDestroy(d->gpu);
    d->gpu = nullptr;
  }
  s = create_handle(NVJPEG_BACKEND_DEFAULT, &d->sw, &flag);
  if (s != NVJPEG_STATUS_SUCCESS) return fail(d, "nvjpegCreateEx", (int)s);
  *backends |= 1;
  *interp |= flag ? 1 : 0;
  NVJ(d, nvjpegJpegStateCreate(d->sw, &d->sw_state));
  NVJ(d, nvjpegJpegStreamCreate(d->sw, &d->sw_stream));
  return 0;
}

static int decode_batched(Decoder* d, nvjpegHandle_t h, nvjpegJpegState_t state,
                   int* held, const std::vector<const unsigned char*>& data,
                   const std::vector<size_t>& len,
                   std::vector<nvjpegImage_t>& dst, cudaStream_t st,
                   const char* what) {
  if (data.empty()) return 0;
  const int m = static_cast<int>(data.size());
  if (m != *held) {
    NVJ(d, nvjpegDecodeBatchedInitialize(h, state, m, 1, NVJPEG_OUTPUT_RGBI));
    *held = m;
  }
  nvjpegStatus_t s = nvjpegDecodeBatched(h, state, data.data(), len.data(),
                                         dst.data(), st);
  if (s != NVJPEG_STATUS_SUCCESS) {
    *held = 0;  // re-initialise after a failed batch
    return fail(d, what, (int)s);
  }
  return 0;
}

// Decodes n JPEGs into interleaved RGB at outs[i] (pitch 3 * widths[i]).
// routes[i]: 2 the hardware batch, 1 the GPU-assisted batch (sequential
// baseline and extended streams), 0 the default backend one image at a
// time (progressive streams, or no batched backend). The sizes must be
// the images' own (checked against nvjpegGetImageInfo). Enqueued on
// `stream`; the caller keeps `data` alive until it has run.
int dv_jpeg_decode(void* handle, int n, const unsigned char* const* data,
                   const size_t* lengths, unsigned char* const* outs,
                   const int* widths, const int* heights, int* routes,
                   void* stream) {
  Decoder* d = static_cast<Decoder*>(handle);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  std::vector<const unsigned char*> hw_data, gpu_data;
  std::vector<size_t> hw_len, gpu_len;
  std::vector<nvjpegImage_t> hw_dst, gpu_dst;
  for (int i = 0; i < n; ++i) {
    int comps = 0;
    nvjpegChromaSubsampling_t css;
    int w[NVJPEG_MAX_COMPONENT], h[NVJPEG_MAX_COMPONENT];
    nvjpegStatus_t s = nvjpegGetImageInfo(d->sw, data[i], lengths[i], &comps,
                                          &css, w, h);
    if (s != NVJPEG_STATUS_SUCCESS) {
      std::snprintf(d->error, sizeof(d->error),
                    "nvjpegGetImageInfo failed with status %d on image %d",
                    (int)s, i);
      return (int)s;
    }
    if (w[0] != widths[i] || h[0] != heights[i]) {
      std::snprintf(d->error, sizeof(d->error),
                    "image %d is %dx%d, the caller said %dx%d", i, w[0], h[0],
                    widths[i], heights[i]);
      return -2;
    }
    nvjpegImage_t dst;
    std::memset(&dst, 0, sizeof(dst));
    dst.channel[0] = outs[i];
    dst.pitch[0] = static_cast<size_t>(widths[i]) * 3;
    int supported = 1;
    if (d->hw != nullptr &&
        nvjpegJpegStreamParse(d->hw, data[i], lengths[i], 0, 0,
                              d->hw_stream) == NVJPEG_STATUS_SUCCESS &&
        nvjpegDecodeBatchedSupported(d->hw, d->hw_stream, &supported) ==
            NVJPEG_STATUS_SUCCESS &&
        supported == 0) {
      routes[i] = 2;
      hw_data.push_back(data[i]);
      hw_len.push_back(lengths[i]);
      hw_dst.push_back(dst);
      continue;
    }
    nvjpegJpegEncoding_t enc = NVJPEG_ENCODING_UNKNOWN;
    if (d->gpu != nullptr &&
        nvjpegJpegStreamParseHeader(d->sw, data[i], lengths[i],
                                    d->sw_stream) == NVJPEG_STATUS_SUCCESS &&
        nvjpegJpegStreamGetJpegEncoding(d->sw_stream, &enc) ==
            NVJPEG_STATUS_SUCCESS &&
        (enc == NVJPEG_ENCODING_BASELINE_DCT ||
         enc == NVJPEG_ENCODING_EXTENDED_SEQUENTIAL_DCT_HUFFMAN)) {
      routes[i] = 1;
      gpu_data.push_back(data[i]);
      gpu_len.push_back(lengths[i]);
      gpu_dst.push_back(dst);
      continue;
    }
    routes[i] = 0;
    s = nvjpegDecode(d->sw, d->sw_state, data[i], lengths[i],
                     NVJPEG_OUTPUT_RGBI, &dst, st);
    if (s != NVJPEG_STATUS_SUCCESS) {
      std::snprintf(d->error, sizeof(d->error),
                    "nvjpegDecode failed with status %d on image %d", (int)s,
                    i);
      return (int)s;
    }
  }
  int rc = decode_batched(d, d->hw, d->hw_state, &d->hw_batch, hw_data,
                          hw_len, hw_dst, st, "nvjpegDecodeBatched (hardware)");
  if (rc != 0) return rc;
  rc = decode_batched(d, d->gpu, d->gpu_state, &d->gpu_batch, gpu_data,
                      gpu_len, gpu_dst, st,
                      "nvjpegDecodeBatched (GPU-assisted)");
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// Encodes one image already on the card: interleaved RGB (pitch 3 w), or
// with css == NVJPEG_CSS_GRAY a single luma plane (pitch w). Writes the
// bitstream to `out` (host) when it fits `cap` and sets *length; returns
// -3 with *length set when it does not. Synchronises `stream`.
int dv_jpeg_encode(void* handle, const unsigned char* image, int width,
                   int height, int quality, int css, unsigned char* out,
                   size_t cap, size_t* length, void* stream) {
  Decoder* d = static_cast<Decoder*>(handle);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d->enc_state == nullptr) {
    NVJ(d, nvjpegEncoderStateCreate(d->sw, &d->enc_state, st));
    NVJ(d, nvjpegEncoderParamsCreate(d->sw, &d->enc_params, st));
  }
  NVJ(d, nvjpegEncoderParamsSetQuality(d->enc_params, quality, st));
  NVJ(d, nvjpegEncoderParamsSetOptimizedHuffman(d->enc_params, 0, st));
  NVJ(d, nvjpegEncoderParamsSetSamplingFactors(
             d->enc_params, static_cast<nvjpegChromaSubsampling_t>(css), st));
  nvjpegImage_t src;
  std::memset(&src, 0, sizeof(src));
  src.channel[0] = const_cast<unsigned char*>(image);
  if (css == NVJPEG_CSS_GRAY) {
    src.pitch[0] = static_cast<size_t>(width);
    NVJ(d, nvjpegEncodeYUV(d->sw, d->enc_state, d->enc_params, &src,
                           NVJPEG_CSS_GRAY, width, height, st));
  } else {
    src.pitch[0] = static_cast<size_t>(width) * 3;
    NVJ(d, nvjpegEncodeImage(d->sw, d->enc_state, d->enc_params, &src,
                             NVJPEG_INPUT_RGBI, width, height, st));
  }
  size_t len = 0;
  NVJ(d, nvjpegEncodeRetrieveBitstream(d->sw, d->enc_state, nullptr, &len,
                                       st));
  cudaStreamSynchronize(st);
  *length = len;
  if (len > cap) return -3;
  NVJ(d, nvjpegEncodeRetrieveBitstream(d->sw, d->enc_state, out, &len, st));
  cudaStreamSynchronize(st);
  *length = len;
  return static_cast<int>(cudaGetLastError());
}

// The batch's resample (see resample_kernel). `out` is (n, out_h, out_w,
// 3) uint8 or float32.
int dv_resample(const unsigned char* src, const long long* offsets,
                const int* desc, int n_images, int out_h, int out_w,
                int mode, int uint8_out, int clip, float div,
                const float* mean, const float* std_, void* out,
                void* stream) {
  if (n_images < 1 || out_h < 1 || out_w < 1 || mode < 0 || mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Emit em;
  em.uint8_out = uint8_out;
  em.clip = clip;
  em.div = div;
  for (int c = 0; c < 3; ++c) {
    em.mean[c] = mean[c];
    em.std[c] = std_[c];
  }
  const long long total = static_cast<long long>(n_images) * out_h * out_w;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  resample_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      src, offsets, desc, n_images, out_h, out_w, mode, em, out);
  return static_cast<int>(cudaGetLastError());
}

// CRC32C (Castagnoli) of n bytes, continuing from `crc` (0 to start):
// SSE4.2's crc32 instruction, 8 bytes at a time.
unsigned int dv_crc32c(const unsigned char* p, size_t n, unsigned int crc) {
  unsigned long long c = (~crc) & 0xFFFFFFFFull;
  while (n >= 8) {
    unsigned long long v;
    std::memcpy(&v, p, 8);
    c = _mm_crc32_u64(c, v);
    p += 8;
    n -= 8;
  }
  unsigned int c32 = static_cast<unsigned int>(c);
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return ~c32;
}

}  // extern "C"
