// The device half of the preprocessing pipeline: staged uint8 views in,
// float32 views out, one launch per view per batch (entry
// xfm_device_preprocess, wrapper ops/device_preprocess.py).
//
// It replaces no pallas_call: the JAX package writes this stage in jnp
// (xfmamba_tpu/data/device_pipeline.py, DevicePreprocess.train_batch :108
// and eval_batch :121) and XLA fuses it into the jitted train and eval
// steps (xfmamba_tpu/train/loop.py:117-124).  The port runs it here so that
// the loader's threads only decode and stage uint8, off the step's host
// thread.
//
// What it computes, for each output pixel (b, oy, ox) of (B, h, w, 1):
// the JAX stage's composition u8 / 255 -> bilinear resize to (Hr, Wr) ->
// crop at (top, left) -> horizontal flip -> nearest rotation about the
// centre with zero fill -> (x - mean) / std, with the index maps composed
// backward, so that nothing between the staged bytes and the output is
// written to device memory:
// - rotate: the inverse map sx = cos xx - sin yy + cx, sy = sin xx + cos yy
//   + cy (xx = ox - cx, yy = oy - cy, cx = (w - 1) / 2), rounded half to
//   even; a source outside the (h, w) window gives 0 before the normalize;
// - flip: sx -> w - 1 - sx where the sample's flag is set;
// - crop: (sy + top, sx + left) on the resized grid;
// - resize: the bilinear sample of the staged image at that grid point,
//   two taps an axis with the weights of jax.image.resize(...,
//   antialias=False) (half-pixel centres, normalised by their sum), which
//   the wrapper computes once in float32 and passes as tables; the row
//   pair first, then the column.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn), in the order the plain version (and JAX) writes
// them: nvcc would otherwise contract cos xx - sin yy + cx into fused
// multiply-adds, which move a source coordinate across a rounding tie where
// the plain version does not.
//
// What bounds it on the H100: the bytes.  Each output pixel reads at most
// four staged bytes (one when the resize is the identity, as the loaders
// stage it) and writes four; at bs 16, 224 x 224 a view is 0.8 MB read and
// 3.2 MB written, about 1.2 us at 3.35 TB/s, so a call is bound by its
// launch.  A thread an output pixel, 256 a block; the staged image and the
// tap tables stay in L1/L2 for the gathers.  The per-sample parameter rows
// (top, left, flip, cos, sin as float32) are drawn on the host and copied
// once a step for both views.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRow = 5;  // top, left, flip, cos, sin

__global__ void __launch_bounds__(kThreads)
    device_preprocess_kernel(const unsigned char* __restrict__ src, float* __restrict__ out,
                             const float* __restrict__ rows, const int* __restrict__ ty,
                             const float* __restrict__ wy, const int* __restrict__ tx,
                             const float* __restrict__ wx, int B, int Hs, int Ws, int h, int w,
                             int rotate, int normalize, float mean, float stdev) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long total = static_cast<long long>(B) * h * w;
  if (idx >= total) return;
  const int ox = static_cast<int>(idx % w);
  const int oy = static_cast<int>((idx / w) % h);
  const int b = static_cast<int>(idx / (static_cast<long long>(h) * w));
  int top = 0, left = 0, flip = 0;
  float cs = 1.f, sn = 0.f;
  if (rows != nullptr) {
    const float* r = rows + static_cast<long long>(b) * kRow;
    top = static_cast<int>(r[0]);
    left = static_cast<int>(r[1]);
    flip = r[2] != 0.f;
    cs = r[3];
    sn = r[4];
  }
  int sy = oy, sx = ox;
  bool valid = true;
  if (rotate) {
    const float cy = 0.5f * static_cast<float>(h - 1), cx = 0.5f * static_cast<float>(w - 1);
    const float xx = __fsub_rn(static_cast<float>(ox), cx);
    const float yy = __fsub_rn(static_cast<float>(oy), cy);
    const float fx = __fadd_rn(__fsub_rn(__fmul_rn(cs, xx), __fmul_rn(sn, yy)), cx);
    const float fy = __fadd_rn(__fadd_rn(__fmul_rn(sn, xx), __fmul_rn(cs, yy)), cy);
    sx = __float2int_rn(fx);
    sy = __float2int_rn(fy);
    valid = sx >= 0 && sx < w && sy >= 0 && sy < h;
  }
  float v = 0.f;
  if (valid) {
    const int ry = sy + top;
    const int rx = (flip ? w - 1 - sx : sx) + left;
    const int y0 = ty[ry], x0 = tx[rx];
    const int y1 = min(y0 + 1, Hs - 1), x1 = min(x0 + 1, Ws - 1);
    const unsigned char* img = src + static_cast<long long>(b) * Hs * Ws;
    const float a00 = __fdiv_rn(static_cast<float>(img[y0 * Ws + x0]), 255.f);
    const float a01 = __fdiv_rn(static_cast<float>(img[y0 * Ws + x1]), 255.f);
    const float a10 = __fdiv_rn(static_cast<float>(img[y1 * Ws + x0]), 255.f);
    const float a11 = __fdiv_rn(static_cast<float>(img[y1 * Ws + x1]), 255.f);
    const float wx0 = wx[2 * rx], wx1 = wx[2 * rx + 1];
    const float r0 = __fadd_rn(__fmul_rn(wx0, a00), __fmul_rn(wx1, a01));
    const float r1 = __fadd_rn(__fmul_rn(wx0, a10), __fmul_rn(wx1, a11));
    v = __fadd_rn(__fmul_rn(wy[2 * ry], r0), __fmul_rn(wy[2 * ry + 1], r1));
  }
  if (normalize) v = __fdiv_rn(__fsub_rn(v, mean), stdev);
  out[idx] = v;
}

}  // namespace

// src (B, Hs, Ws) uint8; out (B, h, w) float32; rows (B, 5) float32 or null
// (the eval transform: no crop, flip or rotation, h = Hr, w = Wr); ty (Hr)
// int32 and wy (Hr, 2) float32 the row taps of the resize to Hr rows, tx /
// wx the column taps to Wr columns.
extern "C" int xfm_device_preprocess(const void* src, void* out, const void* rows, const void* ty,
                                     const void* wy, const void* tx, const void* wx, int B, int Hs,
                                     int Ws, int h, int w, int rotate, int normalize, float mean,
                                     float stdev, void* stream) {
  if (B < 1 || Hs < 1 || Ws < 1 || h < 1 || w < 1) return cudaErrorInvalidValue;
  const long long total = static_cast<long long>(B) * h * w;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  device_preprocess_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned char*>(src), static_cast<float*>(out),
      static_cast<const float*>(rows), static_cast<const int*>(ty),
      static_cast<const float*>(wy), static_cast<const int*>(tx), static_cast<const float*>(wx),
      B, Hs, Ws, h, w, rotate, normalize, mean, stdev);
  return cudaGetLastError();
}
