// Fused ResNet stem tail for Hopper:
//   out = maxpool3x3/s2/pad1(relu(x * scale + offset)),  NHWC, even H and W.
//
// Replaces the TPU kernel horovod_tpu/ops/fused_stem.py:_kernel (launched by
// _fwd through pl.pallas_call, one whole [H, W, C] image per grid step).
// That blocking does not carry over: one 112x112x64 bf16 image is 1.6 MB,
// far beyond an SM's 227 KB of shared memory.
//
// What bounds it: memory bandwidth.  At the ResNet-50 shape
// [256, 112, 112, 64] bf16 the function must read 411.0 MB and write
// 102.8 MB, 513.8 MB in all, or 0.153 ms at 3.35 TB/s; its arithmetic is
// about 10 operations per input element, which is negligible.
//
// Design: one thread per output pixel and per group of V channels, where V
// channels fill one 16-byte load (8 bf16 or 4 float).  A thread reads its
// 3x3 input window with vector loads, applies relu(x*s + b), takes the max
// and stores V outputs with one vector store.  Neighbouring threads take
// neighbouring channel groups, so a warp's loads are contiguous.  Windows
// overlap by one row and column; the re-reads are served by L1/L2, so
// device memory sees each input byte about once.  Where C is not a
// multiple of V (or a pointer is not 16-byte aligned) the wrapper picks
// the scalar instance, V = 1.
//
// Rounding matches the plain PyTorch version bit for bit: it computes
// x*scale and then +offset as two operations, each rounded to x's dtype.
// __fmul_rn/__fadd_rn keep nvcc from contracting the pair into an FMA, and
// for bf16 each result is rounded to bf16 before the next operation.
// Out-of-image taps count as -inf, as _pool_axis pads; every window of a
// 3x3/s2/pad1 pool on even H and W holds at least one real element.
// relu and max propagate NaN, as torch.relu and torch.maximum do.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  __device__ static float load(float v) { return v; }
  __device__ static float store(float v) { return v; }
  __device__ static float affine(float x, float s, float b) {
    return __fadd_rn(__fmul_rn(x, s), b);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  __device__ static float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ static __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float affine(float x, float s, float b) {
    return rnd(__fadd_rn(rnd(__fmul_rn(x, s)), b));
  }
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float relu_nan(float y) {
  return y < 0.f ? 0.f : y;  // NaN < 0 is false: NaN passes through
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;  // NaN in either operand wins
}

template <typename T, int V>
__global__ void fused_stem_kernel(const T* __restrict__ x,
                                  const T* __restrict__ scale,
                                  const T* __restrict__ offset,
                                  T* __restrict__ out, int B, int H, int W,
                                  int C) {
  const int Ho = H / 2, Wo = W / 2, G = C / V;
  const long long total = (long long)B * Ho * Wo * G;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int g = (int)(idx % G);
  long long t = idx / G;
  const int ow = (int)(t % Wo);
  t /= Wo;
  const int oh = (int)(t % Ho);
  const long long b = t / Ho;
  const int c0 = g * V;

  float s[V], o[V], acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    s[v] = Elem<T>::load(scale[c0 + v]);
    o[v] = Elem<T>::load(offset[c0 + v]);
    acc[v] = -INFINITY;
  }
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const int ih = 2 * oh + dy;
    if (ih < 0) continue;  // even H: 2*oh+1 <= H-1 always holds
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int iw = 2 * ow + dx;
      if (iw < 0) continue;
      const Vec<T, V> in = *reinterpret_cast<const Vec<T, V>*>(
          x + ((b * H + ih) * W + iw) * (long long)C + c0);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float y =
            relu_nan(Elem<T>::affine(Elem<T>::load(in.v[v]), s[v], o[v]));
        acc[v] = max_nan(acc[v], y);
      }
    }
  }
  Vec<T, V> res;
#pragma unroll
  for (int v = 0; v < V; ++v) res.v[v] = Elem<T>::store(acc[v]);
  *reinterpret_cast<Vec<T, V>*>(out + ((b * Ho + oh) * Wo + ow) * (long long)C +
                                c0) = res;
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* s, const void* o, void* out,
                   int B, int H, int W, int C, cudaStream_t stream) {
  const long long total = (long long)B * (H / 2) * (W / 2) * (C / V);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  fused_stem_kernel<T, V><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(s),
      static_cast<const T*>(o), static_cast<T*>(out), B, H, W, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 = 16-byte vector path (C a
// multiple of 16/sizeof(T), pointers 16-byte aligned), 0 = scalar path.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int hvd_fused_stem_fwd(const void* x, const void* scale,
                                  const void* offset, void* out, int B, int H,
                                  int W, int C, int dtype, int vec,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return vec ? launch<float, 4>(x, scale, offset, out, B, H, W, C, st)
               : launch<float, 1>(x, scale, offset, out, B, H, W, C, st);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(x, scale, offset, out, B, H, W, C,
                                          st)
               : launch<__nv_bfloat16, 1>(x, scale, offset, out, B, H, W, C,
                                          st);
  }
  return (int)cudaErrorInvalidValue;
}
