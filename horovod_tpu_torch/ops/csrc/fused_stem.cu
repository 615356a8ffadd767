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
// about 10 operations per input element, which is small beside that but
// not negligible: done once per element, not once per tap.
//
// Design: a block owns one image's strip of R output rows and WT output
// columns (the wrapper picks R and WT; at the ResNet shape a strip is 2
// whole rows).  It stages the input rows 2 oh0 - 1 .. 2 (oh0 + R) - 1 (the
// band and its one-row halo) and the columns 2 ow0 - 1 .. 2 (ow0 + WT) - 1
// in shared memory, each row's run of bytes by one bulk copy (TMA,
// cp.async.bulk) completing on an mbarrier.  Then, the pooling identity of
// the reference (_pool_axis) done in place:
//   A. each input element once: y = relu(x * s + b); per pair of columns
//      (2j, 2j + 1) the pair's max goes where 2j was and y[2j + 1] stays
//      (the "odd" column); the halo column 2 ow0 - 1 becomes y, or -inf
//      at the image's left edge;
//   B. each output: the max over three rows of max(odd[j - 1], pair[j]),
//      written with one 16-byte store per channel group.
// So device memory sees each input byte once (the halo row a second time,
// mostly from L2) and each output byte once, all in whole 16-byte runs.
// About 72 KB of shared memory a block lets three blocks share an SM, so
// one block's loads overlap another's arithmetic.  Where C is not a
// multiple of 16 bytes (or a pointer is not 16-byte aligned) the wrapper
// picks the scalar instance, V = 1, which stages with plain loads.
//
// Rounding matches the plain PyTorch version bit for bit: it computes
// x*scale and then +offset as two operations, each rounded to x's dtype.
// __fmul_rn/__fadd_rn keep nvcc from contracting the pair into an FMA, and
// for bf16 each result is rounded to bf16 before the next operation.  The
// bf16 vector instance does the same with bf16x2 instructions
// (__hmul2_rn, __hadd2_rn): a product of two bf16 values is exact in f32
// and f32 holds more than twice bf16's precision, so rounding once to
// bf16 gives what rounding to f32 and then to bf16 gives.  Out-of-image
// taps count as -inf, as _pool_axis pads; every window of a 3x3/s2/pad1
// pool on even H and W holds at least one real element.  relu and max
// propagate NaN, as torch.relu and torch.maximum do.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_hopper.cuh"

namespace {

constexpr int THREADS = 256;

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

// relu(x * s + b) and the elementwise max of V values, rounded where the
// plain version rounds.  Operands by value: one 16-byte load each.
template <typename T, int V>
struct Ops {
  using W = Vec<T, V>;
  __device__ static W affine_relu(W x, W s, W b) {
    W r;
#pragma unroll
    for (int v = 0; v < V; ++v)
      r.v[v] = Elem<T>::store(relu_nan(Elem<T>::affine(
          Elem<T>::load(x.v[v]), Elem<T>::load(s.v[v]),
          Elem<T>::load(b.v[v]))));
    return r;
  }
  __device__ static W max(W a, W c) {
    W r;
#pragma unroll
    for (int v = 0; v < V; ++v)
      r.v[v] = Elem<T>::store(
          max_nan(Elem<T>::load(a.v[v]), Elem<T>::load(c.v[v])));
    return r;
  }
};

template <>
struct Ops<__nv_bfloat16, 8> {
  using W = Vec<__nv_bfloat16, 8>;
  __device__ static const __nv_bfloat162* pairs(const W& w) {
    return reinterpret_cast<const __nv_bfloat162*>(&w);
  }
  __device__ static W affine_relu(W x, W s, W b) {
    W r;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&r);
    const __nv_bfloat162 zero = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = __hmax2_nan(
          __hadd2_rn(__hmul2_rn(pairs(x)[i], pairs(s)[i]), pairs(b)[i]),
          zero);
    return r;
  }
  __device__ static W max(W a, W c) {
    W r;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = __hmax2_nan(pairs(a)[i], pairs(c)[i]);
    return r;
  }
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> neg_inf() {
  Vec<T, V> r;
#pragma unroll
  for (int v = 0; v < V; ++v) r.v[v] = Elem<T>::store(-INFINITY);
  return r;
}

// Bytes of the staged input of one block: 2 R + 1 rows of 2 WT + 1
// pixels, then the mbarrier.
__host__ __device__ inline long long staged_bytes(int R, int WT, int C,
                                                  int elem) {
  return (long long)(2 * R + 1) * (2 * WT + 1) * C * elem;
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
    fused_stem_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                      const T* __restrict__ offset, T* __restrict__ out,
                      int H, int W, int C, int R, int WT) {
  using W_ = Vec<T, V>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* const sx = reinterpret_cast<T*>(smem_raw);
  const int Ho = H / 2, Wo = W / 2, G = C / V;
  const int n_strips = (Ho + R - 1) / R, n_cols = (Wo + WT - 1) / WT;
  int t = blockIdx.x;
  const int ct = t % n_cols;
  t /= n_cols;
  const int oh0 = (t % n_strips) * R, ow0 = ct * WT;
  const long long b = t / n_strips;
  const int nr = min(R, Ho - oh0), nc = min(WT, Wo - ow0);
  // Local row lr is input row 2 oh0 - 1 + lr, local column lc input column
  // 2 ow0 - 1 + lc; row and column 0 lie outside the image at its top and
  // left edges.
  const int rows = 2 * nr + 1, cols = 2 * nc + 1;
  const int r_lo = oh0 == 0, c_lo = ow0 == 0;
  const int stride = (2 * WT + 1) * C;  // elements per staged row
  const long long seg = (long long)(cols - c_lo) * C;  // elements per copy
  auto src_row = [&](int lr) {
    return x + ((b * H + 2 * oh0 - 1 + lr) * W + 2 * ow0 - 1 + c_lo) *
                   (long long)C;
  };

  if constexpr (V * sizeof(T) == 16) {
    const uint32_t bar = hop::smem_u32(
        smem_raw + staged_bytes(R, WT, C, sizeof(T)));
    if (threadIdx.x == 0) {
      hop::mbar_init(bar, 1);
      hop::mbar_init_fence();
      const uint32_t bytes = (uint32_t)(seg * sizeof(T));
      hop::mbar_arrive_expect_tx(bar, (rows - r_lo) * bytes);
      for (int lr = r_lo; lr < rows; ++lr)
        hop::bulk_load(hop::smem_u32(sx + lr * stride + c_lo * C),
                       src_row(lr), bytes, bar);
    }
    __syncthreads();  // the barrier is initialised before anyone waits
    hop::mbar_wait(bar, 0);
  } else {
    const long long n = (rows - r_lo) * seg;
    for (long long i = threadIdx.x; i < n; i += THREADS) {
      const int lr = r_lo + (int)(i / seg);
      sx[lr * stride + c_lo * C + i % seg] = src_row(lr)[i % seg];
    }
    __syncthreads();
  }

  // A: per staged row, item j = 0 is the halo column, j >= 1 the pair of
  // columns 2 j - 1, 2 j; each input element transformed once.
  {
    const int n = (rows - r_lo) * (nc + 1) * G;
    for (int i = threadIdx.x; i < n; i += THREADS) {
      const int g = i % G, j = (i / G) % (nc + 1);
      T* const row = sx + (r_lo + i / (G * (nc + 1))) * stride + g * V;
      const W_ s = *reinterpret_cast<const W_*>(scale + g * V);
      const W_ o = *reinterpret_cast<const W_*>(offset + g * V);
      W_* const c = reinterpret_cast<W_*>(row + 2 * j * C);
      if (j == 0) {
        *c = c_lo ? neg_inf<T, V>() : Ops<T, V>::affine_relu(*c, s, o);
        continue;
      }
      W_* const a = reinterpret_cast<W_*>(row + (2 * j - 1) * C);
      const W_ odd = Ops<T, V>::affine_relu(*c, s, o);
      *a = Ops<T, V>::max(Ops<T, V>::affine_relu(*a, s, o), odd);
      *c = odd;
    }
  }
  __syncthreads();

  // B: output (oh0 + r, ow0 + j) is the max over local rows 2 r .. 2 r + 2
  // of max(odd[j - 1], pair[j]), at local columns 2 j and 2 j + 1.
  const int n = nr * nc * G;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int g = i % G, j = (i / G) % nc, r = i / (G * nc);
    W_ acc = neg_inf<T, V>();
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int lr = 2 * r + d;
      if (lr < r_lo) continue;
      const T* const p = sx + lr * stride + 2 * j * C + g * V;
      acc = Ops<T, V>::max(
          acc, Ops<T, V>::max(*reinterpret_cast<const W_*>(p),
                              *reinterpret_cast<const W_*>(p + C)));
    }
    *reinterpret_cast<W_*>(
        out + ((b * Ho + oh0 + r) * Wo + ow0 + j) * (long long)C + g * V) =
        acc;
  }
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* s, const void* o, void* out,
                   int B, int H, int W, int C, int R, int WT,
                   cudaStream_t stream) {
  const long long blocks = (long long)B * ((H / 2 + R - 1) / R) *
                           ((W / 2 + WT - 1) / WT);
  if (blocks == 0 || C == 0) return cudaSuccess;
  const long long smem = staged_bytes(R, WT, C, sizeof(T)) + 16;
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  fused_stem_kernel<T, V><<<(unsigned)blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(s),
      static_cast<const T*>(o), static_cast<T*>(out), H, W, C, R, WT);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vec: 1 = 16-byte vector instance (C a
// multiple of 16/sizeof(T), pointers 16-byte aligned), 0 = scalar one.
// rows, cols: output rows and columns of a block's strip (R and WT above;
// the staged input, (2 rows + 1) (2 cols + 1) C elements, must fit a
// block's shared memory).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int hvd_fused_stem_fwd(const void* x, const void* scale,
                                  const void* offset, void* out, int B, int H,
                                  int W, int C, int dtype, int vec, int rows,
                                  int cols, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    return vec ? launch<float, 4>(x, scale, offset, out, B, H, W, C, rows,
                                  cols, st)
               : launch<float, 1>(x, scale, offset, out, B, H, W, C, rows,
                                  cols, st);
  }
  if (dtype == 1) {
    return vec ? launch<__nv_bfloat16, 8>(x, scale, offset, out, B, H, W, C,
                                          rows, cols, st)
               : launch<__nv_bfloat16, 1>(x, scale, offset, out, B, H, W, C,
                                          rows, cols, st);
  }
  return (int)cudaErrorInvalidValue;
}
