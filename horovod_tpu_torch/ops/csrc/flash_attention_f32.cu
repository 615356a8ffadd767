// Flash attention on f32 operands: the forward, dQ and dK/dV kernels with
// every product in f32 on the CUDA cores (FFMA), f32 softmax state.
//
// Replaces the three TPU kernels of horovod_tpu/ops/flash_attention.py on
// f32 inputs (the Hopper kernels of flash_attention.cu take bf16 and f16):
//   _fwd_kernel     (:108) -> flash_f32_fwd_kernel
//   _bwd_dq_kernel  (:173) -> flash_f32_dq_kernel
//   _bwd_dkv_kernel (:226) -> flash_f32_dkv_kernel
// The reference upcasts its operands to f32 and multiplies them with
// preferred_element_type=f32, so an f32 call keeps f32 products.  The
// tensor cores' TF32 would round the operands to 10 bits of mantissa, so
// these kernels use FFMA: what bounds them is the card's f32 rate outside
// the tensor cores (67 TFLOP/s), against which the LM shape (B=4, T=2048,
// H=24, D=128, causal) needs 1.5 ms for the forward's 1.03e11 FLOP.
//
// One design for every head dim (D = 16, 32, 64, 128, 256; the wrapper
// pads the others).  A block of 256 threads, a 16 x 16 grid (ty, tx),
// holds its tiles in shared memory as rows of D + 4 floats (the 4 keep a
// float4 read of one row per thread free of bank conflicts):
// * products that reduce over the head dim (S = Q.K^T, dP = dO.V^T and
//   their transposes) give each thread 4 rows (ty * 4 + i) by 2 columns
//   (tx + 16 j) of a 64 x 32 tile, reading both operands' rows as float4
//   along d;
// * products that reduce over the tile's rows (O += P.V, dQ += dS.K, dV +=
//   P^T.dO, dK += dS^T.Q) give each thread the same 4 rows by D / 16
//   columns (groups of VEC contiguous columns), reading P or dS as float4
//   along the reduction and the other operand as VEC contiguous floats.
// The score tile goes through shared memory (64 x 36 floats) between the
// two products.  The forward and dQ own 64 q rows a block and walk key
// tiles of 32; dK/dV owns 64 keys and walks q tiles of 32.
//
// The trouble spots of flash_attention.cu hold here: -inf guards (safe_m,
// p = 0 for a masked score, corr = 0 from an empty row, denom = 1 for l =
// 0), causal tile skipping, rows past T read as zeros and never written,
// the scale after the products, di from the stored o, and a NaN-propagating
// row max.  exp is expf of the difference, as the plain version computes
// it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BR = 64;   // q rows of a forward or dQ block; keys of dK/dV
constexpr int BC = 32;   // keys of a forward or dQ tile; q rows of dK/dV
constexpr int LDP = BC + 4;  // row length of the score tile

struct Geometry {
  int H;                 // heads in the batch*head index (1 for [B*H, T, D])
  int seg_heads;         // batch*head rows per segment-id row
  int T;
  long long sb, st, sh;  // element strides of batch, time and head
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;  // NaN in either operand wins
}

__device__ __forceinline__ long long base_offset(const Geometry& g, int y) {
  return (long long)(y / g.H) * g.sb + (long long)(y % g.H) * g.sh;
}

template <int D>
struct Cols {
  static constexpr int LD = D + 4;                 // shared row length
  static constexpr int VEC = D / 16 < 4 ? D / 16 : 4;
  static constexpr int N = D / 16;                 // columns a thread holds
  // The thread's e-th column of group n.
  static __device__ __forceinline__ int col(int tx, int n, int e) {
    return n * 16 * VEC + tx * VEC + e;
  }
};

template <int VEC>
__device__ __forceinline__ void ldv(const float* p, float (&out)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x, out[1] = x.y, out[2] = x.z, out[3] = x.w;
  } else if constexpr (VEC == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x, out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

template <int VEC>
__device__ __forceinline__ void stv(float* p, const float (&in)[VEC]) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    *p = in[0];
  }
}

// ROWS rows of an operand from device memory, starting at row r0 of the
// batch*head at `src`, into a shared tile of rows of D + 4 floats; rows
// past T read as zeros.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int T, long long st) {
  constexpr int V4 = D / 4;
  for (int idx = threadIdx.x; idx < ROWS * V4; idx += THREADS) {
    const int r = idx / V4, c = (idx % V4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < T)
      x = *reinterpret_cast<const float4*>(src + (long long)(r0 + r) * st + c);
    *reinterpret_cast<float4*>(dst + r * Cols<D>::LD + c) = x;
  }
}

// acc[i][j] += a_i . b_j over the head dim: a the rows ty * 4 + i of tile
// A, b the rows tx + 16 j of tile B (both rows of D + 4 floats).
template <int D>
__device__ __forceinline__ void dot_rows(float (&acc)[4][2], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int LD = Cols<D>::LD;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float a[4][4], b[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ldv<4>(A + (ty * 4 + i) * LD + d, a[i]);
#pragma unroll
    for (int j = 0; j < 2; ++j) ldv<4>(B + (tx + 16 * j) * LD + d, b[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j] = fmaf(a[i][e], b[j][e], acc[i][j]);
  }
}

// acc[i][.] += sum_c P[ty * 4 + i][c] * B[c][.] over the RED rows of B, for
// this thread's columns: P a score tile (rows of LDP floats), B an operand
// tile (rows of D + 4 floats).
template <int D, int RED>
__device__ __forceinline__ void accumulate(float (&acc)[4][D / 16],
                                           const float* P, const float* B,
                                           int ty, int tx) {
  using C = Cols<D>;
#pragma unroll 2
  for (int c = 0; c < RED; c += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) ldv<4>(P + (ty * 4 + i) * LDP + c, p[i]);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
      for (int n = 0; n < C::N / C::VEC; ++n) {
        float b[C::VEC];
        ldv<C::VEC>(B + (c + cc) * C::LD + C::col(tx, n, 0), b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < C::VEC; ++e)
            acc[i][n * C::VEC + e] =
                fmaf(p[i][cc], b[e], acc[i][n * C::VEC + e]);
      }
    }
  }
}

// A sum over the 16 threads of a row (tx), in every one of them.
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = max_nan(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Writes this thread's rows (ty * 4 + i, below T from row r0) of an
// accumulator, times `mul`, to device memory.
template <int D>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[4][D / 16],
                                           int r0, int T, long long st,
                                           int ty, int tx, float mul) {
  using C = Cols<D>;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= T) continue;
#pragma unroll
    for (int n = 0; n < C::N / C::VEC; ++n) {
      float v[C::VEC];
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) v[e] = acc[i][n * C::VEC + e] * mul;
      stv<C::VEC>(dst + (long long)r * st + C::col(tx, n, 0), v);
    }
  }
}

template <int D>
constexpr int fwd_smem_bytes() {
  return (BR + 2 * BC) * Cols<D>::LD * 4 + BR * LDP * 4;
}

// ---------------------------------------------------------------------------
// Forward: one block per (64-row q tile, batch*head).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_f32_fwd_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ m_out, float* __restrict__ l_out,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, Geometry g, int causal,
                         float scale) {
  using C = Cols<D>;
  extern __shared__ float4 smem4[];
  float* const sQ = reinterpret_cast<float*>(smem4);
  float* const sK = sQ + BR * C::LD;
  float* const sV = sK + BC * C::LD;
  float* const sP = sV + BC * C::LD;
  const int T = g.T, y = blockIdx.x;
  // The last q tiles do the most work under causal masking: they start
  // first.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long off = base_offset(g, y);
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;
  int row[4], my_seg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty * 4 + i;
    my_seg[i] = (qs && row[i] < T) ? qs[row[i]] : 0;
  }

  load_tile<D, BR>(sQ, q + off, q0, T, g.st);
  float acc[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < C::N; ++n) acc[i][n] = 0.f;
  float m_i[4], l_part[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m_i[i] = -INFINITY, l_part[i] = 0.f;

  const int kend = causal ? min(T, q0 + BR) : T;
  for (int k0 = 0; k0 < kend; k0 += BC) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<D, BC>(sK, k + off, k0, T, g.st);
    load_tile<D, BC>(sV, v + off, k0, T, g.st);
    __syncthreads();
    float s[4][2] = {};
    dot_rows<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool ok = kc < T && (!causal || kc <= row[i]) &&
                        (!ks || ks[kc] == my_seg[i]);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = max_nan(mx, s[i][j]);
      }
      mx = row_max(mx);
      const float m_new = max_nan(m_i[i], mx);
      const float safe_m = (m_new == -INFINITY) ? 0.f : m_new;
      const float corr =
          (m_i[i] == -INFINITY) ? 0.f : expf(m_i[i] - safe_m);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = (s[i][j] == -INFINITY) ? 0.f : expf(s[i][j] - safe_m);
        sum += p;
        sP[(ty * 4 + i) * LDP + tx + 16 * j] = p;
      }
      l_part[i] = l_part[i] * corr + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int n = 0; n < C::N; ++n) acc[i][n] *= corr;
    }
    __syncthreads();
    accumulate<D, BC>(acc, sP, sV, ty, tx);
  }

  // Epilogue: l == 0 divides by 1 (a fully masked row: o = 0, m = -inf,
  // l = 0).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum(l_part[i]);
    const float denom = (l == 0.f) ? 1.f : l;
    if (row[i] >= T) continue;
#pragma unroll
    for (int n = 0; n < C::N / C::VEC; ++n) {
      float val[C::VEC];
#pragma unroll
      for (int e = 0; e < C::VEC; ++e) val[e] = acc[i][n * C::VEC + e] / denom;
      stv<C::VEC>(o + off + (long long)row[i] * g.st + C::col(tx, n, 0), val);
    }
    if (tx == 0) {
      m_out[(long long)y * T + row[i]] = m_i[i];
      l_out[(long long)y * T + row[i]] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (64-row q tile, batch*head); walks key tiles of 32.
// ---------------------------------------------------------------------------

template <int D>
constexpr int dq_smem_bytes() {
  return (2 * BR + 2 * BC) * Cols<D>::LD * 4 + BR * LDP * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_f32_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ dout,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        const int* __restrict__ qseg,
                        const int* __restrict__ kseg, float* __restrict__ dq,
                        Geometry g, int causal, float scale) {
  using C = Cols<D>;
  extern __shared__ float4 smem4[];
  float* const sQ = reinterpret_cast<float*>(smem4);
  float* const sdO = sQ + BR * C::LD;
  float* const sK = sdO + BR * C::LD;
  float* const sV = sK + BC * C::LD;
  float* const sS = sV + BC * C::LD;
  const int T = g.T, y = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BR;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long off = base_offset(g, y);
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;

  load_tile<D, BR>(sQ, q + off, q0, T, g.st);
  load_tile<D, BR>(sdO, dout + off, q0, T, g.st);
  __syncthreads();
  // Each row's statistics: safe_m, denom (trouble spot 1) and di =
  // rowsum(dO * O) from the stored o, summed by the row's 16 threads.
  int row[4], my_seg[4];
  float safe_m[4], denom[4], di[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row[i] = q0 + ty * 4 + i;
    float m = -INFINITY, l = 0.f, part = 0.f;
    my_seg[i] = 0;
    if (row[i] < T) {
      m = m_in[(long long)y * T + row[i]];
      l = l_in[(long long)y * T + row[i]];
      if (qs) my_seg[i] = qs[row[i]];
      const float* orow = o + off + (long long)row[i] * g.st;
      for (int d = tx; d < D; d += 16)
        part = fmaf(sdO[(ty * 4 + i) * C::LD + d], orow[d], part);
    }
    di[i] = row_sum(part);
    safe_m[i] = (m == -INFINITY) ? 0.f : m;
    denom[i] = (l == 0.f) ? 1.f : l;
  }

  float acc[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < C::N; ++n) acc[i][n] = 0.f;

  const int kend = causal ? min(T, q0 + BR) : T;
  for (int k0 = 0; k0 < kend; k0 += BC) {
    __syncthreads();
    load_tile<D, BC>(sK, k + off, k0, T, g.st);
    load_tile<D, BC>(sV, v + off, k0, T, g.st);
    __syncthreads();
    float s[4][2] = {}, dp[4][2] = {};
    dot_rows<D>(s, sQ, sK, ty, tx);
    dot_rows<D>(dp, sdO, sV, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + tx + 16 * j;
        const bool ok = kc < T && (!causal || kc <= row[i]) &&
                        (!ks || ks[kc] == my_seg[i]);
        const float p = ok ? expf(s[i][j] * scale - safe_m[i]) / denom[i]
                           : 0.f;
        sS[(ty * 4 + i) * LDP + tx + 16 * j] = p * (dp[i][j] - di[i]);
      }
    __syncthreads();
    accumulate<D, BC>(acc, sS, sK, ty, tx);
  }
  // The scale multiplies dQ after its products (trouble spot 3).
  store_rows<D>(dq + off, acc, q0, T, g.st, ty, tx, scale);
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (64-key tile, batch*head); walks q tiles of 32 on
// the transposed scores S^T = K . Q^T.
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * BR + 2 * BC) * Cols<D>::LD * 4 + 2 * BR * LDP * 4 +
         4 * BC * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_f32_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ o,
                         const float* __restrict__ dout,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Geometry g, int causal, float scale) {
  using C = Cols<D>;
  extern __shared__ float4 smem4[];
  float* const sK = reinterpret_cast<float*>(smem4);
  float* const sV = sK + BR * C::LD;
  float* const sQ = sV + BR * C::LD;
  float* const sdO = sQ + BC * C::LD;
  float* const sP = sdO + BC * C::LD;     // P^T, [key][q row]
  float* const sdS = sP + BR * LDP;       // dS^T
  float* const st_m = sdS + BR * LDP;     // per q row of the tile: safe_m,
  float* const st_l = st_m + BC;          // denom,
  float* const st_di = st_l + BC;         // di
  int* const st_seg = reinterpret_cast<int*>(st_di + BC);  // and segment
  const int T = g.T, y = blockIdx.x, k0 = blockIdx.y * BR;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long off = base_offset(g, y);
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;
  int key[4], key_seg[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    key[i] = k0 + ty * 4 + i;
    key_seg[i] = (ks && key[i] < T) ? ks[key[i]] : 0;
  }

  load_tile<D, BR>(sK, k + off, k0, T, g.st);
  load_tile<D, BR>(sV, v + off, k0, T, g.st);
  float acc_dk[4][C::N], acc_dv[4][C::N];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < C::N; ++n) acc_dk[i][n] = acc_dv[i][n] = 0.f;

  // Causal: the q tiles from the first one holding a row q >= k0.
  const int q_start = causal ? (k0 / BC) * BC : 0;
  for (int q0 = q_start; q0 < T; q0 += BC) {
    __syncthreads();
    load_tile<D, BC>(sQ, q + off, q0, T, g.st);
    load_tile<D, BC>(sdO, dout + off, q0, T, g.st);
    __syncthreads();
    {
      // The tile's statistics, 8 threads a row (di from the stored o).
      const int rr = threadIdx.x / 8, part_i = threadIdx.x % 8;
      const int qr = q0 + rr;
      float part = 0.f;
      if (qr < T) {
        const float* orow = o + off + (long long)qr * g.st;
        for (int d = part_i; d < D; d += 8)
          part = fmaf(sdO[rr * C::LD + d], orow[d], part);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, w);
      if (part_i == 0) {
        float m = -INFINITY, l = 0.f;
        int seg = 0;
        if (qr < T) {
          m = m_in[(long long)y * T + qr];
          l = l_in[(long long)y * T + qr];
          if (qs) seg = qs[qr];
        }
        st_m[rr] = (m == -INFINITY) ? 0.f : m;
        st_l[rr] = (l == 0.f) ? 1.f : l;
        st_di[rr] = part;
        st_seg[rr] = seg;
      }
    }
    __syncthreads();
    float s[4][2] = {}, dp[4][2] = {};
    dot_rows<D>(s, sK, sQ, ty, tx);
    dot_rows<D>(dp, sV, sdO, ty, tx);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qc = tx + 16 * j, qr = q0 + qc;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = qr < T && key[i] < T && (!causal || qr >= key[i]) &&
                        (!qs || st_seg[qc] == key_seg[i]);
        const float p =
            ok ? expf(s[i][j] * scale - st_m[qc]) / st_l[qc] : 0.f;
        sP[(ty * 4 + i) * LDP + qc] = p;
        sdS[(ty * 4 + i) * LDP + qc] = p * (dp[i][j] - st_di[qc]);
      }
    }
    __syncthreads();
    accumulate<D, BC>(acc_dv, sP, sdO, ty, tx);
    accumulate<D, BC>(acc_dk, sdS, sQ, ty, tx);
  }
  // The scale multiplies dK after its products (trouble spot 3).
  store_rows<D>(dk + off, acc_dk, k0, T, g.st, ty, tx, scale);
  store_rows<D>(dv + off, acc_dv, k0, T, g.st, ty, tx, 1.f);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

Geometry make_geometry(int H, int seg_heads, int T, long long sb,
                       long long st, long long sh) {
  Geometry g;
  g.H = H;
  g.seg_heads = seg_heads;
  g.T = T;
  g.sb = sb;
  g.st = st;
  g.sh = sh;
  return g;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* m, void* l, const void* qseg, const void* kseg,
                       int BH, const Geometry& g, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  cudaError_t err = prepare(flash_f32_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + BR - 1) / BR);
  flash_f32_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg), g,
      causal, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* m,
                      const void* l, const void* qseg, const void* kseg,
                      void* dq, int BH, const Geometry& g, int causal,
                      float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = prepare(flash_f32_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + BR - 1) / BR);
  flash_f32_dq_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<float*>(dq), g, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* m,
                       const void* l, const void* qseg, const void* kseg,
                       void* dk, void* dv, int BH, const Geometry& g,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  cudaError_t err = prepare(flash_f32_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + BR - 1) / BR);
  flash_f32_dkv_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<float*>(dk),
      static_cast<float*>(dv), g, causal, scale);
  return cudaGetLastError();
}

static_assert(dkv_smem_bytes<256>() <= 232448, "dK/dV tiles fit a block");
static_assert(dq_smem_bytes<256>() <= 232448, "dQ tiles fit a block");

}  // namespace

// The C interface, loaded with ctypes, with the signatures of
// flash_attention.cu's: every tensor f32 ([BH, T] m and l), segment ids
// int32 ([BH / seg_heads, T], or null).  D is 16, 32, 64, 128 or 256.

#define HVD_SWITCH_D(CALL)                      \
  switch (D) {                                  \
    case 16: return (int)CALL(16);              \
    case 32: return (int)CALL(32);              \
    case 64: return (int)CALL(64);              \
    case 128: return (int)CALL(128);            \
    case 256: return (int)CALL(256);            \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" int hvd_flash_fwd_f32(const void* q, const void* k, const void* v,
                                 void* o, void* m, void* l, const void* qseg,
                                 const void* kseg, int BH, int H,
                                 int seg_heads, int T, int D, long long sb,
                                 long long st, long long sh, int causal,
                                 float scale, void* stream) {
  const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DD) \
  launch_fwd<DD>(q, k, v, o, m, l, qseg, kseg, BH, g, causal, scale, s)
  HVD_SWITCH_D(CALL)
#undef CALL
}

extern "C" int hvd_flash_bwd_dq_f32(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* m,
                                    const void* l, const void* qseg,
                                    const void* kseg, void* dq, int BH, int H,
                                    int seg_heads, int T, int D, long long sb,
                                    long long st, long long sh, int causal,
                                    float scale, void* stream) {
  const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DD)                                                       \
  launch_dq<DD>(q, k, v, o, dout, m, l, qseg, kseg, dq, BH, g, causal, \
                scale, s)
  HVD_SWITCH_D(CALL)
#undef CALL
}

extern "C" int hvd_flash_bwd_dkv_f32(const void* q, const void* k,
                                     const void* v, const void* o,
                                     const void* dout, const void* m,
                                     const void* l, const void* qseg,
                                     const void* kseg, void* dk, void* dv,
                                     int BH, int H, int seg_heads, int T,
                                     int D, long long sb, long long st,
                                     long long sh, int causal, float scale,
                                     void* stream) {
  const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DD)                                                          \
  launch_dkv<DD>(q, k, v, o, dout, m, l, qseg, kseg, dk, dv, BH, g, causal, \
                 scale, s)
  HVD_SWITCH_D(CALL)
#undef CALL
}
