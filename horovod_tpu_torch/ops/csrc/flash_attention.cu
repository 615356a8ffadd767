// Flash attention for Hopper: the forward, dQ and dK/dV kernels, bf16 in,
// f32 softmax state and accumulation.
//
// Replaces the three TPU kernels of horovod_tpu/ops/flash_attention.py:
//   _fwd_kernel     (:108), launched by _fwd_parts (:330) -> flash_fwd_kernel
//   _bwd_dq_kernel  (:173), launched by _bwd_parts (:399) -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel (:226), launched by _bwd_parts        -> flash_bwd_dkv_kernel
//
// What bounds them: tensor-core operations.  At the LM shape (B=4, T=2048,
// H=24, D=128, causal) one forward does 4*B*H*D*T(T+1)/2 = 1.03e11 FLOP,
// dq 1.55e11 and dkv 2.06e11, against about 0.2 GB of bytes each: 0.10,
// 0.16 and 0.21 ms at 989 TFLOP/s, versus 0.06 ms for the bytes at
// 3.35 TB/s.  So the design keeps the score tile on chip (never in device
// memory) and feeds every product to the tensor cores.
//
// Design (simple first; wgmma, TMA and warp specialisation come later):
// * The TPU grid walks (batch*head, q-block, k-block) in order on one
//   core, carrying the online-softmax state in VMEM across the k-block
//   dimension.  Here a thread block owns one 64-row tile and a loop inside
//   the block walks the other side, so nothing carries between blocks.
//   The TPU's 1024x1024 f32 score block (4 MB of VMEM) does not fit an
//   SM's 227 KB; tiles are 64x64.
// * 4 warps per block; each warp owns 16 rows of the tile.  Products run
//   through nvcuda::wmma bf16 m16n16k16 with f32 accumulation, operands
//   staged in shared memory.  The f32 score tile goes back to shared
//   memory, where the row max, exp and row sums run in plain code (two
//   lanes per row, 32 columns each); P and dS are rounded to bf16 for the
//   second product.  The row statistics m and l are summed from the f32
//   values, before that rounding.
// * Inputs are addressed through strides, so the [B, T, H, D] layout of
//   the model is read in place (no fold/transpose copies); the folded
//   [B*H, T, D] layout of _fwd_parts is the case H = 1.  m and l are
//   [B*H, T] f32 with row b*H + h, as the reference folds them.
// * Rows and keys past T (a T that is not a multiple of 64) are loaded as
//   zeros and masked.
// * Device-memory latency is what the measurements showed to matter at 8
//   warps per SM: every global access is a 16-byte load (the scalar bf16
//   loads of o for di cost the dK/dV kernel a third of its time), and the
//   forward and dQ kernels fetch the next K/V tile into registers while
//   the current one is computed.  The dK/dV kernel has no registers left
//   for that (its dK and dV accumulators take 128 per thread).
//
// Where the reference is delicate, and what this file does about it:
// 1. -inf arithmetic (reference :138-145, :196-207, :252-261).  A masked
//    score is -inf.  expf(-inf - (-inf)) is NaN in CUDA, so every guard is
//    mirrored: safe_m = (m == -inf) ? 0 : m; p = (s == -inf) ? 0 :
//    expf(s - safe_m); corr = (m_old == -inf) ? 0 : expf(m_old - safe_m);
//    denom = (l == 0) ? 1 : l.  A fully masked row gives o = 0 and zero
//    gradients.
// 2. Causal block skipping, re-derived for 64x64 tiles: the forward and
//    dq kernels of the q-tile starting at q0 visit key tiles k0 with
//    k0 <= min(q0 + 64, T) - 1 (the last row, q0 + 63, sees keys up to
//    itself); the dkv kernel of key tile k0 visits q tiles from
//    floor(k0 / 64) on (the first tile holding a row q >= k0).  Entries
//    inside a visited tile are masked by q >= k.
// 3. The scale multiplies s after the Q.K product, and dQ and dK after
//    their products; q is not pre-scaled.
// 4. di = rowsum(dO * O) comes from the stored bf16 o, upcast, and both
//    backward kernels recompute it.
// 5. NaN propagates: the row max is NaN-propagating (jnp.max is; fmaxf is
//    not), so a NaN input poisons its rows as in the reference.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int BR = 64;          // query rows per tile
constexpr int BC = 64;          // keys per tile
constexpr int NWARPS = 4;       // each warp owns 16 rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int PADH = 8;         // bf16 row padding (keeps 32-byte alignment)
constexpr int PADF = 4;         // f32 row padding

static_assert(BR == NWARPS * 16 && BC == NWARPS * 16, "16 rows per warp");
static_assert(BC == 64 && BR == 64, "two lanes per row cover 32 columns each");

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Geometry {
  int H;                 // heads folded into blockIdx.y (1 for [B*H, T, D])
  int seg_heads;         // rows of blockIdx.y per segment-id row
  int T;
  long long sb, st, sh;  // element strides of batch, time and head
};

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;  // NaN in either operand wins
}

__device__ __forceinline__ long long base_offset(const Geometry& g, int y) {
  return (long long)(y / g.H) * g.sb + (long long)(y % g.H) * g.sh;
}

// A 64-row [64, D] tile in flight: each thread holds tile_chunks<D>() of
// its 16-byte chunks in registers.
template <int D>
__host__ __device__ constexpr int tile_chunks() {
  return 64 * (D / 8) / NTHREADS;
}

// Reads rows [row0, row0 + 64) of a [T, D] slice (row stride st) into
// registers; rows past T become zeros.  The loads stay in flight until
// store_tile uses them, so a caller can fetch the next tile before
// computing on the current one.
template <int D>
__device__ __forceinline__ void fetch_tile(uint4* regs, const bf16* src,
                                           int row0, int T, long long st) {
  constexpr int CHUNKS = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int k = 0; k < tile_chunks<D>(); ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    const int r = i / CHUNKS, c = i % CHUNKS;
    regs[k] = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      regs[k] = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * st + c * 8);
  }
}

// Writes a fetched tile to shared memory with row stride D + PADH.
template <int D>
__device__ __forceinline__ void store_tile(bf16* dst, const uint4* regs) {
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int k = 0; k < tile_chunks<D>(); ++k) {
    const int i = threadIdx.x + k * NTHREADS;
    *reinterpret_cast<uint4*>(dst + (i / CHUNKS) * (D + PADH) +
                              (i % CHUNKS) * 8) = regs[k];
  }
}

template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int row0,
                                          int T, long long st) {
  uint4 regs[tile_chunks<D>()];
  fetch_tile<D>(regs, src, row0, T, st);
  store_tile<D>(dst, regs);
}

// sum_j a[j] * b[j] over N bf16 values (N a multiple of 8, both pointers
// 16-byte aligned), upcast to f32 and summed in order j = 0 .. N-1, read
// with 16-byte loads.
template <int N>
__device__ __forceinline__ float dot_bf16(const bf16* a, const bf16* b) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < N / 8; ++c) {
    const uint4 va = *reinterpret_cast<const uint4*>(a + c * 8);
    const uint4 vb = *reinterpret_cast<const uint4*>(b + c * 8);
    const bf16* pa = reinterpret_cast<const bf16*>(&va);
    const bf16* pb = reinterpret_cast<const bf16*>(&vb);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s += __bfloat162float(pa[i]) * __bfloat162float(pb[i]);
  }
  return s;
}

// out[16 x 64] (f32, ld PADF-padded) = A[16 x D] . B^T, where B is a
// [64 x D] tile: rows of A and rows of B are both contiguous in D.  The
// depth loop is outside, so each A fragment is loaded from shared memory
// once (four accumulators live); each accumulator still sums its depth
// blocks in order.
template <int D>
__device__ __forceinline__ void rows_times_rows_t(float* out, const bf16* a,
                                                  const bf16* b) {
  FragAcc acc[64 / 16];
#pragma unroll
  for (int n = 0; n < 64 / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, D + PADH);
#pragma unroll
    for (int n = 0; n < 64 / 16; ++n) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + n * 16 * (D + PADH) + kk * 16, D + PADH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < 64 / 16; ++n)
    wmma::store_matrix_sync(out + n * 16, acc[n], 64 + PADF,
                            wmma::mem_row_major);
}

// acc[n] += P[16 x 64] . X[64 x D] for the D/16 column blocks n, P with row
// stride 64 + PADH and X with row stride D + PADH.  Depth outside, as
// above: each P fragment is loaded once.
template <int D>
__device__ __forceinline__ void accumulate_p_times_x(FragAcc* acc,
                                                     const bf16* p,
                                                     const bf16* x) {
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + kk * 16, 64 + PADH);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, x + kk * 16 * (D + PADH) + n * 16, D + PADH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: one block per (64-row q tile, batch*head).
// ---------------------------------------------------------------------------

template <int D>
constexpr int fwd_smem_bytes() {
  return 3 * 64 * (D + PADH) * 2      // Q, K, V tiles
         + 64 * (64 + PADF) * 4       // S
         + 64 * (64 + PADH) * 2       // P (bf16)
         + 64 * (D + PADF) * 4;       // O accumulator
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg, Geometry g, int causal,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + 64 * (D + PADH);
  bf16* sV = sK + 64 * (D + PADH);
  float* sS = reinterpret_cast<float*>(sV + 64 * (D + PADH));
  bf16* sP = reinterpret_cast<bf16*>(sS + 64 * (64 + PADF));
  float* sO = reinterpret_cast<float*>(sP + 64 * (64 + PADH));

  // Under causal masking the last q tiles do the most work: start them
  // first, so the short ones fill the tail.
  const int T = g.T, y = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const long long off = base_offset(g, y);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  const int qrow = q0 + r;
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int my_seg = (qs && qrow < T) ? qs[qrow] : 0;

  load_tile<D>(sQ, q + off, q0, T, g.st);
  for (int i = threadIdx.x; i < 64 * (D + PADF); i += NTHREADS) sO[i] = 0.f;

  float m_i = -INFINITY, l_i = 0.f;
  // Trouble spot 2: key tiles past the tile's last row are skipped.
  const int kend = causal ? min(T, q0 + BR) : T;
  uint4 kreg[tile_chunks<D>()], vreg[tile_chunks<D>()];
  fetch_tile<D>(kreg, k + off, 0, T, g.st);
  fetch_tile<D>(vreg, v + off, 0, T, g.st);
  for (int k0 = 0; k0 < kend; k0 += BC) {
    __syncthreads();  // the previous tile's K/V are no longer read
    store_tile<D>(sK, kreg);
    store_tile<D>(sV, vreg);
    __syncthreads();
    // The next tile's loads fly while this one is computed.
    if (k0 + BC < kend) {
      fetch_tile<D>(kreg, k + off, k0 + BC, T, g.st);
      fetch_tile<D>(vreg, v + off, k0 + BC, T, g.st);
    }

    rows_times_rows_t<D>(sS + warp * 16 * (64 + PADF),
                         sQ + warp * 16 * (D + PADH), sK);
    __syncwarp();

    // Online softmax over this row's 32 columns, two lanes per row.
    const float* srow = sS + r * (64 + PADF) + half * 32;
    float sv[32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kc = k0 + half * 32 + j;
      const bool ok = kc < T && (!causal || kc <= qrow) &&
                      (!qs || ks[kc] == my_seg);
      sv[j] = ok ? srow[j] * scale : -INFINITY;
      mx = max_nan(mx, sv[j]);
    }
    mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = max_nan(m_i, mx);
    const float safe_m = (m_new == -INFINITY) ? 0.f : m_new;
    const float corr = (m_i == -INFINITY) ? 0.f : expf(m_i - safe_m);
    bf16* prow = sP + r * (64 + PADH) + half * 32;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float p = (sv[j] == -INFINITY) ? 0.f : expf(sv[j] - safe_m);
      sum += p;
      prow[j] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * corr + sum;
    m_i = m_new;
    float* orow = sO + r * (D + PADF) + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) orow[j] *= corr;
    __syncwarp();

    // O_w += P_w . V, the accumulator round-tripping through shared memory
    // so that the per-row rescale above stays plain code.
    FragAcc acc[D / 16];
    float* ow = sO + warp * 16 * (D + PADF);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::load_matrix_sync(acc[n], ow + n * 16, D + PADF,
                             wmma::mem_row_major);
    accumulate_p_times_x<D>(acc, sP + warp * 16 * (64 + PADH), sV);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(ow + n * 16, acc[n], D + PADF,
                              wmma::mem_row_major);
    __syncwarp();
  }

  if (qrow < T) {
    const float denom = (l_i == 0.f) ? 1.f : l_i;
    const float* orow = sO + r * (D + PADF) + half * (D / 2);
    bf16* dst = o + off + (long long)qrow * g.st + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dst[j] = __float2bfloat16(orow[j] / denom);
    if (half == 0) {
      m_out[(long long)y * T + qrow] = m_i;
      l_out[(long long)y * T + qrow] = l_i;
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (64-row q tile, batch*head); streams key tiles.
// ---------------------------------------------------------------------------

template <int D>
constexpr int dq_smem_bytes() {
  return 4 * 64 * (D + PADH) * 2      // Q, dO (reused to stage dQ), K, V
         + 64 * (64 + PADF) * 4       // S, then dP
         + 64 * (64 + PADH) * 2;      // dS (bf16)
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        const int* __restrict__ qseg,
                        const int* __restrict__ kseg, bf16* __restrict__ dq,
                        Geometry g, int causal, float scale) {
  static_assert(64 * (D + PADF) * 4 <= 2 * 64 * (D + PADH) * 2,
                "dQ staging fits in the Q and dO tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + 64 * (D + PADH);
  bf16* sK = sdO + 64 * (D + PADH);
  bf16* sV = sK + 64 * (D + PADH);
  float* sS = reinterpret_cast<float*>(sV + 64 * (D + PADH));
  bf16* sdS = reinterpret_cast<bf16*>(sS + 64 * (64 + PADF));

  // Heavy (late) q tiles first, as in the forward.
  const int T = g.T, y = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BR;
  const long long off = base_offset(g, y);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  const int qrow = q0 + r;
  const bool live = qrow < T;
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int my_seg = (qs && live) ? qs[qrow] : 0;

  load_tile<D>(sQ, q + off, q0, T, g.st);
  load_tile<D>(sdO, dout + off, q0, T, g.st);
  __syncthreads();

  const float m_i = live ? m_in[(long long)y * T + qrow] : -INFINITY;
  const float l_i = live ? l_in[(long long)y * T + qrow] : 0.f;
  const float safe_m = (m_i == -INFINITY) ? 0.f : m_i;
  const float denom = (l_i == 0.f) ? 1.f : l_i;
  // Trouble spot 4: di from the stored bf16 o, upcast.
  float di = 0.f;
  if (live)
    di = dot_bf16<D / 2>(sdO + r * (D + PADH) + half * (D / 2),
                         o + off + (long long)qrow * g.st + half * (D / 2));
  di += __shfl_xor_sync(0xffffffffu, di, 1);

  FragAcc acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  const int kend = causal ? min(T, q0 + BR) : T;
  uint4 kreg[tile_chunks<D>()], vreg[tile_chunks<D>()];
  fetch_tile<D>(kreg, k + off, 0, T, g.st);
  fetch_tile<D>(vreg, v + off, 0, T, g.st);
  for (int k0 = 0; k0 < kend; k0 += BC) {
    __syncthreads();
    store_tile<D>(sK, kreg);
    store_tile<D>(sV, vreg);
    __syncthreads();
    if (k0 + BC < kend) {
      fetch_tile<D>(kreg, k + off, k0 + BC, T, g.st);
      fetch_tile<D>(vreg, v + off, k0 + BC, T, g.st);
    }

    // S, then p into registers, then dP into the same buffer.
    float* sw = sS + warp * 16 * (64 + PADF);
    rows_times_rows_t<D>(sw, sQ + warp * 16 * (D + PADH), sK);
    __syncwarp();
    const float* srow = sS + r * (64 + PADF) + half * 32;
    float pv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int kc = k0 + half * 32 + j;
      const bool ok = live && kc < T && (!causal || kc <= qrow) &&
                      (!qs || ks[kc] == my_seg);
      const float s = ok ? srow[j] * scale : -INFINITY;
      pv[j] = (s == -INFINITY) ? 0.f : expf(s - safe_m) / denom;
    }
    __syncwarp();
    rows_times_rows_t<D>(sw, sdO + warp * 16 * (D + PADH), sV);
    __syncwarp();
    bf16* dsrow = sdS + r * (64 + PADH) + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      dsrow[j] = __float2bfloat16(pv[j] * (srow[j] - di));
    __syncwarp();
    accumulate_p_times_x<D>(acc, sdS + warp * 16 * (64 + PADH), sK);
  }

  __syncthreads();  // every warp is done with sQ/sdO: reuse them as staging
  float* const stage_base = reinterpret_cast<float*>(sQ);
  float* stage = stage_base + warp * 16 * (D + PADF);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int i = 0; i < acc[n].num_elements; ++i) acc[n].x[i] *= scale;
    wmma::store_matrix_sync(stage + n * 16, acc[n], D + PADF,
                            wmma::mem_row_major);
  }
  __syncwarp();
  if (live) {
    const float* srow = stage_base + r * (D + PADF) + half * (D / 2);
    bf16* dst = dq + off + (long long)qrow * g.st + half * (D / 2);
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dst[j] = __float2bfloat16(srow[j]);
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (64-key tile, batch*head); streams query tiles.
// Warp w owns keys 16w..16w+15 and works on the transposed scores
// S^T = K . Q^T, so P^T and dS^T feed dV += P^T . dO and dK += dS^T . Q.
// ---------------------------------------------------------------------------

template <int D>
constexpr int dkv_smem_bytes() {
  return 4 * 64 * (D + PADH) * 2      // K, V, Q, dO (Q, dO reused to stage)
         + 64 * (64 + PADF) * 4       // S^T, then dP^T
         + 2 * 64 * (64 + PADH) * 2   // P^T, dS^T (bf16)
         + 3 * 64 * 4;                // safe_m, denom, di of the q tile
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, Geometry g, int causal,
                         float scale) {
  static_assert(64 * (D + PADF) * 4 <= 2 * 64 * (D + PADH) * 2,
                "dK/dV staging fits in the Q and dO tiles");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + 64 * (D + PADH);
  bf16* sQ = sV + 64 * (D + PADH);
  bf16* sdO = sQ + 64 * (D + PADH);
  float* sST = reinterpret_cast<float*>(sdO + 64 * (D + PADH));
  bf16* sPT = reinterpret_cast<bf16*>(sST + 64 * (64 + PADF));
  bf16* sdST = sPT + 64 * (64 + PADH);
  float* sM = reinterpret_cast<float*>(sdST + 64 * (64 + PADH));
  float* sL = sM + 64;
  float* sDi = sL + 64;

  const int T = g.T, y = blockIdx.y, k0 = blockIdx.x * BC;
  const long long off = base_offset(g, y);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = warp * 16 + (lane >> 1), half = lane & 1;
  const int krow = k0 + r;
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int my_seg = (ks && krow < T) ? ks[krow] : 0;

  load_tile<D>(sK, k + off, k0, T, g.st);
  load_tile<D>(sV, v + off, k0, T, g.st);

  FragAcc acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_dk[n], 0.f);
    wmma::fill_fragment(acc_dv[n], 0.f);
  }

  // Trouble spot 2: the first q tile with a row q >= k0.
  const int qstart = causal ? (k0 / BR) * BR : 0;
  for (int q0 = qstart; q0 < T; q0 += BR) {
    __syncthreads();
    load_tile<D>(sQ, q + off, q0, T, g.st);
    load_tile<D>(sdO, dout + off, q0, T, g.st);
    __syncthreads();
    {
      // Row statistics of the q tile: two threads per row.
      const int rr = threadIdx.x >> 1, hh = threadIdx.x & 1;
      const int qr = q0 + rr;
      float part = 0.f;
      if (qr < T)
        part = dot_bf16<D / 2>(sdO + rr * (D + PADH) + hh * (D / 2),
                               o + off + (long long)qr * g.st + hh * (D / 2));
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (hh == 0) {
        const float mm = qr < T ? m_in[(long long)y * T + qr] : -INFINITY;
        const float ll = qr < T ? l_in[(long long)y * T + qr] : 0.f;
        sM[rr] = (mm == -INFINITY) ? 0.f : mm;
        sL[rr] = (ll == 0.f) ? 1.f : ll;
        sDi[rr] = part;
      }
    }
    __syncthreads();

    // S^T, then P^T into registers (and bf16 shared memory), then dP^T
    // into the same f32 buffer.
    float* sw = sST + warp * 16 * (64 + PADF);
    rows_times_rows_t<D>(sw, sK + warp * 16 * (D + PADH), sQ);
    __syncwarp();
    const float* srow = sST + r * (64 + PADF) + half * 32;
    bf16* prow = sPT + r * (64 + PADH) + half * 32;
    float pv[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int qc = half * 32 + j, qr = q0 + qc;
      const bool ok = qr < T && krow < T && (!causal || qr >= krow) &&
                      (!qs || qs[qr] == my_seg);
      const float s = ok ? srow[j] * scale : -INFINITY;
      pv[j] = (s == -INFINITY) ? 0.f : expf(s - sM[qc]) / sL[qc];
      prow[j] = __float2bfloat16(pv[j]);
    }
    __syncwarp();
    rows_times_rows_t<D>(sw, sV + warp * 16 * (D + PADH), sdO);
    __syncwarp();
    bf16* dsrow = sdST + r * (64 + PADH) + half * 32;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      dsrow[j] = __float2bfloat16(pv[j] * (srow[j] - sDi[half * 32 + j]));
    __syncwarp();
    accumulate_p_times_x<D>(acc_dv, sPT + warp * 16 * (64 + PADH), sdO);
    accumulate_p_times_x<D>(acc_dk, sdST + warp * 16 * (64 + PADH), sQ);
  }

  __syncthreads();  // every warp is done with sQ/sdO: reuse as staging
  float* const stage_base = reinterpret_cast<float*>(sQ);
  float* stage = stage_base + warp * 16 * (D + PADF);
  const float* srow = stage_base + r * (D + PADF) + half * (D / 2);
  const long long dst_off = off + (long long)krow * g.st + half * (D / 2);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
#pragma unroll
    for (int i = 0; i < acc_dk[n].num_elements; ++i) acc_dk[n].x[i] *= scale;
    wmma::store_matrix_sync(stage + n * 16, acc_dk[n], D + PADF,
                            wmma::mem_row_major);
  }
  __syncwarp();
  if (krow < T) {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk[dst_off + j] = __float2bfloat16(srow[j]);
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc_dv[n], D + PADF,
                            wmma::mem_row_major);
  __syncwarp();
  if (krow < T) {
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dv[dst_off + j] = __float2bfloat16(srow[j]);
  }
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
  cudaError_t err = prepare(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.T + BR - 1) / BR, BH);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(m), static_cast<float*>(l),
      static_cast<const int*>(qseg), static_cast<const int*>(kseg), g, causal,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* m,
                      const void* l, const void* qseg, const void* kseg,
                      void* dq, int BH, const Geometry& g, int causal,
                      float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  cudaError_t err = prepare(flash_bwd_dq_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.T + BR - 1) / BR, BH);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<bf16*>(dq), g, causal,
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
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((g.T + BC - 1) / BC, BH);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), g, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The C interface, loaded with ctypes.  Tensors are bf16 except m and l
// (f32, [BH, T]) and the segment ids (int32, [BH / seg_heads, T], or null
// for none).  Element (y, t, d) of q, k, v, o, dout, dq, dk, dv lives at
// (y / H) * sb + (y % H) * sh + t * st + d.  D is 16, 32, 64 or 128.
// Each returns the cudaError_t of its launch (0 on success).

extern "C" int hvd_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* m, void* l, const void* qseg,
                             const void* kseg, int BH, int H, int seg_heads,
                             int T, int D, long long sb, long long st,
                             long long sh, int causal, float scale,
                             void* stream) {
  const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVD_CALL(DD) \
  launch_fwd<DD>(q, k, v, o, m, l, qseg, kseg, BH, g, causal, scale, s)
  switch (D) {
    case 16: return (int)HVD_CALL(16);
    case 32: return (int)HVD_CALL(32);
    case 64: return (int)HVD_CALL(64);
    case 128: return (int)HVD_CALL(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef HVD_CALL
}

extern "C" int hvd_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* m, const void* l,
                                const void* qseg, const void* kseg, void* dq,
                                int BH, int H, int seg_heads, int T, int D,
                                long long sb, long long st, long long sh,
                                int causal, float scale, void* stream) {
  const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVD_CALL(DD)                                                       \
  launch_dq<DD>(q, k, v, o, dout, m, l, qseg, kseg, dq, BH, g, causal, \
                scale, s)
  switch (D) {
    case 16: return (int)HVD_CALL(16);
    case 32: return (int)HVD_CALL(32);
    case 64: return (int)HVD_CALL(64);
    case 128: return (int)HVD_CALL(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef HVD_CALL
}

extern "C" int hvd_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* o, const void* dout,
                                 const void* m, const void* l,
                                 const void* qseg, const void* kseg, void* dk,
                                 void* dv, int BH, int H, int seg_heads, int T,
                                 int D, long long sb, long long st,
                                 long long sh, int causal, float scale,
                                 void* stream) {
  const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define HVD_CALL(DD)                                                          \
  launch_dkv<DD>(q, k, v, o, dout, m, l, qseg, kseg, dk, dv, BH, g, causal, \
                 scale, s)
  switch (D) {
    case 16: return (int)HVD_CALL(16);
    case 32: return (int)HVD_CALL(32);
    case 64: return (int)HVD_CALL(64);
    case 128: return (int)HVD_CALL(128);
    default: return (int)cudaErrorInvalidValue;
  }
#undef HVD_CALL
}
