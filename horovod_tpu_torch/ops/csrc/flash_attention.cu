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
// dq 1.55e11 and dkv 2.06e11, against about 0.2-0.35 GB of bytes each:
// 0.10, 0.16 and 0.21 ms at 989 TFLOP/s, versus 0.06-0.11 ms for the bytes
// at 3.35 TB/s.  The score tile never leaves the chip.
//
// The TPU grid walks (batch*head, q-block, k-block) in order on one core,
// carrying the online-softmax state in VMEM across the k-block dimension.
// Here a thread block owns one tile and a loop inside it walks the other
// side, so nothing carries between blocks.
//
// Forward and dK/dV (Hopper design, flash_hopper.cuh for the PTX).  The
// full tensor-core rate needs wgmma, whose operands come from shared
// memory (or A from registers) and whose sums stay in registers; round
// trips of S and O through shared memory and register-staged tile loads
// leave a kernel waiting on memory.  So:
// * Warp specialisation: two consumer warpgroups, each owning 64 rows of
//   the block's tile, and a producer.  The producer feeds a ring of
//   shared-memory stages by TMA (one thread issues a whole tile; the copy
//   completes on an mbarrier) and waits for the consumers to free a
//   stage; the consumers only compute.  One block per SM.
// * Forward, per 128-row q tile: Q once, then K and V tiles of 128 keys
//   through three stages (K and V on separate barriers, so S can start
//   before V lands).  S = Q.K^T is one wgmma m64n128k16 chain per
//   warpgroup into registers; the online softmax runs there (row max over
//   the four lanes that share a row, by shuffles; O rescaled in
//   registers); P is rounded to bf16 in registers and is the A operand of
//   O += P.V, V read MN-major from shared memory.  O, m and l never leave
//   the registers until the epilogue.  The producer is one warp (288
//   threads).
// * dK/dV, per 128-key tile: K and V once, then Q, dO and O tiles of 64
//   rows through three stages.  A producer warpgroup loads them and
//   computes each row's di (from the loaded O), m and l into the stage
//   while the consumers work on earlier ones; setmaxnreg gives its
//   registers to the consumers (232 each), whose dK and dV accumulators
//   (64 x D f32 per warpgroup, 128 registers a thread at D = 128) stay in
//   registers over the whole q loop.  S^T = K.Q^T and dP^T = V.dO^T by
//   wgmma into registers; P^T = exp(S^T scale - m) / l (as one exp2 of
//   the log2-scaled difference) and dS^T = P^T (dP^T - di) in registers;
//   dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as register A
//   operands and the same Q and dO tiles read MN-major, so no transposed
//   copy is needed.
// * Tiles are [rows, D] in TMA's swizzled layout (flash_hopper.cuh); the
//   maps address [B, T, H, D] in place as a 4-D (d, t, h, b) tensor, and
//   the folded [B*H, T, D] layout of _fwd_parts as H = 1.  m and l are
//   [B*H, T] f32 with row b*H + h, as the reference folds them.
//
// dQ (the earlier design, not yet redesigned for Hopper): 4 warps, 64x64
// tiles, nvcuda::wmma bf16 m16n16k16 with f32 accumulation, S and dP
// staged in shared memory, the next K/V tile fetched into registers during
// the current tile's compute.
//
// Where the reference is delicate, and what this file does about it:
// 1. -inf arithmetic (reference :138-145, :196-207, :252-261).  A masked
//    score is -inf.  exp(-inf - (-inf)) is NaN in CUDA, so every guard is
//    mirrored: safe_m = (m == -inf) ? 0 : m; p = (s == -inf) ? 0 :
//    exp(s - safe_m); corr = (m_old == -inf) ? 0 : exp(m_old - safe_m);
//    denom = (l == 0) ? 1 : l.  A fully masked row gives o = 0, l = 0 and
//    zero dQ, with dK and dV finite.
// 2. Causal block skipping, re-derived for each tiling: the forward's q
//    tile at q0 (128 rows) visits key tiles k0 < min(T, q0 + 128); dQ's
//    (64 rows) k0 <= min(q0 + 64, T) - 1; dK/dV's key tile at k0 (128
//    keys) visits q tiles of 64 from floor(k0 / 64) on, and a warpgroup
//    skips a q tile that lies wholly before its 64 keys.  Entries inside
//    a visited tile are masked by q >= k.
// 3. Tails: TMA reads rows past T as zeros (T = 40, 64 or 192 leave a
//    tile partly empty), and keys and queries past T are still masked by
//    index; rows past T are not written.  The scale multiplies s after
//    the Q.K product, and dQ and dK after their products; q is not
//    pre-scaled.
// 4. di = rowsum(dO * O) comes from the stored bf16 o, upcast, summed in
//    f32, in both backward kernels.
// 5. NaN propagates: the row max is NaN-propagating (jnp.max is; fmaxf is
//    not), so a NaN input poisons its rows as in the reference.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

#include "flash_hopper.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

// dQ tiles.
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
// The Hopper kernels (forward, dK/dV): shared pieces
// ---------------------------------------------------------------------------

// Two consumer warpgroups of 128 threads and a producer: one warp in the
// forward; in dK/dV a whole warpgroup, so that setmaxnreg can move its
// registers to the consumers (dK and dV alone take 128 a thread).
constexpr int CONSUMERS = 256;
constexpr int FWD_THREADS = CONSUMERS + 32;
constexpr int DKV_THREADS = CONSUMERS + 128;
constexpr float LOG2E = 1.4426950408889634f;

// Forward tiles: 128 q rows per block (64 per consumer warpgroup), key
// tiles of 128 through a ring of three stages (225 KB at D = 128).
constexpr int FWD_BR = 128;
constexpr int FWD_BC = 128;
constexpr int FWD_STAGES = 3;
// dK/dV tiles: 128 keys per block (64 per consumer warpgroup), q tiles of
// 64 through a ring of three stages.
constexpr int DKV_BK = 128;
constexpr int DKV_BQ = 64;
constexpr int DKV_STAGES = 3;

// The first 1024-aligned byte of the dynamic shared memory (its shared
// address and its generic pointer); launches ask for 1024 bytes more.
struct SmemBase {
  uint32_t addr;
  unsigned char* ptr;
};

__device__ __forceinline__ SmemBase smem_base(unsigned char* raw) {
  const uint32_t a = hop::smem_u32(raw);
  const uint32_t aligned = (a + 1023u) & ~1023u;
  return {aligned, raw + (aligned - a)};
}

// Causal skipping (trouble spot 2), one helper per kernel so that the
// producer and the consumers walk the same tiles.  Forward: the q tile at
// q0 visits key tiles up to its last row, k0 < min(T, q0 + FWD_BR).
__device__ __forceinline__ int fwd_key_tiles(int q0, int T, int causal) {
  const int kend = causal ? min(T, q0 + FWD_BR) : T;
  return (kend + FWD_BC - 1) / FWD_BC;
}

// dK/dV: the key tile at k0 visits q tiles from the first one holding a
// row q >= k0.
__device__ __forceinline__ int dkv_first_q_tile(int k0, int causal) {
  return causal ? k0 / DKV_BQ : 0;
}

// ---------------------------------------------------------------------------
// Forward: one block per (128-row q tile, batch*head).
// ---------------------------------------------------------------------------

template <int D>
constexpr int fwd_smem_bytes() {
  return 1024 + FWD_BR * D * 2 + FWD_STAGES * 2 * FWD_BC * D * 2 +
         8 * (1 + 3 * FWD_STAGES);
}

template <int D>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     bf16* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg, Geometry g, int causal,
                     float scale) {
  constexpr int Q_BYTES = FWD_BR * D * 2;
  constexpr int KV_BYTES = FWD_BC * D * 2;
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = smem_base(smem_raw);
  const uint32_t sQ = sm.addr;
  const uint32_t sKV = sQ + Q_BYTES;  // stage s: K at + 2 s KV, V after it
  // Barriers: Q loaded; per stage, K loaded, V loaded (S can start
  // before V lands) and freed by the consumers.
  const uint32_t q_full = sKV + FWD_STAGES * 2 * KV_BYTES;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * FWD_STAGES;
  const uint32_t empty = v_full + 8 * FWD_STAGES;

  // Under causal masking the last q tiles do the most work: blockIdx.y = 0
  // takes the last tile of every batch*head, so the long blocks start
  // first and the short ones fill the tail.
  const int T = g.T, y = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FWD_BR;
  const int n_tiles = fwd_key_tiles(q0, T, causal);

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      hop::mbar_init(k_full + 8 * s, 1);
      hop::mbar_init(v_full + 8 * s, 1);
      hop::mbar_init(empty + 8 * s, CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer: one thread keeps the ring of K/V tiles filled by TMA.
    if (threadIdx.x == CONSUMERS) {
      const int h = y % g.H, b = y / g.H;
      hop::mbar_arrive_expect_tx(q_full, Q_BYTES);
      hop::tma_tile<D, FWD_BR>(sQ, &tm_q, q_full, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % FWD_STAGES;
        hop::mbar_wait(empty + 8 * s, ((i / FWD_STAGES) & 1) ^ 1);
        const uint32_t sK = sKV + s * 2 * KV_BYTES;
        hop::mbar_arrive_expect_tx(k_full + 8 * s, KV_BYTES);
        hop::tma_tile<D, FWD_BC>(sK, &tm_k, k_full + 8 * s, i * FWD_BC, h, b);
        hop::mbar_arrive_expect_tx(v_full + 8 * s, KV_BYTES);
        hop::tma_tile<D, FWD_BC>(sK + KV_BYTES, &tm_v, v_full + 8 * s,
                                 i * FWD_BC, h, b);
      }
    }
    return;
  }

  // Consumers: warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64);
  // this thread holds rows row[0] and row[1] = row[0] + 8 of S and O.
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int warp = (threadIdx.x % 128) / 32;
  const int r_first = q0 + wg * 64;
  int row[2];
  row[0] = r_first + warp * 16 + lane / 4;
  row[1] = row[0] + 8;
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;
  int my_seg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) my_seg[r] = (qs && row[r] < T) ? qs[row[r]] : 0;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};

  hop::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % FWD_STAGES, k0 = i * FWD_BC;
    const uint32_t sK = sKV + s * 2 * KV_BYTES, sV = sK + KV_BYTES;
    hop::mbar_wait(k_full + 8 * s, (i / FWD_STAGES) & 1);

    // S = Q . K^T for this warpgroup's 64 rows, into registers.
    float sc[FWD_BC / 2];
    hop::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hop::wgmma_ss<FWD_BC>(sc, hop::kmajor<D, FWD_BR>(sQ, wg * 64, kk),
                            hop::kmajor<D, FWD_BC>(sK, 0, kk), kk > 0);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(sc);

    // Scale, then mask (trouble spots 2 and 3): only tiles that cross the
    // diagonal, the end of the sequence or a segment need the test.
    const bool need_mask = k0 + FWD_BC > T || ks != nullptr ||
                           (causal && k0 + FWD_BC - 1 > r_first);
#pragma unroll
    for (int j = 0; j < FWD_BC / 2; ++j) {
      sc[j] *= scale;
      if (need_mask) {
        const int r = (j / 2) % 2;
        const int kc = k0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
        const bool ok = kc < T && (!causal || kc <= row[r]) &&
                        (!ks || ks[kc] == my_seg[r]);
        if (!ok) sc[j] = -INFINITY;
      }
    }

    // Online softmax in registers.  Four lanes share a row: the row max
    // is reduced over them by shuffles; the row sum stays a per-thread
    // partial until the end (every term of a row is rescaled alike).
    float corr[2], neg_m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < FWD_BC / 2; ++j)
        if ((j / 2) % 2 == r) mx = max_nan(mx, sc[j]);
      mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = max_nan(m_i[r], mx);
      const float safe_m = (m_new == -INFINITY) ? 0.f : m_new;
      corr[r] = (m_i[r] == -INFINITY) ? 0.f
                                      : exp2f((m_i[r] - safe_m) * LOG2E);
      neg_m2[r] = -safe_m * LOG2E;
      m_i[r] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < FWD_BC / 2; ++j) {
      const int r = (j / 2) % 2;
      const float p = (sc[j] == -INFINITY)
                          ? 0.f
                          : exp2f(fmaf(sc[j], LOG2E, neg_m2[r]));
      sum[r] += p;
      sc[j] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_part[r] = l_part[r] * corr[r] + sum[r];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) acc[j] *= corr[(j / 2) % 2];

    // O += P . V, P rounded to bf16 as the register A operand (its
    // accumulator layout is the A layout of 16-column slices).
    uint32_t pa[FWD_BC / 16][4];
#pragma unroll
    for (int kk = 0; kk < FWD_BC / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = hop::pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    hop::mbar_wait(v_full + 8 * s, (i / FWD_STAGES) & 1);
    hop::wgmma_fence();
    hop::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < FWD_BC / 16; ++kk)
      hop::wgmma_rs<D>(acc, pa[kk], hop::mnmajor<D, FWD_BC>(sV, kk), 1);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(acc);
    hop::fence_regs(pa);
    hop::mbar_arrive(empty + 8 * s);
  }

  // Epilogue (trouble spot 1): l == 0 divides by 1, so a fully masked row
  // gives o = 0 with m = -inf and l = 0.
  const long long off = base_offset(g, y);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[r] >= T) continue;
    const float denom = (l == 0.f) ? 1.f : l;
    bf16* dst = o + off + (long long)row[r] * g.st + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / denom, acc[4 * j + 2 * r + 1] / denom);
    if (lane % 4 == 0) {
      m_out[(long long)y * T + row[r]] = m_i[r];
      l_out[(long long)y * T + row[r]] = l;
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
// dK/dV: one block per (128-key tile, batch*head); walks q tiles of 64.
// Warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64) and works on the
// transposed scores S^T = K . Q^T, so P^T and dS^T, in registers, are the
// A operands of dV += P^T . dO and dK += dS^T . Q.  The same Q and dO
// tiles serve as K-major B (in S^T and dP^T) and MN-major B (in dK, dV).
// ---------------------------------------------------------------------------

// Per q tile and stage, beside Q, dO and O: the producer's row statistics.
struct DkvStats {
  float mlog2[DKV_BQ];  // log2 of exp(safe_m) * denom: p = 2^(s log2e - this)
  float di[DKV_BQ];     // rowsum(dO * O), O the stored bf16 o
  int seg[DKV_BQ];      // q-side segment ids (0 without segments)
};
static_assert(sizeof(DkvStats) <= 1024, "the statistics fit their slot");

template <int D>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return 3 * DKV_BQ * D * 2 + 1024;  // Q, dO, O, statistics
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 1024 + 2 * DKV_BK * D * 2 + DKV_STAGES * dkv_stage_bytes<D>() +
         8 * (1 + 3 * DKV_STAGES);
}

template <int D>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_o,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, Geometry g, int causal,
                         float scale) {
  constexpr int KV_BYTES = DKV_BK * D * 2;
  constexpr int QT_BYTES = DKV_BQ * D * 2;
  constexpr int STAGE = dkv_stage_bytes<D>();
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = smem_base(smem_raw);
  const uint32_t sK = sm.addr, sV = sK + KV_BYTES;
  const uint32_t sStage = sV + KV_BYTES;  // stage s: Q, dO, O, statistics
  // Barriers: K/V loaded; per stage, its tiles loaded (TMA), its
  // statistics written (the producer warpgroup), and freed (consumers).
  const uint32_t kv_full = sStage + DKV_STAGES * STAGE;
  const uint32_t loaded = kv_full + 8, full = loaded + 8 * DKV_STAGES;
  const uint32_t empty = full + 8 * DKV_STAGES;
  auto generic = [&](uint32_t addr) { return sm.ptr + (addr - sm.addr); };
  auto stats = [&](int s) {
    return reinterpret_cast<DkvStats*>(
        generic(sStage + s * STAGE + 3 * QT_BYTES));
  };

  // Under causal masking the first key tiles do the most work: they come
  // first (blockIdx.y = 0 for every batch*head).
  const int T = g.T, y = blockIdx.x, k0 = blockIdx.y * DKV_BK;
  const int q_first = dkv_first_q_tile(k0, causal);
  const int n_tiles = (T + DKV_BQ - 1) / DKV_BQ - q_first;
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;

  if (threadIdx.x == 0) {
    hop::mbar_init(kv_full, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      hop::mbar_init(loaded + 8 * s, 1);
      hop::mbar_init(full + 8 * s, DKV_THREADS - CONSUMERS);
      hop::mbar_init(empty + 8 * s, CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: gives its registers to the consumers; thread 0
    // issues the TMA loads, and all 128 threads compute the q tile's
    // statistics from the loaded tiles, two threads a row (trouble spot
    // 4: di from the stored bf16 o, upcast, summed in f32).
    hop::setmaxnreg_dec<40>();
    const int pt = threadIdx.x - CONSUMERS, rr = pt / 2, half = pt % 2;
    const int h = y % g.H, b = y / g.H;
    if (pt == 0) {
      hop::mbar_arrive_expect_tx(kv_full, 2 * KV_BYTES);
      hop::tma_tile<D, DKV_BK>(sK, &tm_k, kv_full, k0, h, b);
      hop::tma_tile<D, DKV_BK>(sV, &tm_v, kv_full, k0, h, b);
    }
    constexpr int HALF = D / 16;  // 16-byte chunks in half a row
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % DKV_STAGES, q0 = (q_first + i) * DKV_BQ;
      const int qr = q0 + rr;
      const uint32_t parity = (i / DKV_STAGES) & 1;
      const uint32_t sQ = sStage + s * STAGE, sdO = sQ + QT_BYTES;
      const uint32_t sO = sdO + QT_BYTES;
      float m = -INFINITY, l = 0.f;
      int seg = 0;
      if (half == 0 && qr < T) {
        m = m_in[(long long)y * T + qr];
        l = l_in[(long long)y * T + qr];
        if (qs) seg = qs[qr];
      }
      hop::mbar_wait(empty + 8 * s, parity ^ 1);
      if (pt == 0) {
        hop::mbar_arrive_expect_tx(loaded + 8 * s, 3 * QT_BYTES);
        hop::tma_tile<D, DKV_BQ>(sQ, &tm_q, loaded + 8 * s, q0, h, b);
        hop::tma_tile<D, DKV_BQ>(sdO, &tm_do, loaded + 8 * s, q0, h, b);
        hop::tma_tile<D, DKV_BQ>(sO, &tm_o, loaded + 8 * s, q0, h, b);
      }
      hop::mbar_wait(loaded + 8 * s, parity);
      // Rows past T were loaded as zeros: di = 0 there.
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const int c = half * HALF + j;
        const uint4 x = *reinterpret_cast<const uint4*>(
            generic(hop::chunk_addr<D, DKV_BQ>(sdO, rr, c)));
        const uint4 w = *reinterpret_cast<const uint4*>(
            generic(hop::chunk_addr<D, DKV_BQ>(sO, rr, c)));
        const bf16* px = reinterpret_cast<const bf16*>(&x);
        const bf16* pw = reinterpret_cast<const bf16*>(&w);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          part += __bfloat162float(px[e]) * __bfloat162float(pw[e]);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      if (half == 0) {
        DkvStats* st = stats(s);
        const float safe_m = (m == -INFINITY) ? 0.f : m;
        const float denom = (l == 0.f) ? 1.f : l;
        st->mlog2[rr] = safe_m * LOG2E + log2f(denom);
        st->di[rr] = part;
        st->seg[rr] = seg;
      }
      hop::mbar_arrive(full + 8 * s);
    }
    return;
  }

  hop::setmaxnreg_inc<232>();
  // Consumers: this thread holds keys key[0] and key[1] = key[0] + 8 of
  // the warpgroup's 64 (rows of S^T, dK and dV).
  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int k_first = k0 + wg * 64;
  int key[2], key_seg[2];
  key[0] = k_first + warp * 16 + lane / 4;
  key[1] = key[0] + 8;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_seg[r] = (ks && key[r] < T) ? ks[key[r]] : 0;

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  hop::mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % DKV_STAGES, q0 = (q_first + i) * DKV_BQ;
    const uint32_t sQ = sStage + s * STAGE, sdO = sQ + QT_BYTES;
    hop::mbar_wait(loaded + 8 * s, (i / DKV_STAGES) & 1);
    hop::mbar_wait(full + 8 * s, (i / DKV_STAGES) & 1);
    // Under causal masking a q tile wholly before this warpgroup's keys
    // has nothing for it (the block's first tile, for warpgroup 1).
    if (!causal || q0 + DKV_BQ - 1 >= k_first) {
      const DkvStats* st = stats(s);
      float sT[DKV_BQ / 2], dpT[DKV_BQ / 2];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::wgmma_ss<DKV_BQ>(sT, hop::kmajor<D, DKV_BK>(sK, wg * 64, kk),
                              hop::kmajor<D, DKV_BQ>(sQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::wgmma_ss<DKV_BQ>(dpT, hop::kmajor<D, DKV_BK>(sV, wg * 64, kk),
                              hop::kmajor<D, DKV_BQ>(sdO, 0, kk), kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(sT);
      hop::fence_regs(dpT);

      // P^T = exp(S^T scale - m) / l and dS^T = P^T (dP^T - di), with
      // the mask (trouble spots 1-3) where the tile needs one.
      const bool need_mask = q0 + DKV_BQ > T || k_first + 64 > T ||
                             qs != nullptr ||
                             (causal && q0 < k_first + 63);
#pragma unroll
      for (int j = 0; j < DKV_BQ / 2; ++j) {
        const int r = (j / 2) % 2;
        const int qc = 8 * (j / 4) + 2 * (lane % 4) + j % 2;
        float p = exp2f(fmaf(sT[j] * scale, LOG2E, -st->mlog2[qc]));
        if (need_mask) {
          const int qr = q0 + qc;
          const bool ok = qr < T && key[r] < T && (!causal || qr >= key[r]) &&
                          (!qs || st->seg[qc] == key_seg[r]);
          if (!ok) p = 0.f;
        }
        sT[j] = p;
        dpT[j] = p * (dpT[j] - st->di[qc]);
      }
      uint32_t pa[DKV_BQ / 16][4], da[DKV_BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = hop::pack_bf16(sT[8 * kk + 2 * e], sT[8 * kk + 2 * e + 1]);
          da[kk][e] =
              hop::pack_bf16(dpT[8 * kk + 2 * e], dpT[8 * kk + 2 * e + 1]);
        }
      hop::wgmma_fence();
      hop::fence_regs(acc_dv);
      hop::fence_regs(acc_dk);
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        hop::wgmma_rs<D>(acc_dv, pa[kk], hop::mnmajor<D, DKV_BQ>(sdO, kk), 1);
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        hop::wgmma_rs<D>(acc_dk, da[kk], hop::mnmajor<D, DKV_BQ>(sQ, kk), 1);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(acc_dv);
      hop::fence_regs(acc_dk);
      hop::fence_regs(pa);
      hop::fence_regs(da);
    }
    hop::mbar_arrive(empty + 8 * s);
  }

  // The scale multiplies dK after its products (trouble spot 3).
  const long long off = base_offset(g, y);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= T) continue;
    const long long at = off + (long long)key[r] * g.st + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + 8 * j) =
          __floats2bfloat162_rn(acc_dk[4 * j + 2 * r] * scale,
                                acc_dk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + 8 * j) =
          __floats2bfloat162_rn(acc_dv[4 * j + 2 * r],
                                acc_dv[4 * j + 2 * r + 1]);
    }
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

// cuTensorMapEncodeTiled lives in libcuda; the runtime hands out its
// address, so the library links no -lcuda.
PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A 4-D map (d, t, h, b) over one operand, boxes of [rows, BOX] with the
// head dim's swizzle; rows past T read as zeros.  The folded [B*H, T, D]
// layout is H = 1 (its head stride is never stepped: any legal value).
template <int D>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int BH,
                     const Geometry& g, int rows) {
  auto encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  using S = hop::Swizzle<D>;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)g.T, (cuuint64_t)g.H,
                        (cuuint64_t)(BH / g.H)};
  cuuint64_t strides[3] = {(cuuint64_t)g.st * 2,
                           (cuuint64_t)(g.H == 1 ? g.sb : g.sh) * 2,
                           (cuuint64_t)g.sb * 2};
  cuuint32_t box[4] = {(cuuint32_t)S::BOX, (cuuint32_t)rows, 1, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                      const_cast<void*>(ptr), dims, strides, box, step,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, S::TMA,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* m, void* l, const void* qseg, const void* kseg,
                       int BH, const Geometry& g, int causal, float scale,
                       cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_map<D>(&tq, q, BH, g, FWD_BR);
  if (err == cudaSuccess) err = make_map<D>(&tk, k, BH, g, FWD_BC);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, BH, g, FWD_BC);
  constexpr int smem = fwd_smem_bytes<D>();
  if (err == cudaSuccess) err = prepare(flash_fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + FWD_BR - 1) / FWD_BR);
  flash_fwd_kernel<D><<<grid, FWD_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), g, causal, scale);
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
  CUtensorMap tq, tk, tv, tdo, to;
  cudaError_t err = make_map<D>(&tq, q, BH, g, DKV_BQ);
  if (err == cudaSuccess) err = make_map<D>(&tk, k, BH, g, DKV_BK);
  if (err == cudaSuccess) err = make_map<D>(&tv, v, BH, g, DKV_BK);
  if (err == cudaSuccess) err = make_map<D>(&tdo, dout, BH, g, DKV_BQ);
  if (err == cudaSuccess) err = make_map<D>(&to, o, BH, g, DKV_BQ);
  constexpr int smem = dkv_smem_bytes<D>();
  if (err == cudaSuccess) err = prepare(flash_bwd_dkv_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + DKV_BK - 1) / DKV_BK);
  flash_bwd_dkv_kernel<D><<<grid, DKV_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, to, static_cast<const float*>(m),
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
