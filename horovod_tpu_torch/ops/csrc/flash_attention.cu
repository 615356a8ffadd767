// Flash attention for Hopper: the forward, dQ and dK/dV kernels, bf16 or
// f16 in (one instance of each kernel per element type and head dim up to
// 256, and one per element type for every head dim above), f32 softmax
// state and accumulation.  f32 operands take the kernels of
// flash_attention_f32.cu.
//
// Replaces the three TPU kernels of horovod_tpu/ops/flash_attention.py:
//   _fwd_kernel     (:108), launched by _fwd_parts (:330) -> flash_fwd_kernel
//   _bwd_dq_kernel  (:173), launched by _bwd_parts (:399) -> flash_bwd_dq_kernel
//   _bwd_dkv_kernel (:226), launched by _bwd_parts        -> flash_bwd_dkv_kernel
// and, at head dims above 256 (the reference takes any), the wide
// instances flash_fwd_wide_kernel, flash_bwd_dq_wide_kernel and
// flash_bwd_dkv_wide_kernel.
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
// All three kernels share one Hopper design (flash_hopper.cuh for the
// PTX).  The full tensor-core rate needs wgmma, whose operands come from
// shared memory (or A from registers) and whose sums stay in registers;
// round trips of S and O through shared memory and register-staged tile
// loads leave a kernel waiting on memory.  So:
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
//   threads; at D = 256 a warpgroup, see below).
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
// * dQ, per 128-row q tile: Q, dO and O once, then K and V tiles of 64
//   keys through three stages (K and V on separate barriers).  A producer
//   warpgroup loads them and computes each row's di (from the loaded O),
//   m and l into shared memory once, then gives its registers to the
//   consumers.  Per key tile, S = Q.K^T and dP = dO.V^T by wgmma into
//   registers; P = exp(S scale - m) / l (one exp2) and dS = P (dP - di)
//   in registers, rounded to bf16 as the register A operand of dQ +=
//   dS.K, the same K tile read MN-major.  dQ (64 x D f32 per warpgroup)
//   stays in registers over the whole key loop; the epilogue stages it
//   through shared memory for 16-byte stores.  64-key tiles keep S, dP,
//   dS and dQ in registers together (144 a thread at D = 128).
// * Head dim 256 (Tiles<256>): the tiles above do not fit the 232,448
//   bytes a block may hold (the forward's would take 459,856), so the
//   forward walks key tiles of 64 through two stages (197,688 B; O is 64 x
//   256 f32 a warpgroup, 128 registers a thread, beside S's 32, so its
//   producer is a warpgroup that gives its registers away); dQ keeps
//   Q and dO resident but not O (the producer reads each row of O from
//   device memory for di), with key tiles of 32 through two stages
//   (199,744 B); and dK/dV, whose two accumulators would take 256
//   registers a thread, splits the outputs' head dim over two blocks per
//   key tile (blockIdx.z): each block computes S^T and dP^T over the whole
//   head dim and accumulates its 128 columns of dK and dV (1.5x the
//   products; 128 registers a thread, as at D = 128), through one stage
//   (231,456 B).  Sums keep a fixed order; there are no atomics.  P . V at
//   D = 256 is two wgmma products of 128 columns.
// * Head dims above 256 (the wide instances, D a multiple of 256 given at
//   run time, so one instance per element type takes them all): no tile
//   holds a whole row, so S and dP (or S^T and dP^T) accumulate in
//   registers over chunks of 64 columns that the producer streams by TMA
//   through a ring of chunk stages, and the outputs' columns split over
//   blocks (blockIdx.z: 256 of O or dQ, 128 of dK and dV), each reading
//   its columns of V, K, or Q and dO from a column stage.  The tiles and
//   the warp roles are those of D = 256: forward key tiles of 64 (six
//   chunk stages, 214,144 B), dQ key tiles of 32 (four, 199,784 B; di
//   from device memory), dK/dV q tiles of 64 (three, 216,160 B; di from
//   device memory by two producer warps), whatever D.  See the wide
//   section below.
// * Tiles are [rows, D] in TMA's swizzled layout (flash_hopper.cuh); the
//   maps address [B, T, H, D] in place as a 4-D (d, t, h, b) tensor, and
//   the folded [B*H, T, D] layout of _fwd_parts as H = 1.  m and l are
//   [B*H, T] f32 with row b*H + h, as the reference folds them.
//
// Where the reference is delicate, and what this file does about it:
// 1. -inf arithmetic (reference :138-145, :196-207, :252-261).  A masked
//    score is -inf.  exp(-inf - (-inf)) is NaN in CUDA, so every guard is
//    mirrored: safe_m = (m == -inf) ? 0 : m; p = (s == -inf) ? 0 :
//    exp(s - safe_m); corr = (m_old == -inf) ? 0 : exp(m_old - safe_m);
//    denom = (l == 0) ? 1 : l.  A fully masked row gives o = 0, l = 0 and
//    zero dQ, with dK and dV finite.
// 2. Causal block skipping, re-derived for each tiling: the forward's q
//    tile at q0 (128 rows) visits key tiles k0 < min(T, q0 + 128), and
//    so does dQ's (key tiles of 64), where a warpgroup skips the products
//    of a key tile that lies wholly after its 64 rows; dK/dV's key tile
//    at k0 (128 keys) visits q tiles of 64 from floor(k0 / 64) on, and a
//    warpgroup skips a q tile that lies wholly before its 64 keys.
//    Entries inside a visited tile are masked by q >= k.
// 3. Tails: TMA reads rows past T as zeros (T = 40, 64 or 192 leave a
//    tile partly empty), and keys and queries past T are still masked by
//    index; rows past T are not written.  The scale multiplies s after
//    the Q.K product, and dQ and dK after their products; q is not
//    pre-scaled.
// 4. di = rowsum(dO * O) comes from the stored bf16 or f16 o, upcast,
//    summed in f32, in both backward kernels.
// 5. NaN propagates: the row max is NaN-propagating (jnp.max is; fmaxf is
//    not), so a NaN input poisons its rows as in the reference.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using f16 = __half;

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

// ---------------------------------------------------------------------------
// Shared pieces
// ---------------------------------------------------------------------------

// Two consumer warpgroups of 128 threads and a producer: one warp in the
// forward (a warpgroup at D = 256); in dQ and dK/dV a whole warpgroup, so that setmaxnreg can move
// its registers to the consumers (dK and dV alone take 128 a thread; dQ,
// S, dP and dS 144).
constexpr int CONSUMERS = 256;
constexpr int DQ_THREADS = CONSUMERS + 128;
constexpr int DKV_THREADS = CONSUMERS + 128;
constexpr float LOG2E = 1.4426950408889634f;

// Forward tiles: 128 q rows per block (64 per consumer warpgroup), key
// tiles of 128 through a ring of three stages (225 KB at D = 128).
constexpr int FWD_BR = 128;
// dQ tiles: 128 q rows per block (64 per consumer warpgroup), key tiles
// of 64 through a ring of three stages (196 KB at D = 128).
constexpr int DQ_BR = 128;
// dK/dV tiles: 128 keys per block (64 per consumer warpgroup), q tiles of
// 64 through a ring of three stages.
constexpr int DKV_BK = 128;
constexpr int DKV_BQ = 64;
// The opt-in shared memory of one block.
constexpr int SMEM_LIMIT = 232448;

// What varies with the head dim (see the head of the file for D = 256).
template <int D>
struct Tiles {
  static constexpr bool WIDE = D > 128;
  static constexpr int FWD_BC = WIDE ? 64 : 128;
  // At D = 256 the forward's producer is a warpgroup, so that setmaxnreg
  // can give its registers to the consumers (O alone takes 128 a thread):
  // with one producer warp the 288 threads get 168 registers each.
  static constexpr int FWD_THREADS = WIDE ? CONSUMERS + 128 : CONSUMERS + 32;
  static constexpr int FWD_STAGES = WIDE ? 2 : 3;
  static constexpr int DQ_BC = WIDE ? 32 : 64;
  static constexpr int DQ_STAGES = WIDE ? 2 : 3;
  static constexpr bool DQ_O_TILE = !WIDE;  // O resident in dQ's smem
  static constexpr int DKV_STAGES = WIDE ? 1 : 3;
  static constexpr int DKV_COLS = WIDE ? 128 : D;  // dK/dV columns a block
};

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
// q0 visits key tiles of BC up to its last row, k0 < min(T, q0 + FWD_BR).
template <int BC>
__device__ __forceinline__ int fwd_key_tiles(int q0, int T, int causal) {
  const int kend = causal ? min(T, q0 + FWD_BR) : T;
  return (kend + BC - 1) / BC;
}

// dQ: the q tile at q0 visits key tiles of BC up to its last row.
template <int BC>
__device__ __forceinline__ int dq_key_tiles(int q0, int T, int causal) {
  const int kend = causal ? min(T, q0 + DQ_BR) : T;
  return (kend + BC - 1) / BC;
}

// dK/dV: the key tile at k0 visits q tiles from the first one holding a
// row q >= k0.
__device__ __forceinline__ int dkv_first_q_tile(int k0, int causal) {
  return causal ? k0 / DKV_BQ : 0;
}

// The producer warpgroup's per-row statistics of a q tile of ROWS rows,
// beside its Q, dO and O tiles (dQ and dK/dV).
template <int ROWS>
struct RowStats {
  float mlog2[ROWS];  // log2(exp(safe_m) * denom): p = 2^(s log2e - this)
  float di[ROWS];     // rowsum(dO * O), O the stored o
  int seg[ROWS];      // q-side segment ids (0 without segments)
};

// The partial di of one 16-byte chunk each of dO and O (8 elements).
template <typename E>
__device__ __forceinline__ float chunk_dot(uint4 x, uint4 w, float part) {
  const E* px = reinterpret_cast<const E*>(&x);
  const E* pw = reinterpret_cast<const E*>(&w);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    part += hop::Elem<E>::to_float(px[e]) * hop::Elem<E>::to_float(pw[e]);
  return part;
}

// di of row rr of an R-row tile pair (dO, O) in shared memory (generic
// pointers to the 1024-aligned tiles), two threads a row: `half` sums its
// half of the row and the pair adds by a shuffle (trouble spot 4: the
// stored o, upcast, summed in f32).  Rows past T were loaded as zeros:
// di = 0.
template <int D, int R, typename E>
__device__ __forceinline__ float row_di(const unsigned char* tile_do,
                                        const unsigned char* tile_o, int rr,
                                        int half) {
  constexpr int HALF = D / 16;  // 16-byte chunks in half a row
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < HALF; ++j) {
    const uint32_t at = hop::chunk_addr<D, R>(0u, rr, half * HALF + j);
    part = chunk_dot<E>(*reinterpret_cast<const uint4*>(tile_do + at),
                        *reinterpret_cast<const uint4*>(tile_o + at), part);
  }
  return part + __shfl_xor_sync(0xffffffffu, part, 1);
}

// The same with O's row read from device memory (o_row, null past T: di =
// 0), for the tilings that keep no O tile.
template <int D, int R, typename E>
__device__ __forceinline__ float row_di_global(const unsigned char* tile_do,
                                               const E* o_row, int rr,
                                               int half) {
  constexpr int HALF = D / 16;
  float part = 0.f;
  if (o_row != nullptr) {
#pragma unroll 4
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + j;
      const uint32_t at = hop::chunk_addr<D, R>(0u, rr, c);
      part = chunk_dot<E>(*reinterpret_cast<const uint4*>(tile_do + at),
                          *reinterpret_cast<const uint4*>(o_row + 8 * c),
                          part);
    }
  }
  return part + __shfl_xor_sync(0xffffffffu, part, 1);
}

// acc (64 x N f32) += A . B: A 16 rows of the reduction in registers (the
// accumulator layout, packed by Elem<E>::pack), B rows [16 kk, 16 kk + 16)
// and columns [c0, c0 + N) of an R-row tile of head dim D, MN-major.  N =
// 256 is two products of 128 columns.
template <int D, int R, int N, typename E>
__device__ __forceinline__ void mma_rs(float (&acc)[N / 2],
                                       const uint32_t (&a)[4], uint32_t tile,
                                       int c0, int kk) {
  using S = hop::Swizzle<D>;
  constexpr int NN = N > 128 ? 128 : N;
#pragma unroll
  for (int h = 0; h < N / NN; ++h) {
    const uint32_t at = tile + ((c0 + h * NN) / S::BOX) * R * S::W;
    hop::wgmma_rs<NN, E>(*reinterpret_cast<float(*)[NN / 2]>(acc + h * NN / 2),
                         a, hop::mnmajor<D, R>(at, kk), 1);
  }
}

// Two f32 values rounded to E, stored at p (4-byte aligned).
template <typename E>
__device__ __forceinline__ void store2(E* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = hop::Elem<E>::pack(lo, hi);
}

// ---------------------------------------------------------------------------
// Forward: one block per (128-row q tile, batch*head).
// ---------------------------------------------------------------------------

template <int D>
constexpr int fwd_smem_bytes() {
  return 1024 + FWD_BR * D * 2 +
         Tiles<D>::FWD_STAGES * 2 * Tiles<D>::FWD_BC * D * 2 +
         8 * (1 + 3 * Tiles<D>::FWD_STAGES);
}

template <int D, typename E>
__global__ void __launch_bounds__(Tiles<D>::FWD_THREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     E* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out,
                     const int* __restrict__ qseg,
                     const int* __restrict__ kseg, Geometry g, int causal,
                     float scale) {
  constexpr int FWD_BC = Tiles<D>::FWD_BC;
  constexpr int FWD_STAGES = Tiles<D>::FWD_STAGES;
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
  const int n_tiles = fwd_key_tiles<FWD_BC>(q0, T, causal);

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
    if constexpr (Tiles<D>::WIDE) hop::setmaxnreg_dec<40>();
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

  if constexpr (Tiles<D>::WIDE) hop::setmaxnreg_inc<232>();
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
      hop::wgmma_ss<FWD_BC, E>(sc, hop::kmajor<D, FWD_BR>(sQ, wg * 64, kk),
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

    // O += P . V, P rounded to E as the register A operand (its
    // accumulator layout is the A layout of 16-column slices).
    uint32_t pa[FWD_BC / 16][4];
#pragma unroll
    for (int kk = 0; kk < FWD_BC / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] =
            hop::Elem<E>::pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    hop::mbar_wait(v_full + 8 * s, (i / FWD_STAGES) & 1);
    hop::wgmma_fence();
    hop::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < FWD_BC / 16; ++kk)
      mma_rs<D, FWD_BC, D, E>(acc, pa[kk], sV, 0, kk);
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
    E* dst = o + off + (long long)row[r] * g.st + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(dst + 8 * j, acc[4 * j + 2 * r] / denom,
             acc[4 * j + 2 * r + 1] / denom);
    if (lane % 4 == 0) {
      m_out[(long long)y * T + row[r]] = m_i[r];
      l_out[(long long)y * T + row[r]] = l;
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (128-row q tile, batch*head); walks key tiles of 64.
// Warpgroup wg owns q rows [q0 + 64 wg, q0 + 64 wg + 64).
// ---------------------------------------------------------------------------

using DqStats = RowStats<DQ_BR>;
static_assert(sizeof(DqStats) <= 2048, "the statistics fit their slot");

template <int D>
constexpr int dq_smem_bytes() {
  return 1024 + (Tiles<D>::DQ_O_TILE ? 3 : 2) * DQ_BR * D * 2 + 2048 +
         Tiles<D>::DQ_STAGES * 2 * Tiles<D>::DQ_BC * D * 2 +
         8 * (2 + 3 * Tiles<D>::DQ_STAGES);
}

template <int D, typename E>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_o,
                        const float* __restrict__ m_in,
                        const float* __restrict__ l_in,
                        const int* __restrict__ qseg,
                        const int* __restrict__ kseg,
                        const E* __restrict__ o_glob, E* __restrict__ dq,
                        Geometry g, int causal, float scale) {
  constexpr int DQ_BC = Tiles<D>::DQ_BC;
  constexpr int DQ_STAGES = Tiles<D>::DQ_STAGES;
  constexpr bool O_TILE = Tiles<D>::DQ_O_TILE;
  constexpr int Q_BYTES = DQ_BR * D * 2;
  constexpr int KV_BYTES = DQ_BC * D * 2;
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = smem_base(smem_raw);
  // Without an O tile (D = 256) sO aliases the statistics' slot and is
  // never read as a tile.
  const uint32_t sQ = sm.addr, sdO = sQ + Q_BYTES, sO = sdO + Q_BYTES;
  const uint32_t sStats = sO + (O_TILE ? Q_BYTES : 0);
  const uint32_t sKV = sStats + 2048;  // stage s: K at + 2 s KV, V after it
  // Barriers: Q, dO and O loaded; the statistics written (the producer
  // warpgroup); per stage, K loaded, V loaded and freed by the consumers.
  const uint32_t q_full = sKV + DQ_STAGES * 2 * KV_BYTES;
  const uint32_t stats_full = q_full + 8, k_full = stats_full + 8;
  const uint32_t v_full = k_full + 8 * DQ_STAGES;
  const uint32_t empty = v_full + 8 * DQ_STAGES;
  auto generic = [&](uint32_t addr) { return sm.ptr + (addr - sm.addr); };
  DqStats* const stats = reinterpret_cast<DqStats*>(generic(sStats));

  // The last q tiles do the most work under causal masking: blockIdx.y = 0
  // takes the last tile of every batch*head, as in the forward.
  const int T = g.T, y = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BR;
  const int n_tiles = dq_key_tiles<DQ_BC>(q0, T, causal);
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;

  if (threadIdx.x == 0) {
    hop::mbar_init(q_full, 1);
    hop::mbar_init(stats_full, DQ_THREADS - CONSUMERS);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hop::mbar_init(k_full + 8 * s, 1);
      hop::mbar_init(v_full + 8 * s, 1);
      hop::mbar_init(empty + 8 * s, CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: gives its registers to the consumers (56 left
    // a thread: 40 spill the statistics loop; 224 cover the consumers);
    // thread 0 issues the TMA loads, and all 128 threads compute the q
    // tile's statistics from the loaded tiles.
    hop::setmaxnreg_dec<56>();
    const int pt = threadIdx.x - CONSUMERS, half = pt % 2;
    const int h = y % g.H, b = y / g.H;
    auto load_kv = [&](int i) {
      const int s = i % DQ_STAGES;
      hop::mbar_wait(empty + 8 * s, ((i / DQ_STAGES) & 1) ^ 1);
      const uint32_t sK = sKV + s * 2 * KV_BYTES;
      hop::mbar_arrive_expect_tx(k_full + 8 * s, KV_BYTES);
      hop::tma_tile<D, DQ_BC>(sK, &tm_k, k_full + 8 * s, i * DQ_BC, h, b);
      hop::mbar_arrive_expect_tx(v_full + 8 * s, KV_BYTES);
      hop::tma_tile<D, DQ_BC>(sK + KV_BYTES, &tm_v, v_full + 8 * s,
                              i * DQ_BC, h, b);
    };
    // The first stages need no free slot, so they go out before the
    // statistics, and the rest of the ring after them.
    const int first = min(n_tiles, DQ_STAGES);
    if (pt == 0) {
      hop::mbar_arrive_expect_tx(q_full, (O_TILE ? 3 : 2) * Q_BYTES);
      hop::tma_tile<D, DQ_BR>(sQ, &tm_q, q_full, q0, h, b);
      hop::tma_tile<D, DQ_BR>(sdO, &tm_do, q_full, q0, h, b);
      if constexpr (O_TILE)
        hop::tma_tile<D, DQ_BR>(sO, &tm_o, q_full, q0, h, b);
      for (int i = 0; i < first; ++i) load_kv(i);
    }
    hop::mbar_wait(q_full, 0);
    const long long o_off = base_offset(g, y);
    for (int rr = pt / 2; rr < DQ_BR; rr += (DQ_THREADS - CONSUMERS) / 2) {
      const int qr = q0 + rr;
      float di;
      if constexpr (O_TILE) {
        di = row_di<D, DQ_BR, E>(generic(sdO), generic(sO), rr, half);
      } else {
        di = row_di_global<D, DQ_BR, E>(
            generic(sdO), qr < T ? o_glob + o_off + (long long)qr * g.st
                                 : nullptr,
            rr, half);
      }
      if (half == 0) {
        float m = -INFINITY, l = 0.f;
        int seg = 0;
        if (qr < T) {
          m = m_in[(long long)y * T + qr];
          l = l_in[(long long)y * T + qr];
          if (qs) seg = qs[qr];
        }
        const float safe_m = (m == -INFINITY) ? 0.f : m;
        const float denom = (l == 0.f) ? 1.f : l;
        stats->mlog2[rr] = safe_m * LOG2E + log2f(denom);
        stats->di[rr] = di;
        stats->seg[rr] = seg;
      }
    }
    hop::mbar_arrive(stats_full);
    if (pt == 0)
      for (int i = first; i < n_tiles; ++i) load_kv(i);
    return;
  }

  hop::setmaxnreg_inc<224>();
  // Consumers: this thread holds rows row[0] and row[1] = row[0] + 8 of the
  // warpgroup's 64 (rows of S, dP and dQ).
  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int r_first = q0 + wg * 64;
  int row[2];
  row[0] = r_first + warp * 16 + lane / 4;
  row[1] = row[0] + 8;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hop::mbar_wait(stats_full, 0);
  float mlog2[2], di[2];
  int my_seg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mlog2[r] = stats->mlog2[row[r] - q0];
    di[r] = stats->di[row[r] - q0];
    my_seg[r] = stats->seg[row[r] - q0];
  }
  const float scale_log2 = scale * LOG2E;

  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % DQ_STAGES, k0 = i * DQ_BC;
    const uint32_t parity = (i / DQ_STAGES) & 1;
    const uint32_t sK = sKV + s * 2 * KV_BYTES, sV = sK + KV_BYTES;
    // Wait for K even when skipping: the stage's earlier use is then over,
    // so this arrival on `empty` counts towards this tile's phase.
    hop::mbar_wait(k_full + 8 * s, parity);
    // Under causal masking a key tile wholly after this warpgroup's rows
    // has nothing for it (the block's last tile, for warpgroup 0).
    if (!causal || k0 <= r_first + 63) {
      // S = Q . K^T and dP = dO . V^T for this warpgroup's 64 rows.
      float sc[DQ_BC / 2], dp[DQ_BC / 2];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::wgmma_ss<DQ_BC, E>(sc, hop::kmajor<D, DQ_BR>(sQ, wg * 64, kk),
                                hop::kmajor<D, DQ_BC>(sK, 0, kk), kk > 0);
      hop::wgmma_commit();
      hop::mbar_wait(v_full + 8 * s, parity);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::wgmma_ss<DQ_BC, E>(dp, hop::kmajor<D, DQ_BR>(sdO, wg * 64, kk),
                                hop::kmajor<D, DQ_BC>(sV, 0, kk), kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(sc);
      hop::fence_regs(dp);

      // P = exp(S scale - m) / l and dS = P (dP - di), with the mask
      // (trouble spots 1-3) where the tile needs one.
      const bool need_mask = k0 + DQ_BC > T || ks != nullptr ||
                             (causal && k0 + DQ_BC - 1 > r_first);
#pragma unroll
      for (int j = 0; j < DQ_BC / 2; ++j) {
        const int r = (j / 2) % 2;
        float p = exp2f(fmaf(sc[j], scale_log2, -mlog2[r]));
        if (need_mask) {
          const int kc = k0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
          const bool ok = kc < T && (!causal || kc <= row[r]) &&
                          (!ks || ks[kc] == my_seg[r]);
          if (!ok) p = 0.f;
        }
        dp[j] = p * (dp[j] - di[r]);
      }
      // dQ += dS . K, dS rounded to E as the register A operand and K
      // read MN-major (the reduction runs over its rows, the keys).
      uint32_t da[DQ_BC / 16][4];
#pragma unroll
      for (int kk = 0; kk < DQ_BC / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          da[kk][e] =
              hop::Elem<E>::pack(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
      hop::wgmma_fence();
      hop::fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < DQ_BC / 16; ++kk)
        mma_rs<D, DQ_BC, D, E>(acc, da[kk], sK, 0, kk);
      hop::wgmma_commit();
      hop::wgmma_wait_all();
      hop::fence_regs(acc);
      hop::fence_regs(da);
    }
    hop::mbar_arrive(empty + 8 * s);
  }

  // Epilogue: the scale multiplies dQ after its products (trouble spot 3).
  const long long off = base_offset(g, y);
  if constexpr (!O_TILE) {
    // No O tile to stage through: each thread writes its pairs.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= T) continue;
      E* dst = dq + off + (long long)row[r] * g.st + 2 * (lane % 4);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store2(dst + 8 * j, acc[4 * j + 2 * r] * scale,
               acc[4 * j + 2 * r + 1] * scale);
    }
    return;
  }
  // Each warpgroup stages its 64 rows, rounded to E, in its half of the O
  // tile (free once the statistics are written) in the swizzled layout,
  // then writes whole 16-byte chunks of its rows below T.
  const uint32_t stage = sO + wg * 64 * D * 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lr = warp * 16 + lane / 4 + 8 * r;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(
          generic(hop::chunk_addr<D, 64>(stage, lr, j) + 4 * (lane % 4))) =
          hop::Elem<E>::pack(acc[4 * j + 2 * r] * scale,
                             acc[4 * j + 2 * r + 1] * scale);
  }
  hop::named_barrier(1 + wg, 128);
  constexpr int CHUNKS = D / 8;
#pragma unroll
  for (int idx = threadIdx.x % 128; idx < 64 * CHUNKS; idx += 128) {
    const int lr = idx / CHUNKS, c = idx % CHUNKS;
    if (r_first + lr >= T) continue;
    *reinterpret_cast<uint4*>(dq + off + (long long)(r_first + lr) * g.st +
                              8 * c) =
        *reinterpret_cast<const uint4*>(
            generic(hop::chunk_addr<D, 64>(stage, lr, c)));
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (128-key tile, batch*head, column half at D = 256);
// walks q tiles of 64.
// Warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64) and works on the
// transposed scores S^T = K . Q^T, so P^T and dS^T, in registers, are the
// A operands of dV += P^T . dO and dK += dS^T . Q.  The same Q and dO
// tiles serve as K-major B (in S^T and dP^T) and MN-major B (in dK, dV).
// ---------------------------------------------------------------------------

using DkvStats = RowStats<DKV_BQ>;
static_assert(sizeof(DkvStats) <= 1024, "the statistics fit their slot");

template <int D>
__host__ __device__ constexpr int dkv_stage_bytes() {
  return 3 * DKV_BQ * D * 2 + 1024;  // Q, dO, O, statistics
}

template <int D>
constexpr int dkv_smem_bytes() {
  return 1024 + 2 * DKV_BK * D * 2 +
         Tiles<D>::DKV_STAGES * dkv_stage_bytes<D>() +
         8 * (1 + 3 * Tiles<D>::DKV_STAGES);
}

template <int D, typename E>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const __grid_constant__ CUtensorMap tm_o,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const int* __restrict__ qseg,
                         const int* __restrict__ kseg, E* __restrict__ dk,
                         E* __restrict__ dv, Geometry g, int causal,
                         float scale) {
  constexpr int DKV_STAGES = Tiles<D>::DKV_STAGES;
  // This block's columns of dK and dV: [c0, c0 + COLS).
  constexpr int COLS = Tiles<D>::DKV_COLS;
  const int c0 = blockIdx.z * COLS;
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
      const float di =
          row_di<D, DKV_BQ, E>(generic(sdO), generic(sO), rr, half);
      if (half == 0) {
        DkvStats* st = stats(s);
        const float safe_m = (m == -INFINITY) ? 0.f : m;
        const float denom = (l == 0.f) ? 1.f : l;
        st->mlog2[rr] = safe_m * LOG2E + log2f(denom);
        st->di[rr] = di;
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

  float acc_dk[COLS / 2], acc_dv[COLS / 2];
#pragma unroll
  for (int i = 0; i < COLS / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

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
        hop::wgmma_ss<DKV_BQ, E>(sT, hop::kmajor<D, DKV_BK>(sK, wg * 64, kk),
                                 hop::kmajor<D, DKV_BQ>(sQ, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hop::wgmma_ss<DKV_BQ, E>(dpT, hop::kmajor<D, DKV_BK>(sV, wg * 64, kk),
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
          pa[kk][e] =
              hop::Elem<E>::pack(sT[8 * kk + 2 * e], sT[8 * kk + 2 * e + 1]);
          da[kk][e] =
              hop::Elem<E>::pack(dpT[8 * kk + 2 * e], dpT[8 * kk + 2 * e + 1]);
        }
      hop::wgmma_fence();
      hop::fence_regs(acc_dv);
      hop::fence_regs(acc_dk);
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        mma_rs<D, DKV_BQ, COLS, E>(acc_dv, pa[kk], sdO, c0, kk);
#pragma unroll
      for (int kk = 0; kk < DKV_BQ / 16; ++kk)
        mma_rs<D, DKV_BQ, COLS, E>(acc_dk, da[kk], sQ, c0, kk);
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
    const long long at =
        off + (long long)key[r] * g.st + c0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j) {
      store2(dk + at + 8 * j, acc_dk[4 * j + 2 * r] * scale,
             acc_dk[4 * j + 2 * r + 1] * scale);
      store2(dv + at + 8 * j, acc_dv[4 * j + 2 * r],
             acc_dv[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Head dims above 256: the wide instances (D a multiple of WIDE_COLS, any
// size; the wrapper pads the others).  No tile holds a whole row: the
// head-dim reductions (S = Q.K^T and dP = dO.V^T, or their transposes)
// accumulate in registers over chunks of WC columns that the producer
// streams by TMA through a ring of chunk stages, and the outputs' columns
// split over blocks (blockIdx.z), each computing the scores over the whole
// head dim and its own columns of O, dQ, or dK and dV from a column stage
// of their own ring.  Each block recomputes the scores: at D = 512 that is
// 1.5x the forward's products, 1.67x dQ's and 2.5x dK/dV's (four column
// blocks of 128).  The chunk stages refill while the consumers work, and a
// chunk's stage is freed as soon as the next chunk's products are issued
// (wgmma_wait<1>).  Shared memory (wide_*_smem_bytes): forward 214,144 B,
// dQ 199,784 B, dK/dV 216,160 B, whatever D.
// ---------------------------------------------------------------------------

constexpr int WC = 64;               // columns of a head-dim chunk (one box)
constexpr int WIDE_COLS = 256;       // O or dQ columns a forward or dQ block
constexpr int WIDE_DKV_COLS = 128;   // dK and dV columns a dK/dV block
constexpr int W_COL_STAGES = 2;      // column stages of every wide kernel
// Forward: key tiles of 64, six chunk stages of (Q, K) chunks.
constexpr int WF_BC = 64;
constexpr int WF_STAGES = 6;
constexpr int WF_Q = FWD_BR * WC * 2;           // a Q chunk, 16 KB
constexpr int WF_CHUNK = WF_Q + WF_BC * WC * 2;  // + a K chunk, 8 KB
constexpr int WF_V = WF_BC * WIDE_COLS * 2;     // V's columns, 32 KB
// dQ: key tiles of 32, four chunk stages of (Q, dO, K, V) chunks.
constexpr int WQ_BC = 32;
constexpr int WQ_STAGES = 4;
constexpr int WQ_Q = DQ_BR * WC * 2;                // a Q or dO chunk
constexpr int WQ_K = WQ_BC * WC * 2;                // a K or V chunk
constexpr int WQ_CHUNK = 2 * WQ_Q + 2 * WQ_K;       // 40 KB
constexpr int WQ_KCOLS = WQ_BC * WIDE_COLS * 2;     // K's columns, 16 KB
// dK/dV: q tiles of 64, three chunk stages of (K, V, Q, dO) chunks; a
// column stage holds Q's and dO's columns and the tile's statistics.
constexpr int WKV_STAGES = 3;
constexpr int WKV_K = DKV_BK * WC * 2;              // a K or V chunk
constexpr int WKV_Q = DKV_BQ * WC * 2;              // a Q or dO chunk
constexpr int WKV_CHUNK = 2 * WKV_K + 2 * WKV_Q;    // 48 KB
constexpr int WKV_QCOLS = DKV_BQ * WIDE_DKV_COLS * 2;  // Q's or dO's columns
constexpr int WKV_COL = 2 * WKV_QCOLS + 1024;       // + the statistics
// The producer's statistics threads in dK/dV: one a row of the q tile.
constexpr int WKV_STAT_THREADS = DKV_BQ;

// NB boxes [R, WC] of a wide map side by side in shared memory from dst,
// columns [c0, c0 + NB WC) of rows [t0, t0 + R).
template <int R, int NB>
__device__ __forceinline__ void tma_cols(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int t0, int h,
                                         int b) {
#pragma unroll
  for (int i = 0; i < NB; ++i)
    hop::tma_load_4d(dst + i * R * WC * 2, map, bar, c0 + i * WC, t0, h, b);
}

// di = rowsum(dO * O) of one row over the whole head dim, from device
// memory (trouble spot 4: the stored o, upcast, summed in f32).
template <typename E>
__device__ __forceinline__ float row_di_wide(const E* do_row, const E* o_row,
                                             int D) {
  float part = 0.f;
#pragma unroll 2
  for (int c = 0; c < D / 8; ++c)
    part = chunk_dot<E>(*reinterpret_cast<const uint4*>(do_row + 8 * c),
                        *reinterpret_cast<const uint4*>(o_row + 8 * c), part);
  return part;
}

// The four 16-deep steps of one chunk: acc (64 x N) += A . B^T, A rows
// [r0, r0 + 64) of an RA-row chunk, B an N-row chunk, both K-major.  The
// first step of the first chunk starts the sum (scale-d 0).
template <int RA, int N, typename E>
__device__ __forceinline__ void mma_chunk(float (&acc)[N / 2], uint32_t a,
                                          int r0, uint32_t b, int c) {
#pragma unroll
  for (int kk = 0; kk < WC / 16; ++kk)
    hop::wgmma_ss<N, E>(acc, hop::kmajor<WC, RA>(a, r0, kk),
                        hop::kmajor<WC, N>(b, 0, kk), c > 0 || kk > 0);
}

constexpr int wide_fwd_smem_bytes() {
  return 1024 + WF_STAGES * WF_CHUNK + W_COL_STAGES * WF_V +
         8 * 2 * (WF_STAGES + W_COL_STAGES);
}

// Forward: one block per (128-row q tile, batch*head, 256 columns of O).
template <typename E>
__global__ void __launch_bounds__(CONSUMERS + 128, 1)
    flash_fwd_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          E* __restrict__ o, float* __restrict__ m_out,
                          float* __restrict__ l_out,
                          const int* __restrict__ qseg,
                          const int* __restrict__ kseg, Geometry g, int D,
                          int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = smem_base(smem_raw);
  const uint32_t sChunk = sm.addr;  // stage s: Q chunk, then K chunk
  const uint32_t sV = sChunk + WF_STAGES * WF_CHUNK;
  // Barriers: per chunk stage and per column stage, loaded and freed.
  const uint32_t c_full = sV + W_COL_STAGES * WF_V;
  const uint32_t c_empty = c_full + 8 * WF_STAGES;
  const uint32_t v_full = c_empty + 8 * WF_STAGES;
  const uint32_t v_empty = v_full + 8 * W_COL_STAGES;

  const int T = g.T, y = blockIdx.x, c0 = blockIdx.z * WIDE_COLS;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FWD_BR;
  const int n_tiles = fwd_key_tiles<WF_BC>(q0, T, causal);
  const int nc = D / WC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WF_STAGES; ++s) {
      hop::mbar_init(c_full + 8 * s, 1);
      hop::mbar_init(c_empty + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < W_COL_STAGES; ++s) {
      hop::mbar_init(v_full + 8 * s, 1);
      hop::mbar_init(v_empty + 8 * s, CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: one thread streams, per key tile, the (Q, K)
    // chunks and then V's columns; the rest give their registers away.
    hop::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS) {
      const int h = y % g.H, b = y / g.H;
      int j = 0;
      for (int i = 0; i < n_tiles; ++i) {
        for (int c = 0; c < nc; ++c, ++j) {
          const int s = j % WF_STAGES;
          hop::mbar_wait(c_empty + 8 * s, ((j / WF_STAGES) & 1) ^ 1);
          const uint32_t dst = sChunk + s * WF_CHUNK;
          hop::mbar_arrive_expect_tx(c_full + 8 * s, WF_CHUNK);
          hop::tma_load_4d(dst, &tm_q, c_full + 8 * s, c * WC, q0, h, b);
          hop::tma_load_4d(dst + WF_Q, &tm_k, c_full + 8 * s, c * WC,
                           i * WF_BC, h, b);
        }
        const int s = i % W_COL_STAGES;
        hop::mbar_wait(v_empty + 8 * s, ((i / W_COL_STAGES) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(v_full + 8 * s, WF_V);
        tma_cols<WF_BC, WIDE_COLS / WC>(sV + s * WF_V, &tm_v, v_full + 8 * s,
                                        c0, i * WF_BC, h, b);
      }
    }
    return;
  }

  hop::setmaxnreg_inc<232>();
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

  float acc[WIDE_COLS / 2];
#pragma unroll
  for (int i = 0; i < WIDE_COLS / 2; ++i) acc[i] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY}, l_part[2] = {0.f, 0.f};

  int j = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * WF_BC;
    // S = Q . K^T over the chunks, each chunk's stage freed once the next
    // chunk's products are issued.
    float sc[WF_BC / 2];
    int prev = 0;
    for (int c = 0; c < nc; ++c, ++j) {
      const int s = j % WF_STAGES;
      hop::mbar_wait(c_full + 8 * s, (j / WF_STAGES) & 1);
      const uint32_t sQ = sChunk + s * WF_CHUNK;
      hop::wgmma_fence();
      mma_chunk<FWD_BR, WF_BC, E>(sc, sQ, wg * 64, sQ + WF_Q, c);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      if (c > 0) hop::mbar_arrive(c_empty + 8 * prev);
      prev = s;
    }
    hop::wgmma_wait_all();
    hop::fence_regs(sc);
    hop::mbar_arrive(c_empty + 8 * prev);

    // Scale, mask and the online softmax, as flash_fwd_kernel's.
    const bool need_mask = k0 + WF_BC > T || ks != nullptr ||
                           (causal && k0 + WF_BC - 1 > r_first);
#pragma unroll
    for (int jj = 0; jj < WF_BC / 2; ++jj) {
      sc[jj] *= scale;
      if (need_mask) {
        const int r = (jj / 2) % 2;
        const int kc = k0 + 8 * (jj / 4) + 2 * (lane % 4) + jj % 2;
        const bool ok = kc < T && (!causal || kc <= row[r]) &&
                        (!ks || ks[kc] == my_seg[r]);
        if (!ok) sc[jj] = -INFINITY;
      }
    }
    float corr[2], neg_m2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < WF_BC / 2; ++jj)
        if ((jj / 2) % 2 == r) mx = max_nan(mx, sc[jj]);
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
    for (int jj = 0; jj < WF_BC / 2; ++jj) {
      const int r = (jj / 2) % 2;
      const float p = (sc[jj] == -INFINITY)
                          ? 0.f
                          : exp2f(fmaf(sc[jj], LOG2E, neg_m2[r]));
      sum[r] += p;
      sc[jj] = p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_part[r] = l_part[r] * corr[r] + sum[r];
#pragma unroll
    for (int jj = 0; jj < WIDE_COLS / 2; ++jj) acc[jj] *= corr[(jj / 2) % 2];

    // O += P . V over this block's columns of V.
    uint32_t pa[WF_BC / 16][4];
#pragma unroll
    for (int kk = 0; kk < WF_BC / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] =
            hop::Elem<E>::pack(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    const int s = i % W_COL_STAGES;
    hop::mbar_wait(v_full + 8 * s, (i / W_COL_STAGES) & 1);
    hop::wgmma_fence();
    hop::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < WF_BC / 16; ++kk)
      mma_rs<WIDE_COLS, WF_BC, WIDE_COLS, E>(acc, pa[kk], sV + s * WF_V, 0,
                                             kk);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(acc);
    hop::fence_regs(pa);
    hop::mbar_arrive(v_empty + 8 * s);
  }

  // Epilogue (trouble spot 1); every column block computes the same m and
  // l, the first one writes them.
  const long long off = base_offset(g, y);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_part[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (row[r] >= T) continue;
    const float denom = (l == 0.f) ? 1.f : l;
    E* dst = o + off + (long long)row[r] * g.st + c0 + 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < WIDE_COLS / 8; ++jj)
      store2(dst + 8 * jj, acc[4 * jj + 2 * r] / denom,
             acc[4 * jj + 2 * r + 1] / denom);
    if (blockIdx.z == 0 && lane % 4 == 0) {
      m_out[(long long)y * T + row[r]] = m_i[r];
      l_out[(long long)y * T + row[r]] = l;
    }
  }
}

constexpr int wide_dq_smem_bytes() {
  return 1024 + 2048 + WQ_STAGES * WQ_CHUNK + W_COL_STAGES * WQ_KCOLS +
         8 * (1 + 2 * (WQ_STAGES + W_COL_STAGES));
}

// dQ: one block per (128-row q tile, batch*head, 256 columns of dQ).
template <typename E>
__global__ void __launch_bounds__(DQ_THREADS, 1)
    flash_bwd_dq_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const float* __restrict__ m_in,
                             const float* __restrict__ l_in,
                             const int* __restrict__ qseg,
                             const int* __restrict__ kseg,
                             const E* __restrict__ o_glob,
                             const E* __restrict__ do_glob,
                             E* __restrict__ dq, Geometry g, int D,
                             int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = smem_base(smem_raw);
  const uint32_t sStats = sm.addr;
  const uint32_t sChunk = sStats + 2048;  // stage s: Q, dO, K, V chunks
  const uint32_t sK = sChunk + WQ_STAGES * WQ_CHUNK;  // K's columns
  const uint32_t stats_full = sK + W_COL_STAGES * WQ_KCOLS;
  const uint32_t c_full = stats_full + 8, c_empty = c_full + 8 * WQ_STAGES;
  const uint32_t k_full = c_empty + 8 * WQ_STAGES;
  const uint32_t k_empty = k_full + 8 * W_COL_STAGES;
  DqStats* const stats = reinterpret_cast<DqStats*>(sm.ptr);

  const int T = g.T, y = blockIdx.x, c0 = blockIdx.z * WIDE_COLS;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_BR;
  const int n_tiles = dq_key_tiles<WQ_BC>(q0, T, causal);
  const int nc = D / WC;
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;

  if (threadIdx.x == 0) {
    hop::mbar_init(stats_full, DQ_THREADS - CONSUMERS);
    for (int s = 0; s < WQ_STAGES; ++s) {
      hop::mbar_init(c_full + 8 * s, 1);
      hop::mbar_init(c_empty + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < W_COL_STAGES; ++s) {
      hop::mbar_init(k_full + 8 * s, 1);
      hop::mbar_init(k_empty + 8 * s, CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: thread 0 streams, per key tile, the (Q, dO, K,
    // V) chunks and then K's columns; all 128 threads compute the q
    // tile's statistics, one row each, from device memory first.
    hop::setmaxnreg_dec<56>();
    const int pt = threadIdx.x - CONSUMERS;
    const int h = y % g.H, b = y / g.H;
    auto load_chunk = [&](int jj) {
      const int s = jj % WQ_STAGES, i = jj / nc, c = jj % nc;
      hop::mbar_wait(c_empty + 8 * s, ((jj / WQ_STAGES) & 1) ^ 1);
      const uint32_t dst = sChunk + s * WQ_CHUNK;
      const uint32_t bar = c_full + 8 * s;
      hop::mbar_arrive_expect_tx(bar, WQ_CHUNK);
      hop::tma_load_4d(dst, &tm_q, bar, c * WC, q0, h, b);
      hop::tma_load_4d(dst + WQ_Q, &tm_do, bar, c * WC, q0, h, b);
      hop::tma_load_4d(dst + 2 * WQ_Q, &tm_k, bar, c * WC, i * WQ_BC, h, b);
      hop::tma_load_4d(dst + 2 * WQ_Q + WQ_K, &tm_v, bar, c * WC, i * WQ_BC,
                       h, b);
    };
    // The first stages need no free slot: they go out before the
    // statistics, the rest after them.
    const int first = min(n_tiles * nc, min(nc, WQ_STAGES));
    if (pt == 0)
      for (int jj = 0; jj < first; ++jj) load_chunk(jj);
    {
      const int qr = q0 + pt;
      const long long at = base_offset(g, y) + (long long)qr * g.st;
      float m = -INFINITY, l = 0.f, di = 0.f;
      int seg = 0;
      if (qr < T) {
        m = m_in[(long long)y * T + qr];
        l = l_in[(long long)y * T + qr];
        if (qs) seg = qs[qr];
        di = row_di_wide<E>(do_glob + at, o_glob + at, D);
      }
      const float safe_m = (m == -INFINITY) ? 0.f : m;
      const float denom = (l == 0.f) ? 1.f : l;
      stats->mlog2[pt] = safe_m * LOG2E + log2f(denom);
      stats->di[pt] = di;
      stats->seg[pt] = seg;
    }
    hop::mbar_arrive(stats_full);
    if (pt == 0) {
      int jj = 0;
      for (int i = 0; i < n_tiles; ++i) {
        for (int c = 0; c < nc; ++c, ++jj)
          if (jj >= first) load_chunk(jj);
        const int s = i % W_COL_STAGES;
        hop::mbar_wait(k_empty + 8 * s, ((i / W_COL_STAGES) & 1) ^ 1);
        hop::mbar_arrive_expect_tx(k_full + 8 * s, WQ_KCOLS);
        tma_cols<WQ_BC, WIDE_COLS / WC>(sK + s * WQ_KCOLS, &tm_k,
                                        k_full + 8 * s, c0, i * WQ_BC, h, b);
      }
    }
    return;
  }

  hop::setmaxnreg_inc<224>();
  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int r_first = q0 + wg * 64;
  int row[2];
  row[0] = r_first + warp * 16 + lane / 4;
  row[1] = row[0] + 8;

  float acc[WIDE_COLS / 2];
#pragma unroll
  for (int i = 0; i < WIDE_COLS / 2; ++i) acc[i] = 0.f;

  hop::mbar_wait(stats_full, 0);
  float mlog2[2], di[2];
  int my_seg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mlog2[r] = stats->mlog2[row[r] - q0];
    di[r] = stats->di[row[r] - q0];
    my_seg[r] = stats->seg[row[r] - q0];
  }
  const float scale_log2 = scale * LOG2E;

  int j = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = i * WQ_BC, sk = i % W_COL_STAGES;
    const uint32_t kpar = (i / W_COL_STAGES) & 1;
    // Under causal masking a key tile wholly after this warpgroup's rows
    // has nothing for it: its stages are waited for and freed (so each
    // arrival counts towards the right phase).
    if (causal && k0 > r_first + 63) {
      for (int c = 0; c < nc; ++c, ++j) {
        const int s = j % WQ_STAGES;
        hop::mbar_wait(c_full + 8 * s, (j / WQ_STAGES) & 1);
        hop::mbar_arrive(c_empty + 8 * s);
      }
      hop::mbar_wait(k_full + 8 * sk, kpar);
      hop::mbar_arrive(k_empty + 8 * sk);
      continue;
    }
    // S = Q . K^T and dP = dO . V^T over the chunks.
    float sc[WQ_BC / 2], dp[WQ_BC / 2];
    int prev = 0;
    for (int c = 0; c < nc; ++c, ++j) {
      const int s = j % WQ_STAGES;
      hop::mbar_wait(c_full + 8 * s, (j / WQ_STAGES) & 1);
      const uint32_t sQ = sChunk + s * WQ_CHUNK, sdO = sQ + WQ_Q;
      const uint32_t sKc = sdO + WQ_Q, sVc = sKc + WQ_K;
      hop::wgmma_fence();
      mma_chunk<DQ_BR, WQ_BC, E>(sc, sQ, wg * 64, sKc, c);
      mma_chunk<DQ_BR, WQ_BC, E>(dp, sdO, wg * 64, sVc, c);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      if (c > 0) hop::mbar_arrive(c_empty + 8 * prev);
      prev = s;
    }
    hop::wgmma_wait_all();
    hop::fence_regs(sc);
    hop::fence_regs(dp);
    hop::mbar_arrive(c_empty + 8 * prev);

    // P = exp(S scale - m) / l and dS = P (dP - di), as
    // flash_bwd_dq_kernel's.
    const bool need_mask = k0 + WQ_BC > T || ks != nullptr ||
                           (causal && k0 + WQ_BC - 1 > r_first);
#pragma unroll
    for (int jj = 0; jj < WQ_BC / 2; ++jj) {
      const int r = (jj / 2) % 2;
      float p = exp2f(fmaf(sc[jj], scale_log2, -mlog2[r]));
      if (need_mask) {
        const int kc = k0 + 8 * (jj / 4) + 2 * (lane % 4) + jj % 2;
        const bool ok = kc < T && (!causal || kc <= row[r]) &&
                        (!ks || ks[kc] == my_seg[r]);
        if (!ok) p = 0.f;
      }
      dp[jj] = p * (dp[jj] - di[r]);
    }
    // dQ += dS . K over this block's columns of K.
    uint32_t da[WQ_BC / 16][4];
#pragma unroll
    for (int kk = 0; kk < WQ_BC / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        da[kk][e] =
            hop::Elem<E>::pack(dp[8 * kk + 2 * e], dp[8 * kk + 2 * e + 1]);
    hop::mbar_wait(k_full + 8 * sk, kpar);
    hop::wgmma_fence();
    hop::fence_regs(acc);
#pragma unroll
    for (int kk = 0; kk < WQ_BC / 16; ++kk)
      mma_rs<WIDE_COLS, WQ_BC, WIDE_COLS, E>(acc, da[kk],
                                             sK + sk * WQ_KCOLS, 0, kk);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(acc);
    hop::fence_regs(da);
    hop::mbar_arrive(k_empty + 8 * sk);
  }

  // Epilogue: the scale multiplies dQ after its products (trouble spot 3).
  const long long off = base_offset(g, y);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    E* dst = dq + off + (long long)row[r] * g.st + c0 + 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < WIDE_COLS / 8; ++jj)
      store2(dst + 8 * jj, acc[4 * jj + 2 * r] * scale,
             acc[4 * jj + 2 * r + 1] * scale);
  }
}

constexpr int wide_dkv_smem_bytes() {
  return 1024 + WKV_STAGES * WKV_CHUNK + W_COL_STAGES * WKV_COL +
         8 * (2 * WKV_STAGES + 3 * W_COL_STAGES);
}

// dK/dV: one block per (128-key tile, batch*head, 128 columns of dK and
// dV); walks q tiles of 64 on the transposed scores, as
// flash_bwd_dkv_kernel.
template <typename E>
__global__ void __launch_bounds__(DKV_THREADS, 1)
    flash_bwd_dkv_wide_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const float* __restrict__ m_in,
                              const float* __restrict__ l_in,
                              const int* __restrict__ qseg,
                              const int* __restrict__ kseg,
                              const E* __restrict__ o_glob,
                              const E* __restrict__ do_glob,
                              E* __restrict__ dk, E* __restrict__ dv,
                              Geometry g, int D, int causal, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const SmemBase sm = smem_base(smem_raw);
  const uint32_t sChunk = sm.addr;  // stage s: K, V, Q, dO chunks
  // Column stage s: Q's columns, dO's columns, the q tile's statistics.
  const uint32_t sCol = sChunk + WKV_STAGES * WKV_CHUNK;
  const uint32_t c_full = sCol + W_COL_STAGES * WKV_COL;
  const uint32_t c_empty = c_full + 8 * WKV_STAGES;
  const uint32_t col_loaded = c_empty + 8 * WKV_STAGES;
  const uint32_t col_stats = col_loaded + 8 * W_COL_STAGES;
  const uint32_t col_empty = col_stats + 8 * W_COL_STAGES;
  auto stats = [&](int s) {
    return reinterpret_cast<DkvStats*>(sm.ptr + (sCol - sm.addr) +
                                       s * WKV_COL + 2 * WKV_QCOLS);
  };

  const int T = g.T, y = blockIdx.x, k0 = blockIdx.y * DKV_BK;
  const int c0 = blockIdx.z * WIDE_DKV_COLS;
  const int q_first = dkv_first_q_tile(k0, causal);
  const int n_tiles = (T + DKV_BQ - 1) / DKV_BQ - q_first;
  const int nc = D / WC;
  const int* qs = qseg ? qseg + (long long)(y / g.seg_heads) * T : nullptr;
  const int* ks = kseg ? kseg + (long long)(y / g.seg_heads) * T : nullptr;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WKV_STAGES; ++s) {
      hop::mbar_init(c_full + 8 * s, 1);
      hop::mbar_init(c_empty + 8 * s, CONSUMERS);
    }
    for (int s = 0; s < W_COL_STAGES; ++s) {
      hop::mbar_init(col_loaded + 8 * s, 1);
      hop::mbar_init(col_stats + 8 * s, WKV_STAT_THREADS);
      hop::mbar_init(col_empty + 8 * s, CONSUMERS);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // Producer warpgroup: thread 0 streams, per q tile, the (K, V, Q, dO)
    // chunks and then Q's and dO's columns; warps 1 and 2 compute the q
    // tile's statistics, one row a thread, from device memory (trouble
    // spot 4); warp 3 has nothing to do.
    hop::setmaxnreg_dec<40>();
    const int pt = threadIdx.x - CONSUMERS;
    const int h = y % g.H, b = y / g.H;
    if (pt == 0) {
      int jj = 0;
      for (int i = 0; i < n_tiles; ++i) {
        const int q0 = (q_first + i) * DKV_BQ;
        for (int c = 0; c < nc; ++c, ++jj) {
          const int s = jj % WKV_STAGES;
          hop::mbar_wait(c_empty + 8 * s, ((jj / WKV_STAGES) & 1) ^ 1);
          const uint32_t dst = sChunk + s * WKV_CHUNK;
          const uint32_t bar = c_full + 8 * s;
          hop::mbar_arrive_expect_tx(bar, WKV_CHUNK);
          hop::tma_load_4d(dst, &tm_k, bar, c * WC, k0, h, b);
          hop::tma_load_4d(dst + WKV_K, &tm_v, bar, c * WC, k0, h, b);
          hop::tma_load_4d(dst + 2 * WKV_K, &tm_q, bar, c * WC, q0, h, b);
          hop::tma_load_4d(dst + 2 * WKV_K + WKV_Q, &tm_do, bar, c * WC, q0,
                           h, b);
        }
        const int s = i % W_COL_STAGES;
        hop::mbar_wait(col_empty + 8 * s, ((i / W_COL_STAGES) & 1) ^ 1);
        const uint32_t dst = sCol + s * WKV_COL;
        hop::mbar_arrive_expect_tx(col_loaded + 8 * s, 2 * WKV_QCOLS);
        tma_cols<DKV_BQ, WIDE_DKV_COLS / WC>(dst, &tm_q, col_loaded + 8 * s,
                                             c0, q0, h, b);
        tma_cols<DKV_BQ, WIDE_DKV_COLS / WC>(dst + WKV_QCOLS, &tm_do,
                                             col_loaded + 8 * s, c0, q0, h,
                                             b);
      }
    } else if (pt >= 32 && pt < 32 + WKV_STAT_THREADS) {
      const int rr = pt - 32;
      const long long off = base_offset(g, y);
      for (int i = 0; i < n_tiles; ++i) {
        const int qr = (q_first + i) * DKV_BQ + rr;
        float m = -INFINITY, l = 0.f, di = 0.f;
        int seg = 0;
        if (qr < T) {
          m = m_in[(long long)y * T + qr];
          l = l_in[(long long)y * T + qr];
          if (qs) seg = qs[qr];
          const long long at = off + (long long)qr * g.st;
          di = row_di_wide<E>(do_glob + at, o_glob + at, D);
        }
        const int s = i % W_COL_STAGES;
        hop::mbar_wait(col_empty + 8 * s, ((i / W_COL_STAGES) & 1) ^ 1);
        DkvStats* st = stats(s);
        const float safe_m = (m == -INFINITY) ? 0.f : m;
        const float denom = (l == 0.f) ? 1.f : l;
        st->mlog2[rr] = safe_m * LOG2E + log2f(denom);
        st->di[rr] = di;
        st->seg[rr] = seg;
        hop::mbar_arrive(col_stats + 8 * s);
      }
    }
    return;
  }

  hop::setmaxnreg_inc<232>();
  const int lane = threadIdx.x % 32;
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int k_first = k0 + wg * 64;
  int key[2], key_seg[2];
  key[0] = k_first + warp * 16 + lane / 4;
  key[1] = key[0] + 8;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_seg[r] = (ks && key[r] < T) ? ks[key[r]] : 0;

  float acc_dk[WIDE_DKV_COLS / 2], acc_dv[WIDE_DKV_COLS / 2];
#pragma unroll
  for (int i = 0; i < WIDE_DKV_COLS / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  int j = 0;
  for (int i = 0; i < n_tiles; ++i) {
    const int q0 = (q_first + i) * DKV_BQ, s2 = i % W_COL_STAGES;
    const uint32_t cpar = (i / W_COL_STAGES) & 1;
    const uint32_t sQc = sCol + s2 * WKV_COL, sdOc = sQc + WKV_QCOLS;
    // Under causal masking a q tile wholly before this warpgroup's keys
    // has nothing for it: its stages are waited for and freed.
    if (causal && q0 + DKV_BQ - 1 < k_first) {
      for (int c = 0; c < nc; ++c, ++j) {
        const int s = j % WKV_STAGES;
        hop::mbar_wait(c_full + 8 * s, (j / WKV_STAGES) & 1);
        hop::mbar_arrive(c_empty + 8 * s);
      }
      hop::mbar_wait(col_loaded + 8 * s2, cpar);
      hop::mbar_wait(col_stats + 8 * s2, cpar);
      hop::mbar_arrive(col_empty + 8 * s2);
      continue;
    }
    // S^T = K . Q^T and dP^T = V . dO^T over the chunks.
    float sT[DKV_BQ / 2], dpT[DKV_BQ / 2];
    int prev = 0;
    for (int c = 0; c < nc; ++c, ++j) {
      const int s = j % WKV_STAGES;
      hop::mbar_wait(c_full + 8 * s, (j / WKV_STAGES) & 1);
      const uint32_t sKc = sChunk + s * WKV_CHUNK, sVc = sKc + WKV_K;
      const uint32_t sQch = sVc + WKV_K, sdOch = sQch + WKV_Q;
      hop::wgmma_fence();
      mma_chunk<DKV_BK, DKV_BQ, E>(sT, sKc, wg * 64, sQch, c);
      mma_chunk<DKV_BK, DKV_BQ, E>(dpT, sVc, wg * 64, sdOch, c);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      if (c > 0) hop::mbar_arrive(c_empty + 8 * prev);
      prev = s;
    }
    hop::wgmma_wait_all();
    hop::fence_regs(sT);
    hop::fence_regs(dpT);
    hop::mbar_arrive(c_empty + 8 * prev);

    hop::mbar_wait(col_loaded + 8 * s2, cpar);
    hop::mbar_wait(col_stats + 8 * s2, cpar);
    const DkvStats* st = stats(s2);
    // P^T and dS^T, as flash_bwd_dkv_kernel's.
    const bool need_mask = q0 + DKV_BQ > T || k_first + 64 > T ||
                           qs != nullptr || (causal && q0 < k_first + 63);
#pragma unroll
    for (int jj = 0; jj < DKV_BQ / 2; ++jj) {
      const int r = (jj / 2) % 2;
      const int qc = 8 * (jj / 4) + 2 * (lane % 4) + jj % 2;
      float p = exp2f(fmaf(sT[jj] * scale, LOG2E, -st->mlog2[qc]));
      if (need_mask) {
        const int qr = q0 + qc;
        const bool ok = qr < T && key[r] < T && (!causal || qr >= key[r]) &&
                        (!qs || st->seg[qc] == key_seg[r]);
        if (!ok) p = 0.f;
      }
      sT[jj] = p;
      dpT[jj] = p * (dpT[jj] - st->di[qc]);
    }
    uint32_t pa[DKV_BQ / 16][4], da[DKV_BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] =
            hop::Elem<E>::pack(sT[8 * kk + 2 * e], sT[8 * kk + 2 * e + 1]);
        da[kk][e] =
            hop::Elem<E>::pack(dpT[8 * kk + 2 * e], dpT[8 * kk + 2 * e + 1]);
      }
    // dV += P^T . dO and dK += dS^T . Q over this block's columns.
    hop::wgmma_fence();
    hop::fence_regs(acc_dv);
    hop::fence_regs(acc_dk);
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)
      mma_rs<WIDE_DKV_COLS, DKV_BQ, WIDE_DKV_COLS, E>(acc_dv, pa[kk], sdOc,
                                                      0, kk);
#pragma unroll
    for (int kk = 0; kk < DKV_BQ / 16; ++kk)
      mma_rs<WIDE_DKV_COLS, DKV_BQ, WIDE_DKV_COLS, E>(acc_dk, da[kk], sQc, 0,
                                                      kk);
    hop::wgmma_commit();
    hop::wgmma_wait_all();
    hop::fence_regs(acc_dv);
    hop::fence_regs(acc_dk);
    hop::fence_regs(pa);
    hop::fence_regs(da);
    hop::mbar_arrive(col_empty + 8 * s2);
  }

  // The scale multiplies dK after its products (trouble spot 3).
  const long long off = base_offset(g, y);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= T) continue;
    const long long at =
        off + (long long)key[r] * g.st + c0 + 2 * (lane % 4);
#pragma unroll
    for (int jj = 0; jj < WIDE_DKV_COLS / 8; ++jj) {
      store2(dk + at + 8 * jj, acc_dk[4 * jj + 2 * r] * scale,
             acc_dk[4 * jj + 2 * r + 1] * scale);
      store2(dv + at + 8 * jj, acc_dv[4 * jj + 2 * r],
             acc_dv[4 * jj + 2 * r + 1]);
    }
  }
}

// The launches call this before they encode their tensor maps: as a
// runtime call it makes the device's primary context current in the
// calling thread (autograd runs the backward on a thread of its own),
// and the driver's map encoder needs a current context.
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

// A 4-D map (d, t, h, b) over one operand of head dim D, boxes of [rows,
// box] with the given swizzle; rows past T read as zeros.  The folded
// [B*H, T, D] layout is H = 1 (its head stride is never stepped: any
// legal value).
template <typename E>
cudaError_t encode_map(CUtensorMap* map, const void* ptr, int BH,
                       const Geometry& g, int D, int box_cols, int rows,
                       CUtensorMapSwizzle swizzle) {
  auto encode = hop::tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)g.T, (cuuint64_t)g.H,
                        (cuuint64_t)(BH / g.H)};
  cuuint64_t strides[3] = {(cuuint64_t)g.st * 2,
                           (cuuint64_t)(g.H == 1 ? g.sb : g.sh) * 2,
                           (cuuint64_t)g.sb * 2};
  cuuint32_t box[4] = {(cuuint32_t)box_cols, (cuuint32_t)rows, 1, 1};
  cuuint32_t step[4] = {1, 1, 1, 1};
  CUresult r = encode(map, hop::Elem<E>::TMA, 4,
                      const_cast<void*>(ptr), dims, strides, box, step,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The map of a kernel head dim D: boxes of [rows, BOX] with its swizzle.
template <int D, typename E>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int BH,
                     const Geometry& g, int rows) {
  using S = hop::Swizzle<D>;
  return encode_map<E>(map, ptr, BH, g, D, S::BOX, rows, S::TMA);
}

template <int D, typename E>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* m, void* l, const void* qseg, const void* kseg,
                       int BH, const Geometry& g, int causal, float scale,
                       cudaStream_t stream) {
  constexpr int smem = fwd_smem_bytes<D>();
  static_assert(smem <= SMEM_LIMIT, "forward tiles fit a block");
  constexpr int BC = Tiles<D>::FWD_BC;
  CUtensorMap tq, tk, tv;
  cudaError_t err = prepare(flash_fwd_kernel<D, E>, smem);
  if (err == cudaSuccess) err = make_map<D, E>(&tq, q, BH, g, FWD_BR);
  if (err == cudaSuccess) err = make_map<D, E>(&tk, k, BH, g, BC);
  if (err == cudaSuccess) err = make_map<D, E>(&tv, v, BH, g, BC);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + FWD_BR - 1) / FWD_BR);
  flash_fwd_kernel<D, E><<<grid, Tiles<D>::FWD_THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<E*>(o), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), g, causal, scale);
  return cudaGetLastError();
}

template <int D, typename E>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* o, const void* dout, const void* m,
                      const void* l, const void* qseg, const void* kseg,
                      void* dq, int BH, const Geometry& g, int causal,
                      float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<D>();
  static_assert(smem <= SMEM_LIMIT, "dQ tiles fit a block");
  constexpr int BC = Tiles<D>::DQ_BC;
  CUtensorMap tq, tk, tv, tdo, to;
  cudaError_t err = prepare(flash_bwd_dq_kernel<D, E>, smem);
  if (err == cudaSuccess) err = make_map<D, E>(&tq, q, BH, g, DQ_BR);
  if (err == cudaSuccess) err = make_map<D, E>(&tk, k, BH, g, BC);
  if (err == cudaSuccess) err = make_map<D, E>(&tv, v, BH, g, BC);
  if (err == cudaSuccess) err = make_map<D, E>(&tdo, dout, BH, g, DQ_BR);
  if (err == cudaSuccess) err = make_map<D, E>(&to, o, BH, g, DQ_BR);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + DQ_BR - 1) / DQ_BR);
  flash_bwd_dq_kernel<D, E><<<grid, DQ_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, to, static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<const E*>(o),
      static_cast<E*>(dq), g, causal, scale);
  return cudaGetLastError();
}

template <int D, typename E>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const void* m,
                       const void* l, const void* qseg, const void* kseg,
                       void* dk, void* dv, int BH, const Geometry& g,
                       int causal, float scale, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<D>();
  static_assert(smem <= SMEM_LIMIT, "dK/dV tiles fit a block");
  CUtensorMap tq, tk, tv, tdo, to;
  cudaError_t err = prepare(flash_bwd_dkv_kernel<D, E>, smem);
  if (err == cudaSuccess) err = make_map<D, E>(&tq, q, BH, g, DKV_BQ);
  if (err == cudaSuccess) err = make_map<D, E>(&tk, k, BH, g, DKV_BK);
  if (err == cudaSuccess) err = make_map<D, E>(&tv, v, BH, g, DKV_BK);
  if (err == cudaSuccess) err = make_map<D, E>(&tdo, dout, BH, g, DKV_BQ);
  if (err == cudaSuccess) err = make_map<D, E>(&to, o, BH, g, DKV_BQ);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + DKV_BK - 1) / DKV_BK, D / Tiles<D>::DKV_COLS);
  flash_bwd_dkv_kernel<D, E><<<grid, DKV_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, to, static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<E*>(dk),
      static_cast<E*>(dv), g, causal, scale);
  return cudaGetLastError();
}


// The map of a wide head dim D (any multiple of WC): boxes of [rows, WC]
// with the 128-byte swizzle, each loaded at its own column.
template <typename E>
cudaError_t make_map_wide(CUtensorMap* map, const void* ptr, int BH,
                          const Geometry& g, int D, int rows) {
  return encode_map<E>(map, ptr, BH, g, D, WC, rows,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename E>
cudaError_t launch_fwd_wide(const void* q, const void* k, const void* v,
                            void* o, void* m, void* l, const void* qseg,
                            const void* kseg, int BH, const Geometry& g,
                            int D, int causal, float scale,
                            cudaStream_t stream) {
  constexpr int smem = wide_fwd_smem_bytes();
  static_assert(smem <= SMEM_LIMIT, "wide forward stages fit a block");
  CUtensorMap tq, tk, tv;
  cudaError_t err = prepare(flash_fwd_wide_kernel<E>, smem);
  if (err == cudaSuccess) err = make_map_wide<E>(&tq, q, BH, g, D, FWD_BR);
  if (err == cudaSuccess) err = make_map_wide<E>(&tk, k, BH, g, D, WF_BC);
  if (err == cudaSuccess) err = make_map_wide<E>(&tv, v, BH, g, D, WF_BC);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + FWD_BR - 1) / FWD_BR, D / WIDE_COLS);
  flash_fwd_wide_kernel<E><<<grid, CONSUMERS + 128, smem, stream>>>(
      tq, tk, tv, static_cast<E*>(o), static_cast<float*>(m),
      static_cast<float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), g, D, causal, scale);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_dq_wide(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const void* m,
                           const void* l, const void* qseg, const void* kseg,
                           void* dq, int BH, const Geometry& g, int D,
                           int causal, float scale, cudaStream_t stream) {
  constexpr int smem = wide_dq_smem_bytes();
  static_assert(smem <= SMEM_LIMIT, "wide dQ stages fit a block");
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = prepare(flash_bwd_dq_wide_kernel<E>, smem);
  if (err == cudaSuccess) err = make_map_wide<E>(&tq, q, BH, g, D, DQ_BR);
  if (err == cudaSuccess) err = make_map_wide<E>(&tk, k, BH, g, D, WQ_BC);
  if (err == cudaSuccess) err = make_map_wide<E>(&tv, v, BH, g, D, WQ_BC);
  if (err == cudaSuccess)
    err = make_map_wide<E>(&tdo, dout, BH, g, D, DQ_BR);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + DQ_BR - 1) / DQ_BR, D / WIDE_COLS);
  flash_bwd_dq_wide_kernel<E><<<grid, DQ_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<const E*>(o),
      static_cast<const E*>(dout), static_cast<E*>(dq), g, D, causal, scale);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_dkv_wide(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* m,
                            const void* l, const void* qseg,
                            const void* kseg, void* dk, void* dv, int BH,
                            const Geometry& g, int D, int causal,
                            float scale, cudaStream_t stream) {
  constexpr int smem = wide_dkv_smem_bytes();
  static_assert(smem <= SMEM_LIMIT, "wide dK/dV stages fit a block");
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = prepare(flash_bwd_dkv_wide_kernel<E>, smem);
  if (err == cudaSuccess) err = make_map_wide<E>(&tq, q, BH, g, D, DKV_BQ);
  if (err == cudaSuccess) err = make_map_wide<E>(&tk, k, BH, g, D, DKV_BK);
  if (err == cudaSuccess) err = make_map_wide<E>(&tv, v, BH, g, D, DKV_BK);
  if (err == cudaSuccess)
    err = make_map_wide<E>(&tdo, dout, BH, g, D, DKV_BQ);
  if (err != cudaSuccess) return err;
  dim3 grid(BH, (g.T + DKV_BK - 1) / DKV_BK, D / WIDE_DKV_COLS);
  flash_bwd_dkv_wide_kernel<E><<<grid, DKV_THREADS, smem, stream>>>(
      tq, tk, tv, tdo, static_cast<const float*>(m),
      static_cast<const float*>(l), static_cast<const int*>(qseg),
      static_cast<const int*>(kseg), static_cast<const E*>(o),
      static_cast<const E*>(dout), static_cast<E*>(dk), static_cast<E*>(dv),
      g, D, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// The C interface, loaded with ctypes: hvd_flash_<kernel>_bf16 and
// hvd_flash_<kernel>_f16.  Tensors are of the suffix's type except m and l
// (f32, [BH, T]) and the segment ids (int32, [BH / seg_heads, T], or null
// for none).  Element (y, t, d) of q, k, v, o, dout, dq, dk, dv lives at
// (y / H) * sb + (y % H) * sh + t * st + d.  D is 16, 32, 64, 128 or 256,
// or a multiple of 256 above it (the wide instances).  Each returns the
// cudaError_t of its launch (0 on success).

#define HVD_SWITCH_D(CALL, WIDE_CALL)                               \
  switch (D) {                                                      \
    case 16: return (int)CALL(16);                                  \
    case 32: return (int)CALL(32);                                  \
    case 64: return (int)CALL(64);                                  \
    case 128: return (int)CALL(128);                                \
    case 256: return (int)CALL(256);                                \
    default:                                                        \
      if (D > 256 && D % WIDE_COLS == 0) return (int)WIDE_CALL;     \
      return (int)cudaErrorInvalidValue;                            \
  }

#define HVD_FLASH_ENTRY_POINTS(SUFFIX)                                        \
  extern "C" int hvd_flash_fwd_##SUFFIX(                                      \
      const void* q, const void* k, const void* v, void* o, void* m, void* l, \
      const void* qseg, const void* kseg, int BH, int H, int seg_heads,       \
      int T, int D, long long sb, long long st, long long sh, int causal,     \
      float scale, void* stream) {                                            \
    const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);            \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                       \
    HVD_SWITCH_D(FWD_##SUFFIX, FWD_WIDE_##SUFFIX)                             \
  }                                                                           \
  extern "C" int hvd_flash_bwd_dq_##SUFFIX(                                   \
      const void* q, const void* k, const void* v, const void* o,             \
      const void* dout, const void* m, const void* l, const void* qseg,       \
      const void* kseg, void* dq, int BH, int H, int seg_heads, int T, int D, \
      long long sb, long long st, long long sh, int causal, float scale,      \
      void* stream) {                                                         \
    const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);            \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                       \
    HVD_SWITCH_D(DQ_##SUFFIX, DQ_WIDE_##SUFFIX)                               \
  }                                                                           \
  extern "C" int hvd_flash_bwd_dkv_##SUFFIX(                                  \
      const void* q, const void* k, const void* v, const void* o,             \
      const void* dout, const void* m, const void* l, const void* qseg,       \
      const void* kseg, void* dk, void* dv, int BH, int H, int seg_heads,     \
      int T, int D, long long sb, long long st, long long sh, int causal,     \
      float scale, void* stream) {                                            \
    const Geometry g = make_geometry(H, seg_heads, T, sb, st, sh);            \
    cudaStream_t s = static_cast<cudaStream_t>(stream);                       \
    HVD_SWITCH_D(DKV_##SUFFIX, DKV_WIDE_##SUFFIX)                             \
  }

#define FWD_bf16(DD) \
  launch_fwd<DD, bf16>(q, k, v, o, m, l, qseg, kseg, BH, g, causal, scale, s)
#define FWD_f16(DD) \
  launch_fwd<DD, f16>(q, k, v, o, m, l, qseg, kseg, BH, g, causal, scale, s)
#define DQ_bf16(DD)                                                         \
  launch_dq<DD, bf16>(q, k, v, o, dout, m, l, qseg, kseg, dq, BH, g, causal, \
                      scale, s)
#define DQ_f16(DD)                                                         \
  launch_dq<DD, f16>(q, k, v, o, dout, m, l, qseg, kseg, dq, BH, g, causal, \
                     scale, s)
#define DKV_bf16(DD)                                                       \
  launch_dkv<DD, bf16>(q, k, v, o, dout, m, l, qseg, kseg, dk, dv, BH, g, \
                       causal, scale, s)
#define DKV_f16(DD)                                                       \
  launch_dkv<DD, f16>(q, k, v, o, dout, m, l, qseg, kseg, dk, dv, BH, g, \
                      causal, scale, s)

#define FWD_WIDE_bf16                                                   \
  launch_fwd_wide<bf16>(q, k, v, o, m, l, qseg, kseg, BH, g, D, causal, \
                        scale, s)
#define FWD_WIDE_f16                                                   \
  launch_fwd_wide<f16>(q, k, v, o, m, l, qseg, kseg, BH, g, D, causal, \
                       scale, s)
#define DQ_WIDE_bf16                                                       \
  launch_dq_wide<bf16>(q, k, v, o, dout, m, l, qseg, kseg, dq, BH, g, D, \
                       causal, scale, s)
#define DQ_WIDE_f16                                                       \
  launch_dq_wide<f16>(q, k, v, o, dout, m, l, qseg, kseg, dq, BH, g, D, \
                      causal, scale, s)
#define DKV_WIDE_bf16                                                    \
  launch_dkv_wide<bf16>(q, k, v, o, dout, m, l, qseg, kseg, dk, dv, BH, \
                        g, D, causal, scale, s)
#define DKV_WIDE_f16                                                    \
  launch_dkv_wide<f16>(q, k, v, o, dout, m, l, qseg, kseg, dk, dv, BH, \
                       g, D, causal, scale, s)

HVD_FLASH_ENTRY_POINTS(bf16)
HVD_FLASH_ENTRY_POINTS(f16)
