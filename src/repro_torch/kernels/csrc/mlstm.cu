// Chunkwise mLSTM (xLSTM matrix memory) for Hopper (sm_90a): a bf16 route on
// the tensor cores (wgmma fed by TMA) and an fp32 route on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/mlstm.py::mlstm_chunkwise (body
// _mlstm_kernel, pl.pallas_call at mlstm.py:137). Both routes compute the
// same function, the stabilised chunkwise mLSTM of every (batch b, head h):
// with chunks of L steps, b_t the in-chunk inclusive cumsum of logsigmoid(f),
// g = b at the chunk's last step, k scaled by 1/sqrt(D) and the state
// (C (D x D), n (D), m) entering the chunk,
//
//   m_t   = max(b_t + m, max_{s<=t} (b_t - b_s + i_s))
//   h_t   = [e^{b_t+m-m_t} q_t C + sum_{s<=t} e^{b_t-b_s+i_s-m_t} (q_t.k_s) v_s]
//           / max(|e^{b_t+m-m_t} q_t.n + sum_{s<=t} e^{...} (q_t.k_s)|, e^{-m_t})
//   m'    = max(g + m, max_j (g - b_j + i_j))
//   C'    = e^{g+m-m'} C + sum_j e^{g-b_j+i_j-m'} k_j v_j^T,  n' likewise with 1 for v_j
//
// for q, k, v (B, T, H, D) in fp32 or bf16 (one type, rows of D contiguous,
// the other axes strided), i and f gates (B, T, H) in fp32, and the output
// (B, T, H, D) in q's type. The state starts at C = 0, n = 0, m = -1e30 (a
// finite stand-in for -inf: with -inf, b + m - m_t would give NaN), and expf
// is the accurate one. The math does not depend on the chunk length, only
// where the sums round. Ragged T is masked: a short last chunk reads zeros
// past T (whose state is never used) and stores nothing there; the Pallas
// kernel asserts T % L == 0 instead.
//
// The TPU kernel carries C (D x D fp32: 1 MB at D = 512) in VMEM across a
// sequential chunk axis, over a grid of B * H sequences. On Hopper C fits no
// SM (227 KB of shared memory), and B * H = 8 sequences at the xlstm-350m
// prefill shape (B 2, T 2048, H 4, D 512) would fill 8 of 132 SMs. So both
// routes split the work into passes that are parallel over more than the
// sequences, and hand the state entering every chunk from one pass to the
// next through device memory.
//
// Routes (the wrapper's plan() picks by shape: bf16 with D % 64 == 0 and
// D <= 512 takes the wgmma route; every other bf16 D and all of fp32 take
// the CUDA-core route).
//
// wgmma route, chunk L = 128, three launches:
//   1. gates   gates_scan_kernel<128> (both routes' gates pass, at their
//              chunk): one block per sequence, 1024 / L chunks at a time: b
//              (an in-chunk scan in warp shuffles), the key weights
//              kw_j = e^{g-b_j+i_j-m'}, the decay e^{g+m-m'} and the m
//              entering each chunk, only m walked chunk by chunk. Scalars
//              only: B*H*T floats.
//   2. states  states_wgmma_kernel: one block per (sequence, 128 x 128 tile
//              of C): 8 x 4 x 4 = 128 blocks at the prefill shape, one wave
//              on 132 SMs. Warpgroup 0 gives its registers away (setmaxnreg)
//              and one of its threads feeds k and v chunks by TMA through a
//              2-deep ring; warpgroups 1 and 2 own 64 rows of the tile each,
//              in fp32 accumulators, over the whole walk. A chunk: write the
//              state entering it (as bf16 hi and lo, below) into a staging
//              buffer in the state map's swizzled layout and store it by TMA,
//              which runs on while the walk goes on; scale the tile by the
//              decay; add (kw k / sqrt(D))^T v, wgmma m64n128k16 with A from
//              registers and B = v MN-major from shared memory. The A
//              fragments come straight from the TMA box of k by
//              ldmatrix.trans (the transposed 8 x 8 pieces are wgmma's
//              register-A layout), scaled by the key weights and split into
//              hi and lo in registers, so k makes no round trip through shared
//              memory. The key weights of the next chunk are loaded while
//              this one runs. The blocks of the first column of tiles also
//              carry n in fp32, each thread a part of two rows, summed over
//              the row's 4 lanes by shuffles at each chunk.
//   3. output  output_wgmma_kernel: one block per (chunk, sequence): 128
//              blocks at the prefill shape, one wave. The loader thread
//              brings q (all D, resident: 128 KB at D 512, each 64-column box
//              on a barrier of its own, just ahead of the first item that
//              reads it) and, through a 3-deep ring of 32 KB stages, for each
//              128-column tile of the output in turn the state entering the
//              chunk in 64-row slabs (hi and lo) and the v tile, with S's k
//              boxes after the first tile's state, so the state streams from
//              device memory from the block's start. Each consumer warpgroup
//              owns 64 rows t.
//              Once: S = q k^T (bf16 inputs, exact products, fp32 sums); the
//              decay matrix and the causal mask applied in fp32 registers
//              give W; its row sums, q.n and the stabilised denominator are
//              formed from fp32 values on the CUDA cores; W is kept as wgmma
//              A fragments (hi and lo, as K1's P). Per column tile: acc = q C
//              (hi and lo), scaled by e^{b+m-m_t} per row, acc += W v;
//              divide, round once to bf16 and store by TMA through the v
//              tile's stage. The chunk's L x L scores never leave the SM.
//
// Precision. The denominator nearly cancels in some rows (ROADMAP C), which
// amplifies an error in the numerator's operands ~10^4-fold. Every operand of
// a numerator product that is not an exact bf16 input (W, kw k / sqrt(D) and
// the state C) is therefore split, x_hi = bf16(x), x_lo = bf16(x - x_hi), and
// its product taken as two wgmmas into one fp32 accumulator: ~16 bits of
// mantissa an operand, for 2x the tensor work on those products. q, k and v
// enter as they are (exact). A plain-torch model of this arithmetic
// (repro_torch.kernels.ref.mlstm_rounded_scan) at the prefill shape reads one
// bf16 ulp of the output against an fp64 evaluation, as the fp32 route does;
// the same with the operands rounded once to bf16 reads 4.7, with TF32
// operands 0.37 (tests/test_torch_kernels.py holds these on the CPU).
//
// What bounds it. At the prefill shape the function moves ~34 MB of q, k, v,
// gates and output, 0.020 ms at 3.35 TB/s: its bound, by bytes. Its work
// grows with the chunk (two L x L x D products a chunk for the intra-chunk
// part, two L x D x D for the state): ~19 GFLOP at L 64, ~21 GFLOP at this
// route's L 128, 0.022 ms at the bf16 tensor rate. This design does ~2x
// that work (the split products), which the tensor cores finish in
// a fraction of its time, and moves the state entering every chunk through
// device memory as bf16 hi and lo: (B*H, T/L - 1, D, D) x 4 bytes = 126 MB
// written by the states pass and read once by the output pass, ~0.075 ms at
// 3.35 TB/s, ~0.1 ms with q, k, v and the output: that traffic, not the
// tensor rate, is the floor of this design, and each pass runs at about two
// thirds of it. A fused walk that keeps C on chip and writes no state is
// later work. PERF.md has the measured times.
//
// CUDA-core route, chunk L = 64, four launches, fp32 FMAs:
//   1. gates   gates_scan_kernel<64>, as above.
//   2. states  one block per (sequence, 64 x 64 tile of C) walks the chunks
//              with its tile in registers, writing the state entering every
//              chunk to a scratch of (B*H, T/L, D, D) fp32 and applying the
//              chunk's rank-L update from shared memory. The blocks of the
//              first column of tiles also carry n.
//   3. scores  one block per (sequence, chunk): the L x L gate-decayed
//              q.k^T (a reduction over D in slabs of 32), its row sums and
//              q.n, giving W, e^{b+m-m_t} and the denominator of every step.
//   4. output  one block per (sequence, chunk, 64 columns of v): W v and
//              q C over the state entering the chunk, each a 64 x 64 tile
//              product from shared memory, then divided by the denominator.
// Every tile product gives a thread a 4 x 4 piece of the output (rows ty +
// 16 i, columns tx + 16 j) from shared-memory rows padded to 65 floats. It is
// bound by the fp32 CUDA-core rate (~0.29 ms at the prefill shape) and keeps
// fp32 inputs within the fp32 bar (2e-3), which bf16 or TF32 operands cannot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int L = 64;        // chunk length of the CUDA-core route
constexpr int TILE = 64;     // edge of an output tile
constexpr int KS = 32;       // reduction slab of the scores and output products
constexpr int NT = 256;      // threads per block of the tile kernels
constexpr int LDS = TILE + 1;
constexpr float NEG_INF = -1e30f;

struct In {
  const void* q;
  const void* k;
  const void* v;
  const float* ig;
  const float* fg;
  void* out;  // (B, T, H, D), contiguous
  long long q_sb, q_st, q_sh;  // element strides of the batch, time and head axes
  long long k_sb, k_st, k_sh;
  long long v_sb, v_st, v_sh;
  long long i_sb, i_st, i_sh;
  long long f_sb, f_st, f_sh;
  int T, H, D, nc;
  float scale;
};

// fp32 scratch of the CUDA-core route, carved from one workspace by ml_workspace_floats' layout
struct Work {
  float* b;      // (BH, nc * L) in-chunk cumsum of logsigmoid(f)
  float* kw;     // (BH, nc * L) key weights e^{g - b_j + i_j - m'}
  float* decay;  // (BH, nc) e^{g + m - m'}
  float* m_in;   // (BH, nc) m entering each chunk
  float* C;      // (BH, nc, D, D) C entering each chunk
  float* n;      // (BH, nc, D) n entering each chunk
  float* W;      // (BH, nc, L, L) gate-decayed scores
  float* iw;     // (BH, nc * L) e^{b + m - m_t}
  float* den;    // (BH, nc * L) the stabilised denominator
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

// row t of a (B, T, H, D) input at sequence (b, h): a pointer to its D elements
template <typename TI>
__device__ __forceinline__ const TI* row(const void* base, long long sb, long long st, long long sh,
                                         int b, int t, int h) {
  return static_cast<const TI*>(base) + b * sb + t * st + h * sh;
}

// what the gates pass writes: fp32, (BH, nc * L) and (BH, nc) at chunk L
struct Gates {
  float* b;      // in-chunk cumsum of logsigmoid(f)
  float* kw;     // key weights e^{g - b_j + i_j - m'}
  float* decay;  // e^{g + m - m'}
  float* m_in;   // m entering each chunk
};

// ---------------------------------------------------------------- 1. gates
// Both routes' gates pass at chunk CL, 1024 / CL chunks at a time: a block of
// 1024 threads per sequence, a thread per step of each of the round's chunks;
// the in-chunk scans in warp shuffles, and only the carried m walked chunk by
// chunk, by one thread over the round's scalars: 3 block barriers a round.
constexpr int GATES_THREADS = 1024;
template <int CL>
__global__ void __launch_bounds__(GATES_THREADS) gates_scan_kernel(In a, Gates w) {
  constexpr int CPR = GATES_THREADS / CL, NW = CL / 32;  // chunks a round, warps a chunk
  __shared__ float wsum[CPR][NW], wmax[CPR][NW], gs[CPR], mnew[CPR];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int j = threadIdx.x % CL, q = threadIdx.x / CL, lane = j % 32, wid = j / 32;
  const long long Tp = (long long)a.nc * CL;
  float m_prev = NEG_INF;  // thread 0's
  for (int c0 = 0; c0 < a.nc; c0 += CPR) {
    const int c = c0 + q, t = c * CL + j;
    float fv = 0.f, iv = 0.f;  // past T: finite, and only the unused last state sees them
    if (c < a.nc && t < a.T) {
      fv = a.fg[b * a.f_sb + t * a.f_st + h * a.f_sh];
      iv = a.ig[b * a.i_sb + t * a.i_st + h * a.i_sh];
    }
    float x = log_sigmoid(fv);  // inclusive scan within the warp
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) wsum[q][wid] = x;
    __syncthreads();
    float pre = 0.f, head = 0.f;  // the earlier warps' sums; g is the last step's b, in its order
#pragma unroll
    for (int k = 0; k < NW - 1; ++k) {
      if (k < wid) pre += wsum[q][k];
      head += wsum[q][k];
    }
    const float bj = pre + x, g = head + wsum[q][NW - 1];
    const float key = g - bj + iv;
    float mk = key;
#pragma unroll
    for (int off = 16; off > 0; off /= 2) mk = fmaxf(mk, __shfl_xor_sync(0xffffffffu, mk, off));
    if (lane == 0) wmax[q][wid] = mk;
    if (j == 0) gs[q] = g;
    __syncthreads();
    if (threadIdx.x == 0)  // m' = max(g + m, max_j key_j), chunk by chunk
      for (int k = 0; k < CPR && c0 + k < a.nc; ++k) {
        float kmax = wmax[k][0];
#pragma unroll
        for (int u = 1; u < NW; ++u) kmax = fmaxf(kmax, wmax[k][u]);
        const float m_new = fmaxf(gs[k] + m_prev, kmax);
        w.m_in[(long long)bh * a.nc + c0 + k] = m_prev;
        w.decay[(long long)bh * a.nc + c0 + k] = expf(gs[k] + m_prev - m_new);
        mnew[k] = m_new;
        m_prev = m_new;
      }
    __syncthreads();
    if (c < a.nc) {
      w.b[bh * Tp + t] = bj;
      w.kw[bh * Tp + t] = expf(key - mnew[q]);
    }
  }
}

// ---------------------------------------------------------------- 2. states
// Block (tile of C, sequence): rows d0.. (k's dims), columns e0.. (v's dims).
template <typename TI>
__global__ void __launch_bounds__(NT) states_kernel(In a, Work w) {
  __shared__ float sk[L][LDS];  // sk[j][d] = k_j[d0 + d] / sqrt(D) * kw_j
  __shared__ float sv[L][LDS];  // sv[j][e] = v_j[e0 + e]
  const int nd = (a.D + TILE - 1) / TILE;
  const int d0 = (blockIdx.x / nd) * TILE, e0 = (blockIdx.x % nd) * TILE;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long Tp = (long long)a.nc * L;
  const long long DD = (long long)a.D * a.D;
  const bool carries_n = e0 == 0 && threadIdx.x < TILE;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float nacc = 0.f;  // n[d0 + threadIdx.x], where carries_n

  for (int c = 0; c < a.nc; ++c) {
    float* Cc = w.C + ((long long)bh * a.nc + c) * DD;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int d = d0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = e0 + tx + 16 * j;
        if (d < a.D && e < a.D) Cc[(long long)d * a.D + e] = acc[i][j];
      }
    }
    if (carries_n && d0 + threadIdx.x < a.D)
      w.n[((long long)bh * a.nc + c) * a.D + d0 + threadIdx.x] = nacc;
    if (c == a.nc - 1) break;  // the state after the last chunk is not used

#pragma unroll 4
    for (int r = 0; r < L * TILE / NT; ++r) {
      const int idx = threadIdx.x + r * NT;
      const int j = idx / TILE, col = idx % TILE;
      const int t = c * L + j;
      float kv = 0.f, vv = 0.f;
      if (t < a.T) {
        if (d0 + col < a.D)
          kv = to_f32(row<TI>(a.k, a.k_sb, a.k_st, a.k_sh, b, t, h)[d0 + col]) * a.scale *
               w.kw[bh * Tp + t];
        if (e0 + col < a.D) vv = to_f32(row<TI>(a.v, a.v_sb, a.v_st, a.v_sh, b, t, h)[e0 + col]);
      }
      sk[j][col] = kv;
      sv[j][col] = vv;
    }
    __syncthreads();

    const float dec = w.decay[(long long)bh * a.nc + c];
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) p[i][j] = 0.f;
#pragma unroll 8
    for (int s = 0; s < L; ++s) {
      float x[4], y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = sk[s][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) y[j] = sv[s][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) p[i][j] += x[i] * y[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dec * acc[i][j] + p[i][j];
    if (carries_n) {
      float s = 0.f;
      for (int j = 0; j < L; ++j) s += sk[j][threadIdx.x];
      nacc = dec * nacc + s;
    }
    __syncthreads();  // before the next chunk overwrites sk and sv
  }
}

// Stage a 64-row, KS-column slab of a row-major matrix M, transposed:
// s[kk][r] = get(r, kk), the element or 0 outside the matrix. Threads read
// along a row (coalesced) and store down a padded column (no bank conflicts).
template <typename Get>
__device__ __forceinline__ void stage_t(float (*s)[LDS], Get get) {
#pragma unroll
  for (int r = 0; r < TILE * KS / NT; ++r) {
    const int idx = threadIdx.x + r * NT;
    const int kk = idx % KS, rr = idx / KS;
    s[kk][rr] = get(rr, kk);
  }
}

// Stage a KS-row, 64-column slab of a row-major matrix read along its rows:
// s[kk][n] = get(kk, n).
template <typename Get>
__device__ __forceinline__ void stage(float (*s)[LDS], Get get) {
#pragma unroll
  for (int r = 0; r < TILE * KS / NT; ++r) {
    const int idx = threadIdx.x + r * NT;
    const int n = idx % TILE, kk = idx / TILE;
    s[kk][n] = get(kk, n);
  }
}

__device__ __forceinline__ void tile_fma(float (*sa)[LDS], float (*sb)[LDS], float acc[4][4],
                                         int ty, int tx) {
#pragma unroll 8
  for (int kk = 0; kk < KS; ++kk) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = sa[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = sb[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
  }
}

// ---------------------------------------------------------------- 3. scores
// Block (chunk, sequence): the L x L scores of the chunk, rows t, columns s.
template <typename TI>
__global__ void __launch_bounds__(NT) scores_kernel(In a, Work w) {
  static_assert(L == TILE, "one tile covers the chunk");
  __shared__ float sq[KS][LDS];  // sq[dd][t] = q_t[d0 + dd]
  __shared__ float sk[KS][LDS];  // sk[dd][s] = k_s[d0 + dd] / sqrt(D)
  __shared__ float sn[KS];
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long Tp = (long long)a.nc * L;
  const float* nc_ = w.n + ((long long)bh * a.nc + c) * a.D;

  float acc[4][4], qn[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qn[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
  for (int d0 = 0; d0 < a.D; d0 += KS) {
    stage_t(sq, [&](int r, int kk) {
      const int t = c * L + r, d = d0 + kk;
      return (t < a.T && d < a.D) ? to_f32(row<TI>(a.q, a.q_sb, a.q_st, a.q_sh, b, t, h)[d]) : 0.f;
    });
    stage_t(sk, [&](int r, int kk) {
      const int t = c * L + r, d = d0 + kk;
      return (t < a.T && d < a.D)
                 ? to_f32(row<TI>(a.k, a.k_sb, a.k_st, a.k_sh, b, t, h)[d]) * a.scale
                 : 0.f;
    });
    if (threadIdx.x < KS) sn[threadIdx.x] = d0 + threadIdx.x < a.D ? nc_[d0 + threadIdx.x] : 0.f;
    __syncthreads();
    tile_fma(sq, sk, acc, ty, tx);
#pragma unroll 8
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) qn[i] += sq[kk][ty + 16 * i] * sn[kk];
    __syncthreads();
  }

  const float m_prev = w.m_in[(long long)bh * a.nc + c];
  float bs[4], is[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int s = tx + 16 * j, ts = c * L + s;
    bs[j] = w.b[bh * Tp + ts];
    is[j] = ts < a.T ? a.ig[b * a.i_sb + ts * a.i_st + h * a.i_sh] : 0.f;
  }
  float* Wc = w.W + ((long long)bh * a.nc + c) * L * L;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = ty + 16 * i;
    const float bt = w.b[bh * Tp + c * L + t];
    float dm[4], mx = NEG_INF;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int s = tx + 16 * j;
      dm[j] = s <= t ? bt - bs[j] + is[j] : NEG_INF;
      mx = fmaxf(mx, dm[j]);
    }
    // the 16 threads of a row are 16 aligned lanes of one warp
#pragma unroll
    for (int off = 8; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_inter = bt + m_prev;
    const float m_comb = fmaxf(mx, m_inter);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float wv = acc[i][j] * expf(dm[j] - m_comb);
      Wc[t * L + tx + 16 * j] = wv;
      sum += wv;
    }
#pragma unroll
    for (int off = 8; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (tx == 0) {
      const float iw = expf(m_inter - m_comb);
      w.iw[bh * Tp + c * L + t] = iw;
      w.den[bh * Tp + c * L + t] = fmaxf(fabsf(sum + iw * qn[i]), expf(-m_comb));
    }
  }
}

// ---------------------------------------------------------------- 4. output
// Block (64 columns of v, chunk, sequence): (W v + iw q C) / den.
template <typename TI>
__global__ void __launch_bounds__(NT) output_kernel(In a, Work w) {
  __shared__ float sa[KS][LDS];
  __shared__ float sb[KS][LDS];
  const int e0 = blockIdx.x * TILE, c = blockIdx.y, bh = blockIdx.z, b = bh / a.H, h = bh % a.H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const long long Tp = (long long)a.nc * L;
  const float* Wc = w.W + ((long long)bh * a.nc + c) * L * L;
  const float* Cc = w.C + ((long long)bh * a.nc + c) * a.D * a.D;

  float intra[4][4], inter[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) intra[i][j] = inter[i][j] = 0.f;

  for (int s0 = 0; s0 < L; s0 += KS) {  // W v
    stage_t(sa, [&](int r, int kk) { return Wc[r * L + s0 + kk]; });
    stage(sb, [&](int kk, int n) {
      const int t = c * L + s0 + kk, e = e0 + n;
      return (t < a.T && e < a.D) ? to_f32(row<TI>(a.v, a.v_sb, a.v_st, a.v_sh, b, t, h)[e]) : 0.f;
    });
    __syncthreads();
    tile_fma(sa, sb, intra, ty, tx);
    __syncthreads();
  }
  if (c > 0) {  // q C; the state entering the first chunk is 0
    for (int d0 = 0; d0 < a.D; d0 += KS) {
      stage_t(sa, [&](int r, int kk) {
        const int t = c * L + r, d = d0 + kk;
        return (t < a.T && d < a.D) ? to_f32(row<TI>(a.q, a.q_sb, a.q_st, a.q_sh, b, t, h)[d])
                                    : 0.f;
      });
      stage(sb, [&](int kk, int n) {
        const int d = d0 + kk, e = e0 + n;
        return (d < a.D && e < a.D) ? Cc[(long long)d * a.D + e] : 0.f;
      });
      __syncthreads();
      tile_fma(sa, sb, inter, ty, tx);
      __syncthreads();
    }
  }

  TI* out = static_cast<TI*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = c * L + ty + 16 * i;
    if (t >= a.T) continue;
    const float iw = w.iw[bh * Tp + t], den = w.den[bh * Tp + t];
    TI* o = out + (((long long)b * a.T + t) * a.H + h) * a.D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      if (e < a.D) store(o + e, (intra[i][j] + iw * inter[i][j]) / den);
    }
  }
}

long long chunks(int T) { return (T + L - 1) / L; }

template <typename TI>
cudaError_t launch(const In& a, const Work& w, int BH, cudaStream_t s) {
  const int nd = (a.D + TILE - 1) / TILE;
  gates_scan_kernel<L><<<BH, GATES_THREADS, 0, s>>>(a, Gates{w.b, w.kw, w.decay, w.m_in});
  states_kernel<TI><<<dim3(nd * nd, BH), NT, 0, s>>>(a, w);
  scores_kernel<TI><<<dim3(a.nc, BH), NT, 0, s>>>(a, w);
  output_kernel<TI><<<dim3(nd, a.nc, BH), NT, 0, s>>>(a, w);
  return cudaGetLastError();
}

}  // namespace

// ============================ bf16 route: wgmma + TMA ============================

namespace wg {

constexpr int L = 128;          // chunk length: two consumer warpgroups of 64 rows
constexpr int NTHREADS = 384;   // warpgroup 0 loads (one thread), 1 and 2 compute
constexpr int CONSUMERS = 256;  // every consumer thread releases a stage
constexpr int LOADER_REGS = 40, CONSUMER_REGS = 232;
constexpr int ATOM = 128;       // bytes of one swizzled row: 64 bf16 columns
constexpr int BOX = L * ATOM;   // one TMA box of q, k or v: 64 columns x L rows (16 KB)
constexpr int CBOX = 64 * ATOM; // one box of the state scratch: 64 columns x 64 rows (8 KB)
constexpr int TILE = 128;       // edge of a tile of C (states), columns of v (output)
constexpr int PLAN_LEN = 14;    // per tensor: dims[4], byte strides[3], box[4], slots[3]
constexpr int MAX_D = 512;

// states pass: a 2-deep ring of k and v chunks (two boxes each); per
// consumer warpgroup a staging buffer for the state's TMA store (hi and lo,
// two boxes each) and the key weights of two chunks; then a full and an empty
// barrier per stage
constexpr int S_STAGES = 2;
constexpr int S_STAGE = 4 * BOX;
constexpr int S_OUT = 4 * CBOX;
constexpr int S_KWS = 2 * L * 4;
constexpr int S_SMEM = 1024 + S_STAGES * S_STAGE + 2 * S_OUT + 2 * S_KWS + 16 * S_STAGES;
// output pass: q (D/64 boxes), a 3-deep ring of 32 KB stages (a k box, a slab
// of the state's hi and lo, or the v tile, which then holds the output tile
// for its TMA store), the barriers (one per box of q, then full and empty per
// stage), the chunk's column keys i_s - b_s (L floats)
constexpr int O_STAGES = 3;
constexpr int O_STAGE = 2 * BOX;
constexpr int o_smem(int D) {
  return 1024 + (D / 64) * BOX + O_STAGES * O_STAGE + 8 * (MAX_D / 64 + 2 * O_STAGES) + 4 * L;
}
static_assert(S_SMEM <= 232448 && o_smem(MAX_D) <= 232448, "tiles do not fit in one SM's shared memory");

// The tensor-map dimension (1..3) of a tensor's head, row and batch axes: the
// wrapper orders them by stride.
struct Slots {
  int h, s, b;
};

__device__ __forceinline__ int pick(int dim, Slots sl, int h, int row, int b) {
  return dim == sl.h ? h : (dim == sl.s ? row : b);
}

__host__ __device__ constexpr int tiles(int D) { return (D + TILE - 1) / TILE; }  // 128-column tiles of C

struct Args {
  const float* ig;  // (B, T, H) input gate, strided
  long long i_sb, i_st, i_sh;
  __nv_bfloat16* out;  // contiguous (B, T, H, D)
  // the state entering each chunk, (BH * nc, 2 * nt, D, 128): for hi, then lo,
  // each 128-column tile of C as D rows of 256 bytes, so that a slab of 64
  // rows of a tile is 16 KB of contiguous memory
  __nv_bfloat16* C;
  const float* b;      // the gates pass's outputs, (BH, nc * L) and (BH, nc)
  const float* kw;
  const float* decay;
  const float* m_in;
  float* n;  // (BH, nc, D): n entering each chunk
  int T, H, D, nc;
  float scale;
  Slots q, k, v, o;  // o: the output's map
};

// One 64-column, L-row box of a (B, T, H, D) operand at column col, row row.
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map, uint32_t bar, Slots sl,
                                         int col, int h, int row, int b) {
  hopper::tma_load_4d(dst, map, bar, col, pick(1, sl, h, row, b), pick(2, sl, h, row, b), pick(3, sl, h, row, b));
}

__device__ __forceinline__ void bar_wg(int w) {  // the 128 threads of consumer warpgroup w
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half: the lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

// x - bf16(x) of a pair packed by pack_bf16, rounded to bf16 again
__device__ __forceinline__ uint32_t pack_lo(float x0, float x1, uint32_t hi) {
  const float2 h = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&hi));
  return pack_bf16(x0 - h.x, x1 - h.y);
}

// ---------------------------------------------------------------- 2. states

// Four 8 x 8 bf16 matrices from shared memory, transposed, into wgmma's
// register-A layout: lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void states_consume(const CUtensorMap* tc, const Args& a, uint8_t* sm, uint32_t base,
                                               uint32_t out, float* kws, uint32_t full, uint32_t empty, int w,
                                               int d0, int e0, int bh) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;  // rows r0 and r0 + 8 of the warpgroup's 64
  const int kcol = 2 * (lane % 4);           // first of two columns in each 8-column block
  const long long Tp = (long long)a.nc * L;
  const bool carries_n = e0 == 0;
  const int nt = tiles(a.D);
  uint8_t* const out_p = sm + (out - base);
  // this lane's ldmatrix row: matrix m = lane / 8 of a k step holds steps j
  // 8 (m / 2) + (0..7) at this warp's 8 rows 8 (m % 2) + (0..7) of C (columns
  // of k), a 16-byte piece of each 128-byte row of the TMA box
  const int jl = 8 * (lane / 16) + lane % 8, piece = 2 * (t / 32) + (lane / 8) % 2;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float np[2] = {0.f, 0.f};  // this thread's part of n at rows r0 and r0 + 8

  // the chunk's key weights in shared memory (kws[c % 2]) and its decay, a
  // chunk ahead: each thread loads one weight of the next chunk while this one runs
  float dec = 0.f;
  if (a.nc > 1) {
    kws[t] = a.kw[bh * Tp + t];
    dec = a.decay[(long long)bh * a.nc];
  }
  bar_wg(w);

  for (int c = 0; c < a.nc; ++c) {
    float kwn = 0.f, decn = 0.f;
    if (c + 1 < a.nc - 1) {
      kwn = a.kw[bh * Tp + (long long)(c + 1) * L + t];
      decn = a.decay[(long long)bh * a.nc + c + 1];
    }
    if (c > 0) {  // the state entering chunk c (the one entering chunk 0 is 0)
      // as bf16 hi and lo into the staging buffer, laid out as the state map's
      // swizzled boxes, then stored by TMA while the walk goes on
      if (t == 0) hopper::bulk_wait_read<0>();  // the previous store has read the buffer
      bar_wg(w);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int dr = r0 + 8 * hf;  // row of the warpgroup's 64
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j) {
          const int off = (j / 8) * CBOX + dr * ATOM + (((j % 8) ^ (dr % 8)) * 16) + kcol * 2;
          const uint32_t hi = pack_bf16(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
          *reinterpret_cast<uint32_t*>(out_p + off) = hi;
          *reinterpret_cast<uint32_t*>(out_p + 2 * CBOX + off) =
              pack_lo(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1], hi);
        }
      }
      hopper::fence_proxy_async();  // these writes, then the TMA store that reads them
      bar_wg(w);
      if (t == 0) {  // rows or columns past D lie outside the map: not written
        const int slot = bh * a.nc + c;
        for (int hl = 0; hl < 2; ++hl)
          for (int cb = 0; cb < 2; ++cb)
            hopper::tma_store_4d(tc, out + (2 * hl + cb) * CBOX, 64 * cb, d0 + 64 * w, hl * nt + e0 / TILE, slot);
        hopper::bulk_commit();
      }
      if (carries_n) {  // n: the 4 lanes' parts of each row, in a fixed order
        float nr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          nr[r] = np[r] + __shfl_xor_sync(0xffffffffu, np[r], 1);
          nr[r] += __shfl_xor_sync(0xffffffffu, nr[r], 2);
        }
        float* nc_ = a.n + ((long long)bh * a.nc + c) * a.D + d0 + 64 * w;
        if (lane % 4 == 0)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            if (d0 + 64 * w + r0 + 8 * r < a.D) nc_[r0 + 8 * r] = nr[r];
      }
    }
    if (c == a.nc - 1) break;  // the state after the last chunk is not used

    // (kw k / sqrt(D))^T as wgmma A fragments, hi and lo, straight from the
    // TMA box by ldmatrix.trans: rows r0, r0 + 8 (columns of k), steps
    // 16 kk + kcol + (0, 1, 8, 9)
    const int s = c % S_STAGES;
    const uint32_t st = base + s * S_STAGE;
    const uint32_t kb = st + w * BOX;  // this warpgroup's 64 columns of k, L rows
    const float* kwc = kws + (c % 2) * L;
    hopper::mbar_wait(full + 8 * s, (c / S_STAGES) & 1);
    np[0] *= dec;
    np[1] *= dec;
    uint32_t ah[L / 16][4], al[L / 16][4];
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      const int j = 16 * kk + jl;
      ldsm_x4_trans(ah[kk], kb + j * ATOM + ((piece ^ (j % 8)) * 16));
      const float f0 = a.scale * kwc[16 * kk + kcol], f1 = a.scale * kwc[16 * kk + kcol + 1];
      const float f8 = a.scale * kwc[16 * kk + kcol + 8], f9 = a.scale * kwc[16 * kk + kcol + 9];
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // q: row r0 + 8 (q % 2), steps + 8 (q / 2)
        const float2 kv = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&ah[kk][q]));
        const float v0 = kv.x * (q < 2 ? f0 : f8), v1 = kv.y * (q < 2 ? f1 : f9);
        np[q % 2] += v0 + v1;
        ah[kk][q] = pack_bf16(v0, v1);
        al[kk][q] = pack_lo(v0, v1, ah[kk][q]);
      }
    }

#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] *= dec;
    hopper::wgmma_fence();
    const uint32_t vb = st + 2 * BOX;  // v: 2 blocks of 64 columns, L rows each
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {  // 16 steps j a product; v MN-major
      const uint64_t db = hopper::sw128_desc(vb + kk * 16 * ATOM, BOX, 1024);
      hopper::wgmma_rs_m64n128k16<1>(acc, ah[kk], db, 1);
      hopper::wgmma_rs_m64n128k16<1>(acc, al[kk], db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(ah);
    hopper::fence_regs(al);
    hopper::mbar_arrive(empty + 8 * s);
    if (c + 1 < a.nc - 1) kws[((c + 1) % 2) * L + t] = kwn;  // read after the next chunk's first barrier
    dec = decn;
  }
  if (t == 0) hopper::bulk_wait<0>();  // the last store done before the block's memory goes
}

__global__ void __launch_bounds__(NTHREADS, 1)
    states_wgmma_kernel(const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tc, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  uint8_t* const sm = smem_raw + (base - raw);
  const uint32_t out = base + S_STAGES * S_STAGE, kws = out + 2 * S_OUT;
  const uint32_t full = kws + 2 * S_KWS, empty = full + 8 * S_STAGES;
  const int nt = tiles(a.D);
  const int d0 = (blockIdx.x / nt) * TILE, e0 = (blockIdx.x % nt) * TILE;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S_STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    hopper::regs_shrink<LOADER_REGS>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tv);
      for (int c = 0; c < a.nc - 1; ++c) {  // the chunks whose update a later chunk reads
        const int s = c % S_STAGES;
        const uint32_t st = base + s * S_STAGE;
        hopper::mbar_wait(empty + 8 * s, ((c / S_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full + 8 * s, S_STAGE);
        for (int cb = 0; cb < 2; ++cb) {
          load_box(st + cb * BOX, &tk, full + 8 * s, a.k, d0 + 64 * cb, h, c * L, b);
          load_box(st + (2 + cb) * BOX, &tv, full + 8 * s, a.v, e0 + 64 * cb, h, c * L, b);
        }
      }
    }
  } else {
    hopper::regs_grow<CONSUMER_REGS>();
    states_consume(&tc, a, sm, base, out + (wg - 1) * S_OUT,
                   reinterpret_cast<float*>(sm + (kws - base) + (wg - 1) * S_KWS), full, empty, wg - 1, d0, e0, bh);
  }
}

// ---------------------------------------------------------------- 3. output

__device__ __forceinline__ void output_consume(const Args& a, uint8_t* sm, uint32_t base, uint32_t q_full,
                                               uint32_t full, uint32_t empty, float* key, const CUtensorMap* to,
                                               int w, int c, int bh) {
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;
  const int kcol = 2 * (t % 4);
  const int b = bh / a.H, h = bh % a.H;
  const int nb = a.D / 64;
  const long long Tp = (long long)a.nc * L;
  const uint32_t sq = base, ring = base + nb * BOX;
  int item = 0;  // the ring's items in the loader's order: per column tile the state's slabs, (the
                 // first tile only) the k boxes, then v
  auto stage = [&](int i) { return ring + (i % O_STAGES) * O_STAGE; };
  auto wait_full = [&](int i) { hopper::mbar_wait(full + 8 * (i % O_STAGES), (i / O_STAGES) & 1); };
  auto release = [&](int i) { hopper::mbar_arrive(empty + 8 * (i % O_STAGES)); };

  if (w == 0) {  // the chunk's column keys; past T the gates pass took i = 0
    const int s = c * L + t;
    key[t] = (s < a.T ? a.ig[b * a.i_sb + s * a.i_st + h * a.i_sh] : 0.f) - a.b[bh * Tp + s];
  }
  asm volatile("bar.sync 3, 256;\n" ::: "memory");

  // acc = q C over the state's slabs for one column tile: D/16 steps, 4 to a
  // slab of 64 rows of C (hi, then lo), C MN-major; issued, the last slab's
  // products left running. The state entering chunk 0 is 0: no slabs.
  float acc[64];
  auto issue_qc = [&]() {
    for (int i = 0; i < nb; ++i, ++item) {
      hopper::mbar_wait(q_full + 8 * i, 0);  // q's box i (passes at once after the first tile)
      wait_full(item);
      const uint32_t cst = stage(item);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = hopper::sw128_desc(sq + i * BOX + w * 64 * ATOM + kk * 32, 16, 1024);
        const uint64_t dh = hopper::sw128_desc(cst + kk * 16 * ATOM, CBOX, 1024);
        if (i == 0 && kk == 0) hopper::wgmma_ss_m64n128k16_set<0, 1>(acc, da, dh);
        else hopper::wgmma_ss_m64n128k16<0, 1>(acc, da, dh, 1);
        hopper::wgmma_ss_m64n128k16<0, 1>(acc, da, hopper::sw128_desc(cst + 2 * CBOX + kk * 16 * ATOM, CBOX, 1024), 1);
      }
      hopper::wgmma_commit();
      if (i > 0) {
        hopper::wgmma_wait<1>();
        release(item - 1);
      }
    }
  };

  // the first column tile's q C, then S = q k^T (D/16 steps, 4 to a k box;
  // both operands K-major), so that the state streams in from the start;
  // each box of q is awaited where it is first read
  float sc[64];
  hopper::wgmma_fence();
  if (c > 0) issue_qc();
  // q.n for this thread's two rows, in fp32 on the CUDA cores while the
  // products run and k streams in: the 4 lanes of a row take a quarter of D each
  float qn[2] = {0.f, 0.f};
  if (c > 0) {  // all of q has arrived
    const float* nc_ = a.n + ((long long)bh * a.nc + c) * a.D;
    const int dq = (t % 4) * (a.D / 4);
#pragma unroll 4
    for (int d = dq; d < dq + a.D / 4; d += 8) {  // D / 4 is a multiple of 16: whole 16-byte pieces
      const float4 n0 = *reinterpret_cast<const float4*>(nc_ + d);
      const float4 n1 = *reinterpret_cast<const float4*>(nc_ + d + 4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = 64 * w + r0 + 8 * r;  // piece d / 8 of its 64-column block, swizzled by the row
        const uint4 raw = *reinterpret_cast<const uint4*>(sm + (d / 64) * BOX + row * ATOM +
                                                          ((((d % 64) / 8) ^ (row % 8)) * 16));
        const uint32_t* x = reinterpret_cast<const uint32_t*>(&raw);
        const float2 x0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[0]));
        const float2 x1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[1]));
        const float2 x2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[2]));
        const float2 x3 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[3]));
        qn[r] += x0.x * n0.x + x0.y * n0.y + x1.x * n0.z + x1.y * n0.w + x2.x * n1.x + x2.y * n1.y +
                 x3.x * n1.z + x3.y * n1.w;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 1);
      qn[r] += __shfl_xor_sync(0xffffffffu, qn[r], 2);
    }
  }
  for (int i = 0; i < nb; ++i, ++item) {
    if (c == 0) hopper::mbar_wait(q_full + 8 * i, 0);
    wait_full(item);
    const uint32_t kst = stage(item);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::sw128_desc(sq + i * BOX + w * 64 * ATOM + kk * 32, 16, 1024);
      const uint64_t db = hopper::sw128_desc(kst + kk * 32, 16, 1024);
      if (i == 0 && kk == 0) hopper::wgmma_ss_m64n128k16_set<0, 0>(sc, da, db);
      else hopper::wgmma_ss_m64n128k16<0, 0>(sc, da, db, 1);
    }
    hopper::wgmma_commit();
    if (item > 0) {
      hopper::wgmma_wait<1>();
      release(item - 1);
    }
  }

  hopper::wgmma_wait<0>();
  hopper::fence_regs(sc);
  hopper::fence_regs(acc);
  release(item - 1);

  // W = S / sqrt(D) e^{b_t - b_s + i_s - m_t} on s <= t, its row sums and the
  // denominator, in fp32; sc[4j + e] is row tr[e >> 1], column 8j + kcol + (e & 1)
  const int tr[2] = {64 * w + r0, 64 * w + r0 + 8};  // rows of the chunk
  const float m_prev = a.m_in[(long long)bh * a.nc + c];
  float bt[2], mc[2], iw[2], den[2], inv[2], mx[2] = {NEG_INF, NEG_INF}, rs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) bt[r] = a.b[bh * Tp + (long long)c * L + tr[r]];
#pragma unroll
  for (int j = 0; j < L / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + kcol + (e & 1), r = e >> 1;
      if (col <= tr[r]) mx[r] = fmaxf(mx[r], bt[r] + key[col]);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row is held by 4 lanes
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mc[r] = fmaxf(mx[r], bt[r] + m_prev);
    iw[r] = expf(bt[r] + m_prev - mc[r]);
  }
#pragma unroll
  for (int j = 0; j < L / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + kcol + (e & 1), r = e >> 1;
      const float wv = col <= tr[r] ? sc[4 * j + e] * a.scale * expf(bt[r] + key[col] - mc[r]) : 0.f;
      sc[4 * j + e] = wv;
      rs[r] += wv;
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    den[r] = fmaxf(fabsf(rs[r] + iw[r] * qn[r]), expf(-mc[r]));
    inv[r] = __frcp_rn(den[r]);  // correctly rounded: x * inv is within 1.5 fp32 ulps of x / den
  }
  // W as wgmma's A fragments (the accumulator layout), hi and lo, kept for
  // every column tile
  uint32_t ph[L / 16][4], pl[L / 16][4];
#pragma unroll
  for (int kk = 0; kk < L / 16; ++kk)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      ph[kk][p] = pack_bf16(sc[8 * kk + 2 * p], sc[8 * kk + 2 * p + 1]);
      pl[kk][p] = pack_lo(sc[8 * kk + 2 * p], sc[8 * kk + 2 * p + 1], ph[kk][p]);
    }

  for (int e0 = 0; e0 < a.D; e0 += TILE) {
    if (c > 0) {  // acc = e^{b_t + m - m_t} q C
      if (e0 > 0) {
        hopper::wgmma_fence();
        issue_qc();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        release(item - 1);
      }
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j) {
        acc[4 * j] *= iw[0];
        acc[4 * j + 1] *= iw[0];
        acc[4 * j + 2] *= iw[1];
        acc[4 * j + 3] *= iw[1];
      }
    }

    // acc += W v: W hi then lo, 16 keys a step; v MN-major
    wait_full(item);
    const uint32_t vst = stage(item);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < L / 16; ++kk) {
      const uint64_t db = hopper::sw128_desc(vst + kk * 16 * ATOM, BOX, 1024);
      hopper::wgmma_rs_m64n128k16<1>(acc, ph[kk], db, c > 0 || kk > 0);
      hopper::wgmma_rs_m64n128k16<1>(acc, pl[kk], db, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(ph);
    hopper::fence_regs(pl);

    // out = acc / den, rounded once to bf16. Once both warpgroups are done
    // with the v tile, each writes its 64 rows into half of that stage in the
    // output map's swizzled layout (two boxes of 64 columns) and one of its
    // threads stores them by TMA, which clips rows past T and columns past D.
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
    const uint32_t ost = vst + w * 2 * CBOX;
    uint8_t* const op = sm + (ost - base);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = r0 + 8 * r;
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
        *reinterpret_cast<uint32_t*>(op + (j / 8) * CBOX + rr * ATOM + (((j % 8) ^ (rr % 8)) * 16) + kcol * 2) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
    hopper::fence_proxy_async();  // these writes, then the TMA store that reads them
    bar_wg(w);
    if (t == 0) {
      const int row = c * L + 64 * w;
      for (int cb = 0; cb < 2; ++cb)
        hopper::tma_store_4d(to, ost + cb * CBOX, e0 + 64 * cb, pick(1, a.o, h, row, b), pick(2, a.o, h, row, b),
                             pick(3, a.o, h, row, b));
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();  // the stage is read before it is released
    }
    bar_wg(w);
    release(item++);
  }
}

__global__ void __launch_bounds__(NTHREADS, 1)
    output_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tc,
                        const __grid_constant__ CUtensorMap to, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);
  const int nb = a.D / 64;
  const uint32_t ring = base + nb * BOX;
  const uint32_t q_full = ring + O_STAGES * O_STAGE, full = q_full + 8 * (MAX_D / 64),
                 empty = full + 8 * O_STAGES;
  float* const key = reinterpret_cast<float*>(sm + (empty + 8 * O_STAGES - base));
  const int c = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh % a.H;

  if (threadIdx.x == 0) {
    for (int i = 0; i < nb; ++i) hopper::mbar_init(q_full + 8 * i, 1);
    for (int s = 0; s < O_STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    hopper::regs_shrink<LOADER_REGS>();
    if (threadIdx.x == 0) {
      hopper::tma_prefetch_map(&tk);
      hopper::tma_prefetch_map(&tc);
      hopper::tma_prefetch_map(&tv);
      const int row = c * L;
      auto load_q = [&](int i) {  // box i of q, on a barrier of its own
        hopper::mbar_expect_tx(q_full + 8 * i, BOX);
        load_box(base + i * BOX, &tq, q_full + 8 * i, a.q, 64 * i, h, row, b);
      };
      int item = 0;
      auto acquire = [&](int bytes) {  // the next stage, once free, expecting `bytes`
        const int s = item % O_STAGES;
        hopper::mbar_wait(empty + 8 * s, ((item / O_STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full + 8 * s, bytes);
        ++item;
        return s;
      };
      const int slot = bh * a.nc + c, nt = tiles(a.D);
      for (int e0 = 0; e0 < a.D; e0 += TILE) {
        if (c > 0) {
          for (int i = 0; i < nb; ++i) {  // rows 64 i.. of C: hi, then lo, 2 boxes of 64 columns each
            if (e0 == 0) load_q(i);  // each box of q just ahead of the first ring item that reads it
            const int s = acquire(4 * CBOX);
            for (int hl = 0; hl < 2; ++hl)
              for (int cb = 0; cb < 2; ++cb)
                hopper::tma_load_4d(ring + s * O_STAGE + (2 * hl + cb) * CBOX, &tc, full + 8 * s, 64 * cb, 64 * i,
                                    hl * nt + e0 / TILE, slot);
          }
        }
        if (e0 == 0)  // S's k boxes after the first column tile's state
          for (int i = 0; i < nb; ++i) {
            if (c == 0) load_q(i);
            const int s = acquire(BOX);
            load_box(ring + s * O_STAGE, &tk, full + 8 * s, a.k, 64 * i, h, row, b);
          }
        const int s = acquire(2 * BOX);
        for (int cb = 0; cb < 2; ++cb)
          load_box(ring + s * O_STAGE + cb * BOX, &tv, full + 8 * s, a.v, e0 + 64 * cb, h, row, b);
      }
    }
  } else {
    hopper::regs_grow<CONSUMER_REGS>();
    output_consume(a, sm, base, q_full, full, empty, key, &to, wg - 1, c, bh);
  }
}

// A map as the kernels expect it: the box's innermost extent 64 columns, then
// `rows` rows on the row slot (q, k, v) or on dim 1 (the state scratch).
inline bool box_ok(const long long* p, int rows, bool by_slot) {
  const long long* box = p + 7;
  const int row_dim = by_slot ? (int)p[12] : 1;
  if (box[0] != 64) return false;
  for (int d = 1; d < 4; ++d)
    if (box[d] != (d == row_dim ? rows : 1)) return false;
  return true;
}

int launch(const long long* plan, const void* const ptrs[5], const In& in, const Gates& gw, const Args& a, int BH,
           cudaStream_t stream) {
  for (int i = 0; i < 3; ++i)
    if (!box_ok(plan + i * PLAN_LEN, L, true)) return (int)cudaErrorInvalidValue;
  if (!box_ok(plan + 3 * PLAN_LEN, 64, false) || !box_ok(plan + 4 * PLAN_LEN, 64, true))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[5];
  for (int i = 0; i < 5; ++i) {
    const long long* p = plan + i * PLAN_LEN;
    const int r = hopper::encode_4d(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptrs[i], p, p + 4, p + 7);
    if (r != 0) return 10000 + r;
  }
  const int nt = tiles(a.D);  // tiles of C along each side
  gates_scan_kernel<L><<<BH, GATES_THREADS, 0, stream>>>(in, gw);
  cudaError_t err;
  if (a.nc > 1) {
    err = cudaFuncSetAttribute(states_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM);
    if (err != cudaSuccess) return (int)err;
    states_wgmma_kernel<<<dim3(nt * nt, BH), NTHREADS, S_SMEM, stream>>>(maps[1], maps[2], maps[3], a);
  }
  err = cudaFuncSetAttribute(output_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, o_smem(a.D));
  if (err != cudaSuccess) return (int)err;
  output_wgmma_kernel<<<dim3(a.nc, BH), NTHREADS, o_smem(a.D), stream>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                                         a);
  return (int)cudaGetLastError();
}

long long chunks(int T) { return (T + L - 1) / L; }

}  // namespace wg

extern "C" int ml_chunk() { return L; }

// fp32 floats of the workspace ml_forward needs
extern "C" long long ml_workspace_floats(int B, int T, int H, int D) {
  const long long BH = (long long)B * H, nc = chunks(T), Tp = nc * L;
  return BH * (4 * Tp + 2 * nc + nc * D * D + nc * D + nc * L * L);
}

// dtype (q, k, v and out): 0 = float32, 1 = bfloat16. out is a contiguous
// (B, T, H, D) tensor of q's type; work holds ml_workspace_floats(B, T, H, D)
// floats. Returns the launches' cudaError_t.
extern "C" int ml_forward(const void* q, const void* k, const void* v, const float* ig,
                          const float* fg, void* out, float* work, int dtype,
                          int B, int T, int H, int D,
                          long long q_sb, long long q_st, long long q_sh,
                          long long k_sb, long long k_st, long long k_sh,
                          long long v_sb, long long v_st, long long v_sh,
                          long long i_sb, long long i_st, long long i_sh,
                          long long f_sb, long long f_st, long long f_sh, void* stream) {
  const long long BH = (long long)B * H, nc = chunks(T), Tp = nc * L;
  if (B <= 0 || H <= 0 || T <= 0 || D <= 0 || BH > 65535 || nc > 65535)
    return (int)cudaErrorInvalidValue;
  const In a{q, k, v, ig, fg, out, q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh,
             i_sb, i_st, i_sh, f_sb, f_st, f_sh, T, H, D, (int)nc, (float)(1.0 / sqrt((double)D))};
  Work w;
  w.b = work;
  w.kw = w.b + BH * Tp;
  w.iw = w.kw + BH * Tp;
  w.den = w.iw + BH * Tp;
  w.decay = w.den + BH * Tp;
  w.m_in = w.decay + BH * nc;
  w.n = w.m_in + BH * nc;
  w.W = w.n + BH * nc * D;
  w.C = w.W + BH * nc * L * L;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(a, w, (int)BH, s);
    case 1: return (int)launch<__nv_bfloat16>(a, w, (int)BH, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ------------------------------ bf16 route entry ------------------------------

extern "C" int ml_wgmma_chunk() { return wg::L; }

// Dynamic shared memory of a block of the bf16 route's states pass (pass 0)
// or output pass (pass 1) at head dim D.
extern "C" int ml_wgmma_smem_bytes(int D, int pass) { return pass == 0 ? wg::S_SMEM : wg::o_smem(D); }

// fp32 floats of the workspace ml_forward_bf16 needs: the state scratch
// (BH * nc, 2 * nt, D, 128) bf16 first, nt = D / 128 rounded up (TMA reads it: the base must be 16-byte
// aligned), then n (BH, nc, D), b, kw (BH, nc * 128), decay, m_in (BH, nc).
extern "C" long long ml_wgmma_workspace_floats(int B, int T, int H, int D) {
  const long long BH = (long long)B * H, nc = wg::chunks(T), Tp = nc * wg::L;
  return BH * nc * wg::tiles(D) * wg::TILE * D + BH * (2 * Tp + 2 * nc + nc * D);
}

// bf16 route: q, k, v bf16 (B, T, H, D) with D % 64 == 0 and D <= 512, read
// by TMA through the plan's tensor maps; gates fp32, strided; out a
// contiguous (B, T, H, D) bf16 tensor; work holds ml_wgmma_workspace_floats
// floats. plan: for q, k, v, the state scratch and out, the tensor map's dims
// (innermost first: D, then the head, row and batch axes ordered by stride;
// for the scratch 128, D, 2 * nt, B*H*nc), byte strides of dims 1..3, box, and the
// map dims of the head, row and batch axes (14 numbers each). Returns the launches' cudaError_t, or 10000 + the
// CUresult of a tensor map cuTensorMapEncodeTiled refused.
extern "C" int ml_forward_bf16(const void* q, const void* k, const void* v, const float* ig, const float* fg,
                               void* out, float* work, int B, int T, int H, int D,
                               long long i_sb, long long i_st, long long i_sh,
                               long long f_sb, long long f_st, long long f_sh,
                               const long long* plan, void* stream) {
  const long long BH = (long long)B * H, nc = wg::chunks(T), Tp = nc * wg::L;
  if (B <= 0 || H <= 0 || T <= 0 || D <= 0 || D % 64 || D > wg::MAX_D || BH > 65535 || nc > 65535)
    return (int)cudaErrorInvalidValue;
  const float scale = (float)(1.0 / sqrt((double)D));
  __nv_bfloat16* C = reinterpret_cast<__nv_bfloat16*>(work);
  float* n = work + BH * nc * wg::tiles(D) * wg::TILE * D;  // 16-byte aligned: the output pass reads it as float4
  float* g = n + BH * nc * D;
  const Gates gw{g, g + BH * Tp, g + 2 * BH * Tp, g + 2 * BH * Tp + BH * nc};
  // the gates pass reads only the gates, T, H and nc
  const In in{q, k, v, ig, fg, out, 0, 0, 0, 0, 0, 0, 0, 0, 0,
              i_sb, i_st, i_sh, f_sb, f_st, f_sh, T, H, D, (int)nc, scale};
  const long long* sl = plan + 11;
  const wg::Args a{ig, i_sb, i_st, i_sh, static_cast<__nv_bfloat16*>(out), C, gw.b, gw.kw, gw.decay, gw.m_in, n,
                   T, H, D, (int)nc, scale,
                   {(int)sl[0], (int)sl[1], (int)sl[2]},
                   {(int)sl[wg::PLAN_LEN], (int)sl[wg::PLAN_LEN + 1], (int)sl[wg::PLAN_LEN + 2]},
                   {(int)sl[2 * wg::PLAN_LEN], (int)sl[2 * wg::PLAN_LEN + 1], (int)sl[2 * wg::PLAN_LEN + 2]},
                   {(int)sl[4 * wg::PLAN_LEN], (int)sl[4 * wg::PLAN_LEN + 1], (int)sl[4 * wg::PLAN_LEN + 2]}};
  const void* const ptrs[5] = {q, k, v, C, out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wg::launch(plan, ptrs, in, gw, a, (int)BH, s);
}
