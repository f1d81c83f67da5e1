// Chunkwise mLSTM (xLSTM matrix memory) for Hopper (sm_90a), fp32 state and arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/mlstm.py::mlstm_chunkwise (body
// _mlstm_kernel, pl.pallas_call at mlstm.py:137). It computes the same
// function, the stabilised chunkwise mLSTM of every (batch b, head h): with
// chunks of L steps, b_t the in-chunk inclusive cumsum of logsigmoid(f),
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
// is the accurate one. The chunk length is L = 64; the math does not depend
// on it, only where the sums round. Ragged T is masked: a short last chunk
// reads zeros past T (whose state is never used) and stores nothing there;
// the Pallas kernel asserts T % L == 0 instead.
//
// Design. The TPU kernel carries C (D x D fp32: 1 MB at D = 512) in VMEM
// across a sequential chunk axis, over a grid of B * H sequences. On Hopper C
// fits no SM (227 KB of shared memory), and B * H = 8 sequences at the
// xlstm-350m prefill shape would fill 8 of 132 SMs. So the work is split into
// four launches, each parallel over more than the sequences:
//
//   1. gates   one block per sequence, a thread per step of a chunk, walks
//              the chunks: b (cumsum by a block scan), the key weights
//              e^{g-b_j+i_j-m'}, the decay e^{g+m-m'} and the m entering each
//              chunk. Scalars only: B*H*T floats.
//   2. states  one block per (sequence, 64 x 64 tile of C) walks the chunks
//              with its tile in registers, writing the state entering every
//              chunk to a scratch of (B*H, T/L, D, D) fp32 (256 MB at the
//              prefill shape) and applying the chunk's rank-L update: a 64 x
//              64 x L product of key-weighted k^T and v from shared memory.
//              The blocks of the first column of tiles also carry n.
//   3. scores  one block per (sequence, chunk): the L x L gate-decayed
//              q.k^T (a reduction over D in slabs of 32), its row sums and
//              q.n, giving W, e^{b+m-m_t} and the denominator of every step.
//   4. output  one block per (sequence, chunk, 64 columns of v): W v and
//              q C over the state entering the chunk, each a 64 x 64 tile
//              product from shared memory, then divided by the denominator.
//
// At B 2, T 2048, H 4, D 512 that is 8, 512, 256 and 2048 blocks of 256
// threads; every tile product gives a thread a 4 x 4 piece of the output
// (rows ty + 16 i, columns tx + 16 j) and reads its operands from shared
// memory rows padded to 65 floats, so the transposed stores of row-major
// inputs meet no bank conflicts.
//
// What bounds it. At the prefill shape the function does ~19 GFLOP (two L x
// L x D products a chunk for the intra-chunk part, two L x D x D for the
// state) and moves ~34 MB in bf16, so its bound is operations: ~0.29 ms on
// the fp32 CUDA cores, ~0.02 ms at the bf16 tensor rate. This first version
// runs fp32 FMAs on the CUDA cores, two shared-memory loads to every two
// FMAs; the state scratch adds ~0.5 GB of HBM traffic. Tensor cores are later
// work. PERF.md has its measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int L = 64;        // chunk length
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

// fp32 scratch, carved from one workspace by ml_workspace_floats' layout
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

// ---------------------------------------------------------------- 1. gates
// One block of L threads per sequence; thread j owns step j of each chunk.
__global__ void __launch_bounds__(L) gates_kernel(In a, Work w) {
  __shared__ float sb[L], sr[L];
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, j = threadIdx.x;
  const long long Tp = (long long)a.nc * L;
  float m_prev = NEG_INF;
  for (int c = 0; c < a.nc; ++c) {
    const int t = c * L + j;
    float fv = 0.f, iv = 0.f;  // past T: finite, and only the unused last state sees them
    if (t < a.T) {
      fv = a.fg[b * a.f_sb + t * a.f_st + h * a.f_sh];
      iv = a.ig[b * a.i_sb + t * a.i_st + h * a.i_sh];
    }
    sb[j] = log_sigmoid(fv);
    __syncthreads();
#pragma unroll
    for (int off = 1; off < L; off *= 2) {  // inclusive scan
      const float add = j >= off ? sb[j - off] : 0.f;
      __syncthreads();
      sb[j] += add;
      __syncthreads();
    }
    const float bj = sb[j], g = sb[L - 1];
    const float key = g - bj + iv;
    sr[j] = key;
    __syncthreads();
#pragma unroll
    for (int off = L / 2; off > 0; off /= 2) {
      if (j < off) sr[j] = fmaxf(sr[j], sr[j + off]);
      __syncthreads();
    }
    const float m_new = fmaxf(g + m_prev, sr[0]);
    w.b[bh * Tp + t] = bj;
    w.kw[bh * Tp + t] = expf(key - m_new);
    if (j == 0) {
      w.m_in[(long long)bh * a.nc + c] = m_prev;
      w.decay[(long long)bh * a.nc + c] = expf(g + m_prev - m_new);
    }
    m_prev = m_new;
    __syncthreads();  // every thread has read sb and sr before the next chunk writes them
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
  gates_kernel<<<BH, L, 0, s>>>(a, w);
  states_kernel<TI><<<dim3(nd * nd, BH), NT, 0, s>>>(a, w);
  scores_kernel<TI><<<dim3(a.nc, BH), NT, 0, s>>>(a, w);
  output_kernel<TI><<<dim3(nd, a.nc, BH), NT, 0, s>>>(a, w);
  return cudaGetLastError();
}

}  // namespace

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
