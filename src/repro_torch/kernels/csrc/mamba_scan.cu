// Mamba selective-SSM scan for Hopper (sm_90a): one pass over T a block,
// fp32 state and arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py::mamba_scan (body
// _mamba_kernel at mamba_scan.py:30, pl.pallas_call at mamba_scan.py:91). It
// computes the same function, Mamba-1's selective scan over T for every
// (batch b, channel d):
//
//   h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h_t[n] * C_t[n] + D[d] * x_t
//
// for x, dt (Bsz, T, Di) and y in x's type (fp32 or bf16), B, C (Bsz, T, N) in
// fp32 or bf16 with strided rows (slices of one projection), A (Di, N) and D
// (Di) in fp32, N from 1 to 64. The state h starts at 0 and stays fp32; D * x
// is added in fp32 before the one rounding to y's type. Ragged T and Di are
// masked here (the Pallas kernel asserts Di % 512 == 0 and T % 128 == 0).
//
// Design: one launch over (tile of CB channels, batch row); each block scans
// all of T for its tile, the state held in registers from the first step to
// the last, so every exponential is taken once and the result does not depend
// on scheduling. At jamba's prefill shape (Bsz 2, Di 8192) that is 256 blocks,
// two an SM. Cutting T into chunks with a carried state was measured and lost
// at jamba's shapes: a chunk's output pass must recompute its decays, which
// fit in no SM (PERF.md).
//
// Inside a block. A channel's N states spread over L lanes of a warp, S = 4
// each (N padded to L * S with A = B = C = 0): L = 4 up to N = 16, 8 up to
// 32, 16 up to 64. Each thread holds two channels (CPT), so a warp's B and C
// loads serve twice the work, and each lane has 8 independent state chains:
// 128 threads make a tile of 64 channels at L = 4. A stage of TS = 16 steps
// is staged in shared memory: dt and x transposed, (CB, TS + 4), so a lane
// reads 4 steps of a channel in one access and a stager writes its rows of
// one channel in one; B and C as (TS, NP) slabs shared by every channel of
// the block. The next stage's x, dt, B and C are loaded into registers
// before the current stage's steps and written to the other buffer after
// them, so one __syncthreads a stage suffices. A step costs a lane, per
// state, one multiply dt * (A log2(e)) (A scaled once per thread), one
// ex2.approx, a multiply u * B and two FMAs, u = dt * x once per channel.
// The lane writes its partial y of every 4 steps to its row of s_red; once a
// stage, the L lanes of a channel each sum the others' partials for TS / L
// steps, add D * x and store y.
//
// What bounds it. At jamba's prefill shape (N 16, bf16) the function moves
// ~202 MB (x, dt read, y written): 0.060 ms at 3.35 TB/s, the bytes bound.
// Its 537 M exponentials run on the special-function units, 16 per SM per
// clock: 0.128 ms at 1.98 GHz, the floor of a kernel that takes one hardware
// exponential per (b, t, d, n), which this design meets. The arithmetic
// issues ~5 instructions an element besides, at two warps on each scheduler,
// so the steps' latency is only partly hidden: the kernel runs at about 1.8x
// the exponential floor on an H100 80GB HBM3 at 700 W (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int NT = 128;        // threads per block
constexpr int CPT = 2;         // channels a thread holds
constexpr int S = 4;           // states of each channel a lane holds
constexpr int TS = 16;         // steps per stage: one y reduction
constexpr int DP = TS + 4;     // row pitch of the transposed dt and x slabs (16-byte rows)
constexpr int MAX_STATES = 64;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* x;
  const void* dt;
  const float* A;  // (Di, N), contiguous
  const void* B;
  const void* C;
  const float* D;  // (Di,)
  void* y;         // (Bsz, T, Di), contiguous
  int Bsz, T, Di, N, ntiles;
  long long x_sb, x_st;  // element strides of the batch and time axes (channel stride 1)
  long long dt_sb, dt_st;
  long long b_sb, b_st;
  long long c_sb, c_st;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// K consecutive floats (aligned to K floats) in one access
template <int K>
__device__ __forceinline__ void ld_vec(const float* p, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (K == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int K>
__device__ __forceinline__ void st_vec(float* p, const float (&v)[K]) {
  if constexpr (K == 4) *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else if constexpr (K == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else *p = v[0];
}

template <typename TX, typename TB, int L>
__global__ void __launch_bounds__(NT, 2) mamba_scan_kernel(Args a) {
  constexpr int CG = NT / L;        // channel groups: a thread holds channels g and g + CG
  constexpr int CB = CPT * CG;      // channels per block
  constexpr int NP = L * S;         // states per channel, padded
  constexpr int KX = TS * CB / NT;  // consecutive rows of x and dt a thread stages
  constexpr int KB = TS * NP / NT;  // B and C elements a thread stages
  constexpr int SPL = TS / L;       // steps of y a lane finishes per stage and channel
  constexpr int RP = CPT * TS + 4;  // row pitch of the y partial sums
  static_assert(KX % 4 == 0 || KX <= 2, "stage rows");
  static_assert(KB >= 1 && TS % L == 0 && TS % 4 == 0, "stage shape");

  // dt and x transposed, (CB, DP): a lane reads 4 steps of a channel at
  // once, a stager writes its KX rows of one channel at once; B and C as
  // (TS, NP); each thread's partial y sums (both channels) as a row of s_red
  __shared__ __align__(16) float s_dt[2][CB * DP];
  __shared__ __align__(16) float s_x[2][CB * DP];
  __shared__ __align__(16) float s_B[2][TS * NP];
  __shared__ __align__(16) float s_C[2][TS * NP];
  __shared__ __align__(16) float s_red[NT * RP];

  const int b = blockIdx.x / a.ntiles;
  const int d0 = blockIdx.x % a.ntiles * CB;
  const int T = a.T;

  const int lane = threadIdx.x % L;  // which S states of its channels
  int cl[CPT];                       // its channels within the tile
  bool live[CPT];
  float Dd[CPT], A2[CPT][S], h[CPT][S];
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    cl[k] = threadIdx.x / L + k * CG;
    const int d = d0 + cl[k];
    live[k] = d < a.Di;
    Dd[k] = live[k] ? a.D[d] : 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int n = lane * S + s;
      h[k][s] = 0.f;
      // a padded state (n >= N) has A = 0 and B = C = 0: it stays 0 and adds 0
      A2[k][s] = (live[k] && n < a.N) ? a.A[(long long)d * a.N + n] * LOG2E : 0.f;
    }
  }
  const int sj = threadIdx.x % CB;       // the channel this thread stages
  const int sr = threadIdx.x / CB * KX;  // its first row in a stage
  const bool sj_live = d0 + sj < a.Di;

  const TX* xs = static_cast<const TX*>(a.x) + b * a.x_sb + d0 + sj;
  const TX* dts = static_cast<const TX*>(a.dt) + b * a.dt_sb + d0 + sj;
  const TB* Bb = static_cast<const TB*>(a.B) + b * a.b_sb;
  const TB* Cb = static_cast<const TB*>(a.C) + b * a.c_sb;
  TX* yb = static_cast<TX*>(a.y) + (long long)b * T * a.Di + d0;

  // one stage's x, dt, B and C, raw, in registers (0 past T, Di and N)
  TX rx[KX], rdt[KX];
  TB rB[KB], rC[KB];
  auto load = [&](int ts) {
    const int tr = ts + sr;
    const TX* px = xs + tr * a.x_st;
    const TX* pd = dts + tr * a.dt_st;
    if (sj_live && tr + KX <= T) {
#pragma unroll
      for (int r = 0; r < KX; ++r) rx[r] = px[r * a.x_st], rdt[r] = pd[r * a.dt_st];
    } else {
#pragma unroll
      for (int r = 0; r < KX; ++r) {
        const bool ok = sj_live && tr + r < T;
        rx[r] = ok ? px[r * a.x_st] : TX(0.f);
        rdt[r] = ok ? pd[r * a.dt_st] : TX(0.f);
      }
    }
#pragma unroll
    for (int r = 0; r < KB; ++r) {
      const int k = threadIdx.x + r * NT;
      const int t = ts + k / NP, n = k % NP;
      const bool ok = t < T && n < a.N;
      rB[r] = ok ? Bb[t * a.b_st + n] : TB(0.f);
      rC[r] = ok ? Cb[t * a.c_st + n] : TB(0.f);
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int r = 0; r < KX; r += (KX >= 4 ? 4 : KX)) {
      constexpr int V = KX >= 4 ? 4 : KX;
      float xv[V], dv[V];
#pragma unroll
      for (int v = 0; v < V; ++v) xv[v] = to_f32(rx[r + v]), dv[v] = to_f32(rdt[r + v]);
      st_vec<V>(&s_dt[buf][sj * DP + sr + r], dv);
      st_vec<V>(&s_x[buf][sj * DP + sr + r], xv);
    }
#pragma unroll
    for (int r = 0; r < KB; ++r) {
      const int k = threadIdx.x + r * NT;
      s_B[buf][k] = to_f32(rB[r]);
      s_C[buf][k] = to_f32(rC[r]);
    }
  };

  float* red = s_red + threadIdx.x * RP;
  const int nst = (T + TS - 1) / TS;
  load(0);
  store(0);
  __syncthreads();
  for (int st = 0; st < nst; ++st) {
    // the steps of stage st from buffer buf, the next stage loaded meanwhile
    // and stored into the other buffer
    const int buf = st & 1, ts = st * TS;
    const bool next = st + 1 < nst;
    if (next) load(ts + TS);  // in flight during the steps below
#pragma unroll
    for (int q = 0; q < TS; q += 4) {
      float dt4[CPT][4], x4[CPT][4], yp[CPT][4];
#pragma unroll
      for (int k = 0; k < CPT; ++k) {
        ld_vec<4>(&s_dt[buf][cl[k] * DP + q], dt4[k]);
        ld_vec<4>(&s_x[buf][cl[k] * DP + q], x4[k]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = q + j;
        float bs[S], cs[S];
        ld_vec<S>(&s_B[buf][i * NP + lane * S], bs);
        ld_vec<S>(&s_C[buf][i * NP + lane * S], cs);
#pragma unroll
        for (int k = 0; k < CPT; ++k) {
          const float u = dt4[k][j] * x4[k][j];
          float acc = 0.f;
#pragma unroll
          for (int s = 0; s < S; ++s) {
            h[k][s] = fmaf(ex2(dt4[k][j] * A2[k][s]), h[k][s], u * bs[s]);
            acc = fmaf(h[k][s], cs[s], acc);
          }
          yp[k][j] = acc;
        }
      }
#pragma unroll
      for (int k = 0; k < CPT; ++k) st_vec<4>(red + k * TS + q, yp[k]);
    }
    // the L lanes of a channel pass their partial sums through s_red; lane l
    // finishes steps [l * SPL, (l + 1) * SPL), adds D * x and stores y
    __syncwarp();
    const int tl = ts + lane * SPL;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      float tot[SPL];
      ld_vec<SPL>(&s_x[buf][cl[k] * DP + lane * SPL], tot);
#pragma unroll
      for (int j = 0; j < SPL; ++j) tot[j] *= Dd[k];
#pragma unroll
      for (int m = 0; m < L; ++m) {
        float v[SPL];
        ld_vec<SPL>(s_red + (threadIdx.x - lane + m) * RP + k * TS + lane * SPL, v);
#pragma unroll
        for (int j = 0; j < SPL; ++j) tot[j] += v[j];
      }
#pragma unroll
      for (int j = 0; j < SPL; ++j)
        if (live[k] && tl + j < T) from_f32(yb + (long long)(tl + j) * a.Di + cl[k], tot[j]);
    }
    if (next) store(buf ^ 1);
    __syncthreads();
  }
}

// L, the lanes of a warp that share a channel's states: L * S >= N
int lanes_for(int N) { return N <= 4 * S ? 4 : N <= 8 * S ? 8 : 16; }

template <typename TX, typename TB, int L>
cudaError_t launch(const Args& a, long long blocks, cudaStream_t stream) {
  mamba_scan_kernel<TX, TB, L><<<(unsigned)blocks, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TX, typename TB>
cudaError_t dispatch_lanes(const Args& a, int L, long long blocks, cudaStream_t stream) {
  switch (L) {
    case 4: return launch<TX, TB, 4>(a, blocks, stream);
    case 8: return launch<TX, TB, 8>(a, blocks, stream);
    default: return launch<TX, TB, 16>(a, blocks, stream);
  }
}

}  // namespace

// The steps of a stage.
extern "C" int ms_stage() { return TS; }

// The lanes of a warp that share the states of one channel, for N states.
extern "C" int ms_lanes(int N) { return lanes_for(N); }

// x_dtype (x, dt, y) and bc_dtype (B, C): 0 = float32, 1 = bfloat16. y is a
// contiguous (Bsz, T, Di) tensor of x's type; N is at most 64. Returns the
// launch's cudaError_t.
extern "C" int ms_forward(const void* x, const void* dt, const float* A, const void* B,
                          const void* C, const float* D, void* y, int x_dtype, int bc_dtype,
                          int Bsz, int T, int Di, int N, long long x_sb, long long x_st,
                          long long dt_sb, long long dt_st, long long b_sb, long long b_st,
                          long long c_sb, long long c_st, void* stream) {
  if (Bsz <= 0 || T <= 0 || Di <= 0 || N <= 0 || N > MAX_STATES) return (int)cudaErrorInvalidValue;
  const int L = lanes_for(N);
  const int ntiles = (Di + NT / L * CPT - 1) / (NT / L * CPT);
  const long long blocks = (long long)ntiles * Bsz;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{x, dt, A, B, C, D, y, Bsz, T, Di, N, ntiles,
               x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st};
  switch (2 * x_dtype + bc_dtype) {
    case 0: return (int)dispatch_lanes<float, float>(a, L, blocks, s);
    case 1: return (int)dispatch_lanes<float, __nv_bfloat16>(a, L, blocks, s);
    case 2: return (int)dispatch_lanes<__nv_bfloat16, float>(a, L, blocks, s);
    case 3: return (int)dispatch_lanes<__nv_bfloat16, __nv_bfloat16>(a, L, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
