// Mamba selective-SSM scan for Hopper (sm_90a), fp32 state and arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/mamba_scan.py::mamba_scan (body
// _mamba_kernel, pl.pallas_call at mamba_scan.py:91). It computes the same
// function, Mamba-1's selective scan over T for every (batch b, channel d):
//
//   h_t[n] = exp(dt_t * A[d, n]) * h_{t-1}[n] + (dt_t * x_t) * B_t[n]
//   y_t    = sum_n h_t[n] * C_t[n] + D[d] * x_t
//
// for x, dt (Bsz, T, Di) and y in x's type (fp32 or bf16), B, C (Bsz, T, N) in
// fp32 or bf16, A (Di, N) and D (Di) in fp32. The state h starts at 0 and stays
// fp32; expf is the accurate one, and D * x is added in fp32 before the one
// rounding to y's type.
//
// Design. The TPU kernel runs a sequential grid axis over chunks of T and
// carries the (channels, N) state between grid steps in VMEM scratch. Hopper
// has no ordered grid axis, so here each thread block owns CB = 64 channels
// of one batch row and walks all of T itself, with the state in registers for
// the whole loop. The N states of a channel are spread over L = 4 lanes of a
// warp, S = N / 4 states each (rounded up to a power of two): a step costs a
// lane S expf and one y partial sum, reduced over the 4 lanes with two
// shuffles. That gives Bsz * Di * 4 threads, 65,536 at the jamba prefill
// shape, where one thread per channel would give 16,384 (a block and four
// warps per SM). Of 1, 2, 4, 8, 16 and 32 lanes, 2 and 4 were fastest at that
// shape (PERF.md); 4 keeps 256 blocks, where 2 lanes leave a batch of one
// prompt 64 blocks for 132 SMs. The block stages each chunk of TC = 32 steps
// in shared memory: the (TC, CB) slabs of x and dt (K = 8 elements a thread,
// loads coalesced along channels), converted to fp32, and the (TC, N) slabs
// of B and C, shared by every channel of the batch row; y goes through a
// (TC, CB) slab and out with coalesced stores. The next chunk's x and dt are
// loaded into registers before the current chunk's steps run, so their
// latency hides behind the steps. Ragged T and Di are masked here (the Pallas
// kernel asserts Di % 512 == 0 and T % 128 == 0 instead), and strided rows of
// B and C (slices of one projection) are read in place.
//
// What bounds it. At the jamba prefill shape (Bsz 2, T 2048, Di 8192, N 16,
// bf16) the function moves ~202 MB (x, dt read, y written) and does ~3.9
// GFLOP, so its bound is bytes: ~0.060 ms at 3.35 TB/s. The 537 M expf run on
// the special-function units, 16 per SM per clock: ~0.13 ms on their own, and
// issuing ~60 instructions per lane and step puts this simple kernel
// above 0.25 ms; PERF.md has its measured times. A chunked two-pass scan over
// T, which would fill the card with more than Bsz * Di * L threads, is later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int L = 4;          // lanes of a warp that share one channel's states
constexpr int CB = NT / L;    // channels per block
constexpr int K = 8;          // x and dt elements each thread stages per chunk
constexpr int TC = K * L;     // steps per chunk
constexpr int MAX_STATES = 16 * L;

struct Args {
  const void* x;
  const void* dt;
  const float* A;  // (Di, N), contiguous
  const void* B;
  const void* C;
  const float* D;  // (Di,)
  void* y;         // (Bsz, T, Di), contiguous
  int T, Di, N;
  long long x_sb, x_st;  // element strides of the batch and time axes (channel stride 1)
  long long dt_sb, dt_st;
  long long b_sb, b_st;
  long long c_sb, c_st;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// One block: channels [d0, d0 + CB) of batch row blockIdx.y. Thread tid
// stages channel j = tid % CB at the chunk's rows tid / CB + r * L. Shared
// memory holds the x, dt and y slabs of (TC, CB) = K * NT floats each and the
// B and C slabs of (TC, NP) floats, NP = L * S >= N (zero-padded).
template <typename TX, typename TB, int S>
__global__ void __launch_bounds__(NT) mamba_scan_kernel(Args a) {
  constexpr int NP = L * S;
  __shared__ float sx[K * NT], sdt[K * NT], sy[K * NT], sB[TC * NP], sC[TC * NP];

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * CB;
  const int c = threadIdx.x / L;     // this thread's channel within the block
  const int lane = threadIdx.x % L;  // which S states of it
  const int d = d0 + c;
  const bool live = d < a.Di;
  const int sj = threadIdx.x % CB;   // the channel this thread stages
  const int si = threadIdx.x / CB;   // its first row in a chunk
  const bool sj_live = d0 + sj < a.Di;

  const TX* xs = static_cast<const TX*>(a.x) + b * a.x_sb + d0 + sj;
  const TX* dts = static_cast<const TX*>(a.dt) + b * a.dt_sb + d0 + sj;
  const TB* Bb = static_cast<const TB*>(a.B) + b * a.b_sb;
  const TB* Cb = static_cast<const TB*>(a.C) + b * a.c_sb;
  TX* ys = static_cast<TX*>(a.y) + (long long)b * a.T * a.Di + d0 + sj;

  float h[S], A[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int n = lane * S + s;
    h[s] = 0.f;
    // a padded state (n >= N) has A = 0 and B = C = 0: it stays 0 and adds 0
    A[s] = (live && n < a.N) ? a.A[(long long)d * a.N + n] : 0.f;
  }
  const float Dd = live ? a.D[d] : 0.f;

  // x and dt of the chunk at t0, raw, in registers (0 outside T and Di)
  TX rx[K], rdt[K];
  auto prefetch = [&](int t0) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int t = t0 + si + r * L;
      const bool ok = sj_live && t < a.T;
      rx[r] = ok ? xs[t * a.x_st] : TX(0.f);
      rdt[r] = ok ? dts[t * a.dt_st] : TX(0.f);
    }
  };
  prefetch(0);

  for (int t0 = 0; t0 < a.T; t0 += TC) {
    const int nt = min(TC, a.T - t0);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int k = (si + r * L) * CB + sj;
      sx[k] = to_f32(rx[r]);
      sdt[k] = to_f32(rdt[r]);
    }
#pragma unroll 4
    for (int k = threadIdx.x; k < TC * NP; k += NT) {
      const int i = k / NP, n = k % NP;
      const bool ok = i < nt && n < a.N;
      sB[k] = ok ? to_f32(Bb[(t0 + i) * a.b_st + n]) : 0.f;
      sC[k] = ok ? to_f32(Cb[(t0 + i) * a.c_st + n]) : 0.f;
    }
    __syncthreads();
    if (t0 + TC < a.T) prefetch(t0 + TC);  // in flight during the steps below

#pragma unroll 4
    for (int i = 0; i < nt; ++i) {
      const float xv = sx[i * CB + c];
      const float dtv = sdt[i * CB + c];
      const float dtx = dtv * xv;
      const float* Bi = sB + i * NP + lane * S;
      const float* Ci = sC + i * NP + lane * S;
      float yp = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        h[s] = expf(dtv * A[s]) * h[s] + dtx * Bi[s];
        yp += h[s] * Ci[s];
      }
      // the L lanes of a channel are aligned in the warp: xor stays inside them
#pragma unroll
      for (int off = L / 2; off > 0; off /= 2) yp += __shfl_xor_sync(0xffffffffu, yp, off);
      if (lane == 0) sy[i * CB + c] = yp + Dd * xv;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int i = si + r * L;
      if (sj_live && i < nt) from_f32(ys + (long long)(t0 + i) * a.Di, sy[i * CB + sj]);
    }
    // the next chunk writes sx, sdt, sB, sC, which no thread reads after the
    // __syncthreads above; sy is read above and written again only after the
    // next __syncthreads
  }
}

template <typename TX, typename TB, int S>
cudaError_t launch(const Args& a, int Bsz, cudaStream_t stream) {
  const dim3 grid((a.Di + CB - 1) / CB, Bsz);
  mamba_scan_kernel<TX, TB, S><<<grid, NT, 0, stream>>>(a);
  return cudaGetLastError();
}

// S, the states a lane holds: the least power of two >= N / L
template <typename TX, typename TB>
cudaError_t dispatch_s(const Args& a, int Bsz, cudaStream_t stream) {
  if (a.N <= L) return launch<TX, TB, 1>(a, Bsz, stream);
  if (a.N <= 2 * L) return launch<TX, TB, 2>(a, Bsz, stream);
  if (a.N <= 4 * L) return launch<TX, TB, 4>(a, Bsz, stream);
  if (a.N <= 8 * L) return launch<TX, TB, 8>(a, Bsz, stream);
  return launch<TX, TB, 16>(a, Bsz, stream);
}

}  // namespace

// x_dtype (x, dt, y) and bc_dtype (B, C): 0 = float32, 1 = bfloat16. y is a
// contiguous (Bsz, T, Di) tensor of x's type; N is at most 64. Returns the
// launch's cudaError_t.
extern "C" int ms_forward(const void* x, const void* dt, const float* A, const void* B,
                          const void* C, const float* D, void* y, int x_dtype, int bc_dtype,
                          int Bsz, int T, int Di, int N,
                          long long x_sb, long long x_st, long long dt_sb, long long dt_st,
                          long long b_sb, long long b_st, long long c_sb, long long c_st,
                          void* stream) {
  if (Bsz <= 0 || Bsz > 65535 || T <= 0 || Di <= 0 || N <= 0 || N > MAX_STATES)
    return (int)cudaErrorInvalidValue;
  const Args a{x, dt, A, B, C, D, y, T, Di, N, x_sb, x_st, dt_sb, dt_st, b_sb, b_st, c_sb, c_st};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * x_dtype + bc_dtype) {
    case 0: return (int)dispatch_s<float, float>(a, Bsz, s);
    case 1: return (int)dispatch_s<float, __nv_bfloat16>(a, Bsz, s);
    case 2: return (int)dispatch_s<__nv_bfloat16, float>(a, Bsz, s);
    case 3: return (int)dispatch_s<__nv_bfloat16, __nv_bfloat16>(a, Bsz, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
