// Flash attention forward for Hopper (sm_90a): a bf16 route on the tensor
// cores (wgmma fed by TMA) and an fp32 route on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _fa_kernel, pl.pallas_call at flash_attention.py:157). Both routes
// compute the same function: softmax(Q K^T * scale) V for q (B,Sq,Hq,D) and
// k, v (B,Sk,Hkv,D), with the online-softmax state (m, l, acc) in fp32; GQA
// (query head h reads kv head h / (Hq/Hkv), no kv copies); causal and
// sliding-window masks from absolute positions shifted by q_offset; an
// optional tanh softcap; no work on kv tiles that are fully masked; rows whose
// l stays 0 return 0; any Sq and Sk; q, k, v read as strided rows of the
// (B, S, H, D) layout, so the wrapper makes no transposed copies.
//
// The TPU kernel walks kv blocks on a sequential grid axis and keeps (m, l,
// acc) in VMEM scratch between grid steps. Hopper runs blocks in parallel and
// in no order, so here one thread block owns one (b, h, q tile) and loops over
// the kv tiles itself, with (m, l, acc) in registers. The loop is clipped to
// the tiles holding a key some row of the block may attend, [max(0, q_lo -
// window + 1), q_hi] when causal, so a window-512 layer at S 2048 visits ~10
// of its 32 kv tiles (bf16, 64 keys).
//
// What bounds it. At the paths' prefill shapes (B=2, S=2048; gemma3-1b Hq 4,
// Hkv 1, D 256; granite Hq 24, Hkv 8, D 64; jamba Hq 32, Hkv 8, D 128) the
// work is 4*D FLOP per attended (q, k) pair against tens of MB of q/k/v/o,
// hundreds of FLOP a byte, so the bound is the tensor rate (operations). A
// kernel comes near it only through wgmma fed from shared memory that TMA
// fills while the tensor cores work.
//
// bf16 route (fa_fwd_wgmma_kernel): one block per (b, h, 128-row q tile) of
// three warpgroups, the q tiles launched heaviest first (the causal
// triangle's last tile first, so it leaves no tail).
// * Warpgroup 0 hands its registers to the others (setmaxnreg) and one of its
//   threads issues every load: Q once, then K and V tiles into rings of
//   full/empty mbarriers, each tile as D/64 TMA boxes of 64 columns in
//   128-byte swizzle; rows past Sq or Sk arrive as zeros. Tiles (keys x
//   stages): D 64 64 x 4, D 128 128 x 3, D 256 64 x 2 (80 / 224 / 192 KB).
// * Warpgroups 1 and 2 own 64 q rows each. S = Q K^T is wgmma m64n{BK}k16
//   with Q and K from shared memory (both K-major: rows are d-contiguous). The
//   online softmax runs on the accumulator registers: a row is held by 4
//   lanes (2 shuffles), p = exp2(s * c - m * c) as one FFMA and one ex2 with
//   c = scale * log2(e), masks only on the tiles that straddle the diagonal,
//   the window's edge or Sk (a masked score is -inf; the running max starts
//   at the finite -1e30, so exp2(m_prev - m_new) is never inf - inf). P is
//   rounded to bf16 in place, where the accumulator layout is already wgmma's
//   register-A layout, and O += P V is wgmma m64n{D}k16 with A from registers
//   and V from shared memory (MN-major: the descriptor's transpose bit), so P
//   makes no trip through shared memory. O (64 x D fp32, 128 registers a
//   thread at D 256) stays in registers; the epilogue divides by l and rounds
//   to bf16 once (a row with l = 0 writes 0).
// * Overlap: tile i's Q K^T is issued together with tile i-1's P V, so tile
//   i's softmax runs while the tensor cores do that P V; and at D 128 and 256
//   the two warpgroups take turns issuing (ping-pong on two named barriers),
//   so one's softmax runs beside the other's products. At D 64 two blocks
//   share an SM instead (104 registers a consumer thread, so BK 64); their
//   four warpgroups interleave on their own.
// * Registers: a consumer thread holds O, the next tile's S and P at once
//   (~200 at D 256), past the 168 that 384 threads get at launch; setmaxnreg
//   gives it 240 of the block's pool. ptxas allocates by that only where the
//   code after setmaxnreg is the consumer's alone: an mbarrier wait written as
//   a C++ loop (shared by both roles once inlined) made it allocate the
//   whole kernel at 168, spill and serialize the wgmmas; the wait is one PTX
//   block (hopper.cuh).
// * Rounding P to bf16 before P V is what Hopper flash attentions do; the TPU
//   kernel keeps p in fp32 (flash_attention.py:75-77, :95-99). The difference
//   stays inside the bf16 bar (2e-2) of tests/test_kernels.py.
// * TMA needs a 16-byte-aligned base and byte strides that are multiples of
//   16: the wrapper checks both and raises otherwise (no fallback).
// * Head dims 80 and 96 run in the D 128 tile, 192 in the D 256 tile: each
//   tensor map has the real head dim d as its innermost extent, so TMA fills
//   the columns past d with zeros (for d 192 the whole fourth box), Q K^T is
//   unchanged and O's columns past d come out 0; the epilogue stores only the
//   first d, so a head's padding never lands on the next head's row. Up to
//   1.6x the operations of a tile of d's own (d 80).
//
// fp32 route (fa_fwd_kernel): one block of 256 threads per (b, h, 64-row q
// tile), Q, K and V tiles staged in shared memory as fp32 (up to 214 KB at
// D 256, so one block an SM), the products as fp32 FMAs on the CUDA cores, so
// that fp32 inputs meet a 2e-5 tolerance, which bf16 or TF32 operands cannot.
// Tiles of D 64, 128, 192 and 256; head dims 80 and 96 run in the D 128 tile,
// loaded with zeros past d and stored only up to d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;            // query rows per block
constexpr int BK = 64;            // keys per kv tile
constexpr int NT = 256;           // threads per block, a 16 x 16 grid (ty, tx)
constexpr int PSTRIDE = BK + 16;  // sP row stride (floats): rows ty and ty+1 hit other banks
constexpr float NEG_INF = -1e30f; // finite, so exp(m_prev - m_new) is never inf - inf

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int Sq, Sk, Hq, Hkv;
  int d;                       // head dim; the tile's D may be larger
  long long q_sb, q_ss, q_sh;  // element strides of the B, S and H axes
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window, q_offset;  // window <= 0: no window
  float scale, softcap;          // softcap <= 0: no softcap
};

// Four consecutive floats as a float4 (16 bytes).
template <typename T>
struct Vec4;

template <>
struct Vec4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ void store(float* p, float4 x) {
    *reinterpret_cast<float4*>(p) = x;
  }
};

// Copy rows [r0, r0 + rows) of one (b, h) slice into shared memory as fp32,
// row stride ld floats; rows at or past n and columns at or past d (a
// multiple of 4) are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long long row_stride, int r0, int n, int rows, int d) {
  constexpr int V = D / 4;
  for (int idx = threadIdx.x; idx < rows * V; idx += NT) {
    const int r = idx / V;
    const int c = (idx % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n && c < d) x = Vec4<T>::load(base + (long long)(r0 + r) * row_stride + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1) fa_fwd_kernel(const Args a) {
  constexpr int LD = D + 4;   // sQ/sK row stride: keys tx..tx+7 hit distinct 16-byte banks
  constexpr int NC = D / 64;  // float4 column chunks per thread in P V
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * D;

  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty + 16 i of the tile
  const int tx = tid % 16;  // keys tx + 16 j; output columns c * 64 + tx * 4
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / a.Hq;
  const int h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);

  const T* qb = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* ob = static_cast<T*>(a.o) + ((long long)b * a.Sq * a.Hq + h) * a.d;  // (B, Sq, Hq, d)
  const long long o_ss = (long long)a.Hq * a.d;

  load_tile<T, D>(sQ, LD, qb, a.q_ss, q0, a.Sq, BQ, a.d);

  // the kv tiles holding a key that some row of this block may attend
  const int q_lo = a.q_offset + q0;
  const int q_hi = a.q_offset + min(q0 + BQ, a.Sq) - 1;
  const int kv_lo = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(a.Sk - 1, q_hi) : a.Sk - 1;
  const int t_end = kv_lo <= kv_hi ? kv_hi / BK + 1 : 0;

  float m[4], l[4], acc[4][NC][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.f;
  }

  for (int t = kv_lo / BK; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's P V is done with sK, sV and sP
    load_tile<T, D>(sK, LD, kb, a.k_ss, k0, a.Sk, BK, a.d);
    load_tile<T, D>(sV, D, vb, a.v_ss, k0, a.Sk, BK, a.d);
    __syncthreads();

    // s = Q K^T for rows ty + 16 i and keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(sK + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j];
          x = fmaf(qv[i].x, kv[j].x, x);
          x = fmaf(qv[i].y, kv[j].y, x);
          x = fmaf(qv[i].z, kv[j].z, x);
          x = fmaf(qv[i].w, kv[j].w, x);
          s[i][j] = x;
        }
    }

    // mask, softcap and the online-softmax update; a row's 64 scores sit in
    // the 16 lanes that share ty, so shuffles over lane offsets 8..1 reduce it
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + ty + 16 * i;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
        ok[j] = kpos < a.Sk && (!a.causal || kpos <= qpos) &&
                (a.window <= 0 || kpos > qpos - a.window);
        s[i][j] = ok[j] ? x : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty + 16 * i) * PSTRIDE + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = alpha[i] * l[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    // acc = acc * alpha + P V for rows ty + 16 i, columns c * 64 + tx * 4 + e
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] *= alpha[i];
    for (int kk = 0; kk < BK; kk += 4) {
      float pv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p = *reinterpret_cast<const float4*>(sP + (ty + 16 * i) * PSTRIDE + kk);
        pv[i][0] = p.x;
        pv[i][1] = p.y;
        pv[i][2] = p.z;
        pv[i][3] = p.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(sV + (kk + u) * D + c * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][c][0] = fmaf(pv[i][u], vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(pv[i][u], vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(pv[i][u], vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(pv[i][u], vv.w, acc[i][c][3]);
          }
        }
    }
  }

  // out = acc / l; a row with l == 0 attended nothing and returns 0
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const float den = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c * 64 + tx * 4 >= a.d) continue;  // the tile's columns past d
      const float4 x = make_float4(acc[i][c][0] / den, acc[i][c][1] / den,
                                   acc[i][c][2] / den, acc[i][c][3] / den);
      Vec4<T>::store(ob + row * o_ss + c * 64 + tx * 4, x);
    }
  }
}

template <int D>
constexpr int smem_bytes() {
  return (int)sizeof(float) * (BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * PSTRIDE);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int smem = smem_bytes<D>();
  static_assert(smem <= 232448, "tile does not fit in one SM's shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + BQ - 1) / BQ, B * a.Hq);
  fa_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// The fp32 route's tile D for head dim d (0: not taken).
constexpr int f32_tile(int d) {
  return d == 64 ? 64 : (d == 80 || d == 96 || d == 128) ? 128 : d == 192 ? 192 : d == 256 ? 256 : 0;
}

cudaError_t dispatch_f32(const Args& a, int B, cudaStream_t stream) {
  switch (f32_tile(a.d)) {
    case 64: return launch<float, 64>(a, B, stream);
    case 128: return launch<float, 128>(a, B, stream);
    case 192: return launch<float, 192>(a, B, stream);
    case 256: return launch<float, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// =========================== bf16 route: wgmma + TMA ===========================

namespace wg {

constexpr int BQ = 128;        // q rows per block: two consumer warpgroups of 64
// warpgroup 0 loads (one thread), warpgroups 1 and 2 compute; setmaxnreg
// moves the loader's registers to the consumers
constexpr int NTHREADS = 384;
constexpr int CONSUMERS = 256;  // every consumer thread releases a stage
constexpr int LOADER_REGS = 24;
constexpr int ATOM = 128;       // bytes of one swizzled row: 64 bf16 columns
constexpr int PLAN_LEN = 14;    // per tensor: dims[4], byte strides[3], box[4], slots[3]
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Tile {
  // D 64: two blocks an SM, each within half the registers (104 a consumer
  // thread), so BK 64 (at BK 128, S, O and P alone take 128); their four
  // warpgroups interleave on their own, so no ping-pong. D 128 and 256: one
  // block an SM.
  static constexpr int BK = D == 128 ? 128 : 64;  // keys per ring stage
  static constexpr int STAGES = D == 64 ? 4 : (D == 128 ? 3 : 2);  // depth of the K and V rings
  static constexpr int BLOCKS = D == 64 ? 2 : 1;  // blocks an SM
  static constexpr bool PINGPONG = BLOCKS == 1;   // the two warpgroups take turns at the tensor cores
  // the registers a consumer thread gets: setmaxnreg draws from the block's own
  // pool, its launch registers (65536 / BLOCKS, 8 a thread at a time) less the loaders'
  static constexpr int CONSUMER_REGS =
      ((65536 / BLOCKS / NTHREADS) / 8 * 8 * NTHREADS - LOADER_REGS * 128) / 256 / 8 * 8;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one K or one V tile
  // slack to align the tiles to a 1024-byte swizzle atom, Q, the K ring, the
  // V ring, then the barriers: Q full, and full and empty for each K and V stage
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES);
  static_assert(SMEM <= 232448 / BLOCKS, "tiles do not fit in one SM's shared memory");
};

// The tensor-map dimension (1..3) of a tensor's head, row and batch axes: the
// wrapper orders them by stride.
struct Slots {
  int h, s, b;
};

struct Args {
  __nv_bfloat16* o;  // contiguous (B, Sq, Hq, d)
  int d;             // head dim: the tile's D, or less (see wgmma_tile)
  int Sq, Sk, Hq, Hkv, n_qtiles;
  int causal, window, q_offset;  // window <= 0: no window
  float scale, softcap;          // softcap <= 0: no softcap
  Slots q, k, v;
};

// A ring of tiles with a full and an empty barrier for each, as shared-memory
// addresses: stage s is at tiles + s * bytes, its barriers at full + 8 s, empty + 8 s.
struct Ring {
  uint32_t tiles, full, empty;
};

__device__ __forceinline__ int pick(int dim, Slots sl, int h, int row, int b) {
  return dim == sl.h ? h : (dim == sl.s ? row : b);
}

// The D/64 boxes of rows [row, row + rows) of head h, batch b into a tile of
// D/64 column blocks, each `rows` x 128 bytes.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, int rows, const CUtensorMap* map, uint32_t bar,
                                          Slots sl, int h, int row, int b) {
#pragma unroll
  for (int cb = 0; cb < D / 64; ++cb)
    hopper::tma_load_4d(dst + cb * rows * ATOM, map, bar, cb * 64, pick(1, sl, h, row, b),
                        pick(2, sl, h, row, b), pick(3, sl, h, row, b));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half: the lower column
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T of one kv tile for one warpgroup: D/16 steps of 16 columns, 4 to
// a 128-byte swizzle row; both operands K-major. Issued, not waited for.
template <int D, int BK>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q, uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = hopper::sw128_desc(q + (kk / 4) * BQ * ATOM + (kk % 4) * 32, 16, 1024);
    const uint64_t db = hopper::sw128_desc(k + (kk / 4) * BK * ATOM + (kk % 4) * 32, 16, 1024);
    if constexpr (BK == 128) {
      if (kk == 0) hopper::wgmma_ss_m64n128k16_set<0, 0>(s, da, db);
      else hopper::wgmma_ss_m64n128k16<0, 0>(s, da, db, 1);
    } else {
      if (kk == 0) hopper::wgmma_ss_m64n64k16_set<0, 0>(s, da, db);
      else hopper::wgmma_ss_m64n64k16<0, 0>(s, da, db, 1);
    }
  }
}

// O += P V of one kv tile (O = P V for the first: O is never zeroed, so its
// registers hold nothing live before): BK/16 steps of 16 keys (2048 bytes of
// V), P from registers; V is MN-major (transposed), its 64-column blocks
// BK * 128 bytes apart. Issued, not waited for.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BK / 16][4], uint32_t v,
                                         bool first) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t db = hopper::sw128_desc(v + kk * 16 * ATOM, BK * ATOM, 1024);
    const int acc = !first || kk > 0;
    if constexpr (D == 64) hopper::wgmma_rs_m64n64k16<1>(o, p[kk], db, acc);
    else if constexpr (D == 128) hopper::wgmma_rs_m64n128k16<1>(o, p[kk], db, acc);
    else hopper::wgmma_rs_m64n256k16<1>(o, p[kk], db, acc);
  }
}

// One kv tile's scores for this thread's rows (qpos0, qpos0 + 8): softcapped,
// masked to -inf where MASK, the running max m (in score units) and sum l
// updated (alpha: the factor on the old state), and the scores replaced by
// p = 2^((s - m) * mult) in fp32, one FFMA and one ex2 each: mult is
// scale * log2(e) (softcap * log2(e) with a softcap), positive. In the
// accumulator layout, s[4j + e] is row qpos0 + 8 (e >> 1), key
// k0 + 8j + kcol + (e & 1); l is this thread's share of the row sum.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int kcol, int qpos0,
                                             const Args& a) {
  const bool cap = a.softcap > 0.f;
  const float mult = (cap ? a.softcap : a.scale) * LOG2E;
  const float cap_in = cap ? a.scale / a.softcap : 0.f;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = cap ? tanhf(s[4 * j + e] * cap_in) : s[4 * j + e];
      if (MASK) {
        const int kpos = k0 + 8 * j + kcol + (e & 1);
        const int qpos = qpos0 + 8 * (e >> 1);
        const bool ok = kpos < a.Sk && (!a.causal || kpos <= qpos) &&
                        (a.window <= 0 || kpos > qpos - a.window);
        x = ok ? x : -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float neg_m[2];  // -m * mult, the FFMA's addend
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = ex2((m[r] - m_new) * mult);
    m[r] = m_new;
    l[r] *= alpha[r];
    neg_m[r] = -m_new * mult;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(fmaf(s[4 * j + e], mult, neg_m[e >> 1]));
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
}

template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
                                        const Args& a, uint32_t sQ, uint32_t q_full, Ring K, Ring V,
                                        int b, int h, int hk, int q0, int t0, int nt) {
  using T = Tile<D>;
  constexpr int STAGES = T::STAGES;
  hopper::tma_prefetch_map(tk);
  hopper::tma_prefetch_map(tv);
  hopper::mbar_expect_tx(q_full, T::Q_BYTES);
  load_tile<D>(sQ, BQ, tq, q_full, a.q, h, q0, b);
  for (int i = 0; i < nt; ++i) {
    const int s = i % STAGES;
    const uint32_t free_parity = ((i / STAGES) & 1) ^ 1;  // the stage's previous tile is consumed
    const int k0 = (t0 + i) * T::BK;
    hopper::mbar_wait(K.empty + 8 * s, free_parity);
    hopper::mbar_expect_tx(K.full + 8 * s, T::KV_BYTES);
    load_tile<D>(K.tiles + s * T::KV_BYTES, T::BK, tk, K.full + 8 * s, a.k, hk, k0, b);
    hopper::mbar_wait(V.empty + 8 * s, free_parity);
    hopper::mbar_expect_tx(V.full + 8 * s, T::KV_BYTES);
    load_tile<D>(V.tiles + s * T::KV_BYTES, T::BK, tv, V.full + 8 * s, a.v, hk, k0, b);
  }
}

// One consumer warpgroup: 64 q rows. Tile i's S = Q K_i^T is issued together
// with O += P_{i-1} V_{i-1}, so the softmax of tile i runs while the tensor
// cores do the previous tile's P V.
template <int D>
__device__ __forceinline__ void consume(const Args& a, uint32_t sQ, uint32_t q_full, Ring K, Ring V,
                                        int w, int b, int h, int q0, int t0, int nt) {
  using T = Tile<D>;
  constexpr int BK = T::BK, STAGES = T::STAGES;
  const int t = threadIdx.x % 128;
  const int r0 = 16 * (t / 32) + (t % 32) / 4;  // rows r0 and r0 + 8 of the warpgroup's 64
  const int kcol = 2 * (t % 4);                  // first of two columns in each 8-column block
  const int wq_lo = a.q_offset + q0 + 64 * w;    // position of the warpgroup's first row
  const int qpos0 = wq_lo + r0;
  const uint32_t qw = sQ + w * 64 * ATOM;

  float o[D / 2];  // set by the first P V; read only where l > 0
  float s[BK / 2];
  uint32_t p[BK / 16][4];
  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f}, alpha[2];

  // the tile's scores to p (bf16, wgmma's A fragment: 16 keys, two 8-column
  // blocks, a step); masks only where the tile straddles the diagonal, the
  // window's edge or Sk
  auto softmax = [&](int i) {
    const int k0 = (t0 + i) * BK;
    const bool edge = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > wq_lo) ||
                      (a.window > 0 && k0 < wq_lo + 64 - a.window);
    if (edge) softmax_tile<BK, true>(s, m, l, alpha, k0, kcol, qpos0, a);
    else softmax_tile<BK, false>(s, m, l, alpha, k0, kcol, qpos0, a);
  };
  auto to_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  auto rescale = [&]() {
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
  };

  // Ping-pong: the two warpgroups take turns issuing their wgmmas, so that one
  // runs its softmax while the other's products fill the tensor cores. A turn
  // is a named barrier of both warpgroups (ids 1 + w): one waits on its own,
  // the other arrives; warpgroup 0 goes first. Each has nt + 1 turns.
  auto my_turn = [&]() {
    if constexpr (T::PINGPONG) asm volatile("bar.sync %0, 256;\n" ::"r"(1 + w) : "memory");
  };
  auto pass_turn = [&](bool last) {
    if constexpr (T::PINGPONG)
      if (!(last && w == 1)) asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - w) : "memory");
  };
  if (T::PINGPONG && w == 1 && nt > 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");

  if (nt > 0) {
    hopper::mbar_wait(q_full, 0);
    hopper::mbar_wait(K.full, 0);
    my_turn();
    hopper::wgmma_fence();
    issue_qk<D, BK>(s, qw, K.tiles);
    hopper::wgmma_commit();
    pass_turn(false);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(s);
    hopper::mbar_arrive(K.empty);
    softmax(0);
    to_p();
  }
  for (int i = 1; i < nt; ++i) {
    const int st = i % STAGES, prev = (i - 1) % STAGES;
    hopper::mbar_wait(K.full + 8 * st, (i / STAGES) & 1);
    hopper::mbar_wait(V.full + 8 * prev, ((i - 1) / STAGES) & 1);
    my_turn();
    hopper::wgmma_fence();
    issue_qk<D, BK>(s, qw, K.tiles + st * T::KV_BYTES);
    hopper::wgmma_commit();
    issue_pv<D, BK>(o, p, V.tiles + prev * T::KV_BYTES, i == 1);
    hopper::wgmma_commit();
    pass_turn(false);
    hopper::wgmma_wait<1>();  // S of tile i is in; P V of tile i - 1 may still run
    hopper::fence_regs(s);
    hopper::mbar_arrive(K.empty + 8 * st);
    softmax(i);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(p);
    hopper::mbar_arrive(V.empty + 8 * prev);
    rescale();
    to_p();
  }
  if (nt > 0) {
    const int last = (nt - 1) % STAGES;
    hopper::mbar_wait(V.full + 8 * last, ((nt - 1) / STAGES) & 1);
    my_turn();
    hopper::wgmma_fence();
    issue_pv<D, BK>(o, p, V.tiles + last * T::KV_BYTES, nt == 1);
    hopper::wgmma_commit();
    pass_turn(true);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(o);
    hopper::fence_regs(p);
  }

  // out = O / l, l summed over the row's 4 lanes; a row with l == 0 attended nothing and returns 0
  const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  }
  const int row0 = q0 + 64 * w + r0;
  __nv_bfloat16* ob = a.o + ((long long)b * a.Sq * a.Hq + h) * a.d + kcol;
  const long long o_ss = (long long)a.Hq * a.d;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (8 * j >= a.d) continue;  // the tile's columns past d (a multiple of 8): not this head's
    if (row0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + row0 * o_ss + 8 * j) =
          l[0] > 0.f ? __floats2bfloat162_rn(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]) : zero;
    if (row0 + 8 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(ob + (row0 + 8) * o_ss + 8 * j) =
          l[1] > 0.f ? __floats2bfloat162_rn(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]) : zero;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, Tile<D>::BLOCKS)
    fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const Args a) {
  using T = Tile<D>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const uint32_t q_full = sQ + T::Q_BYTES + 2 * STAGES * T::KV_BYTES;    // then the barriers, 8 bytes each
  const Ring K{sQ + T::Q_BYTES, q_full + 8, q_full + 8 * (1 + STAGES)};
  const Ring V{K.tiles + STAGES * T::KV_BYTES, q_full + 8 * (1 + 2 * STAGES), q_full + 8 * (1 + 3 * STAGES)};

  const int b = blockIdx.x / a.Hq;
  const int h = blockIdx.x % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (a.n_qtiles - 1 - (int)blockIdx.y) * BQ;  // heaviest q tile first

  // the kv tiles holding a key that some row of this block may attend
  const int q_lo = a.q_offset + q0;
  const int q_hi = a.q_offset + min(q0 + BQ, a.Sq) - 1;
  const int kv_lo = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  const int kv_hi = a.causal ? min(a.Sk - 1, q_hi) : a.Sk - 1;
  const int t0 = kv_lo / T::BK;
  const int nt = kv_lo <= kv_hi ? kv_hi / T::BK + 1 - t0 : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(K.full + 8 * s, 1);
      hopper::mbar_init(K.empty + 8 * s, CONSUMERS);
      hopper::mbar_init(V.full + 8 * s, 1);
      hopper::mbar_init(V.empty + 8 * s, CONSUMERS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index, broadcast from lane 0: setmaxnreg is .aligned, so
  // every warp must visibly take its branch as one
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    hopper::regs_shrink<LOADER_REGS>();
    if (threadIdx.x == 0 && nt > 0)
      produce<D>(&tq, &tk, &tv, a, sQ, q_full, K, V, b, h, hk, q0, t0, nt);
  } else {
    hopper::regs_grow<T::CONSUMER_REGS>();
    consume<D>(a, sQ, q_full, K, V, wg - 1, b, h, q0, t0, nt);
  }
}

// A tensor's plan as the kernel expects it: the head dim innermost, and a
// box of 64 columns, `rows` rows, 1 head, 1 batch.
inline bool box_ok(const long long* p, int head_dim, int rows) {
  const long long* box = p + 7;
  const long long* slots = p + 11;
  if (p[0] != head_dim || box[0] != 64) return false;
  for (int d = 1; d < 4; ++d)
    if (box[d] != (d == slots[1] ? rows : 1)) return false;
  return true;
}

template <int D>
int launch(const long long* plan, const void* const ptrs[3], const Args& a, int B, cudaStream_t stream) {
  using T = Tile<D>;
  if (!box_ok(plan, a.d, BQ) || !box_ok(plan + PLAN_LEN, a.d, T::BK) ||
      !box_ok(plan + 2 * PLAN_LEN, a.d, T::BK))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const long long* p = plan + i * PLAN_LEN;
    const int r = hopper::encode_4d(&maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptrs[i], p, p + 4, p + 7);
    if (r != 0) return 10000 + r;
  }
  const cudaError_t err = cudaFuncSetAttribute(fa_fwd_wgmma_kernel<D>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * a.Hq, a.n_qtiles);
  fa_fwd_wgmma_kernel<D><<<grid, NTHREADS, T::SMEM, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

// The bf16 route's tile D for head dim d (0: not taken): 80 and 96 run in the
// D 128 tile, 192 in the D 256 tile.
constexpr int wgmma_tile(int d) {
  return d == 64 ? 64 : (d == 80 || d == 96 || d == 128) ? 128 : (d == 192 || d == 256) ? 256 : 0;
}

}  // namespace wg

// Dynamic shared memory a block uses at head dim d on a dtype's route
// (0 = float32, 1 = bfloat16; 0 if not taken).
extern "C" int fa_smem_bytes(int d, int dtype) {
  switch (dtype ? 2 * wg::wgmma_tile(d) + 1 : 2 * f32_tile(d)) {
    case 128: return smem_bytes<64>();
    case 256: return smem_bytes<128>();
    case 384: return smem_bytes<192>();
    case 512: return smem_bytes<256>();
    case 129: return wg::Tile<64>::SMEM;
    case 257: return wg::Tile<128>::SMEM;
    case 513: return wg::Tile<256>::SMEM;
    default: return 0;
  }
}

// fp32 route, head dim D in 64, 80, 96, 128, 192, 256 (a multiple of 4, so
// rows load as float4). The output o is a contiguous (B, Sq, Hq, D) float32
// tensor. Returns the launch's cudaError_t.
extern "C" int fa_forward_f32(const void* q, const void* k, const void* v, void* o,
                              int B, int Sq, int Sk, int Hq, int Hkv, int D,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              int causal, int window, int q_offset, float scale, float softcap,
                              void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, Sq, Sk, Hq, Hkv, D,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               causal, window, q_offset, scale, softcap};
  return (int)dispatch_f32(a, B, static_cast<cudaStream_t>(stream));
}

// bf16 route, head dim D in 64, 80, 96, 128, 192, 256. plan: for q, k and v
// in turn, the tensor map's dims (innermost first: D, then the head, row and
// batch axes ordered by stride), its byte strides of dims 1..3, its box, and
// the map dimension of the head, row and batch axes (14 numbers each). The
// output o is a contiguous (B, Sq, Hq, D) bf16 tensor. Returns the launch's cudaError_t, or 10000 + the CUresult of a
// tensor map the CUDA driver refused.
extern "C" int fa_forward_bf16(const void* q, const void* k, const void* v, void* o,
                               int B, int Sq, int Sk, int Hq, int Hkv, int D, const long long* plan,
                               int causal, int window, int q_offset, float scale, float softcap,
                               void* stream) {
  const int n_qtiles = (Sq + wg::BQ - 1) / wg::BQ;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || (long long)B * Hq > 0x7fffffff ||
      n_qtiles > 65535)
    return (int)cudaErrorInvalidValue;
  const long long* sl = plan + 11;
  const wg::Args a{static_cast<__nv_bfloat16*>(o), D, Sq, Sk, Hq, Hkv, n_qtiles, causal, window, q_offset,
                   scale, softcap,
                   {(int)sl[0], (int)sl[1], (int)sl[2]},
                   {(int)sl[wg::PLAN_LEN], (int)sl[wg::PLAN_LEN + 1], (int)sl[wg::PLAN_LEN + 2]},
                   {(int)sl[2 * wg::PLAN_LEN], (int)sl[2 * wg::PLAN_LEN + 1], (int)sl[2 * wg::PLAN_LEN + 2]}};
  const void* const ptrs[3] = {q, k, v};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wg::wgmma_tile(D)) {
    case 64: return wg::launch<64>(plan, ptrs, a, B, s);
    case 128: return wg::launch<128>(plan, ptrs, a, B, s);
    case 256: return wg::launch<256>(plan, ptrs, a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
