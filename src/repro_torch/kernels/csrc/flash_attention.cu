// Flash attention forward for Hopper (sm_90a), fp32 arithmetic.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::flash_attention
// (body _fa_kernel, pl.pallas_call at flash_attention.py:157). It computes the
// same function: softmax(Q K^T * scale) V for q (B,Sq,Hq,D) and k, v
// (B,Sk,Hkv,D), with the online-softmax state (m, l, acc) in fp32; GQA (query
// head h reads kv head h / (Hq/Hkv), no kv copies); causal and sliding-window
// masks from absolute positions shifted by q_offset; an optional tanh softcap;
// no work on kv tiles that are fully masked; rows whose l stays 0 return 0.
//
// Design. The TPU kernel walks kv blocks on a sequential grid axis and keeps
// (m, l, acc) in VMEM scratch between grid steps. Hopper runs blocks in
// parallel and in no order, so here one thread block owns one (b, h, 64-row
// q tile) and loops over the kv tiles itself, with (m, l, acc) in registers.
// The loop is clipped to [max(0, q_lo - window + 1), q_hi] (causal), so a
// window-512 layer visits about 9 tiles of 64 keys rather than all of them.
// Q, K and V tiles are staged in shared memory as fp32 (up to 214 KB at
// D = 256, hence one block of 256 threads per SM); the ragged last q tile and
// kv tile are masked, so any Sq and Sk work. Inputs are read as strided rows
// of the (B, S, H, D) layout: the wrapper makes no transposed copies.
//
// What bounds it. At the gemma3-1b prefill shapes (B=2, S=2048, Hq=4, Hkv=1,
// D=256, bf16) the work is 4*D FLOP per attended (q, k) pair: ~17 GFLOP for a
// causal layer against ~21 MB of q/k/v/o, so the card's bound is its tensor
// rate (operations, not bytes). This first version does the products on the
// fp32 CUDA cores (so fp32 inputs meet a 2e-5 tolerance) and is therefore far
// from that bound; tensor cores (mma.sync / wgmma) and TMA loads come later.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
  long long q_sb, q_ss, q_sh;  // element strides of the B, S and H axes
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window, q_offset;  // window <= 0: no window
  float scale, softcap;          // softcap <= 0: no softcap
};

// Four consecutive elements of T as a float4 (16 bytes of fp32, 8 of bf16).
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

template <>
struct Vec4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float4 x) {
    __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&a);
    raw.y = *reinterpret_cast<uint32_t*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// Copy rows [r0, r0 + rows) of one (b, h) slice into shared memory as fp32,
// row stride ld floats; rows at or past n are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* base,
                                          long long row_stride, int r0, int n, int rows) {
  constexpr int V = D / 4;
  for (int idx = threadIdx.x; idx < rows * V; idx += NT) {
    const int r = idx / V;
    const int c = (idx % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < n) x = Vec4<T>::load(base + (long long)(r0 + r) * row_stride + c);
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
  T* ob = static_cast<T*>(a.o) + ((long long)b * a.Sq * a.Hq + h) * D;  // (B, Sq, Hq, D)
  const long long o_ss = (long long)a.Hq * D;

  load_tile<T, D>(sQ, LD, qb, a.q_ss, q0, a.Sq, BQ);

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
    load_tile<T, D>(sK, LD, kb, a.k_ss, k0, a.Sk, BK);
    load_tile<T, D>(sV, D, vb, a.v_ss, k0, a.Sk, BK);
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

template <typename T>
cudaError_t dispatch_d(const Args& a, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 64: return launch<T, 64>(a, B, stream);
    case 128: return launch<T, 128>(a, B, stream);
    case 256: return launch<T, 256>(a, B, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory a block uses at head dim D (0 if D is not built).
extern "C" int fa_smem_bytes(int D) {
  switch (D) {
    case 64: return smem_bytes<64>();
    case 128: return smem_bytes<128>();
    case 256: return smem_bytes<256>();
    default: return 0;
  }
}

// dtype: 0 = float32, 1 = bfloat16. The output o is a contiguous
// (B, Sq, Hq, D) tensor of the input type. Returns the launch's cudaError_t.
extern "C" int fa_forward(const void* q, const void* k, const void* v, void* o, int dtype,
                          int B, int Sq, int Sk, int Hq, int Hkv, int D,
                          long long q_sb, long long q_ss, long long q_sh,
                          long long k_sb, long long k_ss, long long k_sh,
                          long long v_sb, long long v_ss, long long v_sh,
                          int causal, int window, int q_offset, float scale, float softcap,
                          void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, Sq, Sk, Hq, Hkv,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               causal, window, q_offset, scale, softcap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_d<float>(a, B, D, s);
    case 1: return (int)dispatch_d<__nv_bfloat16>(a, B, D, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
