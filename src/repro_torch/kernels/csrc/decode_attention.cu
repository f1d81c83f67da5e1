// Split-K decode attention for Hopper (sm_90a): one new token a sequence
// against its KV cache (K5).
//
// Replaces no TPU kernel. The JAX package's decode attention
// (src/repro/models/attention.py::_decode_attention) is an einsum over the
// whole cache, with no Pallas kernel behind it; the port ran the same einsums
// in plain torch, which upcast all L slots of the bf16 cache to fp32 (written
// out, then permuted for two batched fp32 products) in every attention layer
// of every step, filled or not. This kernel computes the same function:
//
//   s[j, t] = (q[j] . k[t]) * scale          over the slots t < fill
//   p       = softmax_t(s)                    (fp32)
//   out[j]  = sum_t p[j, t] v[t]              (fp32, rounded once to q's type)
//
// for the g = Hq / Hkv query heads j of each kv head. K and V are read in
// their own type (bf16 or fp32) and converted to fp32 in registers: bf16 to
// fp32 is exact, so the products are the reference's; scores, softmax, P and
// P.V stay in fp32 (P is never rounded to bf16). Only the order of the sums
// differs from the reference's.
//
// What bounds it on this card: the bytes of the cache's filled slots. A slot
// costs 4 * D bytes of K and V in bf16 and 4 * g * D fp32 operations, about g
// operations a byte: mixtral's g 4 is ~70x below the tensor cores' balance
// point and ~5x below the CUDA cores', so the kernel is built to keep HBM busy
// and does its arithmetic with FMAs on the CUDA cores.
//
// Design.
// * One block (128 threads) per (split, kv head, sequence). It holds the g
//   query rows of its kv head (as fp32 in shared memory), so each K and V
//   byte is read once for all g heads, and walks its split's slots in tiles of
//   32. The cache is read in place through its strides (the per-layer view of
//   a stacked cache needs no copy); rows must be 16-byte aligned.
// * Loads: a 3-deep cp.async ring of K and V tiles, 16 bytes a copy, each row
//   padded by 16 bytes so that the score pass's reads (8 threads on 8 rows at
//   one column) hit distinct banks. Slots past fill are not read: their rows
//   fill with zeros and their scores are -inf.
// * Scores: thread (warp w, lane l) computes head w + 4i's score at slot l of
//   the tile; the warp's shuffles give the tile's max and sum of that head.
//   Online softmax: the running max m and sum l a head, and the factor that
//   rescales the running P.V, go through shared memory to the P.V pass, where
//   each thread owns 4 adjacent columns of up to 8 (head, column) groups.
// * Splits: the host's plan cuts the filled tiles into splits of whole tiles,
//   so that B * Hkv * splits blocks fill the card (mixtral's 64 x 8 pairs need
//   none; one sequence at 4,096 slots needs many). With one split the block
//   writes the output itself. With more, each writes its unnormalised P.V and
//   its (m, l) to a workspace, and decode_attn_combine_kernel merges the
//   splits of each (sequence, head) in a fixed order, with no atomics: two
//   runs give the same bits.
//
// The C entry points return the launches' cudaError_t; the wrapper
// (src/repro_torch/kernels/decode_attention.py) checks shapes, types and
// alignment, and allocates the output and the workspace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;      // threads a block
constexpr int TILE = 32;     // slots a tile: one warp's lanes
constexpr int STAGES = 3;    // depth of the cp.async ring
constexpr int MAX_G = 16;    // query heads a kv head
constexpr int MAX_D = 256;   // head dim, a multiple of 8
constexpr int MAX_PAIRS = MAX_G * TILE / NT;      // (head, slot) scores a thread a tile
constexpr int MAX_ITEMS = MAX_G * MAX_D / 4 / NT;  // (head, 4 columns) of P.V a thread

template <typename T>
struct Row;
template <>
struct Row<float> {
  static constexpr int VEC = 4;  // elements a 16-byte copy
};
template <>
struct Row<__nv_bfloat16> {
  static constexpr int VEC = 8;
};

// the padded row of a K or V tile in shared memory, in elements
template <typename T>
__host__ __device__ __forceinline__ int row_len(int D) {
  return D + Row<T>::VEC;
}

template <typename TKV>
__host__ __device__ __forceinline__ size_t smem_bytes(int D, int g) {
  return (size_t)STAGES * 2 * TILE * row_len<TKV>(D) * sizeof(TKV) +
         sizeof(float) * ((size_t)g * D + (size_t)g * (TILE + 1) + 2 * g);
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// 16 bytes from global to shared; with ok false, 16 zero bytes (nothing read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// q (fp32, shared) . one K row (shared), four running sums
__device__ __forceinline__ float dot_row(const float* q, const float* k, int D) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int d = 0; d < D; d += 4) {
    const float4 kk = *reinterpret_cast<const float4*>(k + d);
    const float4 qq = *reinterpret_cast<const float4*>(q + d);
    a0 = fmaf(qq.x, kk.x, a0);
    a1 = fmaf(qq.y, kk.y, a1);
    a2 = fmaf(qq.z, kk.z, a2);
    a3 = fmaf(qq.w, kk.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}
__device__ __forceinline__ float dot_row(const float* q, const __nv_bfloat16* k, int D) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  for (int d = 0; d < D; d += 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(k + d);
    const float4 q0 = *reinterpret_cast<const float4*>(q + d);
    const float4 q1 = *reinterpret_cast<const float4*>(q + d + 4);
    // bf16 -> fp32: the 16 bits on top of a zero mantissa tail (exact)
    a0 = fmaf(q0.x, __uint_as_float(w.x << 16), a0);
    a1 = fmaf(q0.y, __uint_as_float(w.x & 0xffff0000u), a1);
    a2 = fmaf(q0.z, __uint_as_float(w.y << 16), a2);
    a3 = fmaf(q0.w, __uint_as_float(w.y & 0xffff0000u), a3);
    a0 = fmaf(q1.x, __uint_as_float(w.z << 16), a0);
    a1 = fmaf(q1.y, __uint_as_float(w.z & 0xffff0000u), a1);
    a2 = fmaf(q1.z, __uint_as_float(w.w << 16), a2);
    a3 = fmaf(q1.w, __uint_as_float(w.w & 0xffff0000u), a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// four adjacent elements of a V row (shared), as fp32
__device__ __forceinline__ float4 load4(const float* v) { return *reinterpret_cast<const float4*>(v); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* v) {
  const uint2 w = *reinterpret_cast<const uint2*>(v);
  return make_float4(__uint_as_float(w.x << 16), __uint_as_float(w.x & 0xffff0000u),
                     __uint_as_float(w.y << 16), __uint_as_float(w.y & 0xffff0000u));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;       // (B, 1, Hq, D), contiguous, q's type
  float* part;     // (B, Hq, splits, D): each split's unnormalised P.V (splits > 1)
  float* part_ml;  // (B, Hq, splits, 2): each split's running max and sum (splits > 1)
  int Hkv, g, D, fill, tiles_per_split, splits;
  long long q_sb, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh;  // element strides
  float scale;
};

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(NT) decode_attn_split_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = a.D, g = a.g, tid = threadIdx.x;
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int Hq = a.Hkv * g;
  const int row = row_len<TKV>(D);
  TKV* ring = reinterpret_cast<TKV*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + (size_t)STAGES * 2 * TILE * row * sizeof(TKV));
  float* p_s = q_s + g * D;        // (g, TILE + 1): this tile's P
  float* alpha_s = p_s + g * (TILE + 1);  // (g): the factor on the running P.V
  float* l_s = alpha_s + g;        // (g): the final sums

  const int first = split * a.tiles_per_split * TILE;                   // the split's first slot
  const int end = min(first + a.tiles_per_split * TILE, a.fill);        // one past its last
  const int ntiles = (end - first + TILE - 1) / TILE;
  const TKV* kb = static_cast<const TKV*>(a.k) + b * a.k_sb + kh * a.k_sh;
  const TKV* vb = static_cast<const TKV*>(a.v) + b * a.v_sb + kh * a.v_sh;
  const TQ* qb = static_cast<const TQ*>(a.q) + b * a.q_sb + (long long)kh * g * a.q_sh;

  constexpr int VEC = Row<TKV>::VEC;
  const int chunks = D / VEC;  // 16-byte copies a row
  auto load = [&](int t) {
    TKV* ks = ring + (size_t)(t % STAGES) * 2 * TILE * row;
    TKV* vs = ks + TILE * row;
    const int slot0 = first + t * TILE;
    for (int x = tid; x < TILE * chunks; x += NT) {
      const int r = x / chunks, c = (x - r * chunks) * VEC;
      const bool ok = slot0 + r < end;
      const long long slot = ok ? slot0 + r : slot0;  // a valid address; not read when !ok
      cp16(ks + r * row + c, kb + slot * a.k_sl + c, ok);
      cp16(vs + r * row + c, vb + slot * a.v_sl + c, ok);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load(s);
    cp_commit();
  }
  for (int i = tid; i < g * D; i += NT) {
    const int j = i / D;
    q_s[i] = to_f32(qb[j * a.q_sh + (i - j * D)]);
  }

  const int npairs = g * TILE, nitems = g * (D / 4), cols = D / 4;
  float m_run[MAX_PAIRS], l_run[MAX_PAIRS];
  float acc[MAX_ITEMS][4];
#pragma unroll
  for (int u = 0; u < MAX_PAIRS; ++u) {
    m_run[u] = -INFINITY;
    l_run[u] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < MAX_ITEMS; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_wait<STAGES - 2>();  // tile t has landed (this thread's copies)
    __syncthreads();        // ... every thread's; and the stage of tile t - 1 is free
    if (t + STAGES - 1 < ntiles) load(t + STAGES - 1);
    cp_commit();
    const TKV* ks = ring + (size_t)(t % STAGES) * 2 * TILE * row;
    const TKV* vs = ks + TILE * row;
    const int slot0 = first + t * TILE;
#pragma unroll
    for (int u = 0; u < MAX_PAIRS; ++u) {
      const int j = tid + u * NT;  // warp-uniform test: npairs is a multiple of 32
      if (j < npairs) {
        const int h = j / TILE, s = j % TILE;
        const float dot = dot_row(q_s + h * D, ks + s * row, D);
        const float sc = slot0 + s < end ? dot * a.scale : -INFINITY;
        const float m_new = fmaxf(m_run[u], warp_max(sc));  // finite: a tile holds a filled slot
        const float p = expf(sc - m_new);
        const float alpha = expf(m_run[u] - m_new);  // 0 at the first tile
        l_run[u] = l_run[u] * alpha + warp_sum(p);
        m_run[u] = m_new;
        p_s[h * (TILE + 1) + s] = p;
        if (s == 0) alpha_s[h] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < MAX_ITEMS; ++u) {
      const int i = tid + u * NT;
      if (i < nitems) {
        const int h = i / cols, c = (i - h * cols) * 4;
        const float al = alpha_s[h];
        float4 o = make_float4(acc[u][0] * al, acc[u][1] * al, acc[u][2] * al, acc[u][3] * al);
        const float* ph = p_s + h * (TILE + 1);
#pragma unroll 8
        for (int s = 0; s < TILE; ++s) {
          const float p = ph[s];
          const float4 vv = load4(vs + s * row + c);
          o.x = fmaf(p, vv.x, o.x);
          o.y = fmaf(p, vv.y, o.y);
          o.z = fmaf(p, vv.z, o.z);
          o.w = fmaf(p, vv.w, o.w);
        }
        acc[u][0] = o.x;
        acc[u][1] = o.y;
        acc[u][2] = o.z;
        acc[u][3] = o.w;
      }
    }
  }
  cp_wait<0>();

  const long long head0 = (long long)b * Hq + (long long)kh * g;  // (sequence, first head of the kv head)
  if (a.splits == 1) {
#pragma unroll
    for (int u = 0; u < MAX_PAIRS; ++u) {
      const int j = tid + u * NT;
      if (j < npairs && j % TILE == 0) l_s[j / TILE] = l_run[u];
    }
    __syncthreads();
    TQ* out = static_cast<TQ*>(a.out);
#pragma unroll
    for (int u = 0; u < MAX_ITEMS; ++u) {
      const int i = tid + u * NT;
      if (i < nitems) {
        const int h = i / cols, c = (i - h * cols) * 4;
        const float l = l_s[h];
        TQ* o = out + (head0 + h) * D + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] = from_f32<TQ>(acc[u][e] / l);
      }
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < MAX_PAIRS; ++u) {
    const int j = tid + u * NT;
    if (j < npairs && j % TILE == 0) {
      const long long r = (head0 + j / TILE) * a.splits + split;
      a.part_ml[2 * r] = m_run[u];
      a.part_ml[2 * r + 1] = l_run[u];
    }
  }
#pragma unroll
  for (int u = 0; u < MAX_ITEMS; ++u) {
    const int i = tid + u * NT;
    if (i < nitems) {
      const int h = i / cols, c = (i - h * cols) * 4;
      const long long r = (head0 + h) * a.splits + split;
      *reinterpret_cast<float4*>(a.part + r * D + c) = make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
  }
}

// out[r, d] = sum_i e^(m_i - M) part[r, i, d] / sum_i e^(m_i - M) l_i over
// the splits i in order, M = max_i m_i; one thread an output element
template <typename TQ>
__global__ void __launch_bounds__(256) decode_attn_combine_kernel(const float* part, const float* part_ml,
                                                                   TQ* out, long long n, int D, int splits) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const long long r = idx / D;
  const int d = (int)(idx - r * D);
  const float* ml = part_ml + r * splits * 2;
  float M = -INFINITY;
  for (int i = 0; i < splits; ++i) M = fmaxf(M, ml[2 * i]);
  float num = 0.f, den = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float w = expf(ml[2 * i] - M);
    den = fmaf(w, ml[2 * i + 1], den);
    num = fmaf(w, part[(r * splits + i) * D + d], num);
  }
  out[idx] = from_f32<TQ>(num / den);
}

template <typename TQ, typename TKV>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<TKV>(a.D, a.g);
  constexpr int MAX_DEVICES = 64;
  static size_t opted[MAX_DEVICES] = {};  // dynamic shared memory allowed so far, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024 && (device >= MAX_DEVICES || smem > opted[device])) {
    err = cudaFuncSetAttribute(decode_attn_split_kernel<TQ, TKV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) opted[device] = smem;
  }
  decode_attn_split_kernel<TQ, TKV><<<dim3(a.splits, a.Hkv, B), NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return err;
  const long long n = (long long)B * a.Hkv * a.g * a.D;
  decode_attn_combine_kernel<TQ><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      a.part, a.part_ml, static_cast<TQ*>(a.out), n, a.D, a.splits);
  return cudaGetLastError();
}

}  // namespace

// The plan's constants, read back by the wrapper.
extern "C" int da_tile() { return TILE; }
extern "C" int da_stages() { return STAGES; }
extern "C" int da_threads() { return NT; }

// Dynamic shared memory a block of the split kernel takes (kv_dtype 0 =
// float32, 1 = bfloat16).
extern "C" long long da_smem_bytes(int kv_dtype, int D, int g) {
  return (long long)(kv_dtype ? smem_bytes<__nv_bfloat16>(D, g) : smem_bytes<float>(D, g));
}

// q_dtype (q and the output) and kv_dtype (k, v): 0 = float32, 1 = bfloat16.
// splits blocks of tiles_per_split tiles each cover the fill slots; with
// splits > 1, part and part_ml are the workspace and the combine kernel runs
// second. Returns the launches' cudaError_t.
extern "C" int da_forward(const void* q, const void* k, const void* v, void* out, float* part,
                          float* part_ml, int q_dtype, int kv_dtype, int B, int Hkv, int g, int D,
                          int fill, int tiles_per_split, int splits, long long q_sb, long long q_sh,
                          long long k_sb, long long k_sl, long long k_sh, long long v_sb, long long v_sl,
                          long long v_sh, float scale, void* stream) {
  if (B <= 0 || Hkv <= 0 || g <= 0 || g > MAX_G || D <= 0 || D > MAX_D || D % 8 || fill <= 0 ||
      tiles_per_split <= 0 || splits <= 0 || (long long)splits * tiles_per_split * TILE < fill ||
      (long long)(splits - 1) * tiles_per_split * TILE >= fill || B > 65535 || Hkv > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, part, part_ml, Hkv, g, D, fill, tiles_per_split, splits,
               q_sb, q_sh, k_sb, k_sl, k_sh, v_sb, v_sl, v_sh, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * q_dtype + kv_dtype) {
    case 0: return (int)launch<float, float>(a, B, s);
    case 1: return (int)launch<float, __nv_bfloat16>(a, B, s);
    case 2: return (int)launch<__nv_bfloat16, float>(a, B, s);
    case 3: return (int)launch<__nv_bfloat16, __nv_bfloat16>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
