// Grouped matrix product for Hopper (sm_90a): the MoE's expert products.
//
// Replaces the TPU kernel src/repro/kernels/gmm.py::gmm (body _gmm_kernel,
// pl.pallas_call at gmm.py:91). It computes the same function: lhs (M, K) has
// its rows sorted by group, and every run of block_m rows belongs to one
// group, group_ids[m / block_m]; each row is multiplied by its group's matrix
// of rhs (G, K, N):
//
//   out[m, :] = lhs[m, :] @ rhs[group_ids[m / block_m]]     (M, N)
//
// with the products summed in fp32 over K and rounded once to the output's
// type: lhs's type (the TPU kernel's contract) or fp32 (the MoE's up and gate
// products, which the reference keeps in fp32 up to the activation). lhs and
// rhs share one type, bf16 or fp32.
//
// Design. The TPU kernel walks a grid of (row block, N tile, K step), carries
// an fp32 accumulator across the sequential K axis in VMEM, and gets each row
// block's group id by scalar prefetch. Here each thread block owns one output
// tile of BM rows inside one row block and BN columns, walks all of K itself
// with the accumulators in registers, and reads its own group id. A row block
// of block_m rows is cut into ceil(block_m / BM) tiles, the last one masked,
// so any block_m works: 1024 (granite's prefill capacity), 640 (jamba's) and
// 1 (every decode step: one token copy per expert) alike. Blocks are numbered
// row block slowest, then N tile, then M tile fastest: the tiles that share an
// expert's weight tile run together, so the weights come from HBM once per
// output tile and the group's rows stay in L2 while its N tiles run. At
// block_m = 1 this is a weight-streaming product: each block reads its K x BN
// slab of one expert once for its one row, and no expert is read twice.
//
// * bf16: warp-level tensor-core products (mma.sync m16n8k16, bf16 operands,
//   fp32 accumulators). A bf16 x bf16 product is exact in fp32, so this is the
//   reference's function up to the order of the sums. Tiles of K step 64 are
//   staged in shared memory by cp.async in a ring (rows padded by 16 bytes,
//   so the ldmatrix reads hit 8 distinct bank groups), and read into
//   registers with ldmatrix. Two tile shapes: 128 x 128 with 4 warps of 64 x
//   64 and a 3-deep ring (107 KB, two blocks an SM) for row blocks of more
//   than 16 rows, 16 x 64 with 4 warps and a 4-deep ring for the decode
//   shape. Of ten shapes tried at granite's and jamba's products, the 64 x 64
//   warp tile with K step 64 was fastest: it reads the fewest shared bytes
//   per product and syncs the block least often. K and N must be multiples
//   of 8 (16-byte copies); ragged edges of K, N and the row block read zeros
//   and store nothing.
// * fp32: FMAs on the CUDA cores (no TF32, which keeps 10 bits of mantissa):
//   a 64 x 64 tile with 4 x 4 outputs a thread, for every row block (rows
//   beyond the block's are masked); K step 16 in shared memory; any K and N.
//
// What bounds it on this card. Granite's prefill products (M 40,960, K 1536,
// N 512 and back) do 64 GFLOP on ~230-270 MB: 0.065 ms at the bf16 tensor
// rate against ~0.07-0.08 ms at the HBM rate, so bytes bound them, narrowly;
// jamba's (M 10,240, K 4096, N 14,336) do 1.2 TFLOP on 2.5 GB and are bound by
// operations (1.22 ms); every decode step is bound by the bytes of the
// weights (granite 63 MB a product, 0.019 ms). mma.sync does not reach the
// tensor rate that wgmma reaches, and a 128 x 128 tile loads
// 32 KB from L2 for every 2.1 MFLOP (64 operations a byte), so at jamba's
// shape this kernel stays well above its bound; a larger tile needs more
// registers than mma.sync's accumulators leave at two blocks an SM. wgmma
// with TMA loads, larger tiles and a persistent schedule is later work.
// PERF.md has the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const void* lhs;        // (M, K), contiguous
  const void* rhs;        // (G, K, N), contiguous
  const int* group_ids;   // (M / block_m,)
  void* out;              // (M, N), contiguous
  int M, K, N, G, block_m;
  int m_tiles;            // tiles a row block is cut into: ceil(block_m / BM)
  int n_tiles;            // ceil(N / BN)
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

// This block's tile: row block rb, its first row and row count, first column,
// and group id g (or -1 when the id lies outside [0, G)).
struct Tile {
  int row0, rows, n0, g;
};

template <int BM, int BN>
__device__ __forceinline__ Tile tile_of(const Args& a) {
  const long long id = blockIdx.x;
  const int j = (int)(id % a.m_tiles);
  const long long rest = id / a.m_tiles;
  const int nt = (int)(rest % a.n_tiles);
  const int rb = (int)(rest / a.n_tiles);
  Tile t;
  t.row0 = rb * a.block_m + j * BM;
  t.rows = min(BM, a.block_m - j * BM);
  t.n0 = nt * BN;
  const int g = a.group_ids[rb];
  t.g = (g >= 0 && g < a.G) ? g : -1;
  return t;
}

// A group id outside [0, G) is the caller's error: its rows come out NaN.
template <typename TO>
__device__ void poison(const Args& a, const Tile& t, int BN) {
  TO* out = static_cast<TO*>(a.out);
  for (int e = threadIdx.x; e < t.rows * BN; e += blockDim.x) {
    const int r = e / BN, n = t.n0 + e % BN;
    if (n < a.N) store1(out + (long long)(t.row0 + r) * a.N + n, __int_as_float(0x7fc00000));
  }
}

// ------------------------------- bf16 route ---------------------------------

// A tile shape of the bf16 route: BM x BN outputs a block, K steps of BK
// staged in a STAGES-deep ring, WM x WN warps of (BM / WM) x (BN / WN) outputs.
// Shared rows are padded by 16 bytes, so the 8 rows an ldmatrix reads start
// in 8 distinct groups of 4 banks.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Shape {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int NT = WM * WN * 32;
  static constexpr int A_LD = BK + 8, B_LD = BN + 8;
  static constexpr int MI = BM / WM / 16, NI = BN / WN / 8;  // m16n8 tiles of a warp
  static constexpr int SMEM = STAGES * (BM * A_LD + BK * B_LD) * 2;
  static_assert(MI >= 1 && NI >= 2 && NI % 2 == 0 && BK % 16 == 0, "warp tile 16m x 16n at least");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; with ok false, 16 zero bytes (nothing read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared memory: the ring of A tiles (BM x BK, rows of A_LD) then the ring of
// B tiles (BK x BN, rows of B_LD).
template <typename S, typename TO>
__global__ void __launch_bounds__(S::NT) gmm_bf16_kernel(Args a) {
  constexpr int BM = S::BM, BN = S::BN, BK = S::BK, WM = S::WM, WN = S::WN, NT = S::NT;
  constexpr int STAGES = S::STAGES, A_LD = S::A_LD, B_LD = S::B_LD, MI = S::MI, NI = S::NI;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + STAGES * BM * A_LD;

  const Tile t = tile_of<BM, BN>(a);
  if (t.g < 0) {
    poison<TO>(a, t, BN);
    return;
  }
  const __nv_bfloat16* lhs = static_cast<const __nv_bfloat16*>(a.lhs) + (long long)t.row0 * a.K;
  const __nv_bfloat16* rhs = static_cast<const __nv_bfloat16*>(a.rhs) + (long long)t.g * a.K * a.N;
  const int k_tiles = (a.K + BK - 1) / BK;

  auto load = [&](int stage, int kt) {
    const int k0 = kt * BK;
    __nv_bfloat16* as = As + stage * BM * A_LD;
    __nv_bfloat16* bs = Bs + stage * BK * B_LD;
    for (int c = threadIdx.x; c < BM * BK / 8; c += NT) {
      const int r = c / (BK / 8), k = k0 + (c % (BK / 8)) * 8;
      const bool ok = r < t.rows && k < a.K;
      cp16(as + r * A_LD + (c % (BK / 8)) * 8, ok ? lhs + (long long)r * a.K + k : lhs, ok);
    }
    for (int c = threadIdx.x; c < BK * BN / 8; c += NT) {
      const int kr = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const int k = k0 + kr, n = t.n0 + nc;
      const bool ok = k < a.K && n < a.N;
      cp16(bs + kr * B_LD + nc, ok ? rhs + (long long)k * a.N + n : rhs, ok);
    }
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm0 = (warp / WN) * (BM / WM);
  const int wn0 = (warp % WN) * (BN / WN);

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load(s, s);
    cp_commit();  // an empty group keeps the count of groups in step
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_wait<STAGES - 2>();  // tile kt has landed (for this thread's copies)
    __syncthreads();        // ... and for every thread's; stage kt - 1 is free
    if (kt + STAGES - 1 < k_tiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_commit();

    const __nv_bfloat16* as = As + (kt % STAGES) * BM * A_LD;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * BK * B_LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4], bf[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i)
        ldsm_x4(af[i], as + (wm0 + i * 16 + lane % 16) * A_LD + kk + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        uint32_t r[4];
        ldsm_x4_trans(r, bs + (kk + lane % 16) * B_LD + wn0 + j * 8 + (lane / 16) * 8);
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
  }
  cp_wait<0>();

  TO* out = static_cast<TO*>(a.out) + (long long)t.row0 * a.N;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int r = wm0 + i * 16 + lane / 4;
      const int n = t.n0 + wn0 + j * 8 + (lane % 4) * 2;  // N is even: n < N covers n + 1
      if (n >= a.N) continue;
      if (r < t.rows) store2(out + (long long)r * a.N + n, acc[i][j][0], acc[i][j][1]);
      if (r + 8 < t.rows) store2(out + (long long)(r + 8) * a.N + n, acc[i][j][2], acc[i][j][3]);
    }
}

// ------------------------------- fp32 route ---------------------------------

constexpr int BK32 = 16;  // K step of the fp32 route

// Threads TY x TX = (BM / RM) x (BN / RN); thread (ty, tx) owns rows ty + i TY
// and columns tx + j TX, so a warp's loads and stores run along N.
template <int BM, int BN, int RM, int RN>
__global__ void __launch_bounds__((BM / RM) * (BN / RN)) gmm_f32_kernel(Args a) {
  constexpr int TY = BM / RM, TX = BN / RN, NT = TY * TX;
  __shared__ float As[BK32][BM + 1];  // transposed: k-major
  __shared__ float Bs[BK32][BN];

  const Tile t = tile_of<BM, BN>(a);
  if (t.g < 0) {
    poison<float>(a, t, BN);
    return;
  }
  const float* lhs = static_cast<const float*>(a.lhs) + (long long)t.row0 * a.K;
  const float* rhs = static_cast<const float*>(a.rhs) + (long long)t.g * a.K * a.N;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += BK32) {
    for (int e = threadIdx.x; e < BM * BK32; e += NT) {
      const int r = e / BK32, k = k0 + e % BK32;
      As[e % BK32][r] = (r < t.rows && k < a.K) ? lhs[(long long)r * a.K + k] : 0.f;
    }
    for (int e = threadIdx.x; e < BK32 * BN; e += NT) {
      const int kr = e / BN, n = t.n0 + e % BN, k = k0 + kr;
      Bs[kr][e % BN] = (k < a.K && n < a.N) ? rhs[(long long)k * a.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK32; ++k) {
      float av[RM], bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = As[k][ty + i * TY];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = Bs[k][tx + j * TX];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = static_cast<float*>(a.out) + (long long)t.row0 * a.N;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int r = ty + i * TY, n = t.n0 + tx + j * TX;
      if (r < t.rows && n < a.N) out[(long long)r * a.N + n] = acc[i][j];
    }
}

// ------------------------------- launching ----------------------------------

// bf16: rows a block of the decode shape covers at most; larger row blocks
// take the 128-row tile
constexpr int SMALL_BLOCK_M = 16;

template <int BM, int BN>
Args with_tiles(Args a) {
  a.m_tiles = (a.block_m + BM - 1) / BM;
  a.n_tiles = (a.N + BN - 1) / BN;
  return a;
}

bool grid_ok(const Args& a, long long* blocks) {
  *blocks = (long long)(a.M / a.block_m) * a.m_tiles * a.n_tiles;
  return *blocks <= 0x7fffffffLL;
}

template <typename S, typename TO>
cudaError_t launch_bf16(Args a, cudaStream_t stream) {
  a = with_tiles<S::BM, S::BN>(a);
  long long blocks;
  if (!grid_ok(a, &blocks)) return cudaErrorInvalidConfiguration;
  auto kernel = gmm_bf16_kernel<S, TO>;
  if (S::SMEM > 48 * 1024) {  // once per device that launches this shape
    static int ready_on = -1;
    int device;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && device != ready_on) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
      if (err == cudaSuccess) ready_on = device;
    }
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, S::NT, S::SMEM, stream>>>(a);
  return cudaGetLastError();
}

template <int BM, int BN, int RM, int RN>
cudaError_t launch_f32(Args a, cudaStream_t stream) {
  a = with_tiles<BM, BN>(a);
  long long blocks;
  if (!grid_ok(a, &blocks)) return cudaErrorInvalidConfiguration;
  gmm_f32_kernel<BM, BN, RM, RN><<<(unsigned)blocks, (BM / RM) * (BN / RN), 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename TO>
cudaError_t dispatch_bf16(const Args& a, cudaStream_t s) {
  if (a.block_m <= SMALL_BLOCK_M) return launch_bf16<Shape<16, 64, 64, 1, 4, 4>, TO>(a, s);
  return launch_bf16<Shape<128, 128, 64, 2, 2, 3>, TO>(a, s);
}

}  // namespace

// dtype (lhs, rhs): 0 = float32, 1 = bfloat16; out_dtype: 0 = float32, 1 =
// bfloat16 (bf16 output only from bf16 inputs). M is a multiple of block_m and
// group_ids holds M / block_m ids; for bf16, K and N are multiples of 8 and
// every pointer is 16-byte aligned. Returns the launch's cudaError_t.
extern "C" int gmm_forward(const void* lhs, const void* rhs, const int* group_ids, void* out,
                           int dtype, int out_dtype, int M, int K, int N, int G, int block_m,
                           void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || block_m <= 0 || M % block_m != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (K % 8 != 0 || N % 8 != 0)) return (int)cudaErrorInvalidValue;
  const Args a{lhs, rhs, group_ids, out, M, K, N, G, block_m, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * dtype + out_dtype) {
    case 0: return (int)launch_f32<64, 64, 4, 4>(a, s);
    case 2: return (int)dispatch_bf16<float>(a, s);
    case 3: return (int)dispatch_bf16<__nv_bfloat16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
