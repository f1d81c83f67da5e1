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
// block's group id by scalar prefetch. Here a thread block owns output tiles
// of BM rows inside one row block and BN columns, walks all of K itself with
// the accumulators in registers, and reads each tile's group id. A row block
// of block_m rows is cut into ceil(block_m / BM) tiles, so any block_m works:
// 1024 (granite's prefill capacity), 640 (jamba's) and 1 (every decode step:
// one token copy per expert) alike. Tiles are numbered row block slowest,
// then N tile, then M tile fastest: the tiles that share an expert's weight
// tile run together, so the weights come from HBM once per output tile and
// the group's rows stay in L2 while its N tiles run. Three routes:
//
// * bf16, row blocks of more than 16 rows (gmm_wgmma_kernel; the prefill
//   products): wgmma with both operands from shared memory, fed by TMA.
//   - Tiles of 128 x 256 outputs, K step 64. A block of three warpgroups:
//     warpgroup 0 gives its registers away (setmaxnreg) and one of its threads
//     issues every load; warpgroups 1 and 2 each own 64 rows of the tile, with
//     its 64 x 256 fp32 sums in 128 registers a thread (232 by setmaxnreg).
//   - The loads run into a 4-deep ring of full/empty mbarriers, a stage per K
//     step: lhs through an (M, K) tensor map, one 128-row x 64-column box (16
//     KB), rhs through a (G, K, N) map, four 64 x 64 boxes at the tile's group
//     (32 KB), all in 128-byte swizzle. A is K-major; B = rhs[g] is (K, N),
//     N-contiguous, so MN-major: the descriptor's transpose bit, its 64-column
//     blocks 8 KB apart. Each tile's first K step sets the sums (a write-only
//     wgmma), so nothing of the last tile's stays alive in registers.
//   - Persistent: one block an SM walks the tiles blockIdx.x, + gridDim.x, ...
//     The ring runs on across tiles, so one tile's epilogue overlaps the next
//     tile's first loads, and a product of fewer tiles than a few waves leaves
//     no launch tail.
//   - Epilogue by TMA: each warpgroup writes its sums, rounded to the output
//     type, into a 16 KB buffer in the 128-byte swizzle, and one thread stores
//     it by TMA while the warpgroup goes on to the next tile (226 KB of shared
//     memory in all). Stored straight from the registers, a warp writes 4 or
//     8 bytes at each of 8 rows an instruction: at granite's bf16 down
//     product (N 1536, K 512) that cost more than its products.
//   - Edges: TMA fills rows past M and columns past K or N with zeros on
//     load. A tile that reaches past its row block (block_m not a multiple of
//     128, as 200 = 128 + 72) reads the next group's rows; the output map is
//     (N, block_m, M / block_m), so its stores stop at the row block's end and
//     at N. K and N must be multiples of 8 (TMA's 16-byte strides).
// * bf16, row blocks of at most 16 rows (gmm_bf16_kernel; the decode shape):
//   warp-level products (mma.sync m16n8k16), a 16 x 64 tile with 4 warps and
//   a 4-deep cp.async ring, rows padded by 16 bytes for conflict-free ldmatrix
//   reads. Each block reads its K x 64 slab of one expert once for its row:
//   weight-streaming, bound by the bytes of the weights. K and N must be
//   multiples of 8 (16-byte copies); ragged edges read zeros and store nothing.
// * fp32: FMAs on the CUDA cores (no TF32, which keeps 10 bits of mantissa):
//   a 64 x 64 tile with 4 x 4 outputs a thread, for every row block (rows
//   beyond the block's are masked); K step 16 in shared memory; any K and N.
//
// A bf16 x bf16 product is exact in fp32, so the bf16 routes compute the
// reference's function up to the order of the sums.
//
// What bounds it on this card. Granite's prefill products (M 40,960, K 1536,
// N 512 and back) do 64 GFLOP on ~230-270 MB: 0.065 ms at the bf16 tensor
// rate against ~0.07-0.08 ms at the HBM rate, so bytes bound them, narrowly;
// jamba's (M 10,240, K 4096, N 14,336) do 1.2 TFLOP on 2.5 GB and are bound by
// operations (1.22 ms); every decode step is bound by the bytes of the
// weights (granite 63 MB a product, 0.019 ms). A 128 x 256 tile loads 48 KB
// a K step for 4.2 MFLOP (85 operations a byte), which wgmma from shared
// memory sustains; the mma.sync kernel that ran the prefill shapes before
// (128 x 128 tiles, cp.async) reached ~285 TFLOP/s at jamba's. PERF.md has
// the measured times.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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

// Tile `id`: its row block rb, first row and row count (inside its row
// block), first column, and group id g (or -1 when the id lies outside [0, G)).
struct Tile {
  int rb, row0, rows, n0, g;
};

template <int BM, int BN>
__device__ __forceinline__ Tile tile_of(const Args& a, int id) {
  const int j = id % a.m_tiles;
  const int rest = id / a.m_tiles;
  const int nt = rest % a.n_tiles;
  const int rb = rest / a.n_tiles;
  Tile t;
  t.rb = rb;
  t.row0 = rb * a.block_m + j * BM;
  t.rows = min(BM, a.block_m - j * BM);
  t.n0 = nt * BN;
  const int g = a.group_ids[rb];
  t.g = (g >= 0 && g < a.G) ? g : -1;
  return t;
}

template <int BM, int BN>
Args with_tiles(Args a) {
  a.m_tiles = (a.block_m + BM - 1) / BM;
  a.n_tiles = (a.N + BN - 1) / BN;
  return a;
}

__host__ __device__ __forceinline__ long long tile_count(const Args& a) {
  return (long long)(a.M / a.block_m) * a.m_tiles * a.n_tiles;
}

// Whether the tiles can be numbered by an int (the grid's or the persistent
// walk's ids); *blocks: how many.
bool grid_ok(const Args& a, long long* blocks) {
  *blocks = tile_count(a);
  return *blocks <= 0x7fffffffLL;
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

// A tile shape of the mma.sync route: BM x BN outputs a block, K steps of BK
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

// 16 bytes from global to shared; with ok false, 16 zero bytes (nothing read)
__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_addr(p)));
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

  const Tile t = tile_of<BM, BN>(a, blockIdx.x);
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

// ------------------------- bf16 route: wgmma + TMA --------------------------

namespace wg {

constexpr int BM = 128, BN = 256, BK = 64;  // tile rows, columns; K step
constexpr int STAGES = 4;                   // depth of the ring
// warpgroup 0 loads (one thread), warpgroups 1 and 2 compute; setmaxnreg
// moves the loader's registers to the consumers: 168 a thread at launch
// (65,536 / 384, 8 at a time), 40 to the loader, (168 * 384 - 40 * 128) / 256
// to each consumer
constexpr int NTHREADS = 384;
constexpr int LOADER_REGS = 40, CONSUMER_REGS = 232;
constexpr int CONSUMER_WARPS = 8;  // each releases a stage once
constexpr int ATOM = 128;          // bytes of one swizzled row: 64 bf16 columns
constexpr int A_BYTES = BM * BK * 2;          // one lhs box
constexpr int B_BYTES = BK * BN * 2;          // BN / 64 rhs boxes of BK x 64
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// the epilogue stages each warpgroup's 64 rows through shared memory for TMA
// stores, two boxes of 64 rows x 128 bytes at a time
constexpr int EPI_BYTES = 2 * 64 * ATOM;
// slack to align the stages to a 1024-byte swizzle atom, the stages, the two
// warpgroups' epilogue buffers, then a full and an empty barrier for each stage
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * EPI_BYTES + 16 * STAGES;
static_assert(SMEM <= 232448, "the ring does not fit in one SM's shared memory");
constexpr int PLAN_LEN = 11;  // per tensor map: dims[4], byte strides[3], box[4]

__device__ __forceinline__ void produce(const CUtensorMap* tl, const CUtensorMap* tr, const Args& a,
                                        uint32_t ring, uint32_t full, uint32_t empty, int tiles,
                                        int k_steps) {
  hopper::tma_prefetch_map(tl);
  hopper::tma_prefetch_map(tr);
  int it = 0;  // K steps issued by this block, over all its tiles: the ring's position
  for (int id = blockIdx.x; id < tiles; id += gridDim.x) {
    const Tile t = tile_of<BM, BN>(a, id);
    if (t.g < 0) continue;  // poisoned: nothing to load
    for (int kt = 0; kt < k_steps; ++kt, ++it) {
      const int s = it % STAGES;
      const uint32_t stage = ring + s * STAGE_BYTES;
      hopper::mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);  // the stage's last K step is consumed
      hopper::mbar_expect_tx(full + 8 * s, STAGE_BYTES);
      hopper::tma_load_4d(stage, tl, full + 8 * s, kt * BK, t.row0, 0, 0);
#pragma unroll
      for (int c = 0; c < BN / 64; ++c)
        hopper::tma_load_4d(stage + A_BYTES + c * BK * ATOM, tr, full + 8 * s, t.n0 + 64 * c, kt * BK, t.g, 0);
    }
  }
}

// Issues the products of the block's K step `it` (its ring stage's tiles) for
// warpgroup w's 64 rows into acc, once the stage is full; FIRST: acc = A B,
// else acc += A B. Not waited for.
template <bool FIRST>
__device__ __forceinline__ void k_step(float (&acc)[BN / 2], uint32_t ring, uint32_t full, int w, int it) {
  static_assert(BN == 256, "a warpgroup's product is wgmma m64n256k16");
  const int s = it % STAGES;
  const uint32_t sa = ring + s * STAGE_BYTES + w * 64 * ATOM;  // this warpgroup's 64 rows
  const uint32_t sb = ring + s * STAGE_BYTES + A_BYTES;
  hopper::mbar_wait(full + 8 * s, (it / STAGES) & 1);
  if (!FIRST) hopper::fence_regs(acc);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    // A K-major: 16 columns are 32 bytes along the swizzled row; B MN-major:
    // 16 rows are 2048 bytes down, its 64-column blocks BK * 128 bytes apart
    const uint64_t da = hopper::sw128_desc(sa + kk * 32, 16, 1024);
    const uint64_t db = hopper::sw128_desc(sb + kk * 16 * ATOM, BK * ATOM, 1024);
    if (FIRST && kk == 0) hopper::wgmma_ss_m64n256k16_set<0, 1>(acc, da, db);
    else hopper::wgmma_ss_m64n256k16<0, 1>(acc, da, db, 1);
  }
  hopper::wgmma_commit();
}

__device__ __forceinline__ void st_shared(uint32_t addr, float a, float b, float) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(a), "f"(b) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, float a, float b, __nv_bfloat16) {
  __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(*reinterpret_cast<uint32_t*>(&v)) : "memory");
}
// The four warps of warpgroup w (named barrier 1 + w; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

// Stores warpgroup w's 64 rows of a tile by TMA, through the warpgroup's
// buffer `buf` in chunks of two boxes of 64 rows x 128 bytes (64 bf16 or 32
// fp32 columns): the threads write their accumulators there in the 128-byte
// swizzle (16-byte units XOR the row, so the 8 rows of a write meet in no
// bank), then one thread (`leader`) issues the chunk's stores and the
// warpgroup goes on; the stores run on while it multiplies the next tile.
// The output map is (N, block_m, M / block_m): TMA clips the columns past N
// and the rows past the row block, so a tile stores only its own rows.
// `rib`: the warpgroup's first row inside row block rb.
template <typename TO>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], const CUtensorMap* tout, int n0, int rib,
                                           int rb, bool any_rows, uint32_t buf, int w, bool leader) {
  constexpr int SIZE = sizeof(TO);
  constexpr int BC = ATOM / SIZE;  // columns of a box
  const int t = threadIdx.x % 128;
  const int rl = 16 * (t / 32) + (t % 32) / 4;  // rows rl and rl + 8 of the warpgroup's 64
  const int kcol = 2 * (t % 4);
#pragma unroll
  for (int c = 0; c < BN / (2 * BC); ++c) {
    if (leader) hopper::bulk_wait_read<0>();  // the last chunk's stores have read the buffer
    warpgroup_sync(w);
#pragma unroll
    for (int jj = 0; jj < 2 * BC / 8; ++jj) {
      const int x = (8 * jj + kcol) * SIZE;  // byte of the chunk's row: box x / 128, unit x % 128 / 16
      const int j = c * 2 * BC / 8 + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rl + 8 * h;
        const uint32_t addr = buf + x / ATOM * 64 * ATOM + row * ATOM + ((x % ATOM / 16) ^ (row & 7)) * 16 + x % 16;
        st_shared(addr, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1], TO());
      }
    }
    hopper::fence_proxy_async();
    warpgroup_sync(w);
    if (leader && any_rows) {
      hopper::tma_store_4d(tout, buf, n0 + 2 * c * BC, rib, rb, 0);
      hopper::tma_store_4d(tout, buf + 64 * ATOM, n0 + (2 * c + 1) * BC, rib, rb, 0);
      hopper::bulk_commit();
    }
  }
}

// One consumer warpgroup: rows [64 w, 64 w + 64) of every tile of this block.
template <typename TO>
__device__ __forceinline__ void consume(const Args& a, const CUtensorMap* tout, uint32_t ring, uint32_t full,
                                        uint32_t empty, uint32_t buf, int w, int tiles, int k_steps) {
  const bool releases = threadIdx.x % 32 == 0;
  const bool leader = threadIdx.x % 128 == 0;
  // the accumulator layout: acc[4j + e] is row 16 warp + lane / 4 + 8 (e >> 1) of
  // the warpgroup's 64, column 8j + 2 (lane % 4) + (e & 1)
  float acc[BN / 2];
  int it = 0;
  for (int id = blockIdx.x; id < tiles; id += gridDim.x) {
    const Tile tl = tile_of<BM, BN>(a, id);
    if (tl.g < 0) {  // a group id outside [0, G) is the caller's error: its rows come out NaN
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = __int_as_float(0x7fc00000);
    } else {
      // the tile's first K step sets the sums (so nothing of the last tile's
      // stays alive), each later one adds to them
      k_step<true>(acc, ring, full, w, it++);
      for (int kt = 1; kt < k_steps; ++kt, ++it) {
        k_step<false>(acc, ring, full, w, it);
        hopper::wgmma_wait<1>();  // the previous K step's products are done with their stage
        hopper::fence_regs(acc);
        if (releases) hopper::mbar_arrive(empty + 8 * ((it + STAGES - 1) % STAGES));
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (releases) hopper::mbar_arrive(empty + 8 * ((it + STAGES - 1) % STAGES));
    }
    // the epilogue, while the loader fills the ring with the next tile's K steps
    const int rib = tl.row0 - tl.rb * a.block_m + 64 * w;
    store_tile<TO>(acc, tout, tl.n0, rib, tl.rb, tl.rows > 64 * w, buf, w, leader);
  }
  if (leader) hopper::bulk_wait<0>();  // the last stores are done before the block's memory goes
}

template <typename TO>
__global__ void __launch_bounds__(NTHREADS, 1)
    gmm_wgmma_kernel(const __grid_constant__ CUtensorMap tl, const __grid_constant__ CUtensorMap tr,
                     const __grid_constant__ CUtensorMap to, const Args a) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1024-byte aligned
  const uint32_t epi = ring + STAGES * STAGE_BYTES;
  const uint32_t full = epi + 2 * EPI_BYTES, empty = full + 8 * STAGES;
  const int tiles = (int)tile_count(a);  // below 2^31: the launch checks
  const int k_steps = (a.K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  // the warpgroup's index, broadcast from lane 0: setmaxnreg is .aligned, so
  // every warp must visibly take its branch as one
  const int wgi = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wgi == 0) {
    hopper::regs_shrink<LOADER_REGS>();
    if (threadIdx.x == 0) produce(&tl, &tr, a, ring, full, empty, tiles, k_steps);
  } else {
    hopper::regs_grow<CONSUMER_REGS>();
    consume<TO>(a, &to, ring, full, empty, epi + (wgi - 1) * EPI_BYTES, wgi - 1, tiles, k_steps);
  }
}

// A tensor map of the plan as the kernel expects it: these dims, a box of
// `cols` columns and `rows` rows.
inline bool map_ok(const long long* p, long long d0, long long d1, long long d2, int cols, int rows) {
  return p[0] == d0 && p[1] == d1 && p[2] == d2 && p[3] == 1 && p[7] == cols && p[8] == rows && p[9] == 1 &&
         p[10] == 1;
}

// plan: the (K, M) map of lhs, the (N, K, G) map of rhs and the (N, block_m,
// M / block_m) map of the output (11 numbers each). Returns a cudaError_t, or
// 10000 + the CUresult of a tensor map the CUDA driver refused.
template <typename TO>
int launch(Args a, const long long* plan, cudaStream_t stream) {
  a = with_tiles<BM, BN>(a);
  long long tiles;
  if (!grid_ok(a, &tiles)) return (int)cudaErrorInvalidConfiguration;
  if (plan == nullptr || !map_ok(plan, a.K, a.M, 1, 64, BM) || !map_ok(plan + PLAN_LEN, a.N, a.K, a.G, 64, BK) ||
      !map_ok(plan + 2 * PLAN_LEN, a.N, a.block_m, a.M / a.block_m, ATOM / sizeof(TO), 64))
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  const void* base[3] = {a.lhs, a.rhs, a.out};
  const CUtensorMapDataType out_type = sizeof(TO) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  for (int i = 0; i < 3; ++i) {
    const long long* p = plan + i * PLAN_LEN;
    const int r = hopper::encode_4d(&maps[i], i < 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : out_type, base[i], p, p + 4,
                                    p + 7);
    if (r != 0) return 10000 + r;
  }
  int device, sms;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gmm_wgmma_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)(tiles < sms ? tiles : sms);  // persistent: one block an SM
  gmm_wgmma_kernel<TO><<<blocks, NTHREADS, SMEM, stream>>>(maps[0], maps[1], maps[2], a);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ------------------------------- fp32 route ---------------------------------

constexpr int BK32 = 16;  // K step of the fp32 route

// Threads TY x TX = (BM / RM) x (BN / RN); thread (ty, tx) owns rows ty + i TY
// and columns tx + j TX, so a warp's loads and stores run along N.
template <int BM, int BN, int RM, int RN>
__global__ void __launch_bounds__((BM / RM) * (BN / RN)) gmm_f32_kernel(Args a) {
  constexpr int TY = BM / RM, TX = BN / RN, NT = TY * TX;
  __shared__ float As[BK32][BM + 1];  // transposed: k-major
  __shared__ float Bs[BK32][BN];

  const Tile t = tile_of<BM, BN>(a, blockIdx.x);
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
// take the wgmma route
constexpr int SMALL_BLOCK_M = 16;

template <typename S, typename TO>
cudaError_t launch_bf16(Args a, cudaStream_t stream) {
  static_assert(S::SMEM <= 48 * 1024, "the small tile's ring fits the default shared memory");
  a = with_tiles<S::BM, S::BN>(a);
  long long blocks;
  if (!grid_ok(a, &blocks)) return cudaErrorInvalidConfiguration;
  gmm_bf16_kernel<S, TO><<<(unsigned)blocks, S::NT, S::SMEM, stream>>>(a);
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
int dispatch_bf16(const Args& a, const long long* plan, cudaStream_t s) {
  if (a.block_m <= SMALL_BLOCK_M) return (int)launch_bf16<Shape<16, 64, 64, 1, 4, 4>, TO>(a, s);
  return wg::launch<TO>(a, plan, s);
}

}  // namespace

// dtype (lhs, rhs): 0 = float32, 1 = bfloat16; out_dtype: 0 = float32, 1 =
// bfloat16 (bf16 output only from bf16 inputs). M is a multiple of block_m and
// group_ids holds M / block_m ids; for bf16, K and N are multiples of 8 and
// every pointer is 16-byte aligned. plan: the wgmma route's tensor maps (bf16,
// block_m > 16): dims, byte strides and box of the (K, M) map of lhs, the (N,
// K, G) map of rhs and the (N, block_m, M / block_m) map of out, 11 numbers
// each; null for the other routes.
// Returns the launch's cudaError_t, or 10000 + the CUresult of a tensor map
// the CUDA driver refused.
extern "C" int gmm_forward(const void* lhs, const void* rhs, const int* group_ids, void* out,
                           int dtype, int out_dtype, int M, int K, int N, int G, int block_m,
                           const long long* plan, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || G <= 0 || block_m <= 0 || M % block_m != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && (K % 8 != 0 || N % 8 != 0)) return (int)cudaErrorInvalidValue;
  const Args a{lhs, rhs, group_ids, out, M, K, N, G, block_m, 0, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (2 * dtype + out_dtype) {
    case 0: return (int)launch_f32<64, 64, 4, 4>(a, s);
    case 2: return dispatch_bf16<float>(a, plan, s);
    case 3: return dispatch_bf16<__nv_bfloat16>(a, plan, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
