// Causal GQA flash attention for Hopper (sm_90a): forward, dq and dk/dv.
//
// Replaces the three Pallas TPU kernels of torchft_tpu/ops/flash_attention.py:
//   flash_fwd_wgmma_kernel (bf16), flash_fwd_f32_kernel
//                          <- _flash_fwd / _fwd_kernel
//   flash_bwd_dq_wgmma_kernel (bf16), flash_bwd_dq_f32_kernel
//                          <- flash_attention_partial_bwd / _bwd_dq_kernel
//   flash_bwd_dkv_wgmma_kernel (bf16), flash_bwd_dkv_f32_kernel
//                          <- flash_attention_partial_bwd / _bwd_dkv_kernel
// and computes what they compute: masks from explicit int32 position arrays
// (q_pos >= k_pos, so permuted ring/zigzag layouts work), skips a tile that
// lies wholly above the diagonal (min k_pos > max q_pos), gives empty rows
// out = 0 and lse = -1e30, and rounds to the input type where the TPU
// kernels round (p before P.V, ds before dS.K, p and ds before the dk/dv
// products; ds from the unrounded p). Accumulators are f32, and each
// output element is written once, by one block, with no atomics.
//
// What bounds them on the H100: at the train step's shapes (b = 4,
// s = 2048, 8 heads of 128 over 4 KV heads) every kernel does ~2*d flops
// per byte it must move, far above the card's ~295 bf16 flops per byte, so
// the tensor cores are the bound: the forward's 34.4 GFLOP of causal work
// take at least 0.0348 ms at 989 TFLOP/s, dq's 1.5 times and dk/dv's twice
// as much.
//
// The three bf16 kernels share one design, built for that bound:
// - a block of two warpgroups (256 threads), each owning 64 rows of the
//   block's tile: query rows for the forward and dq, key rows for dk/dv;
// - every product is a wgmma with f32 accumulators in registers, in one of
//   two forms: A and B both K-major from shared memory (S = Q.K^T and
//   dP = dO.V^T, or their transposes S^T = K.Q^T and dP^T = V.dO^T), or A
//   as bf16 pairs in registers and B read MN-major from shared memory
//   (O += P.V, dQ += dS.K, dV += P^T.dO, dK += dS^T.Q). The f32
//   accumulator layout of the first form is the bf16 A-fragment layout of
//   the second, so p and ds are rounded in place and fed straight back;
// - the block's own tile lands once (Q; Q and dO; K and V), and the other
//   side streams through a two-stage ring filled by cp.async (16-byte
//   copies, zero-filled past the sequence), so tile j+1 is in flight while
//   tile j is computed, with one barrier per tile;
// - every tile is stored in wgmma's 128-byte swizzle layout, which the
//   tensor cores read without bank conflicts and the copies fill from
//   whole 128-byte lines;
// - positions are reduced once per block, by warp reductions: the block's
//   max query (min key) position and each streamed tile's min key (max
//   query) position, so skipped tiles are never loaded; causal tiles
//   launch heaviest first over all heads.
// Thread (g = lane / 4, c = lane % 4) of warp x of a warpgroup holds rows
// 16 x + g and 16 x + g + 8 of the warpgroup's 64, columns 8 j + 2 c and
// 8 j + 2 c + 1, of every accumulator (wgmma's f32 layout): a[4 j + 2 i + e]
// is row i, column 8 j + 2 c + e. So a row lives in the four threads of a
// quad. The forward keeps S, the running max m, the running sum l and O in
// registers for the whole KV loop (a row max is two shuffles, l is summed
// per thread and reduced once at the end, the online-softmax correction
// is a register multiply). dq keeps dQ, and dk/dv keep dK and dV, in
// registers for their whole loops; with the global lse given, neither
// needs a correction. dk/dv stream the query tiles of every head of the
// GQA group as one sequence, so the ring does not drain between heads and
// the group is summed in the accumulators.
// The f32 instantiations (flash_*_f32_kernel) keep the first design, for
// correctness rather than speed: each block of 4 warps holds a 64-row tile
// and each warp owns a 16-row strip, with FMA products and f32
// accumulators in shared memory.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kF32 = 0;
constexpr int kBF16 = 1;
// Kernel selectors of the entry points.
constexpr int kFwd = 0;
constexpr int kDq = 1;
constexpr int kDkv = 2;

// The bf16 kernels' block shapes, fixed here. A warpgroup owns 64 rows of
// the block's tile; a streamed tile has kFwdBlockN keys, kDqBlockN keys or
// kDkvBlockQ queries (wgmma's N for the first products, its K for the
// second).
constexpr int kFwdWarpgroups = 2;
constexpr int kFwdBlockN = 128;
constexpr int kDqWarpgroups = 2;
constexpr int kDqBlockN = 64;
constexpr int kDkvWarpgroups = 2;
constexpr int kDkvBlockQ = 64;
// Ring depth: tiles j+1 .. j+kStages-1 load while tile j computes.
constexpr int kStages = 2;

// The f32 kernels' shapes.
constexpr int kThreads = 128;     // 4 warps; warp w owns rows [16w, 16w + 16)
constexpr int kRows = 64;         // rows of a block's own tile
constexpr int kBlockK = 64;       // kv rows per inner step of fwd and dq
constexpr int kDkvBlockQF32 = 32;  // q rows per step of dk/dv, to fit in 227 KB

}  // namespace

// Mirrors the ctypes.Structure in ops/flash_attention.py field for field.
// Strides are in elements; the last (head_dim) stride is 1.
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const int* qpos;
  const int* kpos;
  const float* lse;
  const float* delta;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
  int b, sq, sk, h, kvh, d;
  float scale;
};

namespace {

__host__ __device__ constexpr size_t r128(size_t bytes) {
  return (bytes + 127) / 128 * 128;
}

__host__ __device__ constexpr size_t r1024(size_t bytes) {
  return (bytes + 1023) / 1024 * 1024;
}

struct SmemAlloc {
  char* p;
  template <typename U>
  __device__ U* take(int count) {
    U* r = reinterpret_cast<U*>(p);
    p += r128(count * sizeof(U));
    return r;
  }
};

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

// Positions reduced once per block, by warp reductions. The block owns
// entries [r0, r0 + ROWS) of `own` (those at or past n_own excluded); the
// other side streams in tiles of `tile` entries of `other` (those at or
// past n_other excluded). A block of queries (OWN_QUERIES) gets its max
// query position back and each key tile's min into per_tile (INT_MAX for
// none); a block of keys gets its min key position and each query tile's
// max (INT_MIN for none). A tile lies wholly above the diagonal when its
// keys' min exceeds its queries' max. `red` holds one int per warp. Ends
// with __syncthreads.
template <int ROWS, bool OWN_QUERIES>
__device__ int block_positions(const int* own, int r0, int n_own, const int* other,
                               int n_other, int tile, int* red, int* per_tile) {
  constexpr int kOwnNone = OWN_QUERIES ? INT_MIN : INT_MAX;
  constexpr int kTileNone = OWN_QUERIES ? INT_MAX : INT_MIN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  int v = kOwnNone;
  for (int i = threadIdx.x; i < ROWS; i += blockDim.x) {
    if (r0 + i < n_own) v = OWN_QUERIES ? max(v, own[r0 + i]) : min(v, own[r0 + i]);
  }
  v = OWN_QUERIES ? __reduce_max_sync(0xffffffffu, v) : __reduce_min_sync(0xffffffffu, v);
  if (lane == 0) red[warp] = v;
  const int nt = (n_other + tile - 1) / tile;
  for (int t = warp; t < nt; t += nwarps) {
    int m = kTileNone;
    for (int c = t * tile + lane; c < min(n_other, (t + 1) * tile); c += 32) {
      m = OWN_QUERIES ? min(m, other[c]) : max(m, other[c]);
    }
    m = OWN_QUERIES ? __reduce_min_sync(0xffffffffu, m) : __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) per_tile[t] = m;
  }
  __syncthreads();
  int r = kOwnNone;
  for (int w = 0; w < nwarps; ++w) r = OWN_QUERIES ? max(r, red[w]) : min(r, red[w]);
  return r;
}

// ---------------------------------------------------------------------------
// The bf16 kernels' pieces: cp.async, wgmma, descriptors, fragments.

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !in (src is
// then not read, but stays a valid address).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most PENDING of this thread's copy groups are in flight,
// then makes the landed copies visible to wgmma's (async proxy) reads; a
// barrier after it publishes every thread's.
template <int PENDING>
__device__ __forceinline__ void cp_async_wait_for_wgmma() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins accumulator registers at this point of the program, so the compiler
// neither reads them before the wgmma that writes them has been waited for
// nor writes them while a wgmma may still read them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory matrix descriptor for the 128-byte swizzle layout
// (see load_rows_async): `sbo` is the byte stride between groups of 8 rows
// of 128 bytes, `lbo` (MN-major only) the stride between 64-element column
// blocks. The atoms are 1024-byte aligned, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc_sw128(const void* ptr, uint32_t lbo,
                                                    uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(ptr) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// What to add to a K-major descriptor of a tile of `rows` rows for step kk
// of 16 columns: the step starts in column block kk / 4, 32 bytes further
// per step inside it (in the descriptor's 16-byte units).
__device__ __forceinline__ uint64_t k_step(int rows, int kk) {
  return ((kk / 4) * rows * 128 + (kk % 4) * 32) >> 4;
}

// d[0, 32) (+)= A . B over one k16 step; A and B from shared memory, both
// K-major. accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t a, uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[0, 32) += A . B over one k16 step; A as bf16 pairs in registers, B from
// shared memory MN-major (the transposed form for 16-bit types).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[0, 64) += A . B over one k16 step; A as bf16 pairs in registers, B from
// shared memory MN-major (the transposed form for 16-bit types).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The first form at N columns: S = Q.K^T and the like.
template <int N>
__device__ __forceinline__ void wgmma_ss_qk(float (&d)[N / 2], uint64_t a, uint64_t b,
                                            int accumulate) {
  if constexpr (N == 64) {
    wgmma_ss_m64n64k16(d, a, b, accumulate);
  } else {
    wgmma_ss_m64n128k16(d, a, b, accumulate);
  }
}

// The second form at D = head_dim columns: O += P.V and the like.
template <int D>
__device__ __forceinline__ void wgmma_rs_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (D == 64) {
    wgmma_rs_m64n64k16(d, a, b);
  } else {
    wgmma_rs_m64n128k16(d, a, b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Two neighbouring gradient elements, cast once, to bf16 or f32.
__device__ __forceinline__ void store_pair(bf16* dst, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(lo, hi);
}
__device__ __forceinline__ void store_pair(float* dst, float lo, float hi) {
  *reinterpret_cast<float2*>(dst) = make_float2(lo, hi);
}

// Rows [row0, row0 + ROWS) of one head (row stride `row_stride`, D bf16
// each) into wgmma's 128-byte swizzle layout: D / 64 column blocks of
// ROWS x 128 bytes, block b at byte b * ROWS * 128, row r at r * 128 in
// it, and its 16-byte chunk c at ((c ^ (r % 8)) * 16). dst is 1024-byte
// aligned. Eight lanes copy one row's 128 bytes, so a warp reads 4 whole
// lines and writes 4 rows without bank conflicts. Rows at or past nrows
// are zero-filled. K-major this is the first form's A and B operand (SBO
// 1024 bytes); read MN-major it is the second form's B (LBO ROWS * 128,
// SBO 1024).
template <int ROWS, int D, int NT>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                long long row_stride, int row0, int nrows) {
  constexpr int kChunks = ROWS * D / 8;
  static_assert(kChunks % NT == 0, "every thread copies the same number of chunks");
#pragma unroll
  for (int n = 0; n < kChunks / NT; ++n) {
    const int i = n * NT + threadIdx.x;  // (block b, row r, chunk c), c fastest
    const int c = i & 7;
    const int r = (i >> 3) % ROWS;
    const int b = (i >> 3) / ROWS;
    const bool in = row0 + r < nrows;
    cp_async_16(reinterpret_cast<char*>(dst) + (b * ROWS + r) * 128 + ((c ^ (r & 7)) << 4),
                src + (in ? row0 + r : row0) * row_stride + b * 64 + c * 8, in);
  }
}

// The first byte of the dynamic shared memory that is 1024-byte aligned,
// as the swizzle needs.
__device__ __forceinline__ char* smem_1024(char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// ---------------------------------------------------------------------------
// bf16 forward.

// Shared memory of a block that owns 64 * WG query rows: OWN tiles of
// them (Q; Q and dO), then the ring's stages (K, V and the key positions
// of N-key tiles), every tile on a 1024-byte boundary as the swizzle
// needs; 1024 bytes of slack to align the dynamic shared memory itself.
template <int D, int WG, int N, int OWN>
struct QueryBlockSmem {
  static constexpr int kRowsQ = 64 * WG;
  static constexpr size_t q = r1024(kRowsQ * D * sizeof(bf16));
  static constexpr size_t kv = r1024(N * D * sizeof(bf16));
  static constexpr size_t stage = r1024(2 * kv + N * sizeof(int));
  static constexpr size_t fixed = 1024 + OWN * q + kStages * stage + r128(32 * sizeof(int));
  static size_t bytes(int sk) { return fixed + r128(((sk + N - 1) / N) * sizeof(int)); }
};

template <int D, int WG>
using FwdWgmmaSmem = QueryBlockSmem<D, WG, kFwdBlockN, 1>;

// One block of WG warpgroups per (64 * WG query rows, head, batch);
// warpgroup w owns rows [64 w, 64 w + 64) of the tile.
template <int D, int WG>
__global__ void __launch_bounds__(128 * WG, 1) flash_fwd_wgmma_kernel(const FlashParams p) {
  using L = FwdWgmmaSmem<D, WG>;
  constexpr int NT = 128 * WG;
  constexpr int N = kFwdBlockN;
  extern __shared__ __align__(128) char smem_raw[];
  SmemAlloc sm{smem_1024(smem_raw)};
  bf16* sQ = sm.take<bf16>(L::kRowsQ * D);
  char* sRing = sm.take<char>(kStages * L::stage);
  int* sRed = sm.take<int>(32);
  int* sKmin = sm.take<int>((p.sk + N - 1) / N);

  const int tile = gridDim.z - 1 - blockIdx.z;  // longest causal rows first, all heads
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int kvh = hh / (p.h / p.kvh);
  const int q0 = tile * L::kRowsQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_in = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);  // row i = 0; i = 1 is + 8
  const int c2 = 2 * (lane & 3);

  const bf16* q = static_cast<const bf16*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.qpos + (long long)bb * p.sq;
  const int* kpos = p.kpos + (long long)bb * p.sk;

  // Tile t's K, V and key positions into ring stage st, as one copy group.
  auto load_stage = [&](int st, int t) {
    char* base = sRing + st * L::stage;
    const int k0 = t * N;
    load_rows_async<N, D, NT>(reinterpret_cast<bf16*>(base), k, p.k_ss, k0, p.sk);
    load_rows_async<N, D, NT>(reinterpret_cast<bf16*>(base + L::kv), v, p.v_ss, k0, p.sk);
    const int c = threadIdx.x;
    if (c < N) {
      const bool in = k0 + c < p.sk;
      cp_async_4(reinterpret_cast<int*>(base + 2 * L::kv) + c, kpos + (in ? k0 + c : 0), in);
    }
  };

  load_rows_async<L::kRowsQ, D, NT>(sQ, q, p.q_ss, q0, p.sq);
  const int qmax =
      block_positions<L::kRowsQ, true>(qpos, q0, p.sq, kpos, p.sk, N, sRed, sKmin);
  const int nk = (p.sk + N - 1) / N;
  // The next tile at or after t that is not wholly above the diagonal
  // (block-uniform: every thread reads the same kmin).
  auto next_live = [&](int t) {
    while (t < nk && sKmin[t] > qmax) ++t;
    return t;
  };
  // One copy group per ring stage, the first with Q; an empty group when
  // no live tile is left, so that group i always holds the i-th tile.
  int t = next_live(0);
  int fetch = t;  // the next live tile to load
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (fetch < nk) {
      load_stage(st, fetch);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
  }

  int qp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_in + 8 * i;
    qp[i] = row < p.sq ? qpos[row] : INT_MIN;
  }
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, log2 units, as the quad agrees on it
  float l[2] = {0.f, 0.f};          // running sum of this thread's columns, f32
  const float scale_log2 = p.scale * kLog2e;
  // Q: this warpgroup's 64 rows, K-major.
  const uint64_t q_desc = smem_desc_sw128(sQ + (warp >> 2) * 64 * 64, 16, 1024);

  for (int it = 0; t < nk; ++it) {
    const int st = it % kStages;
    cp_async_wait_for_wgmma<kStages - 2>();
    __syncthreads();  // tile t has landed for all; the stage of tile t - 1 is free again
    if (fetch < nk) {
      load_stage((it + kStages - 1) % kStages, fetch);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();

    const char* base = sRing + st * L::stage;
    const bf16* sK = reinterpret_cast<const bf16*>(base);
    const bf16* sV = reinterpret_cast<const bf16*>(base + L::kv);
    const int* sKpos = reinterpret_cast<const int*>(base + 2 * L::kv);
    const int k0 = t * N;

    // S = Q . K^T: D / 16 steps along head_dim, K K-major like Q.
    float s[N / 2];
    const uint64_t k_desc = smem_desc_sw128(sK, 16, 1024);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_qk<N>(s, q_desc + k_step(L::kRowsQ, kk), k_desc + k_step(N, kk), kk);
    }
    wgmma_commit_and_wait();
    fence_regs(s);

    // Scale to log2 units and mask from the positions; masked entries take
    // the sentinel and, below, p = 0.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + c2 + e;
        const int kp = sKpos[col];
        const bool in = k0 + col < p.sk;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float& x = s[4 * j + 2 * i + e];
          x = (in && qp[i] >= kp) ? x * scale_log2 : kNegInf;
          mx[i] = fmaxf(mx[i], x);
        }
      }
    }
    float corr[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      corr[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      // A row with nothing unmasked yet subtracts 0, so its sentinels give
      // exp2(-1e30) = 0 and not exp2(0).
      mu[i] = m_new <= kNegInf ? 0.f : m_new;
    }
    // p in f32 into l, unrounded; rounded to bf16 for P.V. The pairs come
    // out in the A-fragment order: P.V step kk takes pr[4 kk, 4 kk + 4).
    uint32_t pr[N / 4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float p0 = exp2f(s[4 * j + 2 * i] - mu[i]);
        const float p1 = exp2f(s[4 * j + 2 * i + 1] - mu[i]);
        rs[i] += p0 + p1;
        pr[2 * j + i] = pack_bf16(p0, p1);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) o[4 * j + 2 * i + e] *= corr[i];
      }
    }

    // O += P . V: N / 16 steps along the KV tile, V read MN-major. The
    // correction and the packing are pinned before the fence.
    fence_regs(o);
    fence_regs(pr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t a[4] = {pr[4 * kk], pr[4 * kk + 1], pr[4 * kk + 2], pr[4 * kk + 3]};
      wgmma_rs_pv<D>(o, a, smem_desc_sw128(sV + kk * 16 * 64, N * 128, 1024));
    }
    wgmma_commit_and_wait();
    fence_regs(o);
    t = next_live(t + 1);
  }
  cp_async_wait_for_wgmma<0>();  // no copy outlives the block

  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = l[i] + __shfl_xor_sync(0xffffffffu, l[i], 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = q0 + row_in + 8 * i;
    if (row >= p.sq) continue;
    const bool empty = m[i] <= kNegInf;
    const float ls = fmaxf(sum, 1e-30f);
    const float inv = empty ? 0.f : 1.f / ls;
    const long long at = ((long long)bb * p.sq + row) * p.h + hh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_pair(out + at * D + 8 * j + c2, o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
    }
    if ((lane & 3) == 0) p.lse_out[at] = empty ? kNegInf : m[i] * kLn2 + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// bf16 dq.

template <int D, int WG>
using DqWgmmaSmem = QueryBlockSmem<D, WG, kDqBlockN, 2>;

// One block of WG warpgroups per (64 * WG query rows, head, batch), as the
// forward. Per KV tile: S = Q.K^T and dP = dO.V^T (first form), then
// dQ += dS.K (second form, K read MN-major). lse and delta of the thread's
// two rows sit in registers for the whole loop.
template <int D, int WG, typename OutT>
__global__ void __launch_bounds__(128 * WG, 1) flash_bwd_dq_wgmma_kernel(const FlashParams p) {
  using L = DqWgmmaSmem<D, WG>;
  constexpr int NT = 128 * WG;
  constexpr int N = kDqBlockN;
  extern __shared__ __align__(128) char smem_raw[];
  SmemAlloc sm{smem_1024(smem_raw)};
  bf16* sQ = sm.take<bf16>(L::kRowsQ * D);
  bf16* sDO = sm.take<bf16>(L::kRowsQ * D);
  char* sRing = sm.take<char>(kStages * L::stage);
  int* sRed = sm.take<int>(32);
  int* sKmin = sm.take<int>((p.sk + N - 1) / N);

  const int tile = gridDim.z - 1 - blockIdx.z;  // longest causal rows first, all heads
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int kvh = hh / (p.h / p.kvh);
  const int q0 = tile * L::kRowsQ;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_in = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);  // row i = 0; i = 1 is + 8
  const int c2 = 2 * (lane & 3);

  const bf16* q = static_cast<const bf16*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const bf16* dout = static_cast<const bf16*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.qpos + (long long)bb * p.sq;
  const int* kpos = p.kpos + (long long)bb * p.sk;

  // Tile t's K, V and key positions into ring stage st, as one copy group;
  // keys past sk take position INT_MAX, which masks them.
  auto load_stage = [&](int st, int t) {
    char* base = sRing + st * L::stage;
    const int k0 = t * N;
    load_rows_async<N, D, NT>(reinterpret_cast<bf16*>(base), k, p.k_ss, k0, p.sk);
    load_rows_async<N, D, NT>(reinterpret_cast<bf16*>(base + L::kv), v, p.v_ss, k0, p.sk);
    int* pos = reinterpret_cast<int*>(base + 2 * L::kv);
    const int c = threadIdx.x;
    if (c < N) {
      if (k0 + c < p.sk) {
        cp_async_4(pos + c, kpos + k0 + c, true);
      } else {
        pos[c] = INT_MAX;
      }
    }
  };

  load_rows_async<L::kRowsQ, D, NT>(sQ, q, p.q_ss, q0, p.sq);
  load_rows_async<L::kRowsQ, D, NT>(sDO, dout, p.do_ss, q0, p.sq);
  const int qmax =
      block_positions<L::kRowsQ, true>(qpos, q0, p.sq, kpos, p.sk, N, sRed, sKmin);
  const int nk = (p.sk + N - 1) / N;
  auto next_live = [&](int t) {
    while (t < nk && sKmin[t] > qmax) ++t;
    return t;
  };
  int t = next_live(0);
  int fetch = t;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (fetch < nk) {
      load_stage(st, fetch);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
  }

  // The thread's two rows: position (INT_MIN past sq), lse in log2 units
  // and delta (0 past sq).
  int qp[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_in + 8 * i;
    const bool in = row < p.sq;
    const long long at = ((long long)bb * p.sq + (in ? row : 0)) * p.h + hh;
    qp[i] = in ? qpos[row] : INT_MIN;
    lse2[i] = in ? p.lse[at] * kLog2e : 0.f;
    dl[i] = in ? p.delta[at] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  const float scale_log2 = p.scale * kLog2e;
  const uint64_t q_desc = smem_desc_sw128(sQ + (warp >> 2) * 64 * 64, 16, 1024);
  const uint64_t do_desc = smem_desc_sw128(sDO + (warp >> 2) * 64 * 64, 16, 1024);

  for (int it = 0; t < nk; ++it) {
    const int st = it % kStages;
    cp_async_wait_for_wgmma<kStages - 2>();
    __syncthreads();  // tile t has landed for all; the stage of tile t - 1 is free again
    if (fetch < nk) {
      load_stage((it + kStages - 1) % kStages, fetch);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();

    const char* base = sRing + st * L::stage;
    const bf16* sK = reinterpret_cast<const bf16*>(base);
    const bf16* sV = reinterpret_cast<const bf16*>(base + L::kv);
    const int* sKpos = reinterpret_cast<const int*>(base + 2 * L::kv);

    // S = Q.K^T and dP = dO.V^T: D / 16 steps each along head_dim, every
    // operand K-major.
    float s[N / 2], dp[N / 2];
    const uint64_t k_desc = smem_desc_sw128(sK, 16, 1024);
    const uint64_t v_desc = smem_desc_sw128(sV, 16, 1024);
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_qk<N>(s, q_desc + k_step(L::kRowsQ, kk), k_desc + k_step(N, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_qk<N>(dp, do_desc + k_step(L::kRowsQ, kk), v_desc + k_step(N, kk), kk);
    }
    wgmma_commit_and_wait();
    fence_regs(s);
    fence_regs(dp);

    // p from the global lse, exactly 0 where masked; ds = p (dP - delta)
    // scale in f32 from the unrounded p, rounded to bf16 in the A-fragment
    // order: dS.K step kk takes ds[4 kk, 4 kk + 4).
    uint32_t ds[N / 4];
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const int2 kp = *reinterpret_cast<const int2*>(sKpos + 8 * j + c2);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int a = 4 * j + 2 * i;
        const bool m0 = qp[i] >= kp.x, m1 = qp[i] >= kp.y;
        const float p0 = m0 ? exp2f(s[a] * scale_log2 - lse2[i]) : 0.f;
        const float p1 = m1 ? exp2f(s[a + 1] * scale_log2 - lse2[i]) : 0.f;
        const float d0 = dp[a] - dl[i], d1 = dp[a + 1] - dl[i];
        ds[2 * j + i] = pack_bf16(p0 * d0 * p.scale, p1 * d1 * p.scale);
      }
    }

    // dQ += dS.K: N / 16 steps along the KV tile, K read MN-major (the same
    // shared tile as for S, under a second descriptor).
    fence_regs(dq);
    fence_regs(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2], ds[4 * kk + 3]};
      wgmma_rs_pv<D>(dq, a, smem_desc_sw128(sK + kk * 16 * 64, N * 128, 1024));
    }
    wgmma_commit_and_wait();
    fence_regs(dq);
    t = next_live(t + 1);
  }
  cp_async_wait_for_wgmma<0>();  // no copy outlives the block

  OutT* out = static_cast<OutT*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_in + 8 * i;
    if (row >= p.sq) continue;
    const long long at = ((long long)bb * p.sq + row) * p.h + hh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_pair(out + at * D + 8 * j + c2, dq[4 * j + 2 * i], dq[4 * j + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 dk/dv.

// K and V, then the ring's stages (Q, dO, and the tile's query positions,
// lse and delta), every tile on a 1024-byte boundary.
template <int D, int WG>
struct DkvWgmmaSmem {
  static constexpr int kRowsK = 64 * WG;
  static constexpr size_t kv = r1024(kRowsK * D * sizeof(bf16));
  static constexpr size_t q = r1024(kDkvBlockQ * D * sizeof(bf16));
  static constexpr size_t row = r128(kDkvBlockQ * sizeof(int));  // one int or f32 per query
  static constexpr size_t stage = r1024(2 * q + 3 * row);
  static constexpr size_t fixed = 1024 + 2 * kv + kStages * stage + r128(32 * sizeof(int));
  static size_t bytes(int sq) {
    return fixed + r128(((sq + kDkvBlockQ - 1) / kDkvBlockQ) * sizeof(int));
  }
};

// One block of WG warpgroups per (64 * WG key rows, KV head, batch);
// warpgroup w owns keys [64 w, 64 w + 64) of the tile, so every
// accumulator is transposed: rows are keys, columns queries. Per query
// tile: S^T = K.Q^T and dP^T = V.dO^T (first form), then dV += P^T.dO and
// dK += dS^T.Q (second form, dO and Q read MN-major). The ring streams
// (GQA head, query tile) pairs of the whole group.
template <int D, int WG, typename OutT>
__global__ void __launch_bounds__(128 * WG, 1) flash_bwd_dkv_wgmma_kernel(const FlashParams p) {
  using L = DkvWgmmaSmem<D, WG>;
  constexpr int NT = 128 * WG;
  constexpr int BQ = kDkvBlockQ;
  extern __shared__ __align__(128) char smem_raw[];
  SmemAlloc sm{smem_1024(smem_raw)};
  bf16* sK = sm.take<bf16>(L::kRowsK * D);
  bf16* sV = sm.take<bf16>(L::kRowsK * D);
  char* sRing = sm.take<char>(kStages * L::stage);
  int* sRed = sm.take<int>(32);
  const int nq = (p.sq + BQ - 1) / BQ;
  int* sQmax = sm.take<int>(nq);

  // Low key tiles see the most queries under a causal mask: they launch
  // first, over all heads.
  const int kvh = blockIdx.x, bb = blockIdx.y;
  const int k0 = blockIdx.z * L::kRowsK;
  const int group = p.h / p.kvh;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row_in = (warp >> 2) * 64 + (warp & 3) * 16 + (lane >> 2);  // row i = 0; i = 1 is + 8
  const int c2 = 2 * (lane & 3);

  const bf16* k = static_cast<const bf16*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.qpos + (long long)bb * p.sq;
  const int* kpos = p.kpos + (long long)bb * p.sk;
  // The stream: item g * nq + qt is query tile qt of head g of the group.
  const int n_items = group * nq;

  // Item's Q, dO, query positions, lse and delta into ring stage st, as one
  // copy group; queries past sq take position INT_MIN, which masks them,
  // and lse and delta 0.
  auto load_stage = [&](int st, int item) {
    char* base = sRing + st * L::stage;
    const int hh = kvh * group + item / nq;
    const int q0 = (item % nq) * BQ;
    load_rows_async<BQ, D, NT>(reinterpret_cast<bf16*>(base),
                               static_cast<const bf16*>(p.q) + bb * p.q_sb + hh * p.q_sh,
                               p.q_ss, q0, p.sq);
    load_rows_async<BQ, D, NT>(reinterpret_cast<bf16*>(base + L::q),
                               static_cast<const bf16*>(p.dout) + bb * p.do_sb + hh * p.do_sh,
                               p.do_ss, q0, p.sq);
    int* pos = reinterpret_cast<int*>(base + 2 * L::q);
    float* lse = reinterpret_cast<float*>(base + 2 * L::q + L::row);
    float* delta = reinterpret_cast<float*>(base + 2 * L::q + 2 * L::row);
    const int c = threadIdx.x;
    if (c < BQ) {
      const bool in = q0 + c < p.sq;
      const long long at = ((long long)bb * p.sq + (in ? q0 + c : 0)) * p.h + hh;
      if (in) {
        cp_async_4(pos + c, qpos + q0 + c, true);
      } else {
        pos[c] = INT_MIN;
      }
      cp_async_4(lse + c, p.lse + at, in);
      cp_async_4(delta + c, p.delta + at, in);
    }
  };

  load_rows_async<L::kRowsK, D, NT>(sK, k, p.k_ss, k0, p.sk);
  load_rows_async<L::kRowsK, D, NT>(sV, v, p.v_ss, k0, p.sk);
  const int kmin =
      block_positions<L::kRowsK, false>(kpos, k0, p.sk, qpos, p.sq, BQ, sRed, sQmax);
  // The next item at or after `item` whose query tile is not wholly
  // before the block's keys (block-uniform). Positions are per batch, so
  // one tile list serves every head of the group.
  auto next_live = [&](int item) {
    while (item < n_items && sQmax[item % nq] < kmin) ++item;
    return item;
  };
  int item = next_live(0);
  int fetch = item;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (fetch < n_items) {
      load_stage(st, fetch);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();
  }

  // The thread's two keys' positions (INT_MAX past sk).
  int kp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + row_in + 8 * i;
    kp[i] = row < p.sk ? kpos[row] : INT_MAX;
  }
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.f;
    dv[i] = 0.f;
  }
  const float scale_log2 = p.scale * kLog2e;
  const uint64_t k_desc = smem_desc_sw128(sK + (warp >> 2) * 64 * 64, 16, 1024);
  const uint64_t v_desc = smem_desc_sw128(sV + (warp >> 2) * 64 * 64, 16, 1024);

  for (int it = 0; item < n_items; ++it) {
    const int st = it % kStages;
    cp_async_wait_for_wgmma<kStages - 2>();
    __syncthreads();  // this item has landed for all; the previous one's stage is free again
    if (fetch < n_items) {
      load_stage((it + kStages - 1) % kStages, fetch);
      fetch = next_live(fetch + 1);
    }
    cp_async_commit();

    const char* base = sRing + st * L::stage;
    const bf16* sQ = reinterpret_cast<const bf16*>(base);
    const bf16* sDO = reinterpret_cast<const bf16*>(base + L::q);
    const int* sQpos = reinterpret_cast<const int*>(base + 2 * L::q);
    const float* sLse = reinterpret_cast<const float*>(base + 2 * L::q + L::row);
    const float* sDelta = reinterpret_cast<const float*>(base + 2 * L::q + 2 * L::row);

    // S^T = K.Q^T and dP^T = V.dO^T: D / 16 steps each along head_dim,
    // every operand K-major.
    float sT[BQ / 2], dpT[BQ / 2];
    const uint64_t q_desc = smem_desc_sw128(sQ, 16, 1024);
    const uint64_t do_desc = smem_desc_sw128(sDO, 16, 1024);
    fence_regs(sT);
    fence_regs(dpT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_qk<BQ>(sT, k_desc + k_step(L::kRowsK, kk), q_desc + k_step(BQ, kk), kk);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wgmma_ss_qk<BQ>(dpT, v_desc + k_step(L::kRowsK, kk), do_desc + k_step(BQ, kk), kk);
    }
    wgmma_commit_and_wait();
    fence_regs(sT);
    fence_regs(dpT);

    // p^T from each column's (query's) lse, exactly 0 where masked; ds^T =
    // p^T (dP^T - delta) scale in f32 from the unrounded p. Both rounded
    // to bf16 in the A-fragment order: step kk takes [4 kk, 4 kk + 4).
    uint32_t pT[BQ / 4], dsT[BQ / 4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const int2 qp = *reinterpret_cast<const int2*>(sQpos + 8 * j + c2);
      const float2 lse = *reinterpret_cast<const float2*>(sLse + 8 * j + c2);
      const float2 dl = *reinterpret_cast<const float2*>(sDelta + 8 * j + c2);
      const float l0 = lse.x * kLog2e, l1 = lse.y * kLog2e;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int a = 4 * j + 2 * i;
        const bool m0 = qp.x >= kp[i], m1 = qp.y >= kp[i];
        const float p0 = m0 ? exp2f(sT[a] * scale_log2 - l0) : 0.f;
        const float p1 = m1 ? exp2f(sT[a + 1] * scale_log2 - l1) : 0.f;
        const float d0 = dpT[a] - dl.x, d1 = dpT[a + 1] - dl.y;
        pT[2 * j + i] = pack_bf16(p0, p1);
        dsT[2 * j + i] = pack_bf16(p0 * d0 * p.scale, p1 * d1 * p.scale);
      }
    }

    // dV += P^T.dO and dK += dS^T.Q: BQ / 16 steps along the query tile, dO
    // and Q read MN-major (the same shared tiles as above, under second
    // descriptors).
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pT);
    fence_regs(dsT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      const uint32_t a[4] = {pT[4 * kk], pT[4 * kk + 1], pT[4 * kk + 2], pT[4 * kk + 3]};
      wgmma_rs_pv<D>(dv, a, smem_desc_sw128(sDO + kk * 16 * 64, BQ * 128, 1024));
      const uint32_t b[4] = {dsT[4 * kk], dsT[4 * kk + 1], dsT[4 * kk + 2], dsT[4 * kk + 3]};
      wgmma_rs_pv<D>(dk, b, smem_desc_sw128(sQ + kk * 16 * 64, BQ * 128, 1024));
    }
    wgmma_commit_and_wait();
    fence_regs(dv);
    fence_regs(dk);
    item = next_live(item + 1);
  }
  cp_async_wait_for_wgmma<0>();  // no copy outlives the block

  OutT* dk_out = static_cast<OutT*>(p.dk);
  OutT* dv_out = static_cast<OutT*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = k0 + row_in + 8 * i;
    if (row >= p.sk) continue;
    const long long at = ((long long)bb * p.sk + row) * p.kvh + kvh;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      store_pair(dk_out + at * D + 8 * j + c2, dk[4 * j + 2 * i], dk[4 * j + 2 * i + 1]);
      store_pair(dv_out + at * D + 8 * j + c2, dv[4 * j + 2 * i], dv[4 * j + 2 * i + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the first design's FMA strips, for correctness.

// Rows [row0, row0 + ROWS) of one head (row stride `row_stride`) into a
// padded shared tile, 16 bytes per load; rows at or past `nrows` are zero.
template <int ROWS, int D>
__device__ void load_tile(float* dst, int ld, const float* src, long long row_stride, int row0,
                          int nrows) {
  constexpr int kVecPerRow = D / 4;
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// One warp: C[16][N] = scale * A[16][D] . B[N][D]^T (A, B row-major).
template <int N, int D>
__device__ void strip_abt(const float* A, int lda, const float* B, int ldb, float* C, int ldc,
                          float scale) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * N; i += 32) {
    const int r = i / N, col = i % N;
    float acc = 0.f;
    for (int k = 0; k < D; ++k) acc += A[r * lda + k] * B[col * ldb + k];
    C[r * ldc + col] = acc * scale;
  }
  __syncwarp();
}

// One warp: C[16][D] += P[16][N] . V[N][D] (P, V row-major).
template <int N, int D>
__device__ void strip_pv(const float* P, int ldp, const float* V, int ldv, float* C, int ldc) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < 16 * D; i += 32) {
    const int r = i / D, col = i % D;
    float acc = C[r * ldc + col];
    for (int k = 0; k < N; ++k) acc += P[r * ldp + k] * V[k * ldv + col];
    C[r * ldc + col] = acc;
  }
  __syncwarp();
}

// Padded leading dimensions; the pad staggers banks.
template <int D, int N>
struct Layout {
  static constexpr int LDT = D + 8;  // tiles of head_dim columns
  static constexpr int LDS = N + 4;  // score tiles
  static constexpr int LDP = N + 8;  // probability tiles
  static constexpr int LDO = D + 4;  // accumulators
  static constexpr size_t tile_t(int rows) { return r128(rows * LDT * sizeof(float)); }
  static constexpr size_t tile_s(int rows) { return r128(rows * LDS * sizeof(float)); }
  static constexpr size_t tile_p(int rows) { return r128(rows * LDP * sizeof(float)); }
  static constexpr size_t tile_o(int rows) { return r128(rows * LDO * sizeof(float)); }
  static constexpr size_t vec(int n) { return r128(n * 4); }
};

template <int D>
struct FwdSmem : Layout<D, kBlockK> {
  using L = Layout<D, kBlockK>;
  static constexpr size_t fixed = L::tile_t(kRows) + 2 * L::tile_t(kBlockK) +
                                  L::tile_s(kRows) + L::tile_p(kRows) + L::tile_o(kRows) +
                                  4 * L::vec(kRows) + L::vec(kBlockK) + L::vec(32);
  static size_t bytes(int sk) { return fixed + L::vec((sk + kBlockK - 1) / kBlockK); }
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_f32_kernel(const FlashParams p) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(128) char smem_raw[];
  SmemAlloc sm{smem_raw};
  float* sQ = sm.take<float>(kRows * L::LDT);
  float* sK = sm.take<float>(kBlockK * L::LDT);
  float* sV = sm.take<float>(kBlockK * L::LDT);
  float* sS = sm.take<float>(kRows * L::LDS);
  float* sP = sm.take<float>(kRows * L::LDP);
  float* sO = sm.take<float>(kRows * L::LDO);
  float* sM = sm.take<float>(kRows);
  float* sL = sm.take<float>(kRows);
  float* sCorr = sm.take<float>(kRows);
  int* sQpos = sm.take<int>(kRows);
  int* sKpos = sm.take<int>(kBlockK);
  int* sRed = sm.take<int>(32);
  int* sKmin = sm.take<int>((p.sk + kBlockK - 1) / kBlockK);

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (p.h / p.kvh);
  const int q0 = tile * kRows;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;

  const float* q = static_cast<const float*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.qpos + (long long)bb * p.sq;
  const int* kpos = p.kpos + (long long)bb * p.sk;

  load_tile<kRows, D>(sQ, L::LDT, q, p.q_ss, q0, p.sq);
  for (int i = tid; i < kRows; i += kThreads) {
    sQpos[i] = q0 + i < p.sq ? qpos[q0 + i] : INT_MIN;
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }
  for (int i = tid; i < kRows * L::LDO; i += kThreads) sO[i] = 0.f;
  const int qmax =
      block_positions<kRows, true>(qpos, q0, p.sq, kpos, p.sk, kBlockK, sRed, sKmin);

  const int nk = (p.sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < nk; ++kt) {
    if (sKmin[kt] > qmax) continue;  // wholly above the diagonal (block-uniform)
    const int k0 = kt * kBlockK;
    __syncthreads();  // every reader of the previous tile is done
    for (int i = tid; i < kBlockK; i += kThreads) {
      sKpos[i] = k0 + i < p.sk ? kpos[k0 + i] : INT_MAX;
    }
    load_tile<kBlockK, D>(sK, L::LDT, k, p.k_ss, k0, p.sk);
    load_tile<kBlockK, D>(sV, L::LDT, v, p.v_ss, k0, p.sk);
    __syncthreads();

    strip_abt<kBlockK, D>(sQ + r0 * L::LDT, L::LDT, sK, L::LDT, sS + r0 * L::LDS, L::LDS,
                          p.scale);
    for (int r = r0; r < r0 + 16; ++r) {
      const int qp = sQpos[r];
      float s[kBlockK / 32];
      bool ok[kBlockK / 32];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kBlockK / 32; ++j) {
        const int c = lane + 32 * j;
        ok[j] = (k0 + c < p.sk) && qp >= sKpos[c];
        s[j] = ok[j] ? sS[r * L::LDS + c] : kNegInf;
        mx = fmaxf(mx, s[j]);
      }
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBlockK / 32; ++j) {
        const float pj = ok[j] ? expf(s[j] - m_new) : 0.f;
        sum += pj;
        sP[r * L::LDP + lane + 32 * j] = pj;
      }
      sum = warp_sum(sum);
      const float corr = expf(m_prev - m_new);
      __syncwarp();  // every lane has read sM[r]
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * corr + sum;
        sCorr[r] = corr;
      }
    }
    __syncwarp();
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = r0 + i / D;
      sO[r * L::LDO + i % D] *= sCorr[r];
    }
    __syncwarp();
    strip_pv<kBlockK, D>(sP + r0 * L::LDP, L::LDP, sV, L::LDT, sO + r0 * L::LDO, L::LDO);
  }

  float* out = static_cast<float*>(p.out);
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    if (row >= p.sq) break;
    const bool empty = sM[r] <= kNegInf;
    const float l = fmaxf(sL[r], 1e-30f);
    const long long at = ((long long)bb * p.sq + row) * p.h + hh;
    for (int c = lane; c < D; c += 32) {
      out[at * D + c] = empty ? 0.f : sO[r * L::LDO + c] / l;
    }
    if (lane == 0) p.lse_out[at] = empty ? kNegInf : sM[r] + logf(l);
  }
}

template <int D>
struct DqSmem : Layout<D, kBlockK> {
  using L = Layout<D, kBlockK>;
  static constexpr size_t bytes = 2 * L::tile_t(kRows) + 2 * L::tile_t(kBlockK) +
                                  2 * L::tile_s(kRows) + L::tile_p(kRows) +
                                  L::tile_o(kRows) + 3 * L::vec(kRows) + L::vec(kBlockK);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_f32_kernel(const FlashParams p) {
  using L = DqSmem<D>;
  extern __shared__ __align__(128) char smem_raw[];
  SmemAlloc sm{smem_raw};
  float* sQ = sm.take<float>(kRows * L::LDT);
  float* sDO = sm.take<float>(kRows * L::LDT);
  float* sK = sm.take<float>(kBlockK * L::LDT);
  float* sV = sm.take<float>(kBlockK * L::LDT);
  float* sS = sm.take<float>(kRows * L::LDS);
  float* sDP = sm.take<float>(kRows * L::LDS);
  float* sDS = sm.take<float>(kRows * L::LDP);
  float* sDQ = sm.take<float>(kRows * L::LDO);
  float* sLse = sm.take<float>(kRows);
  float* sDelta = sm.take<float>(kRows);
  int* sQpos = sm.take<int>(kRows);
  int* sKpos = sm.take<int>(kBlockK);

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (p.h / p.kvh);
  const int q0 = tile * kRows;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;

  const float* q = static_cast<const float*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const float* dout = static_cast<const float*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  const float* k = static_cast<const float*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.qpos + (long long)bb * p.sq;
  const int* kpos = p.kpos + (long long)bb * p.sk;

  load_tile<kRows, D>(sQ, L::LDT, q, p.q_ss, q0, p.sq);
  load_tile<kRows, D>(sDO, L::LDT, dout, p.do_ss, q0, p.sq);
  for (int i = tid; i < kRows; i += kThreads) {
    const bool in = q0 + i < p.sq;
    const long long at = ((long long)bb * p.sq + q0 + i) * p.h + hh;
    sQpos[i] = in ? qpos[q0 + i] : INT_MIN;
    sLse[i] = in ? p.lse[at] : 0.f;
    sDelta[i] = in ? p.delta[at] : 0.f;
  }
  for (int i = tid; i < kRows * L::LDO; i += kThreads) sDQ[i] = 0.f;
  __syncthreads();
  int qmax = INT_MIN;
  for (int i = 0; i < kRows; ++i) qmax = max(qmax, sQpos[i]);

  const int nk = (p.sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    for (int i = tid; i < kBlockK; i += kThreads) {
      sKpos[i] = k0 + i < p.sk ? kpos[k0 + i] : INT_MAX;
    }
    __syncthreads();
    int kmin = INT_MAX;
    for (int i = 0; i < kBlockK; ++i) kmin = min(kmin, sKpos[i]);
    if (kmin > qmax) continue;
    load_tile<kBlockK, D>(sK, L::LDT, k, p.k_ss, k0, p.sk);
    load_tile<kBlockK, D>(sV, L::LDT, v, p.v_ss, k0, p.sk);
    __syncthreads();

    strip_abt<kBlockK, D>(sQ + r0 * L::LDT, L::LDT, sK, L::LDT, sS + r0 * L::LDS, L::LDS,
                          p.scale);
    strip_abt<kBlockK, D>(sDO + r0 * L::LDT, L::LDT, sV, L::LDT, sDP + r0 * L::LDS, L::LDS,
                          1.f);
    for (int i = lane; i < 16 * kBlockK; i += 32) {
      const int r = r0 + i / kBlockK, c = i % kBlockK;
      const bool ok = (k0 + c < p.sk) && sQpos[r] >= sKpos[c];
      const float pr = ok ? expf(sS[r * L::LDS + c] - sLse[r]) : 0.f;
      sDS[r * L::LDP + c] = pr * (sDP[r * L::LDS + c] - sDelta[r]) * p.scale;
    }
    __syncwarp();
    strip_pv<kBlockK, D>(sDS + r0 * L::LDP, L::LDP, sK, L::LDT, sDQ + r0 * L::LDO, L::LDO);
  }

  float* dq = static_cast<float*>(p.dq);
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    if (row >= p.sq) break;
    const long long at = ((long long)bb * p.sq + row) * p.h + hh;
    for (int c = lane; c < D; c += 32) dq[at * D + c] = sDQ[r * L::LDO + c];
  }
}

template <int D>
struct DkvSmem : Layout<D, kDkvBlockQF32> {
  static constexpr int BQ = kDkvBlockQF32;
  using L = Layout<D, BQ>;
  static constexpr size_t bytes = 2 * L::tile_t(kRows) + 2 * L::tile_t(BQ) +
                                  2 * L::tile_s(kRows) + 2 * L::tile_p(kRows) +
                                  2 * L::tile_o(kRows) +
                                  3 * L::vec(BQ) + L::vec(kRows);
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_f32_kernel(const FlashParams p) {
  using L = DkvSmem<D>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(128) char smem_raw[];
  SmemAlloc sm{smem_raw};
  float* sK = sm.take<float>(kRows * L::LDT);
  float* sV = sm.take<float>(kRows * L::LDT);
  float* sQ = sm.take<float>(BQ * L::LDT);
  float* sDO = sm.take<float>(BQ * L::LDT);
  float* sSt = sm.take<float>(kRows * L::LDS);
  float* sDPt = sm.take<float>(kRows * L::LDS);
  float* sPt = sm.take<float>(kRows * L::LDP);
  float* sDSt = sm.take<float>(kRows * L::LDP);
  float* sDK = sm.take<float>(kRows * L::LDO);
  float* sDV = sm.take<float>(kRows * L::LDO);
  float* sLse = sm.take<float>(BQ);
  float* sDelta = sm.take<float>(BQ);
  int* sQpos = sm.take<int>(BQ);
  int* sKpos = sm.take<int>(kRows);

  // Low kv tiles see the most queries under a causal mask: natural order
  // already launches the heaviest first.
  const int k0 = blockIdx.x * kRows;
  const int kvh = blockIdx.y, bb = blockIdx.z;
  const int group = p.h / p.kvh;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;

  const float* k = static_cast<const float*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.qpos + (long long)bb * p.sq;
  const int* kpos = p.kpos + (long long)bb * p.sk;

  load_tile<kRows, D>(sK, L::LDT, k, p.k_ss, k0, p.sk);
  load_tile<kRows, D>(sV, L::LDT, v, p.v_ss, k0, p.sk);
  for (int i = tid; i < kRows; i += kThreads) {
    sKpos[i] = k0 + i < p.sk ? kpos[k0 + i] : INT_MAX;
  }
  for (int i = tid; i < kRows * L::LDO; i += kThreads) {
    sDK[i] = 0.f;
    sDV[i] = 0.f;
  }
  __syncthreads();
  int kmin = INT_MAX;
  for (int i = 0; i < kRows; ++i) kmin = min(kmin, sKpos[i]);

  const int nq = (p.sq + BQ - 1) / BQ;
  // The GQA group is summed here, so dk/dv are written once per kv head.
  for (int g = 0; g < group; ++g) {
    const int hh = kvh * group + g;
    const float* q = static_cast<const float*>(p.q) + bb * p.q_sb + hh * p.q_sh;
    const float* dout = static_cast<const float*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
    for (int qt = 0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      for (int i = tid; i < BQ; i += kThreads) {
        const bool in = q0 + i < p.sq;
        const long long at = ((long long)bb * p.sq + q0 + i) * p.h + hh;
        sQpos[i] = in ? qpos[q0 + i] : INT_MIN;
        sLse[i] = in ? p.lse[at] : 0.f;
        sDelta[i] = in ? p.delta[at] : 0.f;
      }
      __syncthreads();
      int qmax = INT_MIN;
      for (int i = 0; i < BQ; ++i) qmax = max(qmax, sQpos[i]);
      if (qmax < kmin) continue;  // every query is before every key
      load_tile<BQ, D>(sQ, L::LDT, q, p.q_ss, q0, p.sq);
      load_tile<BQ, D>(sDO, L::LDT, dout, p.do_ss, q0, p.sq);
      __syncthreads();

      strip_abt<BQ, D>(sK + r0 * L::LDT, L::LDT, sQ, L::LDT, sSt + r0 * L::LDS, L::LDS,
                       p.scale);
      strip_abt<BQ, D>(sV + r0 * L::LDT, L::LDT, sDO, L::LDT, sDPt + r0 * L::LDS, L::LDS, 1.f);
      for (int i = lane; i < 16 * BQ; i += 32) {
        const int r = r0 + i / BQ, c = i % BQ;
        const bool ok = (k0 + r < p.sk) && sQpos[c] >= sKpos[r];
        const float pr = ok ? expf(sSt[r * L::LDS + c] - sLse[c]) : 0.f;
        sPt[r * L::LDP + c] = pr;
        sDSt[r * L::LDP + c] = pr * (sDPt[r * L::LDS + c] - sDelta[c]) * p.scale;
      }
      __syncwarp();
      strip_pv<BQ, D>(sPt + r0 * L::LDP, L::LDP, sDO, L::LDT, sDV + r0 * L::LDO, L::LDO);
      strip_pv<BQ, D>(sDSt + r0 * L::LDP, L::LDP, sQ, L::LDT, sDK + r0 * L::LDO, L::LDO);
    }
  }

  float* dk = static_cast<float*>(p.dk);
  float* dv = static_cast<float*>(p.dv);
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = k0 + r;
    if (row >= p.sk) break;
    const long long at = ((long long)bb * p.sk + row) * p.kvh + kvh;
    for (int c = lane; c < D; c += 32) {
      dk[at * D + c] = sDK[r * L::LDO + c];
      dv[at * D + c] = sDV[r * L::LDO + c];
    }
  }
}

// ---------------------------------------------------------------------------
// Launch plans.

// One kernel instance with its grid, threads and dynamic shared memory;
// fn is null where no instance is built.
struct Plan {
  const void* fn;
  dim3 grid;
  int threads;
  size_t smem;
};

// The bf16 backward kernels: dq over (heads, batch, query tiles), longest
// rows first inside the kernel; dk/dv over (KV heads, batch, key tiles),
// key tiles ascending so the heaviest blocks start first.
template <int D, typename OutT>
Plan bwd_bf16_plan(int kernel, const FlashParams& p) {
  if (kernel == kDq) {
    constexpr int WG = kDqWarpgroups;
    return {(const void*)flash_bwd_dq_wgmma_kernel<D, WG, OutT>,
            dim3(p.h, p.b, (p.sq + 64 * WG - 1) / (64 * WG)), 128 * WG,
            DqWgmmaSmem<D, WG>::bytes(p.sk)};
  }
  constexpr int WG = kDkvWarpgroups;
  return {(const void*)flash_bwd_dkv_wgmma_kernel<D, WG, OutT>,
          dim3(p.kvh, p.b, (p.sk + 64 * WG - 1) / (64 * WG)), 128 * WG,
          DkvWgmmaSmem<D, WG>::bytes(p.sq)};
}

template <int D>
Plan plan_for(int kernel, int dtype, int out_f32, const FlashParams& p) {
  if (dtype == kBF16) {
    if (kernel != kFwd) {
      return out_f32 ? bwd_bf16_plan<D, float>(kernel, p) : bwd_bf16_plan<D, bf16>(kernel, p);
    }
    // The forward's grid: heads, batch, then query tiles, so that the
    // block scheduler takes the heaviest tiles of every head first.
    constexpr int WG = kFwdWarpgroups;
    return {(const void*)flash_fwd_wgmma_kernel<D, WG>,
            dim3(p.h, p.b, (p.sq + 64 * WG - 1) / (64 * WG)), 128 * WG,
            FwdWgmmaSmem<D, WG>::bytes(p.sk)};
  }
  // f32 (gradients always f32): one block of 4 warps per 64-row tile.
  if (kernel == kFwd) {
    return {(const void*)flash_fwd_f32_kernel<D>, dim3((p.sq + kRows - 1) / kRows, p.h, p.b),
            kThreads, FwdSmem<D>::bytes(p.sk)};
  }
  if (kernel == kDq) {
    return {(const void*)flash_bwd_dq_f32_kernel<D>, dim3((p.sq + kRows - 1) / kRows, p.h, p.b),
            kThreads, DqSmem<D>::bytes};
  }
  return {(const void*)flash_bwd_dkv_f32_kernel<D>, dim3((p.sk + kRows - 1) / kRows, p.kvh, p.b),
          kThreads, DkvSmem<D>::bytes};
}

Plan plan(int kernel, int dtype, int out_f32, const FlashParams& p) {
  const bool known =
      (dtype == kBF16 || dtype == kF32) && (kernel == kFwd || kernel == kDq || kernel == kDkv);
  if (known && p.d == 64) return plan_for<64>(kernel, dtype, out_f32, p);
  if (known && p.d == 128) return plan_for<128>(kernel, dtype, out_f32, p);
  return {nullptr, dim3(), 0, 0};
}

int run(const Plan& k, const FlashParams& p, void* stream) {
  if (!k.fn) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {const_cast<FlashParams*>(&p)};
  cudaLaunchKernel(k.fn, k.grid, dim3(k.threads), args, k.smem,
                   static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

}  // namespace

// Entry points. `dtype` is 0 for float32 and 1 for bfloat16; `out_f32`
// selects f32 gradients (else the input type). Each returns the launch's
// cudaError_t (0 on success); cudaErrorInvalidValue for an unsupported
// dtype or head_dim (64 and 128 are built).
extern "C" {

int tpuft_flash_fwd(const FlashParams* p, int dtype, void* stream) {
  return run(plan(kFwd, dtype, 0, *p), *p, stream);
}

int tpuft_flash_bwd_dq(const FlashParams* p, int dtype, int out_f32, void* stream) {
  return run(plan(kDq, dtype, out_f32, *p), *p, stream);
}

int tpuft_flash_bwd_dkv(const FlashParams* p, int dtype, int out_f32, void* stream) {
  return run(plan(kDkv, dtype, out_f32, *p), *p, stream);
}

// The resources of one kernel instance (`kernel` 0 forward, 1 dq, 2 dk/dv)
// at sequence length `s` (its shared memory holds one int per streamed
// tile): out[0] resident blocks per SM, out[1] threads per block, out[2]
// registers and out[3] local-memory bytes (spills and stack) per thread.
int tpuft_flash_resources(int kernel, int dtype, int out_f32, int d, int s, int* out) {
  FlashParams p{};
  p.b = p.h = p.kvh = 1;
  p.sq = p.sk = s;
  p.d = d;
  const Plan k = plan(kernel, dtype, out_f32, p);
  if (!k.fn) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)k.smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], k.fn, k.threads, k.smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k.fn);
  if (err != cudaSuccess) return (int)err;
  out[1] = k.threads;
  out[2] = attr.numRegs;
  out[3] = (int)attr.localSizeBytes;
  return 0;
}

}  // extern "C"
