// Causal GQA flash attention for Hopper (sm_90a): forward, dq and dk/dv.
//
// Replaces the three Pallas TPU kernels of torchft_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _flash_fwd / _fwd_kernel
//   flash_bwd_dq_kernel  <- flash_attention_partial_bwd / _bwd_dq_kernel
//   flash_bwd_dkv_kernel <- flash_attention_partial_bwd / _bwd_dkv_kernel
// and computes what they compute: masks from explicit int32 position arrays
// (q_pos >= k_pos, so permuted ring/zigzag layouts work), skips a tile that
// lies wholly above the diagonal, gives empty rows out = 0 and lse = -1e30,
// and rounds to the input type where the TPU kernels round (p before P.V,
// ds before dS.K, p and ds before the dk/dv products). Accumulators are f32.
//
// What bounds them on the H100: at the train step's shapes (s = 2048,
// d = 128) every kernel does ~2*d flops per byte it must move, far above
// the card's ~295 bf16 flops per byte, so the tensor cores are the bound.
// This first version feeds them with WMMA bf16 16x16x16 products out of
// shared memory (no wgmma, TMA or warp specialisation yet): each block of
// 4 warps holds a 64-row tile and each warp owns a 16-row strip, so the
// softmax bookkeeping for a row never leaves its warp. Accumulators live in
// shared memory as f32, which lets the online-softmax rescale work without
// knowing the fragment layout. Causal tiles are launched heaviest first.
// The f32 instantiation runs the same code with FMA products in place of
// WMMA, for correctness rather than speed.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu

#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 128;  // 4 warps; warp w owns rows [16w, 16w + 16)
constexpr int kRows = 64;      // rows of a block's own tile
constexpr int kBlockK = 64;    // kv rows per inner step of fwd and dq
constexpr float kNegInf = -1e30f;
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

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

struct SmemAlloc {
  char* p;
  template <typename U>
  __device__ U* take(int count) {
    U* r = reinterpret_cast<U*>(p);
    p += r128(count * sizeof(U));
    return r;
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
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

// Rows [row0, row0 + ROWS) of one head (row stride `row_stride`) into a
// padded shared tile, 16 bytes per load; rows at or past `nrows` are zero.
template <typename T, int ROWS, int D>
__device__ void load_tile(T* dst, int ld, const T* src, long long row_stride,
                          int row0, int nrows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < ROWS * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// One warp: C[16][N] = scale * A[16][D] . B[N][D]^T (f32 out; A, B row-major).
template <typename T, int N, int D>
__device__ void strip_abt(const T* A, int lda, const T* B, int ldb, float* C,
                          int ldc, float scale) {
  if constexpr (std::is_same<T, bf16>::value) {
    for (int n0 = 0; n0 < N; n0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::fill_fragment(c, 0.0f);
#pragma unroll
      for (int k0 = 0; k0 < D; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, A + k0, lda);
        wmma::load_matrix_sync(b, B + n0 * ldb + k0, ldb);
        wmma::mma_sync(c, a, b, c);
      }
#pragma unroll
      for (int i = 0; i < c.num_elements; ++i) c.x[i] *= scale;
      wmma::store_matrix_sync(C + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int i = lane; i < 16 * N; i += 32) {
      const int r = i / N, col = i % N;
      float acc = 0.f;
      for (int k = 0; k < D; ++k) acc += A[r * lda + k] * B[col * ldb + k];
      C[r * ldc + col] = acc * scale;
    }
  }
  __syncwarp();
}

// One warp: C[16][D] += P[16][N] . V[N][D] (f32 accumulator; P, V row-major).
template <typename T, int N, int D>
__device__ void strip_pv(const T* P, int ldp, const T* V, int ldv, float* C,
                         int ldc) {
  if constexpr (std::is_same<T, bf16>::value) {
    for (int d0 = 0; d0 < D; d0 += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      wmma::load_matrix_sync(c, C + d0, ldc, wmma::mem_row_major);
#pragma unroll
      for (int k0 = 0; k0 < N; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, P + k0, ldp);
        wmma::load_matrix_sync(b, V + k0 * ldv + d0, ldv);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + d0, c, ldc, wmma::mem_row_major);
    }
  } else {
    const int lane = threadIdx.x & 31;
    for (int i = lane; i < 16 * D; i += 32) {
      const int r = i / D, col = i % D;
      float acc = C[r * ldc + col];
      for (int k = 0; k < N; ++k) acc += P[r * ldp + k] * V[k * ldv + col];
      C[r * ldc + col] = acc;
    }
  }
  __syncwarp();
}

// Padded leading dimensions: every 16-row strip and 16-column step starts
// on a 32-byte boundary (wmma's requirement) and the pad staggers banks.
template <typename T, int D, int N>
struct Layout {
  static constexpr int LDT = D + 8;  // T tiles of head_dim columns
  static constexpr int LDS = N + 4;  // f32 score tiles
  static constexpr int LDP = N + 8;  // T probability tiles
  static constexpr int LDO = D + 4;  // f32 accumulators
  static constexpr size_t tile_t(int rows) { return r128(rows * LDT * sizeof(T)); }
  static constexpr size_t tile_s(int rows) { return r128(rows * LDS * sizeof(float)); }
  static constexpr size_t tile_p(int rows) { return r128(rows * LDP * sizeof(T)); }
  static constexpr size_t tile_o(int rows) { return r128(rows * LDO * sizeof(float)); }
  static constexpr size_t vec(int n) { return r128(n * 4); }
};

template <typename T, int D>
struct FwdSmem : Layout<T, D, kBlockK> {
  using L = Layout<T, D, kBlockK>;
  static constexpr size_t bytes = L::tile_t(kRows) + 2 * L::tile_t(kBlockK) +
                                  L::tile_s(kRows) + L::tile_p(kRows) +
                                  L::tile_o(kRows) + 4 * L::vec(kRows) +
                                  L::vec(kBlockK);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FlashParams p) {
  using L = FwdSmem<T, D>;
  extern __shared__ __align__(128) char smem_raw[];
  SmemAlloc sm{smem_raw};
  T* sQ = sm.take<T>(kRows * L::LDT);
  T* sK = sm.take<T>(kBlockK * L::LDT);
  T* sV = sm.take<T>(kBlockK * L::LDT);
  float* sS = sm.take<float>(kRows * L::LDS);
  T* sP = sm.take<T>(kRows * L::LDP);
  float* sO = sm.take<float>(kRows * L::LDO);
  float* sM = sm.take<float>(kRows);
  float* sL = sm.take<float>(kRows);
  float* sCorr = sm.take<float>(kRows);
  int* sQpos = sm.take<int>(kRows);
  int* sKpos = sm.take<int>(kBlockK);

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int kvh = hh / (p.h / p.kvh);
  const int q0 = tile * kRows;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;

  const T* q = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.qpos + (long long)bb * p.sq;
  const int* kpos = p.kpos + (long long)bb * p.sk;

  load_tile<T, kRows, D>(sQ, L::LDT, q, p.q_ss, q0, p.sq);
  for (int i = tid; i < kRows; i += kThreads) {
    sQpos[i] = q0 + i < p.sq ? qpos[q0 + i] : INT_MIN;
    sM[i] = kNegInf;
    sL[i] = 0.f;
  }
  for (int i = tid; i < kRows * L::LDO; i += kThreads) sO[i] = 0.f;
  __syncthreads();
  int qmax = INT_MIN;
  for (int i = 0; i < kRows; ++i) qmax = max(qmax, sQpos[i]);

  const int nk = (p.sk + kBlockK - 1) / kBlockK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every reader of the previous tile is done
    for (int i = tid; i < kBlockK; i += kThreads) {
      sKpos[i] = k0 + i < p.sk ? kpos[k0 + i] : INT_MAX;
    }
    __syncthreads();
    int kmin = INT_MAX;
    for (int i = 0; i < kBlockK; ++i) kmin = min(kmin, sKpos[i]);
    if (kmin > qmax) continue;  // wholly above the diagonal (block-uniform)
    load_tile<T, kBlockK, D>(sK, L::LDT, k, p.k_ss, k0, p.sk);
    load_tile<T, kBlockK, D>(sV, L::LDT, v, p.v_ss, k0, p.sk);
    __syncthreads();

    strip_abt<T, kBlockK, D>(sQ + r0 * L::LDT, L::LDT, sK, L::LDT,
                             sS + r0 * L::LDS, L::LDS, p.scale);
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
        sP[r * L::LDP + lane + 32 * j] = from_float<T>(pj);
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
    strip_pv<T, kBlockK, D>(sP + r0 * L::LDP, L::LDP, sV, L::LDT,
                            sO + r0 * L::LDO, L::LDO);
  }

  T* out = static_cast<T*>(p.out);
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    if (row >= p.sq) break;
    const bool empty = sM[r] <= kNegInf;
    const float l = fmaxf(sL[r], 1e-30f);
    const long long at = ((long long)bb * p.sq + row) * p.h + hh;
    for (int c = lane; c < D; c += 32) {
      out[at * D + c] = from_float<T>(empty ? 0.f : sO[r * L::LDO + c] / l);
    }
    if (lane == 0) p.lse_out[at] = empty ? kNegInf : sM[r] + logf(l);
  }
}

template <typename T, int D>
struct DqSmem : Layout<T, D, kBlockK> {
  using L = Layout<T, D, kBlockK>;
  static constexpr size_t bytes = 2 * L::tile_t(kRows) + 2 * L::tile_t(kBlockK) +
                                  2 * L::tile_s(kRows) + L::tile_p(kRows) +
                                  L::tile_o(kRows) + 3 * L::vec(kRows) +
                                  L::vec(kBlockK);
};

template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const FlashParams p) {
  using L = DqSmem<T, D>;
  extern __shared__ __align__(128) char smem_raw[];
  SmemAlloc sm{smem_raw};
  T* sQ = sm.take<T>(kRows * L::LDT);
  T* sDO = sm.take<T>(kRows * L::LDT);
  T* sK = sm.take<T>(kBlockK * L::LDT);
  T* sV = sm.take<T>(kBlockK * L::LDT);
  float* sS = sm.take<float>(kRows * L::LDS);
  float* sDP = sm.take<float>(kRows * L::LDS);
  T* sDS = sm.take<T>(kRows * L::LDP);
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

  const T* q = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* dout = static_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
  const T* k = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.qpos + (long long)bb * p.sq;
  const int* kpos = p.kpos + (long long)bb * p.sk;

  load_tile<T, kRows, D>(sQ, L::LDT, q, p.q_ss, q0, p.sq);
  load_tile<T, kRows, D>(sDO, L::LDT, dout, p.do_ss, q0, p.sq);
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
    load_tile<T, kBlockK, D>(sK, L::LDT, k, p.k_ss, k0, p.sk);
    load_tile<T, kBlockK, D>(sV, L::LDT, v, p.v_ss, k0, p.sk);
    __syncthreads();

    strip_abt<T, kBlockK, D>(sQ + r0 * L::LDT, L::LDT, sK, L::LDT,
                             sS + r0 * L::LDS, L::LDS, p.scale);
    strip_abt<T, kBlockK, D>(sDO + r0 * L::LDT, L::LDT, sV, L::LDT,
                             sDP + r0 * L::LDS, L::LDS, 1.f);
    for (int i = lane; i < 16 * kBlockK; i += 32) {
      const int r = r0 + i / kBlockK, c = i % kBlockK;
      const bool ok = (k0 + c < p.sk) && sQpos[r] >= sKpos[c];
      const float pr = ok ? expf(sS[r * L::LDS + c] - sLse[r]) : 0.f;
      const float ds = pr * (sDP[r * L::LDS + c] - sDelta[r]) * p.scale;
      sDS[r * L::LDP + c] = from_float<T>(ds);
    }
    __syncwarp();
    strip_pv<T, kBlockK, D>(sDS + r0 * L::LDP, L::LDP, sK, L::LDT,
                            sDQ + r0 * L::LDO, L::LDO);
  }

  OutT* dq = static_cast<OutT*>(p.dq);
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = q0 + r;
    if (row >= p.sq) break;
    const long long at = ((long long)bb * p.sq + row) * p.h + hh;
    for (int c = lane; c < D; c += 32) dq[at * D + c] = from_float<OutT>(sDQ[r * L::LDO + c]);
  }
}

// The dk/dv pass walks q tiles of BQ rows: 64 for bf16, 32 for f32 so that
// the f32 instantiation fits in the 227 KB a block may use.
template <typename T>
struct DkvTile {
  static constexpr int BQ = std::is_same<T, bf16>::value ? 64 : 32;
};

template <typename T, int D>
struct DkvSmem : Layout<T, D, DkvTile<T>::BQ> {
  static constexpr int BQ = DkvTile<T>::BQ;
  using L = Layout<T, D, BQ>;
  static constexpr size_t bytes = 2 * L::tile_t(kRows) + 2 * L::tile_t(BQ) +
                                  2 * L::tile_s(kRows) + 2 * L::tile_p(kRows) +
                                  2 * L::tile_o(kRows) + 3 * L::vec(BQ) +
                                  L::vec(kRows);
};

template <typename T, typename OutT, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const FlashParams p) {
  using L = DkvSmem<T, D>;
  constexpr int BQ = L::BQ;
  extern __shared__ __align__(128) char smem_raw[];
  SmemAlloc sm{smem_raw};
  T* sK = sm.take<T>(kRows * L::LDT);
  T* sV = sm.take<T>(kRows * L::LDT);
  T* sQ = sm.take<T>(BQ * L::LDT);
  T* sDO = sm.take<T>(BQ * L::LDT);
  float* sSt = sm.take<float>(kRows * L::LDS);
  float* sDPt = sm.take<float>(kRows * L::LDS);
  T* sPt = sm.take<T>(kRows * L::LDP);
  T* sDSt = sm.take<T>(kRows * L::LDP);
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

  const T* k = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const int* qpos = p.qpos + (long long)bb * p.sq;
  const int* kpos = p.kpos + (long long)bb * p.sk;

  load_tile<T, kRows, D>(sK, L::LDT, k, p.k_ss, k0, p.sk);
  load_tile<T, kRows, D>(sV, L::LDT, v, p.v_ss, k0, p.sk);
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
    const T* q = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
    const T* dout = static_cast<const T*>(p.dout) + bb * p.do_sb + hh * p.do_sh;
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
      load_tile<T, BQ, D>(sQ, L::LDT, q, p.q_ss, q0, p.sq);
      load_tile<T, BQ, D>(sDO, L::LDT, dout, p.do_ss, q0, p.sq);
      __syncthreads();

      strip_abt<T, BQ, D>(sK + r0 * L::LDT, L::LDT, sQ, L::LDT,
                          sSt + r0 * L::LDS, L::LDS, p.scale);
      strip_abt<T, BQ, D>(sV + r0 * L::LDT, L::LDT, sDO, L::LDT,
                          sDPt + r0 * L::LDS, L::LDS, 1.f);
      for (int i = lane; i < 16 * BQ; i += 32) {
        const int r = r0 + i / BQ, c = i % BQ;
        const bool ok = (k0 + r < p.sk) && sQpos[c] >= sKpos[r];
        const float pr = ok ? expf(sSt[r * L::LDS + c] - sLse[c]) : 0.f;
        const float ds = pr * (sDPt[r * L::LDS + c] - sDelta[c]) * p.scale;
        sPt[r * L::LDP + c] = from_float<T>(pr);
        sDSt[r * L::LDP + c] = from_float<T>(ds);
      }
      __syncwarp();
      strip_pv<T, BQ, D>(sPt + r0 * L::LDP, L::LDP, sDO, L::LDT,
                         sDV + r0 * L::LDO, L::LDO);
      strip_pv<T, BQ, D>(sDSt + r0 * L::LDP, L::LDP, sQ, L::LDT,
                         sDK + r0 * L::LDO, L::LDO);
    }
  }

  OutT* dk = static_cast<OutT*>(p.dk);
  OutT* dv = static_cast<OutT*>(p.dv);
  for (int r = r0; r < r0 + 16; ++r) {
    const int row = k0 + r;
    if (row >= p.sk) break;
    const long long at = ((long long)bb * p.sk + row) * p.kvh + kvh;
    for (int c = lane; c < D; c += 32) {
      dk[at * D + c] = from_float<OutT>(sDK[r * L::LDO + c]);
      dv[at * D + c] = from_float<OutT>(sDV[r * L::LDO + c]);
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, size_t smem, const FlashParams& p,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int fwd(const FlashParams& p, cudaStream_t s) {
  dim3 grid((p.sq + kRows - 1) / kRows, p.h, p.b);
  return launch(flash_fwd_kernel<T, D>, grid, FwdSmem<T, D>::bytes, p, s);
}

template <typename T, typename OutT, int D>
int dq(const FlashParams& p, cudaStream_t s) {
  dim3 grid((p.sq + kRows - 1) / kRows, p.h, p.b);
  return launch(flash_bwd_dq_kernel<T, OutT, D>, grid, DqSmem<T, D>::bytes, p, s);
}

template <typename T, typename OutT, int D>
int dkv(const FlashParams& p, cudaStream_t s) {
  dim3 grid((p.sk + kRows - 1) / kRows, p.kvh, p.b);
  return launch(flash_bwd_dkv_kernel<T, OutT, D>, grid, DkvSmem<T, D>::bytes, p, s);
}

}  // namespace

// Entry points. `dtype` is 0 for float32 and 1 for bfloat16; `out_f32`
// selects f32 gradients (else the input type). Each returns the launch's
// cudaError_t (0 on success); cudaErrorInvalidValue for an unsupported
// dtype or head_dim (64 and 128 are built).
extern "C" {

int tpuft_flash_fwd(const FlashParams* p, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && p->d == 64) return fwd<bf16, 64>(*p, s);
  if (dtype == kBF16 && p->d == 128) return fwd<bf16, 128>(*p, s);
  if (dtype == kF32 && p->d == 64) return fwd<float, 64>(*p, s);
  if (dtype == kF32 && p->d == 128) return fwd<float, 128>(*p, s);
  return (int)cudaErrorInvalidValue;
}

int tpuft_flash_bwd_dq(const FlashParams* p, int dtype, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && !out_f32 && p->d == 64) return dq<bf16, bf16, 64>(*p, s);
  if (dtype == kBF16 && !out_f32 && p->d == 128) return dq<bf16, bf16, 128>(*p, s);
  if (dtype == kBF16 && out_f32 && p->d == 64) return dq<bf16, float, 64>(*p, s);
  if (dtype == kBF16 && out_f32 && p->d == 128) return dq<bf16, float, 128>(*p, s);
  if (dtype == kF32 && p->d == 64) return dq<float, float, 64>(*p, s);
  if (dtype == kF32 && p->d == 128) return dq<float, float, 128>(*p, s);
  return (int)cudaErrorInvalidValue;
}

int tpuft_flash_bwd_dkv(const FlashParams* p, int dtype, int out_f32, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16 && !out_f32 && p->d == 64) return dkv<bf16, bf16, 64>(*p, s);
  if (dtype == kBF16 && !out_f32 && p->d == 128) return dkv<bf16, bf16, 128>(*p, s);
  if (dtype == kBF16 && out_f32 && p->d == 64) return dkv<bf16, float, 64>(*p, s);
  if (dtype == kBF16 && out_f32 && p->d == 128) return dkv<bf16, float, 128>(*p, s);
  if (dtype == kF32 && p->d == 64) return dkv<float, float, 64>(*p, s);
  if (dtype == kF32 && p->d == 128) return dkv<float, float, 128>(*p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
