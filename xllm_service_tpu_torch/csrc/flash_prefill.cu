// Chunked paged-prefill flash-attention kernel for Hopper (sm_90a), bound
// with ctypes.
//
// Replaces the JAX package's TPU kernel
//   xllm_service_tpu/ops/pallas/flash_prefill.py::flash_prefill_kernel
// (body _prefill_kernel). Same function: q [P, Lpad, Hq, D] holds each
// sequence's chunk at absolute positions start_pos[p] + j; the chunk's own
// K/V were already written into the paged cache k/v [N, Hkv, BS, D], so
// query j reads only the cache, positions 0 .. start_pos + j (the last
// `window` of them when window > 0), through block_table [P, MB]. Rows with
// j >= true_len[p] emit zeros. Online softmax in f32, masking by -1e30.
// Output [P, Lpad, Hq, D]. The plain PyTorch version is
// xllm_service_tpu_torch/ops/attention.py::prefill_attention_blockwise.
//
// What bounds it on the card: operations. A chunk of L new tokens over a
// context of C does ~4 * L * C * Hq * D flops against ~2 * C * Hkv * D * 2
// bytes of K/V, hundreds of flops per byte once L reaches the hundreds, so
// the roofline is flops over the 989 TFLOP/s bf16 tensor-core rate.
//
// Design, first version (correct and simple): one CTA of four warps per
// (kv head, query tile, sequence). A tile holds 64 query rows: 64 / G chunk
// positions times the G query heads that share the kv head, so a K/V tile
// loaded into shared memory serves the whole GQA group (the TPU kernel's
// position-major row layout). The CTA walks the cache in tiles of 64
// tokens up to its own causal bound (start + last valid row of the tile)
// and no further; each warp owns 16 rows and computes S = Q K^T and
// O += P V with warp-level bf16 tensor-core products (WMMA 16x16x16, f32
// accumulate), the online softmax on S in f32 with two lanes per row, and
// keeps O in shared memory so each tile can rescale it row by row. A warp
// whose rows all lie before a K/V tile (causal) or past it (window) skips
// that tile. Cache positions past the causal bound are never read; their
// tile slots are zero-filled, so block-table entries past the context (the
// garbage block 0) are never read as context. wgmma, TMA and a pipelined
// producer warp are left for a later version.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int ROWS = 64;    // query rows (position, head) per CTA
constexpr int KT = 64;      // cache tokens per K/V tile
constexpr int NUM_WARPS = 4;  // 16 rows each

template <int D>
struct Layout {
  static constexpr int LDQ = D + 8;   // bf16 row stride of Q/K/V tiles
  static constexpr int LDS = KT + 4;  // f32 row stride of S
  static constexpr int LDP = KT + 8;  // bf16 row stride of P
  static constexpr int LDO = D + 4;   // f32 row stride of O
  static constexpr size_t Q_BYTES = (size_t)ROWS * LDQ * 2;
  static constexpr size_t KV_BYTES = (size_t)KT * LDQ * 2;
  static constexpr size_t S_BYTES = 16 * LDS * 4;
  static constexpr size_t P_BYTES = 16 * LDP * 2;
  static constexpr size_t O_BYTES = 16 * LDO * 4;
  static constexpr size_t WARP_BYTES = S_BYTES + P_BYTES + O_BYTES;
  static constexpr size_t TOTAL = Q_BYTES + 2 * KV_BYTES + NUM_WARPS * WARP_BYTES;
  // WMMA pointers must be 32-byte aligned: every region size is a multiple.
  static_assert(Q_BYTES % 32 == 0 && S_BYTES % 32 == 0 && P_BYTES % 32 == 0 &&
                    O_BYTES % 32 == 0,
                "smem regions must stay 32-byte aligned");
};

template <int D, int G>
__global__ void __launch_bounds__(NUM_WARPS * 32) flash_prefill_kernel(
    const bf16* __restrict__ q,        // [P, Lpad, Hq, D]
    const bf16* __restrict__ k,        // [N, Hkv, BS, D]
    const bf16* __restrict__ v,        // [N, Hkv, BS, D]
    const int* __restrict__ block_table,  // [P, MB]
    const int* __restrict__ start_pos,    // [P]
    const int* __restrict__ true_len,     // [P]
    bf16* __restrict__ out,            // [P, Lpad, Hq, D]
    int Lpad, int Hkv, int N, int BS, int MB, float scale, int window) {
  using Lay = Layout<D>;
  constexpr int TQ = ROWS / G;     // chunk positions per tile
  constexpr int CHUNKS = D / 8;    // 16-byte pieces per row
  constexpr int LDQ = Lay::LDQ, LDS = Lay::LDS, LDP = Lay::LDP, LDO = Lay::LDO;
  extern __shared__ __align__(128) unsigned char smem[];

  const int h = blockIdx.x;
  const int tile_lo = blockIdx.y * TQ;
  const int p = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int Hq = Hkv * G;
  const int start = start_pos[p];
  const int n_valid = min(true_len[p], Lpad);
  // Row i of the tile is chunk position tile_lo + i / G, query head
  // h * G + i % G.
  auto row_ptr = [&](const bf16* base, int i) {
    return base + (((size_t)p * Lpad + tile_lo + i / G) * Hq + (size_t)h * G + i % G) * D;
  };

  if (tile_lo >= n_valid) {  // every row is past true_len: zeros
    for (int idx = tid; idx < ROWS * CHUNKS; idx += blockDim.x) {
      const int i = idx / CHUNKS;
      if (tile_lo + i / G >= Lpad) continue;
      bf16* dst = const_cast<bf16*>(row_ptr(out, i)) + (idx % CHUNKS) * 8;
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    return;
  }

  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = reinterpret_cast<bf16*>(smem + Lay::Q_BYTES);
  bf16* v_s = reinterpret_cast<bf16*>(smem + Lay::Q_BYTES + Lay::KV_BYTES);
  unsigned char* wbase = smem + Lay::Q_BYTES + 2 * Lay::KV_BYTES + warp * Lay::WARP_BYTES;
  float* s_w = reinterpret_cast<float*>(wbase);
  bf16* p_w = reinterpret_cast<bf16*>(wbase + Lay::S_BYTES);
  float* o_w = reinterpret_cast<float*>(wbase + Lay::S_BYTES + Lay::P_BYTES);

  for (int idx = tid; idx < ROWS * CHUNKS; idx += blockDim.x) {
    const int i = idx / CHUNKS;
    const int c = idx % CHUNKS;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (tile_lo + i / G < Lpad)
      val = *reinterpret_cast<const uint4*>(row_ptr(q, i) + c * 8);
    *reinterpret_cast<uint4*>(q_s + i * LDQ + c * 8) = val;
  }
  for (int idx = lane; idx < 16 * LDO; idx += 32) o_w[idx] = 0.f;

  // This lane's softmax row (two lanes per row, 32 columns each).
  const int row = lane >> 1;
  const int half = lane & 1;
  const int i_row = warp * 16 + row;
  const int j_row = tile_lo + i_row / G;
  const bool row_valid = j_row < n_valid;
  const int row_pos = start + j_row;
  float m_run = XLLM_NEG_INF;
  float l_run = 0.f;

  // Positions this warp's rows cover, for skipping whole K/V tiles.
  const int w_j_lo = tile_lo + (warp * 16) / G;
  const bool warp_live = w_j_lo < n_valid;
  const int w_pos_lo = start + w_j_lo;
  const int w_pos_hi = start + min(tile_lo + (warp * 16 + 15) / G, n_valid - 1);

  // The tile's context: cache positions [kv_lo, kv_hi).
  const int kv_hi = start + min(tile_lo + TQ, n_valid);
  const int kv_lo = window > 0 ? max(start + tile_lo - window + 1, 0) : 0;
  const int* table = block_table + (size_t)p * MB;

  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], q_s + warp * 16 * LDQ + kk * 16, LDQ);

  for (int kv0 = kv_lo; kv0 < kv_hi; kv0 += KT) {
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int idx = tid; idx < KT * CHUNKS; idx += blockDim.x) {
      const int t = idx / CHUNKS;
      const int c = idx % CHUNKS;
      const int pos = kv0 + t;
      uint4 kval = make_uint4(0, 0, 0, 0), vval = kval;
      if (pos < kv_hi) {
        int blk = pos / BS < MB ? table[pos / BS] : 0;
        if ((unsigned)blk >= (unsigned)N) blk = 0;
        const size_t off = (((size_t)blk * Hkv + h) * BS + pos % BS) * D + c * 8;
        kval = *reinterpret_cast<const uint4*>(k + off);
        vval = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(k_s + t * LDQ + c * 8) = kval;
      *reinterpret_cast<uint4*>(v_s + t * LDQ + c * 8) = vval;
    }
    __syncthreads();
    if (!warp_live || kv0 > w_pos_hi || (window > 0 && kv0 + KT - 1 <= w_pos_lo - window))
      continue;

    // S = Q K^T for this warp's 16 rows.
#pragma unroll
    for (int n = 0; n < KT / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sc;
      wmma::fill_fragment(sc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;
        wmma::load_matrix_sync(kb, k_s + n * 16 * LDQ + kk * 16, LDQ);
        wmma::mma_sync(sc, qa[kk], kb, sc);
      }
      wmma::store_matrix_sync(s_w + n * 16, sc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this lane's 32 columns of its row.
    float sv[32];
    float mx = XLLM_NEG_INF;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const int col = half * 32 + c;
      const int pos = kv0 + col;
      const bool keep = row_valid && pos <= row_pos && (window <= 0 || pos > row_pos - window);
      sv[c] = keep ? s_w[row * LDS + col] * scale : XLLM_NEG_INF;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = (m_run <= XLLM_NEG_INF / 2) ? 0.f : __expf(m_run - m_new);
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < 32; ++c) {
      const float pv = (sv[c] <= XLLM_NEG_INF / 2) ? 0.f : __expf(sv[c] - m_new);
      rs += pv;
      p_w[row * LDP + half * 32 + c] = __float2bfloat16(pv);
    }
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    l_run = l_run * alpha + rs;
    m_run = m_new;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) o_w[row * LDO + d] *= alpha;
    __syncwarp();

    // O += P V.
#pragma unroll
    for (int dc = 0; dc < D / 16; ++dc) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> oc;
      wmma::load_matrix_sync(oc, o_w + dc * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vb;
        wmma::load_matrix_sync(pa, p_w + kk * 16, LDP);
        wmma::load_matrix_sync(vb, v_s + kk * 16 * LDQ + dc * 16, LDQ);
        wmma::mma_sync(oc, pa, vb, oc);
      }
      wmma::store_matrix_sync(o_w + dc * 16, oc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (j_row < Lpad) {
    bf16* dst = const_cast<bf16*>(row_ptr(out, i_row));
    const float inv = (row_valid && l_run > 0.f) ? 1.f / l_run : 0.f;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d)
      dst[d] = __float2bfloat16(o_w[row * LDO + d] * inv);
  }
}

template <int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* bt,
                   const int* start, const int* tl, void* out, int P,
                   int Lpad, int Hkv, int N, int BS, int MB, float scale,
                   int window, cudaStream_t stream) {
  constexpr int TQ = ROWS / G;
  const size_t smem = Layout<D>::TOTAL;
  auto kernel = flash_prefill_kernel<D, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, (Lpad + TQ - 1) / TQ, P);
  kernel<<<grid, NUM_WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), bt, start, tl, static_cast<bf16*>(out),
      Lpad, Hkv, N, BS, MB, scale, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t by_group(int G, const void* q, const void* k, const void* v,
                     const int* bt, const int* st, const int* tl, void* out,
                     int P, int Lpad, int Hkv, int N, int BS, int MB,
                     float scale, int window, cudaStream_t s) {
  switch (G) {
    case 1: return launch<D, 1>(q, k, v, bt, st, tl, out, P, Lpad, Hkv, N, BS, MB, scale, window, s);
    case 2: return launch<D, 2>(q, k, v, bt, st, tl, out, P, Lpad, Hkv, N, BS, MB, scale, window, s);
    case 4: return launch<D, 4>(q, k, v, bt, st, tl, out, P, Lpad, Hkv, N, BS, MB, scale, window, s);
    case 8: return launch<D, 8>(q, k, v, bt, st, tl, out, P, Lpad, Hkv, N, BS, MB, scale, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// bfloat16 only. Returns the launch's cudaError_t (0 on success); the caller
// raises on anything else.
extern "C" int xllm_flash_prefill(const void* q, const void* k, const void* v,
                                  const void* block_table,
                                  const void* start_pos, const void* true_len,
                                  void* out, int P, int Lpad, int Hkv, int G,
                                  int D, int N, int BS, int MB, float scale,
                                  int window, void* stream) {
  const int* bt = static_cast<const int*>(block_table);
  const int* st = static_cast<const int*>(start_pos);
  const int* tl = static_cast<const int*>(true_len);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return by_group<64>(G, q, k, v, bt, st, tl, out, P, Lpad, Hkv, N, BS, MB, scale, window, s);
    case 128: return by_group<128>(G, q, k, v, bt, st, tl, out, P, Lpad, Hkv, N, BS, MB, scale, window, s);
    case 256: return by_group<256>(G, q, k, v, bt, st, tl, out, P, Lpad, Hkv, N, BS, MB, scale, window, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* xllm_flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
