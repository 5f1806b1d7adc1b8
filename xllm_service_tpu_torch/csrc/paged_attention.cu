// Paged-attention decode kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the JAX package's TPU kernel
//   xllm_service_tpu/ops/pallas/paged_attention.py::paged_attention_kernel
// (body _decode_kernel). Same function: one query token per sequence,
// q [R, Hq, D], attends to the first seq_lens[r] rows of its paged context
// in k/v [N, Hkv, BS, D] through block_table [R, MB] (the last `window` of
// them when window > 0), online softmax in f32 with scale applied to q and
// masking by NEG_INF = -1e30; rows with seq_lens == 0 emit zeros. The plain
// PyTorch version is xllm_service_tpu_torch/ops/attention.py
// ::paged_attention_gather.
//
// What bounds it on the card: bytes. Every live context row is read once
// (2 * Hkv * D * elem bytes per token), at ~1 flop per byte, far below the
// H100's ~295 bf16 flop/byte ridge, so the roofline is context bytes over
// 3.35 TB/s.
//
// Design, first version (correct and simple): one CTA per (kv head,
// sequence) serves all G = Hq / Hkv query heads of that kv head, so each K/V
// row is read from device memory once for the whole GQA group (the TPU
// kernel's grouping, without its pad of G to 8 sublanes). Eight warps walk
// the context in groups of U consecutive tokens; lane i holds D/32
// consecutive elements of a row, so a warp reads each row as one coalesced
// D-element load, and the U rows of a group are loaded before any of them
// is used to keep several loads in flight. Each warp keeps its own
// (max, sum, accumulator) per head; the warps merge through shared memory
// at the end. Block-table entries are read only for positions below the
// sequence length, so entries past the context (the garbage block 0) are
// never read as context. Splitting one long context over several CTAs
// (flash-decoding) is left for a later version.

#include "common.cuh"

namespace {

using xllm::from_float;
using xllm::load_vec;
using xllm::warp_sum;

constexpr int NUM_WARPS = 8;

template <typename T, int D, int G, int U>
__global__ void __launch_bounds__(NUM_WARPS * 32) paged_decode_kernel(
    const T* __restrict__ q,           // [R, Hq, D]
    const T* __restrict__ k,           // [N, Hkv, BS, D]
    const T* __restrict__ v,           // [N, Hkv, BS, D]
    const int* __restrict__ block_table,  // [R, MB]
    const int* __restrict__ seq_lens,  // [R]
    T* __restrict__ out,               // [R, Hq, D]
    int Hkv, int N, int BS, int MB, float scale, int window) {
  constexpr int PER = D / 32;
  extern __shared__ __align__(16) float merge[];  // [NUM_WARPS][G][D + 2]

  const int h = blockIdx.x;
  const int r = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int Hq = Hkv * G;
  T* o = out + ((size_t)r * Hq + (size_t)h * G) * D;

  const int L = min(seq_lens[r], MB * BS);
  if (L <= 0) {
    for (int i = threadIdx.x; i < G * D; i += blockDim.x) o[i] = from_float<T>(0.f);
    return;
  }
  const int lo = window > 0 ? max(L - window, 0) : 0;

  float qv[G][PER];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    load_vec<T, PER>(q + ((size_t)r * Hq + (size_t)h * G + g) * D + lane * PER, qv[g]);
#pragma unroll
    for (int i = 0; i < PER; ++i) qv[g][i] *= scale;
  }

  float m[G], l[G], acc[G][PER];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = XLLM_NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) acc[g][i] = 0.f;
  }

  const int* table = block_table + (size_t)r * MB;
  const size_t blk_stride = (size_t)Hkv * BS * D;
  const size_t head_off = (size_t)h * BS * D + lane * PER;

  for (int t0 = lo + warp * U; t0 < L; t0 += NUM_WARPS * U) {
    float kr[U][PER], vr[U][PER];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < L) {
        int blk = table[t / BS];
        if ((unsigned)blk >= (unsigned)N) blk = 0;
        const size_t off = (size_t)blk * blk_stride + head_off + (size_t)(t % BS) * D;
        load_vec<T, PER>(k + off, kr[u]);
        load_vec<T, PER>(v + off, vr[u]);
      } else {
#pragma unroll
        for (int i = 0; i < PER; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float s[U];
      float mx = XLLM_NEG_INF;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < PER; ++i) part += qv[g][i] * kr[u][i];
        part = warp_sum(part);
        s[u] = (t0 + u < L) ? part : XLLM_NEG_INF;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = __expf(m[g] - m_new);
      l[g] *= alpha;
#pragma unroll
      for (int i = 0; i < PER; ++i) acc[g][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = (t0 + u < L) ? __expf(s[u] - m_new) : 0.f;
        l[g] += p;
#pragma unroll
        for (int i = 0; i < PER; ++i) acc[g][i] += p * vr[u][i];
      }
      m[g] = m_new;
    }
  }

  // Merge the warps' partial softmax states.
  constexpr int STRIDE = D + 2;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* dst = merge + (warp * G + g) * STRIDE;
#pragma unroll
    for (int i = 0; i < PER; ++i) dst[lane * PER + i] = acc[g][i];
    if (lane == 0) {
      dst[D] = m[g];
      dst[D + 1] = l[g];
    }
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int g = idx / D;
    const int d = idx % D;
    float mx = XLLM_NEG_INF;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) mx = fmaxf(mx, merge[(w * G + g) * STRIDE + D]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NUM_WARPS; ++w) {
      const float* src = merge + (w * G + g) * STRIDE;
      const float wgt = __expf(src[D] - mx);
      den += src[D + 1] * wgt;
      num += src[d] * wgt;
    }
    o[idx] = from_float<T>(num / fmaxf(den, 1e-30f));
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v, const int* bt,
                   const int* seq_lens, void* out, int R, int Hkv, int N,
                   int BS, int MB, float scale, int window,
                   cudaStream_t stream) {
  constexpr int U = (D * G <= 512) ? 4 : 2;
  const size_t smem = (size_t)NUM_WARPS * G * (D + 2) * sizeof(float);
  auto kernel = paged_decode_kernel<T, D, G, U>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Hkv, R), NUM_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bt, seq_lens, static_cast<T*>(out), Hkv, N,
      BS, MB, scale, window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t by_group(int G, const void* q, const void* k, const void* v,
                     const int* bt, const int* sl, void* out, int R, int Hkv,
                     int N, int BS, int MB, float scale, int window,
                     cudaStream_t s) {
  switch (G) {
    case 1: return launch<T, D, 1>(q, k, v, bt, sl, out, R, Hkv, N, BS, MB, scale, window, s);
    case 2: return launch<T, D, 2>(q, k, v, bt, sl, out, R, Hkv, N, BS, MB, scale, window, s);
    case 4: return launch<T, D, 4>(q, k, v, bt, sl, out, R, Hkv, N, BS, MB, scale, window, s);
    case 8: return launch<T, D, 8>(q, k, v, bt, sl, out, R, Hkv, N, BS, MB, scale, window, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_dim(int D, int G, const void* q, const void* k, const void* v,
                   const int* bt, const int* sl, void* out, int R, int Hkv,
                   int N, int BS, int MB, float scale, int window,
                   cudaStream_t s) {
  switch (D) {
    case 64: return by_group<T, 64>(G, q, k, v, bt, sl, out, R, Hkv, N, BS, MB, scale, window, s);
    case 128: return by_group<T, 128>(G, q, k, v, bt, sl, out, R, Hkv, N, BS, MB, scale, window, s);
    case 256: return by_group<T, 256>(G, q, k, v, bt, sl, out, R, Hkv, N, BS, MB, scale, window, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = bfloat16, 1 = float32. Returns the launch's cudaError_t (0 on
// success); the caller raises on anything else.
extern "C" int xllm_paged_attention(int dtype, const void* q, const void* k,
                                    const void* v, const void* block_table,
                                    const void* seq_lens, void* out, int R,
                                    int Hkv, int G, int D, int N, int BS,
                                    int MB, float scale, int window,
                                    void* stream) {
  const int* bt = static_cast<const int*>(block_table);
  const int* sl = static_cast<const int*>(seq_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return by_dim<__nv_bfloat16>(D, G, q, k, v, bt, sl, out, R, Hkv, N, BS, MB, scale, window, s);
  if (dtype == 1)
    return by_dim<float>(D, G, q, k, v, bt, sl, out, R, Hkv, N, BS, MB, scale, window, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* xllm_paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
