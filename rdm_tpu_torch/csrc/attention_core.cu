// Bare attention core softmax(q k^T / sqrt(C)) v for Hopper, sm_90a.
//
// Replaces the TPU kernel rdm_tpu/ops/pallas/attention.py::_attn_kernel.  For
// one sample of (L, C) q, k, v it computes the L x L scores, their row
// softmax and p v, keeping the scores out of device memory.  With the f32
// softmax (softmax_f32, or float32 inputs) scores and softmax are f32 and p
// is rounded to the working type T before p v; otherwise the scores are
// rounded to T, scaled by T(1/sqrt C) in T, and the softmax runs in T (see
// attn_common.cuh: softmax_rows).  p v accumulates in f32 and is rounded to
// T once.
//
// Bound on this card: at B = 1024, L = 81, C = 64 in bf16 the kernel must read
// q, k, v and write o, 42.5 MB (12.7 us at 3.35 TB/s), against 1.7 GFLOP
// (1.7 us at the bf16 tensor-core peak): memory bounds it.  The design keeps
// a sample's k (transposed), v and score rows in shared memory, so device
// memory sees each input once and the output once.
//
// Design: one block of 256 threads per sample, the products as the fused
// attention block does them (attn_common.cuh: tile_product over 4 x 8
// register tiles in f32), query rows in chunks of R rows so that L = C = 128
// fits in 227 KB.  Shared memory, f32: k transposed (C x LP), v (L x C), a
// chunk of score rows (R x LP) and of q rows (R x (C + 1)).
#include "attn_common.cuh"

namespace {

template <typename T, bool kScoresInT>
__global__ void __launch_bounds__(kThreads)
attention_core_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      int L, int C, int R, float scale) {
  const int LP = (L + TN - 1) / TN * TN;
  const int CP = C + 1;              // odd row stride of q: no bank conflicts
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                  // C x LP: k transposed
  float* vb = kt + C * LP;           // L x C : v
  float* sb = vb + L * C;            // R x LP: scores, then probabilities
  float* qb = sb + R * LP;           // R x CP: a chunk of q rows

  const size_t base = static_cast<size_t>(blockIdx.x) * L * C;
  const T* qs = q + base;
  T* os = o + base;
  for (int i = threadIdx.x; i < L * C; i += kThreads) {
    const int l = i / C;
    kt[(i - l * C) * LP + l] = to_f<T>(k[base + i]);
    vb[i] = to_f<T>(v[base + i]);
  }
  const float scale_t = rnd<T>(scale);

  for (int r0 = 0; r0 < L; r0 += R) {
    const int nr = min(R, L - r0);
    for (int i = threadIdx.x; i < nr * C; i += kThreads) {
      const int l = i / C;
      qb[l * CP + i - l * C] = to_f<T>(qs[static_cast<size_t>(r0) * C + i]);
    }
    __syncthreads();

    tile_product(nr, L, C, [=](int i, int c) { return qb[i * CP + c]; },
                 [=](int c, int j0, float* vals) { load8_shared(kt + c * LP + j0, vals); },
                 [=](int i, int j, float acc) {
                   sb[i * LP + j] = kScoresInT ? rnd<T>(rnd<T>(acc) * scale_t) : acc * scale;
                 });
    __syncthreads();

    softmax_rows<T, kScoresInT>(sb, nr, L, LP);
    __syncthreads();

    tile_product(nr, C, L, [=](int i, int j) { return sb[i * LP + j]; },
                 [=](int j, int c0, float* vals) { load8_shared(vb + j * C + c0, vals); },
                 [=](int i, int c, float acc) {
                   os[static_cast<size_t>(r0 + i) * C + c] = from_f<T>(acc);
                 });
    __syncthreads();
  }
}

template <typename T, bool kScoresInT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int L, int C,
                   int R, float scale, cudaStream_t stream) {
  const size_t LP = (L + TN - 1) / TN * TN;
  const size_t smem = sizeof(float) * (C * LP + static_cast<size_t>(L) * C + R * LP
                                       + static_cast<size_t>(R) * (C + 1));
  auto kern = attention_core_kernel<T, kScoresInT>;
  // The most shared memory any shape takes (the launcher caps R so that
  // L = C = 128 fits), set once per instantiation.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
  if (attr != cudaSuccess) return attr;
  if (smem > 232448) return cudaErrorInvalidValue;
  kern<<<B, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), static_cast<T*>(o),
                                      L, C, R, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  q, k, v and o are (B, L, C) row-major of
// the working type; scores_in_t selects the softmax in the working type
// (softmax_f32 off).  Returns a cudaError_t.
int rdm_attention_core(const void* q, const void* k, const void* v, void* o,
                       int B, int L, int C, int R, int dtype, int scores_in_t,
                       float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || L > kMaxL || C < 8 || C > 128 || C % 8 != 0 || R < 1 || R > L)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return static_cast<int>(launch<float, false>(q, k, v, o, B, L, C, R, scale, s));
  if (dtype == 1 && scores_in_t)
    return static_cast<int>(launch<__nv_bfloat16, true>(q, k, v, o, B, L, C, R, scale, s));
  if (dtype == 1)
    return static_cast<int>(launch<__nv_bfloat16, false>(q, k, v, o, B, L, C, R, scale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
