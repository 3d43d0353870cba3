// Fused NCSN++ attention block (AttnBlockpp forward) for Hopper, sm_90a.
//
// Replaces the TPU kernel rdm_tpu/ops/pallas/attention.py::_fused_block_kernel.
// For one sample it computes
//   h   = GroupNorm(x)                      (f32 statistics, var = E[x^2] - mean^2)
//   q,k,v = h Wq + bq, h Wk + bk, h Wv + bv (f32 accumulation)
//   p   = softmax(q k^T / sqrt(C))          (f32)
//   o   = p v
//   out = (x + (o Wp + bp)) * rescale
// with the rounding points of the TPU kernel: h, each NIN result (before its
// bias is added in the working type), p and o are rounded to the working
// type T (float or bfloat16), and the residual is formed in T.
//
// Bound on this card: at the sampling shape (B = 1024, L = 81, C = 64, bf16)
// the block reads and writes 1024*81*64*2 bytes each way (21.2 MB) and does
// about 4.4 GFLOP, so memory bounds it at about 6.3 us against 4.5 us of
// tensor-core time.  The design keeps every intermediate (h, q, k, v, the
// L x L scores, o) in shared memory, so device memory sees one read of x, one
// write of out and the weights, which stay in L2.
//
// Design: one thread block of 256 threads per sample (the grid is B, so a
// ragged batch needs no padding).  The kernel reads and writes the model's
// NCHW tensor directly: one sample is a contiguous C x L slab.  Shared memory
// holds, in f32: k transposed (C x LP), v (L x C), a chunk of score rows
// (R x LP), h (later o; L x (C + 1)) and a chunk of q rows (R x (C + 1)).
// Query rows are processed in chunks of R rows so that C = 128 with L = 128
// still fits in 227 KB; at the flagship shape one chunk covers all 81 rows.
// Every product is a plain f32 FMA loop over a 4 x 8 register tile per
// thread: per step of the reduction a thread loads 4 values of the left
// operand (same address across most of the warp, or rows 4 apart on an odd
// stride: no bank conflicts) and 8 contiguous values of the right operand
// with 16-byte loads, and does 32 FMAs.  The NIN weights are read from global
// memory (L1/L2) in the working type.  Tensor cores, TMA and wgmma are left to
// a later kernel.
#include "attn_common.cuh"

namespace {

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
fused_attn_block_kernel(const T* __restrict__ x, T* __restrict__ out,
                        const T* __restrict__ gamma, const T* __restrict__ beta,
                        const T* __restrict__ wq, const T* __restrict__ bq,
                        const T* __restrict__ wk, const T* __restrict__ bk,
                        const T* __restrict__ wv, const T* __restrict__ bv,
                        const T* __restrict__ wp, const T* __restrict__ bp,
                        int L, int groups, int R, float eps, float scale, float rescale) {
  constexpr int CP = C + 1;          // odd row stride of h and q: no bank conflicts
  const int LP = (L + TN - 1) / TN * TN;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;                  // C x LP: k transposed, later (o Wp + bp) transposed
  float* vb = kt + C * LP;           // L x C : v
  float* sb = vb + L * C;            // R x LP: scores, then probabilities
  float* hb = sb + R * LP;           // L x CP: h, then o
  float* qb = hb + L * CP;           // R x CP: a chunk of q rows
  __shared__ float s_mu[C];
  __shared__ float s_inv[C];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* xb = x + static_cast<size_t>(blockIdx.x) * C * L;
  T* ob = out + static_cast<size_t>(blockIdx.x) * C * L;

  // 1. Group statistics.  A group is cg consecutive channels, i.e. a
  //    contiguous run of cg * L values of the NCHW slab.
  const int cg = C / groups;
  const int gsize = cg * L;
  const float inv_n = 1.0f / static_cast<float>(gsize);
  for (int g = warp; g < groups; g += kWarps) {
    const T* xg = xb + static_cast<size_t>(g) * gsize;
    float s1 = 0.f, s2 = 0.f;
    for (int i = lane; i < gsize; i += 32) {
      const float v = to_f<T>(xg[i]);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      const float mu = s1 * inv_n;
      const float var = s2 * inv_n - mu * mu;
      s_mu[g] = mu;
      s_inv[g] = 1.0f / sqrtf(var + eps);
    }
  }
  __syncthreads();

  // 2. h = GroupNorm(x), rounded to T, stored token-major.
  for (int i = tid; i < C * L; i += kThreads) {
    const int c = i / L;
    const int l = i - c * L;
    const int g = c / cg;
    const float hn = (to_f<T>(xb[i]) - s_mu[g]) * s_inv[g];
    hb[l * CP + c] = rnd<T>(hn * to_f<T>(gamma[c]) + to_f<T>(beta[c]));
  }
  __syncthreads();

  // NIN: T(T(sum_c src[i][c] W[c][j]) + b[j]).
  auto h_row = [=](int i, int k) { return hb[i * CP + k]; };
  auto w_row = [](const T* W) {
    return [=](int k, int j0, float* vals) { load8_global<T>(W + k * C + j0, vals); };
  };

  // 3. k (stored transposed) and v for all rows.
  tile_product(L, C, C, h_row, w_row(wk), [=](int i, int j, float acc) {
    kt[j * LP + i] = rnd<T>(rnd<T>(acc) + to_f<T>(bk[j]));
  });
  tile_product(L, C, C, h_row, w_row(wv), [=](int i, int j, float acc) {
    vb[i * C + j] = rnd<T>(rnd<T>(acc) + to_f<T>(bv[j]));
  });
  __syncthreads();

  // 4. Attention, R query rows at a time.  Row r of h is dead once q row r
  //    exists, so o overwrites h chunk by chunk.
  for (int r0 = 0; r0 < L; r0 += R) {
    const int nr = min(R, L - r0);
    const float* hc = hb + r0 * CP;
    tile_product(nr, C, C, [=](int i, int k) { return hc[i * CP + k]; }, w_row(wq),
                 [=](int i, int j, float acc) {
                   qb[i * CP + j] = rnd<T>(rnd<T>(acc) + to_f<T>(bq[j]));
                 });
    __syncthreads();

    tile_product(nr, L, C, [=](int i, int k) { return qb[i * CP + k]; },
                 [=](int k, int j0, float* vals) { load8_shared(kt + k * LP + j0, vals); },
                 [=](int i, int j, float acc) { sb[i * LP + j] = acc * scale; });
    __syncthreads();

    for (int r = warp; r < nr; r += kWarps) {
      float* srow = sb + r * LP;
      float m = -INFINITY;
      for (int j = lane; j < L; j += 32) m = fmaxf(m, srow[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(srow[j] - m);
        srow[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < L; j += 32) srow[j] = rnd<T>(srow[j] / sum);
    }
    __syncthreads();

    float* oc = hb + r0 * CP;
    tile_product(nr, C, L, [=](int i, int k) { return sb[i * LP + k]; },
                 [=](int k, int j0, float* vals) { load8_shared(vb + k * C + j0, vals); },
                 [=](int i, int j, float acc) { oc[i * CP + j] = rnd<T>(acc); });
    __syncthreads();
  }

  // 5. Output projection, stored transposed into the dead k buffer.
  tile_product(L, C, C, h_row, w_row(wp), [=](int i, int j, float acc) {
    kt[j * LP + i] = rnd<T>(rnd<T>(acc) + to_f<T>(bp[j]));
  });
  __syncthreads();

  // 6. Residual in T, written back as NCHW.
  const float rs = rnd<T>(rescale);
  for (int i = tid; i < C * L; i += kThreads) {
    const int c = i / L;
    const int l = i - c * L;
    const float s = rnd<T>(to_f<T>(xb[i]) + kt[c * LP + l]);
    ob[i] = from_f<T>(s * rs);
  }
}

template <typename T, int C>
cudaError_t launch(const void* x, void* out, const void* const* p, int B, int L,
                   int groups, int R, float eps, float scale, float rescale,
                   cudaStream_t stream) {
  const size_t LP = (L + TN - 1) / TN * TN;
  const size_t smem = sizeof(float) * (C * LP + static_cast<size_t>(L) * C + R * LP
                                       + static_cast<size_t>(L) * (C + 1)
                                       + static_cast<size_t>(R) * (C + 1));
  auto kern = fused_attn_block_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<B, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out),
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
      static_cast<const T*>(p[8]), static_cast<const T*>(p[9]),
      L, groups, R, eps, scale, rescale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  params: gamma, beta, wq, bq, wk, bk,
// wv, bv, wp, bp, all of the working type; W is (C_in, C_out) row-major.
// Returns a cudaError_t.
int rdm_fused_attn_block(const void* x, void* out,
                         const void* gamma, const void* beta,
                         const void* wq, const void* bq,
                         const void* wk, const void* bk,
                         const void* wv, const void* bv,
                         const void* wp, const void* bp,
                         int B, int C, int L, int groups, int R, int dtype,
                         float eps, float scale, float rescale, void* stream) {
  const void* p[10] = {gamma, beta, wq, bq, wk, bk, wv, bv, wp, bp};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || L < 1 || L > kMaxL || R < 1 || R > L || groups < 1 || C % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && C == 64)
    return static_cast<int>(launch<float, 64>(x, out, p, B, L, groups, R, eps, scale, rescale, s));
  if (dtype == 0 && C == 128)
    return static_cast<int>(launch<float, 128>(x, out, p, B, L, groups, R, eps, scale, rescale, s));
  if (dtype == 1 && C == 64)
    return static_cast<int>(launch<__nv_bfloat16, 64>(x, out, p, B, L, groups, R, eps, scale, rescale, s));
  if (dtype == 1 && C == 128)
    return static_cast<int>(launch<__nv_bfloat16, 128>(x, out, p, B, L, groups, R, eps, scale, rescale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
