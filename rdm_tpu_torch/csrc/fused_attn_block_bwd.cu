// Backward of the fused NCSN++ attention block (AttnBlockpp) for Hopper, sm_90a.
//
// Replaces the TPU kernel
// rdm_tpu/ops/pallas/attention.py::_fused_block_bwd_kernel.  For one sample it
// recomputes the forward (GroupNorm, q, k, v, the float32 softmax p, o) and
// chains the cotangent g of the block's output back:
//   gs  = T(g * T(rescale))                 residual-scaled cotangent
//   dWp += o^T gs, dbp += sum gs            float32 partial sums
//   do  = T(gs Wp^T)
//   dv  = T(T(p)^T do),  dp = do v^T        (dp float32)
//   ds  = T(p * (dp - rowsum(dp * p)) / sqrt(C))
//   dq  = T(ds k),  dk = T(ds^T q)
//   dWq += h^T dq, dWk += h^T dk, dWv += h^T dv, and the bias sums
//   dh  = dq Wq^T + dk Wk^T + dv Wv^T       (float32, summed in this order)
//   dgamma += sum dh * xhat, dbeta += sum dh
//   dx  = T(inv * (dh*gamma - mean_g(dh*gamma) - xhat * mean_g(dh*gamma*xhat))
//           + g * rescale)
// with the rounding points of the TPU kernel (T is the working type, float or
// bfloat16; every value rounded to T is kept as a float holding that value).
//
// Bound on this card: at the training shape (B = 4096, L = 81, C = 64, bf16)
// the block reads x and g and writes dx, 3 x 42.5 MB, about 38 us at
// 3.35 TB/s; it does about 13 MFLOP per sample (8.7 for the backward, 4.3
// for the recompute), 53 GFLOP in all, about 54 us at 989 TFLOP/s.  So
// operations bound it.
//
// Design.  The TPU kernel runs its grid in order and adds every tile's
// parameter gradients into one output block.  Here blocks run at once, so
// the grid is a fixed number of slots (kSlots, or B if smaller): block s
// handles samples s, s + S, s + 2S, ... in that order and adds their
// parameter gradients into its own float32 slot of a workspace (no atomics,
// no other block writes there).  A second kernel sums the slots in slot
// order.  The result is the same from run to run and does not depend on the
// card's number of SMs.  One block of 256 threads works on one sample at a
// time; every product is the register-tiled FMA loop of the forward kernel
// (attn_common.cuh) with float32 accumulation.  The sample's intermediates
// (h, q, k, v, o, gs, then do, dv, dq, dk, dh in the dead buffers; p and
// dp/ds as L x L) live in shared memory as float32 where they fit: at
// C 64, L 81 all of them do (183 KB).  For larger shapes the launcher moves
// the buffers that do not fit to a per-slot scratch area in device memory
// (L2-resident); the kernel reads both through the same pointers.  Tensor
// cores and several samples per block are left to a later kernel.
#include "attn_common.cuh"

#include <cstddef>

namespace {

constexpr int kSlots = 128;
constexpr int kBuffers = 8;
// Shared memory a block may use on sm_90 (227 KB), less room for the
// kernel's static arrays.
constexpr int kSmemBytes = 232448 - 4096;

// Buffers of one sample, in the order the launcher tries to fit them into
// shared memory.
enum Buf { kP = 0, kDP, kK, kV, kQ, kH, kO, kGS };

struct Layout {
  int off[kBuffers];      // float offset in shared memory or in the slot's scratch
  int in_smem[kBuffers];  // 1: shared memory, 0: scratch in device memory
  int smem_floats;
  int scratch_floats;     // per slot
};

__host__ __device__ inline int padded_l(int L) { return (L + TN - 1) / TN * TN; }

inline Layout make_layout(int C, int L) {
  const int lc = L * (C + 1);
  const int ll = L * padded_l(L);
  const int sizes[kBuffers] = {ll, ll, lc, lc, lc, lc, lc, lc};
  Layout lay{};
  const int budget = kSmemBytes / static_cast<int>(sizeof(float));
  for (int i = 0; i < kBuffers; ++i) {
    if (lay.smem_floats + sizes[i] <= budget) {
      lay.in_smem[i] = 1;
      lay.off[i] = lay.smem_floats;
      lay.smem_floats += sizes[i];
    } else {
      lay.in_smem[i] = 0;
      lay.off[i] = lay.scratch_floats;
      lay.scratch_floats += sizes[i];
    }
  }
  return lay;
}

// Offsets of the ten parameter gradients in one slot (and in the output):
// gamma, beta, Wq, bq, Wk, bk, Wv, bv, Wp, bp.
struct GradOffsets {
  int gamma, beta, wq, bq, wk, bk, wv, bv, wp, bp, total;
  __host__ __device__ explicit GradOffsets(int C) {
    gamma = 0;
    beta = C;
    wq = 2 * C;
    bq = wq + C * C;
    wk = bq + C;
    bk = wk + C * C;
    wv = bk + C;
    bv = wv + C * C;
    wp = bv + C;
    bp = wp + C * C;
    total = bp + C;
  }
};

template <typename T, int C>
__global__ void __launch_bounds__(kThreads)
fused_attn_block_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            T* __restrict__ dx,
                            const T* __restrict__ gamma, const T* __restrict__ beta,
                            const T* __restrict__ wq, const T* __restrict__ bq,
                            const T* __restrict__ wk, const T* __restrict__ bk,
                            const T* __restrict__ wv, const T* __restrict__ bv,
                            const T* __restrict__ wpt, const T* __restrict__ bp,
                            const T* __restrict__ wqt, const T* __restrict__ wkt,
                            const T* __restrict__ wvt,
                            float* __restrict__ slots, float* __restrict__ scratch,
                            Layout lay, int B, int L, int groups, float eps, float scale,
                            float rescale) {
  constexpr int CP = C + 1;  // odd row stride of the L x C buffers
  const int LP = padded_l(L);
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_mu[C];
  __shared__ float s_inv[C];
  __shared__ float s_m1[C];
  __shared__ float s_m2[C];

  float* buf[kBuffers];
  for (int i = 0; i < kBuffers; ++i)
    buf[i] = lay.in_smem[i] ? smem + lay.off[i]
                            : scratch + static_cast<size_t>(blockIdx.x) * lay.scratch_floats
                                  + lay.off[i];
  float* const pb = buf[kP];    // L x LP: p (float32), rows of the softmax
  float* const db = buf[kDP];   // L x LP: dp, then ds
  float* const kb = buf[kK];    // L x CP: k, then dk
  float* const vb = buf[kV];    // L x CP: v
  float* const qb = buf[kQ];    // L x CP: q, then dh
  float* const hb = buf[kH];    // L x CP: h
  float* const ob = buf[kO];    // L x CP: o, then do, then dq
  float* const gb = buf[kGS];   // L x CP: gs, then dv

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = C / groups;
  const int gsize = cg * L;
  const float inv_n = 1.0f / static_cast<float>(gsize);
  const float rs_t = rnd<T>(rescale);
  const GradOffsets go(C);
  float* const slot = slots + static_cast<size_t>(blockIdx.x) * go.total;

  for (int i = tid; i < go.total; i += kThreads) slot[i] = 0.f;

  // Accessors for the products.  A(i, k) gives one value; B(k, j0, vals)
  // fills vals with B(k, j0 .. j0 + TN).  Rows past L are clamped (their
  // results are dropped).
  auto rows_of = [=](const float* m) {          // B(k, j) = m[k][j], L x CP
    return [=](int k, int j0, float* vals) {
#pragma unroll
      for (int n = 0; n < TN; ++n) vals[n] = m[k * CP + j0 + n];
    };
  };
  auto cols_of = [=](const float* m) {          // B(k, j) = m[j][k], j < L
    return [=](int k, int j0, float* vals) {
#pragma unroll
      for (int n = 0; n < TN; ++n) vals[n] = m[min(j0 + n, L - 1) * CP + k];
    };
  };
  auto w_rows = [](const T* W) {                 // B(k, j) = W[k][j], global
    return [=](int k, int j0, float* vals) { load8_global<T>(W + k * C + j0, vals); };
  };
  auto a_rows = [=](const float* m, int stride) {  // A(i, k) = m[i][k]
    return [=](int i, int k) { return m[i * stride + k]; };
  };
  auto a_cols = [=](const float* m, int stride) {  // A(i, k) = m[k][i]
    return [=](int i, int k) { return m[k * stride + i]; };
  };

  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    const T* xb = x + static_cast<size_t>(b) * C * L;
    const T* gsrc = g + static_cast<size_t>(b) * C * L;
    T* dxb = dx + static_cast<size_t>(b) * C * L;

    // ---- recompute the forward --------------------------------------------
    for (int gi = warp; gi < groups; gi += kWarps) {
      const T* xg = xb + static_cast<size_t>(gi) * gsize;
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
        s_mu[gi] = mu;
        s_inv[gi] = 1.0f / sqrtf(var + eps);
      }
    }
    __syncthreads();

    for (int i = tid; i < C * L; i += kThreads) {
      const int c = i / L;
      const int l = i - c * L;
      const int gi = c / cg;
      const float hn = (to_f<T>(xb[i]) - s_mu[gi]) * s_inv[gi];
      hb[l * CP + c] = rnd<T>(hn * to_f<T>(gamma[c]) + to_f<T>(beta[c]));
      // gs = T(g * T(rescale)), token-major
      gb[l * CP + c] = rnd<T>(to_f<T>(gsrc[i]) * rs_t);
    }
    __syncthreads();

    tile_product(L, C, C, a_rows(hb, CP), w_rows(wq), [=](int i, int j, float acc) {
      qb[i * CP + j] = rnd<T>(rnd<T>(acc) + to_f<T>(bq[j]));
    });
    tile_product(L, C, C, a_rows(hb, CP), w_rows(wk), [=](int i, int j, float acc) {
      kb[i * CP + j] = rnd<T>(rnd<T>(acc) + to_f<T>(bk[j]));
    });
    tile_product(L, C, C, a_rows(hb, CP), w_rows(wv), [=](int i, int j, float acc) {
      vb[i * CP + j] = rnd<T>(rnd<T>(acc) + to_f<T>(bv[j]));
    });
    __syncthreads();

    // scores, then the float32 softmax in place
    tile_product(L, L, C, a_rows(qb, CP), cols_of(kb), [=](int i, int j, float acc) {
      pb[i * LP + j] = acc * scale;
    });
    __syncthreads();
    for (int r = warp; r < L; r += kWarps) {
      float* row = pb + r * LP;
      float m = -INFINITY;
      for (int j = lane; j < L; j += 32) m = fmaxf(m, row[j]);
      m = warp_max(m);
      float sum = 0.f;
      for (int j = lane; j < L; j += 32) {
        const float e = expf(row[j] - m);
        row[j] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      for (int j = lane; j < L; j += 32) row[j] = row[j] / sum;
    }
    __syncthreads();

    // o = T(T(p) v)
    tile_product(L, C, L, [=](int i, int k) { return rnd<T>(pb[i * LP + k]); },
                 rows_of(vb), [=](int i, int j, float acc) { ob[i * CP + j] = rnd<T>(acc); });
    __syncthreads();

    // ---- proj: y = o Wp + bp ------------------------------------------------
    tile_product(C, C, L, a_cols(ob, CP), rows_of(gb), [=](int i, int j, float acc) {
      slot[go.wp + i * C + j] += acc;
    });
    for (int c = tid; c < C; c += kThreads) {
      float s = 0.f;
      for (int l = 0; l < L; ++l) s += gb[l * CP + c];
      slot[go.bp + c] += s;
    }
    __syncthreads();
    // do = T(gs Wp^T), into the dead o buffer
    tile_product(L, C, C, a_rows(gb, CP), w_rows(wpt), [=](int i, int j, float acc) {
      ob[i * CP + j] = rnd<T>(acc);
    });
    __syncthreads();

    // ---- attention: o = p v ---------------------------------------------------
    // dv = T(T(p)^T do), into the dead gs buffer; dp = do v^T
    tile_product(L, C, L, [=](int i, int k) { return rnd<T>(pb[k * LP + i]); },
                 rows_of(ob), [=](int i, int j, float acc) { gb[i * CP + j] = rnd<T>(acc); });
    tile_product(L, L, C, a_rows(ob, CP), cols_of(vb), [=](int i, int j, float acc) {
      db[i * LP + j] = acc;
    });
    __syncthreads();
    // ds = T(p * (dp - rowsum(dp * p)) * scale), in place
    for (int r = warp; r < L; r += kWarps) {
      float* drow = db + r * LP;
      const float* prow = pb + r * LP;
      float s = 0.f;
      for (int j = lane; j < L; j += 32) s = fmaf(drow[j], prow[j], s);
      s = warp_sum(s);
      for (int j = lane; j < L; j += 32) drow[j] = rnd<T>(prow[j] * (drow[j] - s) * scale);
    }
    __syncthreads();
    // dq = T(ds k), into the dead do buffer
    tile_product(L, C, L, a_rows(db, LP), rows_of(kb), [=](int i, int j, float acc) {
      ob[i * CP + j] = rnd<T>(acc);
    });
    __syncthreads();
    // dk = T(ds^T q), into the dead k buffer
    tile_product(L, C, L, a_cols(db, LP), rows_of(qb), [=](int i, int j, float acc) {
      kb[i * CP + j] = rnd<T>(acc);
    });
    __syncthreads();

    // ---- q, k, v NINs -----------------------------------------------------------
    tile_product(C, C, L, a_cols(hb, CP), rows_of(ob), [=](int i, int j, float acc) {
      slot[go.wq + i * C + j] += acc;
    });
    tile_product(C, C, L, a_cols(hb, CP), rows_of(kb), [=](int i, int j, float acc) {
      slot[go.wk + i * C + j] += acc;
    });
    tile_product(C, C, L, a_cols(hb, CP), rows_of(gb), [=](int i, int j, float acc) {
      slot[go.wv + i * C + j] += acc;
    });
    for (int c = tid; c < C; c += kThreads) {
      float sq = 0.f, sk = 0.f, sv = 0.f;
      for (int l = 0; l < L; ++l) {
        sq += ob[l * CP + c];
        sk += kb[l * CP + c];
        sv += gb[l * CP + c];
      }
      slot[go.bq + c] += sq;
      slot[go.bk + c] += sk;
      slot[go.bv + c] += sv;
    }
    // dh = dq Wq^T + dk Wk^T + dv Wv^T (float32), into the dead q buffer; each
    // element is written by the same thread in the three products
    tile_product(L, C, C, a_rows(ob, CP), w_rows(wqt), [=](int i, int j, float acc) {
      qb[i * CP + j] = acc;
    });
    tile_product(L, C, C, a_rows(kb, CP), w_rows(wkt), [=](int i, int j, float acc) {
      qb[i * CP + j] += acc;
    });
    tile_product(L, C, C, a_rows(gb, CP), w_rows(wvt), [=](int i, int j, float acc) {
      qb[i * CP + j] += acc;
    });
    __syncthreads();

    // ---- GroupNorm ------------------------------------------------------------
    for (int c = tid; c < C; c += kThreads) {
      const int gi = c / cg;
      const T* xc = xb + static_cast<size_t>(c) * L;
      float sg = 0.f, sb = 0.f;
      for (int l = 0; l < L; ++l) {
        const float dh = qb[l * CP + c];
        const float xhat = (to_f<T>(xc[l]) - s_mu[gi]) * s_inv[gi];
        sg = fmaf(dh, xhat, sg);
        sb += dh;
      }
      slot[go.gamma + c] += sg;
      slot[go.beta + c] += sb;
    }
    for (int gi = warp; gi < groups; gi += kWarps) {
      float m1 = 0.f, m2 = 0.f;
      for (int i = lane; i < gsize; i += 32) {
        const int c = gi * cg + i / L;
        const int l = i % L;
        const float dxh = qb[l * CP + c] * to_f<T>(gamma[c]);
        const float xhat = (to_f<T>(xb[c * L + l]) - s_mu[gi]) * s_inv[gi];
        m1 += dxh;
        m2 = fmaf(dxh, xhat, m2);
      }
      m1 = warp_sum(m1);
      m2 = warp_sum(m2);
      if (lane == 0) {
        s_m1[gi] = m1 * inv_n;
        s_m2[gi] = m2 * inv_n;
      }
    }
    __syncthreads();
    for (int i = tid; i < C * L; i += kThreads) {
      const int c = i / L;
      const int l = i - c * L;
      const int gi = c / cg;
      const float xhat = (to_f<T>(xb[i]) - s_mu[gi]) * s_inv[gi];
      const float dxh = qb[l * CP + c] * to_f<T>(gamma[c]);
      const float d = s_inv[gi] * (dxh - s_m1[gi] - xhat * s_m2[gi]);
      dxb[i] = from_f<T>(d + to_f<T>(gsrc[i]) * rescale);
    }
    __syncthreads();
  }
}

// out[e] = sum over slots s = 0 .. S-1, in that order, of slots[s][e].
__global__ void sum_slots_kernel(const float* __restrict__ slots, float* __restrict__ out,
                                 int n_slots, int total) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  float s = 0.f;
  for (int k = 0; k < n_slots; ++k) s += slots[static_cast<size_t>(k) * total + e];
  out[e] = s;
}

template <typename T, int C>
cudaError_t launch(const void* x, const void* g, void* dx, const void* const* p, float* grads,
                   float* workspace, int B, int L, int groups, float eps, float scale,
                   float rescale, cudaStream_t stream) {
  const Layout lay = make_layout(C, L);
  const int n_slots = B < kSlots ? B : kSlots;
  const GradOffsets go(C);
  float* slots = workspace;
  float* scratch = workspace + static_cast<size_t>(n_slots) * go.total;
  const size_t smem = sizeof(float) * static_cast<size_t>(lay.smem_floats);
  auto kern = fused_attn_block_bwd_kernel<T, C>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<n_slots, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<const T*>(p[0]), static_cast<const T*>(p[1]),
      static_cast<const T*>(p[2]), static_cast<const T*>(p[3]),
      static_cast<const T*>(p[4]), static_cast<const T*>(p[5]),
      static_cast<const T*>(p[6]), static_cast<const T*>(p[7]),
      static_cast<const T*>(p[8]), static_cast<const T*>(p[9]),
      static_cast<const T*>(p[10]), static_cast<const T*>(p[11]),
      static_cast<const T*>(p[12]),
      slots, scratch, lay, B, L, groups, eps, scale, rescale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_slots_kernel<<<(go.total + 255) / 256, 256, 0, stream>>>(slots, grads, n_slots,
                                                              go.total);
  return cudaGetLastError();
}

bool valid(int B, int C, int L, int groups) {
  return B >= 1 && L >= 1 && L <= kMaxL && groups >= 1 && (C == 64 || C == 128)
         && C % groups == 0;
}

}  // namespace

extern "C" {

// Floats of device workspace the launch needs: the slots of partial
// parameter gradients, then the scratch of the buffers that do not fit in
// shared memory.  0 for an unsupported shape.
long long rdm_fused_attn_block_bwd_workspace(int B, int C, int L, int groups) {
  if (!valid(B, C, L, groups)) return 0;
  const long long n_slots = B < kSlots ? B : kSlots;
  return n_slots * (GradOffsets(C).total + make_layout(C, L).scratch_floats);
}

// dtype: 0 = float32, 1 = bfloat16.  params: gamma, beta, Wq, bq, Wk, bk, Wv,
// bv, Wp^T, bp, Wq^T, Wk^T, Wv^T, all of the working type; W is (C_in, C_out)
// row-major.  grads: 4 C^2 + 6 C floats, the ten gradients in parameter order
// (gamma, beta, Wq, bq, Wk, bk, Wv, bv, Wp, bp).  Returns a cudaError_t.
int rdm_fused_attn_block_bwd(const void* x, const void* g, void* dx,
                             const void* gamma, const void* beta,
                             const void* wq, const void* bq,
                             const void* wk, const void* bk,
                             const void* wv, const void* bv,
                             const void* wpt, const void* bp,
                             const void* wqt, const void* wkt, const void* wvt,
                             void* grads, void* workspace,
                             int B, int C, int L, int groups, int dtype,
                             float eps, float scale, float rescale, void* stream) {
  const void* p[13] = {gamma, beta, wq, bq, wk, bk, wv, bv, wpt, bp, wqt, wkt, wvt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* gr = static_cast<float*>(grads);
  float* ws = static_cast<float*>(workspace);
  if (!valid(B, C, L, groups)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && C == 64)
    return static_cast<int>(launch<float, 64>(x, g, dx, p, gr, ws, B, L, groups, eps, scale, rescale, s));
  if (dtype == 0 && C == 128)
    return static_cast<int>(launch<float, 128>(x, g, dx, p, gr, ws, B, L, groups, eps, scale, rescale, s));
  if (dtype == 1 && C == 64)
    return static_cast<int>(launch<__nv_bfloat16, 64>(x, g, dx, p, gr, ws, B, L, groups, eps, scale, rescale, s));
  if (dtype == 1 && C == 128)
    return static_cast<int>(launch<__nv_bfloat16, 128>(x, g, dx, p, gr, ws, B, L, groups, eps, scale, rescale, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rdm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
