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
//   dh  = dq Wq^T + dk Wk^T + dv Wv^T       (float32)
//   dgamma += sum dh * xhat, dbeta += sum dh
//   dx  = T(inv * (dh*gamma - mean_g(dh*gamma) - xhat * mean_g(dh*gamma*xhat))
//           + g * rescale)
// with the rounding points of the TPU kernel (T is the working type, float or
// bfloat16; every value rounded to T is kept as a float holding that value).
//
// Bound on this card: at the training shape (B = 4096, L = 81, C = 64, bf16)
// the block reads x and g and writes dx, 3 x 42.5 MB, about 38 us at
// 3.35 TB/s; it does about 12.3 MFLOP per sample (8.0 for the backward, 4.3
// for the recompute), 50.6 GFLOP in all, about 51 us at 989 TFLOP/s.  So
// operations bound it.
//
// Both bodies share the slots.  The TPU kernel runs its grid in order and
// adds every tile's parameter gradients into one output block.  Here blocks
// run at once, so the grid is a fixed number of slots (kSlots, or B if
// smaller): block s handles samples s, s + S, s + 2S, ... in that order and
// adds their parameter gradients into its own float32 slot of a workspace
// (no atomics, no other block writes there).  A second kernel sums the slots
// in slot order.  The result is the same from run to run and does not depend
// on the card's number of SMs.
//
// bfloat16, C = 64, L <= 96 (fused_attn_block_bwd_tc_kernel): every operand
// of every product is a bf16 value (the rounding points above), so the 17
// products of a sample run on mma.sync.m16n8k16 with float32 sums; only their
// order of summation differs from the plain version's.  One block of NT
// warps (16 NT >= L token rows) per slot stages the four weights once, as
// output-channel panels (chunks swizzled): plain ldmatrix gives h W, and
// ldmatrix.trans of the same panel gives gs Wp^T and dq Wq^T (Wp arrives as
// Wp^T and is copied as it is).  x and g of each sample arrive by 1-D TMA
// bulk copies into a ring of `stages` stages (two where they fit).  Warp w
// owns token rows 16 w .. 16 w + 15, as query rows and as key rows:
//   0. the GroupNorm statistics of the sample (warps over groups);
//   1. h of its rows as A fragments straight from the x slab; q, k, v
//      (rounded before the bias) staged in bf16 panels; gs as A fragments
//      from the g slab; do = T(gs Wp^T) staged and kept in registers;
//   2. as query rows: s = q k^T and the float32 softmax p in registers (-inf
//      on padded keys); o = T(T(p) v); dp = do v^T in p's layout;
//      ds = T(p (dp - rowsum(dp p)) / sqrt(C)); dq = T(ds k) with ds the A
//      operand from the accumulators; T(p) and ds staged as 16 NT x 16 NT
//      bf16 panels (row stride 16 NT + 8: an odd number of 16-byte chunks,
//      so ldmatrix rows fall on distinct banks);
//   3. as key rows: dv = T(T(p)^T do) and dk = T(ds^T q) (A by
//      ldmatrix.trans from those panels), staged over the dead v and k;
//      dh = dq Wq^T + dk Wk^T + dv Wv^T, one float32 chain in registers;
//      then o and dq staged over the dead q and do, h and gs (their
//      fragments built again from the slabs) over the dead T(p), and the
//      warp's column sums of dh and dh xhat;
//   4. the weight and bias gradients of the sample in 40 units of 16 x 32
//      over the warps (dWq, dWk, dWv, dWp by 16 rows and 32 columns; the
//      four biases by 32 columns): each adds its token contraction (A = h^T
//      or o^T by ldmatrix.trans of their rows, a row of ones for a bias;
//      B = dq, dk, dv or gs by ldmatrix.trans) into a float32 accumulator in
//      shared memory that lives for all of the block's samples and is
//      written to the slot once, at the end; dgamma, dbeta and the
//      GroupNorm means m1, m2 from the warps' column sums, in warp order;
//   5. dx = T(inv (dh gamma - m1 - xhat m2) + g rescale) (rounded once, the
//      residual term in float32) into the dead k panel as the C x L slab,
//      which goes out with one bulk store.
// Padded rows (tokens L .. 16 NT - 1) add exactly nothing to any gradient.
// The kernel relies on three facts: h is 0 on padded rows (so hW is the bias
// and every score finite); padded keys are masked to -inf before the
// softmax, so their p and hence ds are exactly 0; and gs is 0 on padded
// rows, so do, dp and ds are 0 there, and with them dq, and dk and dv of the
// padded key rows, dh, and every padded row's share of a weight or bias sum.
// GroupNorm and dx read only rows below L.
//
// Shared memory of the tensor-core body (NT = 6, L = 81), 232,320 of the
// 232,448 bytes a block may have: barriers 128; the four weight panels
// 32,768; the float32 gradient accumulators 67,072 (4 C^2 + 6 C; the weight
// accumulators' columns swizzled by row so float2 accesses of a warp miss
// no bank); the q, k, v biases 768 and, by channel, the sample's GroupNorm
// mean and 1 / std beside gamma and beta 1,024; four bf16 panels of 96 x 64 (q then o, k then dk then dx, v then dv, do
// then dq) 49,152; T(p) and ds, 96 x 104 each, 39,936 (after step 3: h and
// gs, 96 x 64 each, the warps' column sums and m1, m2); the x and g slabs
// of two stages 41,472.  dq and o wait in registers across a barrier.  At
// 81 < L <= 96 one stage fits, and the loads are not overlapped.  Seven
// block barriers a sample.
//
// Registers: one block of NT warps an SM allows 255 a thread; ptxas takes
// them all and spills 100 bytes at NT = 6 (72 at 4, 20 at 2).  Holding dp
// 16 keys at a time (two passes over do v^T) spilled about as much and ran
// 5 % slower.  With 6 warps an SM every phase waits on latency rather than
// on the tensor cores (PERF.md: cycles per phase, knock-outs).
//
// Every other shape, and float32 (fused_attn_block_bwd_kernel, the earlier
// body): one block of 256 threads works on one sample at a time; every
// product is the register-tiled FMA loop of the forward kernel
// (attn_common.cuh) with float32 accumulation, summing into the slot in
// device memory sample by sample.  The sample's intermediates (h, q, k, v,
// o, gs, then do, dv, dq, dk, dh in the dead buffers; p and dp/ds as L x L)
// live in shared memory as float32 where they fit: at C 64, L 81 all of
// them do (183 KB).  For larger shapes the launcher moves the buffers that
// do not fit to a per-slot scratch area in device memory (L2-resident); the
// kernel reads both through the same pointers.  TF32 would break the
// float32 tolerance (1e-4).
#include "attn_common.cuh"
#include "attn_mma.cuh"
#include "tma.cuh"
#include "smem_attr.cuh"

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
  // the most any shape may take (make_layout keeps each within it), set once
  // per instantiation and card
  static SmemAttr smem_attr;
  const cudaError_t attr = smem_attr.apply(reinterpret_cast<const void*>(kern), kSmemBytes);
  if (attr != cudaSuccess) return attr;
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
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_slots_kernel<<<(go.total + 255) / 256, 256, 0, stream>>>(slots, grads, n_slots,
                                                              go.total);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bfloat16, C = 64, L <= 96: tensor cores (see the header)

using bf16 = __nv_bfloat16;

constexpr int kTcC = 64;            // channels of the tensor-core body
constexpr int kTcMaxL = 96;         // its most tokens
constexpr int kTcSmemLimit = 232448;
constexpr int kTcUnits = 24;        // gradient units of a sample: 4 weights x 4 row tiles, 4 biases x 2

__host__ __device__ constexpr int tc_slab_bytes(int L) { return (kTcC * L * 2 + 127) / 128 * 128; }

// Byte offsets of the tensor-core body's shared memory (see the header).
struct TcLayout {
  int w, acc, prm, stats, panels, ll, ring, total;
};

__host__ __device__ inline TcLayout tc_layout(int NT, int L, int stages) {
  const int rows = 16 * NT, lls = rows + 8;
  TcLayout t{};
  t.w = 128;                                                  // after the barriers
  t.acc = t.w + 4 * kTcC * kTcC * 2;
  t.prm = t.acc + (4 * kTcC * kTcC + 6 * kTcC) * 4;
  t.stats = t.prm + 3 * kTcC * 4;
  t.panels = t.stats + 4 * kTcC * 4;
  t.ll = t.panels + 4 * rows * kTcC * 2;
  // T(p) and ds; after step 3 the h and gs panels, the column sums and m1, m2
  const int ll = 2 * rows * lls * 2, late = 2 * rows * kTcC * 2 + (2 * NT + 2) * kTcC * 4;
  t.ring = t.ll + ((ll > late ? ll : late) + 127) / 128 * 128;
  t.total = t.ring + stages * 2 * tc_slab_bytes(L);
  return t;
}

// Two stages of x and g where they fit beside the rest, else one.
inline int tc_stages(int NT, int L) { return tc_layout(NT, L, 2).total <= kTcSmemLimit ? 2 : 1; }

// Every product of the tensor-core body goes through here.
__device__ __forceinline__ void mma16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                      unsigned b1) {
  mma_bf16(d, a, b0, b1);
}

// acc (16 x 16 NJ) += A (16 x 16, fragment a) B over depth 16 kk .. 16 kk + 15
// and columns 16 j0 ..,
// with B's fragments from a staged tensor of ROWS rows (swizzled_chunk
// layout).  kRowsAreN: the tensor's rows are B's columns and its channels
// B's depth (plain ldmatrix); else its rows are the depth and its channels
// the columns (ldmatrix.trans).
template <int ROWS, bool kRowsAreN, int NJ>
__device__ __forceinline__ void product_step(float (&acc)[2 * NJ][4], const unsigned (&a)[4],
                                             const bf16* t, int kk, int lane, int j0 = 0) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    unsigned b[4];     // columns 16 (j0 + j) + 0..7 (b[0], b[1]: depth + 0..7, + 8..15), then + 8..15
    if (kRowsAreN)
      ldmatrix_x4(b, t + swizzled_chunk<ROWS>(16 * (j0 + j) + (lane & 7) + ((lane >> 4) << 3),
                                              2 * kk + ((lane >> 3) & 1)));
    else
      ldmatrix_x4_trans(b, t + swizzled_chunk<ROWS>(16 * kk + (lane & 15),
                                                    2 * (j0 + j) + (lane >> 4)));
    mma16(acc[2 * j], a, b[0], b[1]);
    mma16(acc[2 * j + 1], a, b[2], b[3]);
  }
}

// acc (16 x 16 NJ) += A B over the whole depth 16 KT, A given as KT fragments.
template <int ROWS, bool kRowsAreN, int KT, int NJ>
__device__ __forceinline__ void product16(float (&acc)[2 * NJ][4], const unsigned (&a)[KT][4],
                                          const bf16* t, int lane) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) product_step<ROWS, kRowsAreN, NJ>(acc, a[kk], t, kk, lane);
}

// Fragment kk of a 16 x 16 KT accumulator rounded to bf16: the A operand of
// the next product as it stands (the two layouts coincide).
template <int N>
__device__ __forceinline__ void frag_of(const float (&acc)[N][4], int kk, unsigned (&a)[4]) {
  a[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
  a[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
  a[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
  a[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

template <int KT>
__device__ __forceinline__ void to_frags(const float (&acc)[2 * KT][4], unsigned (&a)[KT][4]) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) frag_of(acc, kk, a[kk]);
}

// Rows r0 .. r0 + 15 of fragments a (16 x 64) into a staged tensor.
template <int ROWS>
__device__ __forceinline__ void stage_frags(const unsigned (&a)[4][4], bf16* t, int r0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<unsigned*>(t + swizzled_chunk<ROWS>(r0 + g + 8 * (e & 1), 2 * kk + (e >> 1))
                                   + 2 * tq) = a[kk][e];
}

// The warp's NIN result, rounded before its bias, plus the bias in bf16,
// into rows r0 .. r0 + 15 of a staged tensor.
template <int ROWS>
__device__ __forceinline__ void stage_nin(const float (&acc)[8][4], const float* bias, bf16* t,
                                          int r0, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = 8 * n + 2 * tq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<unsigned*>(t + swizzled_chunk<ROWS>(r0 + g + 8 * hf, n) + 2 * tq) =
          pack_bf16(rnd_bf16(acc[n][2 * hf]) + bias[c], rnd_bf16(acc[n][2 * hf + 1]) + bias[c + 1]);
  }
}

// Rows r0 .. r0 + 15, columns 16 kk .. 16 kk + 15 of a fragment into a
// row-major bf16 tensor of row stride lls.
__device__ __forceinline__ void stage_square(const unsigned (&a)[4], bf16* t, int lls, int r0,
                                             int kk, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    *reinterpret_cast<unsigned*>(t + (r0 + g + 8 * (e & 1)) * lls + 16 * kk + 2 * tq
                                 + 8 * (e >> 1)) = a[e];
}

// h = T((x - mu) inv gamma + beta), as the forward kernel forms it.
__device__ __forceinline__ float norm_affine(float xv, float mu, float inv, float gm, float bt) {
  return __fadd_rn(__fmul_rn((xv - mu) * inv, gm), bt);
}

// One block per slot: block s takes samples s, s + gridDim.x, ..., its m-th
// into stage m % stages.  Warp 0, lane 0 loads the samples and stores dx.
template <int NT>
__global__ void __launch_bounds__(32 * NT, 1)
fused_attn_block_bwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                               bf16* __restrict__ dx,
                               const bf16* __restrict__ gamma, const bf16* __restrict__ beta,
                               const bf16* __restrict__ wq, const bf16* __restrict__ bq,
                               const bf16* __restrict__ wk, const bf16* __restrict__ bk,
                               const bf16* __restrict__ wv, const bf16* __restrict__ bv,
                               const bf16* __restrict__ wpt, float* __restrict__ slots, int B,
                               int L, int groups, int stages, float eps, float scale,
                               float rescale) {
  constexpr int C = kTcC, ROWS = 16 * NT, LLS = ROWS + 8, NTH = 32 * NT;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const TcLayout lay = tc_layout(NT, L, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_tc);
  bf16* wsm = reinterpret_cast<bf16*>(smem_tc + lay.w);       // Wq, Wk, Wv, Wp panels
  float* acc = reinterpret_cast<float*>(smem_tc + lay.acc);   // dWq, dWk, dWv, dWp
  float* accb = acc + 4 * C * C;                  // dbq, dbk, dbv, dbp, dgamma, dbeta
  float* prm = reinterpret_cast<float*>(smem_tc + lay.prm);   // bq, bk, bv
  // by channel: its group's mean and 1 / std (this sample's), gamma, beta
  float4* cst = reinterpret_cast<float4*>(smem_tc + lay.stats);
  bf16* P0 = reinterpret_cast<bf16*>(smem_tc + lay.panels);   // q, then o
  bf16* P1 = P0 + ROWS * C;                                   // k, then dk, then dx (C x L)
  bf16* P2 = P1 + ROWS * C;                                   // v, then dv
  bf16* P3 = P2 + ROWS * C;                                   // do, then dq
  bf16* PT = reinterpret_cast<bf16*>(smem_tc + lay.ll);       // T(p), ROWS x LLS
  bf16* DS = PT + ROWS * LLS;                                 // ds
  bf16* HP = PT;                                  // after step 3: h,
  bf16* GP = HP + ROWS * C;                       // gs,
  float* part = reinterpret_cast<float*>(GP + ROWS * C);   // column sums, warp by warp,
  float* m12 = part + 2 * NT * C;                 // the GroupNorm means m1, m2 by group
  unsigned char* ring = smem_tc + lay.ring;
  const int sb = tc_slab_bytes(L), slab = C * L, slab_bytes = 2 * slab;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = 16 * w;
  const int gq = lane >> 2, tq = lane & 3;
  const bool leader = threadIdx.x == 0;

  if (leader) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
  }
  // The weights, once: W (C_in x C_out, row-major) transposed into panels of
  // output-channel rows; Wp^T rows are such rows already.
  for (int i = threadIdx.x; i < 3 * C * C / 8; i += NTH) {
    const int t = i / (C * C / 8), r = i - t * (C * C / 8), c = r / (C / 8), n0 = (r % (C / 8)) * 8;
    const bf16* src = t == 0 ? wq : t == 1 ? wk : wv;
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + r);
    const bf16* v = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      wsm[t * C * C + swizzled_chunk<64>(n0 + e, c >> 3) + (c & 7)] = v[e];
  }
  for (int i = threadIdx.x; i < C * C / 8; i += NTH)
    *reinterpret_cast<uint4*>(wsm + 3 * C * C + swizzled_chunk<64>(i / 8, i % 8)) =
        __ldg(reinterpret_cast<const uint4*>(wpt) + i);
  for (int i = threadIdx.x; i < 3 * C; i += NTH) {
    const int t = i / C;
    prm[i] = __bfloat162float((t == 0 ? bq : t == 1 ? bk : bv)[i - t * C]);
  }
  for (int c = threadIdx.x; c < C; c += NTH)
    cst[c] = make_float4(0.f, 0.f, __bfloat162float(gamma[c]), __bfloat162float(beta[c]));
  for (int i = threadIdx.x; i < 4 * C * C + 6 * C; i += NTH) acc[i] = 0.f;
  __syncthreads();

  const int cg = C / groups, mul = (65536 + cg - 1) / cg;   // c / cg = (c * mul) >> 16
  const float inv_n = 1.0f / static_cast<float>(cg * L);
  const float rs_t = rnd_bf16(rescale);
  auto load = [&](int m, int b) {                           // the m-th sample, into stage m % stages
    uint64_t* bar = full + m % stages;
    unsigned char* st = ring + (m % stages) * 2 * sb;
    mbar_expect_tx(bar, 2 * slab_bytes);
    bulk_load(st, x + static_cast<size_t>(b) * slab, slab_bytes, bar);
    bulk_load(st + sb, g + static_cast<size_t>(b) * slab, slab_bytes, bar);
  };
  if (leader)
    for (int m = 0; m < stages && blockIdx.x + m * gridDim.x < B; ++m)
      load(m, blockIdx.x + m * gridDim.x);

  for (int m = 0, b = blockIdx.x; b < B; ++m, b += gridDim.x) {
    mbar_wait(full + m % stages, (m / stages) & 1);
    const bf16* xs = reinterpret_cast<const bf16*>(ring + (m % stages) * 2 * sb);   // C x L
    const bf16* gsl = reinterpret_cast<const bf16*>(ring + (m % stages) * 2 * sb + sb);
    // gs = T(g T(rescale)) at channel c, token l; 0 on padded rows
    auto gs_at = [&](int c, int l) {
      return l < L ? __bfloat162float(gsl[c * L + l]) * rs_t : 0.f;
    };
    auto h_at = [&](int c, int l) {
      const float4 s = cst[c];
      return l < L ? norm_affine(__bfloat162float(xs[c * L + l]), s.x, s.y, s.z, s.w) : 0.f;
    };
    // dx of the last sample went out of P1; the barrier below publishes that
    if (leader) bulk_wait_read();

    // 0. GroupNorm statistics: group gi is cg * L contiguous values; a warp
    //    takes two of its groups at a time (gi and gi + NT), for two
    //    independent chains of loads and sums.
    for (int gi = w; gi < groups; gi += 2 * NT) {
      const bool two = gi + NT < groups;
      const bf16* xa = xs + gi * cg * L;
      const bf16* xb = xs + (two ? gi + NT : gi) * cg * L;
      float s[4] = {0.f, 0.f, 0.f, 0.f};   // sum and sum of squares of each
      if ((cg * L) % 2 == 0) {       // bf16 pairs (a group starts on a 4-byte boundary)
#pragma unroll 4
        for (int i = lane; i < cg * L / 2; i += 32) {
          const float2 u = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(xa)[i]);
          const float2 v = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(xb)[i]);
          s[0] += u.x;
          s[0] += u.y;
          s[1] = fmaf(u.x, u.x, s[1]);
          s[1] = fmaf(u.y, u.y, s[1]);
          s[2] += v.x;
          s[2] += v.y;
          s[3] = fmaf(v.x, v.x, s[3]);
          s[3] = fmaf(v.y, v.y, s[3]);
        }
      } else {
#pragma unroll 4
        for (int i = lane; i < cg * L; i += 32) {
          const float u = __bfloat162float(xa[i]), v = __bfloat162float(xb[i]);
          s[0] += u;
          s[1] = fmaf(u, u, s[1]);
          s[2] += v;
          s[3] = fmaf(v, v, s[3]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int q = 0; q < 4; ++q) s[q] += __shfl_xor_sync(0xffffffffu, s[q], off);
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (q == 1 && !two) break;
        const float mean = s[2 * q] * inv_n;
        const float rstd =
            1.0f / sqrtf(__fsub_rn(__fmul_rn(s[2 * q + 1], inv_n), __fmul_rn(mean, mean)) + eps);
        const int g0 = (gi + q * NT) * cg;
        for (int c = g0 + lane; c < g0 + cg; c += 32)
          *reinterpret_cast<float2*>(cst + c) = make_float2(mean, rstd);
      }
    }
    __syncthreads();

    // The warp's rows of h and gs as A fragments (register e of k-step kk:
    // row r0 + gq + 8 (e % 2), channels 16 kk + 2 tq + 8 (e / 2) + {0, 1}).
    auto rows_of_h_gs = [&](unsigned (&ha)[4][4], unsigned (&ga)[4][4]) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + gq + 8 * (e & 1), c = 16 * kk + 2 * tq + 8 * (e >> 1);
          ha[kk][e] = pack_bf16(h_at(c, r), h_at(c + 1, r));
          ga[kk][e] = pack_bf16(gs_at(c, r), gs_at(c + 1, r));
        }
    };

    // 1. q, k, v staged; do = T(gs Wp^T) staged and kept.
    unsigned ha[4][4], da[4][4];
    rows_of_h_gs(ha, da);
    float t8[8][4];
    zero(t8);
    product16<64, true, 4, 4>(t8, ha, wsm + C * C, lane);
    stage_nin<ROWS>(t8, prm + C, P1, r0, lane);
    zero(t8);
    product16<64, true, 4, 4>(t8, ha, wsm + 2 * C * C, lane);
    stage_nin<ROWS>(t8, prm + 2 * C, P2, r0, lane);
    zero(t8);
    product16<64, true, 4, 4>(t8, ha, wsm, lane);
    stage_nin<ROWS>(t8, prm, P0, r0, lane);
    zero(t8);
    product16<64, false, 4, 4>(t8, da, wsm + 3 * C * C, lane);
    to_frags<4>(t8, da);
    stage_frags<ROWS>(da, P3, r0, lane);
    __syncthreads();

    // 2. As query rows: s = q k^T over all 16 NT keys, the float32 softmax.
    float p[2 * NT][4];
    {
      unsigned qa[4][4];
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
        ldmatrix_x4(qa[kc], P0 + swizzled_chunk<ROWS>(r0 + (lane & 15), 2 * kc + (lane >> 4)));
      zero(p);
      product16<ROWS, true, 4, NT>(p, qa, P1, lane);
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      const bool ragged = 8 * j + 8 > L;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        p[j][2 * hf] = !ragged || 8 * j + 2 * tq < L ? p[j][2 * hf] * scale : -INFINITY;
        p[j][2 * hf + 1] = !ragged || 8 * j + 2 * tq + 1 < L ? p[j][2 * hf + 1] * scale : -INFINITY;
        mx[hf] = fmaxf(mx[hf], fmaxf(p[j][2 * hf], p[j][2 * hf + 1]));
      }
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    }
#pragma unroll
    for (int j = 0; j < 2 * NT; ++j) {
      if (8 * j >= L) {               // padding alone: p is 0 without an exp
        p[j][0] = p[j][1] = p[j][2] = p[j][3] = 0.f;
        continue;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {  // -inf for a padded key: exp gives 0
        const float e0 = expf(p[j][2 * hf] - mx[hf]), e1 = expf(p[j][2 * hf + 1] - mx[hf]);
        p[j][2 * hf] = e0;
        p[j][2 * hf + 1] = e1;
        sum[hf] += e0 + e1;
      }
    }
    // p = e / sum, correctly rounded (Markstein, as attn_mma.cuh divides)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 1);
      sum[hf] += __shfl_xor_sync(0xffffffffu, sum[hf], 2);
      const float rcp = __frcp_rn(sum[hf]);
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = p[j][2 * hf + e], q = v * rcp;
          p[j][2 * hf + e] = fmaf(fmaf(-q, sum[hf], v), rcp, q);
        }
    }
    // o = T(T(p) v), T(p) staged for the key rows
    unsigned oa[4][4];
    zero(t8);
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      unsigned pa[4];
      frag_of(p, kk, pa);
      stage_square(pa, PT, LLS, r0, kk, lane);
      product_step<ROWS, false, 4>(t8, pa, P2, kk, lane);
    }
    to_frags<4>(t8, oa);
    // dp = do v^T in p's layout; ds = T(p (dp - rowsum(dp p)) / sqrt(C))
    unsigned dqa[4][4];
    {
      float dp[2 * NT][4];
      zero(dp);
      product16<ROWS, true, 4, NT>(dp, da, P2, lane);
      float rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          rsum[hf] = fmaf(dp[j][2 * hf], p[j][2 * hf], rsum[hf]);
          rsum[hf] = fmaf(dp[j][2 * hf + 1], p[j][2 * hf + 1], rsum[hf]);
        }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        rsum[hf] += __shfl_xor_sync(0xffffffffu, rsum[hf], 1);
        rsum[hf] += __shfl_xor_sync(0xffffffffu, rsum[hf], 2);
      }
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - rsum[e >> 1]) * scale;
      // dq = T(ds k), ds the A operand as it stands; ds staged for the key rows
      zero(t8);
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        unsigned sa[4];
        frag_of(dp, kk, sa);
        stage_square(sa, DS, LLS, r0, kk, lane);
        product_step<ROWS, false, 4>(t8, sa, P1, kk, lane);
      }
      to_frags<4>(t8, dqa);
    }
    __syncthreads();

    // 3. As key rows (the same 16 tokens): dv = T(T(p)^T do), dk = T(ds^T q),
    //    A by ldmatrix.trans of the warp's columns of T(p) and ds.
    unsigned dva[4][4], dka[4][4];
    {
      float dk[8][4];
      zero(t8);
      zero(dk);
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        unsigned pta[4], sta[4];
        const int off = (16 * kk + (lane & 7) + 8 * (lane >> 4)) * LLS + r0 + 8 * ((lane >> 3) & 1);
        ldmatrix_x4_trans(pta, PT + off);
        ldmatrix_x4_trans(sta, DS + off);
        product_step<ROWS, false, 4>(t8, pta, P3, kk, lane);
        product_step<ROWS, false, 4>(dk, sta, P0, kk, lane);
      }
      to_frags<4>(t8, dva);
      to_frags<4>(dk, dka);
    }
    stage_frags<ROWS>(dva, P2, r0, lane);   // v and k are dead since the barrier
    stage_frags<ROWS>(dka, P1, r0, lane);
    // dh = dq Wq^T + dk Wk^T + dv Wv^T, float32
    float dh[8][4];
    zero(dh);
    product16<64, false, 4, 4>(dh, dqa, wsm, lane);
    product16<64, false, 4, 4>(dh, dka, wsm + C * C, lane);
    product16<64, false, 4, 4>(dh, dva, wsm + 2 * C * C, lane);
    __syncthreads();

    // o and dq over the dead q and do, h and gs over the dead T(p); the
    // warp's column sums of dh and dh xhat (accumulator element (n, e): row
    // r0 + gq + 8 (e / 2), channel 8 n + 2 tq + e % 2), summed over its 16
    // rows, lanes 0..3 keep them.
    stage_frags<ROWS>(oa, P0, r0, lane);
    stage_frags<ROWS>(dqa, P3, r0, lane);
    rows_of_h_gs(ha, da);
    stage_frags<ROWS>(ha, HP, r0, lane);
    stage_frags<ROWS>(da, GP, r0, lane);
    {
      float s1[16], s2[16];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * tq + e;
          const float4 s = cst[c];
          s1[2 * n + e] = s2[2 * n + e] = 0.f;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int r = r0 + gq + 8 * hf;
            if (r < L) {
              const float d = dh[n][2 * hf + e];
              s1[2 * n + e] += d;
              s2[2 * n + e] = fmaf(d, (__bfloat162float(xs[c * L + r]) - s.x) * s.y, s2[2 * n + e]);
            }
          }
        }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
          s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
        }
      if (gq == 0)
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int c = 8 * (i >> 1) + 2 * tq + (i & 1);
          part[w * C + c] = s1[i];
          part[(NT + w) * C + c] = s2[i];
        }
    }
    __syncthreads();

    // 4. The sample's weight and bias gradients, added into the block's
    //    accumulators, in 24 units over the warps: unit u < 16 is rows
    //    16 (u % 4) .. of dW_(u / 4) (q, k, v, p), all 64 columns; u >= 16
    //    columns 32 (u % 2) .. of bias (u - 16) / 2.  A is h^T or o^T by
    //    ldmatrix.trans of their rows (a row of ones for a bias: the column
    //    sums), B is dq, dk, dv or gs.  Weight element (i, j) sits at
    //    i C + (j ^ 8 (i % 4)).
    for (int u = w; u < kTcUnits; u += NT) {
      if (u < 16) {
        const int t = u >> 2, mt = u & 3;
        float* aw = acc + t * C * C;
        float d[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 16 * mt + gq + 8 * hf;
            const float2 v = *reinterpret_cast<const float2*>(aw + i * C + ((8 * n + 2 * tq) ^ (8 * (i & 3))));
            d[n][2 * hf] = v.x;
            d[n][2 * hf + 1] = v.y;
          }
#pragma unroll
        for (int kk = 0; kk < NT; ++kk) {
          unsigned a[4];
          ldmatrix_x4_trans(a, (t < 3 ? HP : P0)
                                   + swizzled_chunk<ROWS>(16 * kk + (lane & 7) + 8 * (lane >> 4),
                                                          2 * mt + ((lane >> 3) & 1)));
          product_step<ROWS, false, 4>(d, a, t == 0 ? P3 : t == 1 ? P1 : t == 2 ? P2 : GP, kk,
                                       lane);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 16 * mt + gq + 8 * hf;
            *reinterpret_cast<float2*>(aw + i * C + ((8 * n + 2 * tq) ^ (8 * (i & 3)))) =
                make_float2(d[n][2 * hf], d[n][2 * hf + 1]);
          }
      } else {
        const int t = (u - 16) >> 1, half = u & 1;
        float* ab = accb + t * C + 32 * half;
        float d[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n) {   // every row starts from the bias and ends as it
          const float2 v = *reinterpret_cast<const float2*>(ab + 8 * n + 2 * tq);
          d[n][0] = d[n][2] = v.x;
          d[n][1] = d[n][3] = v.y;
        }
        const unsigned one = pack_bf16(1.f, 1.f);
        const unsigned a[4] = {one, one, one, one};
#pragma unroll
        for (int kk = 0; kk < NT; ++kk)
          product_step<ROWS, false, 2>(d, a, t == 0 ? P3 : t == 1 ? P1 : t == 2 ? P2 : GP, kk,
                                       lane, 2 * half);
        if (gq == 0)
#pragma unroll
          for (int n = 0; n < 4; ++n)
            *reinterpret_cast<float2*>(ab + 8 * n + 2 * tq) = make_float2(d[n][0], d[n][1]);
      }
    }
    // dgamma, dbeta, and the GroupNorm means m1, m2 of each group, from the
    // warps' column sums (each a fixed order)
    for (int c = threadIdx.x; c < C; c += NTH) {
      float s1 = 0.f, s2 = 0.f;
      for (int v = 0; v < NT; ++v) {
        s1 += part[v * C + c];
        s2 += part[(NT + v) * C + c];
      }
      accb[4 * C + c] += s2;
      accb[5 * C + c] += s1;
    }
    for (int gi = w; gi < groups; gi += NT) {
      float t1 = 0.f, t2 = 0.f;
      for (int i = lane; i < cg * NT; i += 32) {
        const int c = gi * cg + i % cg, v = i / cg;
        const float gmc = cst[c].z;
        t1 = fmaf(gmc, part[v * C + c], t1);
        t2 = fmaf(gmc, part[(NT + v) * C + c], t2);
      }
      t1 = warp_sum(t1);
      t2 = warp_sum(t2);
      if (lane == 0) {
        m12[gi] = t1 * inv_n;
        m12[C + gi] = t2 * inv_n;
      }
    }
    __syncthreads();

    // 5. dx = T(inv (dh gamma - m1 - xhat m2) + g rescale) for the warp's
    //    rows, as the C x L slab over the dead k panel, then one bulk store;
    //    the stage takes the sample `stages` ahead.
    //    Every value first, then the stores (loads are not held behind them).
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + gq + 8 * (e >> 1), c = 8 * n + 2 * tq + (e & 1), k = (c * mul) >> 16;
        if (r < L) {
          const float4 s = cst[c];
          const float xh = (__bfloat162float(xs[c * L + r]) - s.x) * s.y;
          dh[n][e] = s.y * (dh[n][e] * s.z - m12[k] - xh * m12[C + k])
                     + __bfloat162float(gsl[c * L + r]) * rescale;
        }
      }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + gq + 8 * (e >> 1), c = 8 * n + 2 * tq + (e & 1);
        if (r < L) P1[c * L + r] = __float2bfloat16(dh[n][e]);
      }
    fence_proxy_async();             // the bulk store reads these bytes
    __syncthreads();
    if (leader) {
      bulk_store(dx + static_cast<size_t>(b) * slab, P1, slab_bytes);
      if (b + stages * gridDim.x < B) load(m + stages, b + stages * gridDim.x);
    }
  }
  if (leader) bulk_wait();

  // The block's sums go to its slot once, in parameter order.
  const GradOffsets go(C);
  float* slot = slots + static_cast<size_t>(blockIdx.x) * go.total;
  const int woff[4] = {go.wq, go.wk, go.wv, go.wp};
  for (int i = threadIdx.x; i < 4 * C * C; i += NTH) {
    const int t = i / (C * C), r = (i / C) % C, c = i % C;
    slot[woff[t] + r * C + c] = acc[t * C * C + r * C + (c ^ (8 * (r & 3)))];
  }
  const int boff[6] = {go.bq, go.bk, go.bv, go.bp, go.gamma, go.beta};
  for (int i = threadIdx.x; i < 6 * C; i += NTH) slot[boff[i / C] + i % C] = accb[i];
}

template <int NT>
cudaError_t launch_tc(const void* x, const void* g, void* dx, const void* const* p, float* grads,
                      float* slots, int B, int L, int groups, float eps, float scale,
                      float rescale, cudaStream_t stream) {
  auto kern = fused_attn_block_bwd_tc_kernel<NT>;
  static SmemAttr smem_attr;
  const cudaError_t attr = smem_attr.apply(reinterpret_cast<const void*>(kern), kTcSmemLimit);
  if (attr != cudaSuccess) return attr;
  const int stages = tc_stages(NT, L);
  const int n_slots = B < kSlots ? B : kSlots;
  const GradOffsets go(kTcC);
  kern<<<n_slots, 32 * NT, tc_layout(NT, L, stages).total, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g), static_cast<bf16*>(dx),
      static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]),
      static_cast<const bf16*>(p[2]), static_cast<const bf16*>(p[3]),
      static_cast<const bf16*>(p[4]), static_cast<const bf16*>(p[5]),
      static_cast<const bf16*>(p[6]), static_cast<const bf16*>(p[7]),
      static_cast<const bf16*>(p[8]), slots, B, L, groups, stages, eps, scale, rescale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_slots_kernel<<<(go.total + 255) / 256, 256, 0, stream>>>(slots, grads, n_slots, go.total);
  return cudaGetLastError();
}

// Warps of a tensor-core block for L tokens: 16-row tiles 2, 4 or 6.
inline int tc_warps(int L) { return (L + 31) / 32 * 2; }

bool tc_body(int C, int L, int dtype) { return dtype == 1 && C == kTcC && L <= kTcMaxL; }

bool valid(int B, int C, int L, int groups) {
  return B >= 1 && L >= 1 && L <= kMaxL && groups >= 1 && (C == 64 || C == 128)
         && C % groups == 0;
}

}  // namespace

extern "C" {

// Floats of device workspace the launch needs: the slots of partial
// parameter gradients, then the scratch of the buffers that do not fit in
// shared memory (none for the tensor-core body).  0 for an unsupported shape.
long long rdm_fused_attn_block_bwd_workspace(int B, int C, int L, int groups) {
  if (!valid(B, C, L, groups)) return 0;
  const long long n_slots = B < kSlots ? B : kSlots;
  return n_slots * (GradOffsets(C).total + make_layout(C, L).scratch_floats);
}

// The body a launch takes for (C, L, dtype) and its plan, into out[4]:
// 1 for the tensor-core body (0: the scalar one), threads a block, stages
// of x and g, dynamic shared memory bytes.  Returns a cudaError_t.
int rdm_fused_attn_block_bwd_plan(int C, int L, int dtype, int* out) {
  if (!valid(1, C, L, 1) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tc_body(C, L, dtype)) {
    const int nt = tc_warps(L), stages = tc_stages(nt, L);
    out[0] = 1;
    out[1] = 32 * nt;
    out[2] = stages;
    out[3] = tc_layout(nt, L, stages).total;
  } else {
    out[0] = 0;
    out[1] = kThreads;
    out[2] = 0;
    out[3] = static_cast<int>(sizeof(float)) * make_layout(C, L).smem_floats;
  }
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16.  params: gamma, beta, Wq, bq, Wk, bk, Wv,
// bv, Wp^T, bp, Wq^T, Wk^T, Wv^T, all of the working type; W is (C_in, C_out)
// row-major.  grads: 4 C^2 + 6 C floats, the ten gradients in parameter order
// (gamma, beta, Wq, bq, Wk, bk, Wv, bv, Wp, bp).  bfloat16 at C = 64 with
// L <= 96 runs the tensor-core body, which reads neither bp nor Wq^T, Wk^T,
// Wv^T (they may be null) and needs x, g, dx and Wp^T on 16-byte
// boundaries; every other shape and float32 the scalar body.  Returns a
// cudaError_t.
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
  if (tc_body(C, L, dtype)) {
    const int nt = tc_warps(L);
    if (nt == 2) return static_cast<int>(launch_tc<2>(x, g, dx, p, gr, ws, B, L, groups, eps, scale, rescale, s));
    if (nt == 4) return static_cast<int>(launch_tc<4>(x, g, dx, p, gr, ws, B, L, groups, eps, scale, rescale, s));
    return static_cast<int>(launch_tc<6>(x, g, dx, p, gr, ws, B, L, groups, eps, scale, rescale, s));
  }
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
