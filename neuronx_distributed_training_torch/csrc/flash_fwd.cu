// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the TPU kernel `_fwd_kernel` (launched by `_fwd_pallas`) in
// neuronx_distributed_training_tpu/ops/flash_attention.py: the online-softmax
// forward o = softmax(q k^T * d^-1/2 + mask) v with its row logsumexp, causal /
// sliding-window masking with q_offset, an optional key-padding mask, optional
// packed segments, GQA by index (kv head = h / (nh / nkv), K/V never repeated),
// and exact skipping of fully masked kv tiles.
//
// Design: one block of 4 warps owns a 64-row q tile of one head; each warp owns
// 16 rows.  The TPU grid's sequential kv dimension is a loop inside the block,
// over the visible kv tiles only; the next tile's K and V stream into a second
// shared-memory buffer (cp.async) while this one is computed.  q k^T and p v run
// on the tensor cores with mma.sync m16n8k16 (bf16 operands, fp32
// accumulators, K and V fragments by ldmatrix); p is rounded to bf16 for the
// p v product exactly where the TPU kernel does `p.astype(v.dtype)`.  The
// running max, sum and output tile stay in registers (the accumulator fragment
// layout tells each thread its rows).  Late q tiles, the longest under causal
// masking, are scheduled first.
//
// Bound on the card: at the main-path shape (b=1, nh=32, nkv=8, s=8192, d=128,
// causal) the work is 4*nh*s^2*d/2 ~ 550 GFLOP per call against ~0.1 GB of
// traffic, so the forward is bound by tensor-core operations.  Left for later:
// Hopper's wgmma and TMA in place of mma.sync and cp.async, and warp
// specialisation.
#include <climits>

#include "flash_common.cuh"

namespace nxdt {

struct FwdParams {
  const bf16 *q, *k, *v;
  const int *kvm, *seg;
  bf16* o;
  float* lse;
  int b, sq, skv, nh, nkv, group;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale;
  int causal, window, q_offset;
};

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_kernel(const FwdParams p) {
  constexpr int LD = D + 8, NT = 128, KS = D / 16, ON = D / 8, SN = BKV / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ * LD;         // two K buffers, then two V buffers
  bf16* Vs = Ks + 2 * BKV * LD;
  __shared__ int kvm_s[2][BKV];
  __shared__ int segk_s[2][BKV];
  __shared__ int segq_max;

  // the causal diagonal makes late q tiles the longest: schedule them first
  const int qi = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int kh = h / p.group;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = warp * 16 + g;  // this thread's rows of the q tile: r0 and r0 + 8

  load_tile<D, LD, BQ, NT>(Qs, p.q + bi * p.q_sb + h * p.q_sh + (long long)qi * BQ * p.q_ss,
                           p.q_ss, tid);
  int segq0 = 0, segq1 = 0;
  if (p.seg) {
    if (tid == 0) segq_max = INT_MIN;
    __syncthreads();
    const int* segq = p.seg + (long long)bi * p.sq + qi * BQ;
    if (tid < BQ) atomicMax(&segq_max, segq[tid]);
    segq0 = segq[r0];
    segq1 = segq[r0 + 8];
  }
  __syncthreads();

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const bf16* ap = Qs + r0 * LD + kk * 16 + t * 2;
    qf[kk][0] = ld32(ap);
    qf[kk][1] = ld32(ap + 8 * LD);
    qf[kk][2] = ld32(ap + 8);
    qf[kk][3] = ld32(ap + 8 * LD + 8);
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[ON][4];
#pragma unroll
  for (int on = 0; on < ON; ++on)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[on][e] = 0.f;
  const int qpos0 = p.q_offset + qi * BQ + r0, qpos1 = qpos0 + 8;

  const bf16* kbase = p.k + bi * p.k_sb + kh * p.k_sh;
  const bf16* vbase = p.v + bi * p.v_sb + kh * p.v_sh;
  const int* kvm_row = p.kvm ? p.kvm + (long long)bi * p.skv : nullptr;
  const int* segk_row = p.seg ? p.seg + (long long)bi * p.skv : nullptr;
  const int nkb = p.skv / BKV;

  // the next kv tile at or after `ki` that some query of this q tile may see;
  // fully masked tiles (causal / window, all-padding, ahead of every query
  // segment) are never loaded or computed.  Block-uniform.
  auto next_live = [&](int ki) {
    for (; ki < nkb; ++ki) {
      if (!tile_visible(qi, ki, p.causal, p.window, p.q_offset)) continue;
      const int kv = ki * BKV + tid;
      if (kvm_row && !__syncthreads_or(tid < BKV && kvm_row[kv] > 0)) continue;
      if (segk_row && !__syncthreads_or(tid < BKV && segk_row[kv] <= segq_max)) continue;
      return ki;
    }
    return nkb;
  };
  auto issue = [&](int ki, int buf) {
    const int kv0 = ki * BKV;
    load_tile_async<D, LD, BKV, NT>(Ks + buf * BKV * LD, kbase + (long long)kv0 * p.k_ss,
                                    p.k_ss, tid);
    load_tile_async<D, LD, BKV, NT>(Vs + buf * BKV * LD, vbase + (long long)kv0 * p.v_ss,
                                    p.v_ss, tid);
    cp_async_commit();
    if (tid < BKV) {
      if (kvm_row) kvm_s[buf][tid] = kvm_row[kv0 + tid];
      if (segk_row) segk_s[buf][tid] = segk_row[kv0 + tid];
    }
  };

  int ki = next_live(0), buf = 0;
  if (ki < nkb) issue(ki, 0);
  while (ki < nkb) {
    const int nxt = next_live(ki + 1);
    if (nxt < nkb) {
      issue(nxt, buf ^ 1);  // overlaps this tile's math
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * BKV * LD;
    const bf16* Vb = Vs + buf * BKV * LD;
    const int kv0 = ki * BKV;

    float s[SN][4];
#pragma unroll
    for (int nt = 0; nt < SN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
    for (int nt = 0; nt < SN; ++nt) {
#pragma unroll
      for (int kk = 0; kk < KS; kk += 2) {
        // b fragments of k steps kk and kk + 1 for kv rows nt*8.. (K row-major)
        uint32_t b[4];
        ldmatrix_x4(b, Kb + (nt * 8 + (lane & 7)) * LD + kk * 16 + (lane >> 3) * 8);
        mma16816(s[nt], qf[kk], b[0], b[1]);
        mma16816(s[nt], qf[kk + 1], b[2], b[3]);
      }
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int nt = 0; nt < SN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + t * 2 + (e & 1);
        const int r = e >> 1;
        bool ok = pos_visible(r ? qpos1 : qpos0, kv0 + col, p.causal, p.window);
        if (kvm_row) ok = ok && kvm_s[buf][col] > 0;
        if (segk_row) ok = ok && segk_s[buf][col] == (r ? segq1 : segq0);
        const float x = ok ? s[nt][e] * p.scale : NEG_INF;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffff, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < SN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pv = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = pv;
        ls[e >> 1] += pv;
      }
    l[0] = alpha[0] * l[0] + ls[0];
    l[1] = alpha[1] * l[1] + ls[1];
#pragma unroll
    for (int on = 0; on < ON; ++on) {
      acc[on][0] *= alpha[0];
      acc[on][1] *= alpha[0];
      acc[on][2] *= alpha[1];
      acc[on][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int on = 0; on < ON; on += 2) {
        // b fragments of output column tiles on and on + 1 (V row-major, transposed)
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                 on * 8 + (lane >> 4) * 8);
        mma16816(acc[on], a, b[0], b[1]);
        mma16816(acc[on + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
    ki = nxt;
    buf ^= 1;
  }

  float* lse = p.lse + ((long long)bi * p.nh + h) * p.sq + qi * BQ;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffff, l[r], 2);
    // a row with no visible key keeps m = NEG_INF: output 0, lse NEG_INF
    const bool vis = m[r] > NEG_INF / 2;
    const float l_safe = l[r] == 0.f ? 1.f : l[r];
    const int row = r0 + r * 8;
    bf16* orow = p.o + bi * p.o_sb + h * p.o_sh + (long long)(qi * BQ + row) * p.o_ss;
#pragma unroll
    for (int on = 0; on < ON; ++on) {
      const float x0 = vis ? acc[on][2 * r] / l_safe : 0.f;
      const float x1 = vis ? acc[on][2 * r + 1] / l_safe : 0.f;
      *reinterpret_cast<uint32_t*>(orow + on * 8 + t * 2) = pack_bf16(x0, x1);
    }
    if (t == 0) lse[row] = vis ? m[r] + logf(l_safe) : NEG_INF;
  }
}

template <int D>
static int launch_fwd(const FwdParams& p, cudaStream_t stream) {
  const size_t smem = 5 * BQ * (D + 8) * sizeof(bf16);  // Q + 2 x (K + V)
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_kernel<D><<<dim3(p.sq / BQ, p.nh, p.b), 128, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace nxdt

extern "C" int nxdt_flash_fwd(const void* q, const void* k, const void* v, const void* kvm,
                              const void* seg, void* o, void* lse, int b, int sq, int skv,
                              int nh, int nkv, int d, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                              long long o_ss, long long o_sh, float scale, int causal,
                              int window, int q_offset, void* stream) {
  using namespace nxdt;
  FwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.kvm = static_cast<const int*>(kvm);
  p.seg = static_cast<const int*>(seg);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.b = b; p.sq = sq; p.skv = skv; p.nh = nh; p.nkv = nkv; p.group = nh / nkv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale; p.causal = causal; p.window = window; p.q_offset = q_offset;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return launch_fwd<128>(p, st);
  if (d == 64) return launch_fwd<64>(p, st);
  return (int)cudaErrorInvalidValue;
}
