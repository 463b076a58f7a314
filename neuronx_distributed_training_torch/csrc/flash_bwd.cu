// Flash-attention dq kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dq_kernel` (launched by `_bwd_pallas`) in
// neuronx_distributed_training_tpu/ops/flash_attention.py.  It recomputes
// p = exp(s - lse) per tile (0 on rows whose lse is NEG_INF), then
// ds = p * (do v^T - delta) * scale; delta = rowsum(do * o) (minus the lse
// cotangent in the lse variant) comes in precomputed, as in the TPU code.
// One block per (q tile, q head) loops over the visible kv tiles and
// accumulates dq = sum ds k.
//
// Precision, as on the TPU: s = q k^T and dp = do v^T take bf16 operands, whose
// products are exact in fp32, and run on the tensor cores with fp32
// accumulation.  ds stays fp32 and so does its product ds k, because rounding
// ds to bf16 biases dq: each fp32 operand is split exactly into three bf16
// parts (hi + mid + lo), so ds k = hi k + mid k + lo k with every product exact
// and all sums in fp32, on the tensor cores.
//
// Bound on the card: per visible (query, key) pair the kernel does 4d bf16
// operations for s and dp plus 3 x 2d for the split ds k; at the main-path
// shape (b=1, nh=32, nkv=8, s=8192, d=128, causal) that is ~1.4 TFLOP per call
// against ~0.2 GB of traffic, so it is bound by tensor-core operations.  Left
// for later: cp.async / TMA pipelining of the tiles (they load synchronously;
// two blocks per SM overlap one's loads with the other's math), and wgmma.
#include <climits>

#include "flash_common.cuh"

namespace nxdt {

struct BwdParams {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *kvm, *seg;
  bf16 *dq, *dk, *dv;
  int b, sq, skv, nh, nkv, group;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh;
  long long dq_sb, dq_ss, dq_sh, dk_sb, dk_ss, dk_sh;  // dv shares dk's strides
  float scale;
  int causal, window, q_offset;
};

constexpr int LDS = BKV + 4;  // fp32 tile pitch (64 columns)

// x = hi + mid + lo exactly, each part bf16: bf16 keeps 8 significand bits,
// so three parts hold fp32's 24.  A product of such an fp32 operand with a bf16
// operand is then three exact bf16 products summed in fp32 on the tensor cores.
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi, uint32_t& mid,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = x0 - hf.x, r1 = x1 - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0 - mf.x, r1 - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// acc (16 x 8 per n-tile, NTILES n-tiles) += X (16 x 64, fp32, split exactly
// into three bf16 parts) @ Y (64 x NTILES*8, bf16 rows of pitch LD).  `xval(r, c)`
// reads X; `yrow` points at Y[0][first column of this warp].
template <int NTILES, int LD, typename XF>
__device__ __forceinline__ void mma_split_fp32(float acc[][4], XF xval, const bf16* yrow,
                                               int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    const int k0 = kk * 16 + t * 2;
    uint32_t hi[4], mid[4], lo[4];
    split3(xval(g, k0), xval(g, k0 + 1), hi[0], mid[0], lo[0]);
    split3(xval(g + 8, k0), xval(g + 8, k0 + 1), hi[1], mid[1], lo[1]);
    split3(xval(g, k0 + 8), xval(g, k0 + 9), hi[2], mid[2], lo[2]);
    split3(xval(g + 8, k0 + 8), xval(g + 8, k0 + 9), hi[3], mid[3], lo[3]);
    const bf16* yp = yrow + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int nt = 0; nt < NTILES; nt += 2) {
      uint32_t b[4];  // Y is row-major [k][n]: transposed loads give the b fragments
      ldmatrix_x4_trans(b, yp + nt * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        mma16816(acc[nt + j], lo, b[2 * j], b[2 * j + 1]);
        mma16816(acc[nt + j], mid, b[2 * j], b[2 * j + 1]);
        mma16816(acc[nt + j], hi, b[2 * j], b[2 * j + 1]);
      }
    }
  }
}

// p and ds for one 64 x 64 (q rows x kv columns) tile: each warp computes a
// 16 x 32 block of s = q k^T and dp = do v^T on the tensor cores, then writes
// p and ds in fp32 to shared memory.
template <int D>
__device__ __forceinline__ void tile_p_ds(const BwdParams& p, const bf16* Qs, const bf16* dOs,
                                          const bf16* Ks, const bf16* Vs, const float* lse_s,
                                          const float* delta_s, const int* kvm_s,
                                          const int* segq_s, const int* segk_s, float* Ps,
                                          float* dSs, int qi, int ki) {
  constexpr int LD = D + 8;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rb = (warp & 3) * 16, cb = (warp >> 2) * 32;
  float s[4][4], dp[4][4];
  warp_tile_abt<D, LD>(s, Qs, Ks, rb, cb, lane);
  warp_tile_abt<D, LD>(dp, dOs, Vs, rb, cb, lane);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rl = rb + g + (e >> 1) * 8, cl = cb + nt * 8 + t * 2 + (e & 1);
      bool ok = pos_visible(p.q_offset + qi * BQ + rl, ki * BKV + cl, p.causal, p.window);
      if (p.kvm) ok = ok && kvm_s[cl] > 0;
      if (p.seg) ok = ok && segq_s[rl] == segk_s[cl];
      const float x = ok ? s[nt][e] * p.scale : NEG_INF;
      const float lse = lse_s[rl];
      const float pv = lse > NEG_INF / 2 ? expf(x - lse) : 0.f;
      if (Ps) Ps[rl * LDS + cl] = pv;
      dSs[rl * LDS + cl] = pv * (dp[nt][e] - delta_s[rl]) * p.scale;
    }
}

template <int D>
__global__ void __launch_bounds__(256) flash_dq_kernel(const BwdParams p) {
  constexpr int LD = D + 8, NT = 256, NJ = D / 16;  // NJ: n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BQ * LD;
  bf16* Ks = dOs + BQ * LD;
  bf16* Vs = Ks + BKV * LD;
  float* dSs = reinterpret_cast<float*>(Vs + BKV * LD);
  __shared__ float lse_s[BQ], delta_s[BQ];
  __shared__ int kvm_s[BKV], segk_s[BKV], segq_s[BQ];
  __shared__ int segq_max;

  const int qi = blockIdx.x, h = blockIdx.y, bi = blockIdx.z, kh = h / p.group;
  const int tid = threadIdx.x;
  load_tile<D, LD, BQ, NT>(Qs, p.q + bi * p.q_sb + h * p.q_sh + (long long)qi * BQ * p.q_ss,
                           p.q_ss, tid);
  load_tile<D, LD, BQ, NT>(
      dOs, p.dout + bi * p.do_sb + h * p.do_sh + (long long)qi * BQ * p.do_ss, p.do_ss, tid);
  const long long row0 = ((long long)bi * p.nh + h) * p.sq + qi * BQ;
  if (tid < BQ) {
    lse_s[tid] = p.lse[row0 + tid];
    delta_s[tid] = p.delta[row0 + tid];
  }
  if (p.seg) {
    if (tid == 0) segq_max = INT_MIN;
    __syncthreads();
    if (tid < BQ) {
      segq_s[tid] = p.seg[(long long)bi * p.sq + qi * BQ + tid];
      atomicMax(&segq_max, segq_s[tid]);
    }
  }
  __syncthreads();

  // this warp's dq block: rows rb..rb+15, columns cb..cb+D/2-1
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rb = (warp & 3) * 16, cb = (warp >> 2) * (D / 2);
  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const bf16* kbase = p.k + bi * p.k_sb + kh * p.k_sh;
  const bf16* vbase = p.v + bi * p.v_sb + kh * p.v_sh;
  const int nkb = p.skv / BKV;
  for (int ki = 0; ki < nkb; ++ki) {
    if (!tile_visible(qi, ki, p.causal, p.window, p.q_offset)) continue;
    const int kv0 = ki * BKV;
    if (p.kvm) {
      const int val = tid < BKV ? p.kvm[(long long)bi * p.skv + kv0 + tid] : 0;
      if (!__syncthreads_or(val > 0)) continue;
    }
    if (p.seg) {
      const int ok = tid < BKV ? (p.seg[(long long)bi * p.skv + kv0 + tid] <= segq_max) : 0;
      if (!__syncthreads_or(ok)) continue;
    }
    __syncthreads();  // the previous tile's K and dS reads are done
    load_tile<D, LD, BKV, NT>(Ks, kbase + (long long)kv0 * p.k_ss, p.k_ss, tid);
    load_tile<D, LD, BKV, NT>(Vs, vbase + (long long)kv0 * p.v_ss, p.v_ss, tid);
    if (tid < BKV) {
      if (p.kvm) kvm_s[tid] = p.kvm[(long long)bi * p.skv + kv0 + tid];
      if (p.seg) segk_s[tid] = p.seg[(long long)bi * p.skv + kv0 + tid];
    }
    __syncthreads();
    tile_p_ds<D>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, kvm_s, segq_s, segk_s, nullptr, dSs, qi,
                 ki);
    __syncthreads();
    // dq += ds k, ds kept exact in fp32 (three bf16 parts)
    mma_split_fp32<NJ, LD>(
        acc, [&](int r, int c) { return dSs[(rb + r) * LDS + c]; }, Ks + cb, lane);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* out = p.dq + bi * p.dq_sb + h * p.dq_sh + (long long)(qi * BQ + rb + g + 8 * r) * p.dq_ss;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      *reinterpret_cast<uint32_t*>(out + cb + j * 8 + t * 2) =
          pack_bf16(acc[j][2 * r], acc[j][2 * r + 1]);
  }
}

template <int D>
static int launch_dq(const BwdParams& p, cudaStream_t stream) {
  const size_t smem = 4 * BQ * (D + 8) * sizeof(bf16) + BQ * LDS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  flash_dq_kernel<D><<<dim3(p.sq / BQ, p.nh, p.b), 256, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

static BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kvm,
                             const void* seg, int b, int sq, int skv, int nh, int nkv,
                             const long long* st, float scale, int causal, int window,
                             int q_offset) {
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kvm = static_cast<const int*>(kvm);
  p.seg = static_cast<const int*>(seg);
  p.dq = p.dk = p.dv = nullptr;
  p.b = b; p.sq = sq; p.skv = skv; p.nh = nh; p.nkv = nkv; p.group = nh / nkv;
  p.q_sb = st[0]; p.q_ss = st[1]; p.q_sh = st[2];
  p.k_sb = st[3]; p.k_ss = st[4]; p.k_sh = st[5];
  p.v_sb = st[6]; p.v_ss = st[7]; p.v_sh = st[8];
  p.do_sb = st[9]; p.do_ss = st[10]; p.do_sh = st[11];
  p.dq_sb = p.dq_ss = p.dq_sh = p.dk_sb = p.dk_ss = p.dk_sh = 0;
  p.scale = scale; p.causal = causal; p.window = window; p.q_offset = q_offset;
  return p;
}

}  // namespace nxdt

// strides: 12 element strides (batch, seq, head) of q, k, v and dout, in order.
extern "C" int nxdt_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kvm,
                             const void* seg, void* dq, int b, int sq, int skv, int nh,
                             int nkv, int d, const long long* strides, long long dq_sb,
                             long long dq_ss, long long dq_sh, float scale, int causal,
                             int window, int q_offset, void* stream) {
  using namespace nxdt;
  BwdParams p = make_params(q, k, v, dout, lse, delta, kvm, seg, b, sq, skv, nh, nkv, strides,
                            scale, causal, window, q_offset);
  p.dq = static_cast<bf16*>(dq);
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d == 128) return launch_dq<128>(p, st);
  if (d == 64) return launch_dq<64>(p, st);
  return (int)cudaErrorInvalidValue;
}
