// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces the TPU kernel `_fwd_kernel` (launched by `_fwd_pallas`) in
// neuronx_distributed_training_tpu/ops/flash_attention.py: the online-softmax
// forward o = softmax(q k^T * d^-1/2 + mask) v with its row logsumexp, causal /
// sliding-window masking with q_offset, an optional key-padding mask, optional
// packed segments, GQA by index (kv head = h / (nh / nkv), K/V never repeated),
// and exact skipping of fully masked kv tiles.
//
// Bound on the card: at the main-path shape (b=1, nh=32, nkv=8, s=8192, d=128,
// causal) the work is 4*nh*s^2*d/2 ~ 550 GFLOP per call against ~0.1 GB of
// traffic, so the forward is bound by tensor-core operations; the design feeds
// wgmma, the only way to Hopper's full tensor-core rate.
//
// Design (warp-specialised, one CTA per 128-row q tile of one head):
// - Roles.  Warpgroups 0 and 1 are consumers, each owning 64 q rows (wgmma's
//   M); warpgroup 2 is the producer, of which one warp works and gives its
//   registers to the consumers (setmaxnreg 40 / 232, in one if/else by role).
// - The kv ring.  The producer loads the Q tile once and streams K and V tiles
//   of 128 rows through a 2-stage shared-memory ring with TMA (128B swizzle),
//   completion counted in bytes on a "full" mbarrier per stage; consumers hand
//   a stage back on its "empty" mbarrier.
// - Products.  S = Q K^T is wgmma m64n128k16 with both operands in shared
//   memory (both K-major).  p is rounded to bf16 in registers, exactly where
//   the TPU kernel does `p.astype(v.dtype)`, and feeds O += P V as wgmma's
//   register A operand; V [kv, d] is MN-major for B (transpose bit set).
// - Softmax.  m, l and the rescale stay in registers, in log2 units (exp2
//   with log2(e) * scale folded in); lse is written in natural log.
// - Masks.  The producer decides which kv tiles are live and which of them
//   straddle the causal diagonal, the window edge, padding, a segment edge
//   or the end of the keys; only those take the per-element mask.  The walk
//   is `stream_kv_tiles` in flash_pipeline.cuh, shared with the dq kernel.
// - Scheduling.  blockIdx.x is the head and blockIdx.y walks the q tiles from
//   the last (the longest under causal masking) to the first.
//
// Where the trouble lies:
// - Tensor maps for strided views: v arrives as a view of the fused QKV
//   projection (seq stride (nh + 2 nkv) d).  Each operand is a 4-D map
//   (d, s, h, b) built from the strides the wrapper passes; a 128B-swizzled
//   box row is at most 64 bf16, so d = 128 takes two boxes per tile.
// - cuTensorMapEncodeTiled is taken from the driver through the runtime's
//   entry-point lookup (its signature differs across CUDA 12.x; see
//   hopper.cuh), and each map is passed by value in a __grid_constant__
//   parameter block.
// - Producer and consumers must walk the same tiles: the skips depend on the
//   data (padding, segments), so only the producer decides, and it publishes
//   each live tile's index and mask flag in the stage; index -1 ends the walk.
// - wgmma descriptors: LBO / SBO of the 128B-swizzled layouts and the 32-byte
//   k16 step are in hopper.cuh.  Accumulator arrays take compile-time indices
//   only (fully unrolled loops), or they spill.
// - Ragged tiles: when sq % 128 == 64 the second consumer's rows lie past sq;
//   TMA fills them with zeros and their stores of o and lse are skipped.
#include "flash_pipeline.cuh"

namespace nxdt {
namespace fwd {

using namespace hopper;

constexpr int BM = 128;  // q rows per CTA: two consumer warpgroups of 64
constexpr int BN = 128;  // kv rows per tile
// (BM and BN are BLOCK_Q and FWD_BLOCK_KV in tests/test_torch_flash_attention.py)
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Smem {
  bf16 q[D / 64][BM * 64];  // 128B-swizzled column halves, 1024-byte aligned
  bf16 k[STAGES][D / 64][BN * 64];
  bf16 v[STAGES][D / 64][BN * 64];
  int kvm[STAGES][BN];  // key padding and key segments of a masked tile
  int segk[STAGES][BN];
  int tile[STAGES];    // kv tile index, -1 ends the walk
  int masked[STAGES];  // 1: the tile needs the per-element mask
  uint64_t q_full, full[STAGES], empty[STAGES];
};

struct Params {
  CUtensorMap tq, tk, tv;
  const int *kvm, *seg;
  bf16* o;
  float* lse;
  int b, sq, skv, nh, nkv, group;
  long long o_sb, o_ss, o_sh;
  float scale_log2;  // d^-1/2 * log2(e)
  int causal, window, q_offset;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

// One warp: load Q, then walk the kv tiles, publishing the live ones.
template <int D>
__device__ __forceinline__ void produce(const Params& p, Smem<D>& sm, int h, int qi, int bi) {
  const int q_lo = qi * BM, q_rows = min(BM, p.sq - q_lo);
  if ((threadIdx.x & 31) == 0) {
    mbar_arrive_expect_tx(&sm.q_full, BM * D * 2);
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf) tma_load_4d(sm.q[hf], &p.tq, &sm.q_full, hf * 64, q_lo, h, bi);
  }
  stream_kv_tiles<BN, STAGES, D>(p, sm, h / p.group, bi, q_lo, q_rows);
}

// One warpgroup: 64 q rows of the tile through every published kv tile.
template <int D>
__device__ __forceinline__ void consume(const Params& p, Smem<D>& sm, int h, int qi, int bi) {
  constexpr int SN = BN / 2, ON = D / 2;  // accumulator floats per thread: S, O
  const int c = threadIdx.x / 128, w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = qi * BM, q_rows = min(BM, p.sq - q_lo);
  const int row0 = c * 64 + w * 16 + g;  // this thread's rows of the tile: row0, row0 + 8
  const int qpos0 = p.q_offset + q_lo + row0, qpos1 = qpos0 + 8;
  int segq0 = 0, segq1 = 0;
  if (p.seg) {
    if (row0 < q_rows) segq0 = p.seg[(long long)bi * p.sq + q_lo + row0];
    if (row0 + 8 < q_rows) segq1 = p.seg[(long long)bi * p.sq + q_lo + row0 + 8];
  }

  float o[ON];
#pragma unroll
  for (int i = 0; i < ON; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  const uint32_t q_base = smem_u32(sm.q[0]);
  mbar_wait(&sm.q_full, 0);

  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(&sm.full[stage], phase);
    const int ki = sm.tile[stage];
    if (ki < 0) break;
    const bool masked = sm.masked[stage] != 0;
    const uint32_t k_base = smem_u32(sm.k[stage][0]), v_base = smem_u32(sm.v[stage][0]);

    float s[SN];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n128(s, desc_kmajor<BM>(q_base, c * 64, kk), desc_kmajor<BN>(k_base, 0, kk),
                    kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // accumulator entry 4j + e: row row0 + 8 (e >> 1), column 8j + 2t + (e & 1)
#pragma unroll
    for (int i = 0; i < SN; ++i) s[i] *= p.scale_log2;
    if (masked) {
      const int kv0 = ki * BN;
      const bool kvm = p.kvm != nullptr, seg = p.seg != nullptr;
#pragma unroll
      for (int i = 0; i < SN; ++i) {
        const int col = (i >> 2) * 8 + t * 2 + (i & 1), r = (i >> 1) & 1;
        const int kv = kv0 + col;
        const bool ok = kv < p.skv && pos_visible(r ? qpos1 : qpos0, kv, p.causal, p.window) &&
                        (!kvm || sm.kvm[stage][col] > 0) &&
                        (!seg || sm.segk[stage][col] == (r ? segq1 : segq0));
        if (!ok) s[i] = NEG_INF;
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < SN; ++i) {
      if ((i >> 1) & 1)
        mx1 = fmaxf(mx1, s[i]);
      else
        mx0 = fmaxf(mx0, s[i]);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2_approx(m0 - mn0), a1 = exp2_approx(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int i = 0; i < SN; ++i) {
      if ((i >> 1) & 1) {
        s[i] = exp2_approx(s[i] - m1);
        ls1 += s[i];
      } else {
        s[i] = exp2_approx(s[i] - m0);
        ls0 += s[i];
      }
    }
    l0 = l0 * a0 + ls0;
    l1 = l1 * a1 + ls1;
#pragma unroll
    for (int i = 0; i < ON; ++i) o[i] *= ((i >> 1) & 1) ? a1 : a0;

    // p (unnormalized) in bf16 as wgmma's register A operand, one k16 slice of
    // kv columns per 8 accumulator entries
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    fence_regs(o);  // the rescaling of o stays before the fence
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      if constexpr (D == 128)
        wgmma_rs_n128(o, pa[kk], desc_mnmajor<BN>(v_base, kk));
      else
        wgmma_rs_n64(o, pa[kk], desc_mnmajor<BN>(v_base, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  float* lse = p.lse + ((long long)bi * p.nh + h) * p.sq + q_lo;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= q_rows) continue;  // past sq (ragged last tile)
    const float m = r ? m1 : m0, l = r ? l1 : l0;
    // a row with no visible key keeps m = NEG_INF: output 0, lse NEG_INF
    const bool vis = m > NEG_INF / 2;
    const float inv = vis ? 1.f / l : 0.f;
    bf16* orow = p.o + bi * p.o_sb + h * p.o_sh + (long long)(q_lo + row) * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + j * 8 + t * 2) =
          pack_bf16(o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    if (t == 0) lse[row] = vis ? (m + log2f(l)) * LN2 : NEG_INF;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_fwd_kernel(__grid_constant__ const Params p) {
  extern __shared__ unsigned char smem_raw[];
  // align the tiles to 1024 bytes, offsetting the shared array itself so
  // that the compiler still sees shared (not generic) addresses
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  const int h = blockIdx.x, qi = gridDim.y - 1 - blockIdx.y, bi = blockIdx.z;
  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= 256) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 288) produce<D>(p, sm, h, qi, bi);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<D>(p, sm, h, qi, bi);
  }
}

template <int D>
static int launch(Params& p, const void* q, const void* k, const void* v, const long long* st,
                  cudaStream_t stream) {
  int err = make_tmap(&p.tq, q, p.b, p.sq, p.nh, D, st[0], st[1], st[2], BM);
  if (!err) err = make_tmap(&p.tk, k, p.b, p.skv, p.nkv, D, st[3], st[4], st[5], BN);
  if (!err) err = make_tmap(&p.tv, v, p.b, p.skv, p.nkv, D, st[6], st[7], st[8], BN);
  if (err) return err;
  const size_t smem = sizeof(Smem<D>) + 1024;  // + room to align the tiles to 1024 bytes
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_fwd_kernel<D><<<dim3(p.nh, (p.sq + BM - 1) / BM, p.b), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace fwd
}  // namespace nxdt

extern "C" int nxdt_flash_fwd(const void* q, const void* k, const void* v, const void* kvm,
                              const void* seg, void* o, void* lse, int b, int sq, int skv,
                              int nh, int nkv, int d, long long q_sb, long long q_ss,
                              long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                              long long o_ss, long long o_sh, float scale, int causal,
                              int window, int q_offset, void* stream) {
  using namespace nxdt;
  fwd::Params p;
  p.kvm = static_cast<const int*>(kvm);
  p.seg = static_cast<const int*>(seg);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.b = b; p.sq = sq; p.skv = skv; p.nh = nh; p.nkv = nkv; p.group = nh / nkv;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale_log2 = scale * hopper::LOG2E;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) return fwd::launch<128>(p, q, k, v, st, s);
  if (d == 64) return fwd::launch<64>(p, q, k, v, st, s);
  return (int)cudaErrorInvalidValue;
}
