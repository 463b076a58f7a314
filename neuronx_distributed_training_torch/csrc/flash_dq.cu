// Flash-attention dq kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dq_kernel` (launched by `_bwd_pallas`) in
// neuronx_distributed_training_tpu/ops/flash_attention.py: per q head and q
// tile, dq = sum over the visible kv tiles of ds k, with p = exp(s - lse) (0 on
// rows whose lse is NEG_INF) and ds = p * (do v^T - delta) * scale;
// delta = rowsum(do * o) (minus the lse cotangent in the lse variant) comes in
// precomputed, as in the TPU code.
//
// Precision, as on the TPU: s = q k^T and dp = do v^T take bf16 operands,
// whose products are exact in fp32, with fp32 accumulation.  ds stays fp32 in
// its product ds k (rounding ds to bf16 biases dq): each element is split
// exactly into three bf16 parts, hi + mid + lo, and ds k is the fp32 sum of
// three bf16 products on the tensor cores, smallest first.
//
// Bound on the card: per visible (query, key) pair the function needs 4d
// operations for s and dp plus 3 x 2d for the split ds k (10d); at the
// main-path shape (b=1, nh=32, nkv=8, s=8192, d=128, causal) ~1.4 TFLOP per
// call against ~0.2 GB of traffic, so it is bound by tensor-core operations;
// the design feeds wgmma, the only way to Hopper's full tensor-core rate.
//
// Design (warp-specialised, one CTA per 128-row q tile of one q head, the
// structure of flash_fwd.cu):
// - Roles.  Warpgroups 0 and 1 are consumers, each owning 64 q rows (wgmma's
//   M); warpgroup 2 is the producer, of which one warp works and gives its
//   registers to the consumers (setmaxnreg 40 / 232, in one if/else by role).
// - Loads.  The producer loads Q and dO once by TMA (128B swizzle), and the
//   tile's lse, delta and q segment ids by 1-D bulk copies, all on one
//   mbarrier; then it streams K and V tiles of 64 rows through a 3-stage ring
//   ("full" / "empty" mbarriers).  Which kv tiles are live, and which of them
//   need the per-element mask, it alone decides, by the walk it shares with
//   the forward (`stream_kv_tiles`, flash_pipeline.cuh).
// - Products.  S = Q K^T and dP = dO V^T are wgmma m64n64k16 with both
//   operands K-major in shared memory, issued together; p is computed while
//   dP runs.  p = exp2(s * scale * log2 e - lse * log2 e) and
//   ds = p (dp - delta) scale stay in registers, where the accumulator layout
//   is already wgmma's register-A layout.  dQ += dS K is three register-A
//   wgmmas m64n{d}k16 per k16 slice of ds (`mma_split`); the same K tile is
//   their B operand, read MN-major (transpose bit set), as it was read
//   K-major for S.
// - Scheduling.  blockIdx.x is the head and blockIdx.y walks the q tiles from
//   the last (the longest under causal masking) to the first.
//
// Where the trouble lies:
// - Registers.  dQ (64 floats a thread at d = 128) beside S and dP (32 each
//   with 64-row kv tiles) and the parts of two split slices (24) fit the
//   consumers' budget; 128-row kv tiles would hold 192 accumulator floats
//   before the split, where the dk/dv kernel met wgmma serialisation and
//   spills.  Fully unrolled loops keep every accumulator index a constant.
// - Ragged tiles: when sq % 128 == 64 the second consumer's rows lie past sq;
//   TMA fills its Q and dO rows with zeros, the bulk copies bring only the
//   q_rows that exist, and that consumer computes nothing: it only hands the
//   stages back.
// - Tensor maps for strided views (q, k and v are views of the fused QKV
//   projection): the 4-D maps (d, s, h, b) of hopper.cuh, from the wrapper's
//   strides.
#include "flash_pipeline.cuh"

namespace nxdt {
namespace dq {

using namespace hopper;

constexpr int BM = 128;  // q rows per CTA: two consumer warpgroups of 64
constexpr int BN = 64;   // kv rows per tile
// (BM and BN are BLOCK_Q and DQ_BLOCK_KV in tests/test_torch_flash_attention.py)
constexpr int STAGES = 3;
constexpr int THREADS = 384;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

template <int D>
struct Smem {
  bf16 q[D / 64][BM * 64];  // 128B-swizzled column halves, 1024-byte aligned
  bf16 dout[D / 64][BM * 64];
  bf16 k[STAGES][D / 64][BN * 64];
  bf16 v[STAGES][D / 64][BN * 64];
  float lse[BM];
  float delta[BM];
  int segq[BM];
  int kvm[STAGES][BN];  // key padding and key segments of a masked tile
  int segk[STAGES][BN];
  int tile[STAGES];    // kv tile index, -1 ends the walk
  int masked[STAGES];  // 1: the tile needs the per-element mask
  uint64_t q_full, full[STAGES], empty[STAGES];
};

struct Params {
  CUtensorMap tq, tk, tv, tdo;
  const float *lse, *delta;
  const int *kvm, *seg;
  bf16* dq;
  int b, sq, skv, nh, nkv, group;
  long long dq_sb, dq_ss, dq_sh;
  float scale, scale_log2;  // d^-1/2, and d^-1/2 * log2(e)
  int causal, window, q_offset;
};

// One warp: load Q, dO and the tile's rows of lse, delta and segment ids,
// then walk the kv tiles, publishing the live ones.
template <int D>
__device__ __forceinline__ void produce(const Params& p, Smem<D>& sm, int h, int qi, int bi) {
  const int q_lo = qi * BM, q_rows = min(BM, p.sq - q_lo);
  if ((threadIdx.x & 31) == 0) {
    const uint32_t row_bytes = q_rows * 4;  // rows past sq are neither copied nor read
    mbar_arrive_expect_tx(&sm.q_full, 2 * BM * D * 2 + (p.seg ? 3 : 2) * row_bytes);
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf) {
      tma_load_4d(sm.q[hf], &p.tq, &sm.q_full, hf * 64, q_lo, h, bi);
      tma_load_4d(sm.dout[hf], &p.tdo, &sm.q_full, hf * 64, q_lo, h, bi);
    }
    const long long row = ((long long)bi * p.nh + h) * p.sq + q_lo;
    bulk_load(sm.lse, p.lse + row, row_bytes, &sm.q_full);
    bulk_load(sm.delta, p.delta + row, row_bytes, &sm.q_full);
    if (p.seg) bulk_load(sm.segq, p.seg + (long long)bi * p.sq + q_lo, row_bytes, &sm.q_full);
  }
  stream_kv_tiles<BN, STAGES, D>(p, sm, h / p.group, bi, q_lo, q_rows);
}

// One warpgroup: dQ of 64 q rows of the tile over every published kv tile.
template <int D>
__device__ __forceinline__ void consume(const Params& p, Smem<D>& sm, int h, int qi, int bi) {
  constexpr int SN = BN / 2, QN = D / 2;  // accumulator floats per thread: S (and dP), dQ
  const int c = threadIdx.x / 128, w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = qi * BM, q_rows = min(BM, p.sq - q_lo);
  const bool live = c * 64 < q_rows;  // false: every row of this warpgroup lies past sq
  const int row0 = c * 64 + w * 16 + g;  // this thread's rows of the tile: row0, row0 + 8
  const int qpos0 = p.q_offset + q_lo + row0, qpos1 = qpos0 + 8;

  float acc[QN];
#pragma unroll
  for (int i = 0; i < QN; ++i) acc[i] = 0.f;
  mbar_wait(&sm.q_full, 0);
  // per row: -lse log2(e), or NEG_INF where lse is NEG_INF (a row with no
  // visible key), so that p = exp2(x - lse log2(e)) is 0 there as on the
  // TPU; delta; the query segment
  float nl0 = NEG_INF, nl1 = NEG_INF, dl0 = 0.f, dl1 = 0.f;
  int segq0 = 0, segq1 = 0;
  if (live) {
    const float l0 = sm.lse[row0], l1 = sm.lse[row0 + 8];
    if (l0 > NEG_INF / 2) nl0 = -l0 * LOG2E;
    if (l1 > NEG_INF / 2) nl1 = -l1 * LOG2E;
    dl0 = sm.delta[row0];
    dl1 = sm.delta[row0 + 8];
    if (p.seg) {
      segq0 = sm.segq[row0];
      segq1 = sm.segq[row0 + 8];
    }
  }
  const uint32_t q_base = smem_u32(sm.q[0]), do_base = smem_u32(sm.dout[0]);

  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(&sm.full[stage], phase);
    const int ki = sm.tile[stage];
    if (ki < 0) break;
    if (live) {
      const bool masked = sm.masked[stage] != 0;
      const uint32_t k_base = smem_u32(sm.k[stage][0]), v_base = smem_u32(sm.v[stage][0]);

      // S = Q K^T and dP = dO V^T: 64 q rows x 64 kv columns; entry 4j + e is
      // row row0 + 8 (e >> 1), column 8j + 2t + (e & 1)
      float s[SN], dp[SN];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(s, desc_kmajor<BM>(q_base, c * 64, kk), desc_kmajor<BN>(k_base, 0, kk),
                     kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dp, desc_kmajor<BM>(do_base, c * 64, kk), desc_kmajor<BN>(v_base, 0, kk),
                     kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // S is done; dP runs on while p is computed
      fence_regs(s);

      // p; masked tiles first set the pairs no query may see to NEG_INF (keys
      // past skv or padding, outside the causal or window band, or in another
      // segment)
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
          s[i] = ok ? s[i] * p.scale_log2 : NEG_INF;
        }
      } else {
#pragma unroll
        for (int i = 0; i < SN; ++i) s[i] *= p.scale_log2;
      }
#pragma unroll
      for (int i = 0; i < SN; ++i) s[i] = exp2_approx(s[i] + (((i >> 1) & 1) ? nl1 : nl0));

      // ds = p (dp - delta) scale, in place of p
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < SN; ++i) s[i] *= (dp[i] - (((i >> 1) & 1) ? dl1 : dl0)) * p.scale;

      // dQ += dS K, dS exact in fp32 as three bf16 parts; K MN-major as B
      mma_split<D>(acc, [&s](int i) { return s[i]; }, k_base);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= q_rows) continue;
    bf16* out = p.dq + bi * p.dq_sb + h * p.dq_sh + (long long)(q_lo + row) * p.dq_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + j * 8 + t * 2) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_dq_kernel(__grid_constant__ const Params p) {
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
static int launch(Params& p, const void* q, const void* k, const void* v, const void* dout,
                  const long long* st, cudaStream_t stream) {
  int err = make_tmap(&p.tq, q, p.b, p.sq, p.nh, D, st[0], st[1], st[2], BM);
  if (!err) err = make_tmap(&p.tk, k, p.b, p.skv, p.nkv, D, st[3], st[4], st[5], BN);
  if (!err) err = make_tmap(&p.tv, v, p.b, p.skv, p.nkv, D, st[6], st[7], st[8], BN);
  if (!err) err = make_tmap(&p.tdo, dout, p.b, p.sq, p.nh, D, st[9], st[10], st[11], BM);
  if (err) return err;
  const size_t smem = sizeof(Smem<D>) + 1024;  // + room to align the tiles to 1024 bytes
  cudaError_t e = cudaFuncSetAttribute(flash_dq_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_dq_kernel<D><<<dim3(p.nh, (p.sq + BM - 1) / BM, p.b), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace dq
}  // namespace nxdt

// strides: 12 element strides (batch, seq, head) of q, k, v and dout, in order.
extern "C" int nxdt_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* kvm,
                             const void* seg, void* dq_out, int b, int sq, int skv, int nh,
                             int nkv, int d, const long long* strides, long long dq_sb,
                             long long dq_ss, long long dq_sh, float scale, int causal,
                             int window, int q_offset, void* stream) {
  using namespace nxdt;
  dq::Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kvm = static_cast<const int*>(kvm);
  p.seg = static_cast<const int*>(seg);
  p.dq = static_cast<bf16*>(dq_out);
  p.b = b; p.sq = sq; p.skv = skv; p.nh = nh; p.nkv = nkv; p.group = nh / nkv;
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  p.scale = scale;
  p.scale_log2 = scale * hopper::LOG2E;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) return dq::launch<128>(p, q, k, v, dout, strides, s);
  if (d == 64) return dq::launch<64>(p, q, k, v, dout, strides, s);
  return (int)cudaErrorInvalidValue;
}
