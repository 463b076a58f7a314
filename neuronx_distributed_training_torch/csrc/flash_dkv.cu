// Flash-attention dk/dv kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `_dkv_kernel` (launched by `_bwd_pallas`) in
// neuronx_distributed_training_tpu/ops/flash_attention.py: per kv head,
// dv = sum p^T do and dk = sum ds^T q over the GQA group and the visible q
// tiles, with p = exp(s - lse) (0 on rows whose lse is NEG_INF) and
// ds = p * (do v^T - delta) * scale; delta = rowsum(do * o) (minus the lse
// cotangent in the lse variant) comes in precomputed, as in the TPU code.
//
// Precision, as on the TPU: s and dp take bf16 operands, whose products are
// exact in fp32, with fp32 accumulation.  p and ds stay fp32 operands of
// p^T do and ds^T q (rounding ds to bf16 biases the gradients): each fp32
// element is split exactly into three bf16 parts, hi + mid + lo, and each
// product is the fp32 sum of three bf16 products on the tensor cores.
//
// Bound on the card: per visible (query, key) pair the function needs 4d
// operations for s and dp plus 2 x 3 x 2d for the split products (16d); at the
// main-path shape (b=1, nh=32, nkv=8, s=8192, d=128, causal) ~2.2 TFLOP per
// call against ~0.2 GB of traffic, so it is bound by tensor-core operations.
// This kernel does 18d (s is computed twice, see "Two walks").
//
// Design (warp-specialised, one CTA per 128-row kv tile of one kv head):
// - Roles.  Warpgroups 0 and 1 are consumers, each owning 64 kv rows (wgmma's
//   M); warpgroup 2 is the producer, of which one warp works (setmaxnreg
//   40 / 232 in one if/else by role).  K and V are loaded once by TMA.
// - The q-side ring.  For each (GQA head, 64-row q tile) the producer streams
//   Q and dO (TMA, 128B swizzle) and lse, delta and the q segment ids (1-D
//   bulk copies) through a 2-stage ring of mbarriers; both consumers share
//   every stage.  Each CTA owns its dK / dV tile, so nothing needs atomics.
// - Transposed products.  S^T = K Q^T and dP^T = V dO^T run with kv rows as
//   M (wgmma m64n64k16, both operands K-major in shared memory), so P^T and
//   dS^T come out with kv rows as M: the register A layout of dV += P^T dO
//   and dK += dS^T Q.  No shared 64 x 64 fp32 tile is written or re-read
//   transposed by other warps.
// - Split products.  Each fp32 element is split once, in registers, into
//   three bf16 parts, which go to wgmma with A from registers (m64n{d}k16);
//   dO and Q are MN-major as B (transpose bit set).  A slice is split while
//   the previous slice's products run.
// - Two walks.  Registers decide the design.  Holding dK and dV (128 floats
//   a thread at d = 128) beside S^T, dP^T and the split parts made ptxas
//   serialise the wgmmas ("insufficient register resources") and spill,
//   whatever the setmaxnreg budget.  So the producer walks the q tiles
//   twice: the first walk accumulates dV (needs S^T only), the second dK
//   (S^T and dP^T, issued together); one 64 x d accumulator is live.  p, and
//   then ds, wait in a thread-private shared-memory stash (32 floats a
//   thread, written and read back by the same thread) from which the split
//   products read them a k16 slice at a time.  The cost is s computed twice.
// - Masks in the transposed layout: rows are keys (padding, key segments,
//   keys past skv), columns queries (q segment ids, lse = NEG_INF).  The
//   producer skips tiles by the TPU kernel's rules (`_visible`, an
//   all-padding kv tile gives dk = dv = 0, segk_min <= max segq) and flags the
//   live tiles that need the per-element mask.
//
// Where the trouble lies:
// - Tensor maps for strided views (v is a view of the fused QKV projection)
//   and the driver's cuTensorMapEncodeTiled lookup: see flash_fwd.cu and
//   hopper.cuh; the same 4-D maps (d, s, h, b) serve here.
// - Producer and consumers must walk the same tiles: the producer alone
//   decides, and publishes each live (q tile, head, walk) and its mask flag
//   in the stage; q tile -1 ends the walks.
// - Registers: see "Two walks"; fully unrolled loops keep every array index
//   a constant.
#include "flash_pipeline.cuh"

namespace nxdt {
namespace dkv {

using namespace hopper;

constexpr int BN = 128;  // kv rows per CTA: two consumer warpgroups of 64
constexpr int BM = 64;   // q rows per streamed tile
constexpr int STAGES = 2;
constexpr int THREADS = 384;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

template <int D>
struct Smem {
  bf16 k[D / 64][BN * 64];  // 128B-swizzled column halves, 1024-byte aligned
  bf16 v[D / 64][BN * 64];
  bf16 q[STAGES][D / 64][BM * 64];
  bf16 dout[STAGES][D / 64][BM * 64];
  float lse[STAGES][BM];
  float delta[STAGES][BM];
  int segq[STAGES][BM];
  float stash[32][256];  // p, then ds, of the current tile: [entry][consumer thread]
  int qtile[STAGES];  // q tile index, -1 ends the walk
  int pass[STAGES];  // 0: the tile feeds dv, 1: dk
  int masked[STAGES];
  uint64_t kv_full, full[STAGES], empty[STAGES];
};

struct Params {
  CUtensorMap tq, tk, tv, tdo;
  const float *lse, *delta;
  const int *kvm, *seg;
  bf16 *dk, *dv;
  int b, sq, skv, nh, nkv, group;
  long long dk_sb, dk_ss, dk_sh;  // dv shares dk's strides
  float scale, scale_log2;
  int causal, window, q_offset;
};

// One warp: load K and V, then walk the (GQA head, q tile) pairs, publishing
// the live ones.
template <int D>
__device__ __forceinline__ void produce(const Params& p, Smem<D>& sm, int kh, int ki, int bi) {
  const int lane = threadIdx.x & 31;
  const int kv_lo = ki * BN, kv_n = min(BN, p.skv - kv_lo), kv_hi = kv_lo + kv_n - 1;
  if (lane == 0) {
    mbar_arrive_expect_tx(&sm.kv_full, 2 * BN * D * 2);
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf) {
      tma_load_4d(sm.k[hf], &p.tk, &sm.kv_full, hf * 64, kv_lo, kh, bi);
      tma_load_4d(sm.v[hf], &p.tv, &sm.kv_full, hf * 64, kv_lo, kh, bi);
    }
  }
  bool any_key = true, all_keys = true;
  if (p.kvm) {
    bool any = false, all = true;
    for (int c = lane; c < kv_n; c += 32) {
      const bool on = p.kvm[(long long)bi * p.skv + kv_lo + c] > 0;
      any = any || on;
      all = all && on;
    }
    any_key = __any_sync(0xffffffff, any);
    all_keys = __all_sync(0xffffffff, all);
  }
  int segk_min = INT_MAX, segk_max = INT_MIN;
  if (p.seg) {
    for (int c = lane; c < kv_n; c += 32) {
      const int s = p.seg[(long long)bi * p.skv + kv_lo + c];
      segk_min = min(segk_min, s);
      segk_max = max(segk_max, s);
    }
    warp_minmax(segk_min, segk_max);
  }
  const int nqb = p.sq / BM;
  int stage = 0;
  uint32_t phase = 0;
  // two walks, the first for dv and the second for dk; an all-padding kv
  // tile publishes nothing: dk = dv = 0
  for (int pass = 0; any_key && pass < 2; ++pass)
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = kh * p.group + gi;
    for (int qi = 0; qi < nqb; ++qi) {
      const int qpos_lo = p.q_offset + qi * BM, qpos_hi = qpos_lo + BM - 1;
      if (p.causal && kv_lo > qpos_hi) continue;
      if (p.window >= 0 && kv_hi <= qpos_lo - p.window) continue;
      bool whole = kv_n == BN && all_keys && (!p.causal || kv_hi <= qpos_lo) &&
                   (p.window < 0 || kv_lo > qpos_hi - p.window);
      if (p.seg) {
        int mn = INT_MAX, mx = INT_MIN;
        for (int r = lane; r < BM; r += 32) {
          const int s = p.seg[(long long)bi * p.sq + qi * BM + r];
          mn = min(mn, s);
          mx = max(mx, s);
        }
        warp_minmax(mn, mx);
        if (segk_min > mx) continue;  // the kv tile is ahead of every query segment
        whole = whole && mn == mx && segk_min == segk_max && mn == segk_min;
      }
      mbar_wait(&sm.empty[stage], phase ^ 1);
      if (lane == 0) {
        sm.qtile[stage] = qi;
        sm.pass[stage] = pass;
        sm.masked[stage] = !whole;
        mbar_arrive_expect_tx(&sm.full[stage],
                              2 * BM * D * 2 + 2 * BM * 4 + (p.seg ? BM * 4 : 0));
#pragma unroll
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(sm.q[stage][hf], &p.tq, &sm.full[stage], hf * 64, qi * BM, h, bi);
          tma_load_4d(sm.dout[stage][hf], &p.tdo, &sm.full[stage], hf * 64, qi * BM, h, bi);
        }
        const long long row = ((long long)bi * p.nh + h) * p.sq + qi * BM;
        bulk_load(sm.lse[stage], p.lse + row, BM * 4, &sm.full[stage]);
        bulk_load(sm.delta[stage], p.delta + row, BM * 4, &sm.full[stage]);
        if (p.seg)
          bulk_load(sm.segq[stage], p.seg + (long long)bi * p.sq + qi * BM, BM * 4,
                    &sm.full[stage]);
      }
      __syncwarp();
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  mbar_wait(&sm.empty[stage], phase ^ 1);
  if (lane == 0) {
    sm.qtile[stage] = -1;
    mbar_arrive(&sm.full[stage]);
  }
}

// rows kv0 and kv1 of this thread of a 64 x D accumulator, to bf16 at `out`
template <int D>
__device__ __forceinline__ void store_rows(const Params& p, bf16* out, const float (&acc)[D / 2],
                                           int kv0, int kv1, int kh, int bi) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kv = r ? kv1 : kv0;
    if (kv >= p.skv) continue;
    bf16* row = out + bi * p.dk_sb + kh * p.dk_sh + (long long)kv * p.dk_ss + t * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + j * 8) =
          pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// One warpgroup: dv, then dk, of 64 kv rows over every published q tile (the
// producer walks the q tiles twice), so one 64 x d accumulator is live.
template <int D>
__device__ __forceinline__ void consume(const Params& p, Smem<D>& sm, int kh, int ki, int bi) {
  const int c = threadIdx.x / 128, w = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = c * 64 + w * 16 + g;  // this thread's kv rows of the tile: r0, r0 + 8
  const int kv0 = ki * BN + r0, kv1 = kv0 + 8;
  // the keys of these rows: in range, not padding, and their segments
  bool key0 = kv0 < p.skv, key1 = kv1 < p.skv;
  if (p.kvm) {
    key0 = key0 && p.kvm[(long long)bi * p.skv + kv0] > 0;
    key1 = key1 && p.kvm[(long long)bi * p.skv + kv1] > 0;
  }
  int segk0 = 0, segk1 = 0;
  if (p.seg) {
    if (kv0 < p.skv) segk0 = p.seg[(long long)bi * p.skv + kv0];
    if (kv1 < p.skv) segk1 = p.seg[(long long)bi * p.skv + kv1];
  }

  float acc[D / 2];  // dv in the first walk, dk in the second
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  int pass = 0;
  float st[32], dpt[32];  // S^T and dP^T of a tile
  float* stash = &sm.stash[0][threadIdx.x];
  const auto stashed = [stash](int i) { return stash[i * 256]; };  // entry i of this thread
  const uint32_t k_base = smem_u32(sm.k[0]), v_base = smem_u32(sm.v[0]);
  mbar_wait(&sm.kv_full, 0);

  int stage = 0;
  uint32_t phase = 0;
  while (true) {
    mbar_wait(&sm.full[stage], phase);
    const int qi = sm.qtile[stage];
    if (qi < 0) break;
    if (pass == 0 && sm.pass[stage] == 1) {  // dv is complete
      store_rows<D>(p, p.dv, acc, kv0, kv1, kh, bi);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      pass = 1;
    }
    const bool masked = sm.masked[stage] != 0;
    const uint32_t q_base = smem_u32(sm.q[stage][0]), do_base = smem_u32(sm.dout[stage][0]);
    // K's and V's descriptors are the same in every iteration; recomputing
    // them (a few integer operations) is cheaper than holding 32 registers
    uint32_t kb = k_base, vb = v_base;
    asm volatile("" : "+r"(kb), "+r"(vb));

    // S^T = K Q^T (and, for dk, dP^T = V dO^T): 64 kv rows x 64 q columns;
    // entry 4j + e is kv row r0 + 8 (e >> 1), q column 8j + 2t + (e & 1).
    // p, then ds, go to a thread-private stash in shared memory, from which
    // the split products read them a k16 slice at a time.
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);  // the zeroing stays before the fence
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(st, desc_kmajor<BN>(kb, c * 64, kk), desc_kmajor<BM>(q_base, 0, kk), 1);
    wgmma_commit();
    if (pass) {
      wgmma_fence();  // dP^T's registers pass through the branch
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, desc_kmajor<BN>(vb, c * 64, kk), desc_kmajor<BM>(do_base, 0, kk), 1);
      wgmma_commit();
      wgmma_wait<1>();  // S^T is done; dP^T runs on while p is computed
    } else {
      wgmma_wait<0>();
    }
    fence_regs(st);
    // p = exp(s - lse), 0 where lse is NEG_INF; masked tiles first zero the
    // pairs no query may see (keys past skv or padding, outside the causal
    // or window band, or in another segment)
    const int qpos0 = p.q_offset + qi * BM;
    if (masked) {
      const bool seg = p.seg != nullptr;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = (i >> 2) * 8 + t * 2 + (i & 1), r = (i >> 1) & 1;
        const bool ok = (r ? key1 : key0) &&
                        pos_visible(qpos0 + col, r ? kv1 : kv0, p.causal, p.window) &&
                        (!seg || sm.segq[stage][col] == (r ? segk1 : segk0));
        st[i] = ok ? st[i] * p.scale_log2 : NEG_INF;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 32; ++i) st[i] *= p.scale_log2;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float lse = sm.lse[stage][(i >> 2) * 8 + t * 2 + (i & 1)];
      st[i] = lse > NEG_INF / 2 ? exp2_approx(st[i] - lse * LOG2E) : 0.f;
    }
    if (pass == 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) stash[i * 256] = st[i];
      mma_split<D>(acc, stashed, do_base);  // dv += p^T do
    } else {
      wgmma_wait<0>();
      fence_regs(dpt);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = (i >> 2) * 8 + t * 2 + (i & 1);
        stash[i * 256] = st[i] * (dpt[i] - sm.delta[stage][col]) * p.scale;
      }
      mma_split<D>(acc, stashed, q_base);  // dk += ds^T q
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&sm.empty[stage]);
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (pass == 0) {  // no live tile: dv and dk are zero
    store_rows<D>(p, p.dv, acc, kv0, kv1, kh, bi);
  }
  store_rows<D>(p, p.dk, acc, kv0, kv1, kh, bi);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1) flash_dkv_kernel(__grid_constant__ const Params p) {
  extern __shared__ unsigned char smem_raw[];
  // align the tiles to 1024 bytes, offsetting the shared array itself so
  // that the compiler still sees shared (not generic) addresses
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  // kv tile 0 has the most visible q tiles under causal masking: blockIdx.y
  // walks the kv tiles from the first, every kv head of one tile together
  const int kh = blockIdx.x, ki = blockIdx.y, bi = blockIdx.z;
  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
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
    if (threadIdx.x < 288) produce<D>(p, sm, kh, ki, bi);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<D>(p, sm, kh, ki, bi);
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
  cudaError_t e = cudaFuncSetAttribute(flash_dkv_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  flash_dkv_kernel<D><<<dim3(p.nkv, (p.skv + BN - 1) / BN, p.b), THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace dkv
}  // namespace nxdt

// strides: 12 element strides (batch, seq, head) of q, k, v and dout, in order.
extern "C" int nxdt_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, const void* kvm,
                              const void* seg, void* dk, void* dv, int b, int sq, int skv,
                              int nh, int nkv, int d, const long long* strides, long long dk_sb,
                              long long dk_ss, long long dk_sh, float scale, int causal,
                              int window, int q_offset, void* stream) {
  using namespace nxdt;
  dkv::Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.kvm = static_cast<const int*>(kvm);
  p.seg = static_cast<const int*>(seg);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.b = b; p.sq = sq; p.skv = skv; p.nh = nh; p.nkv = nkv; p.group = nh / nkv;
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.scale = scale;
  p.scale_log2 = scale * hopper::LOG2E;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 128) return dkv::launch<128>(p, q, k, v, dout, strides, s);
  if (d == 64) return dkv::launch<64>(p, q, k, v, dout, strides, s);
  return (int)cudaErrorInvalidValue;
}
