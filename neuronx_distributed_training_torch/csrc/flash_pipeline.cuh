// Pieces the Hopper flash kernels share: the producer's walk over the kv
// tiles of one q tile (forward and dq), and the product of an fp32 operand,
// split exactly into three bf16 parts, on wgmma (dq and dk/dv).
#pragma once

#include <climits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace nxdt {

// x = hi + mid + lo exactly, each part bf16: bf16 keeps 8 significand bits,
// so three parts hold fp32's 24.  A product of such an fp32 operand with a
// bf16 operand is then three exact bf16 products summed in fp32.
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

// acc (64 x D, fp32) += X (64 x 64, fp32) @ Y (64 x D, MN-major tile at
// y_base), one warpgroup.  x(i) is this thread's accumulator-layout entry i
// of X (entry 4j + e: row 8 (e >> 1) of the thread's pair, column 8j + 2t +
// (e & 1)), which is wgmma's register-A layout.  Each element is split
// exactly into three bf16 parts, and each k16 slice takes three register-A
// wgmmas, smallest part first.  The parts of two slices are live at a time: a
// slice is split while the previous one's products run.
template <int D, class X>
__device__ __forceinline__ void mma_split(float (&acc)[D / 2], X x, uint32_t y_base) {
  using namespace hopper;
  uint32_t parts[2][3][4];  // [slice parity][lo, mid, hi][A fragment]
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t(&a)[3][4] = parts[kk & 1];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      split3(x(8 * kk + 2 * j), x(8 * kk + 2 * j + 1), a[2][j], a[1][j], a[0][j]);
    if (kk == 0) fence_regs(acc);
    fence_regs(a);  // the split stays before the fence
    wgmma_fence();
    const uint64_t b = desc_mnmajor<64>(y_base, kk);
#pragma unroll
    for (int part = 0; part < 3; ++part) {  // smallest first
      if constexpr (D == 128)
        wgmma_rs_n128(acc, a[part], b);
      else
        wgmma_rs_n64(acc, a[part], b);
    }
    wgmma_commit();
    if (kk < 3) {
      wgmma_wait<1>();  // the previous slice is done: its parts may be reused
      if (kk > 0) fence_regs(parts[(kk - 1) & 1]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(parts[0]);
  fence_regs(parts[1]);
}

// One warp (all lanes): walk the kv tiles of BN rows that the q rows
// [q_lo, q_lo + q_rows) of batch bi may see, and stream the K and V tiles of
// each live one (kv head kh) through the ring of `sm` by TMA, publishing its
// index and mask flag in the stage; index -1 ends the walk.
//
// The rules are the TPU kernels' (`_visible`, an all-padding kv tile, a kv
// tile ahead of every query segment) on the exact q range:
// - skipped: past the causal diagonal of the last q row (and so is every
//   later tile), behind the window of the first, all keys padding, or its
//   least key segment above the greatest query segment;
// - whole (no per-element mask): BN keys in range, wholly below the causal
//   diagonal of the first q row and inside the window of the last, no key
//   padding, and one segment for every query and key;
// - otherwise flagged; its key padding and key segments are copied into the
//   stage for the per-element mask.
// P supplies kvm, seg, sq, skv, causal, window (-1: none), q_offset and the
// tensor maps tk, tv; SM the ring: k, v, kvm, segk, tile, masked, full, empty.
template <int BN, int STAGES, int D, class P, class SM>
__device__ __forceinline__ void stream_kv_tiles(const P& p, SM& sm, int kh, int bi, int q_lo,
                                                int q_rows) {
  using namespace hopper;
  const int lane = threadIdx.x & 31;
  int segq_min = INT_MAX, segq_max = INT_MIN;
  if (p.seg) {
    for (int r = lane; r < q_rows; r += 32) {
      const int s = p.seg[(long long)bi * p.sq + q_lo + r];
      segq_min = min(segq_min, s);
      segq_max = max(segq_max, s);
    }
    warp_minmax(segq_min, segq_max);
  }
  const int qpos_lo = p.q_offset + q_lo, qpos_hi = qpos_lo + q_rows - 1;
  const int nkb = (p.skv + BN - 1) / BN;
  int stage = 0;
  uint32_t phase = 0;
  for (int ki = 0; ki < nkb; ++ki) {
    const int kv_lo = ki * BN, kv_n = min(BN, p.skv - kv_lo), kv_hi = kv_lo + kv_n - 1;
    if (p.causal && kv_lo > qpos_hi) break;  // and every later tile
    if (p.window >= 0 && kv_hi <= qpos_lo - p.window) continue;
    bool whole = kv_n == BN && (!p.causal || kv_hi <= qpos_lo) &&
                 (p.window < 0 || kv_lo > qpos_hi - p.window);
    if (p.kvm) {
      bool any = false, all = true;
      for (int c = lane; c < kv_n; c += 32) {
        const bool on = p.kvm[(long long)bi * p.skv + kv_lo + c] > 0;
        any = any || on;
        all = all && on;
      }
      if (!__any_sync(0xffffffff, any)) continue;  // all padding
      whole = whole && __all_sync(0xffffffff, all);
    }
    if (p.seg) {
      int mn = INT_MAX, mx = INT_MIN;
      for (int c = lane; c < kv_n; c += 32) {
        const int s = p.seg[(long long)bi * p.skv + kv_lo + c];
        mn = min(mn, s);
        mx = max(mx, s);
      }
      warp_minmax(mn, mx);
      if (mn > segq_max) continue;  // ahead of every query segment
      whole = whole && mn == mx && segq_min == segq_max && mn == segq_min;
    }
    mbar_wait(&sm.empty[stage], phase ^ 1);
    if (!whole) {
      for (int c = lane; c < BN; c += 32) {
        const bool in = c < kv_n;
        if (p.kvm) sm.kvm[stage][c] = in ? p.kvm[(long long)bi * p.skv + kv_lo + c] : 0;
        if (p.seg) sm.segk[stage][c] = in ? p.seg[(long long)bi * p.skv + kv_lo + c] : 0;
      }
    }
    if (lane == 0) {
      sm.tile[stage] = ki;
      sm.masked[stage] = !whole;
    }
    __syncwarp();
    if (lane == 0) {
      mbar_arrive_expect_tx(&sm.full[stage], 2 * BN * D * 2);
#pragma unroll
      for (int hf = 0; hf < D / 64; ++hf) {
        tma_load_4d(sm.k[stage][hf], &p.tk, &sm.full[stage], hf * 64, kv_lo, kh, bi);
        tma_load_4d(sm.v[stage][hf], &p.tv, &sm.full[stage], hf * 64, kv_lo, kh, bi);
      }
    }
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  mbar_wait(&sm.empty[stage], phase ^ 1);
  if (lane == 0) {
    sm.tile[stage] = -1;
    mbar_arrive(&sm.full[stage]);
  }
}

}  // namespace nxdt
