// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu,
// flash_dkv.cu).
//
// Layout contract: q/o are [b, sq, nh, d] and k/v [b, skv, nkv, d] (the model's
// layout), read through element strides with the head dim contiguous; lse and
// delta are plain fp32 [b, nh, sq]; d is 64 or 128.  Masked scores are set to
// NEG_INF (-1e30) exactly as the TPU kernels do; a row with no visible key
// yields o = 0 and lse = NEG_INF.  The 64 x 64 tiles (BQ, BKV) and the
// cp.async / ldmatrix / mma.sync helpers below serve the dq kernel; the
// forward and dk/dv kernels choose their own tiles (hopper.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nxdt {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;
constexpr int BKV = 64;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c (16x8 fp32) += a (16x16 bf16, row-major fragment) * b (16x8 bf16, col-major
// fragment).  Fragment ownership (PTX ISA, mma.m16n8k16): with g = lane / 4 and
// t = lane % 4, a = {A[g][2t..], A[g+8][2t..], A[g][2t+8..], A[g+8][2t+8..]},
// b = {B[2t..][g], B[2t+8..][g]}, c = {C[g][2t], C[g][2t+1], C[g+8][2t],
// C[g+8][2t+1]}.
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy a [ROWS, D] bf16 tile (global row stride `stride` elements) into shared
// memory with row pitch LD, 16 bytes per thread and step.
template <int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long stride,
                                          int tid) {
  constexpr int VEC = D / 8;
  for (int i = tid; i < ROWS * VEC; i += NT) {
    const int r = i / VEC, c = (i % VEC) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + r * stride + c);
  }
}

// Asynchronous 16-byte global -> shared copies (cp.async), one commit group per
// tile, so the next tile's load overlaps this tile's math.
template <int D, int LD, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, long long stride,
                                                int tid) {
  constexpr int VEC = D / 8;
  for (int i = tid; i < ROWS * VEC; i += NT) {
    const int r = i / VEC, c = (i % VEC) * 8;
    const uint32_t saddr = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * LD + c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr),
                 "l"(src + r * stride + c));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory (ldmatrix); lane l gives the
// address of row l % 8 of matrix l / 8 and receives {M[g][2t], M[g][2t+1]} of
// each matrix i in r[i] (transposed with .trans: {M[2t][g], M[2t+1][g]}).
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* addr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const bf16* addr) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 x 32 tile of A[rb:rb+16, :] @ B[cb:cb+32, :]^T for one warp, both operands
// bf16 in shared memory with pitch LD (fragments by ldmatrix); fp32
// accumulation on the tensor cores.
template <int D, int LD>
__device__ __forceinline__ void warp_tile_abt(float c[4][4], const bf16* A, const bf16* B,
                                              int rb, int cb, int lane) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
  const int r8 = lane & 7, hi8 = ((lane >> 3) & 1) * 8, q8 = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, A + (rb + r8 + hi8) * LD + kk * 16 + q8);
#pragma unroll
    for (int nt = 0; nt < 4; nt += 2) {
      uint32_t b[4];  // k halves of n-tiles nt and nt + 1
      ldmatrix_x4(b, B + (cb + nt * 8 + r8 + q8) * LD + kk * 16 + hi8);
      mma16816(c[nt], a, b[0], b[1]);
      mma16816(c[nt + 1], a, b[2], b[3]);
    }
  }
}

// The TPU kernels' `_visible` rule on 64 x 64 tiles: a kv tile that no query of
// the q tile may see is never computed.
__device__ __forceinline__ bool tile_visible(int qi, int ki, int causal, int window,
                                             int q_offset) {
  const int q_lo = qi * BQ + q_offset, q_hi = q_lo + BQ - 1;
  const int kv_lo = ki * BKV, kv_hi = kv_lo + BKV - 1;
  bool vis = true;
  if (causal) vis = vis && (kv_lo <= q_hi);
  if (window >= 0) vis = vis && (kv_hi > q_lo - window);
  return vis;
}

__device__ __forceinline__ bool pos_visible(int qpos, int kpos, int causal, int window) {
  bool ok = true;
  if (causal) ok = ok && (kpos <= qpos);
  if (window >= 0) ok = ok && (kpos > qpos - window);
  return ok;
}

}  // namespace nxdt
