// Shared pieces of the flash-attention kernels (flash_fwd.cu, flash_dq.cu,
// flash_dkv.cu).
//
// Layout contract: q/o are [b, sq, nh, d] and k/v [b, skv, nkv, d] (the model's
// layout), read through element strides with the head dim contiguous; lse and
// delta are plain fp32 [b, nh, sq]; d is 64 or 128.  Masked scores are set to
// NEG_INF (-1e30) exactly as the TPU kernels do; a row with no visible key
// yields o = 0 and lse = NEG_INF.  Each kernel chooses its own tiles; the
// Hopper primitives are in hopper.cuh, the pieces the kernels share in
// flash_pipeline.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace nxdt {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bool pos_visible(int qpos, int kpos, int causal, int window) {
  bool ok = true;
  if (causal) ok = ok && (kpos <= qpos);
  if (window >= 0) ok = ok && (kpos > qpos - window);
  return ok;
}

}  // namespace nxdt
