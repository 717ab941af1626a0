// The reference's bfloat16 compute (ALSConfig.compute_dtype="bfloat16"):
// the factor rows a kernel gathers, and some of its weights, are rounded
// to bfloat16 where the reference casts them with astype, and every
// product of two such values is formed exactly in float32 and summed in
// float32 (preferred_element_type=float32). The kernels keep float32
// inputs and round each value as they load it, round-to-nearest-even as
// astype and Tensor.to(torch.bfloat16) round.
#pragma once

#include <cuda_bf16.h>

// x rounded to the nearest bfloat16 (ties to even), widened back to float.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// x in the compute type: rounded when BF16, else unchanged.
template <bool BF16>
__device__ __forceinline__ float in_cdt(float x) {
  if constexpr (BF16) {
    return round_bf16(x);
  } else {
    return x;
  }
}
