// Slab staging for the check-node kernels that hold a (check, frame) in a
// warp (cn_ems.cu, cn_qspa.cu).
//
// A block takes fb = 2^lg_fb consecutive frames b0 .. b0 + fb - 1 of one
// (check, slot) row block [q, B] of a batch-last tensor. Its [q, fb] slab
// moves along b, so global loads and stores run along the frame axis and
// use each 32-byte sector whole. The block's threads move S entries each
// (S * blockDim.x = q * fb), entry e = threadIdx.x + s * blockDim.x.
// slab_fetch reads them into registers (zeros past B); slab_put writes
// them to the shared slab (row stride fb + 1) between two barriers;
// slab_store writes the slab out between two barriers.

#pragma once

template <int S>
__device__ __forceinline__ void slab_fetch(float (&v)[S], const float* src, int B, int b0,
                                           int lg_fb) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = threadIdx.x + s * blockDim.x;
    const int a = e >> lg_fb, b = b0 + (e & ((1 << lg_fb) - 1));
    v[s] = b < B ? src[(size_t)a * B + b] : 0.f;
  }
}

template <int S>
__device__ __forceinline__ void slab_put(float* slab, const float (&v)[S], int lg_fb) {
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = threadIdx.x + s * blockDim.x;
    slab[(e >> lg_fb) * ((1 << lg_fb) + 1) + (e & ((1 << lg_fb) - 1))] = v[s];
  }
  __syncthreads();
}

template <int S>
__device__ __forceinline__ void slab_store(const float* slab, float* dst, int B, int b0,
                                           int lg_fb) {
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = threadIdx.x + s * blockDim.x;
    const int a = e >> lg_fb, f = e & ((1 << lg_fb) - 1);
    if (b0 + f < B) dst[(size_t)a * B + b0 + f] = slab[a * ((1 << lg_fb) + 1) + f];
  }
  __syncthreads();
}
