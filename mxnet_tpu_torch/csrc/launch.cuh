// Host-side launch helpers shared by the flash-attention sources: the
// dynamic shared-memory opt-in, and the launch of one kernel of a
// (dropout-free, dropout) pair of template instances.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace launcher {

// above 48 KB a block's dynamic shared memory needs an opt-in, once per
// device and kernel (one bit each), so a launch can also be captured in a
// CUDA graph
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes,
                   std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// the pair's kernel for p.dropout_on, NT threads a block, over a grid of
// (tiles of `rows` rows, B * p.H); done holds each kernel's opt-in bits
template <int bytes, int NT, typename Params>
cudaError_t pair(void (*plain)(const Params), void (*drop)(const Params),
                 std::atomic<unsigned long long> (&done)[2], int rows,
                 const Params& p, int B, cudaStream_t stream) {
  void (*kernel)(const Params) = p.dropout_on ? drop : plain;
  cudaError_t err = opt_in(kernel, bytes, done[p.dropout_on ? 1 : 0]);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + rows - 1) / rows, B * p.H);
  kernel<<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace launcher
