// The card's SM count and the blocks an SM holds of a kernel, for grids
// sized to one wave (class_hoist.cu K4, stitch_planes.cu K17).  The
// runtime's answers are kept (the SM count per device, the occupancy per
// launch site in a static Occupancy beside the launch, asked again only
// when the device, the block size or the dynamic shared memory changes):
// each query costs host time on every call otherwise.  A race between two
// host threads can only make a grid smaller, never a result different.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

namespace ktt {

struct Occupancy {
  int dev = -1;
  int threads = 0;
  size_t smem = 0;
  int per_sm = 0;
};

constexpr int MAX_DEVICES = 64;

// the current device and its SM count
inline cudaError_t device_sms(int* dev, int* nsm) {
  static int cached[MAX_DEVICES] = {};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev < 0 || *dev >= MAX_DEVICES) return cudaDeviceGetAttribute(nsm, cudaDevAttrMultiProcessorCount, *dev);
  if (cached[*dev] == 0) {
    int n = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
    cached[*dev] = n;
  }
  *nsm = cached[*dev];
  return cudaSuccess;
}

template <class Kernel>
cudaError_t blocks_per_sm(Occupancy& memo, Kernel kernel, int dev, int threads, size_t smem, int* per_sm) {
  if (memo.dev != dev || memo.threads != threads || memo.smem != smem) {
    int n = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
    if (err != cudaSuccess) return err;
    memo.dev = dev;
    memo.threads = threads;
    memo.smem = smem;
    memo.per_sm = n > 0 ? n : 1;
  }
  *per_sm = memo.per_sm;
  return cudaSuccess;
}

}  // namespace ktt
