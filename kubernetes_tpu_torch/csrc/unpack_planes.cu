// K9 unpack_planes: packed bool planes back to dense bools on the card.
//
// Replaces the jitted bitplane.unpack of the JAX package's api/delta.py:922
// DeltaEncoder._packed_put: the encoder packs a wide bool field on the host
// (ops/bitplane.py np_pack_lastaxis: little-endian bits in little-endian
// uint32 words), copies the words to the card and this kernel writes the
// dense plane, out[r, j] = bit (j & 31) of words[r, j >> 5], j < n.
//
// One thread per output byte, so the stores coalesce; a warp's 32 bytes
// read one word.  Bound on an H100: the bytes, rows x (4 W + n), at
// 3.35 TB/s.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

__global__ void __launch_bounds__(NT) unpack_planes_kernel(const uint32_t* __restrict__ words,  // [rows, W]
                                                           int64_t rows, int W, int n,
                                                           uint8_t* __restrict__ out) {  // [rows, n]
  const int64_t i = (int64_t)blockIdx.x * NT + threadIdx.x;
  if (i >= rows * n) return;
  const int64_t r = i / n;
  const int j = (int)(i % n);
  out[i] = (uint8_t)((words[r * W + (j >> 5)] >> (j & 31)) & 1u);
}

}  // namespace

extern "C" int ktt_unpack_planes(const void* words, void* out, long long rows, int W, int n,
                                 void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (rows < 0 || n < 0 || W != (n + 31) / 32) return (int)cudaErrorInvalidValue;
  const int64_t work = (int64_t)rows * n;
  if (work == 0) return (int)cudaGetLastError();
  unpack_planes_kernel<<<(unsigned)((work + NT - 1) / NT), NT, 0, st>>>(
      static_cast<const uint32_t*>(words), rows, W, n, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
