// K9 unpack_planes: packed bool planes back to dense bools on the card.
//
// Replaces the jitted bitplane.unpack of the JAX package's api/delta.py:922
// DeltaEncoder._packed_put: the encoder packs a wide bool field on the host
// (ops/bitplane.py np_pack_lastaxis: little-endian bits in little-endian
// uint32 words), copies the words to the card and this kernel writes the
// dense plane, out[r, j] = bit (j & 31) of words[r, j >> 5], j < n.
//
// Design: a thread per half word, 16 output bytes.  The halves are taken
// in row-major order, so consecutive threads write consecutive bytes of
// the flat output (a row's last word writes n - 32 (W - 1) bytes, the next
// row starts right after) and a warp's stores cover ~512 contiguous bytes.
// The grid's y axis takes batches of rows, so a thread finds its row with
// one 32-bit division of its index inside the batch by 2 W (no 64-bit
// division or modulo, and none per byte).  A thread expands its 16 bits
// into 16 bytes in registers (a nibble times 0x00204081 spreads its 4
// bits to the low bit of 4 bytes) and writes them with one 16-byte store
// where its first byte is 16-aligned (every row when n % 16 == 0, as the
// 80-wide taint planes) and the half is whole; otherwise with single bytes
// up to 4-byte alignment, 4-byte stores (the words shifted into place by a
// funnel shift) and single bytes for the rest.  The ragged last word of a
// row writes only its j < n bytes; a half past n writes nothing.
//
// Bound on an H100: the bytes, rows x (4 W + n), at 3.35 TB/s.
//
// Built by ops/kernels.py with nvcc -gencode arch=compute_90a,code=sm_90a
// -O3 -fmad=false; called through ctypes (plain C interface below).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
// halves a row batch may hold: a batch index fits 32 bits
constexpr int64_t BATCH_HALVES = (int64_t)1 << 30;

// bytes 4i..4i+3 of the 16 a half expands to: bit 4i + k -> byte k's bit 0
__device__ __forceinline__ uint32_t spread(uint32_t x, int i) {
  return (((x >> (4 * i)) & 0xfu) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(NT) unpack_planes_kernel(const uint32_t* __restrict__ words,  // [rows, W]
                                                           int64_t rows, int W, int n, int batch_rows,
                                                           uint8_t* __restrict__ out) {  // [rows, n]
  const uint32_t per_row = 2u * (uint32_t)W;
  const uint32_t i = blockIdx.x * NT + threadIdx.x;
  const uint32_t rl = i / per_row;
  if (rl >= (uint32_t)batch_rows) return;
  const int64_t r = (int64_t)blockIdx.y * batch_rows + rl;
  if (r >= rows) return;
  const uint32_t h = i - rl * per_row;  // the half within its row
  const int j0 = 16 * (int)h;            // its first column
  const int len = min(16, n - j0);
  if (len <= 0) return;  // the upper half of a last word of 16 or fewer columns
  const uint32_t x = words[r * W + (h >> 1)] >> (16 * (h & 1));
  uint32_t v[5] = {spread(x, 0), spread(x, 1), spread(x, 2), spread(x, 3), 0u};
  uint8_t* dst = out + r * n + j0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  if (len == 16 && (a & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    return;
  }
  // single bytes to 4-byte alignment, whole words, single bytes
  const int head = min(len, (int)((4 - (a & 3)) & 3));
  for (int k = 0; k < head; ++k) dst[k] = (uint8_t)((x >> k) & 1u);
  const int m = (len - head) >> 2;
  uint32_t* d = reinterpret_cast<uint32_t*>(dst + head);
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (t < m) d[t] = head ? __funnelshift_r(v[t], v[t + 1], 8 * head) : v[t];
  for (int k = head + 4 * m; k < len; ++k) dst[k] = (uint8_t)((x >> k) & 1u);
}

}  // namespace

extern "C" int ktt_unpack_planes(const void* words, void* out, long long rows, int W, int n,
                                 void* stream) {
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (rows < 0 || n < 0 || W != (n + 31) / 32) return (int)cudaErrorInvalidValue;
  if (rows == 0 || n == 0) return (int)cudaGetLastError();
  const int64_t per_row = 2 * (int64_t)W;
  const int64_t batch = BATCH_HALVES / per_row < rows ? BATCH_HALVES / per_row : rows;  // rows a y-batch
  const int64_t ny = (rows + batch - 1) / batch;
  if (batch < 1 || ny > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((batch * per_row + NT - 1) / NT), (unsigned)ny);
  unpack_planes_kernel<<<grid, NT, 0, st>>>(static_cast<const uint32_t*>(words), rows, W, n, (int)batch,
                                            static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}
