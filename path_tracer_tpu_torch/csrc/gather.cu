// P0 gather_rows: out[r, :] = table[idx[r], :], the row gather of BVH-node
// and primitive rows that K1 (trace_step) and K7 (closest_hit) issue once
// per traversal step.
//
// Replaces the probe path_tracer_tpu/tools/bench_gather.py
// pallas_formulations (:105-145, the repo's only pl.pallas_call at :119)
// and the XLA gathers it is held against (:1-104).  Its one-hot MXU and
// Mosaic variants are TPU workarounds with no counterpart here.
//
// One thread per output float4 when the row width is a multiple of 4 (the
// 80-, 96- and 184-float rows are), else per output float: neighbouring
// threads copy neighbouring 16-byte pieces of one row, so both the reads
// of a row and the writes of the output are coalesced, and a row index is
// read by the W/4 threads of its row (one cached load).  An index outside
// [0, B) is clamped, as JAX's gather does.
//
// Bound: bytes.  Each output row is read once from the table and written
// once: R x W x 4 x 2 bytes (plus the indices) over 3.35 TB/s.  A small
// table stays in the 50 MB L2, so a gather can beat that bound's HBM rate.
#include <cuda_runtime.h>

template <class T>
__global__ void gather_rows_kernel(const T* __restrict__ table, int B,
                                   int w, const int* __restrict__ idx,
                                   long long R, T* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= R * w) return;
  const long long r = t / w;
  const int c = (int)(t - r * w);
  int src = idx[r];
  src = src < 0 ? 0 : (src >= B ? B - 1 : src);
  out[t] = table[(long long)src * w + c];
}

// table (B, W) f32, idx (R,) int32 -> out (R, W) f32, all contiguous.
extern "C" int ptt_gather_rows(const float* table, int B, int W,
                               const int* idx, long long R, float* out,
                               void* stream) {
  if (R == 0 || W == 0) return 0;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const int block = 256;
  const bool vec = W % 4 == 0 && ((size_t)table % 16) == 0 &&
                   ((size_t)out % 16) == 0;
  const int w = vec ? W / 4 : W;
  const long long grid = (R * w + block - 1) / block;
  if (vec) {
    gather_rows_kernel<float4><<<(unsigned)grid, block, 0,
                                 (cudaStream_t)stream>>>(
        (const float4*)table, B, w, idx, R, (float4*)out);
  } else {
    gather_rows_kernel<float><<<(unsigned)grid, block, 0,
                                (cudaStream_t)stream>>>(table, B, w, idx, R,
                                                         out);
  }
  return (int)cudaGetLastError();
}
