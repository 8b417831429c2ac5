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
// [0, B) is clamped, as JAX's clip-mode gather does.
//
// Bound: bytes, counted as for every kernel of the port: the table and the
// indices read once, the rows written once, (B x W + R + R x W) x 4 bytes
// over 3.35 TB/s (P0's (512, 80) x 16,384 rows: 0.0016 ms).  A launch also
// pays a floor, an empty kernel on the same grid (ptt_gather_rows_floor
// below).  On an H100 (80GB HBM3, 700 W), in a CUDA graph, that floor is
// about half of P0's time and the rest about its bound, and every design
// measured against this one lost or tied (PERF.md): several pieces a
// thread on one wave of blocks, a warp per 8 rows sharing their indices by
// shuffles, bulk asynchronous copies through shared memory, streaming
// stores, 32-bit index arithmetic, blocks of 128 or 512 threads.
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

__global__ void gather_rows_floor_kernel() {}

// table (B, W) f32, idx (R,) int32 -> out (R, W) f32, all contiguous; with
// floor, an empty kernel on the same grid and block in place of the gather
// (its launch floor, for measurement).
static int launch_gather(const float* table, int B, int W, const int* idx,
                         long long R, float* out, void* stream, bool floor) {
  if (R == 0 || W == 0) return 0;
  if (B <= 0) return (int)cudaErrorInvalidValue;
  const int block = 256;
  const bool vec = W % 4 == 0 && ((size_t)table % 16) == 0 &&
                   ((size_t)out % 16) == 0;
  const int w = vec ? W / 4 : W;
  const unsigned grid = (unsigned)((R * w + block - 1) / block);
  cudaStream_t s = (cudaStream_t)stream;
  if (floor) {
    gather_rows_floor_kernel<<<grid, block, 0, s>>>();
  } else if (vec) {
    gather_rows_kernel<float4><<<grid, block, 0, s>>>(
        (const float4*)table, B, w, idx, R, (float4*)out);
  } else {
    gather_rows_kernel<float><<<grid, block, 0, s>>>(table, B, w, idx, R,
                                                     out);
  }
  return (int)cudaGetLastError();
}

extern "C" int ptt_gather_rows(const float* table, int B, int W,
                               const int* idx, long long R, float* out,
                               void* stream) {
  return launch_gather(table, B, W, idx, R, out, stream, false);
}

// The launch floor of ptt_gather_rows on these arguments (ops/gather.py
// gather_rows_floor).
extern "C" int ptt_gather_rows_floor(const float* table, int B, int W,
                                     const int* idx, long long R, float* out,
                                     void* stream) {
  return launch_gather(table, B, W, idx, R, out, stream, true);
}
