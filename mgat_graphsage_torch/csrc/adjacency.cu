// Dense per-molecule adjacency from a padded COO edge list, for Hopper (sm_90a).
//
// Replaces: mgat_graphsage_tpu/ops/pallas_adjacency.py::dense_adjacency_pallas
// (_adj_kernel), which builds one-hot [N, E] operands for a group of 8
// molecules in VMEM and contracts them on the MXU.
//
// Computes, for every molecule b:
//     adj[b, dst, src] = min(sum over edges e of edge_mask[b, e], 1)
// with edges[b, 0, e] = src and edges[b, 1, e] = dst.  Duplicate edges sum
// before the clamp; masked (padding) edges point at node 0 and add 0; edges
// whose indices fall outside [0, N) are dropped, as the one-hot contraction
// and the scatter drop them.
//
// Bound on the H100: bytes.  The work is one add per edge; the traffic is
// the B*N*N*4-byte output (1.6 MB at B=64, N=80), against B*E*12 bytes of
// input.  At 3.35 TB/s the output write alone is ~0.5 us, so the kernel sits
// at the launch-latency floor at serving shapes.
//
// Design: one block per molecule, no grouping restriction on B.  The block
// zeroes an N*N f32 tile in shared memory (25.6 KB at N=80; 64 KB at N=128,
// which needs the >48 KB dynamic shared memory opt-in), scatters each edge
// with a shared-memory atomicAdd, clamps, and writes the tile out once with
// consecutive threads on consecutive addresses.  The one-hot operands never
// exist.  For 0/1 masks the sums are small integers, so the result is exact
// and independent of the atomics' order; for fractional masks the order of
// the float additions may change the last ulp before the clamp.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void dense_adjacency_kernel(const int* __restrict__ edges,
                                       const float* __restrict__ edge_mask,
                                       float* __restrict__ out,
                                       int num_edges, int num_nodes) {
  extern __shared__ float tile[];
  const int b = blockIdx.x;
  const int nn = num_nodes * num_nodes;

  for (int i = threadIdx.x; i < nn; i += blockDim.x) tile[i] = 0.0f;
  __syncthreads();

  const int* src = edges + (size_t)b * 2 * num_edges;
  const int* dst = src + num_edges;
  const float* m = edge_mask + (size_t)b * num_edges;
  for (int e = threadIdx.x; e < num_edges; e += blockDim.x) {
    const int s = src[e];
    const int d = dst[e];
    if (s >= 0 && s < num_nodes && d >= 0 && d < num_nodes) {
      atomicAdd(&tile[d * num_nodes + s], m[e]);
    }
  }
  __syncthreads();

  float* o = out + (size_t)b * nn;
  for (int i = threadIdx.x; i < nn; i += blockDim.x) {
    const float v = tile[i];
    o[i] = v > 1.0f ? 1.0f : v;  // min(v, 1), NaN propagates as in the plain version
  }
}

}  // namespace

// edges [B, 2, E] int32, edge_mask [B, E] f32, out [B, N, N] f32; all
// contiguous on the current device.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int dense_adjacency_launch(const void* edges, const void* edge_mask,
                                      void* out, int batch, int num_edges,
                                      int num_nodes, void* stream) {
  if (batch == 0) return 0;
  const size_t smem = (size_t)num_nodes * num_nodes * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_adjacency_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dense_adjacency_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(edges), static_cast<const float*>(edge_mask),
      static_cast<float*>(out), num_edges, num_nodes);
  return (int)cudaGetLastError();
}
