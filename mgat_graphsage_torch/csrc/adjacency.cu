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
// and the scatter drop them.  NaN propagates through the clamp.
//
// Bound on the H100: bytes.  The work is one add per edge; the traffic is
// the B*N*N*4-byte output (1.6 MB at B=64, N=80) and B*E*12 bytes of input:
// 0.53 us at B=64 and 1.06 us at B=128 (N=80, E=176) at 3.35 TB/s, below
// the ~1.9 us floor of back-to-back launches.  So the design keeps the chain
// after the launch short: one load and one barrier, then each warp on its
// own rows to its stores, with no scatter and no tile to zero.
//
// Design: grid (B, G), G row groups per molecule (row_groups below), so that
// a serving batch of 64 still covers the 132 SMs.  A block stages its
// molecule's edges in shared memory once (16-byte loads where E % 4 == 0 and
// the tensors are 16-byte aligned), 12 bytes an edge: the source, the mask,
// and the row the edge adds to (row_key: -1 for an edge that adds nothing).
// Each warp owns kRowsPerWarp consecutive destination rows.  It ballots 32
// edges at a time on "adds to one of my rows" (the next 32 keys already in
// flight) and walks the set bits in ascending e: the row comes from the
// edge's lane by a shuffle, the source and mask by broadcast loads, and the
// lane that owns column src adds mask[e] to that row's register.  No
// scatter and no N x N tile: every cell is one lane's register, summed in
// ascending e, the order in which the plain version sums on the CPU, so the
// result equals it bit for bit for any mask and repeats bit for bit.
// A lane holds 4 columns of each of its warp's rows, a warp pass 128; past
// N = 128 the warp walks the edges once more for each further 128 columns,
// so any N >= 1 is taken.  The lane clamps and stores its columns: one
// 16-byte store a row where rows start 16-byte aligned (N % 4 == 0; lane l
// owns columns 4l .. 4l+3), else 4-byte stores (lane l owns columns
// l + 32j), consecutive lanes on consecutive addresses.  Default cache
// policy: add_self_loops, the attention mask and SAGEConv read the output
// next, from L2.  Where the staged edges would not fit in a block's shared
// memory (E > 19,370), the warps read the edge list from global memory
// (through L1) instead, with the same sums.
//
// Tuned on an H100 with kernel_phases.py's "k1" copies (PERF.md): 2 rows a
// warp beat 1, 4 and 8 at B=64 and B=128; the row groups (1 to 4) moved the
// time by less than 0.1 us, so the launcher keeps kernel 2's rule.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int kRowsPerWarp = 2;        // destination rows a warp walks
constexpr int kMaxWarps = 32;          // warps of a block at most
constexpr int kCols = 128;             // columns of one warp pass (4 a lane)
constexpr size_t kSmemLimit = 232448;  // bytes of shared memory a block may use

// The row an edge adds to, or -1 where an index falls outside [0, N) or the
// mask is 0: adding +-0 leaves every sum that starts at +0 as it was, and the
// padding edges (all at node 0, mask 0) would otherwise make row 0 the
// longest walk of every molecule.
__device__ __forceinline__ int row_key(int s, int d, float m, int n) {
  return ((unsigned)s < (unsigned)n && (unsigned)d < (unsigned)n && m != 0.0f)
             ? d : -1;
}

// Where a block reads its molecule's edges: staged in shared memory, or
// straight from the [2, E] and [E] rows in global memory.
template <bool kStaged>
struct EdgeList {
  const int* src;     // [E]
  const int* key;     // staged: row_key of each edge
  const int* dst;     // global: dst as given
  const float* mask;  // [E]
  int n;

  __device__ int row_of(int e) const {  // the row edge e adds to, or -1
    return kStaged ? key[e] : row_key(src[e], dst[e], mask[e], n);
  }
};

__device__ __forceinline__ float clamp1(float v) {
  return v > 1.0f ? 1.0f : v;  // min(v, 1), NaN propagates as in the plain version
}

// VEC = 4: lane l holds columns c0 + 4l + j; VEC = 1: columns c0 + l + 32j.
template <int VEC, bool kStaged>
__global__ void __launch_bounds__(kMaxWarps * 32)
dense_adjacency_kernel(const int* __restrict__ edges,
                       const float* __restrict__ edge_mask,
                       float* __restrict__ out, int num_edges, int num_nodes,
                       int group_rows, int vec_load) {
  extern __shared__ __align__(16) int smem[];
  const int e_n = num_edges, n = num_nodes;
  const int b = blockIdx.x;
  const int* src_g = edges + (size_t)b * 2 * e_n;
  const float* mask_g = edge_mask + (size_t)b * e_n;
  EdgeList<kStaged> el{src_g, nullptr, src_g + e_n, mask_g, n};

  // ---- load
  if (kStaged) {
    int* key_s = smem;
    int* src_s = smem + e_n;
    float* mask_s = reinterpret_cast<float*>(smem + 2 * e_n);
    if (vec_load) {  // E % 4 == 0 and 16-byte aligned rows
      for (int i = threadIdx.x; i < e_n / 4; i += blockDim.x) {
        const int4 s = reinterpret_cast<const int4*>(src_g)[i];
        const int4 d = reinterpret_cast<const int4*>(src_g + e_n)[i];
        const float4 m = reinterpret_cast<const float4*>(mask_g)[i];
        reinterpret_cast<int4*>(src_s)[i] = s;
        reinterpret_cast<int4*>(key_s)[i] = make_int4(
            row_key(s.x, d.x, m.x, n), row_key(s.y, d.y, m.y, n),
            row_key(s.z, d.z, m.z, n), row_key(s.w, d.w, m.w, n));
        reinterpret_cast<float4*>(mask_s)[i] = m;
      }
    } else {
      for (int i = threadIdx.x; i < e_n; i += blockDim.x) {
        const int s = src_g[i];
        const float m = mask_g[i];
        src_s[i] = s;
        key_s[i] = row_key(s, src_g[e_n + i], m, n);
        mask_s[i] = m;
      }
    }
    __syncthreads();
    el = EdgeList<kStaged>{src_s, key_s, nullptr, mask_s, n};
  }

  // ---- rows
  const int lane = threadIdx.x & 31;
  const int d0 = blockIdx.y * group_rows + (threadIdx.x >> 5) * kRowsPerWarp;
  const int rows =
      min(kRowsPerWarp, min(n, ((int)blockIdx.y + 1) * group_rows) - d0);
  if (rows <= 0) return;
  float* out_d0 = out + ((size_t)b * n + d0) * n;
  for (int c0 = 0; c0 < n; c0 += kCols) {
    float acc[kRowsPerWarp][4] = {};
    int key = lane < e_n ? el.row_of(lane) : -1;
    for (int e0 = 0; e0 < e_n; e0 += 32) {
      const int next = e0 + 32 + lane;  // the next 32 keys, loaded early
      const int key_next = next < e_n ? el.row_of(next) : -1;
      const int r_lane = key - d0;      // the row of this lane's edge
      unsigned bits = __ballot_sync(~0u, (unsigned)r_lane < (unsigned)rows);
      key = key_next;
      while (bits) {  // the warp's edges in ascending e
        const int l = __ffs(bits) - 1;
        bits &= bits - 1;
        const int r = __shfl_sync(~0u, r_lane, l);
        const int rel = el.src[e0 + l] - c0 - VEC * lane;  // slot, scaled
        const float m = el.mask[e0 + l];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (r == i && rel == j * (VEC == 4 ? 1 : 32)) acc[i][j] += m;
      }
    }
    // ---- store
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      if (i >= rows) break;
      float* row = out_d0 + (size_t)i * n;
      if (VEC == 4) {
        const int col = c0 + 4 * lane;
        if (col < n) {
          const float4 v = make_float4(clamp1(acc[i][0]), clamp1(acc[i][1]),
                                       clamp1(acc[i][2]), clamp1(acc[i][3]));
          *reinterpret_cast<float4*>(row + col) = v;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = c0 + lane + 32 * j;
          if (col < n) row[col] = clamp1(acc[i][j]);
        }
      }
    }
  }
}

// Row groups per molecule: the SM count over the batch, rounded, at least
// 1 and at most N.
int row_groups(int batch, int n, int sms) {
  return std::max(1, std::min((sms + batch / 2) / batch, n));
}

// Rows of one group, after adding groups until a block has at most
// kMaxWarps warps of kRowsPerWarp rows.
int group_rows(int n, int groups) {
  const int most = kMaxWarps * kRowsPerWarp;
  const int g = std::max(groups, (n + most - 1) / most);
  return (n + g - 1) / g;
}

int warps_for(int rows) { return (rows + kRowsPerWarp - 1) / kRowsPerWarp; }

size_t staged_smem(int e) { return (size_t)e * 12; }

template <int VEC, bool kStaged>
int launch(const void* edges, const void* edge_mask, void* out, int batch,
           int e, int n, int rows, int vec_load, cudaStream_t stream) {
  const size_t smem = kStaged ? staged_smem(e) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        dense_adjacency_kernel<VEC, kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(batch, (n + rows - 1) / rows);
  dense_adjacency_kernel<VEC, kStaged><<<grid, warps_for(rows) * 32, smem, stream>>>(
      static_cast<const int*>(edges), static_cast<const float*>(edge_mask),
      static_cast<float*>(out), e, n, rows, vec_load);
  return (int)cudaGetLastError();
}

}  // namespace

// edges [B, 2, E] int32, edge_mask [B, E] f32, out [B, N, N] f32; all
// contiguous on the current device, N >= 1.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int dense_adjacency_launch(const void* edges, const void* edge_mask,
                                      void* out, int batch, int num_edges,
                                      int num_nodes, void* stream) {
  if (batch == 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int n = num_nodes, e = num_edges;
  int groups = row_groups(batch, n, sms);
  const int rows = group_rows(n, groups);
  const bool aligned16 = ((uintptr_t)edges % 16 == 0) &&
                         ((uintptr_t)edge_mask % 16 == 0);
  const int vec_load = (e % 4 == 0 && aligned16) ? 1 : 0;
  const bool staged = staged_smem(e) <= kSmemLimit;
  const bool vec_store = n % 4 == 0 && (uintptr_t)out % 16 == 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec_store)
    return staged ? launch<4, true>(edges, edge_mask, out, batch, e, n, rows, vec_load, s)
                  : launch<4, false>(edges, edge_mask, out, batch, e, n, rows, vec_load, s);
  return staged ? launch<1, true>(edges, edge_mask, out, batch, e, n, rows, vec_load, s)
                : launch<1, false>(edges, edge_mask, out, batch, e, n, rows, vec_load, s);
}
