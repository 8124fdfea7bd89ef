// Graphormer's structural attention bias, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no graph transformer.  It
// takes the place of the chain of PyTorch ops of ops/structural_bias.py::
// structural_bias_explicit (kept for the CPU) on CUDA tensors, in
// models/layers.py::StructuralBias.
//
// For spd [B, n, n] int8 (shortest-path distances, -1 for unreachable and
// padded pairs), types [B, n, n, hops] int8 (the bond type of each hop of
// the pair's path, 0 for none), spatial [S, H], virt [H] and edge [hops, 5,
// H] f32 (edge[m][t] = edge_type[t] @ edge_hop[m], formed by the caller;
// edge[m][0] is the padding type's constant zero):
//     r    = S - 1 if d < 0, else min(d, S - 2)
//     c    = (edge[0][t_0] + edge[1][t_1] + ... + edge[hops-1][t_hops-1])
//            / clamp(d, 1, hops)                  (added in that order)
//     out[b, h, i + 1, j + 1] = spatial[r][h] + c[h]
//     out[b, h, 0, :] = out[b, h, :, 0] = virt[h]
// out [B, H, n + 1, n + 1] f32: the torch ops' f32 operations in their
// order, so the two agree bit for bit.  The backward, for the output's
// gradient G:
//     d_spatial[r]  = sum of G over the pairs of row r
//     d_edge[m][t]  = sum of G / clamp(d, 1, hops) over the pairs with
//                     t_m = t, for t >= 1 (type 0 embeds to a constant)
//     d_virt        = sum of G over row 0 and column 0.
//
// Bound on the H100: bytes.  At B = 1024, n = 80, H = 32 each direction
// reads the int8 structure (39.3 MB) and writes, or reads, the f32 bias
// once (860 MB): 0.268 ms at 3.35 TB/s.  The torch ops made ~25 passes over
// [B, n, n, H] f32 temporaries forward, and their backward sorted 6.5M
// indices for each of the six table lookups.  So nothing [B, H, N, N] is
// made but the one output, nothing is sorted, and the arithmetic (the
// IEEE division by the hop count that the torch ops make) hides behind the
// bytes.
//
// Design.  Forward: a block per molecule stages, head-major in shared
// memory, the table rows the molecule can touch (distances below
// min(n, S - 1), the unreachable row S - 1, the edge table) and, for a pair
// with no bond (most pairs of a padded batch), its hop terms' sum over each
// hop count; then a 32-bit descriptor a pair (distance row, hop count, bond
// types).  It then writes one head's plane at a time, front to back, each
// warp's store one whole 128-byte line.  Backward: a warp takes a
// (molecule, row) at a time, lane = head, and stages the next row's G for
// all heads (4-byte cp.async, its structure into registers) while it sums
// the current one.  The distance bin adds into the lane's own bank of a
// warp-private [bins][32] sum in shared memory (no bank conflicts, no
// atomics); a group of 8 keys of one bin and no bond (padding) adds as one
// sum, and a run of keys in one bin in a register first.  The edge rows add
// into registers by selects, with no branch.  At the end a block adds its
// warps' sums in warp order into one partial a block, and a second launch
// adds the partials in block order.  The grid is the card's resident blocks
// and each warp's rows are fixed by its index, so every run gives the same
// bits.  A distance at or past n (none that the featuriser makes: a path
// visits at most n atoms) has no bin: its row adds by atomics straight into
// d_spatial, the one sum whose order may change between runs.
//
// What the measurements taught (H100, B = 1024, n = 80, the cell's
// molecules, PERF.md).  A thread a pair writing its 32 heads, a plane apart,
// took 0.94 ms forward; a head's plane at a time 0.75 ms, and with each
// warp's store aligned to a line 0.56 ms (the stores alone: 0.62 -> 0.37
// ms, against 0.26 ms for a plain fill).  The backward's per-key loop ran
// at ~270 cycles a key with a uniform switch over the bond types and the
// structure loaded byte by byte (1.93 ms); loads in flight together, the
// selects, the padding groups and a double buffer brought it to ~1.0 ms,
// where each row waits ~12K cycles for its G although the next row's copy
// starts a whole row ahead: the 32 heads' rows lie a plane apart, 324 bytes
// each, and the HBM serves them at ~0.85 TB/s.  16-byte copies, 4-byte
// copies, loads through registers and warps kept in step per row all read
// the same.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 128;     // atoms: keys of a row are n + 1 <= 129
constexpr int kMaxHops = 5;    // descriptor: 8 + 3 + 3 * 5 bits
constexpr int kTypes = 5;      // bond types 1..4 and the padding type 0
constexpr int kFwdThreads = 256;
constexpr int kMaxWarps = 8;   // backward warps a block, at most
constexpr int kSumWarps = 8;   // final sum: warps a bin
constexpr int kOverflow = 255;  // descriptor bin of a distance at or past n
constexpr int kKeysPerLane = (kMaxN + 31) / 32;
constexpr int kGroup = 8;      // backward keys loaded together
constexpr unsigned kVirtual = 0xffffffffu;  // forward: the graph token's pair

struct Args {
  const int8_t* spd;
  const int8_t* types;
  const float* spatial;  // [S, H]
  const float* virt;     // [H]
  const float* edge;     // [hops, 5, H]
  const float* grad;     // [B, H, n + 1, n + 1]
  float* out;            // [B, H, n + 1, n + 1]
  float* partial;        // [blocks, bins, 32]
  float* d_spatial;      // [S, H], zeroed by the caller
  float* d_virt;         // [H]
  float* d_edge;         // [hops, 5, H], zeroed by the caller
  int batch, heads, n, S, hops;
  int nd;                // distance bins: min(n, S - 1)
};

__host__ __device__ inline int bins(const Args& a) {
  // distances, unreachable, edges (m, t - 1), virtual
  return a.nd + 1 + a.hops * (kTypes - 1) + 1;
}

// a backward staging buffer: [32][(n + 1) | 1] (odd, so the 32 lanes'
// reads of one key fall in 32 banks), and at least the rows of sums that
// follow the distance rows at the end
__host__ __device__ inline int tile_floats(const Args& a) {
  const int t = 32 * ((a.n + 1) | 1), extra = 32 * (bins(a) - a.nd - 1);
  return t > extra ? t : extra;
}

// a backward warp's shared memory: its distance sums [nd + 1][32], two
// staging buffers, two rows of descriptors
__host__ __device__ inline int warp_floats(const Args& a) {
  return 32 * (a.nd + 1) + 2 * tile_floats(a) + 2 * (a.n + 1);
}

__device__ __forceinline__ int clamp_type(int t) {
  return t < 0 ? 0 : (t >= kTypes ? kTypes - 1 : t);
}

__device__ __forceinline__ int hop_count(int d, int hops) {
  return d < 1 ? 1 : (d > hops ? hops : d);
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a pair's descriptor: its distance bin (the forward's staged row, or
// kOverflow) in bits 0-7, hop count in 8-10, the hops' bond types in 11-25;
// the forward's kVirtual for the graph token's row and column
__device__ __forceinline__ unsigned pair_desc(int d, const int (&t)[kMaxHops],
                                              int nd, int S, int hops) {
  unsigned w;
  if (d < 0) {
    w = nd;
  } else {
    const int r = min(d, S - 2);
    w = r < nd ? r : kOverflow;
  }
  w |= static_cast<unsigned>(hop_count(d, hops)) << 8;
#pragma unroll
  for (int m = 0; m < kMaxHops; ++m)
    w |= static_cast<unsigned>(clamp_type(t[m])) << (11 + 3 * m);
  return w;
}

__global__ void __launch_bounds__(kFwdThreads)
    structural_bias_fwd_kernel(const Args a) {
  extern __shared__ float sm[];
  const int H = a.heads, n = a.n, n1 = n + 1, nd = a.nd, hops = a.hops;
  const int rs = nd + 1;            // staged spatial rows a head
  const int es = hops * kTypes;     // staged edge rows a head
  const int pairs = n1 * n1;
  float* sp_s = sm;                 // [H][rs]: rows 0..nd-1, then S - 1
  float* ed_s = sp_s + H * rs;      // [H][es]
  float* zq_s = ed_s + H * es;      // [H][hops]: no-bond term / (k + 1)
  unsigned* desc = reinterpret_cast<unsigned*>(zq_s + H * hops);  // [pairs]
  for (int e = threadIdx.x; e < H * rs; e += blockDim.x) {
    const int h = e / rs, r = e - h * rs;
    sp_s[e] = a.spatial[(size_t)(r < nd ? r : a.S - 1) * H + h];
  }
  for (int e = threadIdx.x; e < H * es; e += blockDim.x) {
    const int h = e / es, k = e - h * es;
    ed_s[e] = a.edge[k * H + h];
  }
  const int b = blockIdx.x;
  const int8_t* spd = a.spd + (size_t)b * n * n;
  const int8_t* types = a.types + (size_t)b * n * n * hops;
  for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
    const int i = p / n1, j = p - i * n1;
    if (i == 0 || j == 0) {
      desc[p] = kVirtual;
      continue;
    }
    const int q = (i - 1) * n + (j - 1);
    int t[kMaxHops];
#pragma unroll
    for (int m = 0; m < kMaxHops; ++m)
      t[m] = m < hops ? types[q * hops + m] : 0;
    desc[p] = pair_desc(spd[q], t, nd, a.S, hops);
  }
  __syncthreads();
  // a pair with no bond type adds the type-0 rows: the same sum for every
  // such pair, formed once a head in the pairs' order of operations
  for (int e = threadIdx.x; e < H * hops; e += blockDim.x) {
    const int h = e / hops, k = e - h * hops;
    const float* ed = ed_s + h * es;
    float c = ed[0];
    for (int m = 1; m < hops; ++m) c = __fadd_rn(c, ed[m * kTypes]);
    zq_s[e] = __fdiv_rn(c, static_cast<float>(k + 1));
  }
  __syncthreads();

  // a head's plane at a time, so the block writes it front to back
  float* out = a.out + (size_t)b * H * pairs;
  for (int h = 0; h < H; ++h, out += pairs) {
    const float vd = a.virt[h];
    const float* ed = ed_s + h * es;
    const float* sp = sp_s + h * rs;
    const float* zq = zq_s + h * hops;
    // from the plane's first 128-byte line, so each warp's store fills
    // whole lines
    const int lead =
        static_cast<int>((reinterpret_cast<uintptr_t>(out) >> 2) & 31);
    for (int p = static_cast<int>(threadIdx.x) - lead; p < pairs;
         p += blockDim.x) {
      if (p < 0) continue;
      const unsigned w = desc[p];
      if (w == kVirtual) {
        out[p] = vd;
        continue;
      }
      const int r = w & 255, hop = (w >> 8) & 7;
      float c;
      if (w >> 11) {
        c = ed[(w >> 11) & 7];
#pragma unroll
        for (int m = 1; m < kMaxHops; ++m)
          if (m < hops)
            c = __fadd_rn(c, ed[m * kTypes + ((w >> (11 + 3 * m)) & 7)]);
        c = __fdiv_rn(c, static_cast<float>(hop));
      } else {
        c = zq[hop - 1];
      }
      float s;
      if (r != kOverflow) {
        s = sp[r];
      } else {  // a distance at or past n: its row read in place
        const int i = p / n1, j = p - i * n1;
        s = a.spatial[(size_t)min(static_cast<int>(spd[(i - 1) * n + j - 1]),
                                  a.S - 2) * H + h];
      }
      out[p] = __fadd_rn(s, c);
    }
  }
}

// the structure of a row's keys, as the backward's lanes load it: key j =
// lane + 32 u
struct RowStructure {
  int d[kKeysPerLane];
  int t[kKeysPerLane][kMaxHops];
};

// start the loads of row i of molecule b (every load in flight at once)
__device__ __forceinline__ void load_structure(RowStructure& r, const Args& a,
                                               int b, int i, int lane) {
  const size_t q0 = ((size_t)b * a.n + (i - 1)) * a.n;
#pragma unroll
  for (int u = 0; u < kKeysPerLane; ++u) {
    const int j = lane + 32 * u;
    const bool in = i > 0 && j < a.n;
    r.d[u] = in ? a.spd[q0 + j] : 0;
#pragma unroll
    for (int m = 0; m < kMaxHops; ++m)
      r.t[u][m] = in && m < a.hops ? a.types[(q0 + j) * a.hops + m] : 0;
  }
}

__device__ __forceinline__ void store_desc(unsigned* desc,
                                           const RowStructure& r,
                                           const Args& a, int lane) {
#pragma unroll
  for (int u = 0; u < kKeysPerLane; ++u) {
    const int j = lane + 32 * u;
    if (j < a.n) desc[j + 1] = pair_desc(r.d[u], r.t[u], a.nd, a.S, a.hops);
  }
}

// the row's G for every head into a staging buffer [32][ld] (n1 floats a
// head, a plane apart in the source); one cp.async group
__device__ __forceinline__ void stage_row(float* tile, const Args& a, int b,
                                          int i, int ld, int lane) {
  const int H = a.heads, n1 = a.n + 1;
  const float* g = a.grad + ((size_t)b * H * n1 + i) * n1;
  for (int h = 0; h < H; ++h)
    for (int k = lane; k < n1; k += 32)
      cp4(tile + h * ld + k, g + (size_t)h * n1 * n1 + k);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__global__ void __launch_bounds__(32 * kMaxWarps)
    structural_bias_bwd_kernel(const Args a) {
  extern __shared__ float sm[];
  const int H = a.heads, n = a.n, n1 = n + 1, nd = a.nd, hops = a.hops;
  const int ld = n1 | 1;
  const int wf = warp_floats(a), tf = tile_floats(a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* acc = sm + warp * wf;                      // [nd + 1][32]
  float* tiles = acc + 32 * (nd + 1);               // 2 x tile_floats
  unsigned* descs = reinterpret_cast<unsigned*>(tiles + 2 * tf);  // 2 x [n1]
  for (int k = lane; k < 32 * (nd + 1); k += 32) acc[k] = 0.0f;
  float ea[kMaxHops][kTypes - 1];
#pragma unroll
  for (int m = 0; m < kMaxHops; ++m)
#pragma unroll
    for (int t = 0; t < kTypes - 1; ++t) ea[m][t] = 0.0f;
  float vd = 0.0f;

  // rows row0, row0 + stride, ...: each staged into one buffer while the
  // warp sums the one before it from the other
  const int warps = blockDim.x >> 5;
  const int rows = a.batch * n1, stride = gridDim.x * warps;
  int row = blockIdx.x * warps + warp;
  RowStructure next;
  if (row < rows) {
    const int b = row / n1, i = row - b * n1;
    stage_row(tiles, a, b, i, ld, lane);
    load_structure(next, a, b, i, lane);
    store_desc(descs, next, a, lane);
  }
  for (int buf = 0; row < rows; row += stride, buf ^= 1) {
    const int b = row / n1, i = row - b * n1;
    const int after = row + stride;
    if (after < rows) {
      const int b2 = after / n1, i2 = after - b2 * n1;
      stage_row(tiles + (buf ^ 1) * tf, a, b2, i2, ld, lane);
      load_structure(next, a, b2, i2, lane);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      cp_wait_all();
    }
    __syncwarp();
    const float* gl = tiles + buf * tf + lane * ld;
    const unsigned* desc = descs + buf * n1;

    if (i == 0) {
      for (int j = 0; j < n1; ++j) vd += gl[j];
    } else {
      vd += gl[0];
      int cur = -1;
      float run = 0.0f;
      // keys in groups of kGroup: the group's loads first, then its sums
      for (int j0 = 1; j0 < n1; j0 += kGroup) {
        unsigned w[kGroup];
        float gv[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          w[u] = j0 + u < n1 ? desc[j0 + u] : 0u;
          gv[u] = j0 + u < n1 ? gl[j0 + u] : 0.0f;
        }
        // a group of keys of one bin and no bond (a molecule's padding, most
        // keys of a padded batch): one sum
        bool same = (w[0] >> 11) == 0 && (w[0] & 255) != kOverflow;
#pragma unroll
        for (int u = 1; u < kGroup; ++u)
          same &= j0 + u >= n1 || w[u] == w[0];
        if (same) {
          float t[kGroup];
#pragma unroll
          for (int u = 0; u < kGroup; ++u) t[u] = gv[u];
#pragma unroll
          for (int half = kGroup / 2; half > 0; half /= 2)
#pragma unroll
            for (int u = 0; u < half; ++u) t[u] += t[u + half];
          const int bin = w[0] & 255;
          if (bin == cur) {
            run += t[0];
          } else {
            if (cur >= 0) acc[cur * 32 + lane] += run;
            cur = bin;
            run = t[0];
          }
          continue;
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (j0 + u >= n1) break;
          const int bin = w[u] & 255;
          if (bin == kOverflow) {
            if (lane < H) {
              const int d = a.spd[((size_t)b * n + (i - 1)) * n + j0 + u - 1];
              atomicAdd(a.d_spatial + (size_t)min(d, a.S - 2) * H + lane,
                        gv[u]);
            }
          } else if (bin == cur) {
            run += gv[u];
          } else {
            if (cur >= 0) acc[cur * 32 + lane] += run;
            cur = bin;
            run = gv[u];
          }
          if (w[u] >> 11) {
            const float v =
                __fdiv_rn(gv[u], static_cast<float>((w[u] >> 8) & 7));
            // branch-free: a select a row, no uniform branch to wait on
#pragma unroll
            for (int m = 0; m < kMaxHops; ++m) {
              const unsigned t = (w[u] >> (11 + 3 * m)) & 7;
#pragma unroll
              for (int k = 0; k < kTypes - 1; ++k)
                ea[m][k] += t == k + 1u ? v : 0.0f;
            }
          }
        }
      }
      if (cur >= 0) acc[cur * 32 + lane] += run;
    }
    __syncwarp();  // this buffer is read before it is staged again
    if (after < rows) store_desc(descs + (buf ^ 1) * n1, next, a, lane);
  }

  // the register sums follow the distance rows, over the dead tiles
#pragma unroll
  for (int m = 0; m < kMaxHops; ++m)
    if (m < hops)
#pragma unroll
      for (int t = 0; t < kTypes - 1; ++t)
        acc[(nd + 1 + m * (kTypes - 1) + t) * 32 + lane] = ea[m][t];
  acc[(bins(a) - 1) * 32 + lane] = vd;
  __syncthreads();
  const int nb = bins(a);
  float* part = a.partial + (size_t)blockIdx.x * nb * 32;
  for (int k = threadIdx.x; k < nb * 32; k += blockDim.x) {
    const float* s = sm + k;
    float v = s[0];
    for (int w = 1; w < warps; ++w) v += s[w * wf];
    part[k] = v;
  }
}

// one block a bin: warp w adds the partials of blocks w, w + 8, ... for
// lane = head, then warp 0 adds the eight in order and writes the table row
__global__ void __launch_bounds__(32 * kSumWarps)
    structural_bias_bwd_sum_kernel(const Args a, int blocks) {
  __shared__ float s[kSumWarps][32];
  const int bin = blockIdx.x, nb = bins(a), nd = a.nd, H = a.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float v = 0.0f;
  for (int blk = warp; blk < blocks; blk += kSumWarps)
    v += a.partial[((size_t)blk * nb + bin) * 32 + lane];
  s[warp][lane] = v;
  __syncthreads();
  if (warp != 0 || lane >= H) return;
  float t = s[0][lane];
  for (int w = 1; w < kSumWarps; ++w) t += s[w][lane];
  if (bin < nd) {
    a.d_spatial[(size_t)bin * H + lane] = t;
  } else if (bin == nd) {
    a.d_spatial[(size_t)(a.S - 1) * H + lane] = t;
  } else if (bin < nb - 1) {
    const int k = bin - nd - 1, m = k / (kTypes - 1);
    const int type = k - m * (kTypes - 1) + 1;
    a.d_edge[(m * kTypes + type) * H + lane] = t;
  } else {
    a.d_virt[lane] = t;
  }
}

bool valid(const Args& a) {
  return a.batch >= 0 && a.n >= 1 && a.n <= kMaxN && a.heads >= 1 &&
         a.heads <= 32 && a.hops >= 1 && a.hops <= kMaxHops && a.S >= 2;
}

Args make_args(int batch, int heads, int n, int S, int hops) {
  Args a{};
  a.batch = batch;
  a.heads = heads;
  a.n = n;
  a.S = S;
  a.hops = hops;
  a.nd = n < S - 1 ? n : S - 1;
  return a;
}

int fwd_smem(const Args& a) {
  return 4 * (a.heads * ((a.nd + 1) + a.hops * kTypes + a.hops) +
              (a.n + 1) * (a.n + 1));
}

// the backward's warps a block: as many as fit the block's shared memory,
// up to kMaxWarps; 0 where not even one does
int bwd_warps(const Args& a, int* warps) {
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  const int w = most / (4 * warp_floats(a));
  *warps = w < kMaxWarps ? w : kMaxWarps;
  return (int)err;
}

}  // namespace

// Blocks of the backward's grid (its partials) for this shape on the
// current device: the resident blocks of the card, or fewer where the rows
// do not fill them.  Negative (a cudaError) on failure.
extern "C" int structural_bias_bwd_blocks(int batch, int heads, int n, int S,
                                          int hops) {
  const Args a = make_args(batch, heads, n, S, hops);
  if (!valid(a)) return -(int)cudaErrorInvalidValue;
  int warps = 0;
  cudaError_t err = (cudaError_t)bwd_warps(a, &warps);
  if (err != cudaSuccess) return -(int)err;
  if (warps < 1) return -(int)cudaErrorInvalidConfiguration;
  const int smem = 4 * warps * warp_floats(a);
  err = cudaFuncSetAttribute(structural_bias_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, structural_bias_bwd_kernel, 32 * warps, smem);
  if (err != cudaSuccess) return -(int)err;
  if (per_sm < 1) return -(int)cudaErrorInvalidConfiguration;
  const long long need = ((long long)batch * (n + 1) + warps - 1) / warps;
  const long long blocks = (long long)sms * per_sm;
  return (int)(need < blocks ? (need > 0 ? need : 1) : blocks);
}

// spd [B, n, n] and types [B, n, n, hops] int8, spatial [S, H], virt [H],
// edge [hops, 5, H] f32, out [B, H, n + 1, n + 1] f32, all contiguous;
// 1 <= n <= 128, 1 <= H <= 32, 1 <= hops <= 5, S >= 2 (checked by the
// caller: ops/structural_bias.py::kernels_support).  Returns
// cudaGetLastError() after the launch.
extern "C" int structural_bias_fwd_launch(const void* spd, const void* types,
                                          const void* spatial,
                                          const void* virt, const void* edge,
                                          void* out, int batch, int heads,
                                          int n, int S, int hops,
                                          void* stream) {
  Args a = make_args(batch, heads, n, S, hops);
  if (!valid(a)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  a.spd = static_cast<const int8_t*>(spd);
  a.types = static_cast<const int8_t*>(types);
  a.spatial = static_cast<const float*>(spatial);
  a.virt = static_cast<const float*>(virt);
  a.edge = static_cast<const float*>(edge);
  a.out = static_cast<float*>(out);
  const int smem = fwd_smem(a);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        structural_bias_fwd_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  structural_bias_fwd_kernel<<<batch, kFwdThreads, smem,
                               (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// grad [B, H, n + 1, n + 1] f32 and the forward's structure, contiguous ->
// d_spatial [S, H] and d_edge [hops, 5, H] (both zeroed by the caller; the
// rows no pair touches, and d_edge's type-0 rows, stay zero) and d_virt
// [H]; partial [blocks, bins, 32] f32 scratch, blocks from
// structural_bias_bwd_blocks.  Two launches.  Returns cudaGetLastError().
extern "C" int structural_bias_bwd_launch(const void* grad, const void* spd,
                                          const void* types, void* partial,
                                          void* d_spatial, void* d_virt,
                                          void* d_edge, int batch, int heads,
                                          int n, int S, int hops, int blocks,
                                          void* stream) {
  Args a = make_args(batch, heads, n, S, hops);
  if (!valid(a) || blocks < 1) return (int)cudaErrorInvalidValue;
  a.grad = static_cast<const float*>(grad);
  a.spd = static_cast<const int8_t*>(spd);
  a.types = static_cast<const int8_t*>(types);
  a.partial = static_cast<float*>(partial);
  a.d_spatial = static_cast<float*>(d_spatial);
  a.d_virt = static_cast<float*>(d_virt);
  a.d_edge = static_cast<float*>(d_edge);
  int warps = 0;
  cudaError_t err = (cudaError_t)bwd_warps(a, &warps);
  if (err != cudaSuccess) return (int)err;
  if (warps < 1) return (int)cudaErrorInvalidConfiguration;
  const int smem = 4 * warps * warp_floats(a);
  err = cudaFuncSetAttribute(structural_bias_bwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  structural_bias_bwd_kernel<<<blocks, 32 * warps, smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  structural_bias_bwd_sum_kernel<<<bins(a), 32 * kSumWarps, 0, s>>>(a,
                                                                   blocks);
  return (int)cudaGetLastError();
}
