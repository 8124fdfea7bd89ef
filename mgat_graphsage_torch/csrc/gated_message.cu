// GraphGPS's gated message passing, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no GraphGPS.  It takes the
// place of the chain of PyTorch ops of ops/gated_message.py::GatedMessage
// (kept for the CPU, f64 and shapes past the limits below) on CUDA tensors,
// in every layer of models/layers.py::GatedGCNLayer.
//
// For node rows dh, eh, bh [B, n, D] and edge rows ce [B, E, D] (bf16 or
// f32, all one type), edges [B, 2, E] int32 (row 0 the source j, row 1 the
// target i) and mask [B, E] (the same type; a slot is real where it is not
// 0, and its gate is scaled by it):
//     e_ji  = (dh_i + eh_j) + ce_ji            f32, rounded once to T
//     s_ji  = sigmoid(e_ji) * mask_ji          real slots only
//     agg_i = num_i * inv_i,  num_i = sum s_ji bh_j,  inv_i = 1 / (sum s_ji
//             + 1e-6)                          f32 sums
// e is written for every slot, masked ones included.  The backward, from
// the outputs' gradients G (agg) and Ge (e), either may be absent:
//     de_ji = Ge_ji + ((dnum_i bh_j - dden_i) s_ji) (1 - s_ji)   (real)
//     de_ji = Ge_ji                                            (masked)
//     dnum_i = G_i inv_i,  dden_i = (G_i agg_i) inv_i
//     ddh_i = sum_{slots -> i} de,  deh_j = sum_{slots j ->} de,
//     dbh_j = sum_{real slots j ->} dnum_i s_ji,  dce = de
// the explicit path's arithmetic in its order, up to the order of the f32
// sums.  Indices outside [0, n) are clamped into it (the explicit path's
// index_select refuses them).
//
// Bound on the H100: bytes.  At B = 1024, n = 80, E = 176, D = 384 in bf16
// the forward must read dh, eh, bh, ce and write agg and e (4 node and 2
// edge tensors, 528 MB: 158 us at 3.35 TB/s) and the backward read G, dh,
// eh, bh, Ge, ce and write ddh, deh, dbh, dce (7 node and 3 edge tensors,
// 855 MB: 255 us).  The torch ops made ~12 passes forward and ~15 backward
// over f32 [B * E, D] temporaries (277 MB each) at every padded slot (69% of
// them in the training cell), summed by index_add_ atomics, and saved the
// f32 gates, agg and inv for the backward.  So here every row is read and
// written once a pass, nothing edge-sized is kept for the backward (it
// recomputes e, the gates and the sums from the same inputs, to the bit),
// and the arithmetic, a sigmoid a slot, hides behind the loads.
//
// Design.  A block per (molecule, 64 columns of D): a column chunk is
// independent of every other, so no sum crosses blocks.  The block stages
// its molecule's edges and mask in shared memory and sorts its slots by key
// with a stable counting sort (one warp, __match_any_sync over 32 slots at
// a time): every list is in slot order, and every sum runs over its list in
// one fixed order, with no atomics: the same bits on every run, for any
// edge list and any mask.  A thread takes 8 columns of a row (one 16-byte
// load of bf16), 8 threads a row, 32 rows in flight.
//   Forward: the work items are the n targets and the masked slots.  A
// target reads dh_i once and walks its real incoming slots, writing each
// e_ji and summing num and den in registers, then writes agg_i (0 for a
// target with none).  A masked slot writes its e alone.  The padding's
// slots (all 0 -> 0 in a featurised batch) so spread over the block rather
// than lengthen atom 0's list.
//   Backward: lists by (target, masked) and by (source, masked), so that a
// node's real slots come first in its list, and of the masked slots alone.
// Pass 1, over the same items: a target recomputes num and den over its real
// slots, then walks them again for de and dnum * s, which it keeps in f32 in
// shared memory ([E][64] each) and writes dce; a masked slot keeps de = Ge
// and writes dce.  Pass 2: a
// target sums de over its whole list into ddh, a source over its whole list
// into deh and dnum * s over its real part into dbh, four partial sums
// interleaved (the padding's list of ~120 slots is the block's longest
// walk), each output written once.
//
// What the measurements taught (H100, the training cell's shape and
// molecules, PERF.md).  The forward runs at 238 us (66% of its bound), the
// backward at 584 us (44%): 48 us of staging and sorting, ~390 us of pass 1
// and ~140 us of pass 2 by copies with a pass cut out.  Pass 1 waits on
// its loads: a target's real slots are walked one after another, twice,
// and ~22 of a block's 32 rows hold a real target.  Other shapes of the
// same arithmetic (the same bits) read: 32 columns a block and 4 a thread,
// 287 / 561 us; 64 and 4, 212 / 710 us; 32 and 8, 343 / 873 us.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxN = 128;    // atoms: a node index is one byte
constexpr int kMaxE = 256;    // edge slots: a slot index is one byte
constexpr int kCols = 64;     // columns of D a block
constexpr int kVec = 8;       // columns a thread: one 16-byte load of bf16
constexpr int kLanes = kCols / kVec;   // threads a row
constexpr int kThreads = 256;
constexpr int kRows = kThreads / kLanes;  // rows in flight
constexpr float kEps = 1e-6f;  // the public GatedGCNLayer's, ops/gated_message.py EPS

template <typename T>
struct Args {
  const T* dh;
  const T* eh;
  const T* ce;
  const T* bh;
  const T* mask;      // [B, E]
  const int* edges;   // [B, 2, E]
  const T* g_agg;     // backward: [B, n, D] or null
  const T* g_e;       // backward: [B, E, D] or null
  T* agg;             // forward outputs
  T* e;
  T* ddh;             // backward outputs
  T* deh;
  T* dce;
  T* dbh;             // null where g_agg is
  int n, E, D;
};

// ---- rows of 8 columns ----------------------------------------------------

__device__ __forceinline__ void load8(const bf16* p, float (&v)[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p + 4));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void store8(bf16* p, const float (&v)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void zero8(float (&v)[kVec]) {
#pragma unroll
  for (int q = 0; q < kVec; ++q) v[q] = 0.f;
}

// torch's sigmoid for float: 1 / (1 + exp(-x))
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }

// ---- staging and the counting sort -----------------------------------------

struct Slots {
  uint8_t src[kMaxE];
  uint8_t dst[kMaxE];
  float m[kMaxE];          // the mask's value, 0 on a masked slot
};

// One warp: a stable counting sort of the slots 0..E-1 by key[s] < nkeys
// (<= 256).  start[k] is the first position of key k in order, start[nkeys]
// = E; within a key the slots keep their order.  rank is scratch.
__device__ void warp_sort(const uint8_t* key, int E, int nkeys,
                          uint8_t* rank, int16_t* start, uint8_t* order) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int k = lane; k < nkeys; k += 32) start[k] = 0;  // counts, first
  __syncwarp();
  for (int base = 0; base < E; base += 32) {
    const int s = base + lane;
    const bool in = s < E;
    const int k = in ? key[s] : 256 + lane;   // a lane past E peers with none
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    const int r = in ? start[k] + __popc(peers & below) : 0;
    __syncwarp();
    if (in) {
      rank[s] = static_cast<uint8_t>(r);
      if ((peers & below) == 0) start[k] += __popc(peers);
    }
    __syncwarp();
  }
  constexpr int kPer = 256 / 32;
  int c[kPer], sum = 0;
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = lane * kPer + q;
    c[q] = k < nkeys ? start[k] : 0;
    sum += c[q];
  }
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  int run = incl - sum;
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int k = lane * kPer + q;
    if (k < nkeys) start[k] = static_cast<int16_t>(run);
    run += c[q];
  }
  if (lane == 0) start[nkeys] = static_cast<int16_t>(E);
  __syncwarp();
  for (int s = lane; s < E; s += 32) order[start[key[s]] + rank[s]] = static_cast<uint8_t>(s);
  __syncwarp();
}

// One warp: the masked slots in slot order into list, their count into
// *count.
__device__ void masked_list(const Slots& sl, int E, uint8_t* list,
                            int* count) {
  const int lane = threadIdx.x & 31;
  int run = 0;
  for (int base = 0; base < E; base += 32) {
    const int s = base + lane;
    const bool off = s < E && sl.m[s] == 0.f;
    const unsigned ball = __ballot_sync(0xffffffffu, off);
    if (off) list[run + __popc(ball & ((1u << lane) - 1u))] = static_cast<uint8_t>(s);
    run += __popc(ball);
  }
  if (lane == 0) *count = run;
}

template <typename T>
__device__ void stage(const Args<T>& a, Slots& sl) {
  const int b = blockIdx.x;
  const int* src = a.edges + (long long)b * 2 * a.E;
  const int* dst = src + a.E;
  const T* mask = a.mask + (long long)b * a.E;
  for (int s = threadIdx.x; s < a.E; s += blockDim.x) {
    sl.src[s] = static_cast<uint8_t>(min(max(__ldg(src + s), 0), a.n - 1));
    sl.dst[s] = static_cast<uint8_t>(min(max(__ldg(dst + s), 0), a.n - 1));
    sl.m[s] = to_float(mask[s]);
  }
}

// ---- forward ------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
gated_message_fwd_kernel(const Args<T> a) {
  __shared__ Slots sl;
  __shared__ uint8_t key[kMaxE], rank[kMaxE], order[kMaxE];
  __shared__ int16_t start[kMaxN + 2];
  stage(a, sl);
  __syncthreads();
  // real slots by target, the masked ones after them under key n
  for (int s = threadIdx.x; s < a.E; s += blockDim.x)
    key[s] = sl.m[s] != 0.f ? sl.dst[s] : static_cast<uint8_t>(a.n);
  __syncthreads();
  if (threadIdx.x < 32) warp_sort(key, a.E, a.n + 1, rank, start, order);
  __syncthreads();

  const int col = blockIdx.y * kCols + (threadIdx.x % kLanes) * kVec;
  if (col >= a.D) return;
  const long long D = a.D;
  const T* dh = a.dh + (long long)blockIdx.x * a.n * D + col;
  const T* eh = a.eh + (long long)blockIdx.x * a.n * D + col;
  const T* bh = a.bh + (long long)blockIdx.x * a.n * D + col;
  const T* ce = a.ce + (long long)blockIdx.x * a.E * D + col;
  T* e = a.e + (long long)blockIdx.x * a.E * D + col;
  T* agg = a.agg + (long long)blockIdx.x * a.n * D + col;
  const int masked = a.E - start[a.n];
  for (int it = threadIdx.x / kLanes; it < a.n + masked; it += kRows) {
    if (it < a.n) {
      const int i = it;
      float x[kVec], num[kVec], den[kVec];
      zero8(num);
      zero8(den);
      const int k1 = start[i + 1];
      if (start[i] < k1) load8(dh + i * D, x);
      for (int k = start[i]; k < k1; ++k) {
        const int s = order[k], j = sl.src[s];
        float y[kVec], c[kVec], v[kVec], ev[kVec];
        load8(eh + j * D, y);
        load8(ce + s * D, c);
        load8(bh + j * D, v);
        const float m = sl.m[s];
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          ev[q] = (x[q] + y[q]) + c[q];
          const float g = sigmoid(ev[q]) * m;
          num[q] += g * v[q];
          den[q] += g;
        }
        store8(e + s * D, ev);
      }
#pragma unroll
      for (int q = 0; q < kVec; ++q) num[q] = num[q] * (1.f / (den[q] + kEps));
      store8(agg + i * D, num);
    } else {
      const int s = order[start[a.n] + it - a.n];
      float x[kVec], y[kVec], c[kVec];
      load8(dh + sl.dst[s] * D, x);
      load8(eh + sl.src[s] * D, y);
      load8(ce + s * D, c);
#pragma unroll
      for (int q = 0; q < kVec; ++q) x[q] = (x[q] + y[q]) + c[q];
      store8(e + s * D, x);
    }
  }
}

// ---- backward -----------------------------------------------------------

// the f32 rows of a block's slots in shared memory: de, then dnum * s
__host__ __device__ inline int bwd_smem(int E) {
  return 2 * E * kCols * (int)sizeof(float);
}

// the sum of rows of buf [E][kCols] over list[k0..k1), four partial sums
// interleaved, added in a fixed order
__device__ __forceinline__ void sum_rows(const float* buf, const uint8_t* list,
                                         int k0, int k1, int cofs,
                                         float (&out)[kVec]) {
  float p[4][kVec];
#pragma unroll
  for (int u = 0; u < 4; ++u) zero8(p[u]);
  int k = k0;
  for (; k + 4 <= k1; k += 4) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* r = buf + list[k + u] * kCols + cofs;
      const float4 lo = *reinterpret_cast<const float4*>(r);
      const float4 hi = *reinterpret_cast<const float4*>(r + 4);
      p[u][0] += lo.x; p[u][1] += lo.y; p[u][2] += lo.z; p[u][3] += lo.w;
      p[u][4] += hi.x; p[u][5] += hi.y; p[u][6] += hi.z; p[u][7] += hi.w;
    }
  }
#pragma unroll
  for (int u = 0; u < 3; ++u) {
    if (k + u < k1) {
      const float* r = buf + list[k + u] * kCols + cofs;
#pragma unroll
      for (int q = 0; q < kVec; ++q) p[u][q] += r[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kVec; ++q) out[q] = (p[0][q] + p[1][q]) + (p[2][q] + p[3][q]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gated_message_bwd_kernel(const Args<T> a) {
  extern __shared__ float4 dyn[];
  float* de_s = reinterpret_cast<float*>(dyn);     // [E][kCols]
  float* ds_s = de_s + a.E * kCols;                // [E][kCols]
  __shared__ Slots sl;
  __shared__ uint8_t tkey[kMaxE], skey[kMaxE], trank[kMaxE], srank[kMaxE];
  __shared__ uint8_t torder[kMaxE], sorder[kMaxE];
  __shared__ uint8_t mlist[kMaxE];
  __shared__ int16_t tstart[2 * kMaxN + 1], sstart[2 * kMaxN + 1];
  __shared__ int masked;
  stage(a, sl);
  __syncthreads();
  for (int s = threadIdx.x; s < a.E; s += blockDim.x) {
    const int off = sl.m[s] == 0.f;
    tkey[s] = static_cast<uint8_t>(2 * sl.dst[s] + off);
    skey[s] = static_cast<uint8_t>(2 * sl.src[s] + off);
  }
  __syncthreads();
  if (threadIdx.x < 32)
    warp_sort(tkey, a.E, 2 * a.n, trank, tstart, torder);
  else if (threadIdx.x < 64)
    warp_sort(skey, a.E, 2 * a.n, srank, sstart, sorder);
  else if (threadIdx.x < 96)
    masked_list(sl, a.E, mlist, &masked);
  __syncthreads();

  const int cofs = (threadIdx.x % kLanes) * kVec;
  const int col = blockIdx.y * kCols + cofs;
  const bool live = col < a.D;
  const long long D = a.D;
  const long long nb = (long long)blockIdx.x * a.n * D + col;
  const long long eb = (long long)blockIdx.x * a.E * D + col;
  const bool has_g = a.g_agg != nullptr, has_ge = a.g_e != nullptr;
  const int row = threadIdx.x / kLanes;

  // pass 1: de and dnum * s of every slot into shared memory, dce out
  for (int it = row; live && it < a.n + masked; it += kRows) {
    if (it < a.n) {
      const int i = it, k0 = tstart[2 * i], k1 = tstart[2 * i + 1];
      if (k0 == k1) continue;
      float x[kVec], dnum[kVec], dden[kVec];
      load8(a.dh + nb + i * D, x);
      if (has_g) {
        float g[kVec], num[kVec], den[kVec];
        load8(a.g_agg + nb + i * D, g);
        zero8(num);
        zero8(den);
        for (int k = k0; k < k1; ++k) {
          const int s = torder[k], j = sl.src[s];
          float y[kVec], c[kVec], v[kVec];
          load8(a.eh + nb + j * D, y);
          load8(a.ce + eb + s * D, c);
          load8(a.bh + nb + j * D, v);
          const float m = sl.m[s];
#pragma unroll
          for (int q = 0; q < kVec; ++q) {
            const float g = sigmoid((x[q] + y[q]) + c[q]) * m;
            num[q] += g * v[q];
            den[q] += g;
          }
        }
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          const float inv = 1.f / (den[q] + kEps);
          dnum[q] = g[q] * inv;
          dden[q] = (g[q] * (num[q] * inv)) * inv;
        }
      }
      for (int k = k0; k < k1; ++k) {
        const int s = torder[k], j = sl.src[s];
        float de[kVec];
        if (has_ge) load8(a.g_e + eb + s * D, de);
        else zero8(de);
        if (has_g) {
          float y[kVec], c[kVec], v[kVec], ds[kVec];
          load8(a.eh + nb + j * D, y);
          load8(a.ce + eb + s * D, c);
          load8(a.bh + nb + j * D, v);
          const float m = sl.m[s];
#pragma unroll
          for (int q = 0; q < kVec; ++q) {
            const float g = sigmoid((x[q] + y[q]) + c[q]) * m;
            de[q] = de[q] + ((dnum[q] * v[q] - dden[q]) * g) * (1.f - g);
            ds[q] = dnum[q] * g;
          }
          store8(ds_s + s * kCols + cofs, ds);
        }
        store8(de_s + s * kCols + cofs, de);
        store8(a.dce + eb + s * D, de);
      }
    } else {
      const int s = mlist[it - a.n];
      float de[kVec];
      if (has_ge) load8(a.g_e + eb + s * D, de);
      else zero8(de);
      store8(de_s + s * kCols + cofs, de);
      store8(a.dce + eb + s * D, de);
    }
  }
  __syncthreads();
  if (!live) return;

  // pass 2: each node's sums over its lists, each output written once
  for (int it = row; it < 2 * a.n; it += kRows) {
    float out[kVec];
    if (it < a.n) {
      const int i = it;
      sum_rows(de_s, torder, tstart[2 * i], tstart[2 * i + 2], cofs, out);
      store8(a.ddh + nb + i * D, out);
    } else {
      const int j = it - a.n;
      sum_rows(de_s, sorder, sstart[2 * j], sstart[2 * j + 2], cofs, out);
      store8(a.deh + nb + j * D, out);
      if (has_g) {
        sum_rows(ds_s, sorder, sstart[2 * j], sstart[2 * j + 1], cofs, out);
        store8(a.dbh + nb + j * D, out);
      }
    }
  }
}

template <typename T>
Args<T> make_args(const void* dh, const void* eh, const void* ce,
                  const void* bh, const void* edges, const void* mask, int n,
                  int E, int D) {
  Args<T> a{};
  a.dh = static_cast<const T*>(dh);
  a.eh = static_cast<const T*>(eh);
  a.ce = static_cast<const T*>(ce);
  a.bh = static_cast<const T*>(bh);
  a.edges = static_cast<const int*>(edges);
  a.mask = static_cast<const T*>(mask);
  a.n = n;
  a.E = E;
  a.D = D;
  return a;
}

bool valid(int batch, int n, int E, int D, int dtype) {
  return batch >= 0 && batch <= 2147483647 && n >= 1 && n <= kMaxN &&
         E >= 1 && E <= kMaxE && D >= kVec && D % kVec == 0 &&
         (dtype == 0 || dtype == 1);
}

template <typename T>
int fwd(const Args<T>& a, int batch, cudaStream_t s) {
  const dim3 grid(batch, (a.D + kCols - 1) / kCols);
  gated_message_fwd_kernel<T><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const Args<T>& a, int batch, cudaStream_t s) {
  const int smem = bwd_smem(a.E);
  cudaError_t err = cudaFuncSetAttribute(
      gated_message_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(batch, (a.D + kCols - 1) / kCols);
  gated_message_bwd_kernel<T><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dh, eh, bh [B, n, D], ce [B, E, D] and mask [B, E], all bf16 (dtype 1) or
// all f32 (dtype 0), edges [B, 2, E] int32, all contiguous and 16-byte
// aligned -> agg [B, n, D] and e [B, E, D] of the same type.  1 <= n <= 128,
// 1 <= E <= 256, D a multiple of 8 (checked by the caller: ops/
// gated_message.py::kernels_support).  Returns cudaGetLastError() after the
// launch.
extern "C" int gated_message_fwd_launch(const void* dh, const void* eh,
                                        const void* ce, const void* bh,
                                        const void* edges, const void* mask,
                                        void* agg, void* e, int batch, int n,
                                        int E, int D, int dtype,
                                        void* stream) {
  if (!valid(batch, n, E, D, dtype)) return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    Args<bf16> a = make_args<bf16>(dh, eh, ce, bh, edges, mask, n, E, D);
    a.agg = static_cast<bf16*>(agg);
    a.e = static_cast<bf16*>(e);
    return fwd(a, batch, s);
  }
  Args<float> a = make_args<float>(dh, eh, ce, bh, edges, mask, n, E, D);
  a.agg = static_cast<float*>(agg);
  a.e = static_cast<float*>(e);
  return fwd(a, batch, s);
}

// The forward's inputs and the outputs' gradients g_agg [B, n, D] and g_e
// [B, E, D] (either may be NULL: a zero gradient) -> ddh, deh, dbh [B, n,
// D] and dce [B, E, D] (dbh NULL, and not written, where g_agg is), of the
// inputs' type, the same layout and limits.  Returns cudaGetLastError().
extern "C" int gated_message_bwd_launch(const void* dh, const void* eh,
                                        const void* ce, const void* bh,
                                        const void* edges, const void* mask,
                                        const void* g_agg, const void* g_e,
                                        void* ddh, void* deh, void* dce,
                                        void* dbh, int batch, int n, int E,
                                        int D, int dtype, void* stream) {
  if (!valid(batch, n, E, D, dtype) || (g_agg != nullptr && dbh == nullptr))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    Args<bf16> a = make_args<bf16>(dh, eh, ce, bh, edges, mask, n, E, D);
    a.g_agg = static_cast<const bf16*>(g_agg);
    a.g_e = static_cast<const bf16*>(g_e);
    a.ddh = static_cast<bf16*>(ddh);
    a.deh = static_cast<bf16*>(deh);
    a.dce = static_cast<bf16*>(dce);
    a.dbh = static_cast<bf16*>(dbh);
    return bwd(a, batch, s);
  }
  Args<float> a = make_args<float>(dh, eh, ce, bh, edges, mask, n, E, D);
  a.g_agg = static_cast<const float*>(g_agg);
  a.g_e = static_cast<const float*>(g_e);
  a.ddh = static_cast<float*>(ddh);
  a.deh = static_cast<float*>(deh);
  a.dce = static_cast<float*>(dce);
  a.dbh = static_cast<float*>(dbh);
  return bwd(a, batch, s);
}
