// P1 and P2: ITERS row permutations of x [R = E * Q rows, BT frames] f32,
// each followed by +1, frames innermost. Two routing probes:
//   micro_flat_gather  x[r, :] <- x[perm[r], :] + 1          (one flat table)
//   micro_row_moves    x[e, s, :] <- x[pi[e], perms[e, s], :] + 1
//                      (a partner row per edge and a slot permutation per
//                      edge; the kernel composes the source row itself)
//
// Replaces: benchmarks/micro_pallas.py, flat_gather_kernel /
// run_flat_gather (P1, call :63) and row_moves_kernel / run_row_moves (P2,
// call :86). The TPU asked whether a static gather lowers at all inside a
// kernel; on Hopper a gather from shared memory is native, and the probes
// ask what one costs.
//
// What bounds them on the H100: bytes. x is read once and written once
// (2 x 3.34 MB at E = 408, Q = 16, BT = 128) and the tables once: about
// 2.0 us at 3.35 TB/s, against 20 x R x BT adds = 0.25 us at 67 TFLOP/s.
// What holds them is the shared-memory pipe (every iteration gathers R
// values of a frame and stores R: at least 2 R / 32 wavefronts an SM) and
// the fixed part (the launch, the slots, the frame in and out).
//
// Design. The frames are independent and a frame's rows mix, so one block
// owns one frame (R values, 26 KB at R = 6528): 128 blocks for 132 SMs at
// the probe's shape, each of up to 1024 threads. A thread owns K "slots"
// (slot i = k * threads + thread), each a (destination, source) pair of
// shared-memory positions packed into one register; the block builds them
// once from the tables, so the iteration loop reads no table and divides
// by nothing: K gathers from one buffer, +1, K stores into the other, one
// barrier, swap. The 32 slots of a warp's k-th step are a "round".
//   Bank conflicts. Slot i holds destination row i, so a round's stores
// fall in 32 banks; P1's gathers go where its table points (a random
// permutation puts ~3.5 of a round's 32 sources in its fullest bank).
// P2 at Q = 16: a round holds two edges, one a half-warp,
// whose 16 slots read 16 floats of one source row: the low or the high 16
// banks by the parity of pi[e]. Edges are paired so that the two differ in
// the parity of e (their stores) and of pi[e] (their gathers): every such
// pair is free of conflicts; the few left over are paired as they come.
// Other Q keep the rows in order.
//   The fixed part. A cluster of C = 2 blocks (two blocks of one GPC
// always fit; 4 and 8 measured about twice as slow at the probe's shape:
// their clusters do not all run at once) owns 2 consecutive frames; each
// block loads half of the rows of both frames (a row's two frames as one
// float2) and writes each value into its frame's block over distributed
// shared memory; at the end each block writes its frame's rows into the
// stage of the block that stores them, and that block stores its rows of
// both frames the same way. Every remote access is a write, so none waits on
// the other SM. One float of every 512-byte row per block would touch a
// cache line per value.
//
// Every value is its plain version's: each iteration is one gather and one
// +1 per row (f32, no FMA), in any order of the rows. Plain versions:
// nbldpc_tpu_torch/kernels/micro.py, flat_gather_plain and row_moves_plain;
// micro.gather_shared_bytes mirrors gather_smem, and micro.row_schedule
// is a host twin of row_slots_paired's order (tested on the CPU; the
// kernel's own order shows only in its time).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kCluster = 2;          // frames a cluster loads and stores together
constexpr int kChunk = 8;            // a thread's gathers in flight before its stores
constexpr int kIoUnroll = 8;         // a thread's loads in flight when a frame moves in
constexpr int kIdxBits = 16;         // a slot: source | destination << 16 (R < 2^16)
constexpr unsigned kIdxMask = (1u << kIdxBits) - 1;
constexpr size_t kDefaultShared = 48 * 1024;
constexpr size_t kMaxShared = 232448;
constexpr int kMaxDevices = 64;
constexpr int kMaxSlots = 20;        // slots a thread: the shared memory caps a frame at 19

enum Mode { kFlat, kRows, kRowsPaired };

struct Args {
  const float* x;
  float* out;
  const int* perm;              // P1: [R]
  const int* pi;                // P2: [E]
  const int* perms;             // P2: [E, Q]
  int R, E, Q, BT, iters;
  int mode;
  int slots;                    // a frame's slots: R, or 32 a pair of edges
};

// Shared bytes of a block (micro.gather_shared_bytes repeats this): two
// buffers of R + 1 floats (the last, a pad slot's cell), the stage of the
// rows the block stores (R + kCluster floats) and, for P2, the scratch
// of the pairing: an edge's class and rank in it [E], the edge at each
// half of each pair [E + 1] and four class counts.
size_t gather_smem(long long R, long long E) {
  return 4 * (2 * (R + 1) + R + kCluster + (E ? 2 * E + 8 : 0));
}

// barrier.cluster in two halves: arrive (relaxed: it orders no memory)
// and wait
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned slot(int dst, int src) {
  return (unsigned)src | ((unsigned)dst << kIdxBits);
}

// P2's slots at Q = 16, paired: pair p (slots 32 p .. 32 p + 31) holds edge
// edge_at[2 p] in its low half-warp and edge_at[2 p + 1] in its high one.
// Class c = 2 (e & 1) + (pi[e] & 1); classes 0 and 3, and 1 and 2, differ
// in both parities and pair first; the rest follow in class order 0, 3, 1,
// 2, two at a time (an odd count leaves one half empty).
template <int K>
__device__ void row_slots_paired(const Args& g, int* scratch, unsigned (&idx)[K]) {
  const int tid = threadIdx.x, nt = blockDim.x, E = g.E;
  int* rnk = scratch;                 // [E] class | rank in the class << 2
  int* edge_at = scratch + E;         // [E + 1]
  int* cnt = edge_at + E + 1;         // [4]
  if (tid < 4) cnt[tid] = 0;
  if (tid == 0) edge_at[E] = -1;
  __syncthreads();
  for (int e = tid; e < E; e += nt) {
    const int c = ((e & 1) << 1) | (__ldg(g.pi + e) & 1);
    rnk[e] = c | atomicAdd(&cnt[c], 1) << 2;
  }
  __syncthreads();
  const int n0 = cnt[0], n1 = cnt[1], n2 = cnt[2], n3 = cnt[3];
  const int m03 = min(n0, n3), m12 = min(n1, n2);
  const int l0 = n0 - m03, l3 = n3 - m03, l1 = n1 - m12;   // left over, by class
  for (int e = tid; e < E; e += nt) {
    const int c = rnk[e] & 3, k = rnk[e] >> 2;
    int at;
    if ((c == 0 || c == 3) && k < m03) {
      at = 2 * k + (c == 3);
    } else if ((c == 1 || c == 2) && k < m12) {
      at = 2 * (m03 + k) + (c == 2);
    } else {
      const int j = c == 0 ? k - m03
                  : c == 3 ? l0 + k - m03
                  : c == 1 ? l0 + l3 + k - m12
                           : l0 + l3 + l1 + k - m12;
      at = 2 * (m03 + m12) + j;
    }
    edge_at[at] = e;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = k * nt + tid, s = i & 15;
    const int e = i < g.slots ? edge_at[(i >> 5) * 2 + ((i >> 4) & 1)] : -1;
    idx[k] = e >= 0 ? slot(e * 16 + s, __ldg(g.pi + e) * 16 + __ldg(g.perms + e * 16 + s))
                    : slot(g.R, g.R);
  }
}

template <int K>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kMaxThreads)
gather_kernel(const Args g) {
  extern __shared__ float smem[];
  const cg::cluster_group cl = cg::this_cluster();
  constexpr int C = kCluster, lgC = 1;
  static_assert(C == 1 << lgC, "a cluster of 2^lgC blocks");
  const int rank = (int)cl.block_rank();
  const int tid = threadIdx.x, nt = blockDim.x, R = g.R, BT = g.BT;
  const int f0 = blockIdx.x - rank;                  // the cluster's first frame
  float* const buf0 = smem;
  float* const buf1 = buf0 + R + 1;
  float* const stage = buf1 + R + 1;                 // [Rc][C], Rc C < R + C
  int* const scratch = reinterpret_cast<int*>(stage + R + C);
  // this block moves rows [r0, r0 + Rc) of the cluster's frames f0 .. f0 +
  // C - 1 in and out, C consecutive floats a row: pair j is row r0 + j / C
  // of frame f0 + j % C
  const int Rc = (R + C - 1) >> lgC, r0 = rank * Rc;
  const int n = max(0, min(R, r0 + Rc) - r0) << lgC;
  auto live = [&](int j) { return j < n && f0 + (j & (C - 1)) < BT; };
  auto at = [&](int j) { return (size_t)(r0 + (j >> lgC)) * BT + f0 + (j & (C - 1)); };
  // two frames of a row as one float2 where every pair of frames is aligned
  const bool vec = BT % 2 == 0 && reinterpret_cast<uintptr_t>(g.x) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(g.out) % 8 == 0;

  // (1) the slots, while the cluster's blocks start (the barrier's wait
  // comes before the first write into another block); a pad slot (past the
  // rows) reads and writes the cell R
  cluster_arrive_relaxed();
  if (tid == 0) buf0[R] = buf1[R] = 0.0f;
  unsigned idx[K];
  if (g.mode == kRowsPaired) {
    row_slots_paired<K>(g, scratch, idx);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = k * nt + tid;
      const int src = i >= R ? R
                    : g.mode == kFlat ? __ldg(g.perm + i)
                                      : __ldg(g.pi + i / g.Q) * g.Q + __ldg(g.perms + i);
      idx[k] = i < R ? slot(i, src) : slot(R, R);
    }
  }
  cluster_wait();

  // (2) this block's pairs, read from x and written into buffer 0 of their
  // frame's block
  const int step = vec ? 2 : 1;
  for (int j0 = step * tid; j0 < n; j0 += step * nt * kIoUnroll) {
    float2 v[kIoUnroll];
#pragma unroll
    for (int u = 0; u < kIoUnroll; ++u) {
      const int j = j0 + step * u * nt;
      v[u] = !live(j) ? make_float2(0.0f, 0.0f)
           : vec      ? *reinterpret_cast<const float2*>(g.x + at(j))
                      : make_float2(g.x[at(j)], 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kIoUnroll; ++u) {
      const int j = j0 + step * u * nt, f = j & (C - 1), r = r0 + (j >> lgC);
      if (live(j)) {
        cl.map_shared_rank(buf0, f)[r] = v[u].x;
        if (vec) cl.map_shared_rank(buf0, f + 1)[r] = v[u].y;
      }
    }
  }
  cl.sync();

  // (3) the iterations: every slot gathers one value, +1, and stores it
  // into the other buffer; one barrier
  const float* a = buf0;
  if (blockIdx.x < BT) {
    float* b = buf1;
    for (int it = 0; it < g.iters; ++it) {
#pragma unroll
      for (int c = 0; c < K; c += kChunk) {
        float v[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (c + u < K) v[u] = a[idx[c + u] & kIdxMask] + 1.0f;
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          if (c + u < K) b[idx[c + u] >> kIdxBits] = v[u];
      }
      __syncthreads();
      float* t = const_cast<float*>(a);
      a = b;
      b = t;
    }
    // (4) the frame's rows into the stage of the block that stores them
    // (rows [k Rc, (k + 1) Rc) to block k, as its pairs); the stages are
    // touched by nothing else, so no barrier comes before
    for (int k = 0; k < C; ++k) {
      float* dst = cl.map_shared_rank(stage, k) + rank;
      const int rows = min(Rc, R - k * Rc);
      for (int i = tid; i < rows; i += nt) dst[i << lgC] = a[k * Rc + i];
    }
  }
  cl.sync();

  // (5) this block's pairs from its stage to out. No block reads another's
  // shared memory past the barrier above, so none waits for the others
  if (vec) {
    for (int j = 2 * tid; j < n; j += 2 * nt)
      if (live(j))
        *reinterpret_cast<float2*>(g.out + at(j)) = *reinterpret_cast<const float2*>(stage + j);
  } else {
    for (int j = tid; j < n; j += nt)
      if (live(j)) g.out[at(j)] = stage[j];
  }
}

template <int K>
cudaError_t launch(const Args& g, size_t smem, cudaStream_t stream) {
  const int nt = ((g.slots + K - 1) / K + 31) / 32 * 32;
  auto kernel = gather_kernel<K>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  // the kernel's shared-memory limit as set on each device
  static size_t allowed[kMaxDevices] = {};
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > kDefaultShared && smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  // a block a frame, the grid padded to whole clusters
  kernel<<<(g.BT + kCluster - 1) / kCluster * kCluster, nt, smem, stream>>>(g);
  return cudaGetLastError();
}

// K, the slots a thread: the least of these that needs at most 1024
// threads (7 at the probe's shape)
cudaError_t dispatch(const Args& g, size_t smem, cudaStream_t stream) {
  if (g.R < 1 || g.R > (int)kIdxMask - 1 || g.BT < 1 || g.iters < 0 || smem > kMaxShared)
    return cudaErrorInvalidValue;
  const int per = (g.slots + kMaxThreads - 1) / kMaxThreads;
  if (per <= 1) return launch<1>(g, smem, stream);
  if (per <= 2) return launch<2>(g, smem, stream);
  if (per <= 4) return launch<4>(g, smem, stream);
  if (per <= 7) return launch<7>(g, smem, stream);
  if (per <= 10) return launch<10>(g, smem, stream);
  if (per <= 14) return launch<14>(g, smem, stream);
  if (per <= kMaxSlots) return launch<kMaxSlots>(g, smem, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int micro_flat_gather(const float* x, float* out, const int* perm, int R, int BT,
                                 int iters, void* stream) {
  const Args g{x, out, perm, nullptr, nullptr, R, 0, 1, BT, iters, kFlat, R};
  return dispatch(g, gather_smem(R, 0), static_cast<cudaStream_t>(stream));
}

extern "C" int micro_row_moves(const float* x, float* out, const int* pi, const int* perms,
                               int E, int Q, int BT, int iters, void* stream) {
  const long long R = (long long)E * Q;
  if (E < 1 || Q < 1 || R > kIdxMask) return cudaErrorInvalidValue;
  const bool paired = Q == 16;         // two edges a warp, paired by parity
  const Args g{x, out, nullptr, pi, perms, (int)R, E, Q, BT, iters,
               paired ? kRowsPaired : kRows, paired ? 32 * ((E + 1) / 2) : (int)R};
  return dispatch(g, gather_smem(R, E), static_cast<cudaStream_t>(stream));
}
