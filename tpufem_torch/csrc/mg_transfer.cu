// Fused V-cycle transfers of the constant-coefficient 3D multigrid, on the
// embedded layout (node (z, y, x) at store (z+1, y+1, x+1); x rows of 128).
//
// K3 replaces tpufem/ops/mg_transfer_pallas.py::_kern_rr:
//     rc = mask_c(sample2(W (r - A e)))
// K4 replaces tpufem/ops/mg_transfer_pallas.py::_kern_pas:
//     e' = e + mask(W inject2(ec));  y = e' + omega D^-1 (r - A e')
//     (optionally <r, y>)
// A is the constant-weight stencil gated by the row-type code plane
// (0 padding, 1 interior, 2 Dirichlet identity); W = I + 1/2 adjacency of
// the Kuhn split; coarse node i sits on fine node 2i, i.e. coarse store
// index s <-> fine store index 2s - 1 on every axis.
//
// Bound on the card: bytes.  K4 reads code, r, e on the fine level and ec
// (1/8 the size) and writes y; K3 reads code, r, e on the fine level and
// code_c, and writes rc.  At 384 -> 192 (fine store 392 x 392 x 512,
// fp32, beyond the 50 MB L2) that is 1.30 GB, 0.388 ms at 3.35 TB/s, for
// K4 and 1.03 GB, 0.306 ms, for K3; at 96 -> 48 0.0071 and 0.0059 ms.
// Every tap of the 15-point stencil reaches one step on each axis.
//
// The first design ran one thread per output row, every neighbour read
// from device memory through L1: 0.1135 ms (K4) and 0.0552 ms (K3) at
// 96 -> 48, 5.62 and 1.99 ms at 384 -> 192 (fp32, NVIDIA H100 80GB HBM3 at
// 700 W, scripts/kernel_ab.py).  It was bound by load issue, not bytes:
// K4 rebuilt each neighbour's e' = e + P ec from scratch, 15 times over
// (about 62 loads through L1 per output), and K3 ran one thread per coarse
// store row, so that at 96 -> 48 three in four threads exited at once and
// the rest ran 15 residuals of 15 taps each, 450 dependent loads.
//
// The tiled design keeps the TPU kernels' intermediates on chip again, in
// shared memory.  A block owns a tile of 128 fine store columns (K4: its
// own columns; K3: 64 coarse columns, whose fine footprint is the same 128
// plus halo) by TY rows, and marches over a range of TZ planes:
//   * e, code and r arrive plane by plane with 16-byte cp.async (element
//     by element where a pointer is not 16-byte aligned), one plane ahead
//     of their use, each thread's chunks planned once per block; outside
//     the store grid they read 0 (padding), which the taps of an interior
//     row never reach;
//   * each element is formed once into a ring of three masked planes:
//     m = code == 1 ? e' : 0 (K4, e' = e + P ec, ec read through L1) or
//     code == 1 ? e : 0 (K3), the value every tap of A reads; K4 keeps the
//     core's e' beside it for its own row's update;
//   * A's 15 taps then run from shared memory, at offsets fixed at compile
//     time (the Kuhn stencil's steps, which the launcher checks);
//   * K3 writes the fine residual r - A e once per element of its tile and
//     halo into a ring of residual planes, aligned to the coarse lattice
//     (coarse node (Z, Y, X) at fine (2Z - 1, 2Y - 1, 2X - 1)) so that
//     each coarse output's 3 x 3 x 3 neighbourhood under W lies in the
//     block; the threads owning the coarse rows sum the centre and the 14
//     adjacency terms.  Every coarse store row is written once, interior
//     rows their sum, the rest 0 (a block that holds no coarse node only
//     writes zeros), so K3 needs no memset and no idle threads;
//   * TY is a template parameter, so that a thread's rows (every second
//     one of a column) unroll, their loads issuing together.
// Each output keeps the first design's operations and order: K4 e + (0.5
// a + 0.5 b), the taps in offset order, then the update; K3 each
// residual's taps in offset order, then the centre and the 14 halved terms
// in the reference's order.  The fields equal the first design's bit for
// bit; K4's dot sums other blocks (per-block fp64 partials, then a
// fixed-order pass: reproducible from run to run).
//
// Shared memory, registers (-Xptxas -v, no spills) and blocks per SM at
// the tiles transfer_tiling picks (ops/mg_transfer_cuda.py; it computes
// the same bytes as rr_smem / pas_smem here, tpufem_mg_transfer_smem):
//   K4, fp32, TY = 8 (both shapes): 59,904 B, 80 registers, 3 blocks;
//   K4, fp64, TY = 4: 67,072 B, 72 registers, 3 blocks;
//   K3, fp32, TY = 4 (both shapes): 72,256 B, 78 registers, 3 blocks;
//   K3, fp64, TY = 3: 113,792 B, 79 registers, 2 blocks (shared memory).
// Above 48 KB the launcher raises the kernel's dynamic shared memory limit;
// a refused launch returns its error.  At 96 -> 48 the picked tiles leave
// 338 (K4) and 325 (K3, working) blocks, fewer than the 396 an H100 holds
// at once; at 384 -> 192, 2548 and 2548.  What bounds them now is the
// per-plane work of a block (staging, the prolongation, the taps and the
// barriers), not bytes: scripts/mg_transfer_ablation.py, PERF.md.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kOffsets = 15;
constexpr int kThreads = tpufem::kBlock;
constexpr int kTileX = 128;               // fine store columns of a tile
constexpr int kCoarseX = kTileX / 2;      // K3: coarse columns of a tile
constexpr int kMaxDevices = 64;

// The 3D Kuhn stencil's grid steps (dz, dy, dx) in the embedded plan's
// offset order (flat offsets ascending, i.e. lexicographic steps).  The
// taps' shared-memory offsets are compile-time constants; the launcher
// checks the level's steps against this table.
__host__ __device__ constexpr int kuhn_step(int k, int axis) {
  constexpr int steps[kOffsets][3] = {
      {-1, -1, -1}, {-1, -1, 0}, {-1, 0, -1}, {-1, 0, 0}, {0, -1, -1},
      {0, -1, 0},   {0, 0, -1},  {0, 0, 0},   {0, 0, 1},  {0, 1, 0},
      {0, 1, 1},    {1, 0, 0},   {1, 0, 1},   {1, 1, 0},  {1, 1, 1}};
  return steps[k][axis];
}

// Kuhn-split adjacency (tpufem/ops/mg_transfer_pallas.py
// _adjacency_offsets_3d), in the order the reference sums it.
__host__ __device__ constexpr int kuhn_adj(int j, int axis) {
  constexpr int adj[14][3] = {
      {-1, 0, 0},  {1, 0, 0},  {0, -1, 0},  {0, 1, 0},   {0, 0, -1},
      {0, 0, 1},   {-1, -1, 0}, {1, 1, 0},  {-1, 0, -1}, {1, 0, 1},
      {0, -1, -1}, {0, 1, 1},  {-1, -1, -1}, {1, 1, 1}};
  return adj[j][axis];
}

// The level's weights, 1 / w0 and omega in the vector type (rounded on
// the host as the device would round them), passed by value.
template <typename T>
struct ConstOp {
  T w[kOffsets];
  T inv_w0;
  T omega;
};

struct Dims {
  int f0, f1, f2;  // fine store grid
  int c0, c1, c2;  // coarse store grid
  int n0, n1, n2;  // coarse node grid
};

// A block stages positions [0, hi) on each axis; 0 outside.
struct Box {
  int z1, y1, x1;
};

// Values a 16-byte chunk holds.
template <typename T>
__host__ __device__ constexpr int chunk() {
  return 16 / static_cast<int>(sizeof(T));
}

// Raw and masked plane rows: K4 stages its 128 columns and one 16-byte
// chunk either side (for the halo column); K3 the fine columns
// 2 X0 - 4 .. 2 X0 + 127 of its 64 coarse columns from X0.
template <typename T>
__host__ __device__ constexpr int pas_row() {
  return kTileX + 2 * chunk<T>();
}
constexpr int kRrRow = kTileX + 4;
constexpr int kResRow = kTileX + 2;  // residual columns 2 X0 - 2 + (0..128)

// K4: code 3 planes, e 2, r 2 (core rows), masked 3, e' 2 (core rows).
template <typename T>
size_t pas_smem(int ty) {
  return (8 * static_cast<size_t>(ty + 2) * pas_row<T>() +
          4 * static_cast<size_t>(ty) * kTileX) *
         sizeof(T);
}

// K3: e and code 2 planes each, masked 3 (2 ty + 3 rows), r 2 (2 ty + 1
// rows), code_c 1 (ty coarse rows of 64), residual 4 planes, then the
// interior flags of 2 residual planes (bytes).
template <typename T>
size_t rr_smem(int ty) {
  const size_t er = 2 * ty + 3, qr = 2 * ty + 1;
  const size_t flags = (2 * qr * kResRow + 15) / 16 * 16;
  return (7 * er * kRrRow + 2 * qr * kRrRow + ty * kCoarseX +
          4 * qr * kResRow) *
             sizeof(T) +
         flags;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of BYTES (4, 8 or 16) into shared memory; src_bytes 0 fills
// zeros and reads nothing.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copy rows [y_lo, y_lo + rows) x columns [x_lo, x_lo + W) of store
// plane z into dst (row stride W) element by element, 0 outside the box:
// the staging of a tile whose source is not 16-byte aligned.
template <typename T, int W>
__device__ __forceinline__ void stage_elements(T* dst,
                                               const T* __restrict__ src,
                                               int z, int y_lo, int rows,
                                               int x_lo, const Box& box,
                                               int f1, int f2) {
  const bool zok = z >= 0 && z < box.z1;
  for (int i = threadIdx.x; i < rows * W; i += kThreads) {
    const int row = i / W, col = i - row * W;
    const int y = y_lo + row, x = x_lo + col;
    const bool ok = zok && y >= 0 && y < box.y1 && x >= 0 && x < box.x1;
    const T* s = ok ? src + (static_cast<long long>(z) * f1 + y) * f2 + x
                    : src;
    cp_async<sizeof(T)>(dst + i, s, ok ? static_cast<int>(sizeof(T)) : 0);
  }
}

// A thread's share of a tile staged plane after plane (ROWS rows of W
// values from row y_lo, column x_lo; x_lo and W whole 16-byte chunks):
// each chunk's offset in the tile and in a store plane, and whether it
// lies in the box's rows and columns.  Planned once per block, so that a
// plane's copy costs each thread a few instructions per chunk.
template <typename T, int W, int ROWS>
struct Stage {
  static constexpr int kChunks = ROWS * (W / chunk<T>());
  static constexpr int kN = (kChunks + kThreads - 1) / kThreads;
  int tile[kN];   // -1: no chunk
  int plane[kN];
  bool ok[kN];

  __device__ __forceinline__ Stage(int y_lo, int x_lo, const Box& box,
                                   int f2) {
    constexpr int H = chunk<T>(), NC = W / H;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int i = threadIdx.x + n * kThreads;
      const int row = i / NC, ch = i - row * NC;
      const int y = y_lo + row, x = x_lo + ch * H;
      tile[n] = i < kChunks ? row * W + ch * H : -1;
      ok[n] = y >= 0 && y < box.y1 && x >= 0 && x < box.x1;
      plane[n] = ok[n] ? y * f2 + x : 0;
    }
  }

  // Copy store plane z of src into dst, 0 outside the box; a chunk that
  // starts inside the box is copied whole (the store rows are whole
  // chunks).  Element by element where a pointer is not 16-byte aligned
  // (vec false).
  __device__ __forceinline__ void issue(T* dst, const T* __restrict__ src,
                                        int z, const Box& box, int f1,
                                        int f2, int y_lo, int x_lo,
                                        bool vec) const {
    if (!vec) {
      stage_elements<T, W>(dst, src, z, y_lo, ROWS, x_lo, box, f1, f2);
      return;
    }
    const bool zok = z >= 0 && z < box.z1;
    const T* base = zok ? src + static_cast<long long>(z) * f1 * f2 : src;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      if (tile[n] < 0) continue;
      const bool in = zok && ok[n];
      cp_async<16>(dst + tile[n], in ? base + plane[n] : src, in ? 16 : 0);
    }
  }
};

// A_const's interior row from a ring of three masked planes (the row's
// plane and its neighbours below and above), the taps in offset order.
template <typename T, int W>
__device__ __forceinline__ T taps(const T* below, const T* mid,
                                  const T* above, int j,
                                  const ConstOp<T>& op) {
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kOffsets; ++k) {
    const int dz = kuhn_step(k, 0);
    const T* pl = dz < 0 ? below : (dz > 0 ? above : mid);
    acc += op.w[k] * pl[j + kuhn_step(k, 1) * W + kuhn_step(k, 2)];
  }
  return acc;
}

// Rows of a K3 / K4 tile the launchers instantiate (the tile rows are a
// template parameter, so that each thread's rows unroll and their loads
// issue together): the rows transfer_tiling picks, and one that divides
// no store grid (K4 6, K3 3) for the tests of ragged tiles.
#define TPUFEM_RR_ROWS(X) X(2) X(3) X(4)
#define TPUFEM_PAS_ROWS(X) X(4) X(6) X(8)

template <typename T, int TY>
__global__ void __launch_bounds__(kThreads, 3)
residual_restrict_kernel(const T* __restrict__ code_f,
                         const T* __restrict__ code_c,
                         const T* __restrict__ r, const T* __restrict__ e,
                         T* __restrict__ rc, Dims g, ConstOp<T> op, int tz,
                         bool vec) {
  constexpr int RW = kRrRow;
  constexpr int ER = 2 * TY + 3;        // e rows: fine 2 Y0 - 3 ..
  constexpr int QR = 2 * TY + 1;        // residual rows: fine 2 Y0 - 2 ..
  constexpr int PS = ER * RW, QS = QR * kResRow, RS = QR * RW;
  constexpr int CC = TY * kCoarseX;
  constexpr int NR = (QR + 1) / 2;      // residual rows of a thread
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw_e = reinterpret_cast<T*>(smem);          // 2 planes
  T* raw_c = raw_e + 2 * PS;                      // 2
  T* rs = raw_c + 2 * PS;                         // 2 of QR x RW
  T* ccs = rs + 2 * RS;                           // TY x 64 coarse codes
  T* ring = ccs + CC;                             // 3 masked planes
  T* res = ring + 3 * PS;                         // 4 residual planes
  unsigned char* flag = reinterpret_cast<unsigned char*>(res + 4 * QS);

  const int X0 = blockIdx.x * kCoarseX, Y0 = blockIdx.y * TY;
  const int Zs = blockIdx.z * tz, Ze = min(Zs + tz, g.c0);
  // coarse planes that may hold an interior row: node planes 1..n0
  const int Za = max(Zs, 1), Zb = min(Ze, g.n0 + 1);
  const bool active = Za < Zb && Y0 <= g.n1 && Y0 + TY > 1 &&
                      X0 <= g.n2 && X0 + kCoarseX > 1;
  for (int Z = Zs; Z < Ze; ++Z) {
    if (active && Z >= Za && Z < Zb) continue;
    for (int i = threadIdx.x; i < CC; i += kThreads) {
      const int row = i / kCoarseX, Y = Y0 + row;
      if (Y >= g.c1) break;
      rc[(static_cast<long long>(Z) * g.c1 + Y) * g.c2 + X0 +
         (i - row * kCoarseX)] = T(0);
    }
  }
  if (!active) return;

  // the fine positions the coarse nodes reach: e at -1 .. 2n + 1
  const Box box{min(g.f0, 2 * g.n0 + 2), min(g.f1, 2 * g.n1 + 2),
                min(g.f2, 2 * g.n2 + 2)};
  const Box cbox{g.c0, g.c1, g.c2};
  const int ey0 = 2 * Y0 - 3, ex0 = 2 * X0 - 4;
  const int col = threadIdx.x & (kTileX - 1), rg = threadIdx.x / kTileX;
  const int lastres = 2 * Zb - 2;             // residual planes up to it
  // plane p = P0 + i is formed at step i, the residual of plane p - 1
  // taken at the same step, and coarse plane Z summed at the step that
  // takes the residual of fine plane 2Z; r of plane p and the coarse codes
  // of plane p / 2 are staged a step ahead of their use
  const int P0 = 2 * Za - 3, np = 2 * (Zb - Za) + 3;
  const Stage<T, RW, ER> se(ey0, ex0, box, g.f2);
  const Stage<T, RW, QR> sr(ey0 + 1, ex0, box, g.f2);
  const Stage<T, kCoarseX, TY> sc(Y0, X0, cbox, g.c2);
  auto stage = [&](int i) {
    const int p = P0 + i;
    if (i + 1 < np) {
      se.issue(raw_e + ((i + 1) & 1) * PS, e, p + 1, box, g.f1, g.f2, ey0,
               ex0, vec);
      se.issue(raw_c + ((i + 1) & 1) * PS, code_f, p + 1, box, g.f1, g.f2,
               ey0, ex0, vec);
    }
    if (p >= 2 * Za - 2 && p <= lastres) {
      sr.issue(rs + (i & 1) * RS, r, p, box, g.f1, g.f2, ey0 + 1, ex0, vec);
      if (!(p & 1) && p >= 2 * Za)
        sc.issue(ccs, code_c, p >> 1, cbox, g.c1, g.c2, Y0, X0, vec);
    }
    cp_async_commit();
  };
  const int xx = 2 * X0 - 2 + col;
  const bool xin = xx >= 0 && xx <= 2 * g.n2;
  const bool xlast = 2 * X0 + kTileX - 2 <= 2 * g.n2;  // residual column 128
  se.issue(raw_e, e, P0, box, g.f1, g.f2, ey0, ex0, vec);
  se.issue(raw_c, code_f, P0, box, g.f1, g.f2, ey0, ex0, vec);
  cp_async_commit();
  for (int i = 0; i < np; ++i) {
    const int p = P0 + i;
    cp_async_wait_all();
    __syncthreads();
    stage(i);
    {
      // masked plane: m = code == 1 ? e : 0, 16 bytes at a time
      constexpr int H = chunk<T>();
      struct alignas(16) V { T v[H]; };
      const V* ce = reinterpret_cast<const V*>(raw_e + (i & 1) * PS);
      const V* cc = reinterpret_cast<const V*>(raw_c + (i & 1) * PS);
      V* m = reinterpret_cast<V*>(ring + (i % 3) * PS);
      for (int k = threadIdx.x; k < PS / H; k += kThreads) {
        const V a = ce[k], c = cc[k];
        V out;
#pragma unroll
        for (int h = 0; h < H; ++h) out.v[h] = c.v[h] == T(1) ? a.v[h] : T(0);
        m[k] = out;
      }
      // each residual position's own row type: interior flag, and the
      // Dirichlet identity's e (0 on padding)
      const T* pe = raw_e + (i & 1) * PS;
      const T* pc = raw_c + (i & 1) * PS;
      T* q = res + (i & 3) * QS;
      unsigned char* f = flag + (i & 1) * QS;
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int row = rg + 2 * k;
        if (row < QR) {
          const int j = (row + 1) * RW + col + 2;
          const T c = pc[j];
          q[row * kResRow + col] = c == T(2) ? pe[j] : T(0);
          f[row * kResRow + col] = c == T(1);
        }
      }
      if (threadIdx.x < QR) {
        const int row = threadIdx.x, j = (row + 1) * RW + kTileX + 2;
        const T c = pc[j];
        q[row * kResRow + kTileX] = c == T(2) ? pe[j] : T(0);
        f[row * kResRow + kTileX] = c == T(1);
      }
    }
    __syncthreads();
    if (i < 2) continue;
    const int a = p - 1;                       // residual plane
    {
      const T* below = ring + ((i + 1) % 3) * PS;
      const T* mid = ring + ((i + 2) % 3) * PS;
      const T* above = ring + (i % 3) * PS;
      const T* rr = rs + ((i + 1) & 1) * RS;
      const unsigned char* f = flag + ((i + 1) & 1) * QS;
      T* q = res + ((i + 3) & 3) * QS;
      // every row's loads first, then the stores (they share the planes)
      T v[NR];
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int row = rg + 2 * k;
        if (row < QR) {
          const int yy = 2 * Y0 - 2 + row;
          const int j = (row + 1) * RW + col + 2, jq = row * kResRow + col;
          const T t = taps<T, RW>(below, mid, above, j, op);
          const T ax = f[jq] ? t : q[jq];
          v[k] = xin && yy >= 0 && yy <= 2 * g.n1 ? rr[row * RW + col + 2] - ax
                                                 : T(0);
        }
      }
      T vl = T(0);
      if (threadIdx.x < QR) {
        const int row = threadIdx.x, yy = 2 * Y0 - 2 + row;
        const int j = (row + 1) * RW + kTileX + 2;
        const int jq = row * kResRow + kTileX;
        const T t = taps<T, RW>(below, mid, above, j, op);
        const T ax = f[jq] ? t : q[jq];
        if (xlast && yy >= 0 && yy <= 2 * g.n1)
          vl = rr[row * RW + kTileX + 2] - ax;
      }
#pragma unroll
      for (int k = 0; k < NR; ++k) {
        const int row = rg + 2 * k;
        if (row < QR) q[row * kResRow + col] = v[k];
      }
      if (threadIdx.x < QR) q[threadIdx.x * kResRow + kTileX] = vl;
    }
    if ((a & 1) || a < 2 * Za) continue;
    __syncthreads();
    const int Z = a >> 1;
    const T* qm = res + ((i + 1) & 3) * QS;  // fine plane 2Z - 2
    const T* q0 = res + ((i + 2) & 3) * QS;  // 2Z - 1
    const T* qp = res + ((i + 3) & 3) * QS;  // 2Z
#pragma unroll
    for (int k0 = 0; k0 < CC; k0 += kThreads) {
      const int k = k0 + threadIdx.x;
      const int row = k / kCoarseX, cx = k - row * kCoarseX;
      const int Y = Y0 + row, X = X0 + cx;
      if (k < CC && Y < g.c1) {
        T acc = T(0);
        if (ccs[k] == T(1) && Y >= 1 && Y <= g.n1 && X >= 1 && X <= g.n2) {
          const int jc = (2 * row + 1) * kResRow + 2 * cx + 1;
          acc = q0[jc];
#pragma unroll
          for (int t = 0; t < 14; ++t) {
            const int dz = kuhn_adj(t, 0);
            const T* pl = dz < 0 ? qm : (dz > 0 ? qp : q0);
            acc += T(0.5) *
                   pl[jc + kuhn_adj(t, 1) * kResRow + kuhn_adj(t, 2)];
          }
        }
        rc[(static_cast<long long>(Z) * g.c1 + Y) * g.c2 + X] = acc;
      }
    }
  }
}

// One axis of the prolongation at fine coordinate v: the coarse
// coordinates of the two nodes P averages (the same one on an odd v, a
// coarse node), and whether each is a node (n nodes).  With all three
// axes odd the fine node is a coarse node; otherwise the even axes give
// one of the 7 Kuhn adjacency directions, and the node is the midpoint of
// the coarse nodes one step either way along it.
struct Axis {
  int lo, hi;
  bool ok_lo, ok_hi, odd;
};

__device__ __forceinline__ Axis axis(int v, int n) {
  const bool odd = v & 1;
  const int d = odd ? 0 : 1;
  const int lo = (v - d + 1) >> 1, hi = (v + d + 1) >> 1;
  return Axis{lo, hi, v - d >= 0 && lo <= n, v + d >= 0 && hi <= n, odd};
}

// (W inject2(ec)) at a fine position from its three axes: ec at a coarse
// node, else 0.5 ec(lo) + 0.5 ec(hi), a coarse value outside the nodes
// reading 0.  ecb is ec from the block's first coarse plane, row and
// column (zb, yb, xb), so that offsets are 32-bit; both loads issue
// unconditionally (from a clamped offset).
template <typename T>
__device__ __forceinline__ T prolonged(const T* __restrict__ ecb,
                                       const Axis& az, const Axis& ay,
                                       const Axis& ax, int zb, int yb, int xb,
                                       const Dims& g) {
  const bool ok_lo = az.ok_lo && ay.ok_lo && ax.ok_lo;
  const bool ok_hi = az.ok_hi && ay.ok_hi && ax.ok_hi;
  const T a = __ldg(ecb + (ok_lo ? ((az.lo - zb) * g.c1 + ay.lo - yb) * g.c2 +
                                       ax.lo - xb
                                 : 0));
  const T b = __ldg(ecb + (ok_hi ? ((az.hi - zb) * g.c1 + ay.hi - yb) * g.c2 +
                                       ax.hi - xb
                                 : 0));
  const T vlo = ok_lo ? a : T(0);
  if (az.odd && ay.odd && ax.odd) return vlo;
  return T(0.5) * vlo + T(0.5) * (ok_hi ? b : T(0));
}

template <typename T, int TY>
__global__ void __launch_bounds__(kThreads, 3)
prolong_add_smooth_kernel(const T* __restrict__ code_f,
                          const T* __restrict__ ec, const T* __restrict__ r,
                          const T* __restrict__ e, T* __restrict__ y,
                          double* __restrict__ partials, Dims g,
                          ConstOp<T> op, int tz, bool vec) {
  constexpr int H = chunk<T>();
  constexpr int RW = pas_row<T>();
  constexpr int PS = (TY + 2) * RW, CS = TY * kTileX;
  constexpr int NF = (TY + 2) / 2, NO = TY / 2;   // a thread's rows
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw_c = reinterpret_cast<T*>(smem);   // 3 planes
  T* raw_e = raw_c + 3 * PS;               // 2
  T* rs = raw_e + 2 * PS;                  // 2 core planes of r
  T* ring = rs + 2 * CS;                   // 3 masked planes
  T* epc = ring + 3 * PS;                  // 2 core planes of e'

  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * TY;
  const int z0 = blockIdx.z * tz, z1 = min(z0 + tz, g.f0);
  const Box box{g.f0, g.f1, g.f2};
  const int col = threadIdx.x & (kTileX - 1), rg = threadIdx.x / kTileX;
  const Axis xa = axis(x0 + col, g.n2);
  // the coarse nodes the block's prolongation reaches start at plane
  // z0 / 2, row (y0 - 1) / 2 and column x0 / 2 - 1 (clamped to the grid)
  const int zb = min(z0 >> 1, g.c0 - 1);
  const int yb = min(max((y0 - 1) >> 1, 0), g.c1 - 1);
  const int xb = min(max(x0 / 2 - 1, 0), g.c2 - 1);
  const T* ecb = ec + (static_cast<long long>(zb) * g.c1 + yb) * g.c2 + xb;
  // plane p = z0 - 1 + i is formed at step i and output plane p - 1
  // written at the same step; r of plane p is staged a step ahead of use
  const int np = z1 - z0 + 2;
  const Stage<T, RW, TY + 2> se(y0 - 1, x0 - H, box, g.f2);
  const Stage<T, kTileX, TY> sr(y0, x0, box, g.f2);
  auto stage = [&](int i) {
    const int p = z0 - 1 + i;
    if (i + 1 < np) {
      se.issue(raw_e + ((i + 1) & 1) * PS, e, p + 1, box, g.f1, g.f2, y0 - 1,
               x0 - H, vec);
      se.issue(raw_c + ((i + 1) % 3) * PS, code_f, p + 1, box, g.f1, g.f2,
               y0 - 1, x0 - H, vec);
      if (i >= 1)
        sr.issue(rs + (i & 1) * CS, r, p, box, g.f1, g.f2, y0, x0, vec);
    }
    cp_async_commit();
  };
  se.issue(raw_e, e, z0 - 1, box, g.f1, g.f2, y0 - 1, x0 - H, vec);
  se.issue(raw_c, code_f, z0 - 1, box, g.f1, g.f2, y0 - 1, x0 - H, vec);
  cp_async_commit();
  double part = 0.0;
  for (int i = 0; i < np; ++i) {
    const int p = z0 - 1 + i;
    cp_async_wait_all();
    __syncthreads();
    stage(i);
    {
      // e' = e + P ec (P ec only on node rows) once per element; the
      // masked plane keeps it on interior rows, as their neighbours' taps
      // read it, and the core's e' is kept for its own row's update
      const T* ce = raw_e + (i & 1) * PS;
      const T* cc = raw_c + (i % 3) * PS;
      T* m = ring + (i % 3) * PS;
      T* ep = epc + (i & 1) * CS;
      const Axis za = axis(p, g.n0);
      T cv[NF], pv[NF];
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const int row = rg + 2 * k;
        cv[k] = cc[row * RW + col + H];
        pv[k] = prolonged(ecb, za, axis(y0 - 1 + row, g.n1), xa, zb, yb, xb,
                          g);
      }
#pragma unroll
      for (int k = 0; k < NF; ++k) {
        const int row = rg + 2 * k, j = row * RW + col + H;
        const T v = ce[j] + (cv[k] != T(0) ? pv[k] : T(0));
        m[j] = cv[k] == T(1) ? v : T(0);
        if (row >= 1 && row <= TY) ep[(row - 1) * kTileX + col] = v;
      }
      // the halo columns x0 - 1 and x0 + 128
      if (threadIdx.x < 2 * (TY + 2)) {
        const int row = threadIdx.x >> 1;
        const int cx = (threadIdx.x & 1) ? kTileX : -1;
        const int j = row * RW + cx + H;
        const T c = cc[j];
        const T pr = prolonged(ecb, za, axis(y0 - 1 + row, g.n1),
                               axis(x0 + cx, g.n2), zb, yb, xb, g);
        m[j] = c == T(1) ? ce[j] + pr : T(0);
      }
    }
    __syncthreads();
    if (i < 2) continue;
    const int z = p - 1;
    const T* below = ring + ((i + 1) % 3) * PS;
    const T* mid = ring + ((i + 2) % 3) * PS;
    const T* above = ring + (i % 3) * PS;
    const T* cc = raw_c + ((i + 2) % 3) * PS;
    const T* ep = epc + ((i + 1) & 1) * CS;
    const T* rr = rs + ((i + 1) & 1) * CS;
    T* yz = y + static_cast<long long>(z) * g.f1 * g.f2 + x0 + col;
#pragma unroll
    for (int k = 0; k < NO; ++k) {
      const int row = rg + 2 * k, yy = y0 + row;
      const int j = (row + 1) * RW + col + H, jc = row * kTileX + col;
      const T c = cc[j], v = ep[jc], rv = rr[jc];
      const T t = taps<T, RW>(below, mid, above, j, op);
      const T ax = c == T(1) ? t : (c == T(2) ? v : T(0));
      const T invd = c == T(1) ? op.inv_w0 : T(1);
      const T out = v + op.omega * invd * (rv - ax);
      if (yy < g.f1) {
        yz[static_cast<long long>(yy) * g.f2] = out;
        part += static_cast<double>(rv) * static_cast<double>(out);
      }
    }
  }
  if (partials != nullptr) {
    part = tpufem::block_sum<kThreads>(part);
    if (threadIdx.x == 0)
      partials[(static_cast<long long>(blockIdx.z) * gridDim.y +
                blockIdx.y) * gridDim.x + blockIdx.x] = part;
  }
}

template <typename T>
ConstOp<T> make_op(const double* weights, double inv_w0, double omega) {
  ConstOp<T> op;
  for (int i = 0; i < kOffsets; ++i) op.w[i] = static_cast<T>(weights[i]);
  op.inv_w0 = static_cast<T>(inv_w0);
  op.omega = static_cast<T>(omega);
  return op;
}

Dims make_dims(const int* fine_sg, const int* coarse_sg,
               const int* coarse_ng) {
  return Dims{fine_sg[0],   fine_sg[1],   fine_sg[2],
              coarse_sg[0], coarse_sg[1], coarse_sg[2],
              coarse_ng[0], coarse_ng[1], coarse_ng[2]};
}

// A grid the kernels take: 3D, factor-2 coarsening, rows of 128, the Kuhn
// stencil's steps in the plan's order; tiles of at least one row and
// plane.
bool valid(const Dims& g, const int* grid_offsets, int ty, int tz) {
  for (int k = 0; k < kOffsets; ++k)
    for (int a = 0; a < 3; ++a)
      if (grid_offsets[3 * k + a] != kuhn_step(k, a)) return false;
  return ty >= 1 && tz >= 1 && g.f2 % kTileX == 0 && g.c2 % kCoarseX == 0 &&
         2 * g.n0 + 1 < g.f0 && 2 * g.n1 + 1 < g.f1 && 2 * g.n2 + 1 < g.f2 &&
         g.n0 < g.c0 && g.n1 < g.c1 && g.n2 < g.c2;
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15u) == 0;
}

// Raise a kernel's dynamic shared memory limit to `bytes` (once per
// kernel, device and size); 0 or the CUDA error.
template <auto Kernel>
int allow_smem(size_t bytes) {
  static size_t allowed[kMaxDevices] = {};
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && allowed[dev] >= bytes) return 0;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here, not by the next launch
    return static_cast<int>(err);
  }
  if (dev < kMaxDevices) allowed[dev] = bytes;
  return 0;
}

unsigned int ceil_div(int a, int b) {
  return static_cast<unsigned int>((a + b - 1) / b);
}

template <typename T>
int launch_rr(const T* code_f, const T* code_c, const T* r, const T* e, T* rc,
              const int* fine_sg, const int* coarse_sg, const int* coarse_ng,
              const int* grid_offsets, const double* weights, int k, int ty,
              int tz, void* stream) {
  const Dims g = make_dims(fine_sg, coarse_sg, coarse_ng);
  if (k != kOffsets || !valid(g, grid_offsets, ty, tz))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConstOp<T> op = make_op<T>(weights, 0.0, 0.0);
  const size_t smem = rr_smem<T>(ty);
  const dim3 grid(g.c2 / kCoarseX, ceil_div(g.c1, ty), ceil_div(g.c0, tz));
  const bool vec = aligned16({code_f, code_c, r, e});
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (ty) {
#define TPUFEM_CASE(TY)                                                    \
  case TY:                                                                 \
    err = allow_smem<residual_restrict_kernel<T, TY>>(smem);               \
    if (err != 0) return err;                                              \
    residual_restrict_kernel<T, TY><<<grid, kThreads, smem, s>>>(          \
        code_f, code_c, r, e, rc, g, op, tz, vec);                         \
    return static_cast<int>(cudaGetLastError());
    TPUFEM_RR_ROWS(TPUFEM_CASE)
#undef TPUFEM_CASE
  }
  return err;
}

template <typename T>
int launch_pas(const T* code_f, const T* ec, const T* r, const T* e, T* y,
               double* partials, T* dot, const int* fine_sg,
               const int* coarse_sg, const int* coarse_ng,
               const int* grid_offsets, const double* weights, int k,
               double inv_w0, double omega, int ty, int tz, void* stream) {
  const Dims g = make_dims(fine_sg, coarse_sg, coarse_ng);
  if (k != kOffsets || !valid(g, grid_offsets, ty, tz))
    return static_cast<int>(cudaErrorInvalidValue);
  const ConstOp<T> op = make_op<T>(weights, inv_w0, omega);
  const size_t smem = pas_smem<T>(ty);
  const dim3 grid(g.f2 / kTileX, ceil_div(g.f1, ty), ceil_div(g.f0, tz));
  const bool vec = aligned16({code_f, r, e});
  double* part = dot != nullptr ? partials : nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = static_cast<int>(cudaErrorInvalidValue);
  switch (ty) {
#define TPUFEM_CASE(TY)                                                    \
  case TY:                                                                 \
    err = allow_smem<prolong_add_smooth_kernel<T, TY>>(smem);              \
    if (err != 0) return err;                                              \
    prolong_add_smooth_kernel<T, TY><<<grid, kThreads, smem, s>>>(         \
        code_f, ec, r, e, y, part, g, op, tz, vec);                        \
    err = static_cast<int>(cudaGetLastError());                            \
    break;
    TPUFEM_PAS_ROWS(TPUFEM_CASE)
#undef TPUFEM_CASE
  }
  if (err != 0 || dot == nullptr) return err;
  tpufem::finish_dot_kernel<T><<<1, tpufem::kFinishBlock, 0, s>>>(
      partials, static_cast<int>(grid.x * grid.y * grid.z), dot);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// fine_sg / coarse_sg: store grids; coarse_ng: coarse node grid (3 ints
// each).  grid_offsets / weights: the fine level's k = 15 offsets as
// (dz, dy, dx) triples (the Kuhn stencil's, in the plan's order) and their
// weights.  ty, tz: coarse rows and planes of a block's tile
// (transfer_tiling).
int tpufem_residual_restrict_f32(const float* code_f, const float* code_c,
                                 const float* r, const float* e, float* rc,
                                 const int* fine_sg, const int* coarse_sg,
                                 const int* coarse_ng,
                                 const int* grid_offsets,
                                 const double* weights, int k, int ty, int tz,
                                 void* stream) {
  return launch_rr<float>(code_f, code_c, r, e, rc, fine_sg, coarse_sg,
                          coarse_ng, grid_offsets, weights, k, ty,
                          tz, stream);
}

int tpufem_residual_restrict_f64(const double* code_f, const double* code_c,
                                 const double* r, const double* e, double* rc,
                                 const int* fine_sg, const int* coarse_sg,
                                 const int* coarse_ng,
                                 const int* grid_offsets,
                                 const double* weights, int k, int ty, int tz,
                                 void* stream) {
  return launch_rr<double>(code_f, code_c, r, e, rc, fine_sg, coarse_sg,
                           coarse_ng, grid_offsets, weights, k, ty,
                           tz, stream);
}

// ty, tz: fine rows and planes of a block's tile.  partials: fp64 scratch
// of one slot per block (f2 / 128 x ceil(f1 / ty) x ceil(f0 / tz)), used
// when dot != NULL.
int tpufem_prolong_add_smooth_f32(const float* code_f, const float* ec,
                                  const float* r, const float* e, float* y,
                                  double* partials, float* dot,
                                  const int* fine_sg, const int* coarse_sg,
                                  const int* coarse_ng,
                                  const int* grid_offsets,
                                  const double* weights, int k, double inv_w0,
                                  double omega, int ty, int tz,
                                  void* stream) {
  return launch_pas<float>(code_f, ec, r, e, y, partials, dot, fine_sg,
                           coarse_sg, coarse_ng, grid_offsets,
                           weights, k, inv_w0, omega, ty, tz, stream);
}

int tpufem_prolong_add_smooth_f64(const double* code_f, const double* ec,
                                  const double* r, const double* e, double* y,
                                  double* partials, double* dot,
                                  const int* fine_sg, const int* coarse_sg,
                                  const int* coarse_ng,
                                  const int* grid_offsets,
                                  const double* weights, int k, double inv_w0,
                                  double omega, int ty, int tz,
                                  void* stream) {
  return launch_pas<double>(code_f, ec, r, e, y, partials, dot, fine_sg,
                            coarse_sg, coarse_ng, grid_offsets,
                            weights, k, inv_w0, omega, ty, tz, stream);
}

// Dynamic shared memory (bytes) of K3 (kernel 3) or K4 (kernel 4) at
// itemsize 4 or 8 and tile rows ty; -1 for any other kernel or size.
int tpufem_mg_transfer_smem(int kernel, int itemsize, int ty) {
  size_t bytes = 0;
  if (kernel == 3 && itemsize == 4) bytes = rr_smem<float>(ty);
  if (kernel == 3 && itemsize == 8) bytes = rr_smem<double>(ty);
  if (kernel == 4 && itemsize == 4) bytes = pas_smem<float>(ty);
  if (kernel == 4 && itemsize == 8) bytes = pas_smem<double>(ty);
  return bytes > 0 ? static_cast<int>(bytes) : -1;
}

}  // extern "C"
