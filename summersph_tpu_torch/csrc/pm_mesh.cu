// The PM mesh's force gradient for Hopper (sm_90a): F = -grad phi by
// 4th-order central differences on the n^3 cells that the mesh keeps
// (ops/pm_gravity.py fd4_gradient; the wrapper is fd4_gradient_cuda there).
//
// It replaces no TPU kernel.  The JAX package's `_fd4_gradient`
// (summersph_tpu/ops/pm_gravity.py) is plain jnp: 12 rolls of the whole
// zero-padded (2n)^3 potential, cropped to n^3 afterwards.  The port did
// the same with torch.roll and elementwise passes, ~40 launches that wrote
// every intermediate as a (2n)^3 cube: 18.9 ms a solve at grid 256 on an
// H100 80GB HBM3, 59% of a self-gravitating disc's step.
//
// Output j on an axis reads phi[(j + lead + t) mod L], t = -2, -1, 1, 2,
// and on the other two axes phi[j + lead]:
//   - the padded cube of the fd path: L = 2n, lead 0; the reads at j = 0, 1
//     wrap to planes 2n-2 and 2n-1, the padded half of the circulant
//     potential, which holds correct open-space values;
//   - the pencil solve's ghost-ringed cube: L = n + 4, lead 2.
// The result is written as [n, n, n, 3], the layout the CIC gather reads.
//
// The arithmetic is the plain version's, in its order, each step rounded
// as written (no FMA contraction):
//   -((((-phi[j+2] + 8 phi[j+1]) - 8 phi[j-1]) + phi[j-2]) / (12 cell))
// with 12 cell rounded in the working type and `cell` read on the card
// (a solve never waits for the host).  So the kernel equals
// fd4_gradient_plain bit for bit.
//
// The work is bytes: the n^3 cells and the 12 n^2 ring cells the stencil
// reads, and 3 n^3 values written: 0.27 GB at grid 256 in float32, 0.081
// ms at 3.35 TB/s (grid 128: 0.011 ms).  A block takes a tile of 32 x 32
// (y, z) columns and marches along x through a chunk of planes:
//   - each thread keeps the 5-plane x window of its 4 columns in
//     registers, loading one new plane a step;
//   - each plane's tile, with a 2-cell ring in y and z, is staged in
//     shared memory (double-buffered, one barrier a plane) for the y and z
//     differences: the centre from the registers, the ring (272 of 1,296
//     cells) from device memory, so each value is read ~1.27 times plus
//     the 4 planes a chunk warms up with;
//   - a warp owns a y row of the tile; its 3 x 32 results go through
//     shared memory so that each store covers 32 neighbouring addresses.
//
// Every entry point takes float32 or float64 (dbl), launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 32;            // (y, z) columns of a block's tile side
constexpr int NT = 256;             // threads: 32 along z by 8 along y
constexpr int NW = NT / 32;
constexpr int RY = TILE / NW;       // y rows a thread keeps
constexpr int S = TILE + 4;         // the staged plane's side, ring included
constexpr int RING = S * S - TILE * TILE;
constexpr int HALO = (RING + NT - 1) / NT;   // ring cells a thread loads

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

// -(((-p2 + 8 p1) - 8 m1) + m2) / c12, in that order, each step rounded
template <typename T>
__device__ __forceinline__ T fd4(T p2, T p1, T m1, T m2, T c12) {
  const T d = add_rn(sub_rn(add_rn(-p2, mul_rn(T(8), p1)), mul_rn(T(8), m1)),
                     m2);
  return -div_rn(d, c12);
}

// The staged plane's ring cell h (0 <= h < RING) as (sy, sz): two rows
// above and two below the tile across its whole width, then two columns
// left and two right of its rows.
__device__ __forceinline__ void ring_cell(int h, int& sy, int& sz) {
  if (h < 4 * S) {
    const int row = h / S;
    sy = row < 2 ? row : TILE + row;
    sz = h % S;
  } else {
    const int k = h - 4 * S, col = k & 3;
    sy = 2 + (k >> 2);
    sz = col < 2 ? col : TILE + col;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
fd4_gradient_kernel(const T* __restrict__ phi, const T* __restrict__ cell,
                    T* __restrict__ out, int L, int lead, int n, int xc) {
  __shared__ T plane[2][S][S];
  __shared__ T stage[NW][3 * TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int z0 = blockIdx.x * TILE, y0 = blockIdx.y * TILE;
  const int xa = blockIdx.z * xc, xb = min(xa + xc, n);
  const long long LL = (long long)L * L;
  const T c12 = mul_rn(T(12), __ldg(cell));
  // i in [-2, n + 2) -> its plane, row or column of phi
  auto wrap = [&](int i) { return (i + lead + L) % L; };

  long long col[RY];      // the thread's columns' offsets in a plane
  for (int r = 0; r < RY; ++r)
    col[r] = (long long)wrap(y0 + warp + NW * r) * L + wrap(z0 + lane);
  int hs[HALO];           // ring cells: shared index, offset in a plane
  long long hg[HALO];
  for (int k = 0; k < HALO; ++k) {
    const int h = threadIdx.x + k * NT;
    int sy = 0, sz = 0;
    if (h < RING) ring_cell(h, sy, sz);
    hs[k] = h < RING ? sy * S + sz : -1;
    hg[k] = (long long)wrap(y0 + sy - 2) * L + wrap(z0 + sz - 2);
  }

  T w[RY][5];             // phi at x - 2 .. x + 2 of each column
  for (int t = -2; t < 2; ++t) {
    const T* pl = phi + wrap(xa + t) * LL;
    for (int r = 0; r < RY; ++r) w[r][t + 3] = __ldg(pl + col[r]);
  }

  for (int x = xa; x < xb; ++x) {
    T* s = &plane[(x - xa) & 1][0][0];
    const T* ahead = phi + wrap(x + 2) * LL;
    const T* here = phi + wrap(x) * LL;
    for (int r = 0; r < RY; ++r) {
      for (int t = 0; t < 4; ++t) w[r][t] = w[r][t + 1];
      w[r][4] = __ldg(ahead + col[r]);
    }
    for (int k = 0; k < HALO; ++k)
      if (hs[k] >= 0) s[hs[k]] = __ldg(here + hg[k]);
    for (int r = 0; r < RY; ++r)
      s[(2 + warp + NW * r) * S + 2 + lane] = w[r][2];
    __syncthreads();

    const int valid = min(TILE, n - z0);
    for (int r = 0; r < RY; ++r) {
      const int y = y0 + warp + NW * r;
      const T* c = s + (2 + warp + NW * r) * S + 2 + lane;
      T* st = stage[warp];
      st[3 * lane] = fd4(w[r][4], w[r][3], w[r][1], w[r][0], c12);
      st[3 * lane + 1] = fd4(c[2 * S], c[S], c[-S], c[-2 * S], c12);
      st[3 * lane + 2] = fd4(c[2], c[1], c[-1], c[-2], c12);
      __syncwarp();
      if (y < n) {
        T* o = out + (((long long)x * n + y) * n + z0) * 3;
        for (int k = 0; k < 3; ++k) {
          const int e = lane + 32 * k;
          if (e < 3 * valid) o[e] = st[e];
        }
      }
      __syncwarp();
    }
  }
}

// Planes a block marches through: 32, halved (down to 8) while the grid
// has fewer than 512 blocks, so that a small mesh still fills the card.
int x_chunk(int n) {
  const int tiles = ((n + TILE - 1) / TILE) * ((n + TILE - 1) / TILE);
  int xc = 32;
  while (xc > 8 && tiles * ((n + xc - 1) / xc) < 512) xc /= 2;
  return xc;
}

template <typename T>
cudaError_t launch_fd4(const void* phi, const void* cell, void* out, int L,
                       int lead, int n, void* stream) {
  const int xc = x_chunk(n);
  const dim3 grid((n + TILE - 1) / TILE, (n + TILE - 1) / TILE,
                  (n + xc - 1) / xc);
  fd4_gradient_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(
      (const T*)phi, (const T*)cell, (T*)out, L, lead, n, xc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fd4_gradient(const void* phi, const void* cell, void* out, int L,
                 int lead, int n, int dbl, void* stream) {
  return dbl ? launch_fd4<double>(phi, cell, out, L, lead, n, stream)
             : launch_fd4<float>(phi, cell, out, L, lead, n, stream);
}

}  // extern "C"
