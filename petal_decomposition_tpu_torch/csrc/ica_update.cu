// K4: one FastICA fixed-point update of a float32 k×k W, with its
// Newton–Schulz symmetric decorrelation and the stop value, in one launch.
//
// Replaces no TPU kernel.  The JAX package runs the update and the
// decorrelation (models/fast_ica.py: _update, symmetric_decorrelation_ns) as
// XLA ops inside its lax.while_loop, where they cost no launches.  The port's
// loop runs on the host, so there the same arithmetic was ≈ 160 kernel
// launches a step: 24 coupled Newton–Schulz steps of three k×k products and
// their elementwise ops, the update and the stop formula.  This kernel is
// those launches as one:
//
//   W_new = gx·p_inv − ((gsum − pad_g0)·p_inv)[:, None]·W
//   A = W_new·W_newᵀ, c = trace(A), Y = A/c, Z = I
//   `iters` times: T = 1.5·I − 0.5·(Z·Y); Y ← Y·T; Z ← T·Z
//   W1 = (Z·W_new)/√c
//   lim = max_i | |row_i(W1)·col_i(W)| − 1 |
//
// in IEEE float32 on the CUDA cores (FFMA; no TF32: the decorrelation's
// orthonormality and the stop value are float32 roundoff-level quantities).
// Every product and step of the host arithmetic is kept; only the order of
// the sums inside a product differs, and the scalar steps are written with
// the _rn intrinsics so that no multiply and add fuse where the host
// arithmetic rounds twice.
//
// What bounds it on this card: neither operations nor bytes.  At k = 64 the
// step is 148·k³ ≈ 39 MFLOP (well under a microsecond of the card's FP32
// rate) over 48 KB of inputs and outputs; the bound is the chain of ≈ 50
// dependent product phases.  The design keeps each phase short: one thread
// block cluster of 8 CTAs on neighbouring SMs, CTA r owning rows
// [r·R, r·R + R) of Y, Z and T (R = KP/8, KP the padded k: 32, 64 or 128).
// Each CTA holds full copies of Y, T and Z in its shared memory; a CTA
// computes its rows of a product from its local copies and sends each row
// block into every other CTA's copy through distributed shared memory
// (DSMEM) with st.async, which counts the bytes on the receiver's
// mbarrier.  A CTA waits only for the rows it is about to read: no barrier
// of the whole cluster inside the loop (a cluster barrier took ≈ 0.42 µs
// on an H100, 48 of them ≈ 20 µs of the launch).  Y·T and T·Z depend only
// on T and run in one phase: two phases a Newton–Schulz step.  Z's new
// rows stay in this CTA until the next step's first phase, which reads
// only its own rows of Z: three k×k buffers a CTA, so k = 128 fits
// (222 KB).  What bounds a step then, at k = 64 (≈ 4100 SM cycles, thread
// 0's clock): the products (≈ 2000), the partial sums and the 42 KB each
// CTA sends a step at ≈ 32 bytes a cycle (≈ 1100), and waiting for the
// peers' rows (≈ 1000).
// Within a CTA a thread computes a 4×4 output tile over one slice of the
// inner index (float4 loads of A broadcast along a row, float4 loads of B
// along its columns), and the slices' partial sums are added in slice order.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCtas = 8;  // the cluster
// A CTA's threads, each computing an RT×4 tile of a product over one slice
// of its inner index (512-thread CTAs and 2×4 tiles measured slower).
constexpr int kThreads = 256;
constexpr int kRt = 4;

// Slices of the inner index when n threads share a product of `tiles`
// tiles: as many as there are threads a tile, each slice at least 4 long.
__host__ __device__ constexpr int slices(int tiles, int kp, int n) {
  return n / tiles < kp / 4 ? n / tiles : kp / 4;
}

template <int KP>
struct Geometry {
  static constexpr int NT = kThreads;
  static constexpr int RT = kRt;
  static constexpr int R = KP / kCtas;  // rows a CTA owns
  // Row stride in shared memory: the 4-float pad puts the float4s that
  // one warp reads from neighbouring rows in different banks.
  static constexpr int LD = KP + 4;
  static constexpr int CG = KP / 4;  // column groups of four
  static constexpr int TILES = (R / RT) * CG;
  static constexpr int S1 = slices(TILES, KP, NT);      // one product
  static constexpr int S2 = slices(TILES, KP, NT / 2);  // two at once
  // The slices' partial sums: one product's, or two at once.
  static constexpr int PART = S1 > 2 * S2 ? S1 * R * KP : 2 * S2 * R * KP;
  static constexpr int SMEM_FLOATS = 3 * KP * LD + R * LD + PART;
};

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// A cluster barrier: every store before it, to this CTA's or a peer's
// shared memory, is visible to every thread of the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.aligned;\n"
      "barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The address `a` of this CTA's shared memory in CTA `rank`'s.
__device__ __forceinline__ uint32_t peer(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// Open the barrier's current phase for `bytes` of st.async data: the
// phase completes when they have all landed.
__device__ __forceinline__ void bar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of parity `parity` to complete; the data that the
// peers' st.async wrote in it is visible after.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// Store v at `dst` of this CTA's shared memory and at the same place in
// every other CTA of the cluster, the remote stores counted on that CTA's
// barrier `bar` (starting with the next rank, so the CTAs do not all write
// to one peer).  This CTA's own threads read the local store after a
// __syncthreads.
__device__ __forceinline__ void push(int rank, float* dst, uint32_t bar,
                                     float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
  const uint32_t addr = smem_addr(dst);
#pragma unroll
  for (int r = 1; r < kCtas; ++r) {
    const int to = (rank + r) % kCtas;
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
        "[%0], {%1, %2, %3, %4}, [%5];\n"
        ::"r"(peer(addr, to)), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w),
        "r"(peer(bar, to)) : "memory");
  }
}

// W_new[i][j] (0 outside k×k), rounded as the host arithmetic rounds it.
__device__ __forceinline__ float w_new_at(const float* __restrict__ w,
                                          const float* __restrict__ gx,
                                          const float* __restrict__ gsum,
                                          int k, int i, int j, float p_inv,
                                          float pad_g0) {
  if (i >= k || j >= k) return 0.f;
  const float g = __fmul_rn(__fsub_rn(gsum[i], pad_g0), p_inv);
  return __fsub_rn(__fmul_rn(gx[i * k + j], p_inv), __fmul_rn(g, w[i * k + j]));
}

// Partial sums of A·B over one slice of the inner index.  A is this CTA's
// R rows, B a full KP×KP matrix, both in its shared memory at stride LD.
// Thread t of NT computes an RT×4 tile over its slice s and writes it to
// part + s·R·KP (R×KP, dense).
template <int KP, int NT>
__device__ __forceinline__ void product_part(const float* __restrict__ a,
                                             const float* __restrict__ b,
                                             float* __restrict__ part, int t) {
  using G = Geometry<KP>;
  constexpr int RT = G::RT;
  constexpr int S = slices(G::TILES, KP, NT);
  constexpr int L = KP / S;
  if (t >= G::TILES * S) return;
  const int c4 = t % G::CG;
  const int rg = (t / G::CG) % (G::R / RT);
  const int s = t / G::TILES;
  const float* ap = a + rg * RT * G::LD + s * L;
  const float* bp = b + s * L * G::LD + c4 * 4;
  float acc[RT][4];
#pragma unroll
  for (int q = 0; q < RT; ++q) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[q][c] = 0.f;
  }
#pragma unroll 4
  for (int l = 0; l < L; l += 4) {
    float av[RT][4];
#pragma unroll
    for (int q = 0; q < RT; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(ap + q * G::LD + l);
      av[q][0] = v.x;
      av[q][1] = v.y;
      av[q][2] = v.z;
      av[q][3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 bv = *reinterpret_cast<const float4*>(bp + (l + u) * G::LD);
#pragma unroll
      for (int q = 0; q < RT; ++q) {
        acc[q][0] = fmaf(av[q][u], bv.x, acc[q][0]);
        acc[q][1] = fmaf(av[q][u], bv.y, acc[q][1]);
        acc[q][2] = fmaf(av[q][u], bv.z, acc[q][2]);
        acc[q][3] = fmaf(av[q][u], bv.w, acc[q][3]);
      }
    }
  }
  float* pp = part + s * G::R * KP + rg * RT * KP + c4 * 4;
#pragma unroll
  for (int q = 0; q < RT; ++q) {
    *reinterpret_cast<float4*>(pp + q * KP) =
        make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
  }
}

// Group g (four neighbouring outputs) of a product: its S partial sums
// added in slice order.
template <int KP, int S>
__device__ __forceinline__ float4 reduce_group(const float* __restrict__ part,
                                               int g) {
  const float* p = part + g * 4;
  float4 v = *reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int s = 1; s < S; ++s) {
    const float4 u =
        *reinterpret_cast<const float4*>(p + s * Geometry<KP>::R * KP);
    v.x += u.x;
    v.y += u.y;
    v.z += u.z;
    v.w += u.w;
  }
  return v;
}

// T = 1.5·I − 0.5·P, entry (i, j), with I the k×k identity.
__device__ __forceinline__ float t_entry(int i, int j, int k, float p) {
  return __fsub_rn(i == j && j < k ? 1.5f : 0.f, __fmul_rn(0.5f, p));
}

template <int KP>
__global__ void __cluster_dims__(kCtas, 1, 1)
    __launch_bounds__(Geometry<KP>::NT, 1)
    ica_update_kernel(const float* __restrict__ w,
                      const float* __restrict__ gx,
                      const float* __restrict__ gsum, float* __restrict__ w1,
                      float* __restrict__ lim, int k, float p_inv,
                      float pad_g0, int iters) {
  using G = Geometry<KP>;
  constexpr int R = G::R, LD = G::LD, CG = G::CG, NT = G::NT;
  constexpr int S1 = G::S1, S2 = G::S2;
  extern __shared__ float4 smem4[];
  float* yf = reinterpret_cast<float*>(smem4);  // Y, all rows
  float* tf = yf + KP * LD;  // T, all rows (W_newᵀ before the loop, W_new
                             // after it)
  float* zf = tf + KP * LD;  // Z, all rows
  float* zs = zf + KP * LD;  // this CTA's rows: W_new, Z, then W1
  float* part = zs + R * LD;
  __shared__ int lim_bits;  // CTA 0's: the max of the rows' stop values
  __shared__ float c_shared;
  // Y's rows arrive on bar_y (phase 0: A; phase s: Y after s steps), T's
  // and Z's on bar_tz (phase s: step s's T and Z).
  __shared__ unsigned long long bars[2];
  const uint32_t bar_y = smem_addr(&bars[0]), bar_tz = smem_addr(&bars[1]);
  // The bytes of a k×k buffer that the peers send (all rows but this
  // CTA's own).
  constexpr uint32_t kMatBytes = (KP - R) * KP * sizeof(float);

  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int t = threadIdx.x;
  const int row0 = rank * R;

  if (t == 0) {
    lim_bits = 0;
    bar_init(bar_y);
    bar_init(bar_tz);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    bar_expect(bar_y, kMatBytes);
    if (iters > 0) bar_expect(bar_tz, 2 * kMatBytes);
  }
  // No CTA writes to a peer's shared memory before the peer has started
  // and set up its barriers.
  cluster_arrive_relaxed();

  // W_new, all of it transposed into tf (the B of W_new·W_newᵀ), this CTA's
  // rows into zs.
  for (int e = t; e < KP * KP; e += NT) {
    const int i = e / KP, j = e % KP;
    const float v = w_new_at(w, gx, gsum, k, i, j, p_inv, pad_g0);
    tf[j * LD + i] = v;
    if (i >= row0 && i < row0 + R) zs[(i - row0) * LD + j] = v;
  }
  __syncthreads();
  // A = W_new·W_newᵀ: this CTA's rows into every CTA's yf.
  product_part<KP, NT>(zs, tf, part, t);
  __syncthreads();
  cluster_wait();
  for (int g = t; g < R * CG; g += NT) {
    push(rank, yf + (row0 + g / CG) * LD + (g % CG) * 4, bar_y,
         reduce_group<KP, S1>(part, g));
  }
  for (int e = t; e < R * KP; e += NT) {  // Z₀ = I, this CTA's rows
    const int i = row0 + e / KP, j = e % KP;
    zs[(e / KP) * LD + j] = (i == j && i < k) ? 1.f : 0.f;
  }
  bar_wait(bar_y, 0);
  if (t == 0 && iters > 0) bar_expect(bar_y, kMatBytes);
  __syncthreads();  // this CTA's own rows of A
  // c = trace(A), summed in the same order in every CTA; Y = A/c in each
  // CTA's copy.
  if (t < 32) {
    float s = 0.f;
    for (int i = t; i < k; i += 32) s += yf[i * LD + i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (t == 0) c_shared = s;
  }
  __syncthreads();
  const float c = c_shared;
  for (int e = t; e < k * KP; e += NT) {
    const int i = e / KP, j = e % KP;
    if (j < k) yf[i * LD + j] = __fdiv_rn(yf[i * LD + j], c);
  }
  __syncthreads();

  // No barrier of the whole cluster in the loop: a CTA waits only for the
  // rows it reads, and the data flow orders each buffer's reuse.  A CTA
  // writes step s's T and Z rows into a peer only once it holds all of Y
  // after s steps, the last of which the peer sent after its step s − 1
  // had read its T and Z; it writes Y after s + 1 steps into a peer only
  // once it holds all of step s's T, which the peer sent after reading Y.
  for (int it = 0; it < iters; ++it) {
    // Phase 1: T = 1.5·I − 0.5·(Z·Y), this CTA's rows into every CTA's tf;
    // Z's rows (kept in zs since the last step) into every CTA's zf.
    if (it > 0) {
      bar_wait(bar_y, it & 1);
      if (t == 0) bar_expect(bar_y, kMatBytes);
    }
    for (int g = t; g < R * CG; g += NT) {
      const int off = (g / CG) * LD + (g % CG) * 4;
      push(rank, zf + row0 * LD + off, bar_tz,
           *reinterpret_cast<const float4*>(zs + off));
    }
    product_part<KP, NT>(zs, yf, part, t);
    __syncthreads();
    for (int g = t; g < R * CG; g += NT) {
      const int i = row0 + g / CG, j = (g % CG) * 4;
      const float4 p = reduce_group<KP, S1>(part, g);
      push(rank, tf + i * LD + j, bar_tz,
           make_float4(t_entry(i, j, k, p.x), t_entry(i, j + 1, k, p.y),
                       t_entry(i, j + 2, k, p.z), t_entry(i, j + 3, k, p.w)));
    }
    __syncthreads();
    // Phase 2: Y ← Y·T into every CTA's yf (each CTA reads only its own
    // rows of Y here), Z ← T·Z into zs.
    bar_wait(bar_tz, it & 1);
    if (t == 0 && it + 1 < iters) bar_expect(bar_tz, 2 * kMatBytes);
    if (t < NT / 2) {
      product_part<KP, NT / 2>(yf + row0 * LD, tf, part, t);
    } else {
      product_part<KP, NT / 2>(tf + row0 * LD, zf, part + G::PART / 2,
                               t - NT / 2);
    }
    __syncthreads();
    for (int g = t; g < 2 * R * CG; g += NT) {
      const bool is_z = g >= R * CG;
      const int h = is_z ? g - R * CG : g;
      const float4 v =
          reduce_group<KP, S2>(part + (is_z ? G::PART / 2 : 0), h);
      const int off = (h / CG) * LD + (h % CG) * 4;
      if (is_z) {
        *reinterpret_cast<float4*>(zs + off) = v;
      } else {
        push(rank, yf + row0 * LD + off, bar_y, v);
      }
    }
    __syncthreads();
  }
  // The last step's Y rows land before this CTA may end.
  if (iters > 0) bar_wait(bar_y, iters & 1);

  // W1 = (Z·W_new)/√c: W_new again, untransposed, into tf (no peer writes
  // to it after the last step's T).
  for (int e = t; e < KP * KP; e += NT) {
    const int i = e / KP, j = e % KP;
    tf[i * LD + j] = w_new_at(w, gx, gsum, k, i, j, p_inv, pad_g0);
  }
  __syncthreads();
  product_part<KP, NT>(zs, tf, part, t);
  __syncthreads();
  const float root_c = __fsqrt_rn(c);
  for (int g = t; g < R * CG; g += NT) {
    const float4 p = reduce_group<KP, S1>(part, g);
    const float v[4] = {__fdiv_rn(p.x, root_c), __fdiv_rn(p.y, root_c),
                        __fdiv_rn(p.z, root_c), __fdiv_rn(p.w, root_c)};
    const int r = g / CG, j = (g % CG) * 4;
    *reinterpret_cast<float4*>(zs + r * LD + j) =
        make_float4(v[0], v[1], v[2], v[3]);
    if (row0 + r < k) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (j + q < k) w1[(row0 + r) * k + j + q] = v[q];
      }
    }
  }
  __syncthreads();
  // lim: a warp a row; the rows' values meet in CTA 0 by an integer max,
  // which orders non-negative floats and keeps a NaN (as torch's max does).
  const int warp = t / 32, lane = t % 32;
  for (int r = warp; r < R && row0 + r < k; r += NT / 32) {
    const int i = row0 + r;
    float s = 0.f;
    for (int j = lane; j < k; j += 32) {
      s += __fmul_rn(zs[r * LD + j], w[j * k + i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      atomicMax(cl.map_shared_rank(&lim_bits, 0),
                __float_as_int(fabsf(fabsf(s) - 1.f)));
    }
  }
  cluster_sync();
  if (rank == 0 && t == 0) *lim = __int_as_float(lim_bits);
}

template <int KP>
int launch(const float* w, const float* gx, const float* gsum, float* w1,
           float* lim, int k, float p_inv, float pad_g0, int iters,
           cudaStream_t stream) {
  constexpr int bytes = Geometry<KP>::SMEM_FLOATS * sizeof(float);
  static bool sized[64] = {};  // the attribute is set once a device
  int dev = 0;
  cudaError_t st = cudaGetDevice(&dev);
  if (st != cudaSuccess) return st;
  if (dev >= 64 || !sized[dev]) {
    st = cudaFuncSetAttribute(ica_update_kernel<KP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
    if (st != cudaSuccess) return st;
    if (dev < 64) sized[dev] = true;
  }
  ica_update_kernel<KP><<<kCtas, Geometry<KP>::NT, bytes, stream>>>(
      w, gx, gsum, w1, lim, k, p_inv, pad_g0, iters);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* petal_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// w, gx: k×k row-major; gsum: k; w1: k×k out; lim: one float out; all
// float32 on the device.  1 ≤ k ≤ 128.  Returns a cudaError_t.
int petal_ica_update_f32(const void* w, const void* gx, const void* gsum,
                         void* w1, void* lim, int k, float p_inv,
                         float pad_g0, int iters, void* stream) {
  const auto* wp = static_cast<const float*>(w);
  const auto* gxp = static_cast<const float*>(gx);
  const auto* gsp = static_cast<const float*>(gsum);
  auto* w1p = static_cast<float*>(w1);
  auto* limp = static_cast<float*>(lim);
  auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 128 || iters < 0) return cudaErrorInvalidValue;
  if (k <= 32) {
    return launch<32>(wp, gxp, gsp, w1p, limp, k, p_inv, pad_g0, iters, s);
  }
  if (k <= 64) {
    return launch<64>(wp, gxp, gsp, w1p, limp, k, p_inv, pad_g0, iters, s);
  }
  return launch<128>(wp, gxp, gsp, w1p, limp, k, p_inv, pad_g0, iters, s);
}

}  // extern "C"
