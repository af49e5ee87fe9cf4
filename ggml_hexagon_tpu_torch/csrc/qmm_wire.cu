// K10 at B <= 8: the streaming, split-K GEMV over the wire planes of any
// QConfig, bf16 or f32 compute, for sm_90a.  qmm_wire_gemm.cu holds K10
// above 8 rows.
//
// Replaces ggml_hexagon_tpu/ops/qmatmul.py `_qmm_kernel`, launched through
// `pallas_call` in `_qmatmul_pallas` (entry `qmatmul_pallas`), at B <= 8.
//
// What bounds it: bytes (the wire planes are read once, ~2 flops a weight
// byte per row) in bf16; in f32, at 8 rows, the f32 multiply-adds about as
// much (16 a weight pair of rows on the CUDA cores).
//
// The contract (wire.cuh): the weight dequantized in f32 with the TPU
// kernel's roundings, rounded to the compute type (bf16, or kept in f32), x
// rounded the same way, the products summed in f32.  The dequantized weight
// never exists in device memory.  One template instance per plane family
// (low/high bits, signed, LUT, super-block, asymmetry) and compute type,
// chosen at compile time: a run-time branch in the inner loop cost
// K1/K3/K5 30-75%.
//
//  * Weight rows are the M of bf16 mma.sync m16n8k16 (swap-AB), 64 a tile;
//    the <= 8 activation rows are its N (columns past B repeat the last
//    row and are dropped).  Eight consumer warps: four row groups of 16,
//    each split into two halves that take alternate (unit, shift) items
//    and add their sums at the tile's end.
//  * The planes stream through a ring of stages by TMA from a producer
//    warp with an evict-first L2 policy.  A stage is HW consecutive
//    positions of the high plane (128, 64 or 32 dividing its row) and the
//    R low-plane boxes that share those high bytes (R = 4 for Q5_0, Q5_1,
//    Q5_K; 2 for Q6_K, Q3_K; 1 without a high plane), so each high byte is
//    fetched once with the low bytes it pairs with.  The scale planes' row
//    pitches are no TMA pitch (d of K = 11008 is 172 bytes, sc at gs = 32
//    344), so the producer's 32 lanes copy each stage's scale words with
//    4-byte cp.async into the same ring slot, arriving on its mbarrier.
//  * A thread decodes 16 weights of each of its two rows from one 16-byte
//    word of the stage at one shift (wire.cuh decode4): each code becomes
//    the f32 2^23 + code by one prmt, then the exact subtraction, the scale
//    and the bias in f32.  bf16: one rounding to bf16; the mma's k index
//    maps the thread's 16 columns, and the activation fragment is the same
//    16 columns, 32 contiguous bytes.  f32: the weight stays unrounded and
//    meets each activation row's 16 f32 columns in fused multiply-adds on
//    the CUDA cores; the four threads of a row pair sum their units by
//    shuffles at the tile's end, into the mma's output layout.
//  * Each block builds its K split's activation once, in the planes' run
//    order, in shared memory (bf16, or f32); blocks are persistent (every
//    nbx-th tile of one split).  Splits are whole stages; the last block of
//    a split tile sums the splits' partials in split order (an int32
//    counter a tile, reset by that block): deterministic, no float atomics.
//    kernels.pick_wire_gemv sizes splits, ring and blocks to the SM count.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "codes.cuh"
#include "hopper.cuh"
#include "wire.cuh"

namespace {

constexpr int GV_NCW = 8;           // consumer warps: 4 row groups, two halves each
constexpr int GV_NCT = GV_NCW * 32;
constexpr int GV_NTH = GV_NCT + 32;  // and one producer warp
constexpr int GV_TR = 64;            // weight rows a tile
constexpr int GV_MAXB = 8;           // activation rows (the mma's N)
constexpr int SMEM_MAX = 232448;     // shared memory a block may take

// How the GEMV walks a family's planes (kernels.wire_geo mirrors it): a
// stage takes HW consecutive high positions h0.. (128, 64 or 32, dividing
// Kph) as R low boxes of HW x 64 rows (at r*Kph + h0) and one high box (at
// h0), and with them every column they hold: per*R runs (s, r) of HW
// columns, the run's first column s*Kp + r*Kph + h0.  Families without a
// high plane take Kph = Kp, R = 1.  nst stages a tile; a K split takes
// whole stages, so it holds whole high bytes.  Each run's scales come as a
// record of nrec words (wire.cuh).  sb: the bytes of a ring slot (the
// boxes and 64 rows x per*R records).
struct WireGeo {
  int per, Kp, Kph, R, HW, lhw, nst, n, scw, nrec, box, sb;
};

__host__ __device__ inline int ilog2i(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

__host__ __device__ inline void wire_geo(WireGeo* g, int bl, int bh, bool sup, int asym, int K,
                                         int gs) {
  g->per = 8 / bl;
  g->Kp = K / g->per;
  g->Kph = bh ? K * bh / 8 : g->Kp;
  g->R = g->Kp / g->Kph;
  g->HW = g->Kph % 128 == 0 ? 128 : g->Kph % 64 == 0 ? 64 : 32;
  g->lhw = ilog2i(g->HW);
  g->nst = g->Kph / g->HW;
  wire_record(g->HW, gs, sup, asym, &g->n, &g->scw, &g->nrec);
  g->box = GV_TR * g->HW;
  g->sb = align128((g->R + (bh > 0)) * g->box + GV_TR * g->per * g->R * g->nrec * 4);
}

// The bytes of an activation run of lmax columns: bf16, or f32 with 16
// bytes of skew after every 32 columns (the four threads of a row pair
// read four neighbouring 16-column units at once: 64 bytes apart they
// would meet the same banks two by two).
__host__ __device__ inline int run_bytes(int lmax, int esz) {
  return esz == 4 ? lmax * 4 + (lmax >> 5) * 16 : lmax * 2;
}

// The block's shared memory: ns ring slots, then the split's activation (nb
// rows of per*R runs of lmax columns, pitch 16 more than a multiple of 128
// bytes: a quarter-warp's 16-byte loads of two rows meet no bank twice),
// the second halves' partial sums, the last-block flag and the mbarriers
// full[ns], empty[ns].
struct WireLayout {
  int act, pitch, red, flag, bars, total;
};

__host__ __device__ inline WireLayout wire_layout(const WireGeo& g, int ns, int lmax, int nb,
                                                  int esz) {
  WireLayout l;
  l.act = ns * g.sb;
  l.pitch = align128(g.per * g.R * run_bytes(lmax, esz)) + 16;
  l.red = l.act + align128(nb * l.pitch);
  l.flag = l.red + 4 * 32 * 4 * 4;
  l.bars = align128(l.flag + 16);
  l.total = l.bars + 8 * 2 * ns;
  return l;
}

struct WireArgs {
  const float* x;  // f32 [NB, K]
  Planes P;
  float* out;      // f32 [NB, n_pad]
  float* ws;       // f32 [ks, NB, n_pad] (ks > 1)
  int* counters;   // one a tile, zero between calls
  WireGeo g;
  int NB, n_pad, ntiles, ks, ns, lmax;
};

struct WireMaps {
  CUtensorMap lo, hi;
};

__device__ __forceinline__ void gv_consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(GV_NCT) : "memory");
}

// The 16 weights of one row's 16-byte unit at shift s (the high bits at
// hs): w[4i + e] from byte e of word i.
template <int BL, int BH, bool SIGNED, bool LUT, int ASYM>
__device__ __forceinline__ void decode16(const uint4& Lw, const uint4& Hw, int s, int hs,
                                         float scale, float bias, float qoff, float (&w)[16]) {
  const uint32_t Lv[4] = {Lw.x, Lw.y, Lw.z, Lw.w};
  const uint32_t Hv[4] = {Hw.x, Hw.y, Hw.z, Hw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float q[4];
    decode4<BL, BH, SIGNED, LUT, ASYM>(Lv[i], Hv[i], BL * s, hs, scale, bias, qoff, q);
#pragma unroll
    for (int e = 0; e < 4; ++e) w[4 * i + e] = q[e];
  }
}

// The same 16 weights rounded to bf16: A[2i], A[2i + 1] the pairs (4i, 4i
// + 1), (4i + 2, 4i + 3).
template <int BL, int BH, bool SIGNED, bool LUT, int ASYM>
__device__ __forceinline__ void decode16_bf16(const uint4& Lw, const uint4& Hw, int s, int hs,
                                              float scale, float bias, float qoff,
                                              uint32_t (&A)[8]) {
  float w[16];
  decode16<BL, BH, SIGNED, LUT, ASYM>(Lw, Hw, s, hs, scale, bias, qoff, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) A[i] = pack_bf16(w[2 * i], w[2 * i + 1]);
}

template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM, bool F32>
__global__ void __launch_bounds__(GV_NTH, 2)
    wire_gemv_kernel(const __grid_constant__ WireArgs a, const __grid_constant__ WireMaps maps) {
  constexpr int PER = 8 / BL;
  constexpr int HIGH = BH > 0;
  constexpr int ESZ = F32 ? 4 : 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const WireGeo g = a.g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ns = a.ns, split = blockIdx.y;
  const int lgs = a.P.gs_shift;
  const int K = a.P.K;
  // this split's stages [st0, st0 + nps) of every tile
  const int st0 = (int)((long long)split * g.nst / a.ks);
  const int nps = (int)((long long)(split + 1) * g.nst / a.ks) - st0;
  const int h_lo = st0 * g.HW;
  const int ntile = (a.ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const WireLayout L = wire_layout(g, ns, a.lmax, a.NB, ESZ);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + L.bars;  // full[ns], empty[ns]
  const int nruns = PER * g.R;
  const int recoff = (g.R + HIGH) * g.box;  // a slot's records

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(bars + 8 * s, 33);              // the expected bytes and 32 lanes' copies
      mbar_init(bars + 8 * (ns + s), GV_NCW);  // every consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == GV_NCW) {
    // ---- producer: lane 0 brings the boxes by TMA, every lane its rows'
    // scale records by 4-byte cp.async, each lane's copies arriving on the
    // stage's mbarrier ----
    const uint64_t pol = evict_first_policy();
    const int nst = ntile * nps;
    for (int i = 0, slot = 0, par = 0, ti = 0, j = 0; i < nst; ++i) {
      if (i >= ns) mbar_wait(bars + 8 * (ns + slot), par ^ 1);
      const int h0 = (st0 + j) * g.HW;
      const int wrow = ((int)blockIdx.x + ti * (int)gridDim.x) * GV_TR;
      const uint32_t full = bars + 8 * slot, sbase = base + slot * g.sb;
      if (lane == 0) {
        mbar_expect_tx(full, (g.R + HIGH) * g.box);
        for (int r = 0; r < g.R; ++r)
          tma_load_2d_ef(sbase + r * g.box, &maps.lo, r * g.Kph + h0, wrow, full, pol);
        if (HIGH) tma_load_2d_ef(sbase + g.R * g.box, &maps.hi, h0, wrow, full, pol);
      }
      for (int rr = lane; rr < GV_TR; rr += 32) {
        const size_t row = (size_t)(wrow + rr);
        for (int run = 0; run < nruns; ++run) {
          const int s = run / g.R, r = run - s * g.R;
          copy_record<SUPER, ASYM>(a.P, row, s * g.Kp + r * g.Kph + h0, g.n, g.scw,
                                   sbase + recoff + (rr * nruns + run) * g.nrec * 4);
        }
      }
      mbar_arrive_cp_async(full);
      if (++slot == ns) slot = 0, par ^= 1;
      if (++j == nps) j = 0, ++ti;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---- the split's activation in run order: run (s, r) holds columns
  // s*Kp + r*Kph + h for h in [h_lo, h_lo + nps*HW) ----
  unsigned char* act = smem + L.act;
  const int RB = run_bytes(a.lmax, ESZ);
  {
    const int q4 = nps * g.HW / 4, per_row = nruns * q4, nq = a.NB * per_row;
    constexpr int U = 8;  // loads in flight a thread
    for (int e0 = tid; e0 < nq; e0 += GV_NCT * U) {
      float4 v[U];
      int off[U];
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int e = e0 + k * GV_NCT;
        off[k] = -1;
        if (e < nq) {
          const int n = e / per_row, rem = e - n * per_row, run = rem / q4, hq = rem - run * q4;
          const int s = run / g.R, r = run - s * g.R;
          const int col = s * g.Kp + r * g.Kph + h_lo + 4 * hq;
          v[k] = __ldg(reinterpret_cast<const float4*>(a.x + (size_t)n * K + col));
          off[k] = n * L.pitch + run * RB + 4 * hq * ESZ + (F32 ? (hq >> 3) * 16 : 0);
        }
      }
#pragma unroll
      for (int k = 0; k < U; ++k)
        if (off[k] >= 0) {
          if constexpr (F32)
            *reinterpret_cast<float4*>(act + off[k]) = v[k];
          else
            *reinterpret_cast<uint2*>(act + off[k]) =
                make_uint2(pack_bf16(v[k].x, v[k].y), pack_bf16(v[k].z, v[k].w));
        }
    }
  }
  gv_consumers_sync();

  // ---- the products over the ring, tile after tile: warp w takes rows
  // 16*(w%4).. and the (unit, shift) items of parity w/4 ----
  const int gid = lane >> 2, tq = lane & 3;
  const int rg = warp & 3, half = warp >> 2;
  const int r0 = 16 * rg + gid, r1 = r0 + 8;
  const int nx = min(gid, a.NB - 1);  // columns past NB repeat the last row; dropped
  const int nhu = g.HW >> 4, lhu = g.lhw - 4;
  const int nitems = g.R * nhu / 4 * PER;  // (unit j, shift s) items of a thread
  const float qoff = wire_qoff<SIGNED, LUT, ASYM>(a.P.off);
  float* red = reinterpret_cast<float*>(smem + L.red);
  int* flag = reinterpret_cast<int*>(smem + L.flag);
  int slot = 0, par = 0;
  for (int ti = 0; ti < ntile; ++ti) {
    const int tile = (int)blockIdx.x + ti * (int)gridDim.x;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    // f32: rows r0 and r1 against every activation row, summed over this
    // thread's units
    float f0[GV_MAXB], f1[GV_MAXB];
#pragma unroll
    for (int n = 0; n < GV_MAXB; ++n) f0[n] = f1[n] = 0.f;
    for (int js = 0; js < nps; ++js) {
      const int h0 = (st0 + js) * g.HW;
      mbar_wait(bars + 8 * slot, par);
      const unsigned char* st = smem + slot * g.sb;
      const uint32_t* rec = reinterpret_cast<const uint32_t*>(st + recoff);
      // each stage's sums start from zero (the tensor cores truncate as they
      // align a long running sum) and join the f32 total
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      for (int it = half; it < nitems; it += 2) {
        const int j = it / PER, s = it - j * PER;
        const int u = tq + 4 * j, r = u >> lhu, hu = u & (nhu - 1);
        const int run = s * g.R + r;
        const uint4 L0 = *reinterpret_cast<const uint4*>(st + r * g.box + r0 * g.HW + hu * 16);
        const uint4 L1 = *reinterpret_cast<const uint4*>(st + r * g.box + r1 * g.HW + hu * 16);
        uint4 H0 = make_uint4(0u, 0u, 0u, 0u), H1 = H0;
        if constexpr (HIGH) {
          H0 = *reinterpret_cast<const uint4*>(st + g.R * g.box + r0 * g.HW + hu * 16);
          H1 = *reinterpret_cast<const uint4*>(st + g.R * g.box + r1 * g.HW + hu * 16);
        }
        const int cs = s * g.Kp + r * g.Kph + h0;
        float sc0, sc1, b0 = 0.f, b1 = 0.f;
        scale_of<SUPER, ASYM>(rec + (r0 * nruns + run) * g.nrec, g.HW, g.n, g.scw, cs, hu, lgs,
                              sc0, b0);
        scale_of<SUPER, ASYM>(rec + (r1 * nruns + run) * g.nrec, g.HW, g.n, g.scw, cs, hu, lgs,
                              sc1, b1);
        if constexpr (F32) {
          float w0[16], w1[16];
          decode16<BL, BH, SIGNED, LUT, ASYM>(L0, H0, s, BH * run, sc0, b0, qoff, w0);
          decode16<BL, BH, SIGNED, LUT, ASYM>(L1, H1, s, BH * run, sc1, b1, qoff, w1);
          const int c0 = h0 - h_lo + 16 * hu;  // the unit's first column in its run
          const unsigned char* xr = act + run * RB + c0 * 4 + (c0 >> 5) * 16;
#pragma unroll
          for (int n = 0; n < GV_MAXB; ++n) {
            if (n < a.NB) {
              const float4* xp = reinterpret_cast<const float4*>(xr + n * L.pitch);
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const float4 xv = xp[q];
                const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  f0[n] = fmaf(w0[4 * q + e], xs[e], f0[n]);
                  f1[n] = fmaf(w1[4 * q + e], xs[e], f1[n]);
                }
              }
            }
          }
        } else {
          uint32_t A0[8], A1[8];
          decode16_bf16<BL, BH, SIGNED, LUT, ASYM>(L0, H0, s, BH * run, sc0, b0, qoff, A0);
          decode16_bf16<BL, BH, SIGNED, LUT, ASYM>(L1, H1, s, BH * run, sc1, b1, qoff, A1);
          const uint4* xp = reinterpret_cast<const uint4*>(
              act + nx * L.pitch + (run * a.lmax + h0 - h_lo + 16 * hu) * 2);
          const uint4 X0 = xp[0], X1 = xp[1];
          mma16816(d0, A0[0], A1[0], A0[1], A1[1], X0.x, X0.y);
          mma16816(d1, A0[2], A1[2], A0[3], A1[3], X0.z, X0.w);
          mma16816(d0, A0[4], A1[4], A0[5], A1[5], X1.x, X1.y);
          mma16816(d1, A0[6], A1[6], A0[7], A1[7], X1.z, X1.w);
        }
      }
      // the slot is free once every lane's values have fed its products
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (ns + slot));
      if constexpr (!F32) {
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[k] += d0[k] + d1[k];
      }
      if (++slot == ns) slot = 0, par ^= 1;
    }
    if constexpr (F32) {
      // the four threads of a row pair hold other units: their sums, then
      // the mma's output layout (row r0 + 8(k >> 1), column 2tq + (k & 1))
#pragma unroll
      for (int n = 0; n < GV_MAXB; ++n) {
        f0[n] += __shfl_xor_sync(0xffffffffu, f0[n], 1);
        f0[n] += __shfl_xor_sync(0xffffffffu, f0[n], 2);
        f1[n] += __shfl_xor_sync(0xffffffffu, f1[n], 1);
        f1[n] += __shfl_xor_sync(0xffffffffu, f1[n], 2);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (tq == q) {
          acc[0] = f0[2 * q];
          acc[1] = f0[2 * q + 1];
          acc[2] = f1[2 * q];
          acc[3] = f1[2 * q + 1];
        }
    }

    // ---- the two halves' sums, then y or the split's partial ----
    if (half) {
#pragma unroll
      for (int k = 0; k < 4; ++k) red[(rg * 32 + lane) * 4 + k] = acc[k];
    }
    gv_consumers_sync();
    const int row0 = tile * GV_TR;
    if (!half) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int n = 2 * tq + (k & 1), row = row0 + r0 + 8 * (k >> 1);
        const float v = acc[k] + red[(rg * 32 + lane) * 4 + k];
        if (n >= a.NB) continue;
        if (a.ks == 1) a.out[(size_t)n * a.n_pad + row] = v;
        else a.ws[((size_t)split * a.NB + n) * a.n_pad + row] = v;
      }
    }
    if (a.ks > 1) {
      __threadfence();
      gv_consumers_sync();
      int* counter = a.counters + tile;
      if (tid == 0) *flag = atomicAdd(counter, 1) == a.ks - 1;
      gv_consumers_sync();
      if (*flag) {
        __threadfence();  // the other splits' partials are visible past this
        for (int e = tid; e < a.NB * GV_TR; e += GV_NCT) {
          const int n = e / GV_TR, row = row0 + e % GV_TR;
          float v = 0.f;
          for (int q = 0; q < a.ks; ++q)
            v += __ldcg(a.ws + ((size_t)q * a.NB + n) * a.n_pad + row);
          a.out[(size_t)n * a.n_pad + row] = v;
        }
        if (tid == 0) *counter = 0;  // ready for the next call
      }
    }
    gv_consumers_sync();  // red and the flag are read before the next tile writes them
  }
}

template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM, bool F32>
int gemv_launch(const WireArgs& a, const WireMaps& m, dim3 grid, int smem, cudaStream_t s) {
  static bool attr_set = false;
  auto kern = wire_gemv_kernel<BL, BH, SIGNED, LUT, SUPER, ASYM, F32>;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kern<<<grid, GV_NTH, smem, s>>>(a, m);
  return (int)cudaGetLastError();
}

template <int BL, int BH, bool SIGNED, bool LUT, bool SUPER, int ASYM>
int gemv_launch_dt(bool f32, const WireArgs& a, const WireMaps& m, dim3 grid, int smem,
                   cudaStream_t s) {
  return f32 ? gemv_launch<BL, BH, SIGNED, LUT, SUPER, ASYM, true>(a, m, grid, smem, s)
             : gemv_launch<BL, BH, SIGNED, LUT, SUPER, ASYM, false>(a, m, grid, smem, s);
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K10 at B <= 8.  x f32 [B, K]; the wire planes of one family
// (kernels._WIRE_FAMILIES): 0 signed int8 (Q8_0 and the expanded i-quants
// and ternary), 1 IQ4_NL, 2 IQ4_XS, 3 Q4_0, 4 Q4_1, 5 Q5_0, 6 Q5_1, 7 Q2_K,
// 8 Q3_K, 9 Q4_K, 10 Q5_K, 11 Q6_K; m is uint8 (minsb) or f32 (min); f32
// != 0 computes in f32, else in bf16; the plan of kernels.pick_wire_gemv:
// ks splits of the stages, ns ring slots, nbx persistent blocks along the
// tiles; ws f32 [ks, B, n_pad] (ks > 1) and the int32 tile counters (zero,
// left zero); out f32 [B, n_pad].
int qmm_wire_gemv_run(int fam, int f32, const float* x, int B, int K, const void* q,
                      const void* qh, const float* d, const void* sc, const float* dmin,
                      const void* m, int n_pad, int gs, float off, int ks, int ns, int nbx,
                      float* ws, int* counters, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (fam < 0 || fam > 11 || B < 1 || B > GV_MAXB || K < 256 || K % 256 || n_pad < GV_TR ||
      n_pad % GV_TR || (gs != 16 && gs != 32 && gs != 256) || ns < 1 || ks < 1 || nbx < 1)
    return (int)cudaErrorInvalidValue;
  const int* f = WIRE_FAMS[fam];
  WireArgs a{};
  wire_geo(&a.g, f[0], f[1], f[4] != 0, f[5], K, gs);
  if (ks > a.g.nst || (ks > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  a.x = x;
  a.P = Planes{(const uint8_t*)q, (const uint8_t*)qh, d, (const int8_t*)sc, dmin,
               (const uint8_t*)m, (const float*)m, K, __builtin_ctz(gs), off};
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.NB = B;
  a.n_pad = n_pad;
  a.ntiles = n_pad / GV_TR;
  a.ks = ks;
  a.ns = ns;
  a.lmax = (a.g.nst + ks - 1) / ks * a.g.HW;
  const WireLayout L = wire_layout(a.g, ns, a.lmax, B, f32 ? 4 : 2);
  if (L.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  WireMaps maps{};
  if (!encode_map_2d(&maps.lo, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, a.g.Kp, n_pad, a.g.Kp, a.g.HW,
                     GV_TR, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  if (f[1] && !encode_map_2d(&maps.hi, CU_TENSOR_MAP_DATA_TYPE_UINT8, qh, a.g.Kph, n_pad,
                             a.g.Kph, a.g.HW, GV_TR, CU_TENSOR_MAP_SWIZZLE_NONE))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(nbx < a.ntiles ? nbx : a.ntiles, ks);
  const bool f3 = f32 != 0;
  const int sm = L.total;
  switch (fam) {
    case 0: return gemv_launch_dt<8, 0, true, false, false, A_NONE>(f3, a, maps, grid, sm, s);
    case 1: return gemv_launch_dt<4, 0, false, true, false, A_NONE>(f3, a, maps, grid, sm, s);
    case 2: return gemv_launch_dt<4, 0, false, true, true, A_NONE>(f3, a, maps, grid, sm, s);
    case 3: return gemv_launch_dt<4, 0, false, false, false, A_NONE>(f3, a, maps, grid, sm, s);
    case 4: return gemv_launch_dt<4, 0, false, false, false, A_MIN>(f3, a, maps, grid, sm, s);
    case 5: return gemv_launch_dt<4, 1, false, false, false, A_NONE>(f3, a, maps, grid, sm, s);
    case 6: return gemv_launch_dt<4, 1, false, false, false, A_MIN>(f3, a, maps, grid, sm, s);
    case 7: return gemv_launch_dt<2, 0, false, false, true, A_MINSB>(f3, a, maps, grid, sm, s);
    case 8: return gemv_launch_dt<2, 1, false, false, true, A_NONE>(f3, a, maps, grid, sm, s);
    case 9: return gemv_launch_dt<4, 0, false, false, true, A_MINSB>(f3, a, maps, grid, sm, s);
    case 10: return gemv_launch_dt<4, 1, false, false, true, A_MINSB>(f3, a, maps, grid, sm, s);
    default: return gemv_launch_dt<4, 2, false, false, true, A_NONE>(f3, a, maps, grid, sm, s);
  }
}

}  // extern "C"
