// K1 / K2 / K5: qp8 decode GEMV (B <= 8) over transposed qp8 planes, for
// sm_90a.
//
// Replaces ggml_hexagon_tpu/ops/qmm_qp8.py `_qp8_decode_kernel` (K1, with
// the helpers `_qp8_prologue`, `_qp8_expand`, `_qp8_body`),
// `_qp8_dual_kernel` (K2) and `_qp8_indirect_kernel` (K5, the MoE
// MUL_MAT_ID GEMV), launched through `pallas_call` in `_qp8_call`,
// `_qp8_dual_call` and `_qp8_indirect_call`.
//
// What bounds it: bytes.  A decode GEMV reads every weight byte once
// (4.5 bits/weight for Q4_K, 6.5 for Q6_K with the bf16 scale planes) and
// does 2 int8 ops per weight, so at B <= 8 it sits two orders of magnitude
// below the card's int8 ridge point: the floor is the plane bytes over the
// memory rate.  To approach it each SM keeps ~200 KB of plane bytes in
// flight, each byte crosses HBM once and is decoded once, and the launch's
// fixed costs (the activation's quantization, the sum of K splits) hide
// under the stream: at the 8B's wo (9.4 MB, 2.8 us) they are most of it.
//
// Design (one launch a call; a block of four consumer warps and one
// producer warp, two blocks an SM):
//  * The planes stream through a ring of stages in shared memory.  A stage
//    is one unit chunk: gs byte rows of the plane with the fewest bits (the
//    unit rows; the high plane, or the low one where there is none) and
//    the low rows they pair with, which lie nl = bl/bh plane periods apart
//    (one 3-D TMA box), with the E = 8/(bh or bl) group rows of fs (and
//    fb) those rows serve (a 3-D box each).  One producer thread issues the
//    boxes with an evict-first L2 policy (a step reads each weight once),
//    one mbarrier a slot counting their bytes; the ring holds 2-16 stages
//    (the host's picker, kernels.pick_gemv, sizes it, the tile and the K
//    splits to the SMs).  The planes are 2-D arrays of row pitch `ld`, so
//    an expert's lane slice is a box coordinate: K5's producer reads
//    ids[p] on the device and the routing never reaches the host.
//  * The activation prologue runs in every block, over the 256-lane
//    segments its K range touches, while the ring fills: the effective
//    activation (raw, RMSNorm*wn, or act(gate)*up with act silu, gelu or
//    relu: act.cuh's template instances, one picked a prologue task by a
//    uniform branch, none in the GEMV loop), its int8 quantization
//    with the true division 127/amax, the segment scales and the integer
//    group sums of the bias dot, into shared memory.  The RMSNorm sum of
//    squares is taken again by every block from L2, by 256 virtual threads
//    in one fixed order (strided partials, a warp butterfly, the eight
//    warps in order), so every block's x8 and xs are bit for bit those of
//    a single pass of 256 threads over the row.
//  * A team of cols/C threads covers a tile's columns, C = 8 a thread (4
//    above 4 rows: a register tile of C x NB int partials).  An item is one
//    group of a stage (gs rows of one low part at one shift, the high rows
//    at theirs), or for the 4+0 planes (Q4_K, IQ3_XXS, IQ3_S) both groups a
//    byte serves, its two nibbles, so every staged byte is read, transposed
//    and decoded once.  A thread reads C bytes of a row at once from shared
//    memory, transposes each 4 x 4 byte block (transpose4) into 4 columns
//    of 4 packed values and takes __dp4a against the int8 activation; the
//    group scales are applied to the exact integer partials in the order of
//    the plain version, acc += P * (fs * xs) + fb * (s8 * xs).  Teams take
//    the block's items in rounds, and a warp releases a slot once its lanes
//    are past it.
//  * Coded planes (the i-quants and ternary: 2+1, 4+0 or 2+0 bits of
//    arithmetic codes) decode where the packed bytes are built, with the
//    alphabet of codes.cuh and its negation set up once a block: byte
//    permutes whose selectors are the codes (for 4-bit codes the raw
//    nibbles themselves, their sign bit the permute's sign-replicate flag)
//    and a blend by the sign.  The products reach 127 * 62 * 32 per group
//    at most, well inside int32.
//  * The loop body is a template instance per plane family (low and high
//    bits) and coded or not, chosen once a block: a run-time branch in the
//    decode costs the uncoded bodies 30-75%, and a high plane handled at
//    run time doubles the Q4_K body.  Ring slots and phases are counted,
//    not divided out.
//  * K splits over blocks (where the column tiles alone leave SMs idle)
//    are whole unit chunks.  Each block of a split tile writes its
//    partials; the last one to finish (a counter in device memory, which
//    it resets for the next call) sums them in split order and adds the
//    residual: no second launch, no float atomics, the same bits every
//    run.
//  * K5 is the same body, one input row a grid.z index, its tile's lanes
//    starting at ids[p] * npe; an id outside [0, E) gives a NaN row.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "act.cuh"
#include "codes.cuh"
#include "hopper.cuh"

namespace {

constexpr int SEG = 256;
constexpr int NCW = 4;            // consumer warps
constexpr int NCT = NCW * 32;     // consumer threads
constexpr int NTH = NCT + 32;     // and one producer warp
constexpr int MAXE = 8;           // groups a unit row serves at most
constexpr int GPS = 16;           // group sums a segment slot (gs >= 16)
constexpr int SMEM_MAX = 232448;  // shared memory a block may take

__host__ __device__ constexpr int cols_per_thread(int nb) { return nb <= 4 ? 8 : 4; }
__host__ __device__ constexpr int padded_rows(int nb) {
  return nb <= 1 ? 1 : nb <= 2 ? 2 : nb <= 4 ? 4 : 8;
}

struct Plane {
  const uint8_t* fq;
  const uint16_t* fs;  // bf16 bits
  const uint16_t* fb;  // bf16 bits or null
  int n2, ld, bl, bh, gs;  // lanes, row pitch of fq/fs/fb, packing
  float off;
  int cm;      // code-map id (codes.cuh), CM_NONE for uncoded planes
  int mapw;    // lanes the tensor maps span (K5: every expert's)
  int U, nl, E, nchunks;  // unit rows, low parts, groups a unit row, chunks
};

// Where a stage keeps its boxes: lo [nl][gs][cols], hi [gs][cols], fs and
// fb [E][cols] bf16; `tx` the bytes its copies bring.
struct Stage {
  int lo, hi, fs, fb, bytes, tx;
};

__host__ __device__ inline Stage stage_of(const Plane& p, int cols) {
  Stage s;
  const int lo = p.nl * p.gs * cols, hi = p.bh ? p.gs * cols : 0, sc = p.E * cols * 2;
  s.lo = 0;
  s.hi = lo;
  s.fs = align128(lo + hi);
  s.fb = s.fs + align128(sc);
  s.bytes = s.fb + (p.fb != nullptr ? align128(sc) : 0);
  s.tx = lo + hi + sc + (p.fb != nullptr ? sc : 0);
  return s;
}

// The block's shared memory: the ring (reused for the teams' sums at the
// end), then the activation: x8 words [slots][64][NBP], segment scales
// [slots][NBP], group sums [slots][GPS][NBP]; the slot table, the norm's
// partials and factors, the last-block flag and the ring's mbarriers.
struct Layout {
  int x8, xs, gsum, tab, redss, inv, flag, bars, total;
};

__host__ __device__ inline Layout layout_of(int sb, int ns, int slots, int nb) {
  const int nbp = padded_rows(nb);
  const int red = NCT * cols_per_thread(nb) * nb * 4;
  Layout l;
  l.x8 = align128(ns * sb > red ? ns * sb : red);
  l.xs = l.x8 + slots * 64 * nbp * 4;
  l.gsum = l.xs + align128(slots * nbp * 4);
  l.tab = l.gsum + slots * GPS * nbp * 4;
  l.redss = l.tab + 4 * (2 * MAXE + 2);
  l.inv = l.redss + 4 * 8 * nbp;
  l.flag = l.inv + 4 * nbp;
  l.bars = align128(l.flag + 16);
  l.total = l.bars + 16 * ns;
  return l;
}

// A stage's items of a team: its groups, or one for both groups of the
// 4+0 planes (gemv_loop40).
__host__ __device__ inline int items_per_stage(const Plane& p) {
  return p.bl == 4 && p.bh == 0 ? 1 : p.E;
}

// Segment slots a block may need: per group row j, the segments that a
// range of su unit rows starting anywhere touches.
__host__ __device__ inline int max_slots(const Plane& p, int ks) {
  const int su = (p.nchunks + ks - 1) / ks * p.gs;
  return p.E * ((su + SEG - 1) / SEG + 1);
}

struct Args {
  Plane A, B;
  int nblk_a;            // column tiles of plane A (plane B's follow)
  int K, mode;           // mode: 0 raw, 1 rmsnorm * wn, 2 act(gate)*up
  int act;               // mode 2's act: ACT_SILU, ACT_GELU or ACT_RELU
  float eps;
  const float* x;
  const float* wn;
  const float* res;      // f32 [rows, n_res] or null
  int n_res;
  float* out;            // f32 [rows, ncols]
  float* ws;             // f32 [ks, rows, ncols] (ks > 1)
  int* counters;         // one a tile and row group, zero between calls
  int ks, ns, nteam, cols, ncols, sb, slots;
  const int* ids;        // K5: expert id a row group, else null
  int npe, n_exp;
};

struct Maps {
  CUtensorMap lo[2], hi[2], fs[2], fb[2];
};

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NCT) : "memory");
}

// 4x4 byte transpose: out[c] byte i = in[i] byte c.
__device__ __forceinline__ void transpose4(const uint32_t q[4], uint32_t col[4]) {
  const uint32_t t0 = __byte_perm(q[0], q[1], 0x5140);
  const uint32_t t1 = __byte_perm(q[2], q[3], 0x5140);
  const uint32_t t2 = __byte_perm(q[0], q[1], 0x7362);
  const uint32_t t3 = __byte_perm(q[2], q[3], 0x7362);
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

// C bytes of a staged plane row as C/4 words.
template <int C>
__device__ __forceinline__ void lds_row(uint32_t (&w)[C / 4], const unsigned char* p) {
  if constexpr (C == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  }
}

// C staged bf16 values as floats.
template <int C>
__device__ __forceinline__ void lds_bf16(float (&f)[C], const uint16_t* p) {
  uint32_t w[C / 2];
  if constexpr (C == 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  } else {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    w[0] = a.x; w[1] = a.y;
  }
#pragma unroll
  for (int i = 0; i < C / 2; ++i) {
    f[2 * i] = bf2f(w[i] & 0xffffu);
    f[2 * i + 1] = bf2f(w[i] >> 16);
  }
}

// The NB activation words of one 4-lane step, NBP apart.
template <int NB, int NBP>
__device__ __forceinline__ void lds_x(int (&xv)[NB], const int* p) {
  if constexpr (NBP == 8) {
    const int4 a = reinterpret_cast<const int4*>(p)[0];
    const int4 b = reinterpret_cast<const int4*>(p)[1];
    const int v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < NB; ++i) xv[i] = v[i];
  } else if constexpr (NBP == 4) {
    const int4 a = *reinterpret_cast<const int4*>(p);
    const int v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int i = 0; i < NB; ++i) xv[i] = v[i];
  } else if constexpr (NBP == 2) {
    const int2 a = *reinterpret_cast<const int2*>(p);
    xv[0] = a.x;
    if constexpr (NB > 1) xv[1] = a.y;
  } else {
    xv[0] = *p;
  }
}

// What a consumer thread's loop needs beyond the arguments.
struct Body {
  const unsigned char* smem;
  uint32_t bars;   // full[ns], then empty[ns]
  const int* x8w;
  const float* xsv;
  const int* gsum;
  const int* tab;  // seg_lo[E], slot base[E + 1]
  int team, c0, c_beg, nst, lane;
  bool bias;
};

// The consumers' loop over the ring for planes of BL low and BH high bits
// (DEC: coded; the only coded 2+0 planes are ternary): team t takes groups t, t + nteam, ... of the block (group
// j of stage i is i * E + j), waits for the stages in order, and its warp
// releases each stage once every group of it is done.  Adds the scaled
// group partials of this thread's C columns to acc.
template <int NB, int BL, int BH, bool DEC>
__device__ __forceinline__ void gemv_loop(const Args& a, const Plane& P, const Stage& sg,
                                          const Body& y, const Decoder& dc,
                                          float (&acc)[cols_per_thread(NB)][NB]) {
  constexpr int C = cols_per_thread(NB);
  constexpr int NBP = padded_rows(NB);
  constexpr int E = 8 / (BH ? BH : BL);             // groups a unit row serves
  constexpr int LOG_E = E == 2 ? 1 : E == 4 ? 2 : 3;
  constexpr int NL = BH ? BL / BH : 1;              // low parts a unit row
  constexpr uint32_t MLO = ((1u << BL) - 1u) * 0x01010101u;
  constexpr uint32_t MHI = ((1u << (BH ? BH : 1)) - 1u) * 0x01010101u;
  const int ns = a.ns, cols = a.cols, nteam = a.nteam, sb = a.sb;
  const int gs = P.gs, lgs = __ffs(gs) - 1, U = P.U;
  const int ngr = y.nst * E;
  // the next stage to wait for, its slot and phase; the next to release
  int seen = 0, seen_slot = 0, rel = 0, rel_slot = 0;
  uint32_t seen_par = 0;
  for (int r0 = 0; r0 < ngr; r0 += nteam) {
    const int gam = r0 + y.team;
    if (y.team < nteam && gam < ngr) {
      const int i = gam >> LOG_E, j = gam & (E - 1);
      while (seen <= i) {
        mbar_wait(y.bars + 8 * seen_slot, seen_par);
        ++seen;
        if (++seen_slot == ns) seen_slot = 0, seen_par ^= 1u;
      }
      int slot = seen_slot - (seen - i);  // stage i's: seen - i < ns
      if (slot < 0) slot += ns;
      const unsigned char* st = y.smem + slot * sb;
      const int k0 = j * U + ((y.c_beg + i) << lgs);
      const int lsh = BL * (j / NL), hsh = BH * j;
      const unsigned char* lo = st + sg.lo + ((j & (NL - 1)) << lgs) * cols + y.c0;
      const unsigned char* hi = st + sg.hi + y.c0;
      const int xslot = y.tab[MAXE + j] + (k0 >> 8) - y.tab[j];
      const int* xw = y.x8w + (xslot * 64 + ((k0 & (SEG - 1)) >> 2)) * NBP;
      int pacc[C][NB];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int b = 0; b < NB; ++b) pacc[c][b] = 0;
#pragma unroll 2
      for (int kk = 0; kk < gs; kk += 4) {
        uint32_t lw[4][C / 4], hw[4][C / 4];
#pragma unroll
        for (int r = 0; r < 4; ++r) lds_row<C>(lw[r], lo + (kk + r) * cols);
        if constexpr (BH != 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r) lds_row<C>(hw[r], hi + (kk + r) * cols);
        }
        int xv[NB];
        lds_x<NB, NBP>(xv, xw + (kk >> 2) * NBP);
#pragma unroll
        for (int qd = 0; qd < C / 4; ++qd) {
          uint32_t q[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            uint32_t v = (lw[r][qd] >> lsh) & MLO;
            if constexpr (BH != 0) v |= ((hw[r][qd] >> hsh) & MHI) << BL;
            if constexpr (DEC) v = decode<BL == 2 && BH == 0>(v, dc);
            q[r] = v;
          }
          uint32_t col[4];
          transpose4(q, col);
#pragma unroll
          for (int c = 0; c < 4; ++c)
#pragma unroll
            for (int b = 0; b < NB; ++b)
              pacc[4 * qd + c][b] = __dp4a((int)col[c], xv[b], pacc[4 * qd + c][b]);
        }
      }
      float sc[C], fbv[C];
      lds_bf16<C>(sc, reinterpret_cast<const uint16_t*>(st + sg.fs) + j * cols + y.c0);
      if (P.fb != nullptr) {
        lds_bf16<C>(fbv, reinterpret_cast<const uint16_t*>(st + sg.fb) + j * cols + y.c0);
      } else {
#pragma unroll
        for (int c = 0; c < C; ++c) fbv[c] = P.off * sc[c];
      }
      const int grp = (k0 & (SEG - 1)) >> lgs;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float xsb = y.xsv[xslot * NBP + b];
        const float s8 = y.bias ? (float)y.gsum[(xslot * GPS + grp) * NBP + b] : 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[c][b] += (float)pacc[c][b] * (sc[c] * xsb);
          if (y.bias) acc[c][b] += fbv[c] * (s8 * xsb);
        }
      }
    }
    // release the stages all of whose groups lie in this round or before
    const int done = min(y.nst, (r0 + nteam) >> LOG_E);
    while (seen < done) {
      mbar_wait(y.bars + 8 * seen_slot, seen_par);
      ++seen;
      if (++seen_slot == ns) seen_slot = 0, seen_par ^= 1u;
    }
    __syncwarp();
    if (y.lane == 0)
      for (; rel < done; ++rel) {
        mbar_arrive(y.bars + 8 * (ns + rel_slot));
        if (++rel_slot == ns) rel_slot = 0;
      }
  }
}

// gemv_loop for planes of 4 low bits and none high (Q4_0, Q4_1, Q4_K and
// the 4-bit codes): a unit row's byte holds group 0's value in its low
// nibble and group 1's in its high one, so an item takes both groups of a
// stage's C columns and reads, transposes (and decodes) each byte once.
// Team t takes stages t, t + nteam, ...
template <int NB, bool DEC>
__device__ __forceinline__ void gemv_loop40(const Args& a, const Plane& P, const Stage& sg,
                                            const Body& y, const Decoder& dc,
                                            float (&acc)[cols_per_thread(NB)][NB]) {
  constexpr int C = cols_per_thread(NB);
  constexpr int NBP = padded_rows(NB);
  const int ns = a.ns, cols = a.cols, nteam = a.nteam, sb = a.sb;
  const int gs = P.gs, lgs = __ffs(gs) - 1, U = P.U;
  int seen = 0, seen_slot = 0, rel = 0, rel_slot = 0;
  uint32_t seen_par = 0;
  for (int r0 = 0; r0 < y.nst; r0 += nteam) {
    const int i = r0 + y.team;
    if (y.team < nteam && i < y.nst) {
      while (seen <= i) {
        mbar_wait(y.bars + 8 * seen_slot, seen_par);
        ++seen;
        if (++seen_slot == ns) seen_slot = 0, seen_par ^= 1u;
      }
      int slot = seen_slot - (seen - i);
      if (slot < 0) slot += ns;
      const unsigned char* st = y.smem + slot * sb;
      const int k0 = (y.c_beg + i) << lgs, k1 = U + k0;  // the two groups' first lanes
      const unsigned char* lo = st + sg.lo + y.c0;
      const int xs0 = y.tab[MAXE] + (k0 >> 8) - y.tab[0];
      const int xs1 = y.tab[MAXE + 1] + (k1 >> 8) - y.tab[1];
      const int* xw0 = y.x8w + (xs0 * 64 + ((k0 & (SEG - 1)) >> 2)) * NBP;
      const int* xw1 = y.x8w + (xs1 * 64 + ((k1 & (SEG - 1)) >> 2)) * NBP;
      int pacc[2][C][NB];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int b = 0; b < NB; ++b) pacc[h][c][b] = 0;
#pragma unroll 2
      for (int kk = 0; kk < gs; kk += 4) {
        uint32_t lw[4][C / 4];
#pragma unroll
        for (int r = 0; r < 4; ++r) lds_row<C>(lw[r], lo + (kk + r) * cols);
        int x0[NB], x1[NB];
        lds_x<NB, NBP>(x0, xw0 + (kk >> 2) * NBP);
        lds_x<NB, NBP>(x1, xw1 + (kk >> 2) * NBP);
#pragma unroll
        for (int qd = 0; qd < C / 4; ++qd) {
          if constexpr (DEC) {
            // per row: [c0 g0, c0 g1, c1 g0, c1 g1] and the same for c2, c3
            uint32_t d0[4], d1[4], t0[4], t1[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) decode_nibbles(lw[r][qd], dc, d0[r], d1[r]);
            transpose4(d0, t0);
            transpose4(d1, t1);
#pragma unroll
            for (int b = 0; b < NB; ++b) {
              pacc[0][4 * qd][b] = __dp4a((int)t0[0], x0[b], pacc[0][4 * qd][b]);
              pacc[1][4 * qd][b] = __dp4a((int)t0[1], x1[b], pacc[1][4 * qd][b]);
              pacc[0][4 * qd + 1][b] = __dp4a((int)t0[2], x0[b], pacc[0][4 * qd + 1][b]);
              pacc[1][4 * qd + 1][b] = __dp4a((int)t0[3], x1[b], pacc[1][4 * qd + 1][b]);
              pacc[0][4 * qd + 2][b] = __dp4a((int)t1[0], x0[b], pacc[0][4 * qd + 2][b]);
              pacc[1][4 * qd + 2][b] = __dp4a((int)t1[1], x1[b], pacc[1][4 * qd + 2][b]);
              pacc[0][4 * qd + 3][b] = __dp4a((int)t1[2], x0[b], pacc[0][4 * qd + 3][b]);
              pacc[1][4 * qd + 3][b] = __dp4a((int)t1[3], x1[b], pacc[1][4 * qd + 3][b]);
            }
          } else {
            uint32_t q[4], col[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) q[r] = lw[r][qd];
            transpose4(q, col);  // raw bytes: both nibbles of 4 rows a column
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int v0 = (int)(col[c] & 0x0f0f0f0fu), v1 = (int)((col[c] >> 4) & 0x0f0f0f0fu);
#pragma unroll
              for (int b = 0; b < NB; ++b) {
                pacc[0][4 * qd + c][b] = __dp4a(v0, x0[b], pacc[0][4 * qd + c][b]);
                pacc[1][4 * qd + c][b] = __dp4a(v1, x1[b], pacc[1][4 * qd + c][b]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float sc[C], fbv[C];
        lds_bf16<C>(sc, reinterpret_cast<const uint16_t*>(st + sg.fs) + h * cols + y.c0);
        if (P.fb != nullptr) {
          lds_bf16<C>(fbv, reinterpret_cast<const uint16_t*>(st + sg.fb) + h * cols + y.c0);
        } else {
#pragma unroll
          for (int c = 0; c < C; ++c) fbv[c] = P.off * sc[c];
        }
        const int xsl = h ? xs1 : xs0, kh = h ? k1 : k0;
        const int grp = (kh & (SEG - 1)) >> lgs;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const float xsb = y.xsv[xsl * NBP + b];
          const float s8 = y.bias ? (float)y.gsum[(xsl * GPS + grp) * NBP + b] : 0.f;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[c][b] += (float)pacc[h][c][b] * (sc[c] * xsb);
            if (y.bias) acc[c][b] += fbv[c] * (s8 * xsb);
          }
        }
      }
    }
    const int done = min(y.nst, r0 + nteam);
    while (seen < done) {
      mbar_wait(y.bars + 8 * seen_slot, seen_par);
      ++seen;
      if (++seen_slot == ns) seen_slot = 0, seen_par ^= 1u;
    }
    __syncwarp();
    if (y.lane == 0)
      for (; rel < done; ++rel) {
        mbar_arrive(y.bars + 8 * (ns + rel_slot));
        if (++rel_slot == ns) rel_slot = 0;
      }
  }
}

// grid.x: column tiles of plane A then plane B; grid.y: K splits; grid.z:
// row groups of NB rows (K5: one row each, ids non-null).
template <int NB>
__global__ void __launch_bounds__(NTH, 2)
    qp8_gemv_kernel(const __grid_constant__ Args a, const __grid_constant__ Maps maps) {
  constexpr int C = cols_per_thread(NB);
  constexpr int NBP = padded_rows(NB);
  extern __shared__ __align__(128) unsigned char smem[];
  const int pi = (int)blockIdx.x >= a.nblk_a;
  const Plane P = pi ? a.B : a.A;  // a copy: fields in registers
  const int cb = pi ? (int)blockIdx.x - a.nblk_a : (int)blockIdx.x;
  const int cols = a.cols, ns = a.ns;
  const int out_col0 = (pi ? a.A.n2 : 0) + cb * cols;
  const int row0 = blockIdx.z * NB;
  const int rows = gridDim.z * NB;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this block's split: unit chunks [c_beg, c_end), a whole number
  const int c_beg = (int)((long long)blockIdx.y * P.nchunks / a.ks);
  const int c_end = (int)((long long)(blockIdx.y + 1) * P.nchunks / a.ks);
  const int nst = c_end - c_beg;
  const Stage sg = stage_of(P, cols);
  const Layout L = layout_of(a.sb, ns, a.slots, NB);
  const uint32_t base = smem_u32(smem);
  const uint32_t bars = base + L.bars;  // full[ns], then empty[ns]
  int* x8w = reinterpret_cast<int*>(smem + L.x8);
  float* xsv = reinterpret_cast<float*>(smem + L.xs);
  int* gsum = reinterpret_cast<int*>(smem + L.gsum);
  int* tab = reinterpret_cast<int*>(smem + L.tab);  // seg_lo[E], slot base[E + 1]
  float* redss = reinterpret_cast<float*>(smem + L.redss);
  float* inv = reinterpret_cast<float*>(smem + L.inv);
  int* flag = reinterpret_cast<int*>(smem + L.flag);

  int lane0 = 0;
  bool valid = true;
  if (a.ids != nullptr) {
    const int e = __ldg(a.ids + blockIdx.z);
    valid = e >= 0 && e < a.n_exp;
    lane0 = valid ? e * a.npe : 0;
  }

  if (tid == 0) {
    for (int s = 0; s < ns; ++s) {
      mbar_init(bars + 8 * s, 1);             // the producer's expected bytes
      mbar_init(bars + 8 * (ns + s), NCW);    // every consumer warp's release
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the segments of each group row's K range [j*U + u_beg, j*U + u_end)
    int slot = 0;
    for (int j = 0; j < P.E; ++j) {
      const int k_beg = j * P.U + c_beg * P.gs, k_end = j * P.U + c_end * P.gs;
      tab[j] = k_beg / SEG;
      tab[MAXE + j] = slot;
      slot += nst > 0 ? (k_end - 1) / SEG - k_beg / SEG + 1 : 0;
    }
    tab[MAXE + P.E] = slot;
  }
  __syncthreads();

  if (warp == NCW) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      const int col = lane0 + cb * cols;
      const uint64_t pol = evict_first_policy();
      for (int i = 0, slot = 0, par = 0; i < nst; ++i) {
        if (i >= ns) mbar_wait(bars + 8 * (ns + slot), par ^ 1);
        const uint32_t full = bars + 8 * slot, dst = base + slot * a.sb;
        const int ch = c_beg + i;
        mbar_expect_tx(full, sg.tx);
        tma_load_3d_ef(dst + sg.lo, &maps.lo[pi], col, ch * P.gs, 0, full, pol);
        if (P.bh) tma_load_2d_ef(dst + sg.hi, &maps.hi[pi], col, ch * P.gs, full, pol);
        tma_load_3d_ef(dst + sg.fs, &maps.fs[pi], col, ch, 0, full, pol);
        if (P.fb != nullptr) tma_load_3d_ef(dst + sg.fb, &maps.fb[pi], col, ch, 0, full, pol);
        if (++slot == ns) slot = 0, par ^= 1;
      }
    }
    return;
  }

  // ---- the activation prologue, while the ring fills ----
  const int K = a.K;
  const int xstride = a.mode == 2 ? 2 * K : K;
  if (a.mode == 1) {
    // 256 virtual threads t' = tid + 128 h, in one fixed order
    for (int b = 0; b < NB; ++b) {
      const float* xr = a.x + (size_t)(row0 + b) * xstride;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float ss = 0.f;
        for (int k0 = tid + NCT * h; k0 < K; k0 += 8 * SEG) {  // 8 loads in flight
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = k0 + u * SEG < K ? xr[k0 + u * SEG] : 0.f;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (k0 + u * SEG < K) ss += v[u] * v[u];
        }
        ss = warp_sum(ss);
        if (lane == 0) redss[b * 8 + warp + NCW * h] = ss;
      }
    }
    consumers_sync();
    if (tid < NB) {
      float s = 0.f;
      for (int w = 0; w < SEG / 32; ++w) s += redss[tid * 8 + w];
      inv[tid] = 1.f / sqrtf(s / (float)K + a.eps);
    }
    consumers_sync();
  }
  const bool bias = P.fb != nullptr || P.off != 0.f;
  const int nslots = tab[MAXE + P.E];
  const int lpg = P.gs / 8;  // lanes a group of the segment
  // a warp takes two (segment slot, row) tasks at a time, both tasks'
  // loads in flight before either is quantized
  const int ntask = nslots * NB;
  for (int t0 = warp; t0 < ntask; t0 += 2 * NCW) {
    float v[2][8], u[2][8];
    int slots[2], rows_b[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int task = min(t0 + q * NCW, ntask - 1);
      const int slot = task / NB, b = task - slot * NB;
      int j = 0;
      while (tab[MAXE + j + 1] <= slot) ++j;
      const int k = (tab[j] + slot - tab[MAXE + j]) * SEG + lane * 8;
      const float* xr = a.x + (size_t)(row0 + b) * xstride;
      slots[q] = slot;
      rows_b[q] = b;
      const float4 p0 = *reinterpret_cast<const float4*>(xr + k);
      const float4 p1 = *reinterpret_cast<const float4*>(xr + k + 4);
      v[q][0] = p0.x; v[q][1] = p0.y; v[q][2] = p0.z; v[q][3] = p0.w;
      v[q][4] = p1.x; v[q][5] = p1.y; v[q][6] = p1.z; v[q][7] = p1.w;
      if (a.mode != 0) {  // up (act) or the norm weight
        const float* w = a.mode == 2 ? xr + K + k : a.wn + k;
        const float4 w0 = *reinterpret_cast<const float4*>(w);
        const float4 w1 = *reinterpret_cast<const float4*>(w + 4);
        u[q][0] = w0.x; u[q][1] = w0.y; u[q][2] = w0.z; u[q][3] = w0.w;
        u[q][4] = w1.x; u[q][5] = w1.y; u[q][6] = w1.z; u[q][7] = w1.w;
      }
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (t0 + q * NCW >= ntask) break;
      const int slot = slots[q], b = rows_b[q];
      if (a.mode == 2) {
        // the act's template instance, picked by a uniform branch a task
        if (a.act == ACT_GELU) act_mul8<ACT_GELU>(v[q], u[q]);
        else if (a.act == ACT_RELU) act_mul8<ACT_RELU>(v[q], u[q]);
        else act_mul8<ACT_SILU>(v[q], u[q]);
      } else if (a.mode == 1) {
        const float ib = inv[b];
#pragma unroll
        for (int i = 0; i < 8; ++i) v[q][i] = v[q][i] * ib * u[q][i];
      }
      float m = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) m = fmaxf(m, fabsf(v[q][i]));
      const float amax = warp_max(m);
      const float iscale = amax > 0.f ? 127.f / amax : 0.f;
      uint32_t w[2] = {0u, 0u};
      int s8 = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qv = __float2int_rn(v[q][i] * iscale);
        s8 += qv;
        w[i >> 2] |= ((uint32_t)qv & 0xffu) << (8 * (i & 3));
      }
      x8w[(slot * 64 + 2 * lane) * NBP + b] = (int)w[0];
      x8w[(slot * 64 + 2 * lane + 1) * NBP + b] = (int)w[1];
      if (lane == 0) xsv[slot * NBP + b] = amax * (1.0f / 127.0f);
      if (bias) {
        for (int o = 1; o < lpg; o <<= 1) s8 += __shfl_xor_sync(0xffffffffu, s8, o);
        if (lane % lpg == 0) gsum[(slot * GPS + lane / lpg) * NBP + b] = s8;
      }
    }
  }
  consumers_sync();

  // ---- the GEMV over the ring: one loop body a plane family ----
  const int tpt = cols / C;  // threads a team
  const int team = tid / tpt, c0 = (tid - team * tpt) * C;
  float acc[C][NB];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[c][b] = 0.f;
  const Body y{smem, bars, x8w, xsv, gsum, tab, team, c0, c_beg, nst, lane, bias};
  const int fam = P.bl * 4 + P.bh;
  if (P.cm != CM_NONE) {
    const Decoder dc = decoder_of(P.cm, P.bh ? 2 : 3);  // the alphabet, once
    if (fam == 16) gemv_loop40<NB, true>(a, P, sg, y, dc, acc);
    else if (fam == 9) gemv_loop<NB, 2, 1, true>(a, P, sg, y, dc, acc);
    else gemv_loop<NB, 2, 0, true>(a, P, sg, y, dc, acc);
  } else {
    const Decoder dc{};
    if (fam == 16) gemv_loop40<NB, false>(a, P, sg, y, dc, acc);
    else if (fam == 17) gemv_loop<NB, 4, 1, false>(a, P, sg, y, dc, acc);
    else if (fam == 18) gemv_loop<NB, 4, 2, false>(a, P, sg, y, dc, acc);
    else if (fam == 9) gemv_loop<NB, 2, 1, false>(a, P, sg, y, dc, acc);
    else gemv_loop<NB, 2, 0, false>(a, P, sg, y, dc, acc);
  }

  // ---- the teams' sums, in team order, then the split's sum ----
  consumers_sync();  // every stage consumed: the ring is free
  float* red = reinterpret_cast<float*>(smem);  // [teams][NB][cols]
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int c = 0; c < C; ++c) red[(team * NB + b) * cols + c0 + c] = acc[c][b];
  consumers_sync();
  const int nteam = min(a.nteam, NCT / tpt);
  for (int e = tid; e < NB * cols; e += NCT) {
    const int b = e / cols, cl = e - b * cols;
    float v = 0.f;
    for (int t = 0; t < nteam; ++t) v += red[(t * NB + b) * cols + cl];
    if (!valid) v = __int_as_float(0x7fc00000);  // NaN: expert id out of range
    const int r = row0 + b, col = out_col0 + cl;
    if (a.ks == 1) {
      if (a.res != nullptr && col < a.n_res) v += a.res[(size_t)r * a.n_res + col];
      a.out[(size_t)r * a.ncols + col] = v;
    } else {
      a.ws[((size_t)blockIdx.y * rows + r) * a.ncols + col] = v;
    }
  }
  if (a.ks == 1) return;
  __threadfence();
  consumers_sync();
  int* counter = a.counters + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) *flag = atomicAdd(counter, 1) == a.ks - 1;
  consumers_sync();
  if (!*flag) return;
  __threadfence();  // the other splits' partials are visible past this
  for (int e = tid; e < NB * cols; e += NCT) {
    const int b = e / cols, cl = e - b * cols;
    const int r = row0 + b, col = out_col0 + cl;
    float v = 0.f;
    for (int s = 0; s < a.ks; ++s)
      v += __ldcg(a.ws + ((size_t)s * rows + r) * a.ncols + col);
    if (a.res != nullptr && col < a.n_res) v += a.res[(size_t)r * a.n_res + col];
    a.out[(size_t)r * a.ncols + col] = v;
  }
  if (tid == 0) *counter = 0;  // ready for the next call
}

// The geometry of a plane set of K rows; false when the kernel cannot take
// it (see qp8_gemv_run).
bool make_plane(Plane* p, const void* fq, const void* fs, const void* fb, int n2, int ld,
                int bl, int bh, int gs, float off, int cm, int mapw, int K) {
  *p = Plane{(const uint8_t*)fq, (const uint16_t*)fs, (const uint16_t*)fb, n2, ld, bl, bh, gs,
             off, cm, mapw, 0, 0, 0, 0};
  if (fq == nullptr || fs == nullptr || (bl != 2 && bl != 4) || (bh != 0 && bh != 1 && bh != 2) ||
      (bh && bl % bh) || gs < 16 || SEG % gs || ld % 128 || n2 % 128 || mapw < n2 || cm < CM_NONE ||
      cm > CM_TERN)
    return false;
  p->U = K * (bh ? bh : bl) / 8;
  p->nl = bh ? bl / bh : 1;
  p->E = K / p->U;
  p->nchunks = p->U / gs;
  return p->U % gs == 0 && p->E <= MAXE && p->nl * p->U * 8 == K * bl;
}

// The tensor maps of plane p into slot i of maps, for tiles of `cols` lanes.
bool make_maps(Maps* m, int i, const Plane& p, int cols) {
  const long long ld = p.ld;
  bool ok = encode_map_3d(&m->lo[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, p.fq, p.mapw, p.U, p.nl, ld,
                          ld * p.U, cols, p.gs, p.nl);
  const int gpu = p.U / p.gs;  // group rows a period
  ok = ok && encode_map_3d(&m->fs[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.fs, p.mapw, gpu, p.E,
                           ld * 2, ld * 2 * gpu, cols, 1, p.E);
  if (p.bh)
    ok = ok && encode_map_2d(&m->hi[i], CU_TENSOR_MAP_DATA_TYPE_UINT8,
                             p.fq + (size_t)p.nl * p.U * p.ld, p.mapw, p.U, ld, cols, p.gs,
                             CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    m->hi[i] = m->lo[i];  // unused
  if (p.fb != nullptr)
    ok = ok && encode_map_3d(&m->fb[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.fb, p.mapw, gpu, p.E,
                             ld * 2, ld * 2 * gpu, cols, 1, p.E);
  else
    m->fb[i] = m->fs[i];  // unused
  return ok;
}

template <int NB>
int launch(const Args& a, const Maps& maps, dim3 grid, int smem, cudaStream_t s) {
  static bool attr_set = false;
  auto kern = qp8_gemv_kernel<NB>;
  if (!attr_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  kern<<<grid, NTH, smem, s>>>(a, maps);
  return (int)cudaGetLastError();
}

// Checks the launch's plan, makes the maps and launches.
int run(Args& a, int NB, int rows_z, bool dual, cudaStream_t s) {
  const int cp = cols_per_thread(NB);
  if (a.cols != 128 && a.cols != 256) return (int)cudaErrorInvalidValue;
  if (a.A.n2 % a.cols || a.B.n2 % a.cols || a.ks < 1 || a.ns < 1 || a.ns > 64 ||
      a.nteam < 1 || a.nteam > NCT * cp / a.cols || a.K % SEG)
    return (int)cudaErrorInvalidValue;
  a.sb = 0;
  a.slots = 0;
  const Plane* planes[2] = {&a.A, &a.B};
  for (const Plane* p : planes) {
    if (a.ks > p->nchunks) return (int)cudaErrorInvalidValue;
    const Stage st = stage_of(*p, a.cols);
    a.sb = st.bytes > a.sb ? st.bytes : a.sb;
    const int sl = max_slots(*p, a.ks);
    a.slots = sl > a.slots ? sl : a.slots;
    // a round's groups must fit the ring: ceil(nteam/E) + 1 stages
    const int per_block = (p->nchunks + a.ks - 1) / a.ks;
    if (per_block > a.ns && a.nteam > (a.ns - 1) * items_per_stage(*p))
      return (int)cudaErrorInvalidValue;
  }
  const Layout L = layout_of(a.sb, a.ns, a.slots, NB);
  if (L.total > SMEM_MAX) return (int)cudaErrorInvalidValue;
  Maps maps;
  if (!make_maps(&maps, 0, a.A, a.cols) || !make_maps(&maps, 1, dual ? a.B : a.A, a.cols))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(a.A.n2 / a.cols + (dual ? a.B.n2 / a.cols : 0), a.ks, rows_z);
  switch (NB) {
    case 1: return launch<1>(a, maps, grid, L.total, s);
    case 2: return launch<2>(a, maps, grid, L.total, s);
    case 3: return launch<3>(a, maps, grid, L.total, s);
    case 4: return launch<4>(a, maps, grid, L.total, s);
    case 5: return launch<5>(a, maps, grid, L.total, s);
    case 6: return launch<6>(a, maps, grid, L.total, s);
    case 7: return launch<7>(a, maps, grid, L.total, s);
    case 8: return launch<8>(a, maps, grid, L.total, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* ght_error_string(int e) { return cudaGetErrorString((cudaError_t)e); }

// K1 / K2: one launch a call.  x f32 [NB, K] ([NB, 2K] gate ++ up in mode
// 2, act(gate) * up with act an ACT_* id), wn f32 [K] (mode 1); plane B is used when n2_b > 0 (K2, the dual
// projection), its columns after A's.  The plan (kernels.pick_gemv): cols
// lanes a tile (128 or 256), ks splits of K (ws f32 [ks, NB, n2_a + n2_b]
// when ks > 1), ns ring stages, nteam teams at work; counters int32, one a
// column tile, zero (each call leaves them so).  out f32 [NB, n2_a + n2_b]
// (+ res f32 [NB, n_res] on columns < n_res).
int qp8_gemv_run(const float* x, const float* wn, int mode, int act, float eps, int NB, int K,
                 const void* fq_a, const void* fs_a, const void* fb_a, int n2_a, int ld_a,
                 int bl_a, int bh_a, int gs_a, float off_a, int cm_a, const void* fq_b,
                 const void* fs_b, const void* fb_b, int n2_b, int ld_b, int bl_b, int bh_b,
                 int gs_b, float off_b, int cm_b, int cols, int ks, int ns, int nteam, float* ws,
                 int* counters, float* out, const float* res, int n_res, void* stream) {
  Args a{};
  if (NB < 1 || NB > 8 || mode < 0 || mode > 2 || (mode == 1 && wn == nullptr) || x == nullptr ||
      act < ACT_SILU || act > ACT_RELU ||
      out == nullptr || counters == nullptr || (ks > 1 && ws == nullptr) ||
      !make_plane(&a.A, fq_a, fs_a, fb_a, n2_a, ld_a, bl_a, bh_a, gs_a, off_a, cm_a, n2_a, K))
    return (int)cudaErrorInvalidValue;
  if (n2_b > 0) {
    if (!make_plane(&a.B, fq_b, fs_b, fb_b, n2_b, ld_b, bl_b, bh_b, gs_b, off_b, cm_b, n2_b, K))
      return (int)cudaErrorInvalidValue;
  } else {
    a.B = a.A;
  }
  a.nblk_a = n2_a / cols;
  a.K = K;
  a.mode = mode;
  a.act = act;
  a.eps = eps;
  a.x = x;
  a.wn = wn;
  a.res = res;
  a.n_res = res != nullptr ? n_res : 0;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.ks = ks;
  a.ns = ns;
  a.nteam = nteam;
  a.cols = cols;
  a.ncols = n2_a + (n2_b > 0 ? n2_b : 0);
  a.ids = nullptr;
  return run(a, NB, 1, n2_b > 0, (cudaStream_t)stream);
}

// K5: row p of x f32 [P, K] against lanes [ids[p]*npe, (ids[p]+1)*npe) of
// the stacked planes (n_exp * npe lanes, row pitch ld), one launch.  The
// plan and scratch as for qp8_gemv_run (ws f32 [ks, P, npe], counters one
// a tile and row); out f32 [P, npe].
int qp8_indirect_run(const float* x, int P, int K, const int* ids, int npe, int n_exp,
                     const void* fq, const void* fs, const void* fb, int ld, int bl, int bh,
                     int gs, float off, int cm, int cols, int ks, int ns, int nteam, float* ws,
                     int* counters, float* out, void* stream) {
  Args a{};
  if (P < 1 || P > 65535 || n_exp < 1 || x == nullptr || ids == nullptr || out == nullptr ||
      counters == nullptr || (ks > 1 && ws == nullptr) ||
      !make_plane(&a.A, fq, fs, fb, npe, ld, bl, bh, gs, off, cm, n_exp * npe, K))
    return (int)cudaErrorInvalidValue;
  a.B = a.A;
  a.nblk_a = npe / cols;
  a.K = K;
  a.mode = 0;
  a.x = x;
  a.out = out;
  a.ws = ws;
  a.counters = counters;
  a.ks = ks;
  a.ns = ns;
  a.nteam = nteam;
  a.cols = cols;
  a.ncols = npe;
  a.ids = ids;
  a.npe = npe;
  a.n_exp = n_exp;
  return run(a, 1, P, false, (cudaStream_t)stream);
}

}  // extern "C"
