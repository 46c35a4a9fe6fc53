// The crush search of every kernel that lays a block over eight lanes: the
// owner crush (encode_merged.cuh, both layouts) and the region encode
// (region_encode.cuh: the fixed grid's 8x8 blocks and the RD levels'
// regions of 256, 1024 and 4096 pixels). It is ops/crush.py find_shifts on
// region values, bit for bit: ladder (25 distinct sweeps, the 64-key box,
// the top K verified), exhaustive (729 triples) and guess, with the floors
// of the reduced-factor modes.
//
// The lane geometry: eight lanes a block, lane sub of a block holding 8
// pixels (in the owner crush column sub of an 8x8 block; in the region
// encode pixels t + T j of its region, T = P / 8), four blocks a warp. A
// block's region is the block itself (level 0), its warp (level 1), an
// aligned group of 4 warps (level 2) or of 16 (level 3); the level is
// uniform over a warp. The policy is what the caller sets: each lane's
// level (owner), whether its CTA holds a region of level 2 or more (xchg,
// uniform over the CTA: such a CTA passes one barrier a batch), the warps
// of the CTA (WARPS, the exchange's slots) and the highest level a CTA can
// hold (L). Integer totals (pixel maxima, error sums, counts) do not depend
// on the order of their reduction: by xor 1, 2, 4 over a block, one warp
// reduction over a warp, and one shared-memory exchange across warps.
//
// The search: the 27 per-axis sweeps are 25 distinct triples, evaluated in
// one batch on a per-pixel base shared by the sweeps of an axis; the
// region's values of a batch sit in shared memory, one row a block (or
// warp), so no lane holds 54 sweep values; the ladder's 64 keys sit 8 a
// lane and are peeled by an arg-max (lowest index on ties) by xor 1, 2, 4;
// the K candidates do not depend on each other's errors and are verified
// kCandBatch a batch; exhaustive mode goes 9 a batch, guess mode in one
// batch with (0, 0, 0), whose values are the reduced-factor floors. Each
// block's decode frame (axis normals and offsets) sits in shared memory and
// is read once per candidate; a decoded channel's clamp to [0, 255] is one
// DPX instruction (__vimin_s32_relu).

#pragma once

#include "limg_common.cuh"

namespace limg {

struct IAdd {
  __device__ int operator()(int a, int b) const { return add_wrap(a, b); }
};
struct IMax {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct LMax {
  __device__ long long operator()(long long a, long long b) const { return a > b ? a : b; }
};

// limg_common.cuh pixel_err of pixel k of px (one row of pixels a
// channel), the clamp to [0, 255] by one instruction (__vimin_s32_relu:
// max(min(x, 255), 0)): the crush search's and crush_eval.cu's error.
template <int CH, int N>
__device__ __forceinline__ int clamped_pixel_err(const int (&est)[CH], const int (&px)[CH][N],
                                                 int k) {
  int d2[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int d = __vimin_s32_relu(est[c], 255) - px[c][k];
    d2[c] = d * d;
  }
  const bool lo = d2[0] < 0x4000;
  int e = d2[0] * (lo ? 2 : 3) + d2[1] * 4 + d2[2] * (lo ? 3 : 2);
  if (CH == 4) e += d2[CH - 1] * 3;
  return e;
}

// op over aligned groups of TO lanes by xor butterflies at FROM, 2 FROM,
// ... < TO: the pairwise-adjacent tree over the groups of FROM lanes, the
// same bits in every lane for a commutative op.
template <int FROM, int TO, class T, class Op>
__device__ __forceinline__ T butterfly(T x, Op op) {
#pragma unroll
  for (int off = FROM; off < TO; off <<= 1) x = op(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

constexpr int kMaxCands = 27;                  // candidates in one batch (the sweeps)
constexpr int kBatchVals = 2 * kMaxCands + 2;  // their pixel maxima and error sums, the count
constexpr int kRowStride = kBatchVals + 1;     // a block's row of region values
constexpr int kCandBatch = 8;                  // ladder candidates verified per batch

// Shared memory of one CTA of WARPS warps (4 WARPS blocks): each block's
// decode frame (axis normals n[k][c], then offsets m[k][c]), each block's
// row of region values of the current batch (for a region of one block,
// each block's own row; else the warp's first block's row), the warps'
// partial values for the exchange (two sets), and each block's peeled
// ladder triples.
template <int CH, int WARPS, int L>
struct CrushShared {
  static constexpr int kBlocks = 4 * WARPS;
  int frames[kBlocks * 6 * CH];
  int rows[kBlocks * kRowStride];
  int xs[L >= 2 ? 2 * kBatchVals * WARPS : 1];
  int trips[kBlocks * kCandBatch];
};

// One lane's part of the search of its block's region: its 8 pixels and
// their u8 factors in registers, the block's decode frame in shared
// memory, and the state of the search (see the top of this file).
template <int CH, int WARPS, int L>
struct CrushLane {
  int px[CH][8];
  int f8w[8];      // pixel k's u8 factors, axis a in byte a
  int vmask;       // bit k: pixel k lies inside the image
  int sub, lane, warp, blk, owner, set;
  bool xchg;
  int count;       // region pixel count
  int max_pix, max_blk, es;
  bool floors;
  int floor_pix, floor_blk;
  CrushShared<CH, WARPS, L>* sh;

  // the block's axis normal n[k][c] and offset m[k][c]
  __device__ const int* frame() const { return sh->frames + blk * 6 * CH; }
  __device__ int n_at(int k, int c) const { return frame()[k * CH + c]; }
  __device__ int m_at(int k, int c) const { return frame()[(3 + k) * CH + c]; }

  // Sets the block's decode frame from the region's six endpoint rows (in
  // every lane); the block's lane 0 writes it (an index by lane would put
  // ep in local memory). A __syncwarp must follow before it is read.
  __device__ void set_frame(const int (&ep)[6][CH]) {
    if (sub == 0) {
      int* fr = sh->frames + blk * 6 * CH;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          fr[k * CH + c] = ep[2 * k + 1][c] - ep[2 * k][c];
          fr[(3 + k) * CH + c] = ep[2 * k][c];
        }
      }
    }
  }

  __device__ bool admissible(int pm, int be) const {
    return limg::admissible(pm, be, count, max_pix, max_blk, es, floors, floor_pix, floor_blk);
  }
  __device__ bool operator()(int pm, int be) const { return admissible(pm, be); }

  // clamped_pixel_err of pixel k (0 outside the image)
  __device__ int pixel_err_of(const int (&est)[CH], int k) const {
    const int e = clamped_pixel_err<CH>(est, px, k);
    return ((vmask >> k) & 1) ? e : 0;
  }

  // Exact (pixel max, error sum >> es) of this lane's pixels under the
  // shift triple s (ops/crush.py evaluate_batch; the three axes' offsets,
  // an order-free integer sum, are added first).
  __device__ void eval(const int (&s)[3], int& pm, int& be) const {
    int shr[3], qm[3], mul[3], nn[3][CH], msum[CH];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int se = min(s[k], 8);
      shr[k] = 8 * k + se;
      qm[k] = 0xFF >> se;
      mul[k] = mult_for(se);
#pragma unroll
      for (int c = 0; c < CH; ++c) nn[k][c] = s[k] > 7 ? 0 : n_at(k, c);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c)
      msum[c] = m_at(0, c) + (s[1] > 7 ? 0 : m_at(1, c)) + (s[2] > 7 ? 0 : m_at(2, c));
    pm = 0;
    be = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int est[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) est[c] = msum[c];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int fdec = ((f8w[j] >> shr[k]) & qm[k]) * mul[k];
#pragma unroll
        for (int c = 0; c < CH; ++c) est[c] += (fdec * nn[k][c] + 128) >> 8;
      }
      const int e = pixel_err_of(est, j);
      pm = max(pm, e);
      be = add_wrap(be, e >> es);
    }
  }

  // The sweeps of axis A quantize only A: the decode of the other two axes
  // at shift 0 (offset and unquantized factor term) is the same for all of
  // them, summed once per pixel and channel.
  template <int A>
  __device__ void sweep_base(int (&base)[CH][8]) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        int v = 0;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          if (k != A) v += m_at(k, c) + ((((f8w[j] >> (8 * k)) & 0xFF) * n_at(k, c) + 128) >> 8);
        base[c][j] = v;
      }
    }
  }
  // eval of (A at shift s, the other axes at 0) on sweep_base's sums
  template <int A>
  __device__ void eval_sweep(const int (&base)[CH][8], int s, int& pm, int& be) const {
    const int se = min(s, 8), shr = 8 * A + se, qm = 0xFF >> se, mul = mult_for(se);
    int nn[CH], madd[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      nn[c] = s > 7 ? 0 : n_at(A, c);
      madd[c] = (A == 0 || s <= 7) ? m_at(A, c) : 0;
    }
    pm = 0;
    be = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int fdec = ((f8w[j] >> shr) & qm) * mul;
      int est[CH];
#pragma unroll
      for (int c = 0; c < CH; ++c) est[c] = base[c][j] + madd[c] + ((fdec * nn[c] + 128) >> 8);
      const int e = pixel_err_of(est, j);
      pm = max(pm, e);
      be = add_wrap(be, e >> es);
    }
  }
  // The sweeps of axis A into pairs 9 A + s; (A, 0) is (0, 0, 0) for every
  // axis and is evaluated once, as pair 0.
  template <int A>
  __device__ void sweep_axis() {
    int base[CH][8];
    sweep_base<A>(base);
#pragma unroll 1
    for (int s = A == 0 ? 0 : 1; s < 9; ++s) {
      int pm, be;
      eval_sweep<A>(base, s, pm, be);
      put(9 * A + s, pm, be);
    }
  }

  __device__ int row() const { return owner == 0 ? blk : (blk & ~3); }
  __device__ int* my_row() const { return sh->rows + row() * kRowStride; }

  // Value pair i of a batch: this lane's (pixel max, error sum) over its
  // block (xor 1, 2, 4) or its warp (one warp reduction; integers, so any
  // order), into the block's or warp's row; a warp of a larger region
  // publishes its part for end_batch.
  __device__ void put(int i, int pm, int be) {
    if (owner == 0) {
      pm = butterfly<1, 8>(pm, IMax());
      be = butterfly<1, 8>(be, IAdd());
      if (sub == 0) {
        sh->rows[blk * kRowStride + 2 * i] = pm;
        sh->rows[blk * kRowStride + 2 * i + 1] = be;
      }
      return;
    }
    pm = __reduce_max_sync(kFull, pm);
    be = __reduce_add_sync(kFull, be);
    if (lane != 0) return;
    if (owner == 1) {
      sh->rows[blk * kRowStride + 2 * i] = pm;
      sh->rows[blk * kRowStride + 2 * i + 1] = be;
    } else if constexpr (L >= 2) {
      int* xs = sh->xs + set * kBatchVals * WARPS;
      xs[(2 * i) * WARPS + warp] = pm;
      xs[(2 * i + 1) * WARPS + warp] = be;
    }
  }

  // Ends a batch of n value pairs (and the count at 2 n + 1): one barrier
  // where the CTA exchanges, the level-2 and level-3 regions' values
  // combined one to a lane (max for the pixel maxima, wrapping sums for the
  // rest), then the warp's own row is readable.
  template <int G>
  __device__ void combine(int n) {
    constexpr int kPer = 32 / G;
    const int* xs = sh->xs + set * kBatchVals * WARPS;
    const int base = warp & ~(G - 1);
    for (int r = 0; r < (2 * n + 2 + kPer - 1) / kPer; ++r) {
      const int i = r * kPer + lane / G;
      const bool is_max = i < 2 * n && (i & 1) == 0;
      int x = i < 2 * n + 2 ? xs[i * WARPS + base + lane % G] : 0;
#pragma unroll
      for (int off = 1; off < G; off <<= 1) {
        const int y = __shfl_xor_sync(kFull, x, off);
        x = is_max ? max(x, y) : add_wrap(x, y);
      }
      if (lane % G == 0 && i < 2 * n + 2) my_row()[i] = x;
    }
  }
  __device__ void end_batch(int n, int cnt) {
    // the count: a block's by xor 1, 2, 4, a warp's by one reduction
    if (owner == 0) {
      cnt = butterfly<1, 8>(cnt, IAdd());
      if (sub == 0) sh->rows[blk * kRowStride + 2 * n + 1] = cnt;
    } else {
      cnt = __reduce_add_sync(kFull, cnt);
      if (lane == 0) {
        if (owner == 1) {
          sh->rows[blk * kRowStride + 2 * n + 1] = cnt;
        } else if constexpr (L >= 2) {
          int* xs = sh->xs + set * kBatchVals * WARPS;
          xs[(2 * n) * WARPS + warp] = 0;
          xs[(2 * n + 1) * WARPS + warp] = cnt;
        }
      }
    }
    if constexpr (L >= 2) {
      if (xchg) {
        __syncthreads();
        if (owner == 2) combine<4>(n);
        if constexpr (L >= 3) {
          if (owner == 3) combine<16>(n);
        }
        set ^= 1;
      }
    }
    __syncwarp();
  }
  __device__ int pm_at(int i) const { return my_row()[2 * i]; }
  __device__ int be_at(int i) const { return my_row()[2 * i + 1]; }

  // The floors of the reduced-factor modes: the region values at (0, 0, 0).
  __device__ void set_floors(int num_factors, int pm0, int be0) {
    if (num_factors < 3) {
      floors = true;
      floor_pix = pm0;
      floor_blk = be0;
    }
  }

  // Peels the best remaining of the 64 lattice keys (argmax, lowest index on
  // ties), 8 a lane: key j of this lane is index sub + 8 j.
  __device__ void peel(int (&key)[8], const int (&base)[3], int (&s)[3]) const {
    long long best = (long long)key[0] * 64 + (63 - sub);
#pragma unroll
    for (int j = 1; j < 8; ++j) best = max(best, (long long)key[j] * 64 + (63 - (sub + 8 * j)));
    best = butterfly<1, 8>(best, LMax());
    const int idx = 63 - (int)(best & 63);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (idx == sub + 8 * j) key[j] = kSentinel;
    s[0] = max(base[0] - idx / 16, 0);
    s[1] = max(base[1] - (idx / 4) % 4, 0);
    s[2] = max(base[2] - idx % 4, 0);
  }

  // After the batch of the 27 sweeps: the region's count and floors, and
  // from the sweeps' values the ladder box's base and its 64 lattice keys,
  // 8 a lane (key j of this lane is index sub + 8 j).
  __device__ __forceinline__ void ladder_setup(int num_factors, int (&key)[8], int (&base)[3]) {
    count = my_row()[2 * kMaxCands + 1];
    set_floors(num_factors, pm_at(0), be_at(0));
    LadderBox box;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      int pm_ax[9], be_ax[9];
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        pm_ax[s] = pm_at(s == 0 ? 0 : 9 * a + s);
        be_ax[s] = be_at(s == 0 ? 0 : 9 * a + s);
      }
      ladder_axis(box, a, pm_ax, be_ax, *this);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) key[j] = ladder_key(box, *this, sub + 8 * j);
#pragma unroll
    for (int a = 0; a < 3; ++a) base[a] = box.base[a];
  }

  // The shift triple of this block's region (ops/crush.py find_shifts, its
  // candidates reduced in batches); statically dropped axes get 8. cnt is
  // the lane's count of pixels inside the image; the region's lands in
  // count.
  __device__ void search(int crush_mode, int ladder_k, int num_factors, int cnt,
                         int (&best)[3]) {
    best[0] = best[1] = best[2] = 0;
    floors = false;
    floor_pix = floor_blk = 0;
    if (crush_mode == kLadder) {
      // the 27 per-axis sweeps (axis a at shift s, the other axes
      // unquantized) in one batch
      sweep_axis<0>();
      sweep_axis<1>();
      sweep_axis<2>();
      end_batch(kMaxCands, cnt);
      int key[8], base[3];
      ladder_setup(num_factors, key, base);
      // verify the K best-ranked candidates, best first, kCandBatch a batch
      int* trips = sh->trips + blk * kCandBatch;
      int b_tot = -1, b_err = 2147483647;
#pragma unroll 1
      for (int r0 = 0; r0 < ladder_k; r0 += kCandBatch) {
        const int n = min(kCandBatch, ladder_k - r0);
#pragma unroll 1
        for (int i = 0; i < n; ++i) {
          int s[3], pm, be;
          peel(key, base, s);
          if (sub == 0) trips[i] = s[0] | (s[1] << 4) | (s[2] << 8);
          eval(s, pm, be);
          put(i, pm, be);
        }
        end_batch(n, cnt);
#pragma unroll 1
        for (int i = 0; i < n; ++i) {
          const int tr = trips[i];
          const int s[3] = {tr & 15, (tr >> 4) & 15, tr >> 8};
          take_if_better(*this, s, pm_at(i), be_at(i), false, best, b_tot, b_err);
        }
      }
    } else if (crush_mode == kExhaustive) {
      // all 729 triples in ascending lex order, 9 a batch; ties to later
      int b_tot = -1, b_err = 2147483647;
#pragma unroll 1
      for (int i0 = 0; i0 < 729; i0 += 9) {
#pragma unroll 1
        for (int i = 0; i < 9; ++i) {
          const int s[3] = {(i0 + i) / 81, ((i0 + i) / 9) % 9, i};
          int pm, be;
          eval(s, pm, be);
          put(i, pm, be);
        }
        end_batch(9, cnt);
        if (i0 == 0) {
          count = my_row()[2 * 9 + 1];
          set_floors(num_factors, pm_at(0), be_at(0));
        }
#pragma unroll 1
        for (int i = 0; i < 9; ++i) {
          const int s[3] = {(i0 + i) / 81, ((i0 + i) / 9) % 9, i};
          take_if_better(*this, s, pm_at(i), be_at(i), true, best, b_tot, b_err);
        }
      }
    } else if (crush_mode == kGuess) {
      // (0, 0, 0) for the floors, then the four canned triples
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        int g[3] = {0, 0, 0}, pm, be;
        if (t > 0) guess_triple(t - 1, g);
        eval(g, pm, be);
        put(t, pm, be);
      }
      end_batch(5, cnt);
      count = my_row()[2 * 5 + 1];
      set_floors(num_factors, pm_at(0), be_at(0));
      bool ok[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) ok[t] = admissible(pm_at(1 + t), be_at(1 + t));
      const int pick = guess_pick(ok);
      if (pick >= 0) guess_triple(pick, best);
    } else {
      end_batch(0, cnt);
      count = my_row()[1];
    }
#pragma unroll
    for (int k = 0; k < 3; ++k)
      if (k >= num_factors) best[k] = max(best[k], 8);
  }
};

}  // namespace limg
