// A chain owned by a group of lanes of one warp: the evaluators of the staged
// Gibbs move (resident_walk.cu, move 2), of the staged NUTS kernel
// (resident_nuts.cu), of the staged HMC kernel and MH, MALA and ladder
// moves (resident_hmc.cu, resident_walk.cu moves 0-1 and 3), of the dense
// MH, MALA and ladder moves (LaneDenseEval: resident_walk_dense.cu moves 0-1
// and 3, on a generated body of the lane's own rows), of the SMC mutation
// pass (LaneSplitEval: resident_smc.cu) and of the fused log-posterior
// (LaneStagedEval: fused_mlp_vg.cu); and the fixed-budget NUTS, HMC, MH,
// MALA, power-posterior ladder and SMC mutation loops, each written once over
// the lanes a chain (nuts_chain, hmc_chain, walk_chain, tempering_chain,
// smc_chain: Lanes<1>, one thread a chain, is the layout of dense HMC and
// NUTS and of the SMC closure pass, and the other kernels' on data of few
// rows, for tuning groups larger than a cluster of lane blocks holds, or for
// ladders longer than a block of lane chains holds).
//
// Layout. kLanes consecutive lanes of a warp (1, 2, 4, 8, 16 or 32, a
// compile-time constant) own one chain; chain c is threads [c kLanes, (c + 1)
// kLanes) of the grid, so a warp holds 32 / kLanes whole chains. Lane l
// evaluates the staged data rows l, l + kLanes, ... (stage_data, mlp_vg.cuh).
// A vector of the chain's parameter space is either whole in every lane
// (Gibbs: theta, 32 floats on iris MLP(4,3,2,3)) or spread over the lanes,
// lane l owning the coordinates k kLanes + l, k < kPer (NUTS: every vector of
// the tree state; HMC, MH and MALA: the proposal, momentum or z, gradient and
// the accepted theta and gradient; coordinates at or past P are padding, held
// at 0).
//
// Identical bits. Sums over the chain's lanes (the log-likelihood over the
// rows, the dot products of the NUTS algebra) reduce with an xor butterfly
// (__shfl_xor_sync on the chain's lane mask): at every step a lane adds its
// value and its partner's, and its partner adds the same two values in the
// other order; float addition is commutative, so the pair holds the same bits,
// and by induction every lane of the chain ends with the same bits. Draws
// reach the lanes by shuffles, which copy bits. So every lane holds the same
// value, accept uniform, direction and merge uniform, takes the same accept,
// merge and direction decisions, and every branch that decides the chain's
// state reads only such lane-uniform values: the lanes' copies never part.
//
// Draws. The Threefry words of an iteration (a Gibbs sweep: every sub-block's
// normals and accept uniform; a NUTS iteration: the momenta, then depth by
// depth the direction, leaf and merge uniforms; an HMC, MH or MALA
// iteration: the normal pairs and the accept uniform) are spread over the
// chain's lanes, word g on lane g % kLanes in round g / kLanes, each computed once,
// and reach the lanes that use them by shuffles. A warp issues one instruction
// stream for all its lanes, so a word that every lane computed would cost as
// much as computing it once a lane: spread, the 27 words of a depth-3 iris
// NUTS iteration (or of a config 4 Gibbs sweep) take one Threefry pass at 32
// lanes, where every lane computing every word would take 27. The words, keys
// and counters are those of kernel_prng.cuh's streams, so the plain versions
// stay the oracle.
//
// Gibbs (LaneGibbsEval). The cached interface of resident_loop.cuh::
// gibbs_chain, per lane over the lane's own rows: the cache holds, for each of
// the lane's rows, the hidden activations a(l, j) (the keys and order of
// mlp_math.make_incremental_gibbs), for BCE the lane's partial
// log-likelihood of each output unit, and the prior terms of the coordinates
// the lane owns. update<U> recomputes unit U on the lane's rows from the
// cached upstream activations, then every layer strictly downstream, then
// the loss; the value reduces across the lanes. Unlike make_incremental_gibbs
// the cache leaves out the CE logits: an update of an output unit recomputes
// all of them from the cached last hidden layer (kOut - 1 more units, no
// special function), which keeps kOut floats a row, and their copies in an
// update's new entries, out of the registers, where the spills they caused
// cost more than the units. Whether the cache fits a lane's registers is
// decided when the library is built: the generated gibbs_blocks.cuh says so
// (GibbsBlocks::kCached, from ops/resident_walk.py::gibbs_lane_plan); a model
// over that budget takes the whole value-only forward pass on the same lane
// layout, with only the prior terms cached.
//
// NUTS (LaneStagedEval, nuts_chain). Each value-and-gradient gathers
// theta to every lane through the chain's slot of P floats in shared memory,
// runs the forward and hand-derived backward pass of mlp_vg.cuh on the lane's
// rows, and reduce-scatters the P partial gradients by recursive halving over
// shuffles (kLanes - 1 shuffles for each kLanes coordinates; lane l ends with
// the sums of the coordinates it owns), with no shared memory. The tree state
// of nuts_chain becomes (13 + 2 (D - 1)) kPer floats a lane (on iris at depth
// 3: 68 at 8 lanes, where a thread a chain holds 459), the checkpoint stack
// indexed by popcount through selects over its slots, so it stays in
// registers.
//
// HMC, MH and MALA (hmc_chain, walk_chain on LaneStagedEval, whose value-only
// v() serves MH). The chain's state is 5 kPer floats a lane in registers; the
// kinetic energies, |z|^2, the reverse-proposal norm, the value and the moved
// flag reduce over the lanes, so the accept test, the tuner's statistic and
// the trip count are lane-uniform. A tuning group is a block (a block
// reduction, group_mean) or a cluster.
//
// Occupancy. The kernels are bound by latency rather than by issue: each
// caps its registers by launch bounds so that more warps share an SM
// (ops/resident_walk.py::GIBBS_MIN_BLOCKS and WALK_MIN_BLOCKS,
// ops/resident_nuts.py::NUTS_MIN_BLOCKS, ops/resident_hmc.py::
// HMC_MIN_BLOCKS), and some spill; the lane counts and caps are the fastest
// that scripts/lane_sweep.py measured on the H100 (PERF.md, section 6).
//
// Recording. Samples stay chain-minor [kept, rows, C]. With a chain spread
// over 8 lanes or more a warp's direct stores would fall on runs of fewer
// than 8 chains of a row, under a 32-byte sector, so a recorded state goes
// through a shared-memory tile of the block's chains (record_slot; on at
// most 4 lanes the HMC, walk and ladder loops store directly,
// record_lanes), and every kRecordBatch records (kWalkRecordBatch for HMC, MH
// and MALA, whose blocks hold up to 256 chains) the block writes the batch
// out row by row, coalesced, a block's chains being consecutive
// (flush_records): one barrier a batch.

#pragma once

#include <type_traits>

#include "resident_loop.cuh"

namespace lane_eval {

// f(std::integral_constant<int, i>) for i in [I, N): the cache's entries
// indexed and tested at compile time (if constexpr), so the cache and its
// updates stay in registers.
template <int I, int N, class F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<I + 1, N>(f);
  }
}

using mlp_vg::kActs;
using mlp_vg::kCrossEntropy;
using mlp_vg::kIn;
using mlp_vg::kMaxWidth;
using mlp_vg::kNumLayers;
using mlp_vg::kOut;
using mlp_vg::kP;
using mlp_vg::dim;

// The lanes of one chain. Lanes<1> is one thread a chain: its sums and
// broadcasts are the identity, and nuts_chain then takes the thread layout.
template <int kLanesT>
struct Lanes {
  static constexpr int kLanes = kLanesT;
  static_assert(kLanes == 1 || kLanes == 2 || kLanes == 4 || kLanes == 8 || kLanes == 16 ||
                    kLanes == 32,
                "1, 2, 4, 8, 16 or 32 lanes a chain");
  static constexpr int kPer = (kP + kLanes - 1) / kLanes;  // coordinates a lane owns
  int lane;       // 0 .. kLanes - 1
  unsigned mask;  // the chain's lanes in its warp
  __device__ __forceinline__ Lanes()
      : lane(static_cast<int>(threadIdx.x) % kLanes),
        mask(kLanes == 32 ? 0xffffffffu
                          : ((1u << kLanes) - 1u) << ((threadIdx.x & 31u) & ~(kLanes - 1u))) {}
  // the flat coordinate of owned slot k (at or past kP: padding)
  __device__ __forceinline__ int coord(int k) const { return k * kLanes + lane; }
  // the sum over the chain's lanes, the same bits in every lane
  __device__ __forceinline__ float sum(float v) const {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, kLanes);
    return v;
  }
  // lane src's v, in every lane of the chain
  __device__ __forceinline__ float from(float v, int src) const {
    if constexpr (kLanes == 1) return v;
    return __shfl_sync(mask, v, src, kLanes);
  }
  __device__ __forceinline__ bool any(bool v) const {
    if constexpr (kLanes == 1) return v;
    return (__ballot_sync(mask, v) & mask) != 0u;
  }
};

// Sums over the chain's lanes of g [kP], scattered to the owners: own[k] is
// the sum of coordinate k kLanes + lane (0 for padding). Recursive halving: at
// the step of offset o a lane keeps the half of its remaining entries whose
// bit o matches its own lane's, sends the other half to lane ^ o and adds
// what that lane sends.
template <class L>
__device__ __forceinline__ void reduce_scatter(const L& ln, const float (&g)[kP],
                                               float (&own)[L::kPer]) {
  constexpr int kLanes = L::kLanes;
#pragma unroll
  for (int k = 0; k < L::kPer; ++k) {
    float v[kLanes];
#pragma unroll
    for (int m = 0; m < kLanes; ++m) v[m] = k * kLanes + m < kP ? g[k * kLanes + m] : 0.0f;
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
      const bool up = (ln.lane & o) != 0;
#pragma unroll
      for (int j = 0; j < o; ++j) {
        const float send = up ? v[j] : v[j + o];
        const float keep = up ? v[j + o] : v[j];
        v[j] = keep + __shfl_xor_sync(ln.mask, send, o, kLanes);
      }
    }
    own[k] = v[0];
  }
}

// The prior term of coordinate p at value v: -0.5 (v - loc)^2 / scale^2.
__device__ __forceinline__ float prior_term(const mlp_vg::Data& d, int p, float v) {
  const float diff = v - d.loc[p];
  return -0.5f * diff * diff * d.ivar[p];
}

// theta whole in every lane (full), from the owned coordinates th of the
// chain's lanes, through the chain's slot of kP floats in shared memory.
template <class L>
__device__ __forceinline__ void gather(const L& ln, float* slot, const float (&th)[L::kPer],
                                       float (&full)[kP]) {
  __syncwarp(ln.mask);  // every lane has read the slot of the last call
#pragma unroll
  for (int k = 0; k < L::kPer; ++k) {
    if (ln.coord(k) < kP) slot[ln.coord(k)] = th[k];
  }
  __syncwarp(ln.mask);
#pragma unroll
  for (int p = 0; p < kP; ++p) full[p] = slot[p];
}

// ---- NUTS: value and gradient at a theta spread over the lanes ----

template <class L>
struct LaneStagedEval {
  static constexpr int kPer = L::kPer;
  mlp_vg::Data d;
  float prior_const;
  float temperature;
  int n_rows;
  L ln;
  float* slot;  // this chain's theta, [kP] in shared memory
  // The tempered log-posterior at the theta whose owned coordinates are th;
  // its gradient's owned coordinates into g. The same value in every lane.
  __device__ __forceinline__ float vg(const float (&th)[kPer], float (&g)[kPer]) const {
    float full[kP], gp[kP];
    gather(ln, slot, th, full);
#pragma unroll
    for (int p = 0; p < kP; ++p) gp[p] = 0.0f;
    float part = 0.0f;
#pragma unroll 2  // two rows in flight
    for (int r = ln.lane; r < n_rows; r += L::kLanes) {
      mlp_vg::row_log_lik<true>(full, d, r, part, gp);
    }
    float own[kPer];
    reduce_scatter(ln, gp, own);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = ln.coord(k);
      if (p < kP) {
        const float diff = th[k] - d.loc[p];
        part += -0.5f * diff * diff * d.ivar[p];
        g[k] = temperature * (own[k] - diff * d.ivar[p]);
      } else {
        g[k] = 0.0f;
      }
    }
    return temperature * (ln.sum(part) + prior_const);
  }
  // The tempered log-posterior alone (MH): the forward pass on the lane's
  // rows and the prior terms of its coordinates, summed over the lanes.
  __device__ __forceinline__ float v(const float (&th)[kPer]) const {
    float full[kP], unused[kP];
    gather(ln, slot, th, full);
    float part = 0.0f;
#pragma unroll 2
    for (int r = ln.lane; r < n_rows; r += L::kLanes) {
      mlp_vg::row_log_lik<false>(full, d, r, part, unused);
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = ln.coord(k);
      if (p < kP) part += prior_term(d, p, th[k]);
    }
    return temperature * (ln.sum(part) + prior_const);
  }
};

// ---- dense data: the generated body on the lane's own rows ----

// The dense kernels' evaluator on a group of lanes (resident_walk_dense.cu's
// MH, MALA and ladder moves). Body is the generated dense_body::LaneBody
// (ops/mlp_dense.py::dense_lane_source): Body::v and Body::vg run the dense
// body on the lane's rows l, l + kLanes, ..., whose inputs and labels
// (Body::Rows) are registers that the constructor loads once from the lane's
// constants (everything else folded as in the one-thread body), so every
// lane runs the same code.
// As LaneStagedEval: theta is posted to the chain's slot and read back whole,
// the value summed over the lanes, the gradient reduce-scattered onto the
// owners, and the prior taken on the coordinates each lane owns (their
// locations and precisions in registers too).
template <class L, class Body>
struct LaneDenseEval {
  static constexpr int kPer = L::kPer;
  L ln;
  float* slot;  // this chain's theta, [kP] in shared memory
  typename Body::Rows rows;
  float loc[kPer];
  float ivar[kPer];
  __device__ __forceinline__ LaneDenseEval(const L& lanes, float* chain_slot)
      : ln(lanes), slot(chain_slot), rows(Body::rows(lanes.lane)) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = ln.coord(k);
      loc[k] = p < kP ? Body::loc(p) : 0.0f;
      ivar[k] = p < kP ? Body::ivar(p) : 0.0f;
    }
  }
  __device__ __forceinline__ float vg(const float (&th)[kPer], float (&g)[kPer]) const {
    float full[kP], gp[kP];
    gather(ln, slot, th, full);
    float part = Body::vg(full, rows, gp);
    float own[kPer];
    reduce_scatter(ln, gp, own);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float diff = th[k] - loc[k];
      part += -0.5f * diff * diff * ivar[k];
      g[k] = ln.coord(k) < kP ? Body::kTemperature * (own[k] - diff * ivar[k]) : 0.0f;
    }
    return Body::kTemperature * (ln.sum(part) + Body::kPriorConst);
  }
  __device__ __forceinline__ float v(const float (&th)[kPer]) const {
    float full[kP];
    gather(ln, slot, th, full);
    float part = Body::v(full, rows);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float diff = th[k] - loc[k];
      part += -0.5f * diff * diff * ivar[k];
    }
    return Body::kTemperature * (ln.sum(part) + Body::kPriorConst);
  }
};

// ---- SMC: the split evaluation on the lane's staged rows ----

// resident_loop.cuh::SplitEval's contract on a group of lanes (the SMC
// mutation pass, smc_chain): the target lp + beta ll, beta taken at run time,
// with the untempered log-likelihood ll, summed over the lanes, into ll and
// (vg) the combined gradient beta d ll + d lp of the owned coordinates into
// g. The rows are the block's staged rows, lane l taking l, l + kLanes, ...
// (mlp_vg.cuh::row_log_lik), as LaneStagedEval's; the prior is taken on the
// coordinates each lane owns; padding coordinates add no prior term and
// take a zero gradient.
template <class L>
struct LaneSplitEval {
  static constexpr int kPer = L::kPer;
  mlp_vg::Data d;
  float prior_const;
  float beta;
  int n_rows;
  L ln;
  float* slot;  // this chain's theta, [kP] in shared memory
  __device__ __forceinline__ float vg(const float (&th)[kPer], float (&g)[kPer], float& ll) const {
    float full[kP], gp[kP];
    gather(ln, slot, th, full);
#pragma unroll
    for (int p = 0; p < kP; ++p) gp[p] = 0.0f;
    float part = 0.0f;
#pragma unroll 2  // two rows in flight
    for (int r = ln.lane; r < n_rows; r += L::kLanes) {
      mlp_vg::row_log_lik<true>(full, d, r, part, gp);
    }
    float own[kPer];
    reduce_scatter(ln, gp, own);
    float prior = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = ln.coord(k);
      if (p < kP) {
        const float diff = th[k] - d.loc[p];
        prior += -0.5f * diff * diff * d.ivar[p];
        g[k] = -diff * d.ivar[p] + beta * own[k];
      } else {
        g[k] = 0.0f;
      }
    }
    ll = ln.sum(part);
    return (ln.sum(prior) + prior_const) + beta * ll;
  }
  __device__ __forceinline__ float v(const float (&th)[kPer], float& ll) const {
    float full[kP], unused[kP];
    gather(ln, slot, th, full);
    float part = 0.0f;
#pragma unroll 2
    for (int r = ln.lane; r < n_rows; r += L::kLanes) {
      mlp_vg::row_log_lik<false>(full, d, r, part, unused);
    }
    float prior = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = ln.coord(k);
      if (p < kP) prior += prior_term(d, p, th[k]);
    }
    ll = ln.sum(part);
    return (ln.sum(prior) + prior_const) + beta * ll;
  }
};

// ---- Gibbs: the cached value-only evaluator of gibbs_chain ----

// Units are numbered as the node blocks of the Gibbs sweep: layer by layer,
// node by node.
__host__ __device__ constexpr int unit_base(int l) {
  int u = 0;
  for (int i = 0; i < l; ++i) u += dim(i + 1);
  return u;
}
__host__ __device__ constexpr int unit_layer(int u) {
  int l = 0;
  while (l + 1 < kNumLayers && u >= unit_base(l + 1)) ++l;
  return l;
}
constexpr int kHidden = unit_base(kNumLayers - 1);  // hidden units
// floats of a row's cache entry: the hidden activations, and the logits (CE)
// the cached floats of a row: its hidden activations
constexpr int kRowFloats = kHidden;
// a row's activations and, for CE, its logits
constexpr int kA = kHidden + (kCrossEntropy ? kOut : 0) > 0 ? kHidden + (kCrossEntropy ? kOut : 0)
                                                           : 1;
// The row entry of unit u (hidden, or a CE output): its unit number.
// Whether updating unit U changes unit u's entry: u itself and every unit of
// a later layer.
__host__ __device__ constexpr bool changes(int U, int u) {
  return u == U || unit_layer(u) > unit_layer(U);
}

// kRows: rows a lane caches (0: no row cache, the whole forward pass each
// call); the cache also holds kOut partial log-likelihoods (BCE) and the
// prior terms of the lane's coordinates.
template <class L, int kRows>
struct LaneGibbsEval {
  static constexpr int kPer = L::kPer;
  static constexpr int kOutPart = kCrossEntropy ? 0 : kOut;
  static constexpr int kRowCache = kRows * kRowFloats;
  static constexpr int kCache = kRowCache + kOutPart + kPer;
  mlp_vg::Data d;
  float prior_const;
  float temperature;
  int n_rows;
  L ln;

  // the input i of layer l at row r (a: the row's activations, by unit)
  template <int l>
  __device__ __forceinline__ float input(const float (&a)[kA], int r,
                                         int i) const {
    if constexpr (l == 0) {
      return d.x[r * kIn + i];
    } else {
      return a[unit_base(l - 1) + i];
    }
  }

  // pre-activation of unit j of layer l at row r
  template <int l>
  __device__ __forceinline__ float unit_z(const float (&th)[kP],
                                          const float (&a)[kA], int r,
                                          int j) const {
    constexpr int din = dim(l);
    float z = 0.0f;
#pragma unroll
    for (int i = 0; i < din; ++i) z += input<l>(a, r, i) * th[mlp_vg::w_off(l) + j * din + i];
    if constexpr (mlp_vg::has_bias(l)) z += th[mlp_vg::b_off(l) + j];
    return z;
  }

  // Recompute layer l (only unit j0 when j0 >= 0, but every CE logit) and
  // every later layer at row r into a; BCE: the output units' row terms into
  // ll_out (unchanged units keep theirs).
  template <int l>
  __device__ __forceinline__ void forward(const float (&th)[kP],
                                          float (&a)[kA], int r,
                                          int j0, float (&ll_out)[kOut]) const {
    if constexpr (l < kNumLayers) {
      constexpr int dout = dim(l + 1);
#pragma unroll
      for (int j = 0; j < dout; ++j) {
        if (j0 >= 0 && j != j0 && !(kCrossEntropy && l == kNumLayers - 1)) continue;
        const float z = unit_z<l>(th, a, r, j);
        if constexpr (l < kNumLayers - 1) {
          a[unit_base(l) + j] = mlp_vg::sigmoid(z);
        } else if constexpr (kCrossEntropy) {
          a[unit_base(l) + j] = z;
        } else {
          const float softplus = fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)));
          ll_out[j] = (d.y[r * kOut + j] * z - softplus) * d.mask[r];
        }
      }
      forward<l + 1>(th, a, r, -1, ll_out);
    }
  }

  // CE: the row's log-likelihood from its logits.
  __device__ __forceinline__ float ce_row(const float (&a)[kA],
                                          int r) const {
    const float* z = a + kHidden;
    float zmax = z[0];
#pragma unroll
    for (int j = 1; j < kOut; ++j) zmax = fmaxf(zmax, z[j]);
    float sumexp = 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) sumexp += expf(z[j] - zmax);
    const float lse = zmax + logf(sumexp);
    float picked = 0.0f;
#pragma unroll
    for (int j = 0; j < kOut; ++j) picked += d.y[r * kOut + j] * z[j];
    return (picked - lse) * d.mask[r];
  }

  // The lane's rows, value only, through the whole network (no row cache).
  __device__ __forceinline__ float forward_rows(const float (&th)[kP]) const {
    float part = 0.0f;
    for (int r = ln.lane; r < n_rows; r += L::kLanes) {
      float a[kA];
      float ll_out[kOut];
      forward<0>(th, a, r, -1, ll_out);
      if constexpr (kCrossEntropy) {
        part += ce_row(a, r);
      } else {
#pragma unroll
        for (int j = 0; j < kOut; ++j) part += ll_out[j];
      }
    }
    return part;
  }

  __device__ __forceinline__ float finish(float part, const float (&c)[kCache]) const {
#pragma unroll
    for (int k = 0; k < kPer; ++k) part += c[kRowCache + kOutPart + k];
    return temperature * (ln.sum(part) + prior_const);
  }

  __device__ __forceinline__ float init(const float (&th)[kP], float (&c)[kCache]) const {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (p % L::kLanes == ln.lane) {
        c[kRowCache + kOutPart + p / L::kLanes] = prior_term(d, p, th[p]);
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (ln.coord(k) >= kP) c[kRowCache + kOutPart + k] = 0.0f;
    }
    if constexpr (kRows == 0) {
      return finish(forward_rows(th), c);
    } else {
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < kOutPart; ++j) c[kRowCache + j] = 0.0f;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = ln.lane + q * L::kLanes;
        float a[kA];
        float ll_out[kOut];
        if (r < n_rows) {
          forward<0>(th, a, r, -1, ll_out);
          if constexpr (kCrossEntropy) {
            part += ce_row(a, r);
          } else {
#pragma unroll
            for (int j = 0; j < kOut; ++j) c[kRowCache + j] += ll_out[j];
          }
        } else {
#pragma unroll
          for (int e = 0; e < kRowFloats; ++e) a[e] = 0.0f;
        }
#pragma unroll
        for (int e = 0; e < kRowFloats; ++e) c[q * kRowFloats + e] = a[e];
      }
      if constexpr (!kCrossEntropy) {
#pragma unroll
        for (int j = 0; j < kOut; ++j) part += c[kRowCache + j];
      }
      return finish(part, c);
    }
  }

  // The prior terms after unit U's weights and bias moved, into n (the
  // entries of U's coordinates; the others keep c's).
  template <int U>
  __device__ __forceinline__ void prior_update(const float (&th)[kP], const float (&c)[kCache],
                                               float (&n)[kCache]) const {
    constexpr int l = unit_layer(U);
    constexpr int j = U - unit_base(l);
    constexpr int din = dim(l);
#pragma unroll
    for (int i = 0; i <= din; ++i) {
      if (i == din && !mlp_vg::has_bias(l)) continue;
      const int p = i < din ? mlp_vg::w_off(l) + j * din + i : mlp_vg::b_off(l) + j;
      n[kRowCache + kOutPart + p / L::kLanes] = c[kRowCache + kOutPart + p / L::kLanes];
    }
#pragma unroll
    for (int i = 0; i <= din; ++i) {
      if (i == din && !mlp_vg::has_bias(l)) continue;
      const int p = i < din ? mlp_vg::w_off(l) + j * din + i : mlp_vg::b_off(l) + j;
      if (p % L::kLanes == ln.lane) {
        n[kRowCache + kOutPart + p / L::kLanes] = prior_term(d, p, th[p]);
      }
    }
  }

  template <int U>
  __device__ __forceinline__ float update(const float (&th)[kP], const float (&c)[kCache],
                                          float (&n)[kCache]) const {
    constexpr int l = unit_layer(U);
    constexpr int j0 = U - unit_base(l);
    prior_update<U>(th, c, n);
    float prior = 0.0f;
    float part = 0.0f;
    if constexpr (kRows == 0) {
      part = forward_rows(th);
    } else {
      float ll_out[kOut];
      float ll_new[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o) ll_new[o] = 0.0f;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int r = ln.lane + q * L::kLanes;
        if (r >= n_rows) continue;
        float a[kA];
#pragma unroll
        for (int e = 0; e < kRowFloats; ++e) a[e] = c[q * kRowFloats + e];
        forward<l>(th, a, r, j0, ll_out);
        static_for<0, kRowFloats>([&](auto e) {
          if constexpr (changes(U, e())) n[q * kRowFloats + e()] = a[e()];
        });
        if constexpr (kCrossEntropy) {
          part += ce_row(a, r);
        } else {
          static_for<0, kOut>([&](auto o) {
            if constexpr (changes(U, kHidden + o())) ll_new[o()] += ll_out[o()];
          });
        }
      }
      if constexpr (!kCrossEntropy) {
        static_for<0, kOut>([&](auto o) {
          if constexpr (changes(U, kHidden + o())) {
            n[kRowCache + o()] = ll_new[o()];
            part += ll_new[o()];
          } else {
            part += c[kRowCache + o()];
          }
        });
      }
    }
    static_for<0, kPer>([&](auto k) {
      if constexpr (prior_entry_moves<U>(kRowCache + kOutPart + k())) {
        prior += n[kRowCache + kOutPart + k()];
      } else {
        prior += c[kRowCache + kOutPart + k()];
      }
    });
    return temperature * (ln.sum(part + prior) + prior_const);
  }

  // whether unit U's update writes prior entry e
  template <int U>
  __host__ __device__ static constexpr bool prior_entry_moves(int e) {
    constexpr int l = unit_layer(U);
    constexpr int j = U - unit_base(l);
    constexpr int din = dim(l);
    for (int i = 0; i <= din; ++i) {
      if (i == din && !mlp_vg::has_bias(l)) continue;
      const int p = i < din ? mlp_vg::w_off(l) + j * din + i : mlp_vg::b_off(l) + j;
      if (kRowCache + kOutPart + p / L::kLanes == e) return true;
    }
    return false;
  }

  template <int U>
  __device__ __forceinline__ void commit(float (&c)[kCache], const float (&n)[kCache]) const {
    if constexpr (kRows > 0) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        static_for<0, kRowFloats>([&](auto e) {
          if constexpr (changes(U, e())) c[q * kRowFloats + e()] = n[q * kRowFloats + e()];
        });
      }
      if constexpr (!kCrossEntropy) {
        static_for<0, kOut>([&](auto o) {
          if constexpr (changes(U, kHidden + o())) c[kRowCache + o()] = n[kRowCache + o()];
        });
      }
    }
    static_for<kRowCache + kOutPart, kCache>([&](auto e) {
      if constexpr (prior_entry_moves<U>(e())) c[e()] = n[e()];
    });
  }
};

// Records go through a shared-memory tile a block: each thread stages its
// chain's entries of recorded iteration k (record_slot), and every
// kRecordBatch-th record (and the last) the block flushes the batch to the
// samples row by row, coalesced (flush_records). The tile is double-buffered,
// [2][kRecordBatch][rows][nb] for nb = blockDim / kLanes chains, so one
// barrier a batch orders a batch's staging before its flush and every flush
// before the staging that reuses its buffer.
constexpr int kRecordBatch = 4;

// Floats of shared memory of the record tile for a block of threads threads
// (batches of kBatch records).
__host__ __device__ constexpr size_t tile_floats(int lanes, int threads,
                                                 int batch = kRecordBatch) {
  return 2 * batch * static_cast<size_t>(kP + 2) * (threads / lanes);
}

// Where this thread's chain stages record k: entry r at [r * nb].
template <int kLanes, int kBatch = kRecordBatch>
__device__ __forceinline__ float* record_slot(float* tile, int k, int rows) {
  const int nb = blockDim.x / kLanes;
  const int batch = ((k / kBatch) & 1) * kBatch + k % kBatch;
  return tile + static_cast<size_t>(batch) * rows * nb + threadIdx.x / kLanes;
}

// Flushes the batch that record k ends, if it ends one (of kept records).
// Every thread of the block calls it at the same records, with the block's
// first chain: a block's chains are consecutive (staged kernels: block by
// block; dense kernels: a launch's blocks of chains divide the sublane
// row's chain_block / 8, resident_loop.cuh::chain_index), so a thread
// passes its own chain less its slot.
template <int kLanes, int kBatch = kRecordBatch>
__device__ __forceinline__ void flush_records(float* __restrict__ samples, const float* tile,
                                              int k, int kept, int rows, int C, int first) {
  const int j = k % kBatch;
  if (j != kBatch - 1 && k != kept - 1) return;
  const int nb = blockDim.x / kLanes;
  const int per = rows * nb;
  const float* batch = tile + static_cast<size_t>((k / kBatch) & 1) * kBatch * per;
  float* out = samples + static_cast<size_t>(k - j) * rows * C + first;
  __syncthreads();
  for (int i = threadIdx.x; i < (j + 1) * per; i += blockDim.x) {
    const int rec = i / per;
    const int r = i % per / nb;
    out[static_cast<size_t>(rec) * rows * C + static_cast<size_t>(r) * C + i % nb] = batch[i];
  }
}

// ---- draws spread over the lanes ----

// One word of a stream on this lane: both normals of its Box-Muller pair
// (z0, z1) and its uniform in (0, 1] (the word's .x).
struct Word {
  float z0, z1, u;
};
__device__ __forceinline__ Word draw_word(unsigned k0, unsigned k1, unsigned ctr, unsigned j) {
  const uint2 bits = kernel_prng::threefry2x32(k0, k1, ctr, j);
  Word w;
  kernel_prng::normal2(bits, &w.z0, &w.z1);
  w.u = kernel_prng::uniform(bits.x);
  return w;
}

// The Gibbs layout of resident_loop.cuh::gibbs_chain for a chain on kLanes
// lanes: the sweep's words spread over the lanes (word g of the sweep is word
// j of sub-block b, the sub-blocks' words laid end to end: ceil(w_b / 2)
// normal pairs, then the accept uniform), the record through a shared-memory
// tile, the final state and counts written by the lanes that own them.
template <class L, class Blocks>
struct LaneGibbsLayout {
  static constexpr int kLanes = L::kLanes;
  static constexpr int words(int b) { return (Blocks::width(b) + 1) / 2 + 1; }
  static constexpr int first_word(int b) {
    int g = 0;
    for (int i = 0; i < b; ++i) g += words(i);
    return g;
  }
  static constexpr int kWords = first_word(Blocks::kB);
  static constexpr int kRounds = (kWords + kLanes - 1) / kLanes;
  L ln;
  float* tile;  // the block's record tile, [rows][blockDim / kLanes]
  Word w[kRounds];

  // The sweep's words of iteration ctr.
  __device__ __forceinline__ void begin(unsigned k0, unsigned k1, unsigned ctr) {
#pragma unroll
    for (int m = 0; m < kRounds; ++m) {
      const int g = ln.lane + m * kLanes;
      unsigned j = 0;
#pragma unroll
      for (int b = 0; b < Blocks::kB; ++b) {
        if (g >= first_word(b) && g < first_word(b) + words(b)) {
          j = static_cast<unsigned>(b) * kernel_prng::kGibbsStride +
              static_cast<unsigned>(g - first_word(b));
        }
      }
      w[m] = draw_word(k0, k1, ctr, j);
    }
  }
  template <int b, int W>
  __device__ __forceinline__ void normals(unsigned, unsigned, unsigned, float (&z)[W]) const {
#pragma unroll
    for (int k = 0; k < W; ++k) {
      constexpr int g0 = first_word(b);
      const int g = g0 + k / 2;
      const Word& src = w[g / kLanes];
      z[k] = ln.from(k % 2 == 0 ? src.z0 : src.z1, g % kLanes);
    }
  }
  template <int b, int W>
  __device__ __forceinline__ float uniform(unsigned, unsigned, unsigned) const {
    constexpr int g = first_word(b) + (W + 1) / 2;
    return ln.from(w[g / kLanes].u, g % kLanes);
  }

  // Stages theta (whole in every lane), the value and the moved flag of
  // record k of kept, and flushes its batch when it ends one. Every thread
  // of the block calls it at the same iteration.
  __device__ __forceinline__ void record(float* __restrict__ samples, int k, int kept, int C, int c,
                                         bool extras, const float (&th)[kP], float val,
                                         bool moved) const {
    const int rows = extras ? kP + 2 : kP;
    const int nb = blockDim.x / kLanes;
    float* slot = record_slot<kLanes>(tile, k, rows);
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (p % kLanes == ln.lane) slot[p * nb] = th[p];
    }
    if (extras && ln.lane == 0) {
      slot[kP * nb] = val;
      slot[(kP + 1) * nb] = moved ? 1.0f : 0.0f;
    }
    flush_records<kLanes>(samples, tile, k, kept, rows, C,
                          c - static_cast<int>(threadIdx.x) / kLanes);
  }

  template <int kB>
  __device__ __forceinline__ void finish(float* __restrict__ final_theta,
                                         float* __restrict__ accepts, int C, int c,
                                         const float (&th)[kP], const float (&n)[kB]) const {
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      if (p % kLanes == ln.lane) final_theta[static_cast<size_t>(p) * C + c] = th[p];
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      if (b % kLanes == ln.lane) accepts[static_cast<size_t>(b) * C + c] = n[b];
    }
  }
};


// ---- NUTS ----

// Mean of v over the tuning group (every thread of the block, or of the
// cluster, calls it with its chain's value), each chain counted once (its
// lane 0); every thread returns the same value. As resident_loop.cuh::
// group_mean (red, partial, parity).
template <class L>
__device__ __forceinline__ float group_mean(const L& ln, float v, float* red, float* partial,
                                            int parity, int cluster_blocks) {
  v = ln.lane == 0 ? v : 0.0f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warps = blockDim.x >> 5;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.0f;
  for (int w = 0; w < warps; ++w) s += red[w];
  const int chains = blockDim.x / L::kLanes;
  if (cluster_blocks == 1) return s / static_cast<float>(chains);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  if (threadIdx.x == 0) partial[parity] = s;
  cluster.sync();
  float total = 0.0f;
  for (int r = 0; r < cluster_blocks; ++r) {
    total += *cluster.map_shared_rank(partial + parity, static_cast<unsigned>(r));
  }
  return total / static_cast<float>(chains * cluster_blocks);
}

// The metric's owned coordinates, M^-1 and 1/sqrt(M^-1) (0 for padding), in
// registers: the lane layout's metric. nuts_chain reads a metric as im(k)
// and msc(k) of owned slot k, which on one thread a chain is coordinate k
// (resident_loop.cuh::ArrayMetric, the dense kernel's constants).
template <class L>
struct LaneMetric {
  float im_[L::kPer];
  float msc_[L::kPer];
  __device__ __forceinline__ LaneMetric(const L& ln, const float* inv_mass, const float* scale) {
#pragma unroll
    for (int k = 0; k < L::kPer; ++k) {
      const int p = ln.coord(k);
      im_[k] = p < kP ? inv_mass[p] : 0.0f;
      msc_[k] = p < kP ? scale[p] : 0.0f;
    }
  }
  __device__ __forceinline__ float im(int k) const { return im_[k]; }
  __device__ __forceinline__ float msc(int k) const { return msc_[k]; }
};

// sum_p M^-1[p] a[p] b[p] over the chain's lanes: the kinetic energy and the
// U-turn products.
template <class L, class Metric>
__device__ __forceinline__ float mdot(const L& ln, const Metric& mt, const float (&a)[L::kPer],
                                      const float (&b)[L::kPer]) {
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < L::kPer; ++k) s += mt.im(k) * (a[k] * b[k]);
  return ln.sum(s);
}

// The U-turn criterion on velocities: (ta - tb) . M^-1 r_left < 0 or
// (ta - tb) . M^-1 r_right < 0.
template <class L, class Metric>
__device__ __forceinline__ bool uturn(const L& ln, const Metric& mt, const float (&ta)[L::kPer],
                                      const float (&tb)[L::kPer], const float (&r_left)[L::kPer],
                                      const float (&r_right)[L::kPer]) {
  float sl = 0.0f;
  float sr = 0.0f;
#pragma unroll
  for (int k = 0; k < L::kPer; ++k) {
    const float d = ta[k] - tb[k];
    sl += mt.im(k) * (d * r_left[k]);
    sr += mt.im(k) * (d * r_right[k]);
  }
  return ln.sum(sl) < 0.0f || ln.sum(sr) < 0.0f;
}

template <int N>
__device__ __forceinline__ void copy(float (&dst)[N], const float (&src)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = src[k];
}

// One chain's whole fixed-budget NUTS run at tree depth D (a compile-time
// constant), on the lanes ln (Lanes<1>: one thread): per iteration t, the
// momenta (rho = sqrt(M) z, the NUTS stream: key (seed, chain), counter (t,
// j)), then D doublings in a random direction, doubling d integrating 2^d
// leapfrog steps from the chosen end with the momentum oriented by the
// direction. Every leaf runs; after a subtree's U-turn or divergence its
// later leaves weigh -inf and its statistics and flags are gated, and after
// the trajectory's stop every later doubling is gated whole (JAX's
// samplers/nuts.py::_tree_fixed). A leaf's weight is w = v - |rho|^2_M/2 -
// logp0, divergent when !(w > -1000) (NaN too), its statistic min(1, e^w)
// with NaN set to 0; the subtree draws its proposal progressively (u <
// e^(w - lse), u in [0, 1)), checks each odd leaf n against the checkpoints
// of the complete subtrees ending at it (slots [popcount(n) -
// trailing_ones(n), popcount(n)), stored by the even leaves at popcount(n)),
// and a good subtree merges with Betancourt's biased draw (log(u) <
// min(lse_sub - lse, 0)) and installs its end with the forward-time
// momentum; the whole trajectory's U-turn ends it. accept_stat = sum of the
// statistics / max(their count, 1). Post-burn-in sums of accept_stat and of
// the divergence flag go to accepts and divergences; a tuned run
// dual-averages the step on the group mean of accept_stat (NaN counts as 0).
//
// State, (13 + 2 (D - 1)) kPer floats a lane: the trajectory's ends (theta,
// rho, gradient each), its proposal (theta, gradient), the leaf (theta, rho,
// gradient), the subtree's proposal (theta, gradient) and the checkpoint
// stack of D - 1 (theta, rho) slots. The two layouts differ where the
// registers decide:
// - One thread a chain (kPer = P): the words are drawn where they are used;
//   the stack is indexed by the popcount at run time, so it lives in local
//   memory; buf is the block's accepted theta [P][blockDim] in shared
//   memory, which the record and the moved flag read (resident_loop.cuh::
//   record). Whatever the registers do not hold the compiler spills: on XOR
//   (P = 9) that is the stack alone, on iris (459 floats) much more.
// - A group of lanes (kPer = ceil(P / kLanes)): the iteration's words are
//   spread over the lanes (word j on lane j % kLanes) and broadcast; the
//   stack is selected slot by slot, so it stays in registers; buf is the
//   block's record tile (record_slot, flush_records). On iris at 8 lanes a
//   lane holds 68 floats of state.
template <int D, class L, class Eval, class Metric>
__device__ __forceinline__ void nuts_chain(const Eval& ev, const L& ln, const Metric& mt,
                                           const ResidentHMCParams& pr, int c,
                                           int cluster_blocks, const float* __restrict__ theta0,
                                           float* __restrict__ samples,
                                           float* __restrict__ final_theta,
                                           float* __restrict__ accepts,
                                           float* __restrict__ divergences,
                                           float* __restrict__ steps, float* buf, float* red,
                                           float* partial) {
  static_assert(D >= 1, "max_depth >= 1");
  constexpr int kN = L::kPer;
  constexpr int kLanes = L::kLanes;
  constexpr bool kThread = kLanes == 1;
  constexpr int kSlots = D > 1 ? D - 1 : 1;
  constexpr int kPairs = resident_loop::kPairs;
  constexpr int kWords = kPairs + (1 << D) - 1 + 2 * D;
  constexpr int kRounds = kThread ? 1 : (kWords + kLanes - 1) / kLanes;
  const int bd = blockDim.x;
  const int me = threadIdx.x;
  const int C = pr.num_chains;
  const unsigned key0 = static_cast<unsigned>(pr.seed);
  const unsigned key1 = static_cast<unsigned>(c);

  float pt[kN], pg[kN];  // the trajectory's proposal: the accepted state between iterations
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int p = ln.coord(k);
    pt[k] = p < kP ? theta0[static_cast<size_t>(p) * C + c] : 0.0f;
  }
  float pv = ev.vg(pt, pg);
  float prev[kThread ? 1 : kN];  // lanes: the accepted theta of the last iteration
  if constexpr (kThread) {
#pragma unroll
    for (int p = 0; p < kP; ++p) buf[p * bd + me] = pt[p];
  } else {
    copy(prev, pt);
  }

  float tl[kN], rl[kN], gl[kN], tr[kN], rr[kN], gr[kN];  // the trajectory's ends
  float lt[kN], lr[kN], lg[kN];                          // the leaf
  float st[kN], sg[kN];                                  // the subtree's proposal
  float ck_t[kSlots][kN], ck_r[kSlots][kN];              // the checkpoint stack
  float acc_sum = 0.0f;
  float div_sum = 0.0f;
  float step = pr.step;
  float barh = 0.0f;
  float logbare = 0.0f;

  for (int t = 0; t < pr.num_iters; ++t) {
    const unsigned ctr = static_cast<unsigned>(t);
    // lanes: the iteration's words, word g on lane g % kLanes, round g / kLanes
    Word w[kRounds];
    if constexpr (!kThread) {
#pragma unroll
      for (int m = 0; m < kRounds; ++m) {
        w[m] = draw_word(key0, key1, ctr, static_cast<unsigned>(ln.lane + m * kLanes));
      }
    }
    // the [0, 1) uniform of word g (lane-uniform g)
    auto u01 = [&](unsigned g) {
      if constexpr (kThread) {
        return kernel_prng::u01_at(key0, key1, ctr, g);
      } else {
        const int m = static_cast<int>(g) / kLanes;
        float v = w[0].u;
#pragma unroll
        for (int i = 1; i < kRounds; ++i) v = i == m ? w[i].u : v;
        return 1.0f - ln.from(v, static_cast<int>(g) % kLanes);
      }
    };
    {
      float z[kN];
      if constexpr (kThread) {
        kernel_prng::normals(key0, key1, ctr, z);
      } else {
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          // z[p] is normal p % 2 of word p / 2, whose round depends on the lane
          const int p = ln.coord(k);
          const int q = p / 2;
          z[k] = 0.0f;
#pragma unroll
          for (int m = 0; m < kRounds; ++m) {
            const float a = ln.from(w[m].z0, q % kLanes);
            const float b = ln.from(w[m].z1, q % kLanes);
            if (m == q / kLanes) z[k] = (p & 1) ? b : a;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        rl[k] = mt.msc(k) * z[k];
        rr[k] = rl[k];
        tl[k] = pt[k];
        tr[k] = pt[k];
        gl[k] = pg[k];
        gr[k] = pg[k];
      }
    }
    const float logp0 = pv - 0.5f * mdot(ln, mt, rl, rl);
    float lse = 0.0f;  // the start state weighs exp(0)
    float sum_alpha = 0.0f;
    float num_alpha = 0.0f;
    bool turning = false;
    bool diverging = false;
    unsigned word = static_cast<unsigned>(kPairs);  // the direction uniform of depth 0

#pragma unroll 1
    for (int depth = 0; depth < D; ++depth) {
      const bool active = !(turning || diverging);
      const int leaves = 1 << depth;
      const bool go_right = u01(word) < 0.5f;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        lt[k] = go_right ? tr[k] : tl[k];
        lr[k] = go_right ? rr[k] : -rl[k];
        lg[k] = go_right ? gr[k] : gl[k];
        st[k] = lt[k];
        sg[k] = lg[k];
      }
      float s_lse = -INFINITY;
      float sv = 0.0f;
      float s_sum = 0.0f;
      float s_num = 0.0f;
      bool s_turn = false;
      bool s_div = false;

#pragma unroll 1
      for (int n = 0; n < leaves; ++n) {
        const bool live = !(s_turn || s_div);
        const float half = 0.5f * step;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          lr[k] = lr[k] + half * lg[k];
          lt[k] = lt[k] + step * (mt.im(k) * lr[k]);
        }
        const float lv = ev.vg(lt, lg);
#pragma unroll
        for (int k = 0; k < kN; ++k) lr[k] = lr[k] + half * lg[k];
        const float w_leaf = (lv - 0.5f * mdot(ln, mt, lr, lr)) - logp0;
        const bool leaf_div = !(w_leaf > -resident_loop::kDivergence);
        const float e = expf(w_leaf);
        float alpha = e > 1.0f ? 1.0f : e;  // NaN stays NaN
        if (alpha != alpha) alpha = 0.0f;
        const float w_eff = live ? w_leaf : -INFINITY;
        const float new_lse = resident_loop::logaddexp(s_lse, w_eff);
        const float u = u01(word + 1u + static_cast<unsigned>(n));
        if (live && logf(u) < w_eff - new_lse) {
          copy(st, lt);
          copy(sg, lg);
          sv = lv;
        }
        s_lse = new_lse;
        const int pc = __popc(n);
        if ((n & 1) == 0) {
          if constexpr (kThread) {
            copy(ck_t[pc], lt);
            copy(ck_r[pc], lr);
          } else {
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
              if (s == pc) {
                copy(ck_t[s], lt);
                copy(ck_r[s], lr);
              }
            }
          }
        } else {
          const int lo = pc - (__popc(n ^ (n + 1)) - 1);  // pc - trailing_ones(n)
          bool found = false;
          if constexpr (kThread) {
            for (int i = lo; i < pc; ++i) found = found || uturn(ln, mt, lt, ck_t[i], ck_r[i], lr);
          } else {
#pragma unroll
            for (int s = 0; s < kSlots; ++s) {
              if (s >= lo && s < pc && !found) found = uturn(ln, mt, lt, ck_t[s], ck_r[s], lr);
            }
          }
          s_turn = s_turn || (live && found);
        }
        s_div = s_div || (live && leaf_div);
        if (live) {
          s_sum += alpha;
          s_num += 1.0f;
        }
      }

      const bool bad = s_turn || s_div;
      if (active) {
        sum_alpha += s_sum;
        num_alpha += s_num;
      }
      const float diff = s_lse - lse;
      const float accept_log_prob = diff > 0.0f ? 0.0f : diff;  // min(diff, 0), NaN stays
      const float um = u01(word + 1u + static_cast<unsigned>(leaves));
      const bool ok = active && !bad;
      if (ok && logf(um) < accept_log_prob) {
        copy(pt, st);
        copy(pg, sg);
        pv = sv;
      }
      if (ok) {
        lse = resident_loop::logaddexp(lse, s_lse);
        // install the new end with the forward-time momentum
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          if (go_right) {
            tr[k] = lt[k];
            rr[k] = lr[k];
            gr[k] = lg[k];
          } else {
            tl[k] = lt[k];
            rl[k] = -lr[k];
            gl[k] = lg[k];
          }
        }
      }
      const bool whole_turn = ok && uturn(ln, mt, tr, tl, rl, rr);
      turning = turning || (active && (bad || whole_turn));
      diverging = diverging || (active && s_div);
      word += static_cast<unsigned>(leaves) + 2u;
    }

    const float accept_stat = sum_alpha / (num_alpha > 1.0f ? num_alpha : 1.0f);
    if (t >= pr.num_burnin_iters) {
      acc_sum += accept_stat;
      if (diverging) div_sum += 1.0f;
    }
    if (pr.tuned && t < pr.num_burnin_iters) {  // uniform over the group
      float stat = group_mean(ln, accept_stat, red, partial, t & 1, cluster_blocks);
      if (stat != stat) stat = 0.0f;
      step = resident_loop::dual_average(stat, t, pr.num_burnin_iters, pr.tuner_m, pr.d, pr.g,
                                         pr.t0, pr.k, pr.log_eub, barh, logbare);
    }
    if constexpr (kThread) {
      bool moved = false;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        moved |= pt[p] != buf[p * bd + me];
        buf[p * bd + me] = pt[p];
      }
      resident_loop::record(samples, t, pr.num_burnin_iters, pr.record_thin, pr.kept,
                            pr.record_extras, C, c, buf, pv, moved);
    } else {
      bool moved_here = false;
#pragma unroll
      for (int k = 0; k < kN; ++k) moved_here |= pt[k] != prev[k];
      copy(prev, pt);
      const bool moved = ln.any(moved_here);
      const int since = t - pr.num_burnin_iters;
      if (since >= 0 && since % pr.record_thin == 0 && since / pr.record_thin < pr.kept) {
        const int rows = pr.record_extras ? kP + 2 : kP;
        const int nb = bd / kLanes;
        const int rec = since / pr.record_thin;
        float* slot = record_slot<kLanes>(buf, rec, rows);
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          if (ln.coord(k) < kP) slot[ln.coord(k) * nb] = pt[k];
        }
        if (pr.record_extras && ln.lane == 0) {
          slot[kP * nb] = pv;
          slot[(kP + 1) * nb] = moved ? 1.0f : 0.0f;
        }
        flush_records<kLanes>(samples, buf, rec, pr.kept, rows, C, c - me / kLanes);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kN; ++k) {
    if (ln.coord(k) < kP) final_theta[static_cast<size_t>(ln.coord(k)) * C + c] = pt[k];
  }
  if (ln.lane == 0) {
    accepts[c] = acc_sum;
    divergences[c] = div_sum;
    steps[c] = step;
  }
}

// ---- HMC, MH and MALA ----

// Records of the HMC, walk and ladder loops on lanes. On at most 4 lanes a
// chain, a warp's 32 / kLanes >= 8 chains are consecutive and start at a
// multiple of 8, so the warp's stores of one coordinate row cover whole
// 32-byte sectors of the samples: each lane stores its owned coordinates
// directly, with no tile and no barrier. On 8 lanes the runs are shorter than
// a sector, and records go through the tile one at a time: a tuned HMC block
// holds a whole tuning group, whose tile of kRecordBatch records would not
// fit shared memory.
constexpr int kWalkRecordBatch = 1;
__host__ __device__ constexpr bool direct_records(int lanes) { return lanes <= 4; }

// Floats of shared memory of the walk loops' record tile for a block of
// threads threads (none where the lanes store directly).
__host__ __device__ constexpr size_t walk_tile_floats(int lanes, int threads) {
  return direct_records(lanes) ? 0 : tile_floats(lanes, threads, kWalkRecordBatch);
}

// The words of one iteration of the HMC and walk streams (key (k0, k1),
// counter (ctr, j)) on a chain's lanes: the kPairs normal pairs, then the
// accept uniform (word kPairs) and kExtra more words (the ladder's swap
// uniform, word kPairs + 1), word g on lane g % kLanes in round g / kLanes,
// each computed once. Coordinate p is normal p % 2 of word p / 2:
// for an even kLanes the coordinates a lane owns in slot k (k kLanes + lane)
// all take round k / 2, from lane (k kLanes / 2 + lane / 2) % kLanes, so two
// shuffles a slot bring them to their owners.
template <class L, int kExtra = 0>
struct WalkWords {
  static constexpr int kLanes = L::kLanes;
  // the normal pairs, the accept uniform and kExtra more words
  static constexpr int kWords = resident_loop::kPairs + 1 + kExtra;
  static constexpr int kRounds = (kWords + kLanes - 1) / kLanes;
  static_assert(kLanes % 2 == 0, "one thread a chain draws where it uses");
  static_assert((L::kPer - 1) / 2 < kRounds, "every owned coordinate's word is drawn");
  Word w[kRounds];
  __device__ __forceinline__ WalkWords(const L& ln, unsigned k0, unsigned k1, unsigned ctr) {
#pragma unroll
    for (int m = 0; m < kRounds; ++m) {
      w[m] = draw_word(k0, k1, ctr, static_cast<unsigned>(ln.lane + m * kLanes));
    }
  }
  // the normals of the owned coordinates (0 for padding)
  __device__ __forceinline__ void normals(const L& ln, float (&z)[L::kPer]) const {
#pragma unroll
    for (int k = 0; k < L::kPer; ++k) {
      const int src = (k * kLanes / 2 + ln.lane / 2) % kLanes;
      const float a = ln.from(w[k / 2].z0, src);
      const float b = ln.from(w[k / 2].z1, src);
      z[k] = ln.coord(k) < kP ? ((ln.lane & 1) ? b : a) : 0.0f;
    }
  }
  // the accept uniform, in (0, 1]
  __device__ __forceinline__ float uniform(const L& ln) const { return uniform_of<0>(ln); }
  // the uniform of word kPairs + i (the accept uniform, then the extra words), in (0, 1]
  template <int i>
  __device__ __forceinline__ float uniform_of(const L& ln) const {
    constexpr int g = resident_loop::kPairs + i;
    static_assert(g < kWords, "a word that was drawn");
    return ln.from(w[g / kLanes].u, g % kLanes);
  }
};

// Writes the owned coordinates of th (and with extras the value and the
// moved flag) as record k of kept: directly on at most 4 lanes, else staged
// in the tile, whose batch it flushes. Every thread of the block calls it at
// the same records.
template <class L>
__device__ __forceinline__ void record_lanes(const L& ln, float* __restrict__ samples,
                                             float* tile, int k, int kept, int C, int c,
                                             bool extras, const float (&th)[L::kPer], float val,
                                             bool moved) {
  constexpr int kLanes = L::kLanes;
  const int rows = extras ? kP + 2 : kP;
  if constexpr (direct_records(kLanes)) {
    float* out = samples + static_cast<size_t>(k) * rows * C;
#pragma unroll
    for (int j = 0; j < L::kPer; ++j) {
      if (ln.coord(j) < kP) out[static_cast<size_t>(ln.coord(j)) * C + c] = th[j];
    }
    if (extras && ln.lane == 0) {
      out[static_cast<size_t>(kP) * C + c] = val;
      out[static_cast<size_t>(kP + 1) * C + c] = moved ? 1.0f : 0.0f;
    }
    return;
  }
  const int nb = blockDim.x / kLanes;
  float* slot = record_slot<kLanes, kWalkRecordBatch>(tile, k, rows);
#pragma unroll
  for (int j = 0; j < L::kPer; ++j) {
    if (ln.coord(j) < kP) slot[ln.coord(j) * nb] = th[j];
  }
  if (extras && ln.lane == 0) {
    slot[kP * nb] = val;
    slot[(kP + 1) * nb] = moved ? 1.0f : 0.0f;
  }
  flush_records<kLanes, kWalkRecordBatch>(samples, tile, k, kept, rows, C,
                                          c - static_cast<int>(threadIdx.x) / kLanes);
}

// One chain's whole HMC run, on the lanes ln (Lanes<1>: one thread): per
// iteration t, the momenta (normals, key (seed, chain), counter (t, j)),
// num_steps leapfrog steps from the accepted state, the accept test u <
// min(1, exp(H_cur - H_prop)) with u from word ceil(P/2), the post-burn-in
// accept count, the tuner (dual averaging on the group mean of the rate, or
// on the chain's own; the l-rule sets num_steps, and with stochastic
// rounding the last burn-in iteration freezes floor(l/e) + Bernoulli(frac)
// from word ceil(P/2) + 1) and the record. Adds the chain's
// value-and-gradient evaluations (1 + its leapfrog steps) to *evaluations,
// once a chain. A chain stops after its own num_steps (the TPU kernel masks
// the lanes whose trajectory ended).
//
// The layouts differ where the registers decide:
// - One thread a chain (the dense kernel, and the staged one on few rows):
//   the proposal theta, momentum and gradient in registers, the accepted
//   theta and gradient in buf, [P][blockDim] of shared memory, touched once
//   an iteration; the draws where they are used; the record written by the
//   thread (resident_loop.cuh::record).
// - A group of lanes (kPer = ceil(P / kLanes) coordinates a lane): the
//   proposal, momentum, gradient and the accepted theta and gradient, 5 kPer
//   floats a lane, all in registers; the iteration's words spread over the
//   lanes (WalkWords); the kinetic energies and the moved flag reduced over
//   the lanes, so every lane takes the same decisions; buf is the block's
//   record tile.
template <class L, class Eval>
__device__ __forceinline__ void hmc_chain(const Eval& ev, const L& ln,
                                          const ResidentHMCParams& pr, int c, int cluster_blocks,
                                          const float* __restrict__ theta0,
                                          float* __restrict__ samples,
                                          float* __restrict__ final_theta,
                                          float* __restrict__ accepts,
                                          unsigned long long* __restrict__ evaluations,
                                          float* buf, float* red, float* partial) {
  constexpr int kN = L::kPer;
  constexpr bool kThread = L::kLanes == 1;
  constexpr int kPairs = resident_loop::kPairs;
  const int bd = blockDim.x;
  const int me = threadIdx.x;
  const int C = pr.num_chains;
  const unsigned key0 = static_cast<unsigned>(pr.seed);
  const unsigned key1 = static_cast<unsigned>(c);
  float* acc_th = buf;            // one thread: the accepted theta, [P][bd]
  float* acc_g = buf + kP * bd;   // one thread: its gradient, [P][bd]
  float reg_th[kThread ? 1 : kN];  // lanes: the accepted theta's owned coordinates
  float reg_g[kThread ? 1 : kN];   // lanes: its gradient's
  auto at = [&](int k) -> float& {
    if constexpr (kThread) {
      return acc_th[k * bd + me];
    } else {
      return reg_th[k];
    }
  };
  auto ag = [&](int k) -> float& {
    if constexpr (kThread) {
      return acc_g[k * bd + me];
    } else {
      return reg_g[k];
    }
  };

  float th[kN], g[kN], mom[kN];
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int p = ln.coord(k);
    th[k] = p < kP ? theta0[static_cast<size_t>(p) * C + c] : 0.0f;
  }
  float cur_val = ev.vg(th, g);
#pragma unroll
  for (int k = 0; k < kN; ++k) {
    at(k) = th[k];
    ag(k) = g[k];
  }

  unsigned evals = 1;
  float n_accepts = 0.0f;
  float step = pr.step;
  int n_steps = pr.num_steps;
  float barh = 0.0f;
  float logbare = 0.0f;

  for (int t = 0; t < pr.num_iters; ++t) {
    const unsigned ctr = static_cast<unsigned>(t);
    float u_lanes = 0.0f;
    if constexpr (kThread) {
      kernel_prng::normals(key0, key1, ctr, mom);
    } else {
      const WalkWords<L> words(ln, key0, key1, ctr);
      words.normals(ln, mom);
      u_lanes = words.uniform(ln);
    }
    float kin = 0.0f;
#pragma unroll
    for (int k = 0; k < kN; ++k) kin += mom[k] * mom[k];
    kin = ln.sum(kin);
    const float h_cur = -cur_val + 0.5f * kin;

    const float half_step = 0.5f * step;
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      th[k] = at(k);
      g[k] = ag(k);
      mom[k] = mom[k] + half_step * g[k];
    }
    float val = cur_val;
    for (int s = 0; s < n_steps; ++s) {
#pragma unroll
      for (int k = 0; k < kN; ++k) th[k] = th[k] + step * mom[k];
      val = ev.vg(th, g);
      const float f = (s == n_steps - 1 ? 0.5f : 1.0f) * step;
#pragma unroll
      for (int k = 0; k < kN; ++k) mom[k] = mom[k] + f * g[k];
    }
    evals += static_cast<unsigned>(n_steps);
    float kin_prop = 0.0f;
#pragma unroll
    for (int k = 0; k < kN; ++k) kin_prop += mom[k] * mom[k];
    kin_prop = ln.sum(kin_prop);
    const float h_prop = -val + 0.5f * kin_prop;
    const float e = expf(h_cur - h_prop);
    const float rate = e > 1.0f ? 1.0f : e;  // NaN stays NaN and rejects
    float u;
    if constexpr (kThread) {
      u = kernel_prng::uniform_at(key0, key1, ctr, kPairs);
    } else {
      u = u_lanes;
    }
    bool moved = false;
    if (u < rate) {
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        moved |= th[k] != at(k);
        at(k) = th[k];
        ag(k) = g[k];
      }
      cur_val = val;
      if (t >= pr.num_burnin_iters) n_accepts += 1.0f;
    }
    moved = ln.any(moved);

    if (pr.tuned && t < pr.num_burnin_iters) {  // uniform over a population group
      float stat;
      if constexpr (kThread) {
        stat = pr.per_chain ? rate
                            : resident_loop::group_mean(rate, red, partial, t & 1, cluster_blocks);
      } else {
        stat = pr.per_chain ? rate : group_mean(ln, rate, red, partial, t & 1, cluster_blocks);
      }
      if (pr.nan_guard && stat != stat) stat = 0.0f;
      step = resident_loop::dual_average(stat, t, pr.num_burnin_iters, pr.tuner_m, pr.d, pr.g,
                                         pr.t0, pr.k, pr.log_eub, barh, logbare);
      if (pr.use_l) {
        const float ratio = pr.l / step;
        const float cap = static_cast<float>(pr.max_num_steps);
        n_steps = static_cast<int>(fminf(fmaxf(rintf(ratio), 1.0f), cap));
        if (pr.stochastic && t == pr.num_burnin_iters - 1) {
          const float n_lo = floorf(ratio);
          const float ur = kernel_prng::uniform_at(key0, key1, ctr, kPairs + 1);
          const float n = n_lo + (ur < ratio - n_lo ? 1.0f : 0.0f);
          n_steps = static_cast<int>(fminf(fmaxf(n, 1.0f), cap));
        }
      }
    }

    if constexpr (kThread) {
      resident_loop::record(samples, t, pr.num_burnin_iters, pr.record_thin, pr.kept,
                            pr.record_extras, C, c, acc_th, cur_val, moved);
    } else {
      const int since = t - pr.num_burnin_iters;
      if (since >= 0 && since % pr.record_thin == 0 && since / pr.record_thin < pr.kept) {
        record_lanes(ln, samples, buf, since / pr.record_thin, pr.kept, C, c,
                     pr.record_extras != 0, reg_th, cur_val, moved);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int p = ln.coord(k);
    if (p < kP) final_theta[static_cast<size_t>(p) * C + c] = at(k);
  }
  if (ln.lane == 0) accepts[c] = n_accepts;
  resident_loop::count_evaluations(ln.lane == 0 ? evals : 0u, evaluations);
}

// One chain's whole random-walk run, on the lanes ln (Lanes<1>: one thread).
// Per iteration t: P normals z (the walk stream: key (seed, chain), counter
// (t, j)), the proposal, its value (MH) or value and gradient (MALA), and the
// accept test log(u) < log_rate with u from word ceil(P/2).
//   MH:   prop = theta + scale * z; log_rate = v(prop) - v(theta).
//   MALA: prop = theta + (step/2) grad + sqrt(step) z;
//         log_rate = v(prop) - v(theta) - |theta - prop - (step/2) grad(prop)|^2 / (2 step)
//                    + |z|^2 / 2
//         (the two sqrt(step)-Normal densities' constants cancel).
// With pr.tuned (dense kernels), the scale or step is dual-averaged on the
// group mean of min(1, exp(min(log_rate, 0))) during burn-in, with no NaN
// guard (as the TPU kernel has it: a NaN rate stops the group's tuning).
// Layouts as hmc_chain's: one thread keeps the accepted theta (and gradient,
// MALA) in buf, [P][blockDim] of shared memory; a group of lanes keeps them
// in registers, spread over the lanes, with |z|^2, the reverse-proposal norm
// and the moved flag reduced over the lanes, and buf is the record tile.
template <bool kMALA, class L, class Eval>
__device__ __forceinline__ void walk_chain(const Eval& ev, const L& ln,
                                           const ResidentWalkParams& pr, int c,
                                           int cluster_blocks, const float* __restrict__ theta0,
                                           float* __restrict__ samples,
                                           float* __restrict__ final_theta,
                                           float* __restrict__ accepts, float* buf, float* red,
                                           float* partial) {
  constexpr int kN = L::kPer;
  constexpr bool kThread = L::kLanes == 1;
  constexpr int kPairs = resident_loop::kPairs;
  const int bd = blockDim.x;
  const int me = threadIdx.x;
  const int C = pr.num_chains;
  const unsigned key0 = static_cast<unsigned>(pr.seed);
  const unsigned key1 = static_cast<unsigned>(c);
  float* acc_th = buf;           // one thread: the accepted theta, [P][bd]
  float* acc_g = buf + kP * bd;  // one thread, MALA: its gradient, [P][bd]
  float reg_th[kThread ? 1 : kN];
  float reg_g[kThread || !kMALA ? 1 : kN];
  auto at = [&](int k) -> float& {
    if constexpr (kThread) {
      return acc_th[k * bd + me];
    } else {
      return reg_th[k];
    }
  };
  auto ag = [&](int k) -> float& {
    if constexpr (kThread) {
      return acc_g[k * bd + me];
    } else if constexpr (kMALA) {
      return reg_g[k];
    } else {
      return reg_g[0];
    }
  };

  float val;
  {
    float th[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int p = ln.coord(k);
      th[k] = p < kP ? theta0[static_cast<size_t>(p) * C + c] : 0.0f;
    }
    if constexpr (kMALA) {
      float g[kN];
      val = ev.vg(th, g);
#pragma unroll
      for (int k = 0; k < kN; ++k) ag(k) = g[k];
    } else {
      val = ev.v(th);
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) at(k) = th[k];
  }

  float n_accepts = 0.0f;
  float cur = pr.value;
  float barh = 0.0f;
  float logbare = 0.0f;

  for (int t = 0; t < pr.num_iters; ++t) {
    const unsigned ctr = static_cast<unsigned>(t);
    float prop[kN];
    float log_rate;
    bool moved = false;
    {
      float z[kN];
      float u_lanes = 0.0f;
      if constexpr (kThread) {
        kernel_prng::normals(key0, key1, ctr, z);
      } else {
        const WalkWords<L> words(ln, key0, key1, ctr);
        words.normals(ln, z);
        u_lanes = words.uniform(ln);
      }
      auto accept_uniform = [&]() {
        if constexpr (kThread) {
          return kernel_prng::uniform_at(key0, key1, ctr, kPairs);
        } else {
          return u_lanes;
        }
      };
      if constexpr (kMALA) {
        const float half = pr.tuned ? 0.5f * cur : pr.half_step;
        const float sq = pr.tuned ? sqrtf(cur) : pr.sqrt_step;
        float z_sq = z[0] * z[0];
#pragma unroll
        for (int k = 1; k < kN; ++k) z_sq = z_sq + z[k] * z[k];
        z_sq = ln.sum(z_sq);
#pragma unroll
        for (int k = 0; k < kN; ++k) prop[k] = (at(k) + half * ag(k)) + sq * z[k];
        float gp[kN];
        const float v_p = ev.vg(prop, gp);
        float rev_sq = 0.0f;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          const float dp = at(k) - (prop[k] + half * gp[k]);
          rev_sq = rev_sq + dp * dp;
        }
        rev_sq = ln.sum(rev_sq);
        const float half_inv = pr.tuned ? 0.5f / cur : pr.half_inv_step;
        log_rate = ((v_p - val) - half_inv * rev_sq) + 0.5f * z_sq;
        const float u = accept_uniform();
        if (logf(u) < log_rate) {
#pragma unroll
          for (int k = 0; k < kN; ++k) {
            moved |= prop[k] != at(k);
            at(k) = prop[k];
            ag(k) = gp[k];
          }
          val = v_p;
          if (t >= pr.num_burnin_iters) n_accepts += 1.0f;
        }
      } else {
#pragma unroll
        for (int k = 0; k < kN; ++k) prop[k] = at(k) + cur * z[k];
        const float v_p = ev.v(prop);
        log_rate = v_p - val;
        const float u = accept_uniform();
        if (logf(u) < log_rate) {
#pragma unroll
          for (int k = 0; k < kN; ++k) {
            moved |= prop[k] != at(k);
            at(k) = prop[k];
          }
          val = v_p;
          if (t >= pr.num_burnin_iters) n_accepts += 1.0f;
        }
      }
    }
    moved = ln.any(moved);

    if (pr.tuned && t < pr.num_burnin_iters) {  // uniform over the group
      const float r = log_rate > 0.0f ? 0.0f : log_rate;  // min(log_rate, 0), NaN stays
      const float e = expf(r);
      const float rate = e > 1.0f ? 1.0f : e;
      float mean_rate;
      if constexpr (kThread) {
        mean_rate = resident_loop::group_mean(rate, red, partial, t & 1, cluster_blocks);
      } else {
        mean_rate = group_mean(ln, rate, red, partial, t & 1, cluster_blocks);
      }
      cur = resident_loop::dual_average(mean_rate, t, pr.num_burnin_iters, pr.tuner_m, pr.d,
                                        pr.g, pr.t0, pr.k, pr.log_eub, barh, logbare);
    }

    if constexpr (kThread) {
      resident_loop::record(samples, t, pr.num_burnin_iters, pr.record_thin, pr.kept,
                            pr.record_extras, C, c, acc_th, val, moved);
    } else {
      const int since = t - pr.num_burnin_iters;
      if (since >= 0 && since % pr.record_thin == 0 && since / pr.record_thin < pr.kept) {
        record_lanes(ln, samples, buf, since / pr.record_thin, pr.kept, C, c,
                     pr.record_extras != 0, reg_th, val, moved);
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int p = ln.coord(k);
    if (p < kP) final_theta[static_cast<size_t>(p) * C + c] = at(k);
  }
  if (ln.lane == 0) accepts[c] = n_accepts;
}

// ---- power-posterior tempering ----

// Floats of shared memory that tempering_chain takes for a block of threads
// threads: on one thread a chain resident_loop::tempering_floats (the ladder
// state); on lanes, a chain's post of the swap round (theta [P], its gradient
// [P] with MALA, the value and the swap uniform, each [chains]), then the
// record tile.
__host__ __device__ constexpr size_t tempering_lane_floats(bool mala, bool extras, int lanes,
                                                           int threads) {
  return lanes == 1 ? resident_loop::tempering_floats(mala, extras, threads)
                    : ((mala ? 2 : 1) * static_cast<size_t>(kP) + 2) * (threads / lanes) +
                          walk_tile_floats(lanes, threads);
}

// One chain's whole power-posterior run, on the lanes ln (Lanes<1>: one
// thread), the chain being rung c % L of its ladder (L = pr.num_rungs
// consecutive chains, the coldest last). The stored value is the untempered
// log-target v; the rung's temperature T (temps[rung], float32) enters at the
// accept tests only. Per iteration t:
//   the within-rung move on the walk stream (normals from words j <
//   ceil(P/2), the accept uniform from word ceil(P/2)):
//     MH:   prop = theta + scale * z; log_rate = T (v(prop) - v(theta)).
//     MALA: prop = theta + (step/2)(T grad) + sqrt(step) z;
//           log_rate = T (v(prop) - v(theta))
//                      - |theta - prop - (step/2)(T grad(prop))|^2 / (2 step) + |z|^2 / 2;
//   then, when t % between_step == 0, a swap round of parity (t /
//   between_step) % 2: a chain with rung % 2 == parity and rung < L - 1 is
//   the lower member of the pair (rung, rung + 1); with the uniform u of word
//   ceil(P/2) + 1 of its stream it accepts when log(u) < (T_rung -
//   T_rung+1)(v_upper - v), which needs no new evaluation, and the pair
//   exchanges theta, the value and (MALA) the gradient.
// accepts is [2, C]: post-burn-in within-rung accepts, and swap accepts on
// the lower member. With extras the moved flag compares theta after the
// swap round with theta at the start of the iteration (a swapped upper
// member has moved too).
//
// A block holds whole ladders, so a chain's partner one rung up is the next
// chain of its block; pairs are disjoint, and every thread takes the same
// trip count and reaches every barrier of a round, a warp's when whole
// ladders fit a warp, else the block's (resident_loop::ladder_sync). The
// layouts differ where the registers decide:
// - One thread a chain (the dense kernel; the staged one on few rows or for
//   a ladder too long for a block of lane chains): the accepted theta, its
//   gradient (MALA) and the values in ladder, [P][blockDim] each; the lower
//   member decides and exchanges both members' entries (resident_loop.cuh's
//   thread layout, unchanged).
// - A group of lanes (kPer coordinates a lane): the accepted theta and
//   gradient in registers, the within move as walk_chain's on lanes (|z|^2
//   and the reverse-proposal norm butterfly sums, the value the evaluator's
//   butterfly sum, the iteration's words spread over the lanes, the swap
//   uniform among them, each drawn once a chain); at a swap round every
//   chain posts its theta, gradient, value and swap uniform to its slot in
//   ladder, and both members of a pair evaluate the lower member's test
//   from the same bits (its uniform, both values and the two temperatures
//   in the same order), so they take the same decision on every lane; each
//   then reads its partner's post. The record goes through the tile.
template <bool kMALA, class L, class Eval>
__device__ __forceinline__ void tempering_chain(const Eval& ev, const L& ln,
                                                const ResidentWalkParams& pr, int c,
                                                const float* __restrict__ theta0,
                                                const float* __restrict__ temps,
                                                float* __restrict__ samples,
                                                float* __restrict__ final_theta,
                                                float* __restrict__ accepts, float* ladder) {
  constexpr int kN = L::kPer;
  constexpr int kLanes = L::kLanes;
  constexpr bool kThread = kLanes == 1;
  constexpr int kPairs = resident_loop::kPairs;
  const int bd = blockDim.x;
  const int me = threadIdx.x;
  const int C = pr.num_chains;
  const int rungs = pr.num_rungs;
  // one thread: the ladder state, [P][bd] each
  float* acc_th = ladder;                              // [P][bd]
  float* acc_g = acc_th + kP * bd;                     // [P][bd], MALA
  float* acc_v = acc_g + (kMALA ? kP * bd : 0);        // [bd]
  float* start_th = acc_v + bd;                        // [P][bd], extras
  // lanes: the posts of the block's nb chains, then the record tile
  const int nb = bd / kLanes;
  const int ci = me / kLanes;                          // the chain's slot in the block
  float* post_th = ladder;                             // [P][nb]
  float* post_g = post_th + kP * nb;                   // [P][nb], MALA
  float* post_v = post_g + (kMALA ? kP * nb : 0);      // [nb]
  float* post_u = post_v + nb;                         // [nb]
  float* tile = post_u + nb;
  float reg_th[kThread ? 1 : kN];
  float reg_g[kThread || !kMALA ? 1 : kN];
  auto at = [&](int k) -> float& {
    if constexpr (kThread) {
      return acc_th[k * bd + me];
    } else {
      return reg_th[k];
    }
  };
  auto ag = [&](int k) -> float& {
    if constexpr (kThread) {
      return acc_g[k * bd + me];
    } else if constexpr (kMALA) {
      return reg_g[k];
    } else {
      return reg_g[0];
    }
  };
  const unsigned key0 = static_cast<unsigned>(pr.seed);
  const unsigned key1 = static_cast<unsigned>(c);
  const int rung = c % rungs;
  const float temp = temps[rung];
  const float temp_upper = rung < rungs - 1 ? temps[rung + 1] : 0.0f;
  const float temp_lower = rung > 0 ? temps[rung - 1] : 0.0f;  // lanes
  const bool warp_local = 32 % (rungs * kLanes) == 0;

  float val;
  {
    float th[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int p = ln.coord(k);
      th[k] = p < kP ? theta0[static_cast<size_t>(p) * C + c] : 0.0f;
    }
    if constexpr (kMALA) {
      float g[kN];
      val = ev.vg(th, g);
#pragma unroll
      for (int k = 0; k < kN; ++k) ag(k) = g[k];
    } else {
      val = ev.v(th);
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) at(k) = th[k];
  }

  float n_within = 0.0f;
  float n_swaps = 0.0f;
  float start[kThread ? 1 : kN];  // lanes: theta at the start of a recorded swap iteration
  for (int t = 0; t < pr.num_iters; ++t) {
    const unsigned ctr = static_cast<unsigned>(t);
    const bool counting = t >= pr.num_burnin_iters;
    const bool swap_round = t % pr.between_step == 0;
    const int since = t - pr.num_burnin_iters;
    const bool track_start = pr.record_extras && swap_round && since >= 0 &&
                             since % pr.record_thin == 0 && since / pr.record_thin < pr.kept;
    if (track_start) {
      if constexpr (kThread) {
#pragma unroll
        for (int p = 0; p < kP; ++p) start_th[p * bd + me] = acc_th[p * bd + me];
      } else {
        copy(start, reg_th);
      }
    }
    bool moved = false;
    float u_swap = 0.0f;  // lanes: this chain's swap uniform
    {
      float z[kN];
      float u_lanes = 0.0f;
      if constexpr (kThread) {
        kernel_prng::normals(key0, key1, ctr, z);
      } else {
        const WalkWords<L, 1> words(ln, key0, key1, ctr);
        words.normals(ln, z);
        u_lanes = words.uniform(ln);
        u_swap = words.template uniform_of<1>(ln);
      }
      float prop[kN];
      float v_p;
      float log_rate;
      float gp[kMALA ? kN : 1];
      if constexpr (kMALA) {
        float z_sq = z[0] * z[0];
#pragma unroll
        for (int k = 1; k < kN; ++k) z_sq = z_sq + z[k] * z[k];
        z_sq = ln.sum(z_sq);
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          prop[k] = (at(k) + pr.half_step * (temp * ag(k))) + pr.sqrt_step * z[k];
        }
        v_p = ev.vg(prop, gp);
        float rev_sq = 0.0f;
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          const float dp = at(k) - (prop[k] + pr.half_step * (temp * gp[k]));
          rev_sq = rev_sq + dp * dp;
        }
        rev_sq = ln.sum(rev_sq);
        log_rate = (temp * (v_p - val) - pr.half_inv_step * rev_sq) + 0.5f * z_sq;
      } else {
#pragma unroll
        for (int k = 0; k < kN; ++k) prop[k] = at(k) + pr.value * z[k];
        v_p = ev.v(prop);
        log_rate = temp * (v_p - val);
      }
      float u;
      if constexpr (kThread) {
        u = kernel_prng::uniform_at(key0, key1, ctr, kPairs);
      } else {
        u = u_lanes;
      }
      if (logf(u) < log_rate) {
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          moved |= prop[k] != at(k);
          at(k) = prop[k];
          if constexpr (kMALA) ag(k) = gp[k];
        }
        val = v_p;
        if (counting) n_within += 1.0f;
      }
    }

    if (swap_round) {
      const int parity = (t / pr.between_step) % 2;
      if constexpr (kThread) {
        acc_v[me] = val;
        resident_loop::ladder_sync(warp_local);  // every within move and value is written
        if (rung % 2 == parity && rung < rungs - 1) {
          const float u = kernel_prng::uniform_at(key0, key1, ctr, kPairs + 1);
          const float log_rate = (temp - temp_upper) * (acc_v[me + 1] - val);
          if (logf(u) < log_rate) {
#pragma unroll
            for (int p = 0; p < kP; ++p) {
              const float th = acc_th[p * bd + me];
              acc_th[p * bd + me] = acc_th[p * bd + me + 1];
              acc_th[p * bd + me + 1] = th;
              if constexpr (kMALA) {
                const float g = acc_g[p * bd + me];
                acc_g[p * bd + me] = acc_g[p * bd + me + 1];
                acc_g[p * bd + me + 1] = g;
              }
            }
            acc_v[me] = acc_v[me + 1];
            acc_v[me + 1] = val;
            if (counting) n_swaps += 1.0f;
          }
        }
        resident_loop::ladder_sync(warp_local);  // every exchange is done
        val = acc_v[me];
        if (track_start) {
          moved = false;
#pragma unroll
          for (int p = 0; p < kP; ++p) moved |= acc_th[p * bd + me] != start_th[p * bd + me];
        }
      } else {
#pragma unroll
        for (int k = 0; k < kN; ++k) {
          const int p = ln.coord(k);
          if (p < kP) {
            post_th[p * nb + ci] = at(k);
            if constexpr (kMALA) post_g[p * nb + ci] = ag(k);
          }
        }
        if (ln.lane == 0) {
          post_v[ci] = val;
          post_u[ci] = u_swap;
        }
        resident_loop::ladder_sync(warp_local);  // every chain has posted
        const bool lower = rung % 2 == parity && rung < rungs - 1;
        const bool upper = rung > 0 && (rung - 1) % 2 == parity;
        int partner = ci;
        bool take = false;
        if (lower) {
          partner = ci + 1;
          take = logf(u_swap) < (temp - temp_upper) * (post_v[partner] - val);
        } else if (upper) {
          partner = ci - 1;
          take = logf(post_u[partner]) < (temp_lower - temp) * (val - post_v[partner]);
        }
        if (take) {
#pragma unroll
          for (int k = 0; k < kN; ++k) {
            const int p = ln.coord(k);
            if (p < kP) {
              at(k) = post_th[p * nb + partner];
              if constexpr (kMALA) ag(k) = post_g[p * nb + partner];
            }
          }
          val = post_v[partner];
          if (lower && counting) n_swaps += 1.0f;
        }
        resident_loop::ladder_sync(warp_local);  // every chain has read its partner's post
        if (track_start) {
          moved = false;
#pragma unroll
          for (int k = 0; k < kN; ++k) moved |= at(k) != start[k];
        }
      }
    }
    moved = ln.any(moved);

    if constexpr (kThread) {
      resident_loop::record(samples, t, pr.num_burnin_iters, pr.record_thin, pr.kept,
                            pr.record_extras, C, c, acc_th, val, moved);
    } else if (since >= 0 && since % pr.record_thin == 0 && since / pr.record_thin < pr.kept) {
      record_lanes(ln, samples, tile, since / pr.record_thin, pr.kept, C, c,
                   pr.record_extras != 0, reg_th, val, moved);
    }
  }

#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int p = ln.coord(k);
    if (p < kP) final_theta[static_cast<size_t>(p) * C + c] = at(k);
  }
  if (ln.lane == 0) {
    accepts[c] = n_within;
    accepts[static_cast<size_t>(C) + c] = n_swaps;
  }
}

// ---- the SMC mutation pass ----

// One particle's SMC mutation pass, on the lanes ln (Lanes<1>: one thread):
// num_steps MH or MALA moves at the target v = lp + beta ll (ev: a
// SplitEval, a LaneSplitEval, or the closure kernel's evaluator; beta is the
// evaluator's), from theta0, with walk_chain's draws (the walk stream: key
// (stage seed, particle), counter (step, j): the normal pairs, then the
// accept uniform at word ceil(P/2)) and accept algebra. With s = sqrt(step):
//   MH:   prop = theta + s z; log_rate = v(prop) - v(theta).
//   MALA: prop = theta + (step/2) grad + s z;
//         log_rate = v(prop) - v(theta) - |theta - prop - (step/2) grad(prop)|^2 / (2 step)
//                    + |z|^2 / 2,
// grad the target's combined gradient. Records nothing: writes the final
// theta, pot (the accepted state's untempered log-likelihood, the next
// stage's reweighting potential) and the accept count. Layouts as
// walk_chain's: one thread keeps the accepted theta (and gradient, MALA) in
// buf, [P][blockDim] of shared memory; a group of lanes keeps them in
// registers, spread over the lanes, with the iteration's words spread over
// the lanes and |z|^2, the reverse-proposal norm, the value and ll reduced
// over the lanes, so every lane takes the same accept decision (buf unused).
template <bool kMALA, class L, class Eval>
__device__ __forceinline__ void smc_chain(const Eval& ev, const L& ln,
                                          const ResidentSMCParams& pr, int c,
                                          const float* __restrict__ theta0,
                                          float* __restrict__ final_theta,
                                          float* __restrict__ pot, float* __restrict__ accepts,
                                          float* buf) {
  constexpr int kN = L::kPer;
  constexpr bool kThread = L::kLanes == 1;
  constexpr int kPairs = resident_loop::kPairs;
  const int bd = blockDim.x;
  const int me = threadIdx.x;
  const int N = pr.num_particles;
  const unsigned key0 = static_cast<unsigned>(pr.seed);
  const unsigned key1 = static_cast<unsigned>(c);
  float* acc_th = buf;           // one thread: the accepted theta, [P][bd]
  float* acc_g = buf + kP * bd;  // one thread, MALA: its gradient, [P][bd]
  float reg_th[kThread ? 1 : kN];
  float reg_g[kThread || !kMALA ? 1 : kN];
  auto at = [&](int k) -> float& {
    if constexpr (kThread) {
      return acc_th[k * bd + me];
    } else {
      return reg_th[k];
    }
  };
  auto ag = [&](int k) -> float& {
    if constexpr (kThread) {
      return acc_g[k * bd + me];
    } else if constexpr (kMALA) {
      return reg_g[k];
    } else {
      return reg_g[0];
    }
  };

  float val;
  float ll;
  {
    float th[kN];
#pragma unroll
    for (int k = 0; k < kN; ++k) {
      const int p = ln.coord(k);
      th[k] = p < kP ? theta0[static_cast<size_t>(p) * N + c] : 0.0f;
    }
    if constexpr (kMALA) {
      float g[kN];
      val = ev.vg(th, g, ll);
#pragma unroll
      for (int k = 0; k < kN; ++k) ag(k) = g[k];
    } else {
      val = ev.v(th, ll);
    }
#pragma unroll
    for (int k = 0; k < kN; ++k) at(k) = th[k];
  }

  float n_accepts = 0.0f;
  for (int s = 0; s < pr.num_steps; ++s) {
    const unsigned ctr = static_cast<unsigned>(s);
    float z[kN];
    float u;
    if constexpr (kThread) {
      kernel_prng::normals(key0, key1, ctr, z);
      u = kernel_prng::uniform_at(key0, key1, ctr, kPairs);
    } else {
      const WalkWords<L> words(ln, key0, key1, ctr);
      words.normals(ln, z);
      u = words.uniform(ln);
    }
    float prop[kN];
    float v_p;
    float ll_p;
    float log_rate;
    float gp[kMALA ? kN : 1];
    if constexpr (kMALA) {
      float z_sq = z[0] * z[0];
#pragma unroll
      for (int k = 1; k < kN; ++k) z_sq = z_sq + z[k] * z[k];
      z_sq = ln.sum(z_sq);
#pragma unroll
      for (int k = 0; k < kN; ++k) prop[k] = (at(k) + pr.half_step * ag(k)) + pr.sqrt_step * z[k];
      v_p = ev.vg(prop, gp, ll_p);
      float rev_sq = 0.0f;
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        const float dp = at(k) - (prop[k] + pr.half_step * gp[k]);
        rev_sq = rev_sq + dp * dp;
      }
      rev_sq = ln.sum(rev_sq);
      log_rate = ((v_p - val) - pr.half_inv_step * rev_sq) + 0.5f * z_sq;
    } else {
#pragma unroll
      for (int k = 0; k < kN; ++k) prop[k] = at(k) + pr.sqrt_step * z[k];
      v_p = ev.v(prop, ll_p);
      log_rate = v_p - val;
    }
    if (logf(u) < log_rate) {
#pragma unroll
      for (int k = 0; k < kN; ++k) {
        at(k) = prop[k];
        if constexpr (kMALA) ag(k) = gp[k];
      }
      val = v_p;
      ll = ll_p;
      n_accepts += 1.0f;
    }
  }

#pragma unroll
  for (int k = 0; k < kN; ++k) {
    const int p = ln.coord(k);
    if (p < kP) final_theta[static_cast<size_t>(p) * N + c] = at(k);
  }
  if (ln.lane == 0) {
    pot[c] = ll;
    accepts[c] = n_accepts;
  }
}

}  // namespace lane_eval
