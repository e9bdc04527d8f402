// The join epoch's decisions (csrc/nj_epoch.cuh Master) on the host, for
// tests/test_torch_epoch_warp.py and tests/test_torch_constraints_host.py
// (with the constraint penalties of csrc/constraints.cuh): the deciding warp's 32 lanes are
// coroutines (ucontext) on one thread, and every collective (sync, ballot,
// match, shuffle) is a barrier at which each lane yields to the next, so no
// lane passes it before all have arrived; a lane that leaves the warp's
// common control flow shows as a count of barriers unlike the others'.  The
// phases run serially on lane 0, with the kernel's per-position bodies
// (average_pos, out_update_pos, query_pos) and plain serial sums for the
// distances and scans.
//
//   g++ -std=c++20 -O1 -shared -fPIC -ffp-contract=off -Iinclude
//       -I../../veryfasttree_tpu_torch/csrc -o libhost_epoch.so host_epoch.cpp
#include <ucontext.h>

#include <cstring>
#include <functional>
#include <vector>

#include "nj_epoch.cuh"

namespace {

constexpr int kLanes = 32;
constexpr size_t kLaneStack = 1 << 20;

ucontext_t main_ctx, lane_ctx[kLanes];
unsigned cur_lane = 0;
long long barriers[kLanes];
unsigned long long slots[kLanes];
std::function<void()> lane_body;

struct HostWarp {
  static unsigned lane() { return cur_lane; }
  // the barrier: yield to the next lane; the last lane's yield resumes lane 0
  static void sync() {
    const unsigned me = cur_lane;
    ++barriers[me];
    cur_lane = (me + 1) % kLanes;
    swapcontext(&lane_ctx[me], &lane_ctx[cur_lane]);
  }
  template <class T>
  static T exchange(T v, int src) {
    std::memcpy(&slots[cur_lane], &v, sizeof(T));
    sync();
    T o;
    std::memcpy(&o, &slots[src], sizeof(T));
    sync();
    return o;
  }
  static unsigned ballot(bool p) {
    slots[cur_lane] = p;
    sync();
    unsigned m = 0;
    for (int i = 0; i < kLanes; ++i) m |= (unsigned)(slots[i] != 0) << i;
    sync();
    return m;
  }
  static unsigned match(int x) {
    slots[cur_lane] = (unsigned long long)(long long)x;
    sync();
    unsigned m = 0;
    for (int i = 0; i < kLanes; ++i) m |= (unsigned)((long long)slots[i] == (long long)x) << i;
    sync();
    return m;
  }
  static int shfl(int v, int src) { return exchange(v, src); }
  static double shfl(double v, int src) { return exchange(v, src); }
  static int shfl_xor(int v, int m) { return exchange(v, (int)(cur_lane ^ m)); }
  static double shfl_xor(double v, int m) { return exchange(v, (int)(cur_lane ^ m)); }
};

// a lane's coroutine: the body, then the next lane (the last: the caller)
void lane_main(int l) {
  lane_body();
  cur_lane = (unsigned)(l + 1) % kLanes;
}

// runs body() on every lane; false if the lanes met unlike numbers of barriers
bool run_warp(std::function<void()> body) {
  lane_body = std::move(body);
  std::vector<std::vector<char>> stacks(kLanes, std::vector<char>(kLaneStack));
  for (int l = kLanes - 1; l >= 0; --l) {
    getcontext(&lane_ctx[l]);
    lane_ctx[l].uc_stack.ss_sp = stacks[l].data();
    lane_ctx[l].uc_stack.ss_size = kLaneStack;
    lane_ctx[l].uc_link = l + 1 < kLanes ? &lane_ctx[l + 1] : &main_ctx;
    makecontext(&lane_ctx[l], (void (*)())lane_main, 1, l);
    barriers[l] = 0;
  }
  cur_lane = 0;
  swapcontext(&main_ctx, &lane_ctx[0]);
  for (int l = 1; l < kLanes; ++l)
    if (barriers[l] != barriers[0]) return false;
  return true;
}

template <int C>
struct HostPhases {
  static constexpr bool kCons = false;
  const EpochParams& e;

  StoreView view() const { return StoreView{e.codes, e.W, e.U, e.code_freq, e.leaf_rows, (int)e.P}; }

  // (dist, denom) of rows ra, rb (-1: the out-profile), summed in position order
  void pair(int64_t ra, int64_t rb, double& dist, double& denom) const {
    const StoreView s = view();
    double d = 0.0, t = 0.0;
    for (int p = 0; p < e.P; ++p) {
      float wa, wb, ua[C], ub[C];
      load_pos<C>(s, ra, p, e.qU, e.w_out, wa, ua);
      load_pos<C>(s, rb, p, e.qU, e.w_out, wb, ub);
      d = std::fma((double)wa, (double)wb, d);
      for (int c = 0; c < C; ++c)
        t = e.ev ? std::fma((double)ua[c] * (double)ub[c], e.ev[c], t)
                 : std::fma((double)ua[c], (double)ub[c], t);
    }
    dist = d > 0.0 ? (e.ev ? t : d - t) / d : 1.0;
    denom = d;
  }

  void phase(const PhaseCmd& c) const {
    const StoreView s = view();
    const int P = (int)e.P;
    if (c.kind == kPhPairs) {
      for (int64_t k = 0; k < c.n; ++k) pair(e.pa[k], e.pb[k], e.rd[k], e.rw[k]);
    } else if (c.kind == kPhJoin) {
      const float bw = (float)c.bw;
      for (int p = 0; p < P; ++p) {
        average_pos<C>(s, e.codes, e.W, e.U, e.et, c.t, c.i, c.j, p, bw, 1.0f - bw, c.bw == 0.5,
                       (float)e.tol, (float)(1.0 / C));
        if (c.n_old > 0) out_update_pos<C>(e, s, c.i, c.j, c.t, c.n_old, p);
      }
      pair(c.t, c.t, e.rd[0], e.rw[0]);
    } else if (c.kind == kPhQuery) {
      for (int p = 0; p < P; ++p) query_pos<C>(e, s, c.t, p);
    } else if (c.kind == kPhScan) {
      for (int64_t k = 0; k < c.n; ++k) {
        double den = 0.0, dots = 0.0;
        for (int p = 0; p < P; ++p) {
          float w, u[C];
          load_pos<C>(s, e.pa[k], p, nullptr, nullptr, w, u);
          den += e.qw[p] * (double)w;
          for (int cc = 0; cc < C; ++cc) dots += e.qa[p * C + cc] * (double)u[cc];
        }
        e.rd[k] = den > 0.0 ? (e.use_matrix ? dots : den - dots) / den : 1.0;
        e.rw[k] = den;
      }
    } else if (c.kind == kPhOutQuery) {
      for (int p = 0; p < P; ++p)
        for (int cc = 0; cc < C; ++cc) e.qU[p * C + cc] = e.w_out[p] * e.f_out[p * C + cc];
    }
  }

  // every lane calls it, as the kernel's master does
  void run(const PhaseCmd& c) const {
    HostWarp::sync();
    if (cur_lane == 0) phase(c);
    HostWarp::sync();
  }
};

// the phases of the constrained master: the same, with the counts
template <int C>
struct HostPhasesCons : HostPhases<C> {
  static constexpr bool kCons = true;
  EpochCons cons;
};

// one launch's joins; k: the counts, or null
template <int C>
bool run_launch(const EpochParams& given, const EpochCons* k) {
  EpochParams e = given;
  const SmemPlan plan = smem_plan(e.M, e.m, e.ntv, e.smem_state != 0, e.smem_lists != 0);
  e.smem_state = plan.state;
  e.smem_lists = plan.lists;
  std::vector<double> smem(plan.bytes / sizeof(double) + 2);
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem.data());
  return run_warp([&] {
    if (k != nullptr) {
      HostPhasesCons<C> ph{{e}, *k};
      Master<HostWarp, HostPhasesCons<C>> master(e, ph, sm, plan.state, plan.lists);
      master.run_launch();
    } else {
      HostPhases<C> ph{e};
      Master<HostWarp, HostPhases<C>> master(e, ph, sm, plan.state, plan.lists);
      master.run_launch();
    }
  });
}

int run_any(const EpochParams& e, const EpochCons* k) {
  bool ok;
  if (e.C == 4) ok = run_launch<4>(e, k);
  else if (e.C == 20) ok = run_launch<20>(e, k);
  else return -2;
  return ok ? 0 : -3;
}

}  // namespace

extern "C" {

void vft_nj_epoch_scratch(int64_t M, int64_t m, int64_t ntv, int64_t* out) {
  const ScratchLayout s = scratch_layout(M, m, ntv);
  out[0] = s.i_small;
  out[1] = s.d_len;
}

// One launch's joins on host arrays (an EpochParams).  Returns 0, -2 for a
// code count the decisions do not take, or -3 if the lanes parted.
int vft_nj_epoch_host(const void* params) {
  return run_any(*static_cast<const EpochParams*>(params), nullptr);
}

// The same under -constraints (an EpochCons: the counts, updated in place).
int vft_nj_epoch_cons_host(const void* params, const void* cons) {
  return run_any(*static_cast<const EpochParams*>(params),
                 static_cast<const EpochCons*>(cons));
}

// csrc/constraints.cuh on the host: np_sum over a[0, n), the quartet
// penalties of n4 into pen[3], and the join penalty of (i, j)
double vft_np_sum_host(const double* a, int n) {
  int k = 0;
  auto term = [&] { return a[k++]; };
  return np_sum(n, term);
}

void vft_quartet_penalties_host(const int32_t* on, const int32_t* off, int n_cons, double weight,
                                const int32_t* n4, double* pen) {
  const ConView v{on, off, n_cons, weight};
  const int nodes[4] = {n4[0], n4[1], n4[2], n4[3]};
  quartet_penalties(v, nodes, pen);
}

int64_t vft_join_penalty_host(const int32_t* on, const int32_t* off, const int32_t* out_on,
                              const int32_t* out_off, int n_cons, int i, int j) {
  const ConView v{on, off, n_cons, 1.0};
  return join_penalty(v, out_on, out_off, i, j);
}

}  // extern "C"
