// K1: the whole batched PQP solve in one launch.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/solve_kernel.py:
// fused_full_solve (its Pallas body _kernel): multiplicative updates, the
// periodic four-part termination check with the recovered U, optional
// safeguarded acceleration, the stall freeze and the early exit, with the
// problem geometry resident in fast memory for the whole solve.  The TPU
// grid loops a whole batch block until every lane of the block is done,
// freezing done lanes; lanes never read each other, so for every lane the
// iterates, iters and state code are those of a lane solved alone.
//
// The kernel is the lane-tile engine (lane_tile_solve.cuh: a register
// tile over 4 rows x 4 lanes for every product, per-lane sums in a fixed
// order, and a persistent grid that refills a slot from a global queue as
// soon as its lane retires; the note there gives the design and what bounds
// it).  This file holds its C entry points: the launch, and the plan the
// card picks for a shape.
//
// Semantics match pqp_for_mpc_tpu_torch/ops/solve_kernel.py:
// fused_full_solve_reference up to float32 summation order.  feas_dual
// selects the dual-gradient feasibility test of
// pqp_for_mpc_tpu_torch/solver.py: check_terminate, with kps holding the
// slack max(erc Kp, eac); the TPU kernel has only the forcing-scale test.

#include <cuda_runtime.h>

#include "lane_tile_solve.cuh"

extern "C" int full_solve_f32(
    const float* geo, const float* fp, int fp_lane, const float* fd,
    int fd_lane, const float* fdp, int fdp_lane, const float* fdn,
    int fdn_lane, const float* kps, int kps_lane, const float* mp,
    int mp_lane, const float* md, int md_lane, const float* y0, int y0_lane,
    float* y_out, float* u_out, int* iters_out, int* state_out, int* queue,
    int n, int m, int B, int max_iters, int check_every, int accel_every,
    float eaj, float erj, int strict, float den_eps, int gap_comp,
    int feas_dual, void* stream) {
  pqp::lts::Args a;
  a.geo = geo;
  a.fp = fp; a.fd = fd; a.fdp = fdp; a.fdn = fdn; a.kps = kps; a.mp = mp;
  a.md = md; a.y0 = y0;
  a.fp_lane = fp_lane; a.fd_lane = fd_lane; a.fdp_lane = fdp_lane;
  a.fdn_lane = fdn_lane; a.kps_lane = kps_lane; a.mp_lane = mp_lane;
  a.md_lane = md_lane; a.y0_lane = y0_lane;
  a.y_out = y_out; a.u_out = u_out; a.iters_out = iters_out;
  a.state_out = state_out; a.queue = queue;
  a.n = n; a.m = m; a.B = B; a.max_iters = max_iters;
  a.check_every = check_every; a.accel_every = accel_every;
  a.eaj = eaj; a.erj = erj; a.strict = strict; a.den_eps = den_eps;
  a.gap_comp = gap_comp; a.feas_dual = feas_dual;
  return (int)pqp::lts::launch(a, static_cast<cudaStream_t>(stream));
}

// The engine's plan for (n, m, B) as this card launches it: out = {lanes,
// threads, staged matrices, shared bytes, blocks per SM, SMs, grid}, for
// the forcing-scale instantiation (the fan-out's).
extern "C" int full_solve_plan(int n, int m, int B, int* out) {
  if (n < 1 || m < 1 || n > 128 || m > 128 || B < 1)
    return (int)cudaErrorInvalidValue;
  const pqp::lts::Plan p = pqp::lts::plan(n, m);
  if (p.smem > pqp::lts::kSmemLimit) return (int)cudaErrorInvalidValue;
  int per_sm = 0, sms = 0, grid = 0;
  const cudaError_t err =
      pqp::lts::card_grid<false>(p, B, &per_sm, &sms, &grid);
  if (err != cudaSuccess) return (int)err;
  const int vals[7] = {p.lanes, p.threads, p.staged, (int)p.smem, per_sm,
                       sms, grid};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}
