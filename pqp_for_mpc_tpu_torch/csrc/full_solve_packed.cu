// K8: the whole batched PQP solve with G instances packed per lane column.
//
// Replaces the TPU kernel pqp_for_mpc_tpu/ops/packed_kernel.py:
// fused_full_solve_packed (its Pallas body _kernel).  On the TPU, packing
// G = 128 // n_pad instances of one geometry block-diagonally
// (kron(I_G, A)) fills the MXU's 128-deep contraction axis, and every
// reduction of the check, the accel step and the stall test becomes a
// segment reduction (products with the 0/1 indicator E and its transpose).
// The function it computes is K1's, per instance: the same iterates,
// iteration stamps and state codes (0 max_iters, 1 certified, 2 stalled;
// 3 marks padding and never leaves the wrapper).
//
// Why this entry launches K1's engine (lane_tile_solve.cuh, through
// full_solve_f32 in full_solve.cu).  On SIMT hardware there is no
// contraction axis to fill: the engine's lane tile (4 rows x 4 lanes per
// thread, the geometry staged once per block) already reuses every
// geometry load across lanes, which is all that packing bought the TPU,
// and the kron's zero blocks would be pure waste — (G n_pad)^2 products
// where the function needs G n^2.  So K8 keeps its contract (the packing
// rule: an N that pads to more than 64 does not pack and is refused; so is
// the dual-gradient feasibility test, which the TPU kernel does not have)
// and runs the engine, and gives K1's bits on every lane.

#include <cuda_runtime.h>

// full_solve.cu's entry: the lane-tile engine
extern "C" int full_solve_f32(
    const float* geo, const float* fp, int fp_lane, const float* fd,
    int fd_lane, const float* fdp, int fdp_lane, const float* fdn,
    int fdn_lane, const float* kps, int kps_lane, const float* mp,
    int mp_lane, const float* md, int md_lane, const float* y0, int y0_lane,
    float* y_out, float* u_out, int* iters_out, int* state_out, int* queue,
    int n, int m, int B, int max_iters, int check_every, int accel_every,
    float eaj, float erj, int strict, float den_eps, int gap_comp,
    int feas_dual, void* stream);

extern "C" int full_solve_packed_f32(
    const float* geo, const float* fp, int fp_lane, const float* fd,
    int fd_lane, const float* fdp, int fdp_lane, const float* fdn,
    int fdn_lane, const float* kps, int kps_lane, const float* mp,
    int mp_lane, const float* md, int md_lane, const float* y0, int y0_lane,
    float* y_out, float* u_out, int* iters_out, int* state_out, int* queue,
    int n, int m, int B, int max_iters, int check_every, int accel_every,
    float eaj, float erj, int strict, float den_eps, int gap_comp,
    int feas_dual, void* stream) {
  // the TPU kernel's packing: n_pad = n rounded up to 8 (at least 8),
  // G = 128 / n_pad instances per column
  const int n_pad = ((n > 8 ? n : 8) + 7) / 8 * 8;
  // and the TPU kernel's forcing-scale feasibility test alone
  if (n < 1 || 128 / n_pad < 2 || feas_dual) return (int)cudaErrorInvalidValue;
  return full_solve_f32(geo, fp, fp_lane, fd, fd_lane, fdp, fdp_lane, fdn,
                        fdn_lane, kps, kps_lane, mp, mp_lane, md, md_lane,
                        y0, y0_lane, y_out, u_out, iters_out, state_out,
                        queue, n, m, B, max_iters, check_every, accel_every,
                        eaj, erj, strict, den_eps, gap_comp, 0, stream);
}
