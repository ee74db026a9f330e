"""The port's spans on the GPU, over a traced K1 fan-out of 2^16 lanes.

Every test here is marked ``cuda`` and skips without a CUDA device; the
file imports neither JAX nor the JAX package:

    python -m pytest tests/test_torch_tracing_cuda.py -q --noconftest

``kernel.k1``'s device time (CUDA events around the launch) is within 2%
of the profiler's ``lane_tile_solve`` kernel time, the launch's runtime
event lies inside the ``kernel.k1`` span on the profiler's clock, the
build's spans are device-timed, and a snapshot after ``reset()`` counts
only the window after it.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pqp_for_mpc_tpu_torch import bench
from pqp_for_mpc_tpu_torch.dual import dual_geometry, dualize_forcing
from pqp_for_mpc_tpu_torch.models import condense
from pqp_for_mpc_tpu_torch.ops import solve_kernel
from pqp_for_mpc_tpu_torch.routing import solve_auto
from pqp_for_mpc_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

LANES = 1 << 16
KERNEL = "lane_tile_solve"


@pytest.fixture(scope="module")
def fanout():
    """One traced window of a cold fan-out (the build and K1), warmed up
    first; returns (the profiler, the snapshot, the records, the step)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the GPU")
    dev = torch.device("cuda", 0)
    data = condense(bench.example_spec(7, 2.5), device=dev)
    Qp = data.qp()
    cfg = bench.EXAMPLE_CFG
    geom = dual_geometry(data.Gp, data.Qp_inv, theta_floor=cfg.theta_floor)
    x = 0.5 * torch.randn((2, LANES), generator=torch.Generator(
        dev).manual_seed(0), device=dev)

    def step():
        primal = data.assemble(x=x, Qp=Qp)
        dual = dualize_forcing(geom, primal.Fp, primal.Mp, primal.Kp)
        res = solve_auto(primal, dual, cfg=cfg)
        torch.cuda.synchronize(dev)
        return res

    step()
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    snap = tracing.snapshot()
    return prof, snap, tracing.records_since(), step


def _kernel_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == cuda and KERNEL in e.name()]


def test_k1_device_time_is_the_profilers(fanout):
    prof, snap, _, _ = fanout
    k1 = snap["spans"]["kernel.k1"]
    kernels = _kernel_events(prof)
    assert k1["count"] == len(kernels) == 1
    traced = sum(e.duration_ns() for e in kernels) * 1e-9
    assert abs(k1["device_s"] - traced) <= 0.02 * traced
    for name in ("build.assemble", "build.dualize_forcing"):
        assert snap["spans"][name]["device_s"] > 0.0, name
    assert snap["counters"]["route.fused"] == 1
    assert snap["launches"]["k1"] == 1


def test_k1_launch_lies_inside_its_span(fanout):
    prof, _, recs, _ = fanout
    kernel = _kernel_events(prof)[0]
    cuda = torch.autograd.DeviceType.CUDA
    runtime = [e for e in prof.profiler.kineto_results.events()
               if e.device_type() != cuda and "aunch" in e.name()
               and kernel.correlation_id() in (e.correlation_id(),
                                               e.linked_correlation_id())]
    assert runtime, "no runtime event of the K1 launch"
    span = [r for r in recs if r["name"] == "kernel.k1"][0]
    for e in runtime:
        assert span["start_ns"] <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= span["end_ns"]


def test_reset_starts_a_new_window(fanout):
    _, _, _, step = fanout
    before = solve_kernel.fused_full_solve.launches
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        step()
        step()
    snap = tracing.snapshot()
    assert snap["launches"]["k1"] == 2
    assert solve_kernel.fused_full_solve.launches - before == 2
    assert snap["spans"]["kernel.k1"]["count"] == 2
    assert snap["spans"]["solve.auto"]["count"] == 2
    assert snap["counters"] == {"route.fused": 2}
