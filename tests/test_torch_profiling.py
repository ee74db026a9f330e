"""The port's ``utils/profiling.py`` on the CPU: ``trace`` writes a
Chrome/Perfetto trace of the wrapped region (its program spans:
``tests/test_torch_tracing.py``)."""

import json
import os

import torch

from pqp_for_mpc_tpu_torch import PrimalQP, SolverConfig, dualize
from pqp_for_mpc_tpu_torch import solve_batched
from pqp_for_mpc_tpu_torch.utils.profiling import trace


def _problem():
    M, N, B = 4, 8, 3
    g = torch.Generator().manual_seed(0)
    L = torch.randn(M, M, generator=g)
    Qp = L @ L.T + M * torch.eye(M)
    primal = PrimalQP(Qp=Qp, Qp_inv=torch.linalg.inv(Qp),
                      Fp=torch.randn(M, B, generator=g), Mp=torch.zeros(B),
                      Gp=torch.randn(N, M, generator=g),
                      Kp=torch.rand(N, generator=g) + 1.0)
    return primal, dualize(primal)


def test_trace_writes_a_trace_of_the_region(tmp_path):
    primal, dual = _problem()
    with trace(str(tmp_path / "tr")):
        solve_batched(primal, dual, cfg=SolverConfig(max_iters=50))
    path = tmp_path / "tr" / "trace.json"
    assert os.path.isfile(path)
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" == e.get("name", "")
               for e in events)

