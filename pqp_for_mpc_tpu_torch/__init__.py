"""pqp_for_mpc_tpu_torch — the PQP engine for linear MPC in PyTorch and CUDA.

A port of the JAX package ``pqp_for_mpc_tpu`` (which stays the reference) to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).  The
module names mirror the JAX package's:

* :mod:`pqp_for_mpc_tpu_torch.problem` — primal/dual QP containers.
* :mod:`pqp_for_mpc_tpu_torch.dual`    — primal -> dual transform and splits
  (shared geometry, and one geometry per instance: ``dualize_distinct``).
* :mod:`pqp_for_mpc_tpu_torch.solver`  — the batched masked-lane PQP solver.
* :mod:`pqp_for_mpc_tpu_torch.routing` — engine routing (``solve_auto``).
* :mod:`pqp_for_mpc_tpu_torch.ops`     — the CUDA kernels and their plain
  PyTorch versions; ``csrc/`` holds the sources, built at first use.
* :mod:`pqp_for_mpc_tpu_torch.models`  — plant zoo, condensation, the
  stage-wise long-horizon backend, robust tightening and the
  receding-horizon controller.
* :mod:`pqp_for_mpc_tpu_torch.diff`    — ``solve_qp_implicit``, gradients
  through the solution (a ``torch.autograd.Function``).
* :mod:`pqp_for_mpc_tpu_torch.convert` — problem data across from the JAX
  package as NumPy arrays.

The package imports ``torch`` and NumPy, never JAX.
"""

__version__ = "0.1.0"

from pqp_for_mpc_tpu_torch.problem import (  # noqa: F401
    CondensedMPCData, DualQP, PrimalQP)
from pqp_for_mpc_tpu_torch.config import SolverConfig  # noqa: F401
from pqp_for_mpc_tpu_torch.dual import (  # noqa: F401
    dualize, dualize_distinct)
from pqp_for_mpc_tpu_torch.solver import (  # noqa: F401
    SolveResult, solve, solve_batched, solve_mixed)
from pqp_for_mpc_tpu_torch.routing import route_solve, solve_auto  # noqa: F401
from pqp_for_mpc_tpu_torch.diff import solve_qp_implicit  # noqa: F401
from pqp_for_mpc_tpu_torch.ops.distinct_kernel import (  # noqa: F401
    solve_fused_distinct)
from pqp_for_mpc_tpu_torch.ops.distinct_tiled_kernel import (  # noqa: F401
    solve_fused_distinct_tiled)
from pqp_for_mpc_tpu_torch.ops.packed_kernel import (  # noqa: F401
    solve_fused_packed)
