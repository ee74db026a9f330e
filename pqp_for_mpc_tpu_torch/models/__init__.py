from pqp_for_mpc_tpu_torch.models.plants import (  # noqa: F401
    ZOO,
    LinearPlant,
    LTVPlant,
    aircraft_pitch,
    dc_motor,
    double_integrator,
    mass_spring_damper,
    quadruple_tank,
    random_stable,
    stack_plant,
    thermal_rc,
)
from pqp_for_mpc_tpu_torch.models.mpc import (  # noqa: F401
    MPCController,
    MPCSpec,
    auto_backend,
    condense,
    condensed_n_con,
    dare_terminal_weight,
    input_constraints,
    move_schedule,
    prediction_matrices,
)
from pqp_for_mpc_tpu_torch.models.stagewise import (  # noqa: F401
    StagewiseDual,
    StagewiseFactor,
    kkt_solve,
    relinearize,
    riccati_factor,
    solve_stagewise,
    stagewise_dual,
)
from pqp_for_mpc_tpu_torch.models.rti import (  # noqa: F401
    RTIController,
    output_feedback_rollout,
)
from pqp_for_mpc_tpu_torch.models.estimator import (  # noqa: F401
    KalmanFilter,
    kalman_gain,
)
from pqp_for_mpc_tpu_torch.models.mhe import (  # noqa: F401
    MovingHorizonEstimator,
    NonlinearMHE,
)
from pqp_for_mpc_tpu_torch.models.robust import (  # noqa: F401
    lqr_gain,
    robust_spec,
    tube_margins,
)
from pqp_for_mpc_tpu_torch.models.offset_free import (  # noqa: F401
    OffsetFreeController,
    augment_plant,
    check_offset_free_rank,
    disturbance_channels,
    target_maps,
)
