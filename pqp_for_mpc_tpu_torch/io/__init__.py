"""Problem files: the reference's ``example/`` directory format and its
generator format (NumPy copies of the JAX package's ``io/``)."""
from pqp_for_mpc_tpu_torch.io.example_loader import (  # noqa: F401
    load_example_dir,
    write_example_dir,
)
from pqp_for_mpc_tpu_torch.io.generator import (  # noqa: F401
    GeneratedQP,
    generate_instance,
    read_generator_file,
    write_generator_file,
)
