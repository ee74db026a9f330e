import sys

from pqp_for_mpc_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
