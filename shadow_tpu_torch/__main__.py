"""`python -m shadow_tpu_torch run CONFIG`."""

import sys

from shadow_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
