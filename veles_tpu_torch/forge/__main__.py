"""``python -m veles_tpu_torch.forge list|fetch|upload ...``."""

import sys

from veles_tpu_torch.forge.client import main

if __name__ == "__main__":
    sys.exit(main())
