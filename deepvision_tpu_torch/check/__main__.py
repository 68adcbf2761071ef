"""`python -m deepvision_tpu_torch.check` — the port's IR audit CLI."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
