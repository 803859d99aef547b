"""Entry point: ``python -m repro_torch.trace record|replay|diff|verify``."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
