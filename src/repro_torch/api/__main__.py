"""``python -m repro_torch.api`` entry point — see ``repro_torch.api.cli``."""
import sys

from repro_torch.api.cli import main

if __name__ == "__main__":
    sys.exit(main())
