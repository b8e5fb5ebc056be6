"""`python -m pbrt_tpu_torch` entry point (reference: src/main.rs CLI)."""
import sys

from pbrt_tpu_torch.main import main

if __name__ == "__main__":
    sys.exit(main())
