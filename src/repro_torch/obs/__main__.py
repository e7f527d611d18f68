"""CLI entrypoint: ``python -m repro_torch.obs report RUN.jsonl``."""
import sys

from repro_torch.obs.report import main

if __name__ == "__main__":
    sys.exit(main())
