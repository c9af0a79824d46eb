"""``python -m pytorch_distributed_tpu_torch.analysis.ir`` -> graftir CLI."""

import sys

from pytorch_distributed_tpu_torch.analysis.ir.cli import main

if __name__ == "__main__":
    sys.exit(main())
