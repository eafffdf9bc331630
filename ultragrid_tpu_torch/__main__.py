import sys

from ultragrid_tpu_torch.cli import main

sys.exit(main())
