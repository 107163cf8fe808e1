"""Entry point: python -m swipe_tpu_torch [options]."""

import sys

from .cli import main

sys.exit(main())
