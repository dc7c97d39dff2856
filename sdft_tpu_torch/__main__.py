"""``python -m sdft_tpu_torch <7 driver args> [--fd32] [--block N] [--device D]``,
``... bench [m] [block] [runs]`` and ``... trace <logdir> <7 driver args>``
(see ``sdft_tpu_torch.cli``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
