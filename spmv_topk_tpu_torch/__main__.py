"""``python -m spmv_topk_tpu_torch``: the command line (``cli.main``).

The call sits under the ``__main__`` check so that importing this module
(as ``pkgutil.walk_packages`` does) runs nothing."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
