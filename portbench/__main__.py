import time

T0 = time.perf_counter()

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

sys.exit(main(T0))
