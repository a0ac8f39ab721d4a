#!/usr/bin/env python3
"""One run of one cell of the port's benchmark (``BENCHMARK.json``).

  python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
                            --trace <0|1>

Run from the root of a checkout; the last line of standard output is the
result (``pb/cli.py`` says what it holds).
"""
import time

START = time.time()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

if __name__ == "__main__":
    sys.path[:0] = [HERE, ROOT]
    from pb import cli
    sys.exit(cli.main(sys.argv[1:], START, ROOT))
