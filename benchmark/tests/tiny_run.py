"""A whole run of a cell at the tiny test size on the CPU: ``run.main``
with the look for a card skipped and the cell's files swapped for their
tiny versions (``conftest``), judged by the tiny size's own limits
(``tiny_limits.json``, set from the tiny size's readings).

    python3 -m benchmark.tests.tiny_run <cell>     # prints the result line
"""

import io
import json
import os
import sys
from contextlib import redirect_stderr, redirect_stdout

from benchmark import harness, run
from benchmark.tests.conftest import tiny_config, tiny_traffic


with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tiny_limits.json")) as _f:
    TINY_LIMITS = json.load(_f)


def run_tiny(cell: str, seed: int = 2**31 + 11, seconds: float = 0.5, trace: int = 0):
    """→ (exit code, the result line as a dict or None, standard error)."""
    saved = harness.load_config, harness.load_traffic, harness.load_limits
    harness.load_config = lambda bench, name, root=harness.ROOT: tiny_config(name)
    harness.load_traffic = lambda name, here=harness.HERE: tiny_traffic(name)
    harness.load_limits = lambda name, here=harness.HERE: TINY_LIMITS[name]
    out, err = io.StringIO(), io.StringIO()
    try:
        with redirect_stdout(out), redirect_stderr(err):
            rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                           "--trace", str(trace)], device="cpu")
    finally:
        harness.load_config, harness.load_traffic, harness.load_limits = saved
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err.getvalue()


if __name__ == "__main__":
    rc, result, err = run_tiny(sys.argv[1])
    sys.stderr.write(err)
    print(json.dumps(result))
    print(json.dumps({"forbidden": run.forbidden_modules()}))
    sys.exit(rc)
