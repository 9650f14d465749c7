#!/usr/bin/env python3
"""Run `chip_smoke.py` with every top-level function of the script timed:
inclusive host seconds and calls, by call stack, written as JSON. Use it to
find where the script's time goes before cutting a phase.

    python3 chip_smoke_timing.py [OUT.json]   # default build/chip_smoke_timing.json

The script runs as `python3 chip_smoke.py` runs it (its output, gates and
exit code); only the timing file is added. The ranks the script spawns
(`--ddp-rank`, `--shard-rank`) run `chip_smoke.py` itself and are not
timed.
"""

import functools
import json
import os
import sys
import time
import types


def main() -> int:
    import chip_smoke

    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join(chip_smoke.OUT_DIR,
                                                             "chip_smoke_timing.json")
    stack, tree = [], {}

    def timed(name, fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            stack.append(name)
            key = "/".join(stack)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                entry = tree.setdefault(key, [0.0, 0])
                entry[0] += time.perf_counter() - t0
                entry[1] += 1
                stack.pop()
        return inner

    for name, fn in list(vars(chip_smoke).items()):
        if (isinstance(fn, types.FunctionType) and fn.__module__ == chip_smoke.__name__
                and name not in ("main", "_emit")):
            setattr(chip_smoke, name, timed(name, fn))
    try:
        return chip_smoke.main()
    finally:
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as f:
            json.dump({k: dict(seconds=v[0], calls=v[1]) for k, v in sorted(tree.items())},
                      f, indent=0)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
