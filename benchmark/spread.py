"""The spread of each metric over a set of runs, as a bound is set from it:
the distance between the first and the third quartile (Python's
statistics.quantiles, n=4) as a share of the median. Reads files that each
hold a run's standard output (the result is its last line):

    python3 benchmark/spread.py run1.out run2.out ...
"""

import json
import statistics
import sys


def spread(values) -> float:
    q = statistics.quantiles(values, n=4)
    return (q[2] - q[0]) / statistics.median(values)


def main(paths) -> int:
    per = {}
    for path in paths:
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        res = json.loads(lines[-1])
        for name, m in res["metrics"].items():
            per.setdefault(name, []).append(m["value"])
    for name, vals in sorted(per.items()):
        line = f"{name}: n {len(vals)} median {statistics.median(vals)!r}"
        if len(vals) >= 2:
            line += f" spread {spread(vals)!r} values {vals!r}"
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
