"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Loads the cell named in ``BENCHMARK.json`` (its configuration, traffic
mix and per-layer metrics, each found by name under ``portbench/``),
sets up the program (``lisec_tpu_torch``) on the card, warms up, measures
for ``--seconds``, checks a sample of what the window produced against
the plain reference, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (and
``breakdown`` with ``--trace 1``), then ``checks``, each number compared
beside its limit. With ``--trace 0`` the metrics are the cell's
end-to-end ones, with ``--trace 1`` its per-layer ones. Without the cards
the cell asks for it exits 3 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import guard  # noqa: E402

guard.set_environment(ROOT)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    from portbench.harness import device as devmod
    from portbench.harness.runner import run_cell
    args = parse(argv)
    try:
        devmod.require_cards(1)
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), device="cuda", t_start=T_START)
    except devmod.NoCard as e:
        print(f"portbench: no result: {e}", file=sys.stderr)
        return 3
    if result is None:
        return 4
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
