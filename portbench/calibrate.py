"""Readings that the limits of ``correct`` are set from: the compared
numbers of the program, of the control (the reference computed one
precision lower, ``reference/lowp.py``, put in the program's place) and
of each fault of ``reference/faults.py`` planted in the reference put in
the program's place, for a cell at its own size over several seeds, in
one process.

    python3 portbench/calibrate.py --workload pp_serve_b32 \
        --seeds 1,2,3 --seconds 3 [--out readings.jsonl]

Each seed sets up the cell, serves a short window at the cell's load,
and prints one JSON line: the program's numbers, the control's and each
fault's on the same requests' clouds. The benchmark's own runs never run
the control or the faults.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import guard  # noqa: E402

guard.set_environment(ROOT)


def main(argv=None) -> int:
    import torch

    from portbench.harness import device as devmod
    from portbench.harness.spec import load_cell
    from portbench.reference.faults import PLANTED
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    devmod.require_cards(1)
    cell = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        loop = cell.loop(cell, seed, "cuda")
        loop.setup()
        loop.window(args.seconds, False)
        loop.release()
        rec = {"workload": cell.name, "seed": seed,
               "requests": loop.attempted}
        t0 = time.perf_counter()
        rec["program"] = loop.check(detail=True)
        rec["reference_s"] = time.perf_counter() - t0
        for stand_in in ("control", *PLANTED):
            rec[stand_in] = loop.check(stand_in, detail=True)
        rec["card"] = torch.cuda.get_device_name(0)
        rec["power_limit_w"] = devmod.power_limit_w()
        print(json.dumps(rec), flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        del loop
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
