"""Write ``tests/goldens/torch_init_digests.json``: for every shipped
full-width config (each ``configs/*.yaml`` but the ``_tiny`` ones), the
SHA-256 of every tensor of the port's ``init_state(0)`` draw, by
``state_dict`` name (``weights.state_digests``):

    python -m tests.make_torch_init_digests

``tests/test_torch_init_full_width.py`` holds the file against the draw
and the draw against the JAX package's on the CPU; ``chip_smoke.py``
holds the draw that the card's host makes against the file."""

from __future__ import annotations

import glob
import json
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "torch_init_digests.json")


def shipped_configs():
    """The shipped full-width configs, by name."""
    return sorted(os.path.basename(p)[:-len(".yaml")]
                  for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml"))
                  if not p.endswith("_tiny.yaml"))


def init_digests(name: str, device="cpu"):
    """The digests of config ``name``'s ``init_state(0)`` on ``device``."""
    import lisec_tpu_torch
    from lisec_tpu_torch.weights import state_digests
    cfg = lisec_tpu_torch.load_config(
        os.path.join(ROOT, "configs", f"{name}.yaml"))
    pipe = lisec_tpu_torch.build_model(cfg, device=device)
    pipe.init_state(0)
    return state_digests(pipe.model)


def main() -> None:
    torch.set_num_threads(1)
    out = {name: init_digests(name) for name in shipped_configs()}
    with open(GOLDEN, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
