"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points never fall back from the card to the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

import lisec_tpu_torch
from lisec_tpu_torch.pipelines.base import resolve_device

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import lisec_tpu_torch
for m in pkgutil.walk_packages(lisec_tpu_torch.__path__, "lisec_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "lisec_tpu" or k.startswith("lisec_tpu."))
print(len([k for k in sys.modules if k.startswith("lisec_tpu_torch")]), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) > 15      # every module was imported


def test_chip_smoke_names_no_jax():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert not re.search(r"\bjax\b", src)
    assert not re.search(r"lisec_tpu(?!_torch)", src)


def test_convergence_script_names_no_jax():
    with open(os.path.join(ROOT, "convergence_torch.py")) as f:
        src = f.read()
    assert not re.search(r"\bjax\b", src)
    assert not re.search(r"lisec_tpu(?!_torch)", src)


def test_no_silent_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    cfg = lisec_tpu_torch.load_config(
        os.path.join(ROOT, "configs", "pointpillars_tiny.yaml"))
    with pytest.raises(RuntimeError, match="cuda"):
        lisec_tpu_torch.build_model(cfg)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    with pytest.raises(ValueError):
        lisec_tpu_torch.infer(pipe, {})            # asks for cuda


@pytest.mark.parametrize("asked,same", [
    ("cpu", True), (torch.device("cpu"), True), ("cpu:0", True),
    ("cuda", False), ("cuda:0", False)])
def test_infer_compares_device_type_and_index(asked, same):
    """``infer`` takes any spelling of the pipeline's device: it compares
    the type and the resolved index, not the ``torch.device`` objects
    (``torch.device("cuda") != torch.device("cuda:0")``)."""
    from lisec_tpu_torch.pipelines.base import same_device
    cfg = lisec_tpu_torch.load_config(
        os.path.join(ROOT, "configs", "pointpillars_tiny.yaml"))
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    assert same_device(asked, pipe.device) is same
    batch = {"points": torch.zeros((1, cfg.budget.max_points, 4)),
             "point_mask": torch.zeros((1, cfg.budget.max_points),
                                       dtype=torch.bool)}
    if same:
        out = lisec_tpu_torch.infer(pipe, batch, device=asked)
        assert out["boxes"].shape == (1, cfg.budget.nms_post, 7)
    else:
        with pytest.raises(ValueError):
            lisec_tpu_torch.infer(pipe, batch, device=asked)
