"""The port's ``init_state(0)`` of every shipped full-width config
(``configs/*.yaml`` but the ``_tiny`` ones): its digests equal
``tests/goldens/torch_init_digests.json`` (written by
``python -m tests.make_torch_init_digests``, and held by
``chip_smoke.py`` against the draw the card's host makes), and the draw
equals the JAX package's ``init_state(0)`` of the same config, every
value. The JAX side runs on a one-cloud input over a 6.4 m square: the
parameters' shapes and draws do not depend on the input's."""

import json
import os

import pytest
import torch

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu_torch.weights import state_digests, to_flax_arrays
from tests.make_torch_init_digests import GOLDEN, ROOT, shipped_configs
from tests.test_torch_init import assert_same_draw, jax_leaves

torch.set_num_threads(1)

SMALL = ["train.batch_size=1", "budget.max_points=256",
         "voxel.point_cloud_range=[0.0,-3.2,-3.0,6.4,3.2,1.0]"]
CONFIGS = shipped_configs()


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def test_the_golden_holds_every_shipped_config(golden):
    assert sorted(golden) == CONFIGS and len(CONFIGS) == 16


@pytest.mark.parametrize("name", CONFIGS)
def test_full_width_draw_equals_the_golden_and_jax(name, golden):
    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    port = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(path),
                                       device="cpu")
    port.init_state(0)
    assert state_digests(port.model) == golden[name]
    jax_pipe = lisec_tpu.build_model(
        jax_apply_overrides(jax_load_config(path), SMALL))
    assert_same_draw(to_flax_arrays(port.model),
                     jax_leaves(jax_pipe.init_state(0)))
