"""Each model family's weight-name map (``weights._RULES``) on the CPU.

For one model of each ``FLAX_KEYS`` family, and each model of the
family without one (PointPillarsFused, SECONDNet, PointNet2PartSeg):
every ``state_dict`` name has its own flax key, ``convert_flax_arrays``
gives back every tensor of ``to_flax_arrays`` bit for bit (also without
``keys`` where the model names none or is range segmentation, which the
keys tell apart), and for a model the JAX package has, the keys and
shapes are those of its ``init`` tree for the same config. The trained
snapshot ``weights/pointpillars_fixture_hard.npz`` loads strict into
the full-width PointPillars, with the digests it has always loaded to,
and goes back to the file bit for bit.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.weights import (
    convert_flax_arrays, load_weights_npz, state_digests, to_flax_arrays)
from tests.test_torch_init import MODELS, ROOT, jax_leaves

torch.set_num_threads(1)

# The models of ``tests/test_torch_init.py`` (the JAX package has them)
# and CenterPoint (the port only): (config, overrides).
CASES = {**MODELS, "centerpoint": ("centerpoint_tiny", [])}
SNAPSHOT = os.path.join(ROOT, "weights", "pointpillars_fixture_hard.npz")
# SHA-256 of the snapshot's ``state_digests`` (JSON, keys sorted) once
# loaded into ``configs/pointpillars_kitti.yaml``'s model.
SNAPSHOT_DIGESTS = \
    "68c9a92bbd18c11176b1bb3fe79199a9f828c67d7538df13973be9d4b5e7adbe"


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous().view(torch.int32)


@pytest.mark.parametrize("model", sorted(CASES))
def test_each_familys_map_is_a_bijection(model):
    name, overrides = CASES[model]
    path = os.path.join(ROOT, "configs", f"{name}.yaml")
    port = lisec_tpu_torch.build_model(
        apply_overrides(lisec_tpu_torch.load_config(path), overrides),
        device="cpu")
    port.init_state(0)
    net = port.model
    keys = getattr(net, "FLAX_KEYS", None)
    state = net.state_dict()
    names = {n: next(iter(to_flax_arrays(net, {n: t})))
             for n, t in state.items()}
    assert len(set(names.values())) == len(names)
    flat = to_flax_arrays(net)
    assert set(flat) == set(names.values())
    backs = [convert_flax_arrays(flat, keys)]
    if keys in (None, "rangeseg"):
        backs.append(convert_flax_arrays(flat))
    for back in backs:
        assert back.keys() == state.keys()
        for n, t in state.items():
            assert back[n].dtype == torch.float32, n
            assert torch.equal(_bits(back[n]), _bits(t)), n
    if model in MODELS:
        jax_pipe = lisec_tpu.build_model(
            jax_apply_overrides(jax_load_config(path), overrides))
        want = jax_leaves(jax_pipe.init_state(0))
        assert set(flat) == set(want)
        for k, w in want.items():
            assert flat[k].shape == w.shape, k


def test_the_trained_snapshot_loads_to_its_digests():
    pipe = lisec_tpu_torch.build_model(lisec_tpu_torch.load_config(
        os.path.join(ROOT, "configs", "pointpillars_kitti.yaml")),
        device="cpu")
    load_weights_npz(pipe.model, SNAPSHOT)
    digests = json.dumps(state_digests(pipe.model), sort_keys=True)
    assert hashlib.sha256(digests.encode()).hexdigest() == SNAPSHOT_DIGESTS
    back = to_flax_arrays(pipe.model)
    with np.load(SNAPSHOT) as data:
        assert set(back) == set(data.files)
        for k in data.files:
            np.testing.assert_array_equal(
                back[k].view(np.int32),
                np.asarray(data[k], np.float32).view(np.int32), err_msg=k)
