"""The port's checkpoint and resume, metrics file, TensorBoard mirror,
NaN check and command line against the JAX package's.

Training runs on the CPU (``device="cpu"``) at the tiny classifier
config, as ``tests/test_checkpoint.py`` does for the JAX package. The
gate of a resume is bit equality: ten steps equal five, a resume, and
five more, in every parameter, running statistic and optimizer moment.
The dropout masks need no state: they are keyed by ``train.seed`` and
the step, so a resumed run draws the unbroken run's masks.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import lisec_tpu
import lisec_tpu_torch
from lisec_tpu.config import apply_overrides as jax_apply_overrides
from lisec_tpu.config import load_config as jax_load_config
from lisec_tpu.training.checkpoint import (
    CheckpointManager as JaxCheckpointManager)
from lisec_tpu.utils.tb_writer import (
    read_scalar_events as jax_read_scalar_events)
from lisec_tpu_torch import cli
from lisec_tpu_torch.config import apply_overrides
from lisec_tpu_torch.pipelines.classification import PointNetClsPipeline
from lisec_tpu_torch.training.checkpoint import CheckpointManager
from lisec_tpu_torch.training.loop import MetricsLogger, run_evaluation
from lisec_tpu_torch.utils.tb_writer import (
    TensorBoardWriter, read_scalar_events)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(ROOT, "configs", "pointnet_modelnet40_tiny.yaml")
PARTSEG_TINY = os.path.join(ROOT, "configs", "pointnet2_partseg_tiny.yaml")


def _cfg(overrides, path=TINY):
    return apply_overrides(lisec_tpu_torch.load_config(path),
                           ["train.log_every=100", *overrides])


def _train(overrides, path=TINY):
    return lisec_tpu_torch.train(_cfg(overrides, path), device="cpu",
                                 progress=False)


def _assert_same_state(a, b):
    """Two ``Pipeline.state_dict()``s bit for bit."""
    assert a.keys() == b.keys()
    assert a["model"].keys() == b["model"].keys()
    for k, v in a["model"].items():
        assert torch.equal(v, b["model"][k]), k
    oa, ob = a["optimizer"], b["optimizer"]
    assert oa["count"] == ob["count"]
    assert oa["optimizer"]["param_groups"] == ob["optimizer"]["param_groups"]
    sa, sb = oa["optimizer"]["state"], ob["optimizer"]["state"]
    assert sa.keys() == sb.keys() and len(sa) > 0
    for i in sa:
        assert sa[i].keys() == sb[i].keys()
        for k in sa[i]:
            assert torch.equal(sa[i][k], sb[i][k]), (i, k)


# -- resume ------------------------------------------------------------------

@pytest.mark.parametrize("augment", ["false", "true"])
def test_exact_resume_is_bit_equal(tmp_path, augment):
    common = ["train.ckpt_every=5", f"data.augment.enabled={augment}"]
    full, _ = _train(["train.num_steps=10",
                      f"train.ckpt_dir={tmp_path / 'full'}", *common])
    half_dir = f"train.ckpt_dir={tmp_path / 'half'}"
    half, _ = _train(["train.num_steps=5", half_dir, *common])
    assert half.step == 5
    resumed, history = _train(["train.num_steps=10", half_dir,
                               "train.resume=auto", *common])
    assert resumed.step == 10
    assert [h["step"] for h in history] == [6]      # logged at the start
    state = resumed.state_dict()
    assert set(state) == {"model", "optimizer"}
    _assert_same_state(full.state_dict(), state)
    # And the next step's dropout key is the unbroken run's.
    np.testing.assert_array_equal(full.step_key(), resumed.step_key())


def test_resume_without_a_checkpoint_starts_from_the_seed(tmp_path):
    fresh, _ = _train(["train.num_steps=3", "train.ckpt_every=5",
                       f"train.ckpt_dir={tmp_path / 'a'}"])
    resumed, _ = _train(["train.num_steps=3", "train.ckpt_every=5",
                         "train.resume=auto",
                         f"train.ckpt_dir={tmp_path / 'b'}"])
    _assert_same_state(fresh.state_dict(), resumed.state_dict())


def test_state_round_trip_restores_every_part(tmp_path):
    """Part segmentation's moments and running statistics come back into
    a new pipeline as they were saved."""
    cfg = _cfg([], PARTSEG_TINY)
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    pipe.init_state(3)
    with torch.no_grad():
        for p in pipe.model.parameters():
            p.grad = torch.ones_like(p)
    pipe.optimizer.step()
    for m in pipe.model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.running_mean.add_(0.5)
            m.num_batches_tracked.add_(7)
    mgr = CheckpointManager(str(tmp_path), keep=2, every=1)
    assert mgr.save(1, pipe)
    other = lisec_tpu_torch.build_model(cfg, device="cpu")
    other.init_state(0)
    assert mgr.restore(other) == 1 and other.step == 1
    _assert_same_state(pipe.state_dict(), other.state_dict())


def test_a_checkpoint_with_a_dropout_generator_still_loads(tmp_path):
    """A file written before the masks were keyed by the step holds the
    dropout generator's state too: it restores, the state ignored."""
    cfg = _cfg([], PARTSEG_TINY)
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    pipe.init_state(3)
    with torch.no_grad():
        for p in pipe.model.parameters():
            p.grad = torch.ones_like(p)
    pipe.optimizer.step()
    old = {**pipe.state_dict(),
           "dropout_generator": torch.Generator().manual_seed(5).get_state()}
    torch.save(old, os.path.join(str(tmp_path), "4.pt"))
    other = lisec_tpu_torch.build_model(cfg, device="cpu")
    other.init_state(0)
    assert CheckpointManager(str(tmp_path)).restore(other) == 4
    _assert_same_state(pipe.state_dict(), other.state_dict())


def test_a_save_cut_short_is_never_the_latest(tmp_path):
    pipe = lisec_tpu_torch.build_model(_cfg([]), device="cpu")
    pipe.init_state(0)
    mgr = CheckpointManager(str(tmp_path), keep=3, every=5)
    mgr.save(5, pipe)
    with open(os.path.join(str(tmp_path), ".10.pt.tmp"), "wb") as f:
        f.write(b"half a file")
    assert mgr.latest_step() == 5 and mgr.all_steps() == [5]
    assert mgr.restore(pipe) == 5
    # The next save clears what the killed one left.
    assert mgr.save(15, pipe)
    assert sorted(os.listdir(str(tmp_path))) == ["15.pt", "5.pt"]


# -- the steps kept and logged, against the JAX package's -------------------

def test_save_policy_equals_orbax(tmp_path):
    """``should_save`` and the steps kept, step by step, against the JAX
    package's orbax manager driven the same way."""
    want_mgr = JaxCheckpointManager(str(tmp_path / "jax"), keep=2, every=5)
    got_mgr = CheckpointManager(str(tmp_path / "port"), keep=2, every=5)
    pipe = lisec_tpu_torch.build_model(_cfg([]), device="cpu")
    pipe.init_state(0)
    leaf = {"w": np.zeros(2, np.float32)}
    want_saved, got_saved = [], []
    for step in list(range(1, 13)) + [12, 15, 3]:
        if want_mgr.should_save(step):
            want_mgr.save(step, leaf)
            want_mgr.wait()
            want_saved.append(step)
        if got_mgr.should_save(step):
            got_mgr.save(step, pipe)
            got_saved.append(step)
    want_mgr.save(17, leaf, force=True)
    want_mgr.wait()
    got_mgr.save(17, pipe, force=True)
    assert got_saved == want_saved == [1, 5, 10, 15]
    assert got_mgr.all_steps() == list(want_mgr.manager.all_steps()) \
        == [15, 17]
    assert got_mgr.latest_step() == want_mgr.latest_step() == 17
    want_mgr.close()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages: 7 steps, then a resume to 12, ``ckpt_every=5``,
    ``ckpt_keep=2``, ``log_every=4``, each in its own directory."""
    out = {}
    for name in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(name))
        overrides = ["train.ckpt_every=5", "train.ckpt_keep=2",
                     "train.log_every=4", f"train.ckpt_dir={d}"]
        for extra in (["train.num_steps=7"],
                      ["train.num_steps=12", "train.resume=auto"]):
            if name == "jax":
                lisec_tpu.train(jax_apply_overrides(
                    jax_load_config(TINY), overrides + extra),
                    progress=False)
            else:
                lisec_tpu_torch.train(apply_overrides(
                    lisec_tpu_torch.load_config(TINY), overrides + extra),
                    device="cpu", progress=False)
        with open(os.path.join(d, "metrics.jsonl")) as f:
            records = [json.loads(line) for line in f]
        out[name] = (d, records)
    return out


def test_kept_checkpoints_equal_the_jax_loops(runs):
    jax_dir, port_dir = runs["jax"][0], runs["port"][0]
    want = JaxCheckpointManager(jax_dir).manager.all_steps()
    assert CheckpointManager(port_dir).all_steps() == list(want) == [10, 12]


def test_metrics_steps_equal_the_jax_loops(runs):
    want, got = runs["jax"][1], runs["port"][1]
    assert [r["step"] for r in got] == [r["step"] for r in want] \
        == [1, 4, 8, 12]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["lr"] == pytest.approx(w["lr"])


# -- evaluation, the command line ------------------------------------------

def test_run_evaluation_restores_the_latest_checkpoint(tmp_path):
    ckpt = [f"train.ckpt_dir={tmp_path}", "train.ckpt_every=2"]
    trained, _ = _train(["train.num_steps=5", *ckpt])
    assert CheckpointManager(str(tmp_path)).latest_step() == 5
    cfg = _cfg(["train.num_steps=5", *ckpt])
    assert run_evaluation(cfg, device="cpu") == trained.evaluate()
    assert lisec_tpu_torch.evaluate(cfg, device="cpu") == trained.evaluate()


def test_cli_train_eval_infer_round_trip(tmp_path, capsys):
    overrides = [f"train.ckpt_dir={tmp_path / 'run'}", "train.num_steps=4",
                 "train.ckpt_every=2", "train.log_every=2"]
    cli.main(["train", TINY, *overrides], device="cpu")
    assert "[train 4/4]" in capsys.readouterr().out
    # orbax's policy: the first step, each second one, the last.
    assert CheckpointManager(str(tmp_path / "run")).all_steps() == [1, 2, 4]

    cli.main(["eval", TINY, *overrides], device="cpu")
    metrics = json.loads(capsys.readouterr().out)
    cfg = _cfg(overrides)
    pipe = lisec_tpu_torch.build_model(cfg, device="cpu")
    pipe.init_state(cfg.train.seed)
    CheckpointManager(str(tmp_path / "run")).restore(pipe)
    assert metrics == pipe.evaluate()

    cloud = np.random.default_rng(0).normal(size=(200, 3)).astype(np.float32)
    path = str(tmp_path / "cloud.npy")
    np.save(path, cloud)
    out = cli.main(["infer", TINY, "--cloud", path, "--ckpt",
                    str(tmp_path / "run")], device="cpu")
    printed = json.loads(capsys.readouterr().out)
    batch = {k: v[None] for k, v in
             lisec_tpu_torch.preprocess(cloud, cfg).items()}
    want = lisec_tpu_torch.infer(pipe, batch, device="cpu")
    assert out.keys() == want.keys()
    for k in want:
        assert torch.equal(out[k], want[k]), k
    assert printed == {k: v[0].tolist() for k, v in want.items()
                       if k != "logits"}
    # No bench verb: the port is measured by portbench/run.py.
    with pytest.raises(SystemExit):
        cli.main(["bench", TINY], device="cpu")
    assert capsys.readouterr().out == ""


def test_cli_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card; the test is for one without")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["train", TINY, "train.num_steps=1"])


# -- NaN checks -------------------------------------------------------------

def test_debug_nans_raises_at_the_first_non_finite_loss(tmp_path,
                                                        monkeypatch):
    loss = PointNetClsPipeline.loss
    calls = []

    def poisoned(self, batch, rng=None):
        total, aux = loss(self, batch, rng)
        calls.append(1)
        return (total * float("nan") if len(calls) == 3 else total), aux
    monkeypatch.setattr(PointNetClsPipeline, "loss", poisoned)
    with pytest.raises(FloatingPointError, match="step 3"):
        _train(["train.num_steps=5", "train.debug_nans=true",
                f"train.ckpt_dir={tmp_path}"])
    # Without the check the run goes on to its end.
    calls.clear()
    pipe, _ = _train(["train.num_steps=5", f"train.ckpt_dir={tmp_path}/b"])
    assert pipe.step == 5


def test_debug_nans_passes_a_finite_run():
    pipe, history = _train(["train.num_steps=3", "train.debug_nans=true",
                            'train.ckpt_dir=""', "train.log_every=1"])
    assert pipe.step == 3 and len(history) == 3


# -- TensorBoard --------------------------------------------------------------

def test_scalar_roundtrip(tmp_path):
    w = TensorBoardWriter(str(tmp_path))
    w.write_scalars(1, {"loss": 0.5, "acc": 0.25})
    w.write_scalars(2, {"loss": 0.25, "skipme": "not-a-float"})
    w.close()
    files = glob.glob(os.path.join(str(tmp_path), "events.out.tfevents.*"))
    assert len(files) == 1
    events = read_scalar_events(files[0])
    merged = {}
    for e in events:
        merged.setdefault(e["step"], {}).update(e["scalars"])
    assert merged[1] == {"loss": 0.5, "acc": 0.25}
    assert merged[2] == {"loss": 0.25}


def test_metrics_logger_tb(tmp_path):
    lg = MetricsLogger(str(tmp_path / "metrics.jsonl"), tensorboard=True)
    lg.log({"step": 10, "loss": 1.5})
    lg.close()
    files = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    assert len(files) == 1
    events = read_scalar_events(files[0])
    assert any(e["step"] == 10 and e["scalars"].get("loss") == 1.5
               for e in events)


def test_jax_reader_reads_the_ports_event_file(tmp_path):
    """The training loop's mirror, read back by the JAX package's
    decoder (which checks every record's CRCs)."""
    _, history = _train(["train.num_steps=4", "train.log_every=2",
                         "train.tensorboard=true",
                         f"train.ckpt_dir={tmp_path}"])
    files = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    assert len(files) == 1
    events = jax_read_scalar_events(files[0])
    assert events == read_scalar_events(files[0])
    by_step = {}
    for e in events:
        by_step.setdefault(e["step"], {}).update(e["scalars"])
    assert sorted(by_step) == [0, 1, 2, 4]          # 0: the version event
    for rec in history:
        want = {k: float(np.float32(v)) for k, v in rec.items()
                if k != "step"}
        assert by_step[rec["step"]] == want
