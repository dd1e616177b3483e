"""The port's training tutorial (``examples/train_lm_torch.py``) against the
reference's (``examples/train_lm.py``) on the CPU: the two configs equal
field for field, and three steps of the tiny config at the tutorial's
schedule (lr 3e-4, warmup 20, cosine over the run) through the port's
train graph against the reference ``Trainer``'s jitted step, from the same
initial weights (carried across by the bridge) on the same batches: loss,
grad norm and lr within ``tests/test_torch_train.py``'s tolerance."""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw_init as jax_adamw_init
from repro.runtime import Trainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro_torch.bridge import params_from_jax
from repro_torch.data import to_device
from repro_torch.optim import adamw_init
from repro_torch.runtime import Trainer

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-4, rtol=1e-4)
STEPS, SEQ, BATCH = 40, 64, 4  # the tutorial's CPU run (tests/test_torch_examples.py)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


port, ref = _load("train_lm_torch"), _load("train_lm")


@pytest.mark.parametrize("config", ["model_100m", "model_tiny"])
def test_configs_equal_the_references(config):
    assert dataclasses.asdict(getattr(port, config)()) == dataclasses.asdict(
        getattr(ref, config)())


def test_trainer_config_is_derived_as_the_reference_derives_it():
    tcfg = port.trainer_config(300, 256, 8, fail=True)
    assert (tcfg.num_steps, tcfg.checkpoint_every, tcfg.log_every, tcfg.seq_len,
            tcfg.global_batch, tcfg.lr, tcfg.warmup, tcfg.fail_at_step) == (
        300, 75, 15, 256, 8, 3e-4, 20, 150)
    assert port.trainer_config(40, 64, 4, fail=False).fail_at_step is None


def test_three_tiny_steps_match_the_reference_trainers(tmp_path):
    tcfg = port.trainer_config(STEPS, SEQ, BATCH, fail=False)
    jtcfg = JaxTrainerConfig(**{f.name: getattr(tcfg, f.name)
                                for f in dataclasses.fields(JaxTrainerConfig)})
    with JaxTrainer(ref.model_tiny(), jtcfg, str(tmp_path / "jax")) as jtr:
        jp = jtr.init_state()["params"]
        init = jax.tree.map(np.asarray, jp)
        jopt = jax_adamw_init(jtr.ocfg, jp)
        step_fn = jtr._build_step()
        jrows = []
        for step in range(3):
            batch = {k: jnp.asarray(v) for k, v in jtr.data.batch(step).items()}
            jp, jopt, met = step_fn(jp, jopt, batch, jnp.asarray(step))
            jrows.append({k: float(v) for k, v in met.items()})

    with Trainer(port.model_tiny(), tcfg, str(tmp_path / "port"), device="cpu") as tr:
        params = params_from_jax(tr.model_cfg, init, device="cpu")
        state = {"params": params, "opt": adamw_init(tr.ocfg, params.tree()), "step": 0}
        graph = tr.step_graph(state)  # the step Trainer.run calls
        rows = [{k: float(v) for k, v in graph(to_device(tr.data.batch(step), tr.device),
                                               step).items()} for step in range(3)]
        assert graph.stats()["eager_steps"] == 1 and graph.stats()["replays"] == 2
    np.testing.assert_allclose([r["lr"] for r in rows], [0.0, 3e-4 / 20, 6e-4 / 20],
                               rtol=1e-6)  # the warmup
    for row, jrow in zip(rows, jrows):
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(row[key], jrow[key], **TOL, err_msg=key)
