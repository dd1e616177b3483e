"""The port's checkpoint manager (``repro_torch.checkpoint``): the
reference's manager tests, ported (the composed save graph, atomic commit,
keep-k GC, restore), bfloat16 leaves without ``ml_dtypes``, and the shared
on-disk format: a directory written by either package loads bit-exactly in
the other."""
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.checkpoint import save_pytree as jax_save_pytree
from repro_torch.checkpoint import CheckpointManager, load_pytree, save_pytree
from repro_torch.core import ThreadPool

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

CPU = torch.device("cpu")


def _tree():
    return {
        "w": np.arange(12, dtype=np.float32).reshape(3, 4),
        "opt": {"m": np.ones((5,), np.float32), "step": np.asarray(7, np.int32)},
    }


def _torch_tree(seed=0):
    """Every leaf dtype the trainer saves: bf16 params, f32 state, int32
    step; a layer list, as the port's parameter tree has one."""
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {
            "embed": torch.randn((6, 4), generator=g).to(torch.bfloat16),
            "layers": {"s0": [{"w": torch.randn((4, 4), generator=g).to(torch.bfloat16)}
                              for _ in range(2)]},
        },
        "opt": {"m": torch.randn((3,), generator=g), "count": torch.tensor(3, dtype=torch.int32)},
    }


def _bits(t: torch.Tensor) -> np.ndarray:
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def test_sync_save_load_roundtrip(tmp_path):
    tree = _tree()
    save_pytree(tree, tmp_path / "ck", meta={"note": "x"})
    out = load_pytree(tmp_path / "ck", tree, device=CPU)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(out["opt"]["m"].numpy(), tree["opt"]["m"])
    assert out["opt"]["step"].dtype == torch.int32 and int(out["opt"]["step"]) == 7


def test_bf16_leaves_roundtrip_bit_exactly(tmp_path):
    """bf16 goes out as its 16-bit patterns under the dtype "bfloat16" and
    comes back through an int16 view."""
    tree = _torch_tree()
    save_pytree(tree, tmp_path / "ck")
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert manifest["leaves"]["params.embed"]["dtype"] == "bfloat16"
    assert manifest["leaves"]["params.layers.s0.1.w"]["shape"] == [4, 4]
    out = load_pytree(tmp_path / "ck", tree, device=CPU)
    for key in ("embed",):
        assert out["params"][key].dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(out["params"][key]), _bits(tree["params"][key]))
    for a, b in zip(out["params"]["layers"]["s0"], tree["params"]["layers"]["s0"]):
        np.testing.assert_array_equal(_bits(a["w"]), _bits(b["w"]))
    np.testing.assert_array_equal(out["opt"]["m"].numpy(), tree["opt"]["m"].numpy())


def test_restore_needs_a_device_without_a_gpu(tmp_path):
    save_pytree(_tree(), tmp_path / "ck")
    if torch.cuda.is_available():
        pytest.skip("the default device is the card here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_pytree(tmp_path / "ck", _tree())


def test_async_save_composed_graph_and_restore(tmp_path):
    tree = _tree()
    with CheckpointManager(tmp_path, keep=3) as mgr:
        mgr.save_async(5, tree, meta={"lr": 0.25})
        mgr.wait()
        assert mgr.steps() == [5]
        manifest = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())
        assert set(manifest["leaves"]) == {"w", "opt.m", "opt.step"}
        assert manifest["meta"] == {"lr": 0.25, "step": 5}
        restored, meta = mgr.restore(tree, device=CPU)
        np.testing.assert_array_equal(restored["w"].numpy(), tree["w"])
        assert int(restored["opt"]["step"]) == 7
        assert meta["step"] == 5


def test_sequential_saves_replay_the_template_graph(tmp_path):
    with CheckpointManager(tmp_path, keep=5) as mgr:
        mgr.save_async(1, _tree())
        mgr.wait()
        graph = mgr._tpl_graph
        mgr.save_async(2, _torch_tree())  # a different tree through the same graph
        mgr.wait()
        assert mgr._tpl_graph is graph
        assert mgr.steps() == [1, 2]
        restored, _ = mgr.restore(_torch_tree(), step=2, device=CPU)
        np.testing.assert_array_equal(_bits(restored["params"]["embed"]),
                                      _bits(_torch_tree()["params"]["embed"]))


def test_keep_k_gc(tmp_path):
    tree = {"a": np.zeros((2,), np.float32)}
    with CheckpointManager(tmp_path, keep=2) as mgr:
        for step in (1, 2, 3, 4):
            mgr.save_async(step, tree)
        mgr.wait()
        assert mgr.steps() == [3, 4]
        assert mgr.latest_step() == 4


def test_saves_record_bytes_and_seconds(tmp_path):
    tree = {"a": np.zeros((3, 4), np.float32),
            "b": torch.arange(6, dtype=torch.bfloat16)}
    with CheckpointManager(tmp_path) as mgr:
        mgr.save_async(1, tree)
        mgr.save_async(2, tree)
        mgr.wait()
        saves = sorted(mgr.saves, key=lambda r: r["step"])
    assert [r["step"] for r in saves] == [1, 2]
    for r in saves:
        assert r["bytes"] == 3 * 4 * 4 + 6 * 2
        assert 0.0 <= r["snapshot_s"] <= r["seconds"]


def test_no_tmp_residue_after_commit(tmp_path):
    with CheckpointManager(tmp_path) as mgr:
        mgr.save_async(1, {"a": np.zeros((2,), np.float32)})
        mgr.wait()
    residue = [p.name for p in tmp_path.iterdir() if ".tmp" in p.name]
    assert residue == []


def test_restore_missing_raises(tmp_path):
    with CheckpointManager(tmp_path) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore({"a": np.zeros((1,), np.float32)}, device=CPU)


def test_empty_tree_save(tmp_path):
    with CheckpointManager(tmp_path) as mgr:
        mgr.save_async(1, {})
        mgr.wait()
        assert mgr.steps() == [1]
        manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
        assert manifest["leaves"] == {}


def test_wait_scoped_to_own_saves_on_busy_shared_pool(tmp_path):
    """wait() watches this manager's save futures, not pool-wide quiescence."""
    release = threading.Event()
    with ThreadPool(2) as pool:
        pool.submit(lambda: release.wait(30))  # unrelated long-running work
        try:
            with CheckpointManager(tmp_path, pool=pool) as mgr:
                mgr.save_async(3, {"a": np.arange(4, dtype=np.float32)})
                mgr.wait(timeout=30)
                assert mgr.steps() == [3]
        finally:
            release.set()
        pool.wait_idle(10)


def test_manager_rejects_pool_plus_backend(tmp_path):
    with ThreadPool(1) as tp:
        with pytest.raises(ValueError, match="not both"):
            CheckpointManager(tmp_path, pool=tp, backend="process")


def test_process_backend_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError):
        CheckpointManager(tmp_path, backend="process")


def test_reference_checkpoint_loads_bit_exactly_in_the_port(tmp_path):
    rng = np.random.default_rng(0)
    ref_tree = {
        "params": {"w": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
                   "b": jnp.asarray(rng.standard_normal((5,)), jnp.float32)},
        "step": jnp.asarray(11, jnp.int32),
    }
    jax_save_pytree(ref_tree, tmp_path / "ck", meta={"from": "jax"})
    like = {"params": {"w": torch.zeros((3, 5)), "b": torch.zeros((5,))},
            "step": torch.zeros(())}
    out = load_pytree(tmp_path / "ck", like, device=CPU)
    assert out["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(out["params"]["w"]),
                                  np.asarray(ref_tree["params"]["w"]).view(np.int16))
    np.testing.assert_array_equal(out["params"]["b"].numpy(), np.asarray(ref_tree["params"]["b"]))
    assert out["step"].dtype == torch.int32 and int(out["step"]) == 11


def test_port_checkpoint_loads_bit_exactly_in_the_reference(tmp_path):
    tree = _torch_tree(seed=1)
    save_pytree(tree, tmp_path / "ck")
    like = {
        "params": {"embed": jnp.zeros((6, 4)),
                   "layers": {"s0": [{"w": jnp.zeros((4, 4))}, {"w": jnp.zeros((4, 4))}]}},
        "opt": {"m": jnp.zeros((3,)), "count": jnp.zeros((), jnp.int32)},
    }
    out = jax_load_pytree(tmp_path / "ck", like)
    assert str(out["params"]["embed"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(out["params"]["embed"]).view(np.int16),
                                  _bits(tree["params"]["embed"]))
    for a, b in zip(out["params"]["layers"]["s0"], tree["params"]["layers"]["s0"]):
        np.testing.assert_array_equal(np.asarray(a["w"]).view(np.int16), _bits(b["w"]))
    np.testing.assert_array_equal(np.asarray(out["opt"]["m"]), tree["opt"]["m"].numpy())
    assert int(out["opt"]["count"]) == 3
