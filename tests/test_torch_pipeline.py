"""The port's pipeline (``repro_torch.parallel.pipeline``) on a CPU process
group (gloo), against the JAX package's serial ``jax.value_and_grad``.

One group of four worker processes (a ``FileStore`` under the test's
temporary dir, one intra-op thread each, a 60 s process-group timeout and a
240 s outer one, so a deadlocked exchange fails the group instead of hanging
it) runs every case and writes its results; the tests compare them with the
reference's serial loss and gradients over the same microbatches:

* the reference test's residual MLP (``tests/parallel/test_distributed.py``:
  S=4 stages, M=8 microbatches of 4, width 16; params from
  ``np.random.default_rng``) on a ``("pod",)`` mesh of four, with remat on
  and off;
* the same MLP at S=2 with M=3 (a count that does not fill the ring
  evenly) on the pod axis of a ``("data", "pod")`` mesh of (2, 2): two
  pipelines side by side, each held to the reference;
* the S=4 MLP with stage 0's parameters and the inputs frozen: stage 0
  needs no gradient at all and must still take part in the backward's
  exchange, or its partners wait for it until the group's timeout;
* reduced tinyllama (f32, 4 layers, two on each of S=2 stages, weights from
  ``bridge.params_from_jax``): the embedding before stage 0, the stages'
  decoder layers, ``Model.head_loss`` as ``loss_fn``, against the JAX
  package's ``Model.loss`` over the whole batch, with remat on and off.

Tolerances are the reference test's (``tests/parallel/test_distributed.py``):
the loss within rtol 1e-5, every gradient within atol 1e-4, rtol 1e-3. The
worker imports no JAX, so ``tests/test_torch_gpu.py`` runs it over NCCL on
four cards against :func:`port_reference`, the port's own serial loss and
gradients on the CPU.
"""
import datetime
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each keeps them from crowding out one another
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
GROUP_TIMEOUT_S = 240
W, MLP_B = 16, 4  # the MLP's width and microbatch size
TINY_LAYERS, TINY_B, TINY_S, TINY_M = 4, 4, 16, 2  # batch of 4 as 2 microbatches of 2
# name -> (model, stages, microbatches, remat)
CASES = {
    "mlp_s4_m8_remat": ("mlp", 4, 8, True),
    "mlp_s4_m8": ("mlp", 4, 8, False),
    "mlp_s4_m8_frozen0": ("mlp", 4, 8, True),
    "mlp_s2_m3_remat": ("mlp", 2, 3, True),
    "mlp_s2_m3": ("mlp", 2, 3, False),
    "tiny_s2_remat": ("tiny", 2, TINY_M, True),
    "tiny_s2": ("tiny", 2, TINY_M, False),
}
# name -> the leading stages whose parameters are frozen (the inputs too)
FROZEN = {"mlp_s4_m8_frozen0": 1}


def mlp_inputs(S: int, M: int) -> dict:
    rng = np.random.default_rng(S * 100 + M)
    f32 = np.float32
    return {"w": (rng.standard_normal((S, W, W)) * 0.3).astype(f32),
            "b": np.zeros((S, W), f32),
            "x": rng.standard_normal((M, MLP_B, W)).astype(f32),
            "y": rng.standard_normal((M, MLP_B, W)).astype(f32)}


def _stage_fn(p, x):  # the reference test's residual MLP stage
    return x + torch.tanh(x @ p["w"] + p["b"])


def _loss_fn(x, y):
    return torch.mean((x - y) ** 2)


# -- the worker: one rank of the group (torch and the port only) --------------------


def _tiny_pipeline(cfg, model, tree, tokens, targets, mesh, M, remat):
    """Reduced tinyllama pipelined over the mesh's pod axis: returns the loss."""
    from repro_torch.models.blocks import block_apply
    from repro_torch.parallel.pipeline import build_pipelined_loss

    S = mesh.size(mesh.mesh_dim_names.index("pod"))
    stage = mesh.get_local_rank("pod")
    per = cfg.num_layers // S
    layers = tree["layers"]["s0"][stage * per:(stage + 1) * per]

    def stage_fn(lps, x):
        positions = torch.arange(x.shape[1], device=x.device)
        for lp in lps:
            x = block_apply(cfg, lp, x, positions)[0]
        return x

    def loss_fn(x, y):
        return model.head_loss(tree, x, y)[0]

    loss, _ = build_pipelined_loss(stage_fn, loss_fn, mesh, num_microbatches=M, remat=remat)
    B, T = tokens.shape
    x = model._embed_tokens(tree, model._as_index(tokens))
    x_mb = x.reshape(M, B // M, T, -1)
    y_mb = model._as_index(targets).reshape(M, B // M, T)
    return loss(layers, x_mb, y_mb)


def _worker(rank: int, store: str, inputs: str, out: str, device_type: str = "cpu") -> None:
    """One rank: gloo on the CPU, or NCCL on ``cuda:<rank>`` (the on-card
    case, tests/test_torch_gpu.py). Rank 0 writes every case's loss and its
    gradients, gathered."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.parallel.pipeline import build_pipelined_loss
    from repro_torch.tree import tree_flatten_with_keys

    dev = torch.device("cpu") if device_type == "cpu" else torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl", rank=rank,
                            world_size=WORLD, store=dist.FileStore(store, WORLD),
                            timeout=datetime.timedelta(seconds=60))
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    meshes = {4: init_device_mesh(device_type, (4,), mesh_dim_names=("pod",)),
              2: init_device_mesh(device_type, (2, 2), mesh_dim_names=("data", "pod"))}

    def host(t):
        return None if t is None else t.detach().cpu().numpy().copy()

    res: dict = {}
    for name, (kind, S, M, remat) in CASES.items():
        mesh = meshes[S]
        stage = mesh.get_local_rank("pod")
        if kind == "mlp":
            a = inp[name]
            frozen = FROZEN.get(name, 0)
            p = {k: torch.tensor(a[k][stage], device=dev).requires_grad_(stage >= frozen)
                 for k in ("w", "b")}
            x = torch.tensor(a["x"], device=dev).requires_grad_(not frozen)
            loss, table = build_pipelined_loss(_stage_fn, _loss_fn, mesh, num_microbatches=M,
                                               remat=remat)
            value = loss(p, x, torch.tensor(a["y"], device=dev))
            value.backward()
            mine = {"stage": stage, "loss": float(value.detach()), "table": table,
                    "grads": {k: host(t.grad) for k, t in p.items()}, "x": host(x.grad)}
        else:
            cfg = get_reduced("tinyllama-1.1b").replace(
                dtype="float32", num_layers=TINY_LAYERS, **inp.get("overrides", {}))
            model = build_model(cfg, device=dev)
            tree = params_from_jax(cfg, inp["tiny"], device=dev).tree()
            value = _tiny_pipeline(cfg, model, tree, inp["tokens"], inp["targets"], mesh, M,
                                   remat)
            value.backward()
            mine = {"stage": stage, "loss": float(value.detach()),
                    "grads": {k: host(t.grad) for k, t in tree_flatten_with_keys(tree)}}
        everyone = [None] * WORLD
        dist.all_gather_object(everyone, mine)
        res[name] = everyone
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn(tmp, inputs: dict, device_type: str = "cpu") -> dict:
    """Runs the four ranks and returns rank 0's results."""
    store, out, path = str(tmp / "store"), str(tmp / "results.pkl"), tmp / "inputs.pkl"
    path.write_bytes(pickle.dumps(inputs))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import test_torch_pipeline as t; "
            "t._worker(int(sys.argv[2]), *sys.argv[3:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, os.path.dirname(os.path.abspath(__file__)), str(rank),
         store, str(path), out, device_type],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for rank in range(WORLD)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=GROUP_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for proc in procs:
            proc.kill()
    failed = [(i, p.returncode) for i, p in enumerate(procs) if p.returncode]
    assert not failed, f"ranks failed {failed}:\n" + "\n".join(log[-3000:] for log in logs)
    with open(out, "rb") as f:
        return pickle.load(f)


def assemble(name: str, ranks: list) -> list:
    """Each pipeline's loss and gradients in the serial layout, one entry
    per pipeline of the case (two on the (2, 2) mesh): every rank's loss,
    the MLP's stacked stage grads and x's gradient summed over its stages,
    or tinyllama's per-leaf gradients summed over its stages (each layer's
    on its own stage, the embedding's on stage 0, the head's on the last)."""
    kind, S, _M, _remat = CASES[name]
    pipes = [ranks[i * S:(i + 1) * S] for i in range(WORLD // S)]
    out = []
    for pipe in pipes:
        by_stage = sorted(pipe, key=lambda r: r["stage"])
        got = {"losses": [r["loss"] for r in by_stage], "frozen": FROZEN.get(name, 0)}
        if kind == "mlp":
            got["grads"] = {k: [r["grads"][k] for r in by_stage] for k in ("w", "b")}
            xs = [r["x"] for r in by_stage if r["x"] is not None]
            got["x"] = sum(xs) if xs else None
            got["table"] = by_stage[0]["table"]
        else:
            grads = {}
            for r in by_stage:
                for k, g in r["grads"].items():
                    if g is not None:
                        grads[k] = g if k not in grads else grads[k] + g
            got["grads"] = grads
        out.append(got)
    return out


def port_reference(inputs: dict) -> dict:
    """The port's serial loss and gradients on the CPU (no JAX): each MLP
    case's mean of ``loss_fn`` over its microbatches through every stage,
    and tinyllama's ``Model.loss`` over the whole batch, per leaf."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.tree import tree_flatten_with_keys, tree_leaves

    want = {}
    for name, (kind, S, M, _remat) in CASES.items():
        if kind == "mlp":
            a = {k: torch.tensor(v).requires_grad_() for k, v in inputs[name].items()}

            def through(x, a=a, S=S):
                for s in range(S):
                    x = _stage_fn({"w": a["w"][s], "b": a["b"][s]}, x)
                return x

            value = torch.stack([_loss_fn(through(a["x"][m]), a["y"][m]) for m in range(M)]).mean()
            value.backward()
            want[name] = {"loss": float(value.detach()),
                          "grads": {k: a[k].grad.numpy() for k in ("w", "b")},
                          "x": a["x"].grad.numpy()}
        else:
            cfg = get_reduced("tinyllama-1.1b").replace(
                dtype="float32", num_layers=TINY_LAYERS, **inputs.get("overrides", {}))
            model = build_model(cfg, device="cpu")
            tree = params_from_jax(cfg, inputs["tiny"], device="cpu").tree()
            value, _ = model.loss(tree, {"tokens": inputs["tokens"],
                                         "targets": inputs["targets"]})
            grads = torch.autograd.grad(value, tree_leaves(tree))
            want[name] = {"loss": float(value.detach()),
                          "grads": {k: g.numpy() for (k, _), g in
                                    zip(tree_flatten_with_keys(tree), grads)}}
    return want


def stacked(grads: dict) -> dict:
    """Port per-layer gradients ("layers.s0.3.attn.wq") stacked into the
    reference's layout ("layers.s0.attn.wq", layers first)."""
    out: dict = {}
    for key, g in grads.items():
        ref_key, layer = tiny_layer_key(key)
        if layer is None:
            out[ref_key] = g
        else:
            out.setdefault(ref_key, {})[layer] = g
    return {k: np.stack([v[i] for i in sorted(v)]) if isinstance(v, dict) else v
            for k, v in out.items()}


def tiny_layer_key(key: str):
    """A port leaf "layers.s0.3.attn.wq" as (reference leaf, layer index)."""
    parts = key.split(".")
    if parts[0] == "layers":
        return ".".join(parts[:2] + parts[3:]), int(parts[2])
    return key, None


# -- the reference's side (JAX, in this process) ------------------------------------


@pytest.fixture(scope="module")
def reference():
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model

    inputs: dict = {}
    want: dict = {}
    for name, (kind, S, M, _remat) in CASES.items():
        if kind != "mlp":
            continue
        a = mlp_inputs(S, M)
        inputs[name] = a

        def stage_fn(p, x):
            return x + jnp.tanh(x @ p["w"] + p["b"])

        def serial_loss(params, x_mb, y_mb, S=S, stage_fn=stage_fn):
            def apply_all(x):
                for s in range(S):
                    x = stage_fn(jax.tree.map(lambda leaf: leaf[s], params), x)
                return x
            return jnp.mean(jax.vmap(lambda x, y: jnp.mean((apply_all(x) - y) ** 2))(x_mb, y_mb))

        value, (g, gx) = jax.value_and_grad(serial_loss, argnums=(0, 1))(
            {"w": a["w"], "b": a["b"]}, a["x"], a["y"])
        want[name] = {"loss": float(value), "grads": {k: np.asarray(v) for k, v in g.items()},
                      "x": np.asarray(gx)}
    cfg = jax_get_reduced("tinyllama-1.1b").replace(dtype="float32", num_layers=TINY_LAYERS)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (TINY_B, TINY_S + 1))
    inputs["tokens"], inputs["targets"] = toks[:, :-1], toks[:, 1:]
    inputs["tiny"] = jax.tree.map(np.asarray, jp)
    batch = {"tokens": jnp.asarray(inputs["tokens"], jnp.int32),
             "targets": jnp.asarray(inputs["targets"], jnp.int32)}
    (value, _), g = jax.value_and_grad(lambda p: jm.loss(p, batch), has_aux=True)(jp)
    flat = {".".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(g)[0]}
    for name, (kind, *_rest) in CASES.items():
        if kind == "tiny":
            want[name] = {"loss": float(value), "grads": flat}
    return inputs, want


_GROUP: dict = {}  # the group's results (one group per pytest run)


@pytest.fixture(scope="module")
def group(reference, tmp_path_factory):
    if "res" not in _GROUP:
        _GROUP["res"] = spawn(tmp_path_factory.mktemp("pipeline"), reference[0])
    return _GROUP["res"]


def check_case(name: str, pipes: list, want: dict) -> None:
    kind = CASES[name][0]
    for got in pipes:
        for loss in got["losses"]:  # every rank returns the loss
            np.testing.assert_allclose(loss, want["loss"], rtol=1e-5, err_msg=name)
        if kind == "mlp":
            f = got.get("frozen", 0)  # the frozen stages have no gradients, nor has x
            for k in ("w", "b"):
                assert all(g is None for g in got["grads"][k][:f]), name
                np.testing.assert_allclose(np.stack(got["grads"][k][f:]), want["grads"][k][f:],
                                           atol=1e-4, rtol=1e-3, err_msg=f"{name} {k}")
            if f:
                assert got["x"] is None, name
            else:
                np.testing.assert_allclose(got["x"], want["x"], atol=1e-4, rtol=1e-3,
                                           err_msg=f"{name} x")
            continue
        grads = stacked(got["grads"])
        assert sorted(grads) == sorted(want["grads"]), name
        for key, g in grads.items():
            np.testing.assert_allclose(g, want["grads"][key], atol=1e-4, rtol=1e-3,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][0] == "mlp"])
def test_mlp_pipeline_matches_serial_value_and_grad(name, group, reference):
    from repro_torch.parallel.pipeline import forward_tick_table

    _kind, S, M, _remat = CASES[name]
    pipes = assemble(name, group[name])
    assert len(pipes) == WORLD // S
    check_case(name, pipes, reference[1][name])
    for got in pipes:  # the table the ranks ran came from the paper's scheduler
        np.testing.assert_array_equal(got["table"], forward_tick_table(S, M))


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][0] == "tiny"])
def test_tinyllama_pipeline_matches_reference_loss_and_grads(name, group, reference):
    pipes = assemble(name, group[name])
    check_case(name, pipes, reference[1][name])


def test_port_serial_reference_matches_jax(reference):
    """The port's own serial loss and gradients (what the four-card case
    holds the pipeline to) against the JAX package's, at the same
    tolerances."""
    got = port_reference(reference[0])
    for name, want in reference[1].items():
        w = got[name]
        check_case(name, [{"losses": [w["loss"]], "grads": w["grads"], "x": w.get("x")}], want)


def test_ranks_reject_a_wrong_microbatch_count():
    """The tick table is built for ``num_microbatches``; inputs of another
    count are refused before any exchange (a world of one, gloo)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.parallel.pipeline import build_pipelined_loss

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    dist.init_process_group("gloo", rank=0, world_size=1, store=dist.HashStore(),
                            timeout=datetime.timedelta(seconds=30))
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
        loss, table = build_pipelined_loss(_stage_fn, _loss_fn, mesh, num_microbatches=3)
        assert table.shape == (3, 1)
        a = mlp_inputs(1, 3)
        p = {"w": torch.tensor(a["w"][0]), "b": torch.tensor(a["b"][0])}
        with pytest.raises(ValueError, match="microbatches"):
            loss(p, torch.tensor(a["x"][:2]), torch.tensor(a["y"][:2]))
        # world 1: the exchange is skipped and the loss is the serial one
        value = loss(p, torch.tensor(a["x"]), torch.tensor(a["y"]))
    finally:
        dist.destroy_process_group()
    serial = torch.stack([_loss_fn(_stage_fn(p, torch.tensor(a["x"][m])), torch.tensor(a["y"][m]))
                          for m in range(3)]).mean()
    assert float(value.detach()) == float(serial)
