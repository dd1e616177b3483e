"""The sharded train, prefill and decode steps as graphs
(``repro_torch.parallel.steps``' wrappers over ``runtime.graph``) on CPU
process groups (gloo), against their own eager bodies.

On the CPU nothing is captured: a graph runs its body eagerly through the
same static buffers (its inputs, the lr, its outputs) as the card's
replays. So these checks hold the wrappers' plumbing, not the card's
capture: which state a graph is bound to, what it copies in and clones
out, what it refuses. Each mesh, (2 data x 2 model) and (1 data x 4
model), runs one group of four worker processes
(``tests/test_torch_parallel.py``'s ``_spawn``), f32, reduced configs:

* ``Trainer(mesh=).run`` through the graph (one eager warm-up, then the
  captured step replayed) against an eager loop of ``Trainer.train_step``
  on a fresh state over the same batches, bit for bit: every step's metrics
  and every leaf of this rank's state, for dense (tinyllama), GQA-MoE
  (granite-moe), SSM (mamba2) and enc-dec (whisper), each rank's captured
  launches equal (empty on the CPU);
* the lr AdamW reads at each step is the graph's static tensor, holding
  that step's value of a schedule that differs at every step;
* a leaf of the state moved after the capture raises ``GraphError`` before
  the replay (the counter not advanced), and a call on another state
  builds a graph of its own, whose steps equal the first state's;
* the prefill twice (eager, then through the graph) and greedy decoding
  through the decode step's graph against the eager bodies: logits, every
  cache leaf after the last step and the tokens, bit for bit.

``tests/test_torch_gpu.py`` runs the same worker on four cards over NCCL,
where the graphs are captured.
"""
import datetime
import os
import pickle
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_parallel as par  # noqa: E402

MESHES = ((2, 2), (1, 4))
# dense, GQA-MoE, SSM and enc-dec; K1 on the card takes head dim 32, not the
# reduced 16
ARCHS = ("tinyllama-1.1b", "granite-moe-1b-a400m", "mamba2-1.3b", "whisper-medium")
OVERRIDES = {"tinyllama-1.1b": {"head_dim": 32}, "granite-moe-1b-a400m": {"head_dim": 32},
             "whisper-medium": {"head_dim": 32}}
# 4 steps: an eager warm-up, the capture and its replay, two more replays;
# the lr warms up over 2 steps and then decays, so it differs at every step
TRAINER = dict(num_steps=4, checkpoint_every=100, log_every=1, seq_len=8, global_batch=4,
               lr=1e-3, warmup=2)
B, S, NEW = 4, 8, 4  # the prefill's batch and prompt, the greedy tokens


def _cfg(arch: str):
    from repro_torch.configs import get_reduced

    return get_reduced(arch).replace(dtype="float32", **OVERRIDES.get(arch, {}))


def _source(cfg):
    """The Trainer's batches: an encoder-decoder's frames beside the tokens
    (``chip_smoke.EncDecVLMTokens``), else the Trainer's own source."""
    import test_torch_parallel_families as fam

    return fam._trainer_source(cfg)


def _local_leaves(state: dict) -> list:
    from repro_torch.tree import tree_leaves

    return tree_leaves({"params": state["params"].tree(), "opt": state["opt"]})


def _rows(metrics: list) -> list:
    return [{k: v for k, v in r.items() if k not in ("step", "step_s")} for r in metrics]


# -- the worker: one rank of a group (torch and the port only) ---------------------


def _trainer_graph(arch: str, mesh, dev, tmp: str) -> dict:
    """``Trainer(mesh=).run`` through the graph, then the eager loop on a
    fresh state: whether every row and every leaf of this rank's state
    agree bit for bit, the graph's stats, and the lr AdamW read at each
    step (on the CPU, where reading it does not break a capture)."""
    from repro_torch.data import to_device
    from repro_torch.parallel import steps as steps_mod
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = _cfg(arch)
    seen: list = []
    update = steps_mod.adamw_update

    def spy(ocfg, lr, *args, **kw):
        if dev.type == "cpu":
            seen.append((isinstance(lr, torch.Tensor) and lr is getattr(tr.graph, "lr", None),
                         float(lr)))
        return update(ocfg, lr, *args, **kw)

    steps_mod.adamw_update = spy
    try:
        with Trainer(cfg, TrainerConfig(**TRAINER), os.path.join(tmp, f"ckpt_{arch}"),
                     mesh=mesh, data_source=_source(cfg), device=dev) as tr:
            run = tr.run(resume=False)
            stats = tr.graph.stats()
            graph_rows, graph_leaves = _rows(run["metrics"]), _local_leaves(run)
            graph_lrs, seen[:] = list(seen), []
            tr.release_graph()
            state = tr.init_state()
            eager_rows = []
            for step in range(TRAINER["num_steps"]):
                met = tr.train_step(state, to_device(tr.data.batch(step), dev), step)
                eager_rows.append({k: float(v) for k, v in met.items()})
            schedule = [float(tr.lr_fn(step)) for step in range(TRAINER["num_steps"])]
            leaves = _local_leaves(state)
    finally:
        steps_mod.adamw_update = update
    return {"rows_equal": graph_rows == eager_rows, "rows": graph_rows,
            "leaves": len(leaves),
            "leaves_equal": len(leaves) == len(graph_leaves) and all(
                torch.equal(a, b) for a, b in zip(graph_leaves, leaves)),
            "stats": stats, "graph_lrs": graph_lrs, "schedule": schedule}


def _moved_and_recaptured(mesh, dev) -> dict:
    """The sharded step's graph on one state for three steps, a param leaf
    moved, the fourth step (raising ``GraphError``, the counter where it
    was), and three steps on a second state from the same init (a graph of
    its own)."""
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.parallel.steps import build_train_step, make_ctx, shard_params
    from repro_torch.runtime import GraphError
    from repro_torch.tree import tree_leaves

    cfg = _cfg("tinyllama-1.1b")
    model = build_model(cfg, device=dev)
    ocfg = AdamWConfig(lr=1e-3)
    step, _, _ = build_train_step(model, mesh, ocfg, cosine_schedule(1e-3, 1, 8),
                                  model.input_specs("train", {"seq_len": S, "global_batch": B,
                                                              "kind": "train"}))
    rng = np.random.default_rng(5)
    batches = [{k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device=dev)
                for k in ("tokens", "targets")} for _ in range(3)]

    def state():
        params = shard_params(model, model.init(0), mesh)
        return params, adamw_init(ocfg, params.tree(), ctx=make_ctx(mesh))

    def losses(params, opt):
        return [float(step(params, opt, b, i)[2]["loss"]) for i, b in enumerate(batches)]

    params, opt = state()
    first = losses(params, opt)
    graph = step.graph
    leaf = tree_leaves(params.tree())[0]
    leaf.data = leaf.data.clone()
    count = int(opt["count"])
    try:
        step(params, opt, batches[0], 3)
        raised = None
    except GraphError as e:
        raised = str(e)
    out = {"first": first, "first_stats": graph.stats(), "raised": raised,
           "count_before": count, "count_after": int(opt["count"])}
    params2, opt2 = state()
    out["second"] = losses(params2, opt2)
    out["second_stats"] = step.stats()
    out["released"] = graph.state is None and step.graph is not graph
    step.release()
    return out


def _serve_graphs(arch: str, mesh, dev) -> dict:
    """The prefill and NEW greedy decode steps through the wrappers'
    graphs and through their eager bodies, each from the same shards:
    whether the logits (gathered), every cache leaf after the last step
    and the tokens agree bit for bit, and the graphs' stats."""
    from repro_torch.models import build_model
    from repro_torch.models.lm import extend_caches
    from repro_torch.parallel.steps import (
        build_decode_step, build_prefill, full_tensor, shard_params,
    )
    from repro_torch.tree import tree_leaves

    import test_torch_parallel_families as fam

    cfg = _cfg(arch)
    model = build_model(cfg, device=dev)
    batch = fam.make_batch(cfg)
    batch = {k: torch.as_tensor(v[:, :S] if k == "tokens" else v, device=dev)
             for k, v in batch.items() if k != "targets"}
    params = shard_params(model, model.init(0), mesh)
    spec = {"seq_len": S, "global_batch": B, "kind": "prefill"}
    prefill, pspecs = build_prefill(model, mesh, model.input_specs("prefill", spec))
    meta = torch.device("meta")
    decode, dspecs = build_decode_step(model, mesh, {
        "tokens": torch.empty((B, 1), device=meta),
        "caches": model.cache_shapes(B, S + NEW), "index": torch.empty((B,), device=meta)})

    def greedy(pre, dec):
        logits, caches = pre(params, batch)
        caches = extend_caches(caches, NEW, window=cfg.window)
        seen, toks = [], []
        for i in range(NEW):
            full = full_tensor(logits, pspecs["logits"] if i == 0 else dspecs["logits"], mesh)
            seen.append(full)
            toks.append(full[:, -1].argmax(-1))
            logits, caches = dec(params, toks[-1][:, None], caches,
                                 torch.full((B,), S + i, device=dev))
        return seen, toks, caches

    eager = greedy(prefill.body, decode.body)
    first = prefill(params, batch)  # the eager warm-up
    graph = greedy(prefill, decode)  # the capture and its replay, then the decode's
    same = lambda a, b: len(a) == len(b) and all(  # noqa: E731
        torch.equal(x, y) for x, y in zip(a, b))
    out = {"prefill_warmup_equal": same(tree_leaves(list(first)),
                                        tree_leaves(list(prefill.body(params, batch)))),
           "logits_equal": same(graph[0], eager[0]), "tokens_equal": same(graph[1], eager[1]),
           "caches_equal": same(tree_leaves(graph[2]), tree_leaves(eager[2])),
           "prefill_stats": prefill.stats(), "decode_stats": decode.stats()}
    prefill.release()
    decode.release()
    return out


def _worker(rank: int, data: int, model_n: int, store: str, inputs: str, out: str,
            device_type: str = "cpu") -> None:
    """One rank: gloo on the CPU, or NCCL on ``cuda:<rank>`` (the on-card
    case, tests/test_torch_gpu.py). Each rank's results are gathered to
    rank 0, which writes them."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    dev = torch.device("cpu") if device_type == "cpu" else torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl", rank=rank,
                            world_size=par.WORLD, store=dist.FileStore(store, par.WORLD),
                            timeout=datetime.timedelta(seconds=60),
                            **({"device_id": dev} if dev.type == "cuda" else {}))
    mesh = make_host_mesh(model_n, device_type=device_type)
    tmp = os.path.dirname(out)
    res = {"trainer": {arch: _trainer_graph(arch, mesh, dev, tmp) for arch in ARCHS},
           "moved": _moved_and_recaptured(mesh, dev),
           "serve": {arch: _serve_graphs(arch, mesh, dev) for arch in ARCHS}}
    every = [None] * par.WORLD
    dist.all_gather_object(every, res)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(every, f)
    dist.barrier()
    dist.destroy_process_group()


def spawn(mesh: tuple, tmp, device_type: str = "cpu") -> list:
    """Every rank's results from one group of ``mesh``."""
    inputs = tmp / "inputs.pkl"
    inputs.write_bytes(pickle.dumps({}))
    return par._spawn(mesh, tmp, str(inputs), device_type=device_type,
                      module="test_torch_sharded_graph")


# -- the checks, shared with the on-card test -----------------------------------------


def check_trainer(ranks: list, arch: str) -> None:
    steps = TRAINER["num_steps"]
    for r in (rank["trainer"][arch] for rank in ranks):
        assert r["rows_equal"], (arch, r["rows"])
        assert r["leaves"] > 0 and r["leaves_equal"], arch
        assert r["stats"]["eager_steps"] == 1 and r["stats"]["replays"] == steps - 1, r["stats"]
        assert len(r["rows"]) == steps and all(np.isfinite(x["loss"]) for x in r["rows"])
        assert [x["lr"] for x in r["rows"]] == r["schedule"]
    captured = [rank["trainer"][arch]["stats"]["captured_launches"] for rank in ranks]
    assert all(c == captured[0] for c in captured), (arch, captured)
    assert ranks[0]["trainer"][arch]["rows"] == ranks[-1]["trainer"][arch]["rows"]


def check_moved(ranks: list) -> None:
    for r in (rank["moved"] for rank in ranks):
        assert r["raised"] and "moved since the capture" in r["raised"], r
        assert r["first_stats"]["replays"] == 2, r["first_stats"]  # none for the refused call
        assert r["count_after"] == r["count_before"] == 3, r
        assert r["second"] == r["first"], r
        assert r["second_stats"]["eager_steps"] == 1 and r["second_stats"]["replays"] == 2
        assert r["released"], r


def check_serve(ranks: list, arch: str) -> None:
    for r in (rank["serve"][arch] for rank in ranks):
        assert r["prefill_warmup_equal"], arch
        assert r["logits_equal"] and r["tokens_equal"] and r["caches_equal"], (arch, r)
        # the prefill: the warm-up, then the capture and its replay
        assert r["prefill_stats"]["eager_steps"] == 1 and r["prefill_stats"]["replays"] == 1
        assert r["decode_stats"]["eager_steps"] == 1
        assert r["decode_stats"]["replays"] == NEW - 1, r["decode_stats"]
    for kind in ("prefill_stats", "decode_stats"):
        captured = [rank["serve"][arch][kind]["captured_launches"] for rank in ranks]
        assert all(c == captured[0] for c in captured), (arch, kind, captured)


# -- the tests -------------------------------------------------------------------------


_GROUPS: dict = {}  # mesh -> its group's results (one group per mesh per pytest run)


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def group(request, tmp_path_factory):
    if request.param not in _GROUPS:
        _GROUPS[request.param] = spawn(request.param, tmp_path_factory.mktemp("graph_group"))
    return _GROUPS[request.param]


@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_on_a_mesh_through_the_graph_equals_the_eager_loop(group, arch):
    check_trainer(group, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_adamw_reads_the_static_lr_at_each_steps_value(group, arch):
    for r in (rank["trainer"][arch] for rank in group):
        assert len(set(r["schedule"])) == len(r["schedule"]), r["schedule"]
        assert r["graph_lrs"] == [(True, lr) for lr in r["schedule"]], r["graph_lrs"]


def test_a_moved_leaf_raises_and_another_state_captures_anew(group):
    check_moved(group)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_graphs_equal_their_eager_bodies(group, arch):
    check_serve(group, arch)


def test_the_wrappers_keep_their_eager_bodies():
    """``.body`` is the eager step the dry run traces; the wrappers bind no
    graph before their first call."""
    from repro_torch.parallel import steps

    for cls in (steps.ShardedTrainStep, steps.ShardedPrefill, steps.ShardedDecode):
        assert issubclass(cls, steps._StepGraphs)
    step = steps.ShardedTrainStep(lambda *a: a, lambda s: 0.0, "cpu")
    assert step.graph is None and step.stats() == {}
