"""The port's parallelism layer on CPU process groups (gloo), against the
reference's single-device functions.

Each mesh, (2 data x 2 model) and (1 data x 4 model), runs in one group of
four worker processes (a ``FileStore`` under the test's temporary dir, one
intra-op thread each, a timeout on every group) that drives every check and
writes its results; the tests compare them with the JAX package's jitted
single-device ``loss`` + ``adamw_update``, ``moe_dense``, ``prefill`` and
``decode_step``, f32 throughout:

* the reduced tinyllama train step at the schedule's peak lr (past the
  warmup): the loss (rtol 1e-5), the clip's global norm (rtol 1e-5), both
  AdamW moments gathered from their ZeRO blocks (1e-5 scaled: the largest
  error over the leaf's largest magnitude), and every updated param equal to
  the reference's AdamW update of those moments (atol 1e-7);
* ``moe_ep`` forward (rtol 1e-5) and gradients (atol 1e-4, rtol 1e-3) at the
  reference test's config (capacity factor 8: nothing drops);
* the reduced granite-moe decode step (atol 2e-4, rtol 2e-3) and the reduced
  tinyllama prefill (logits and every cache leaf, atol 1e-5 rtol 1e-4);
* ``Trainer(mesh=)`` for 3 steps against the port's single-device Trainer;
* each rank's ZeRO blocks: 1/n_data of every zero-sharded leaf;
* a checkpoint saved on (2, 2) restored bit for bit onto (1, 4), (4, 1) and
  one device, and each rank's peak host memory over a save there (only the
  writer holds the tree on the host).

The dispatch helpers and ``capacity_for`` are held against the reference's at
capacity factor 1.25 (where tokens drop) in this process.
"""
import datetime
import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ((2, 2), (1, 4))
WORLD = 4
GROUP_TIMEOUT_S = 240
B, S = 4, 16  # the train step's and the prefill's batch
# the train step's index: past the schedule's warmup, so its lr is the peak
# (at step 0 it is 0 and the update leaves every param as it was)
TRAIN_STEP, WARMUP, PEAK_LR = 10, 10, 1e-3
MOE_B, MOE_S = 4, 8
DEC_B, DEC_S, DEC_EXTRA = 4, 8, 4


def _moe_cfg(cfg_cls):
    return cfg_cls(name="m", family="moe", num_layers=1, d_model=32, num_heads=2,
                   num_kv_heads=2, d_ff=0, vocab_size=64, num_experts=8,
                   experts_per_token=2, moe_d_ff=16, num_shared_experts=1,
                   capacity_factor=8.0, dtype="float32")


# -- the worker: one rank of a group (torch and the port only) ---------------------


def _worker(rank: int, data: int, model_n: int, store: str, inputs: str, out: str,
            device_type: str = "cpu") -> None:
    """One rank: gloo on the CPU, or NCCL on ``cuda:<rank>`` (the on-card
    case, tests/test_torch_gpu.py)."""
    import torch.distributed as dist

    from repro_torch.bridge import params_from_jax
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ModelConfig
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.models.moe import moe_ep
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.optim.adamw import _zero_dim
    from repro_torch.parallel.sharding import shardings
    from repro_torch.parallel.steps import (
        build_decode_step, build_prefill, build_train_step, full_tensor, local_shard, make_ctx,
        model_param_specs, shard_params,
    )
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_flatten_with_keys, tree_leaves, tree_map

    dev = torch.device("cpu") if device_type == "cpu" else torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl", rank=rank,
                            world_size=WORLD, store=dist.FileStore(store, WORLD),
                            timeout=datetime.timedelta(seconds=60))
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    mesh = make_host_mesh(model_n, device_type=device_type)
    res: dict = {}

    def host(t):
        return t.detach().cpu().numpy().copy()

    def gathered(tree, specs, m=mesh):
        return {k: host(full_tensor(t.detach(), s, m))
                for (k, t), s in zip(tree_flatten_with_keys(tree), tree_leaves(specs))}

    # the train step (the on-card case widens the head dim to one the flash
    # kernel is built for: ``overrides``)
    over = inp.get("overrides", {})
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32", **over)
    model = build_model(cfg, device=dev)
    ocfg = AdamWConfig(lr=PEAK_LR)
    lr_fn = cosine_schedule(PEAK_LR, WARMUP, 100)
    spec = {"seq_len": S, "global_batch": B, "kind": "train"}
    step, specs, _ = build_train_step(model, mesh, ocfg, lr_fn, model.input_specs("train", spec))
    params = shard_params(model, params_from_jax(cfg, inp["tiny"], device=dev), mesh)
    opt = adamw_init(ocfg, params.tree(), ctx=make_ctx(mesh))
    params, opt, metrics = step(params, opt, inp["batch"], TRAIN_STEP)
    res["train_loss"] = float(metrics["loss"])
    res["train_grad_norm"] = float(metrics["grad_norm"])
    res["train_params"] = gathered(params.tree(), specs["params"])
    res["train_m"] = gathered(opt["m"], specs["opt"]["m"])
    res["train_v"] = gathered(opt["v"], specs["opt"]["v"])
    # the ZeRO layout: each rank's moment blocks beside its param shards
    zero = [(k, tuple(p.shape), tuple(m.shape), _zero_dim(p) is not None)
            for (k, p), m in zip(tree_flatten_with_keys(params.tree()), tree_leaves(opt["m"]))]
    zero_all = [None] * WORLD
    dist.all_gather_object(zero_all, zero)
    res["zero"] = zero_all

    # expert-parallel MoE, forward and every gradient
    mcfg = _moe_cfg(ModelConfig)
    ctx = make_ctx(mesh).at(MOE_B, MOE_S)
    p = tree_map(lambda a: torch.tensor(a, device=dev).requires_grad_(), inp["moe_params"])
    x = torch.tensor(inp["moe_x"], device=dev).requires_grad_()
    x_l = ctx.constrain_activations(ctx.local_batch(x))
    y, aux = moe_ep(mcfg, p, x_l, ctx)
    share = (y * y).sum() + aux / ctx.world
    leaves = tree_leaves(p) + [x]
    grads = [ctx.world_sum(g) for g in torch.autograd.grad(share, leaves)]
    res["moe_value"] = float(ctx.world_sum(share.detach()))
    res["moe_grads"] = [host(g) for g in grads]

    # the prefill
    prefill, pspecs = build_prefill(model, mesh, model.input_specs("prefill", spec))
    fresh = shard_params(model, params_from_jax(cfg, inp["tiny"], device=dev), mesh)
    logits, caches = prefill(fresh, inp["prompt"])
    res["prefill_logits"] = host(full_tensor(logits, pspecs["logits"], mesh))
    res["prefill_caches"] = gathered(caches, pspecs["caches"])

    # the decode step, from the reference's prefilled caches: granite-moe
    # (the MoE's decode path) and tinyllama (at model=4 its two kv heads do
    # not divide, so its caches split the head dim)
    for name, arch in (("granite", "granite-moe-1b-a400m"), ("tiny", "tinyllama-1.1b")):
        dcfg = get_reduced(arch).replace(dtype="float32", **over)
        dmodel = build_model(dcfg, device=dev)
        dparams = shard_params(dmodel, params_from_jax(dcfg, inp[name], device=dev), mesh)
        full_caches = tree_map(lambda a: torch.tensor(a, device=dev), inp["dec_caches"][name])
        dspec = {"tokens": torch.empty((DEC_B, 1), device="meta"), "caches": full_caches,
                 "index": torch.empty((DEC_B,), device="meta")}
        decode, dspecs = build_decode_step(dmodel, mesh, dspec)
        local = tree_map(lambda t, s: local_shard(t, s, mesh).clone(), full_caches,
                         dspecs["caches"])
        index = torch.full((DEC_B,), DEC_S, device=dev)
        dl, _ = decode(dparams, torch.zeros((DEC_B, 1), dtype=torch.long, device=dev), local,
                       index)
        res[f"decode_logits_{name}"] = host(full_tensor(dl, dspecs["logits"], mesh))

    # Trainer(mesh=) for three steps
    tcfg = TrainerConfig(**inp["trainer"])
    with Trainer(cfg, tcfg, os.path.join(os.path.dirname(out), f"ckpt_{data}x{model_n}"),
                 mesh=mesh, device=dev) as tr:
        run = tr.run(resume=False)
        res["trainer_losses"] = [r["loss"] for r in run["metrics"]]
        res["trainer_params"] = gathered(run["params"].tree(), tr.specs["params"])

    # a checkpoint saved here, restored onto other meshes and one device
    if (data, model_n) == (2, 2):
        saved = gathered(params.tree(), specs["params"])
        ckdir = os.path.join(os.path.dirname(out), "elastic")
        like = {"params": params.tree()}
        with CheckpointManager(ckdir, keep=1, writer=rank == 0) as cm:
            tree = tree_map(lambda t, s: torch.distributed.tensor.DTensor.from_local(
                t.detach(), mesh, shardings(s, mesh).placements()), like["params"],
                specs["params"])
            cm.save_async(1, {"params": tree}, meta={"step": 1})
            cm.wait()
        dist.barrier()
        cm = CheckpointManager(ckdir, keep=1, writer=False)
        same = {}
        for shape in ((1, 4), (4, 1)):
            other = make_host_mesh(shape[1], device_type=device_type)
            ospecs = model_param_specs(model, other)
            back, meta = cm.restore(like, device=dev,
                                    shardings={"params": shardings(ospecs, other)})
            same[shape] = meta["step"] == 1 and all(
                torch.equal(t.to_local(), local_shard(torch.tensor(saved[k], device=dev), s,
                                                      other))
                for (k, t), s in zip(tree_flatten_with_keys(back["params"]),
                                     tree_leaves(ospecs)))
        whole, _ = cm.restore(like, device=dev)
        same["one device"] = all(np.array_equal(host(t), saved[k])
                                 for k, t in tree_flatten_with_keys(whole["params"]))
        cm.close()
        same_all = [None] * WORLD
        dist.all_gather_object(same_all, same)
        res["elastic"] = same_all
        res["save_host"] = _save_host_peaks(rank, dev, mesh, os.path.dirname(out))

    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _status_bytes(key: str) -> int:
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith(key + ":"))


def _save_host_peaks(rank: int, dev, mesh, tmp: str) -> dict:
    """Each rank's peak host memory over one checkpoint save of a 64 MiB
    tree of sharded leaves (32 leaves of 2 MiB f32, split over data and
    model): the growth of the process's peak resident set (reset first,
    through ``/proc/self/clear_refs``) over its resident set before. Rank 0
    writes and holds the tree on the host; the others join the gathers,
    one leaf at a time, and keep nothing (on the CPU a gathered leaf is
    host memory too, so theirs grow by about one leaf and its buffers)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.parallel.sharding import placements

    spec = ("data", "model")
    tree = {f"w{i}": DTensor.from_local(torch.full((256, 512), float(i), device=dev), mesh,
                                        placements(spec, mesh)) for i in range(32)}
    nbytes = sum(t.numel() * t.element_size() for t in tree.values())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with CheckpointManager(os.path.join(tmp, "save_host"), keep=1, writer=rank == 0) as cm:
        with open("/proc/self/clear_refs", "w") as f:
            f.write("5")  # the peak resident set starts again from the current one
        before = _status_bytes("VmRSS")
        cm.save_async(1, tree)
        cm.wait()
        peak = _status_bytes("VmHWM") - before
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    return {"tree_bytes": nbytes, "peak_growth_bytes": peaks}


def _spawn(mesh: tuple, tmp, inputs: str, device_type: str = "cpu",
           module: str = "test_torch_parallel") -> dict:
    """One group of ``WORLD`` ranks, each running ``module._worker(rank,
    *mesh, store, inputs, out, device_type)``; rank 0's results."""
    store, out = str(tmp / "store"), str(tmp / "results.pkl")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="1")
    code = (f"import sys; sys.path.insert(0, sys.argv[1]); import {module} as t; "
            "n = int(sys.argv[2]); t._worker(*map(int, sys.argv[3:4 + n]), *sys.argv[4 + n:])")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, os.path.dirname(os.path.abspath(__file__)),
         str(len(mesh)), str(rank), *map(str, mesh), store, inputs, out, device_type],
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


# -- the reference's side (JAX, in this process) --------------------------------------


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_get_reduced
    from repro.configs.base import ModelConfig as JaxModelConfig
    from repro.models import build_model as jax_build_model
    from repro.models.common import Alloc
    from repro.models.lm import extend_caches as jax_extend_caches
    from repro.models.moe import moe_dense, moe_params
    from repro.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
    from repro.optim.adamw import decay_mask

    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    out: dict = {}
    inp: dict = {}
    # the train step
    cfg = jax_get_reduced("tinyllama-1.1b").replace(dtype="float32")
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    ocfg = AdamWConfig(lr=PEAK_LR)
    lr_fn = cosine_schedule(PEAK_LR, WARMUP, 100)

    def ref_step(params, opt, batch, step):
        (loss, _), g = jax.value_and_grad(lambda p: jm.loss(p, batch), has_aux=True)(params)
        p2, s2, met = adamw_update(ocfg, lr_fn(step), params, g, opt)
        return p2, loss, s2, met["grad_norm"]

    p2, loss, s2, gnorm = jax.jit(ref_step)(jp, adamw_init(ocfg, jp), batch,
                                            jnp.asarray(TRAIN_STEP))
    out["train_lr"] = float(lr_fn(jnp.asarray(TRAIN_STEP)))
    assert out["train_lr"] == pytest.approx(PEAK_LR)
    out["train_loss"], out["train_params"] = float(loss), to_np(p2)
    out["train_m"], out["train_v"] = to_np(s2["m"]), to_np(s2["v"])
    out["train_grad_norm"], out["train_decay"] = float(gnorm), decay_mask(jp)
    inp["tiny"], inp["batch"] = to_np(jp), batch
    # the prefill
    prompt = {"tokens": toks[:, :-1]}
    logits, caches = jax.jit(jm.prefill)(jp, prompt)
    out["prefill_logits"], out["prefill_caches"] = np.asarray(logits), to_np(caches)
    inp["prompt"] = prompt
    # moe_dense, its value and every gradient
    mcfg = _moe_cfg(JaxModelConfig)
    mp = moe_params(mcfg, Alloc("init", jax.random.PRNGKey(0), dtype=jnp.float32))
    x = jax.random.normal(jax.random.PRNGKey(1), (MOE_B, MOE_S, 32), jnp.float32)

    def f_dense(p, x):
        y, aux = moe_dense(mcfg, p, x)
        return jnp.sum(y * y) + aux

    val, (gp, gx) = jax.value_and_grad(f_dense, argnums=(0, 1))(mp, x)
    out["moe_value"], out["moe_grads"] = float(val), [np.asarray(g) for g in
                                                      jax.tree.leaves(gp) + [gx]]
    inp["moe_params"], inp["moe_x"] = to_np(mp), np.asarray(x)
    # the decode steps
    gcfg = jax_get_reduced("granite-moe-1b-a400m").replace(dtype="float32")
    gm = jax_build_model(gcfg)
    inp["granite"] = to_np(gm.init(jax.random.PRNGKey(0)))
    inp["dec_caches"] = {}
    for name, m in (("granite", gm), ("tiny", jm)):
        dtoks = np.random.default_rng(2).integers(0, m.cfg.vocab_size, (DEC_B, DEC_S))
        _, dcaches = jax.jit(m.prefill)(inp[name], {"tokens": jnp.asarray(dtoks, jnp.int32)})
        dcaches = jax_extend_caches(dcaches, DEC_EXTRA)
        dl, _ = jax.jit(m.decode_step)(inp[name], jnp.zeros((DEC_B, 1), jnp.int32), dcaches,
                                       jnp.asarray(DEC_S))
        out[f"decode_logits_{name}"] = np.asarray(dl)
        inp["dec_caches"][name] = to_np(dcaches)
    inp["trainer"] = dict(num_steps=3, checkpoint_every=100, log_every=1, seq_len=S,
                          global_batch=B, lr=1e-3, warmup=2)
    path = tmp_path_factory.mktemp("parallel_inputs") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return out, inp, str(path)


_GROUPS: dict = {}  # mesh -> its group's results (one group per mesh per pytest run)


def _group(mesh, reference, tmp_path_factory) -> dict:
    if mesh not in _GROUPS:
        _GROUPS[mesh] = _spawn(mesh, tmp_path_factory.mktemp("group"), reference[2])
    return _GROUPS[mesh]


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def sharded(request, reference, tmp_path_factory):
    return request.param, _group(request.param, reference, tmp_path_factory)


def _stack_port(tree: dict) -> dict:
    """The port's per-layer leaf names ("layers.s0.1.attn.wq") regrouped
    into the reference's stacked arrays ("layers.s0.attn.wq")."""
    groups: dict = {}
    for key, arr in tree.items():
        parts = key.split(".")
        if parts[0] in ("layers", "enc_layers") and parts[2].isdigit():
            groups.setdefault(".".join(parts[:2] + parts[3:]), {})[int(parts[2])] = arr
        else:
            groups[key] = arr
    return {k: np.stack([v[i] for i in sorted(v)]) if isinstance(v, dict) else v
            for k, v in groups.items()}


def _ref_flat(tree) -> dict:
    import jax

    return {".".join(str(p.key) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


# -- the tests -------------------------------------------------------------------------


def _adamw_first_step(p0, m, v, lr, decay, cfg) -> np.ndarray:
    """The reference's AdamW update at count 1 from the moments ``m`` and
    ``v`` (the clip scale is already in them), in f32."""
    f = np.float32
    step = (m / f(1 - cfg.b1)) / (np.sqrt(v / f(1 - cfg.b2)) + f(cfg.eps))
    if decay:
        step = step + f(cfg.weight_decay) * p0
    return p0 - f(lr) * step


def test_train_step_matches_single_device(sharded, reference):
    """The loss, and every updated param: the reference's AdamW update of
    the moments this step made (which the next test holds against the
    reference's), applied to the initial params at the schedule's peak lr.
    AdamW's first step is g / (|g| + eps) per element, so f32 noise in a
    near-zero gradient moves its param by up to the lr itself: an
    elementwise comparison with the reference's params cannot be tight, a
    comparison with the update of the port's own moments can."""
    from repro.optim import AdamWConfig

    _, res = sharded
    ref = reference[0]
    np.testing.assert_allclose(res["train_loss"], ref["train_loss"], rtol=1e-5)
    got, want = _stack_port(res["train_params"]), _ref_flat(ref["train_params"])
    assert sorted(got) == sorted(want)
    m, v = _stack_port(res["train_m"]), _stack_port(res["train_v"])
    p0, decay = _ref_flat(reference[1]["tiny"]), _ref_flat(ref["train_decay"])
    for k in want:
        expect = _adamw_first_step(p0[k], m[k], v[k], ref["train_lr"], bool(decay[k]),
                                   AdamWConfig(lr=PEAK_LR))
        np.testing.assert_allclose(got[k], expect, atol=1e-7, rtol=0, err_msg=k)
        assert not np.array_equal(got[k], p0[k]), k  # the step moved every leaf
        np.testing.assert_allclose(want[k], _adamw_first_step(
            p0[k], _ref_flat(ref["train_m"])[k], _ref_flat(ref["train_v"])[k], ref["train_lr"],
            bool(decay[k]), AdamWConfig(lr=PEAK_LR)), atol=1e-7, rtol=0, err_msg=k)


@pytest.mark.parametrize("moment", ["m", "v"])
def test_train_step_clip_norm_and_moments_match_single_device(sharded, reference, moment):
    """The global norm the clip reads (each element counted once across the
    mesh) and every AdamW moment, each leaf gathered from its ZeRO blocks,
    against the reference's: 1e-5 scaled (the largest error over the
    leaf's largest magnitude). A gradient summed too often or too rarely
    over the model or the data axes shows here even where AdamW's
    normalised step hides it."""
    _, res = sharded
    ref = reference[0]
    np.testing.assert_allclose(res["train_grad_norm"], ref["train_grad_norm"], rtol=1e-5)
    got, want = _stack_port(res[f"train_{moment}"]), _ref_flat(ref[f"train_{moment}"])
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        err = float(np.abs(got[k] - want[k]).max()) / scale
        assert err <= 1e-5, (k, err)


def test_moe_ep_forward_matches_dense_oracle(sharded, reference):
    _, res = sharded
    np.testing.assert_allclose(res["moe_value"], reference[0]["moe_value"], rtol=1e-5)


def test_moe_ep_gradients_match_dense_oracle(sharded, reference):
    _, res = sharded
    want = reference[0]["moe_grads"]
    assert len(res["moe_grads"]) == len(want)
    for g, w in zip(res["moe_grads"], want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-3)


def test_prefill_matches_single_device(sharded, reference):
    _, res = sharded
    ref = reference[0]
    np.testing.assert_allclose(res["prefill_logits"], ref["prefill_logits"], atol=1e-5,
                               rtol=1e-4)
    want = _ref_flat(ref["prefill_caches"])
    assert sorted(res["prefill_caches"]) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(res["prefill_caches"][k], w, atol=1e-5, rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", ["granite", "tiny"])
def test_decode_step_matches_single_device(sharded, reference, name):
    _, res = sharded
    key = f"decode_logits_{name}"
    np.testing.assert_allclose(res[key], reference[0][key], atol=2e-4, rtol=2e-3)


@pytest.fixture(scope="module")
def single_trainer(reference, tmp_path_factory):
    from repro_torch.configs import get_reduced
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_flatten_with_keys

    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32")
    tcfg = TrainerConfig(**reference[1]["trainer"])
    with Trainer(cfg, tcfg, str(tmp_path_factory.mktemp("single")), device="cpu") as tr:
        run = tr.run(resume=False)
    return ([r["loss"] for r in run["metrics"]],
            {k: t.detach().numpy() for k, t in tree_flatten_with_keys(run["params"].tree())})


def test_trainer_on_a_mesh_matches_single_device(sharded, single_trainer):
    _, res = sharded
    losses, params = single_trainer
    assert len(res["trainer_losses"]) == 3
    np.testing.assert_allclose(res["trainer_losses"], losses, rtol=1e-5)
    assert sorted(res["trainer_params"]) == sorted(params)
    for k, w in params.items():
        np.testing.assert_allclose(res["trainer_params"][k], w, atol=1e-5, err_msg=k)


def test_zero_moments_hold_a_data_block_of_each_leaf(sharded):
    (data, _), res = sharded
    assert len(res["zero"]) == WORLD
    for rank_rows in res["zero"]:
        # a leaf whose model shard leaves no dim free (a norm weight split
        # over model) keeps its state whole on every data rank
        assert sum(zero for *_, zero in rank_rows) > len(rank_rows) // 2
        for key, p_shape, m_shape, zero in rank_rows:
            want = int(np.prod(p_shape)) // (data if zero else 1)
            assert int(np.prod(m_shape)) == want, (key, p_shape, m_shape)


@pytest.mark.parametrize("target", [(1, 4), (4, 1), "one device"], ids=str)
def test_checkpoint_restores_across_meshes(reference, tmp_path_factory, target):
    res = _group((2, 2), reference, tmp_path_factory)  # saved on the (2, 2) mesh
    assert all(rank[target] for rank in res["elastic"]), res["elastic"]


def test_checkpoint_save_keeps_the_tree_on_the_writers_host_only(reference, tmp_path_factory):
    """A save on (2, 2): the writer's peak host memory grows by at least the
    tree; every other rank's by at most half of it (a rank that copied the
    gathered tree to the host would grow by all of it)."""
    save = _group((2, 2), reference, tmp_path_factory)["save_host"]
    print(json.dumps({"checkpoint_save_host_peak_2x2": save}))  # shown with -s
    writer, *others = save["peak_growth_bytes"]
    assert writer >= save["tree_bytes"], save
    assert max(others) <= save["tree_bytes"] // 2, save


# -- in this process -------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dispatch_combine_and_capacity_match_reference(seed):
    import jax.numpy as jnp

    from repro.configs.base import ModelConfig as JaxModelConfig
    from repro.models import moe as jmoe
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe as tmoe

    kw = dict(name="m", family="moe", num_layers=1, d_model=16, num_heads=2, num_kv_heads=2,
              d_ff=0, vocab_size=64, num_experts=8, experts_per_token=2, moe_d_ff=16,
              capacity_factor=1.25, dtype="float32")
    jcfg, cfg = JaxModelConfig(**kw), ModelConfig(**kw)
    rng = np.random.default_rng(seed)
    T = 48
    x = rng.standard_normal((T, 16)).astype(np.float32)
    # skewed routing: most copies to experts 0 and 1, so the buffers overflow
    ids = np.where(rng.random((T, 2)) < 0.7, rng.integers(0, 2, (T, 2)),
                   rng.integers(0, 8, (T, 2))).astype(np.int32)
    w = rng.random((T, 2)).astype(np.float32)
    C = tmoe.capacity_for(cfg, T)
    assert C == jmoe.capacity_for(jcfg, T)
    jbuf, jslot, jkeep = jmoe._dispatch_local(jcfg, jnp.asarray(x), jnp.asarray(ids), C)
    buf, slot, keep = tmoe._dispatch_local(cfg, torch.from_numpy(x), torch.from_numpy(ids), C)
    assert not bool(keep.all())  # the case drops copies
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(buf.numpy(), np.asarray(jbuf), atol=1e-6)
    y_buf = rng.standard_normal(buf.shape).astype(np.float32)
    want = jmoe._combine_local(jnp.asarray(y_buf), jnp.asarray(w), jslot, jkeep)
    got = tmoe._combine_local(torch.from_numpy(y_buf), torch.from_numpy(w), slot, keep)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("tokens", [1, 7, 64, 1000])
def test_capacity_for_matches_reference(tokens):
    from repro.configs import get_config as jax_get_config
    from repro.models.moe import capacity_for as jax_capacity_for
    from repro_torch.configs import get_config
    from repro_torch.models.moe import capacity_for

    for arch in ("granite-moe-1b-a400m", "deepseek-v2-236b"):
        assert capacity_for(get_config(arch), tokens) == jax_capacity_for(
            jax_get_config(arch), tokens)


@pytest.mark.parametrize("Hp,KVp,n", [(8, 2, 4), (8, 2, 2), (24, 6, 4), (32, 4, 16),
                                      (12, 4, 2)])
def test_local_kv_heads_are_the_ones_each_query_head_reads(Hp, KVp, n):
    from repro_torch.models.attention import _kv_of_local_heads

    G, Hl = Hp // KVp, Hp // n
    k = torch.randn(1, 3, KVp, 4)
    for r in range(n):
        sel = _kv_of_local_heads(k, r * Hl, Hl, G)
        g = Hl // sel.shape[2]  # query heads per selected kv head
        for i, h in enumerate(range(r * Hl, (r + 1) * Hl)):
            assert torch.equal(sel[:, :, i // g], k[:, :, h // G]), (r, h)


class _ShapeMesh:
    """A stand-in mesh: ``parallel.sharding.mesh_shape`` reads its ``shape``."""

    def __init__(self, **shape):
        self.shape = shape


@pytest.mark.parametrize("seq_shard", [True, False])
def test_ctx_seq_shard_decides_the_residual_layout(seq_shard):
    from repro_torch.parallel.ctx import ParallelCtx

    ctx = ParallelCtx(_ShapeMesh(data=2, model=4), seq_shard=seq_shard).at(4, 16)
    x = torch.arange(4 * 16 * 3, dtype=torch.float32).reshape(4, 16, 3)
    assert ctx.seq_sharded is seq_shard
    assert ctx.activation_spec(x) == (("data",), "model" if seq_shard else None, None)
    assert ctx.copies(ctx.seq_sharded) == (1 if seq_shard else 4)
    if not seq_shard:
        assert ctx.constrain_activations(x) is x
    # a sequence the model axis does not divide stays whole either way
    assert not ctx.at(4, 6).seq_sharded


def test_moe_apply_without_expert_parallel_raises():
    from repro_torch.configs import get_reduced
    from repro_torch.models.moe import moe_apply
    from repro_torch.parallel.ctx import ParallelCtx

    ctx = ParallelCtx(_ShapeMesh(data=1, model=1), expert_parallel=False)
    with pytest.raises(NotImplementedError, match="expert parallel"):
        moe_apply(get_reduced("granite-moe-1b-a400m"), {}, torch.zeros(1, 2, 4), ctx)
