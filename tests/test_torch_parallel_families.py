"""Every model family the port carries, under a mesh on CPU process groups
(gloo), against the reference's single-device functions.

The groups are ``tests/test_torch_parallel.py``'s (``_spawn``: four worker
processes, a ``FileStore``, one intra-op thread each, a timeout on every
group), one per mesh for all its checks: (data, model) = (2, 2) and (1, 4),
and the multi-pod (pod, data, model) = (2, 1, 2) and (2, 2, 1). f32
throughout, the reduced configs:

* deepseek-v2-236b (MLA, and MoE with ``expert_mlp`` on ``data``, the 2-D
  expert sharding its full config sets and the reduced one clears; its
  capacity factor set to E/K, so nothing drops and ``moe_ep`` equals the
  reference's ``moe_dense``), mamba2-1.3b (SSM), hymba-1.5b (hybrid, with
  sliding-window ring caches), whisper-medium (encoder-decoder, whose
  decoder cross-attends from a static cache) and paligemma-3b (VLM, a
  prefix-LM span over its patches), on (2, 2) and (1, 4): the train step at
  the schedule's peak lr (the loss and the clip's norm rtol 1e-5, both AdamW
  moments gathered from their ZeRO blocks 1e-5 scaled, 1e-4 for the SSD
  block's per-head and per-channel vectors (``SSM_VECTORS``), every param the
  AdamW update of those moments, atol 1e-7 and one f32 ulp of the value,
  since LayerNorm weights start at 1 where an ulp is 1.19e-7: the
  tolerances of ``tests/test_torch_parallel.py``'s dense step otherwise),
  the prefill (logits and
  every cache leaf gathered, atol 1e-5 rtol 1e-4) and one decode step from
  the reference's prefilled caches (logits atol 2e-4 rtol 2e-3, every cache
  leaf after the step atol 1e-5 rtol 1e-4), against ``jax.value_and_grad``
  of ``Model.loss`` plus ``adamw_update``, ``Model.prefill`` and
  ``Model.decode_step``;
* deepseek-v2's ``moe_ep`` with the 2-D expert sharding, forward and every
  gradient (rtol 1e-5; atol 1e-4 rtol 1e-3, as the dense test's ``moe_ep``
  check): at capacity E/K against ``moe_dense``, and at its own capacity
  factor 1.25, where tokens drop, against the reference's ``_dispatch_local``,
  ``_expert_ffn`` and ``_combine_local`` composed on each rank's tokens;
* mamba2 with 2 SSD heads on (1, 4), which does not divide them: the
  block runs whole on every rank, its state cache split over N;
* tinyllama-1.1b and granite-moe-1b-a400m (capacity E/K) on the multi-pod
  meshes: the train step, the prefill and a decode step;
* ``Trainer(mesh=)`` on (2, 2) for two steps of mamba2 and of whisper (its
  frames from ``chip_smoke.EncDecVLMTokens`` through ``data_source``),
  against the port's single-device Trainer.

``tests/test_torch_gpu.py`` runs the same workers on four cards over NCCL
against the port's own single-device results (:func:`port_reference`).
"""
import datetime
import importlib.util
import os
import pickle
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_parallel as par  # noqa: E402

FAMILIES = ("deepseek-v2-236b", "mamba2-1.3b", "hymba-1.5b", "whisper-medium", "paligemma-3b")
PODS = ("tinyllama-1.1b", "granite-moe-1b-a400m")
# a config of another's widths: mamba2 with 2 SSD heads, which model=4 does
# not divide (the block runs whole, its state split over N)
VARIANTS = {"mamba2-2-heads": ("mamba2-1.3b", {"ssm_head_dim": 64})}
# (pod, data, model) -> the archs its group runs, and whether it runs the
# MoE cases and the trainers
MESHES = {(1, 2, 2): (FAMILIES, True, True),
          (1, 1, 4): (FAMILIES + ("mamba2-2-heads",), True, False),
          (2, 1, 2): (PODS, False, False), (2, 2, 1): (PODS, False, False)}
B, S = 4, 16  # a batch's rows and text tokens
DEC_EXTRA = 4  # the positions the caches are padded by before the decode step
MOE_B, MOE_S = 4, 32  # at (2, 2) and (1, 4) each rank routes 32 tokens
TRAINER_ARCHS = ("mamba2-1.3b", "whisper-medium")
# the SSD block's per-head and per-channel vectors: each gradient element
# sums B x S (x P) products that largely cancel, so f32 summation order
# moves it by more than 1e-5 of the leaf's largest value (one device
# already: hymba's d_skip and a_log read 9.9e-6 and 5.1e-6 scaled against
# the reference's; four cards through the kernels against the CPU, its
# ssm.norm's second moment 1.25e-5); their moments are held to 1e-4
# scaled, the single-device train tests' tolerance
SSM_VECTORS = ("ssm.a_log", "ssm.d_skip", "ssm.dt_bias", "ssm.norm")
TRAINER = dict(num_steps=2, checkpoint_every=100, log_every=1, seq_len=8, global_batch=4,
               lr=1e-3, warmup=1)


def family_cfg(get_reduced, name: str, **overrides):
    """The reduced f32 config a family's checks run (an arch, or a
    :data:`VARIANTS` name), from either package's ``get_reduced``:
    deepseek-v2 with ``expert_mlp`` on ``data`` and, like granite-moe, at a
    capacity factor of E/K (nothing drops)."""
    arch, variant = VARIANTS.get(name, (name, {}))
    cfg = get_reduced(arch).replace(dtype="float32", **variant, **overrides)
    if arch == "deepseek-v2-236b":
        cfg = cfg.replace(sharding_rules=(("expert_mlp", "data"),))
    if cfg.is_moe:
        cfg = cfg.replace(capacity_factor=float(cfg.num_experts // cfg.experts_per_token))
    return cfg


def moe_cfg(get_reduced, capacity_factor: float):
    return get_reduced("deepseek-v2-236b").replace(
        dtype="float32", sharding_rules=(("expert_mlp", "data"),),
        capacity_factor=capacity_factor)


def make_batch(cfg, seed: int = 1) -> dict:
    """Tokens and targets of S text positions, plus frames or patches."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.vision_dim)).astype(np.float32)
    return batch


def seq_len(cfg) -> int:
    return S + (cfg.num_image_tokens if cfg.family == "vlm" else 0)


def port_caches(tree):
    """Caches in the port's layout: a ring's positions, which the reference
    keeps as one row for the batch, as one row per lane."""
    if not isinstance(tree, dict):
        return tree
    out = {k: port_caches(v) for k, v in tree.items()}
    if "pos" in out:
        lanes = out["k"].shape[-4]
        pos = out["pos"]
        out["pos"] = np.broadcast_to(pos[..., None, :], (*pos.shape[:-1], lanes,
                                                          pos.shape[-1])).copy()
    return out


def flat(tree, prefix="") -> dict:
    """A nested dict of arrays keyed by dotted paths."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items() for k2, v2 in flat(v, f"{prefix}{k}.").items()}
    return {prefix[:-1]: np.asarray(tree)}


# -- the worker: one rank of a group (torch and the port only) ---------------------


def _worker(rank: int, pods: int, data: int, model_n: int, store: str, inputs: str, out: str,
            device_type: str = "cpu") -> None:
    import torch.distributed as dist

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_reduced

    dev = torch.device("cpu") if device_type == "cpu" else torch.device("cuda", rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo" if dev.type == "cpu" else "nccl", rank=rank,
                            world_size=par.WORLD, store=dist.FileStore(store, par.WORLD),
                            timeout=datetime.timedelta(seconds=60))
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    # the multi-pod layout at four ranks (make_production_mesh takes 512)
    mesh = init_device_mesh(device_type, (pods, data, model_n),
                            mesh_dim_names=("pod", "data", "model")) if pods > 1 else \
        init_device_mesh(device_type, (data, model_n), mesh_dim_names=("data", "model"))
    archs, moe, trainers = MESHES[(pods, data, model_n)]
    res: dict = {}
    for arch in archs:
        cfg = family_cfg(get_reduced, arch, **inp["overrides"].get(arch, {}))
        res[arch] = _family(cfg, inp[arch], mesh, dev, "train" in inp["checks"].get(arch, ()))
    if moe:
        res["moe"] = {name: _moe_case(get_reduced, name, inp["moe"], mesh, dev)
                      for name in ("dense", "drops")}
    if trainers:
        res["trainer"] = {arch: _trainer(arch, inp, mesh, dev, os.path.dirname(out))
                          for arch in TRAINER_ARCHS}
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


def _gathered(tree, specs, mesh) -> dict:
    from repro_torch.parallel.steps import full_tensor
    from repro_torch.tree import tree_flatten_with_keys, tree_leaves

    return {k: full_tensor(t.detach(), s, mesh).cpu().numpy().copy()
            for (k, t), s in zip(tree_flatten_with_keys(tree), tree_leaves(specs))}


def _family(cfg, fam: dict, mesh, dev, train: bool) -> dict:
    """The train step, the prefill and one decode step of one family."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.parallel.steps import (
        build_decode_step, build_prefill, build_train_step, full_tensor, local_shard, make_ctx,
        shard_params,
    )
    from repro_torch.tree import tree_map

    model = build_model(cfg, device=dev)
    out: dict = {}

    def fresh():
        return shard_params(model, params_from_jax(cfg, fam["params"], device=dev), mesh)

    batch = fam["batch"]
    spec = {"seq_len": seq_len(cfg), "global_batch": B, "kind": "train"}
    if train:
        ocfg = AdamWConfig(lr=par.PEAK_LR)
        lr_fn = cosine_schedule(par.PEAK_LR, par.WARMUP, 100)
        step, specs, _ = build_train_step(model, mesh, ocfg, lr_fn,
                                          model.input_specs("train", spec))
        params = fresh()
        opt = adamw_init(ocfg, params.tree(), ctx=make_ctx(mesh))
        params, opt, metrics = step(params, opt, batch, par.TRAIN_STEP)
        out["train"] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                        "params": _gathered(params.tree(), specs["params"], mesh),
                        "m": _gathered(opt["m"], specs["opt"]["m"], mesh),
                        "v": _gathered(opt["v"], specs["opt"]["v"], mesh)}
    params = fresh()
    prompt = {k: v for k, v in batch.items() if k != "targets"}
    prefill, pspecs = build_prefill(model, mesh, model.input_specs(
        "prefill", dict(spec, kind="prefill")))
    logits, caches = prefill(params, prompt)
    out["prefill"] = {"logits": full_tensor(logits, pspecs["logits"], mesh).cpu().numpy(),
                      "caches": _gathered(caches, pspecs["caches"], mesh)}
    full = tree_map(lambda a: torch.tensor(a, device=dev), fam["dec_caches"])
    meta = torch.device("meta")
    decode, dspecs = build_decode_step(model, mesh, {
        "tokens": torch.empty((B, 1), device=meta), "caches": full,
        "index": torch.empty((B,), device=meta)})
    local = tree_map(lambda t, s: local_shard(t, s, mesh).clone(), full, dspecs["caches"])
    tokens = torch.tensor(fam["dec_tokens"], device=dev)
    dl, _ = decode(params, tokens, local, torch.full((B,), seq_len(cfg), device=dev))
    out["decode"] = {"logits": full_tensor(dl, dspecs["logits"], mesh).cpu().numpy(),
                     "caches": _gathered(local, dspecs["caches"], mesh)}
    return out


def _moe_case(get_reduced, name: str, moe: dict, mesh, dev) -> dict:
    """``moe_ep`` with deepseek-v2's specs (experts over model, their hidden
    dim over data), forward and every gradient, each made whole: summed
    over the mesh axes its spec does not shard (as the train step does),
    then gathered."""
    from repro_torch.models.common import Axes
    from repro_torch.models.moe import moe_ep, moe_params
    from repro_torch.parallel.sharding import rules_for, spec_for
    from repro_torch.parallel.steps import full_tensor, local_shard, make_ctx
    from repro_torch.tree import tree_flatten_with_keys, tree_leaves, tree_map

    cfg = moe_cfg(get_reduced, moe["capacity"][name])
    axes = moe_params(cfg, Axes())
    specs = tree_map(lambda a, ax: spec_for(tuple(ax), a.shape, rules_for(cfg), mesh),
                     moe["params"], axes)
    p = tree_map(lambda a, s: local_shard(torch.tensor(a, device=dev), s, mesh).clone()
                 .requires_grad_(), moe["params"], specs)
    for t, s in zip(tree_leaves(p), tree_leaves(specs)):
        t.mesh_spec = s
    x = torch.tensor(moe["x"], device=dev).requires_grad_()
    ctx = make_ctx(mesh).at(MOE_B, MOE_S)
    y, aux = moe_ep(cfg, p, ctx.constrain_activations(ctx.local_batch(x)), ctx)
    share = (y * y).sum() + aux / ctx.world
    grads = torch.autograd.grad(share, tree_leaves(p) + [x])
    whole = {}
    for (k, t), s, g in zip(tree_flatten_with_keys(p), tree_leaves(specs), grads):
        sharded = {a for e in s if e is not None for a in (e if isinstance(e, tuple) else (e,))}
        if ctx.model_dim(t) is None:
            g = ctx.model_sum(g)
        whole[k] = full_tensor(ctx.batch_sum_except(g, sharded), s, mesh).cpu().numpy()
    whole["x"] = ctx.world_sum(grads[-1]).cpu().numpy()
    return {"value": float(ctx.world_sum(share.detach())), "grads": whole,
            "specs": {k: s for (k, _), s in zip(tree_flatten_with_keys(p), tree_leaves(specs))}}


def _trainer(arch: str, inp: dict, mesh, dev, tmp: str) -> dict:
    from repro_torch.configs import get_reduced
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_reduced(arch).replace(dtype="float32", **inp["overrides"].get(arch, {}))
    with Trainer(cfg, TrainerConfig(**TRAINER), os.path.join(tmp, f"ckpt_{arch}"), mesh=mesh,
                 data_source=_trainer_source(cfg), device=dev) as tr:
        run = tr.run(resume=False)
        return {"losses": [r["loss"] for r in run["metrics"]],
                "params": _gathered(run["params"].tree(), tr.specs["params"], mesh)}


def _trainer_source(cfg):
    """The train cells' source for an encoder-decoder (its frames beside
    the tokens), else the Trainer's default."""
    if not cfg.is_encdec:
        return None
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(par.REPO, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke.EncDecVLMTokens(cfg, TRAINER["seq_len"], TRAINER["global_batch"])


# -- the reference's side (JAX, in this process) --------------------------------------


def _jax_family(arch: str) -> tuple:
    """(inputs, want) of one family from the JAX package."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model
    from repro.models.lm import extend_caches as jax_extend_caches
    from repro.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
    from repro.optim.adamw import decay_mask

    to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
    cfg = family_cfg(jax_get_reduced, arch)
    jm = jax_build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = make_batch(cfg)
    ocfg = AdamWConfig(lr=par.PEAK_LR)
    lr_fn = cosine_schedule(par.PEAK_LR, par.WARMUP, 100)

    def ref_step(params, opt, batch, step):
        (loss, _), g = jax.value_and_grad(lambda p: jm.loss(p, batch), has_aux=True)(params)
        p2, s2, met = adamw_update(ocfg, lr_fn(step), params, g, opt)
        return p2, loss, s2, met["grad_norm"]

    p2, loss, s2, gnorm = jax.jit(ref_step)(jp, adamw_init(ocfg, jp), batch,
                                            jnp.asarray(par.TRAIN_STEP))
    want = {"train": {"loss": float(loss), "grad_norm": float(gnorm),
                      "lr": float(lr_fn(jnp.asarray(par.TRAIN_STEP))),
                      "params": par._ref_flat(p2), "m": par._ref_flat(s2["m"]),
                      "v": par._ref_flat(s2["v"]), "p0": par._ref_flat(jp),
                      "decay": par._ref_flat(decay_mask(jp))}}
    prompt = {k: v for k, v in batch.items() if k != "targets"}
    logits, caches = jax.jit(jm.prefill)(jp, prompt)
    want["prefill"] = {"logits": np.asarray(logits), "caches": flat(port_caches(to_np(caches)))}
    caches = jax_extend_caches(caches, DEC_EXTRA)
    dec_tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    dec_in = port_caches(to_np(caches))
    dl, new = jax.jit(jm.decode_step)(jp, jnp.asarray(dec_tokens), caches,
                                      jnp.asarray(seq_len(cfg)))
    want["decode"] = {"logits": np.asarray(dl), "caches": flat(port_caches(to_np(new)))}
    inputs = {"params": to_np(jp), "batch": batch, "dec_caches": dec_in, "dec_tokens": dec_tokens}
    return inputs, want


def _jax_moe() -> tuple:
    """deepseek-v2's MoE: its params and skewed tokens (a shared offset
    sends most tokens to the same experts, so capacity 1.25 drops), and the
    reference's value and gradients at each capacity and mesh."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models.common import Alloc, act_fn
    from repro.models.moe import (
        _combine_local, _dispatch_local, _expert_ffn, capacity_for, moe_dense, moe_params, route,
    )

    dense_cfg = moe_cfg(jax_get_reduced, 4.0)
    cfg = moe_cfg(jax_get_reduced, 1.25)
    mp = moe_params(cfg, Alloc("init", jax.random.PRNGKey(0), dtype=jnp.float32))
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((MOE_B, MOE_S, cfg.d_model))
         + 1.5 * rng.standard_normal(cfg.d_model)).astype(np.float32)

    def value_and_grads(f):
        val, (gp, gx) = jax.value_and_grad(f, argnums=(0, 1))(mp, jnp.asarray(x))
        g = par._ref_flat(gp)
        g["x"] = np.asarray(gx)
        return {"value": float(val), "grads": g}

    def dense(p, xx):
        y, aux = moe_dense(dense_cfg, p, xx)
        return jnp.sum(y * y) + aux

    def shards(n_b: int, n_m: int):
        """The rank-by-rank composition at capacity 1.25: each rank's rows
        and sequence block dispatched, run and combined on their own."""
        act = act_fn(cfg.act if cfg.act in ("silu", "gelu") else "silu")
        K, d = cfg.experts_per_token, cfg.d_model
        Bl, Sl = MOE_B // n_b, MOE_S // n_m
        C = capacity_for(cfg, Bl * Sl)

        def f(p, xx):
            weights, ids, aux = route(cfg, p, xx)
            total, dropped = aux, 0
            for bi in range(n_b):
                for mi in range(n_m):
                    sl = (slice(bi * Bl, (bi + 1) * Bl), slice(mi * Sl, (mi + 1) * Sl))
                    xs = xx[sl].reshape(-1, d)
                    buf, slot, keep = _dispatch_local(cfg, xs, ids[sl].reshape(-1, K), C)
                    yb = _expert_ffn(cfg, p["w_gate"], p["w_up"], p["w_down"], buf)
                    y = _combine_local(yb, weights[sl].reshape(-1, K), slot, keep)
                    sp = p["shared"]
                    y = y + (act(xs @ sp["w_gate"]) * (xs @ sp["w_up"])) @ sp["w_down"]
                    total = total + jnp.sum(y * y)
            return total

        def drops(p, xx):
            _, ids, _ = route(cfg, p, xx)
            n = 0
            for bi in range(n_b):
                for mi in range(n_m):
                    sl = (slice(bi * Bl, (bi + 1) * Bl), slice(mi * Sl, (mi + 1) * Sl))
                    _, _, keep = _dispatch_local(cfg, xx[sl].reshape(-1, d),
                                                 ids[sl].reshape(-1, K), C)
                    n += int((~np.asarray(keep)).sum())
            return n

        return {**value_and_grads(f), "dropped": drops(mp, jnp.asarray(x))}

    want = {"dense": value_and_grads(dense),
            "drops": {(data, model): shards(data, model) for _, data, model in
                      (m for m, (_, moe, _) in MESHES.items() if moe)}}
    inputs = {"params": jax.tree.map(np.asarray, mp), "x": x,
              "capacity": {"dense": dense_cfg.capacity_factor, "drops": cfg.capacity_factor}}
    return inputs, want


def port_reference(mesh: tuple, overrides: dict, stacked) -> tuple:
    """(inputs, want) of ``mesh``'s group drawn by the port and held against
    its own single-device functions on the CPU: the four-card test's side,
    on a machine without JAX. ``stacked(cfg, params)`` lays the port's
    params out as the reference does. deepseek-v2 takes no train step (its
    attention's backward at Dqk=192/Dv=128 has no kernel on the card)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.models.lm import extend_caches
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, cosine_schedule
    from repro_torch.optim.adamw import decay_mask
    from repro_torch.tree import tree_flatten_with_keys, tree_leaves, tree_map, tree_unflatten

    def flat_port(tree):
        return {k: t.detach().numpy().copy() for k, t in tree_flatten_with_keys(tree)}

    archs, moe, _ = MESHES[mesh]
    inp: dict = {"overrides": overrides, "checks": {}}
    want: dict = {}
    for arch in archs:
        cfg = family_cfg(get_reduced, arch, **overrides.get(arch, {}))
        model = build_model(cfg, device="cpu")
        params = model.init(0)
        batch = make_batch(cfg)
        # copies: the train step below writes into the params in place
        inp[arch] = {"params": tree_map(np.copy, stacked(cfg, params)), "batch": batch}
        want[arch] = {}
        if arch != "deepseek-v2-236b":
            inp["checks"][arch] = ("train",)
            tree = params.tree()
            p0 = par._stack_port(flat_port(tree))
            decay = par._stack_port({k: np.asarray(d) for (k, _), d in zip(
                tree_flatten_with_keys(tree), tree_leaves(decay_mask(tree)))})
            ocfg = AdamWConfig(lr=par.PEAK_LR)
            lr = float(cosine_schedule(par.PEAK_LR, par.WARMUP, 100)(par.TRAIN_STEP))
            loss, _ = model.loss(params, batch)
            grads = tree_unflatten(tree, torch.autograd.grad(loss, tree_leaves(tree)))
            opt = adamw_init(ocfg, tree)
            _, _, met = adamw_update(ocfg, lr, tree, grads, opt)
            want[arch]["train"] = {
                "loss": float(loss.detach()), "grad_norm": float(met["grad_norm"]), "lr": lr,
                "params": par._stack_port(flat_port(tree)),
                "m": par._stack_port(flat_port(opt["m"])),
                "v": par._stack_port(flat_port(opt["v"])), "p0": p0,
                "decay": {k: bool(np.all(d)) for k, d in decay.items()}}
            params = model.init(0)  # the update wrote into the params
        prompt = {k: v for k, v in batch.items() if k != "targets"}
        logits, caches = model.prefill(params, prompt)
        want[arch]["prefill"] = {"logits": logits.numpy(), "caches": flat_port(caches)}
        caches = extend_caches(caches, DEC_EXTRA)
        dec_tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, 1)).astype(
            np.int32)
        inp[arch]["dec_caches"] = tree_map(lambda t: t.numpy().copy(), caches)
        inp[arch]["dec_tokens"] = dec_tokens
        dl, _ = model.decode_step(params, dec_tokens, caches, torch.full((B,), seq_len(cfg)))
        want[arch]["decode"] = {"logits": dl.numpy(), "caches": flat_port(caches)}
    if moe:
        inp["moe"], want["moe"] = _port_moe(mesh[1:])
    return inp, want


def _port_moe(mesh: tuple) -> tuple:
    """:func:`_jax_moe`'s inputs and values from the port's ``moe_dense``, and
    its dispatch, expert products and combine on each rank's tokens of the
    (data, model) ``mesh``."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import moe as tmoe
    from repro_torch.models.common import Init
    from repro_torch.tree import tree_flatten_with_keys, tree_leaves, tree_map

    dense_cfg, cfg = moe_cfg(get_reduced, 4.0), moe_cfg(get_reduced, 1.25)
    mp = tmoe.moe_params(cfg, Init(torch.Generator().manual_seed(0), torch.device("cpu"),
                                   torch.float32))
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((MOE_B, MOE_S, cfg.d_model))
         + 1.5 * rng.standard_normal(cfg.d_model)).astype(np.float32)
    keys = [k for k, _ in tree_flatten_with_keys(mp)]

    def value_and_grads(f):
        p = tree_map(lambda t: t.clone().requires_grad_(), mp)
        xx = torch.tensor(x).requires_grad_()
        val, dropped = f(p, xx)
        grads = torch.autograd.grad(val, tree_leaves(p) + [xx])
        return {"value": float(val.detach()), "dropped": dropped,
                "grads": {**{k: g.numpy() for k, g in zip(keys, grads)}, "x": grads[-1].numpy()}}

    def dense(p, xx):
        y, aux = tmoe.moe_dense(dense_cfg, p, xx)
        return (y * y).sum() + aux, 0

    n_b, n_m = mesh
    Bl, Sl = MOE_B // n_b, MOE_S // n_m
    C = tmoe.capacity_for(cfg, Bl * Sl)
    K, d = cfg.experts_per_token, cfg.d_model

    def shards(p, xx):
        weights, ids, aux = tmoe.route(cfg, p, xx)
        total, dropped = aux, 0
        for bi in range(n_b):
            for mi in range(n_m):
                sl = (slice(bi * Bl, (bi + 1) * Bl), slice(mi * Sl, (mi + 1) * Sl))
                xs = xx[sl].reshape(-1, d)
                buf, slot, keep = tmoe._dispatch_local(cfg, xs, ids[sl].reshape(-1, K), C)
                yb = tmoe._expert_ffn(cfg, p["w_gate"], p["w_up"], p["w_down"], buf)
                y = tmoe._combine_local(yb, weights[sl].reshape(-1, K), slot, keep)
                y = y + tmoe._shared_experts(cfg, p["shared"], xs[None])[0]
                total = total + (y * y).sum()
                dropped += int((~keep).sum())
        return total, dropped

    want = {"dense": value_and_grads(dense), "drops": {mesh: value_and_grads(shards)}}
    inputs = {"params": tree_map(lambda t: t.numpy(), mp), "x": x,
              "capacity": {"dense": dense_cfg.capacity_factor, "drops": cfg.capacity_factor}}
    return inputs, want


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    inp: dict = {"overrides": {}, "checks": {}}
    want: dict = {}
    for arch in FAMILIES + PODS + tuple(VARIANTS):
        inp[arch], want[arch] = _jax_family(arch)
        inp["checks"][arch] = ("train",)
    inp["moe"], want["moe"] = _jax_moe()
    path = tmp_path_factory.mktemp("families_inputs") / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inp, f)
    return inp, want, str(path)


_GROUPS: dict = {}


def _group(mesh, reference, tmp_path_factory) -> dict:
    if mesh not in _GROUPS:
        _GROUPS[mesh] = par._spawn(mesh, tmp_path_factory.mktemp("group"), reference[2],
                                   module="test_torch_parallel_families")
    return _GROUPS[mesh]


def _mesh_id(mesh) -> str:
    return "x".join(map(str, mesh if mesh[0] > 1 else mesh[1:]))


CASES = [(mesh, arch) for mesh, (archs, _, _) in MESHES.items() for arch in archs]


@pytest.fixture(scope="module", params=CASES, ids=[f"{_mesh_id(m)}-{a}" for m, a in CASES])
def family(request, reference, tmp_path_factory):
    mesh, arch = request.param
    return arch, _group(mesh, reference, tmp_path_factory)[arch], reference[1][arch]


# -- the checks (shared with the four-card test) --------------------------------------


def check_train(got: dict, want: dict) -> None:
    """The loss and the clip's norm (rtol 1e-5), both moments (1e-5 scaled)
    and every param: the reference's AdamW update of the port's moments
    (atol 1e-7), which moved it."""
    from repro_torch.optim import AdamWConfig

    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    params, m, v = (par._stack_port(got[k]) for k in ("params", "m", "v"))
    assert sorted(params) == sorted(want["params"])
    for moment, mine in (("m", m), ("v", v)):
        for k, w in want[moment].items():
            scale = max(float(np.abs(w).max()), 1e-30)
            err = float(np.abs(mine[k] - w).max()) / scale
            tol = 1e-4 if k.endswith(SSM_VECTORS) else 1e-5
            assert err <= tol, (moment, k, err)
    ocfg = AdamWConfig(lr=par.PEAK_LR)
    for k, p0 in want["p0"].items():
        expect = par._adamw_first_step(p0, m[k], v[k], want["lr"], bool(want["decay"][k]), ocfg)
        # an f32 ulp of the value beside 1e-7: LayerNorm weights start at 1
        np.testing.assert_allclose(params[k], expect, atol=1e-7, rtol=2.0**-23, err_msg=k)
        assert not np.array_equal(params[k], p0), k  # the step moved every leaf


def check_caches(got: dict, want: dict, **tol) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, err_msg=k, **tol)


def check_prefill(got: dict, want: dict, **tol) -> None:
    tol = tol or dict(atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got["logits"], want["logits"], **tol)
    check_caches(got["caches"], want["caches"], **tol)


def check_decode(got: dict, want: dict, cache_tol=None) -> None:
    np.testing.assert_allclose(got["logits"], want["logits"], atol=2e-4, rtol=2e-3)
    check_caches(got["caches"], want["caches"], **(cache_tol or dict(atol=1e-5, rtol=1e-4)))


def check_moe(got: dict, want: dict) -> None:
    np.testing.assert_allclose(got["value"], want["value"], rtol=1e-5)
    assert sorted(got["grads"]) == sorted(want["grads"])
    for k, w in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k], w, atol=1e-4, rtol=1e-3, err_msg=k)


def check_trainer(got: dict, losses: list, params: dict) -> None:
    assert len(got["losses"]) == TRAINER["num_steps"]
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    assert sorted(got["params"]) == sorted(params)
    for k, w in params.items():
        np.testing.assert_allclose(got["params"][k], w, atol=1e-5, err_msg=k)


# -- the tests -------------------------------------------------------------------------


def test_train_step_matches_single_device(family):
    _, got, want = family
    check_train(got["train"], want["train"])


def test_prefill_matches_single_device(family):
    _, got, want = family
    check_prefill(got["prefill"], want["prefill"])


def test_decode_step_matches_single_device(family):
    _, got, want = family
    check_decode(got["decode"], want["decode"])


@pytest.mark.parametrize("mesh", [m for m, (_, moe, _) in MESHES.items() if moe],
                         ids=_mesh_id)
@pytest.mark.parametrize("case", ["dense", "drops"])
def test_moe_ep_with_expert_hidden_dim_on_data(reference, tmp_path_factory, mesh, case):
    """deepseek-v2's experts split over model and their hidden dim over data
    (the stored blocks are 1/n_data of the experts' rows), forward and
    every gradient: at capacity E/K against ``moe_dense``, and at capacity
    1.25, where this case's skewed tokens drop copies, against the
    reference's dispatch, expert products and combine on each rank's
    tokens."""
    got = _group(mesh, reference, tmp_path_factory)["moe"][case]
    want = reference[1]["moe"][case]
    if case == "drops":
        want = want[mesh[1:]]
        assert want["dropped"] > 0  # the case exercises the capacity
    check_moe(got, want)
    assert got["specs"]["w_gate"] == ("model", None, "data")
    assert got["specs"]["w_down"] == ("model", "data", None)


@pytest.fixture(scope="module")
def single_trainers(reference, tmp_path_factory):
    from repro_torch.configs import get_reduced
    from repro_torch.runtime import Trainer, TrainerConfig
    from repro_torch.tree import tree_flatten_with_keys

    out = {}
    for arch in TRAINER_ARCHS:
        cfg = get_reduced(arch).replace(dtype="float32")
        with Trainer(cfg, TrainerConfig(**TRAINER), str(tmp_path_factory.mktemp("single")),
                     data_source=_trainer_source(cfg), device="cpu") as tr:
            run = tr.run(resume=False)
        out[arch] = ([r["loss"] for r in run["metrics"]],
                     {k: t.detach().numpy() for k, t in tree_flatten_with_keys(
                         run["params"].tree())})
    return out


@pytest.mark.parametrize("arch", TRAINER_ARCHS)
def test_trainer_on_a_mesh_matches_single_device(reference, tmp_path_factory, single_trainers,
                                                 arch):
    got = _group((1, 2, 2), reference, tmp_path_factory)["trainer"][arch]
    check_trainer(got, *single_trainers[arch])


# -- in this process -------------------------------------------------------------------


@pytest.mark.parametrize("arch", FAMILIES)
def test_batch_and_cache_specs_take_every_family(arch):
    """The specs of each family's batch (frames, patches beside the tokens)
    and of its caches split the batch: no family raises under a mesh."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.parallel.steps import batch_specs, cache_specs
    from repro_torch.tree import tree_flatten_with_keys

    cfg = family_cfg(get_reduced, arch)
    model = build_model(cfg, device="cpu")
    mesh = par._ShapeMesh(data=2, model=2)
    spec = {"seq_len": seq_len(cfg), "global_batch": B, "kind": "prefill"}
    bspecs = batch_specs(model, model.input_specs("prefill", spec), ("data",), mesh)
    assert all(s[0] == ("data",) for s in bspecs.values()), bspecs
    assert set(bspecs) == {"tokens"} | ({"frames"} if cfg.is_encdec else set()) | (
        {"patches"} if cfg.family == "vlm" else set())
    cspecs = tree_flatten_with_keys(cache_specs(model.cache_shapes(B, seq_len(cfg)), mesh,
                                                ("data",)))
    for k, s in cspecs:
        assert ("data",) in s, (k, s)  # every cache leaf splits the batch


def test_batch_group_comes_from_make_ctx():
    """A ctx made without ``make_ctx`` (a stand-in mesh, the spec helpers')
    has no batch group: a batch collective on it raises, whatever its
    batch axes."""
    from repro_torch.parallel.ctx import ParallelCtx

    wide = ParallelCtx(par._ShapeMesh(pod=2, data=2, model=1), batch_axes=("pod", "data"))
    assert wide.n_batch == 4
    with pytest.raises(ValueError, match="make_ctx"):
        wide.batch_sum(torch.ones(2))
