"""Multi-pod dry run, ported from the reference's ``repro/launch/dryrun.py``.

For every (architecture × input shape × mesh) cell it builds the port's
sharded step (``parallel/steps.py``: ``build_train_step``,
``build_prefill`` or ``build_decode_step``) on a fake process group of 256
ranks (the 16x16 single-pod mesh) or 512 (the 2x16x16 multi-pod mesh),
this process being rank 0: the counterpart of the reference's
``--xla_force_host_platform_device_count=512``. The fake backend
(``torch.testing._internal.distributed.fake_pg``) completes every
collective at once and moves nothing. The step runs once under
``FakeTensorMode`` on CPU tensors of the shapes of ``Model.input_specs``
and of this rank's shards, so nothing is allocated and nothing touches the
card. Where the card runs a hand-written kernel (flash attention and the
SSD scan, forward and backward), the dry run stands in for it
(:class:`KernelModel`, through ``kernels.build.STAND_IN``): it hands back
tensors of the kernel's outputs' shapes and counts the kernel's FLOPs and
bytes by the formulas the chip smoke's bounds use
(``analysis/roofline.py``), so the step modelled is the card's (the CPU's
plain versions would hold the (Sq, Sk) scores the kernels never write).

It records, per rank:

* **memory**: the parameter and optimizer bytes of the whole model (from
  ``Model.abstract_params`` and ``adamw_abstract_state``) and of this
  rank's shards, and the peak of the bytes the step itself holds live:
  a dispatch mode (``_StepMeter``) registers every storage an op creates
  and counts it off when the last tensor an op returned on it is freed
  (views share their storage and count once; autograd is made to keep the
  tensors it saves themselves). The predicted peak is the
  shards' bytes, the batch's and that step peak; ``fits_80gb`` compares it
  with 80e9 bytes;
* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  step's aten ops (matrix products and convolutions) plus the kernels'
  (``kernel_flops``);
* **bytes accessed**: the sum of every aten op's input and output bytes
  (view ops, which move nothing, left out) plus the kernels' least bytes:
  the unfused eager program the port runs, one op after another, each
  reading its inputs from and writing its output to device memory;
* **collective traffic**: ``analysis/traffic.py``'s record of the step's
  collectives, under the reference's ring model.

Then the roofline terms at the H100's constants and the useful-FLOP ratio
(``analysis/roofline.py``), as the reference computes them. The
reference's scan-depth correction (XLA's cost analysis counts a scanned
layer body once) has no counterpart here: the port runs every layer
eagerly, and every layer's ops are counted.

``--single-device`` models one rank with no mesh, as ``runtime.Trainer``
runs a train step on one card (``Model.loss``, autograd and AdamW), or
``Model.prefill`` / ``decode_step``, at a ``--depth``, ``--batch`` and
``--seq`` of one's choosing: its predicted peak is what ``chip_smoke.py``
prints beside the card's measured one. AdamW's moments are bf16 where the
arch's full config has over 1e11 parameters, as the reference's dry run
keeps them, whatever the depth cut.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --single-device --arch deepseek-v2-236b \\
      --kind train --depth 2 --batch 1 --seq 2048

Each cell's JSON goes to ``build/dryrun/<arch>__<shape>__<mesh>.json``
(``--out`` for another directory).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time
import traceback
import weakref
from collections import Counter
from typing import Optional

import torch

from ..analysis import traffic
from ..analysis.roofline import (
    attention_bwd_cost,
    attention_cost,
    model_flops,
    ssd_bwd_cost,
    ssd_cost,
    terms_from_analysis,
)
from ..configs import ARCH_NAMES, get_config, get_reduced, param_count
from ..tree import tree_leaves, tree_map

OUT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
CARD_BYTES = 80e9  # "fits_80gb"
PRODUCTION_MESHES = {"16x16": (16, 16), "2x16x16": (2, 16, 16)}


def moments_dtype_for(cfg) -> str:
    """The reference's rule for AdamW's moments: bf16 above 1e11 parameters
    (``cfg`` the full config: a depth cut does not change it)."""
    return "bfloat16" if param_count(cfg)["total"] > 1e11 else "float32"


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


class KernelModel:
    """The hand-written kernels as the dry run models them: outputs of the
    kernels' shapes and dtypes (and the backward's f32 row scratch), with
    the kernel's least FLOPs and bytes added up per call. Its methods take
    what the wrappers hand the kernels (``kernels.build.STAND_IN``); the SSD
    backward's scratch, sized by the library on the card, is not modelled."""

    def __init__(self) -> None:
        self.flops = 0
        self.bytes = 0

    @staticmethod
    def _dims(q, k, v, bshd):
        hd, sd = (2, 1) if bshd else (1, 2)
        return (q.shape[0], q.shape[hd], k.shape[hd], q.shape[sd], k.shape[sd], q.shape[3],
                v.shape[3])

    def flash_attention(self, q, k, v, *, causal, window, k_len, bshd, lse, prefix_len):
        B, H, KV, Sq, Sk, Dqk, Dv = self._dims(q, k, v, bshd)
        flops, nbytes = attention_cost(B, H, KV, Sq, Sk, Dqk, Dv, q.element_size(),
                                       causal=causal, window=window, prefix_len=prefix_len,
                                       k_len=k_len)
        self.flops, self.bytes = self.flops + flops, self.bytes + nbytes
        o = q.new_empty((*q.shape[:3], Dv))
        if not lse:
            return o
        self.bytes += 4 * B * H * Sq
        return o, torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)

    def flash_attention_bwd(self, q, k, v, o, lse, do, *, causal, window, k_len, bshd,
                            prefix_len):
        B, H, KV, Sq, Sk, Dqk, Dv = self._dims(q, k, v, bshd)
        flops, nbytes = attention_bwd_cost(B, H, KV, Sq, Sk, Dqk, Dv, q.element_size(),
                                           causal=causal, window=window,
                                           prefix_len=prefix_len, k_len=k_len)
        self.flops, self.bytes = self.flops + flops, self.bytes + nbytes
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)  # D = rowsum(dO o O)
        grads = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        del delta
        return grads

    def ssd(self, x, dt, A, Bm, Cm, *, chunk):
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        flops, nbytes = ssd_cost(B, S, H, P, N, chunk, x.element_size())
        self.flops, self.bytes = self.flops + flops, self.bytes + nbytes
        return torch.empty_like(x), x.new_empty((B, H, P, N), dtype=torch.float32)

    def ssd_bwd(self, x, dt, A, Bm, Cm, dy, dfinal, *, chunk):
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        flops, nbytes = ssd_bwd_cost(B, S, H, P, N, chunk, x.element_size())
        self.flops, self.bytes = self.flops + flops, self.bytes + nbytes
        return tuple(torch.empty_like(t) for t in (x, dt, A, Bm, Cm))


@contextlib.contextmanager
def kernel_model():
    """Stands :class:`KernelModel` in for the kernels inside the block."""
    from ..kernels import build

    prev, model = build.STAND_IN, KernelModel()
    build.STAND_IN = model
    try:
        yield model
    finally:
        build.STAND_IN = prev


def _storage_key(t: torch.Tensor) -> int:
    """The address of ``t``'s storage: one key for all views of it, stable
    while it lives (a fake tensor's storage wrapper is not kept, so the
    wrapper's own identity is not)."""
    return t.untyped_storage()._cdata


def _step_meter(ops: Counter, keep: set):
    """A dispatch mode counting every aten op (into ``ops``), the input and
    output bytes of the ops that are not views, and the bytes of the
    storages the ops create while they live (storages in ``keep``, the
    inputs', excluded). A storage lives while a tensor on it that an op
    returned lives (each tensor's weak-reference finalizer counts it off);
    :func:`_keep_saved` keeps the tensors autograd saves the ones the ops
    returned."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _StepMeter(TorchDispatchMode):
        def __init__(self) -> None:
            super().__init__()
            self.bytes = 0
            self.live = 0
            self.peak = 0
            self._holders: dict = {}  # storage key -> [bytes, live tensors on it]

        def _drop(self, key: int) -> None:
            held = self._holders[key]
            held[1] -= 1
            if held[1] == 0:
                self.live -= held[0]
                del self._holders[key]

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ops[func.overloadpacket.__name__] += 1
            outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
            if not getattr(func, "is_view", False):
                ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
                self.bytes += _nbytes(*ins) + _nbytes(*outs)
            for t in outs:
                key = _storage_key(t)
                if key in keep:
                    continue
                held = self._holders.get(key)
                if held is None:
                    held = self._holders[key] = [t.untyped_storage().nbytes(), 0]
                    self.live += held[0]
                held[1] += 1
                weakref.finalize(t, self._drop, key)
            self.peak = max(self.peak, self.live)
            return out

    return _StepMeter()


def _keep_saved():
    """Autograd keeps the very tensors it saves for the backward (by
    default it keeps an output's data under a new tensor, which the meter's
    finalizers would not see)."""
    return torch.autograd.graph.saved_tensors_hooks(lambda t: t, lambda t: t)


def _fake_world(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _end_world() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh_of(shape: tuple):
    from .mesh import _mesh

    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    return _mesh(shape, axes, "cpu")


def mesh_name(shape: Optional[tuple]) -> str:
    return "single-device" if shape is None else "x".join(str(n) for n in shape)


def _fake_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype)


def run_cell(cfg, shape_name: str, spec: dict, mesh_shape: Optional[tuple], *,
             full_cfg=None, verbose: bool = True) -> dict:
    """One cell: ``cfg`` at ``spec`` (``seq_len``, ``global_batch``,
    ``kind``) on a fake world of ``mesh_shape`` (None: one rank, no mesh).
    AdamW's moments follow :func:`moments_dtype_for` of ``full_cfg`` (the
    config before any depth cut), else of ``cfg``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from ..models import build_model
    from ..optim import AdamWConfig, cosine_schedule
    from ..optim.adamw import adamw_abstract_state, adamw_init

    t0 = time.perf_counter()
    kind = spec["kind"]
    chips = 1
    for n in mesh_shape or ():
        chips *= n
    model = build_model(cfg, device="cpu")
    babs = model.input_specs(shape_name, spec)
    ocfg = AdamWConfig(moments_dtype=moments_dtype_for(full_cfg or cfg))
    lr_fn = cosine_schedule(3e-4, 2000, 100_000)
    abstract = model.abstract_params()
    opt_abstract = adamw_abstract_state(ocfg, abstract)
    mem = {"params_bytes": _nbytes(*tree_leaves(abstract)),
           "opt_bytes": _nbytes(*tree_leaves(opt_abstract)) if kind == "train" else 0,
           "moments_dtype": ocfg.moments_dtype if kind == "train" else None}

    if mesh_shape is not None:
        _fake_world(chips)
    try:
        mesh = ctx = None
        if mesh_shape is not None:  # real tensors: the mesh reads its rank grid
            from ..parallel.steps import make_ctx

            mesh = _mesh_of(mesh_shape)
            ctx = make_ctx(mesh)
        with FakeTensorMode():
            if mesh is not None:
                from ..parallel.steps import shard_params

                params = shard_params(model, tree_map(_fake_like, abstract), mesh)
            else:
                from ..models.common import ParamTree

                params = ParamTree(tree_map(_fake_like, abstract))
            state = {"params": params}
            if kind == "train":
                state["opt"] = adamw_init(ocfg, params.tree(), ctx=ctx)
            batch = {k: v for k, v in babs.items() if k != "caches"}
            batch = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), batch)
            if kind == "decode":
                caches = tree_map(_fake_like, babs["caches"])
                if mesh is not None:
                    from ..parallel.steps import build_decode_step, local_shard

                    _, specs = build_decode_step(model, mesh, babs)
                    caches = tree_map(lambda t, sp: local_shard(t, sp, mesh).clone(), caches,
                                      specs["caches"])
                state["caches"] = caches
            inputs = (tree_leaves(params.tree()) + tree_leaves(state.get("opt", {}))
                      + tree_leaves(state.get("caches", {})) + tree_leaves(batch))
            keep = {_storage_key(t) for t in inputs}
            mem["params_bytes_per_device"] = _nbytes(*tree_leaves(params.tree()))
            mem["opt_bytes_per_device"] = _nbytes(*tree_leaves(state.get("opt", {})))
            mem["batch_bytes_per_device"] = _nbytes(*tree_leaves(batch)) + _nbytes(
                *tree_leaves(state.get("caches", {})))
            step = _step_fn(model, mesh, ocfg, lr_fn, babs, kind, state, batch)
            with kernel_model() as kern, traffic.record() as rec, _keep_saved():
                meter = _step_meter(rec.ops, keep)
                with FlopCounterMode(display=False) as fc, meter:
                    step()
            aten_flops = fc.get_total_flops()
    finally:
        if mesh_shape is not None:
            _end_world()

    flops = float(aten_flops + kern.flops)
    bytes_accessed = float(meter.bytes + kern.bytes)
    coll = traffic.collective_traffic(rec.events)
    hist = traffic.op_histogram(rec)
    static = (mem["params_bytes_per_device"] + mem["opt_bytes_per_device"]
              + mem["batch_bytes_per_device"])
    mem.update(step_peak_bytes=meter.peak, peak_bytes=static + meter.peak,
               fits_80gb=static + meter.peak <= CARD_BYTES,
               tracked_by="a dispatch mode over the storages the step's ops create")
    terms = terms_from_analysis(flops, bytes_accessed, coll["total_bytes"])
    mf = model_flops(cfg, spec["seq_len"], spec["global_batch"], kind)
    useful_per_chip = mf["total"] / chips
    run_s = time.perf_counter() - t0
    result = {
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": mesh_name(mesh_shape),
        "chips": chips,
        "kind": kind,
        "seq_len": spec["seq_len"],
        "global_batch": spec["global_batch"],
        "num_layers": cfg.num_layers,
        "ok": True,
        "run_s": run_s,
        "memory": mem,
        "flops_per_device": flops,
        "aten_flops_per_device": float(aten_flops),
        "kernel_flops_per_device": float(kern.flops),
        "bytes_per_device": bytes_accessed,
        "kernel_bytes_per_device": float(kern.bytes),
        "collectives": coll,
        "op_histogram": hist,
        "roofline": {
            **terms.to_dict(),
            "model_flops_total": mf["total"],
            "model_flops_attention": mf["attention"],
            "model_flops_per_chip": useful_per_chip,
            "useful_flops_ratio": useful_per_chip / flops if flops else 0.0,
        },
    }
    if verbose:
        print(
            f"[OK] {cfg.name:>22s} {shape_name:<12s} {result['mesh']:<13s}"
            f" run={run_s:6.1f}s peak={mem['peak_bytes'] / 2**30:7.2f}GiB"
            f" flops/dev={flops:.3e} coll={coll['total_bytes'] / 2**20:9.1f}MiB"
            f" dominant={terms.dominant}",
            flush=True,
        )
    return result


def _step_fn(model, mesh, ocfg, lr_fn, babs, kind, state, batch):
    """The cell's step as a thunk: the eager body of the sharded step of
    ``parallel.steps`` under a mesh (its graph's static-input copies are no
    part of the step), else what ``runtime.Trainer.train_step`` (or
    serving) runs on one device."""
    from ..optim import adamw_update
    from ..tree import tree_unflatten

    params = state["params"]
    if kind == "train":
        if mesh is not None:
            from ..parallel.steps import build_train_step

            step, _, _ = build_train_step(model, mesh, ocfg, lr_fn, babs)
            return lambda: step.body(params, state["opt"], batch, float(lr_fn(1000)))

        def single():
            tree = params.tree()
            loss, _ = model.loss(params, batch)
            grads = tree_unflatten(tree, torch.autograd.grad(loss, tree_leaves(tree)))
            adamw_update(ocfg, float(lr_fn(1000)), tree, grads, state["opt"])

        return single
    if kind == "prefill":
        if mesh is not None:
            from ..parallel.steps import build_prefill

            fn, _ = build_prefill(model, mesh, babs)
            return lambda: fn.body(params, batch)
        return lambda: model.prefill(params, batch)
    if mesh is not None:
        from ..parallel.steps import build_decode_step

        fn, _ = build_decode_step(model, mesh, babs)
        return lambda: fn.body(params, batch["tokens"], state["caches"], batch["index"])
    return lambda: model.decode_step(params, batch["tokens"], state["caches"], batch["index"])


def save_result(result: dict, out_dir: pathlib.Path = OUT_DIR) -> pathlib.Path:
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{result['arch']}__{result['shape']}__{result['mesh']}.json"
    path.write_text(json.dumps(result, indent=1, default=float))
    return path


def all_cells() -> list:
    cells = []
    for arch in ARCH_NAMES:
        for shape_name in get_config(arch).shapes():
            cells.append((arch, shape_name))
    return cells


def _config(arch: str, reduced: bool, depth: Optional[int]):
    """The arch's config (reduced: keeping the full config's sharding rules,
    deepseek-v2's ``expert_mlp`` on ``data``), its depth cut to ``depth``;
    and the full config, whose size sets the moments' dtype."""
    full = get_config(arch)
    cfg = get_reduced(arch).replace(sharding_rules=full.sharding_rules) if reduced else full
    if depth is not None:
        cfg = cfg.replace(num_layers=depth)
    return cfg, full


def _parse_mesh(text: str) -> tuple:
    return tuple(int(n) for n in text.split("x"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=("single", "multi", "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--single-device", action="store_true",
                    help="one rank, no mesh (the single-card train or serve step)")
    ap.add_argument("--mesh-shape", default=None,
                    help="a fake world of this (data)x(model) or (pod)x(data)x(model) mesh "
                         "in place of the production meshes, e.g. 2x2")
    ap.add_argument("--depth", type=int, default=None, help="decoder layers (default: all)")
    ap.add_argument("--batch", type=int, default=None, help="global batch (default: the shape's)")
    ap.add_argument("--seq", type=int, default=None, help="sequence (default: the shape's)")
    ap.add_argument("--kind", default=None, choices=("train", "prefill", "decode"),
                    help="with --single-device and no --shape")
    ap.add_argument("--reduced", action="store_true", help="the arch's reduced config")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)

    if args.all:
        cells = all_cells()
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        if args.shape:
            shapes = [args.shape]
        elif args.single_device and args.kind:
            shapes = [None]
        else:
            shapes = list(get_config(args.arch).shapes())
        cells = [(args.arch, s) for s in shapes]
    if args.single_device:
        meshes = [None]
    elif args.mesh_shape:
        meshes = [_parse_mesh(args.mesh_shape)]
    else:
        meshes = [PRODUCTION_MESHES[n] for n in
                  {"single": ["16x16"], "multi": ["2x16x16"], "both": ["16x16", "2x16x16"]}[
                      args.mesh]]

    failures = 0
    for arch, shape_name in cells:
        cfg, full = _config(arch, args.reduced, args.depth)
        if shape_name is None:
            shape_name = args.kind
            spec = {"kind": args.kind, "seq_len": args.seq or 2048, "global_batch": args.batch or 1}
        else:
            spec = dict(cfg.shapes()[shape_name])
        if args.seq:
            spec["seq_len"] = args.seq
        if args.batch:
            spec["global_batch"] = args.batch
        for mesh_shape in meshes:
            out = out_dir / f"{cfg.name}__{shape_name}__{mesh_name(mesh_shape)}.json"
            if args.skip_existing and out.exists():
                prev = json.loads(out.read_text())
                if prev.get("ok"):
                    print(f"[skip] {cfg.name} {shape_name} {mesh_name(mesh_shape)}", flush=True)
                    continue
            try:
                result = run_cell(cfg, shape_name, spec, mesh_shape, full_cfg=full)
            except Exception as e:  # noqa: BLE001 - report, continue sweep
                failures += 1
                result = {
                    "arch": cfg.name,
                    "shape": shape_name,
                    "mesh": mesh_name(mesh_shape),
                    "ok": False,
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-4000:],
                }
                print(f"[FAIL] {cfg.name} {shape_name} {mesh_name(mesh_shape)}: {e}", flush=True)
            save_result(result, out_dir)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
