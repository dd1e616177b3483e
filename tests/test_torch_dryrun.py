"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU:

* its CLI, for reduced tinyllama, granite-moe, deepseek-v2 (its full
  config's ``expert_mlp`` on ``data`` kept), mamba2 and whisper on fake
  worlds of 4 (2x2) and 16 (4x4) ranks, writes one JSON per (shape, mesh)
  cell with the reference's keys where the port has a counterpart;
* the parameter and optimizer bytes are the sums over the port's
  ``abstract_params`` and ``adamw_abstract_state``, and a rank's shards and
  ZeRO blocks are its share of them;
* the counted FLOPs equal a ``FlopCounterMode`` count of the same step run
  on real CPU tensors (one device, and a (1, 1) mesh over a real gloo world
  of one rank), the kernels' FLOPs the formulas of their bounds;
* one full-width cell: tinyllama's ``train_4k`` on the 16x16 fake mesh
  (about 15 s here).
"""
import datetime
import json

import pytest
import torch

from repro_torch.analysis.roofline import attention_bwd_cost, attention_cost
from repro_torch.configs import get_config, get_reduced
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import adamw_abstract_state
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ARCHS = ("tinyllama-1.1b", "granite-moe-1b-a400m", "deepseek-v2-236b", "mamba2-1.3b",
         "whisper-medium")
MESHES = ("2x2", "4x4")
# the reference's keys that have a counterpart here, and the roofline's
KEYS = {"arch", "shape", "mesh", "chips", "kind", "seq_len", "global_batch", "ok", "memory",
        "collectives", "op_histogram", "roofline"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant", "dominant_s",
                 "model_flops_total", "model_flops_attention", "model_flops_per_chip",
                 "useful_flops_ratio"}


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _run_cli(*args) -> int:
    with pytest.raises(SystemExit) as done:
        dryrun.main(list(args))
    return done.value.code


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_cli_writes_one_json_per_cell_with_the_reference_keys(arch, mesh, tmp_path):
    assert _run_cli("--arch", arch, "--reduced", "--mesh-shape", mesh, "--seq", "32",
                    "--batch", "16", "--out", str(tmp_path)) == 0
    cfg = get_reduced(arch)
    shapes = list(cfg.shapes())
    files = sorted(p.name for p in tmp_path.iterdir())
    assert files == sorted(f"{cfg.name}__{s}__{mesh}.json" for s in shapes)
    chips = 4 if mesh == "2x2" else 16
    full = get_config(arch)
    model = build_model(cfg.replace(sharding_rules=full.sharding_rules), device="cpu")
    params = _nbytes(model.abstract_params())
    for shape in shapes:
        r = json.loads((tmp_path / f"{cfg.name}__{shape}__{mesh}.json").read_text())
        assert KEYS <= r.keys() and ROOFLINE_KEYS <= r["roofline"].keys(), r.keys()
        assert r["ok"] and r["chips"] == chips and r["mesh"] == mesh
        assert (r["seq_len"], r["global_batch"]) == (32, 16)
        assert r["collectives"]["total_bytes"] > 0 and r["flops_per_device"] > 0
        mem = r["memory"]
        assert mem["params_bytes"] == params
        # a rank holds its shards: less than the whole, at least 1/chips of it
        assert params / chips <= mem["params_bytes_per_device"] < params
        if r["kind"] == "train":
            # deepseek-v2's moments are bf16: its full config has over 1e11 parameters
            moments = "bfloat16" if arch == "deepseek-v2-236b" else "float32"
            opt = _nbytes(adamw_abstract_state(AdamWConfig(moments_dtype=moments),
                                               model.abstract_params()))
            assert mem["opt_bytes"] == opt and mem["moments_dtype"] == moments
            assert opt / chips <= mem["opt_bytes_per_device"] < opt
            assert r["op_histogram"]["dot"] > 0
        assert mem["peak_bytes"] >= mem["params_bytes_per_device"] + mem["opt_bytes_per_device"]
        assert mem["fits_80gb"]
    if arch == "deepseek-v2-236b":  # the 2-D expert sharding: w_gate's hidden dim over data
        assert dict(model.cfg.sharding_rules) == {"expert_mlp": "data"}


def test_parameter_and_optimizer_bytes_of_the_full_configs():
    cfg = get_config("deepseek-v2-236b")
    moments = dryrun.moments_dtype_for(cfg)
    assert moments == "bfloat16" and dryrun.moments_dtype_for(get_config("tinyllama-1.1b")) \
        == "float32"
    model = build_model(cfg.replace(num_layers=2), device="cpu")
    abstract = model.abstract_params()
    n = sum(t.numel() for t in tree_leaves(abstract))
    assert 5.3e9 < n < 5.4e9  # the dense layer 0 and one MoE layer at full width
    opt = adamw_abstract_state(AdamWConfig(moments_dtype=moments), abstract)
    # bf16 params but the f32 router, bf16 m and v, an f32 master, the count
    router = cfg.d_model * cfg.num_experts  # one MoE layer
    assert _nbytes(abstract) == 2 * n + 2 * router
    assert _nbytes(opt) == 8 * n + 4


def _train_step_flops(cfg, B, S, mesh=None):
    """A FlopCounterMode count of one train step on real CPU tensors, the
    kernels modelled as the dry run models them."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
    from repro_torch.tree import tree_unflatten

    model = build_model(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=g, dtype=torch.int32)
             for k in ("tokens", "targets")}
    ocfg, lr_fn = AdamWConfig(), cosine_schedule(3e-4, 2000, 100_000)
    params = model.init(0)
    with dryrun.kernel_model() as kern:
        if mesh is None:
            opt = adamw_init(ocfg, params.tree())
            with FlopCounterMode(display=False) as fc:
                tree = params.tree()
                loss, _ = model.loss(params, batch)
                grads = torch.autograd.grad(loss, tree_leaves(tree))
                adamw_update(ocfg, float(lr_fn(1000)), tree, tree_unflatten(tree, list(grads)),
                             opt)
        else:
            from repro_torch.parallel.steps import build_train_step, make_ctx, shard_params

            spec = {"kind": "train", "seq_len": S, "global_batch": B}
            step, _, _ = build_train_step(model, mesh, ocfg, lr_fn,
                                          model.input_specs("train", spec))
            params = shard_params(model, params, mesh)
            opt = adamw_init(ocfg, params.tree(), ctx=make_ctx(mesh))
            with FlopCounterMode(display=False) as fc:
                step(params, opt, batch, 1000)
    return fc.get_total_flops(), kern.flops


def test_flops_equal_a_count_of_the_step_on_real_tensors():
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32")
    B, S = 2, 16
    r = dryrun.run_cell(cfg, "train", {"kind": "train", "seq_len": S, "global_batch": B}, None,
                        verbose=False)
    aten, kern = _train_step_flops(cfg, B, S)
    assert r["aten_flops_per_device"] == aten > 0
    assert r["kernel_flops_per_device"] == kern
    assert r["flops_per_device"] == aten + kern
    # the kernels: each layer's forward twice (remat), its backward once
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    fwd, _ = attention_cost(B, H, KV, S, S, Dh, Dh, 4, causal=True)
    bwd, _ = attention_bwd_cost(B, H, KV, S, S, Dh, Dh, 4, causal=True)
    assert kern == cfg.num_layers * (2 * fwd + bwd)
    assert r["op_histogram"]["kernels"] == {"flash_attention": 2 * cfg.num_layers,
                                            "flash_attention_bwd": cfg.num_layers}


def test_flops_on_a_fake_world_of_one_equal_a_real_world_of_one(tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_reduced("granite-moe-1b-a400m").replace(dtype="float32")
    B, S = 2, 16
    dist.init_process_group("gloo", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1),
                            timeout=datetime.timedelta(seconds=60))
    try:
        aten, kern = _train_step_flops(cfg, B, S, make_host_mesh(1, device_type="cpu"))
    finally:
        dist.destroy_process_group()
    r = dryrun.run_cell(cfg, "train", {"kind": "train", "seq_len": S, "global_batch": B},
                        (1, 1), verbose=False)
    assert (r["aten_flops_per_device"], r["kernel_flops_per_device"]) == (aten, kern)
    assert r["collectives"]["total_bytes"] == 0  # a group of one rank moves nothing


def test_a_full_width_cell_on_the_16x16_fake_mesh(tmp_path):
    assert _run_cli("--arch", "tinyllama-1.1b", "--shape", "train_4k", "--mesh", "single",
                    "--out", str(tmp_path)) == 0
    r = json.loads((tmp_path / "tinyllama-1.1b__train_4k__16x16.json").read_text())
    assert r["ok"] and r["chips"] == 256 and (r["seq_len"], r["global_batch"]) == (4096, 256)
    assert r["memory"]["fits_80gb"]
    assert 0 < r["roofline"]["useful_flops_ratio"] < 1.5
    assert set(r["collectives"]["count_by_kind"]) >= {"all-gather", "reduce-scatter",
                                                      "all-reduce"}


def test_single_device_predicts_the_train_step_peak(tmp_path):
    assert _run_cli("--single-device", "--arch", "tinyllama-1.1b", "--reduced", "--kind",
                    "train", "--seq", "16", "--batch", "2", "--out", str(tmp_path)) == 0
    r = json.loads((tmp_path / "tinyllama-1.1b-reduced__train__single-device.json").read_text())
    mem = r["memory"]
    assert r["mesh"] == "single-device" and r["chips"] == 1
    assert mem["params_bytes_per_device"] == mem["params_bytes"]
    assert mem["opt_bytes_per_device"] == mem["opt_bytes"]
    # the step holds at least every gradient at once (autograd.grad returns them together)
    assert mem["step_peak_bytes"] >= mem["params_bytes"]
    assert r["collectives"]["total_bytes"] == 0
