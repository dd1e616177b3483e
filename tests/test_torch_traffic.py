"""The port's collective-traffic record (``repro_torch.analysis.traffic``),
the counterpart of the reference's HLO parser (``repro.analysis.hlo``):

* events shaped as the reference test's synthetic HLO ops (the same result
  shapes, dtypes and group sizes) give exactly the reference parser's
  ``bytes_by_kind`` and ``count_by_kind`` on that text;
* on a real gloo group of four ranks, the record of one sharded train step
  of reduced tinyllama on the (2 data x 2 model) mesh equals the fake-world
  dry run's record of the same step (``launch/dryrun.py``), kind by kind
  and byte for byte, rank 0's against rank 0's; the group is spawned once
  (``tests/test_torch_parallel.py``'s ``_spawn``);
* the recorder is off outside its block, and ``op_histogram`` counts the
  matrix products, the convolutions and the kernel entry calls.

The worker imports no JAX: the reference's parser is imported in its test.
"""
import datetime
import os
import pickle
import sys

import pytest
import torch

from repro_torch.analysis import traffic

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_parallel as tpar  # noqa: E402  (the group's spawn)

torch.set_num_threads(1)

B, S = 4, 16  # the sharded step's batch
MESH = (2, 2)

SYNTHETIC_HLO = """
HloModule m
ENTRY e {
  %x = bf16[128,256]{1,0} parameter(0)
  %ar = bf16[128,256]{1,0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = f32[512,256]{1,0} all-gather(%x), replica_groups=[2,8]<=[16], dimensions={0}
  %rs = f32[16,256]{1,0} reduce-scatter(%ag), replica_groups={{0,1}}, to_apply=%add
  %cp = bf16[64,64]{1,0} collective-permute(%x), source_target_pairs={{0,1}}
}
"""


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_events_of_the_synthetic_ops_give_the_reference_parsers_traffic():
    from repro.analysis.hlo import collective_traffic as jax_collective_traffic

    rec = traffic.Recorder()
    rec.collective("all-reduce", _meta((128, 256), torch.bfloat16), 4)
    rec.collective("all-gather", _meta((512, 256), torch.float32), 8)
    rec.collective("reduce-scatter", _meta((16, 256), torch.float32), 2)
    rec.collective("collective-permute", _meta((64, 64), torch.bfloat16), 2)
    got = traffic.collective_traffic(rec.events)
    want = jax_collective_traffic(SYNTHETIC_HLO)
    assert got["bytes_by_kind"] == want["bytes_by_kind"]
    assert got["count_by_kind"] == want["count_by_kind"]
    assert got["total_bytes"] == want["total_bytes"]
    # the ring model: all-reduce 2 size (n-1)/n, all-gather size (n-1)/n,
    # reduce-scatter size (n-1), permute size
    assert got["bytes_by_kind"]["all-reduce"] == 2 * 128 * 256 * 2 * 3 / 4
    assert got["bytes_by_kind"]["reduce-scatter"] == 16 * 256 * 4


def test_all_to_all_follows_the_ring_model():
    rec = traffic.Recorder()
    rec.collective("all-to-all", _meta((8, 4, 16), torch.float32), 4)
    got = traffic.collective_traffic(rec.events)
    assert got["bytes_by_kind"] == {"all-to-all": 8 * 4 * 16 * 4 * 3 / 4}
    with pytest.raises(ValueError, match="unknown collective"):
        traffic.collective_traffic([traffic.CollectiveEvent("broadcast", 4, 2)])


def test_the_recorder_is_off_outside_its_block_and_blocks_nest():
    assert traffic.ACTIVE is None
    with traffic.record() as outer:
        traffic.note_kernel("flash_attention")
        with traffic.record() as inner:
            traffic.note_kernel("ssd")
        assert traffic.ACTIVE is outer
    assert traffic.ACTIVE is None
    traffic.note_kernel("ssd")  # nothing records it
    assert dict(outer.kernels) == {"flash_attention": 1} and dict(inner.kernels) == {"ssd": 1}


def test_op_histogram_counts_products_convolutions_and_kernel_entries():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.dryrun import _step_meter

    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(3, 4, 5, generator=g), torch.randn(3, 5, 6, generator=g)
    x, w = torch.randn(1, 2, 9, generator=g), torch.randn(3, 2, 3, generator=g)
    q = torch.randn(1, 8, 2, 16, generator=g)
    with traffic.record() as rec, _step_meter(rec.ops, set()):  # the dry run's op meter
        torch.einsum("bij,bjk->bik", a, b)
        a[0] @ b[0]
        torch.nn.functional.conv1d(x, w)
        flash_attention(q, q, q, causal=True)  # the plain version on the CPU
    hist = traffic.op_histogram(rec)
    assert hist["dot"] >= 2 and hist["convolution"] == 1
    assert hist["custom-call"] == 1 and hist["kernels"] == {"flash_attention": 1}


# -- the gloo group: one rank's worker (torch and the port only) ----------------------


def _worker(rank: int, data: int, model_n: int, store: str, inputs: str, out: str,
            device_type: str = "cpu") -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.parallel.steps import build_train_step, make_ctx, shard_params

    dist.init_process_group("gloo", rank=rank, world_size=tpar.WORLD,
                            store=dist.FileStore(store, tpar.WORLD),
                            timeout=datetime.timedelta(seconds=60))
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    mesh = make_host_mesh(model_n, device_type="cpu")
    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    ocfg = AdamWConfig()
    spec = {"seq_len": S, "global_batch": B, "kind": "train"}
    step, _, _ = build_train_step(model, mesh, ocfg, cosine_schedule(3e-4, 10, 100),
                                  model.input_specs("train", spec))
    params = shard_params(model, model.init(0), mesh)
    opt = adamw_init(ocfg, params.tree(), ctx=make_ctx(mesh))
    with traffic.record() as rec:
        step(params, opt, inp["batch"], 10)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump({"events": [(e.kind, e.bytes, e.group_size) for e in rec.events]}, f)
    dist.barrier()
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_events(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("traffic_2x2")
    g = torch.Generator().manual_seed(3)
    batch = {"tokens": torch.randint(0, 512, (B, S), generator=g, dtype=torch.int32),
             "targets": torch.randint(0, 512, (B, S), generator=g, dtype=torch.int32)}
    inputs = str(tmp / "inputs.pkl")
    with open(inputs, "wb") as f:
        pickle.dump({"batch": batch}, f)
    return tpar._spawn(MESH, tmp, inputs, module="test_torch_traffic")["events"]


def test_a_gloo_steps_traffic_equals_the_fake_world_dry_run(gloo_events):
    from repro_torch.configs import get_reduced
    from repro_torch.launch.dryrun import run_cell

    cfg = get_reduced("tinyllama-1.1b").replace(dtype="float32")
    dry = run_cell(cfg, "train", {"kind": "train", "seq_len": S, "global_batch": B}, MESH,
                   verbose=False)
    real = traffic.collective_traffic(traffic.CollectiveEvent(*e) for e in gloo_events)
    assert set(real["count_by_kind"]) >= {"all-gather", "reduce-scatter", "all-reduce"}
    assert dry["collectives"]["count_by_kind"] == real["count_by_kind"]
    assert dry["collectives"]["bytes_by_kind"] == real["bytes_by_kind"]
    assert dry["collectives"]["total_bytes"] == real["total_bytes"]
    # an axis's group on (2, 2) has two ranks, the world's (the loss's sum) four
    assert {n for *_, n in gloo_events} == {2, 4}
