"""The port's sharding rules against the reference's, on stand-in meshes
(no devices): ``rules_for``, ``spec_for``, ``param_specs``, ``zero_spec(s)``
and ``estimate_padding_waste`` for every arch at full size on (16, 16),
(2, 4) and (1, 1), and ``Model.logical_axes`` against the reference's tree.

The reference stacks a layer group's layers under a leading ``layers`` dim
where the port keeps one leaf per layer: a port leaf ``layers.s0.3.attn.wq``
is compared with the reference's ``layers.s0.attn.wq`` minus its first
entry. ZeRO specs are taken on each package's own leaf, so they differ
exactly where the reference's lands the data axis on the stacked leaf's
``layers`` dim; those leaves are listed by name.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.parallel import sharding as jsh
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.parallel import sharding as tsh
from repro_torch.tree import tree_flatten_with_keys

torch.set_num_threads(1)


class FakeMesh:
    """Just enough of a mesh for the spec functions (its shape)."""

    def __init__(self, **shape):
        self.shape = shape


MESHES = {"16x16": FakeMesh(data=16, model=16), "2x4": FakeMesh(data=2, model=4),
          "1x1": FakeMesh(data=1, model=1)}


def _stacked_key(key: str) -> str:
    """``layers.s0.3.attn.wq`` -> ``layers.s0.attn.wq`` (the reference's)."""
    parts = key.split(".")
    if parts[0] in ("layers", "enc_layers") and len(parts) > 2 and parts[2].isdigit():
        return ".".join(parts[:2] + parts[3:])
    return key


def _ref_flat(tree, is_leaf=None) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {".".join(str(p.key) for p in path): v for path, v in flat}


def _stacked(key: str) -> bool:
    return _stacked_key(key) != key


@pytest.fixture(scope="module")
def models():
    return {arch: (jax_build_model(jax_get_config(arch)), build_model(get_config(arch),
                                                                       device="cpu"))
            for arch in ARCH_NAMES}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_logical_axes_match_reference(models, arch):
    jm, tm = models[arch]
    ref = _ref_flat(jm.logical_axes(), is_leaf=lambda x: isinstance(x, tuple))
    port = tree_flatten_with_keys(tm.logical_axes())
    shapes = dict(tree_flatten_with_keys(tm.abstract_params()))
    ref_shapes = _ref_flat(jm.abstract_params())
    assert {_stacked_key(k) for k, _ in port} == set(ref)
    for key, axes in port:
        want = ref[_stacked_key(key)]
        want_shape = tuple(ref_shapes[_stacked_key(key)].shape)
        if _stacked(key):
            assert want[0] == "layers", key
            want, want_shape = want[1:], want_shape[1:]
        assert tuple(axes) == tuple(want), key
        assert tuple(shapes[key].shape) == want_shape, key
        assert shapes[key].device.type == "meta"


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rules_match_reference(arch):
    assert tsh.rules_for(get_config(arch)) == jsh.rules_for(jax_get_config(arch))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_reference(models, arch, mesh):
    jm, tm = models[arch]
    fm = MESHES[mesh]
    ref = _ref_flat(jsh.param_specs(jm.abstract_params(), jm.logical_axes(),
                                    jsh.rules_for(jm.cfg), fm), is_leaf=lambda x: isinstance(x, P))
    port = tree_flatten_with_keys(tsh.param_specs(tm.abstract_params(), tm.logical_axes(),
                                                  tsh.rules_for(tm.cfg), fm))
    assert len(port) == len(tree_flatten_with_keys(tm.abstract_params()))
    for key, spec in port:
        want = tuple(ref[_stacked_key(key)])
        if _stacked(key):
            assert want[0] is None, key  # the layers dim is never sharded
            want = want[1:]
        want = want + (None,) * (len(spec) - len(want))
        assert tuple(spec) == want, key


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_zero_specs_match_reference(models, arch, mesh):
    jm, tm = models[arch]
    fm = MESHES[mesh]
    jspecs = jsh.param_specs(jm.abstract_params(), jm.logical_axes(), jsh.rules_for(jm.cfg), fm)
    ref = _ref_flat(jsh.zero_specs(jspecs, jm.abstract_params(), fm, ("data",)),
                    is_leaf=lambda x: isinstance(x, P))
    tspecs = tsh.param_specs(tm.abstract_params(), tm.logical_axes(), tsh.rules_for(tm.cfg), fm)
    port = tree_flatten_with_keys(tsh.zero_specs(tspecs, tm.abstract_params(), fm, ("data",)))
    on_layers = set()  # the reference's data axis on a stacked leaf's layers dim
    for key, spec in port:
        want = tuple(ref[_stacked_key(key)])
        if _stacked(key):
            if want[0] is not None:
                on_layers.add(_stacked_key(key))
                continue
            want = want[1:]
        want = want + (None,) * (len(spec) - len(want))
        assert tuple(spec) == want, key
    assert on_layers == ZERO_ON_LAYERS.get((arch, mesh), set())


def _names(groups: str, leaves: str) -> set:
    return {f"{g}.{leaf}" for g in groups.split() for leaf in leaves.split()}


_NORMS = "attn_norm.w mlp_norm.w"
_MAMBA = "ssm.a_log ssm.conv_b ssm.conv_w ssm.d_skip ssm.dt_bias ssm.norm ssm_norm.w"
_WHISPER = (_names("enc_layers.s0", "attn_norm.b attn_norm.w mlp.b1 mlp.b2 mlp_norm.b "
                   "mlp_norm.w")
            | _names("layers.s0", "attn_norm.b attn_norm.w cross_norm.b cross_norm.w mlp.b1 "
                     "mlp.b2 mlp_norm.b mlp_norm.w"))
# the stacked leaves whose reference ZeRO spec puts the data axis on the
# layers dim (the largest replicated dim it divides); each of the port's
# per-layer leaves of these takes its own ZeRO spec on its own shape
ZERO_ON_LAYERS = {
    **{(arch, mesh): _names("layers.s0", _NORMS)
       for arch in ("deepseek-coder-33b", "tinyllama-1.1b", "qwen1.5-4b", "paligemma-3b",
                    "granite-moe-1b-a400m") for mesh in ("2x4", "1x1")},
    **{("phi4-mini-3.8b", mesh): _names("layers.s0", _NORMS) for mesh in MESHES},
    ("hymba-1.5b", "2x4"): _names("layers.s1", _NORMS + " " + _MAMBA + " ssm.in_proj"),
    ("hymba-1.5b", "1x1"): _names("layers.s1 layers.s3", _NORMS + " " + _MAMBA),
    **{("whisper-medium", mesh): _WHISPER for mesh in ("2x4", "1x1")},
    ("deepseek-v2-236b", "1x1"): _names("layers.s0 layers.s1",
                                        _NORMS + " attn.kv_norm attn.q_norm"),
    **{("mamba2-1.3b", mesh): _names("layers.s0", _MAMBA) for mesh in MESHES},
}


# -- the reference's unit cases, ported -------------------------------------------------


def test_divisible_dims_shard_on_preferred_axis():
    rules = tsh.rules_for(get_config("tinyllama-1.1b"))
    mesh = MESHES["16x16"]
    assert tsh.spec_for(("embed", "mlp"), (2048, 5632), rules, mesh) == (None, "model")
    assert tsh.spec_for(("vocab", "embed"), (32000, 2048), rules, mesh) == ("model", None)


def test_awkward_dims_fall_back_to_row_parallel():
    rules = tsh.rules_for(get_config("tinyllama-1.1b"))
    mesh = MESHES["16x16"]
    assert tsh.spec_for(("embed", "heads", None), (7168, 56, 128), rules, mesh) == (
        "model", None, None)
    spec = tsh.spec_for(("layers", "heads", None), (62, 56, 128), rules, mesh)
    assert spec == (None, None, "model")


def test_zero_spec_adds_data_axis_once():
    mesh = MESHES["16x16"]
    assert tsh.zero_spec((None, "model"), (4096, 5632), mesh, ("data",)) == ("data", "model")
    z2 = tsh.zero_spec(("model", None, "data"), (160, 5120, 1536), mesh, ("data",))
    assert z2.count("data") == 1


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_padding_waste_matches_reference(models, arch, mesh):
    jm, tm = models[arch]
    fm = MESHES[mesh]
    jspecs = jsh.param_specs(jm.abstract_params(), jm.logical_axes(), jsh.rules_for(jm.cfg), fm)
    tspecs = tsh.param_specs(tm.abstract_params(), tm.logical_axes(), tsh.rules_for(tm.cfg), fm)
    want = jsh.estimate_padding_waste(jm.abstract_params(), jspecs, fm)
    got = tsh.estimate_padding_waste(tm.abstract_params(), tspecs, fm)
    assert got == want


def test_padding_waste_estimator():
    class Leaf:
        shape = (56, 128)
        dtype = np.dtype("float32")

    waste = tsh.estimate_padding_waste({"w": Leaf()}, {"w": ("model", None)}, MESHES["16x16"])
    assert waste["waste_frac"] == pytest.approx(8 / 56)


def test_placements_map_specs_to_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard

    class NamedMesh:
        mesh_dim_names = ("data", "model")

    mesh = NamedMesh()
    assert tsh.placements((None, "model"), mesh) == [Replicate(), Shard(1)]
    assert tsh.placements(("model", None, "data"), mesh) == [Shard(2), Shard(0)]
    assert tsh.placements((), mesh) == [Replicate(), Replicate()]
    sh = tsh.shardings({"a": ("data",), "b": [(None, "model")]}, mesh)
    assert sh["a"].placements() == [Shard(0), Replicate()]
    assert sh["b"][0].spec == (None, "model")
