"""The port's logical-axis sharding (``utils.sharding``, the models' spec
trees and ``launch.specs``) against the JAX package's, exactly, on stub
meshes that carry only ``shape`` and ``axis_names``.

For all ten configs at full width, the port's spec tree (``model_specs``)
equals the reference's (``init_model``'s second output, through
``jax.eval_shape``: nothing is allocated) leaf for leaf, the port's meta
shapes equal the reference's, and ``resolve_spec`` of every leaf equals
the reference's ``PartitionSpec`` on the meshes 1x1, 4x1, 1x4, 2x2, 2x4,
16x16 and 2x16x16 (``pod``); so do both ``cache_logical_specs`` tables
over each config's dense and clustered decode caches, and ``BATCH_SPECS``.
Placements follow a resolved spec row-major, and ``abstract_state`` and
``decode_inputs_specs`` give the reference's shapes.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as jbase
from repro.launch import specs as jspecs
from repro.models import model as JM
from repro.utils import sharding as jshd
from repro_torch.configs import base as tbase
from repro_torch.launch import specs as tspecs
from repro_torch.models import model as TM
from repro_torch.utils import sharding as shd
from repro_torch.utils.tree import tree_leaves

ARCHS = sorted(jbase.all_configs())


class Stub:
    """A mesh as both resolvers read it: named axes and their sizes."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, shape))


MESHES = {"1x1": Stub((1, 1), ("data", "model")),
          "4x1": Stub((4, 1), ("data", "model")),
          "1x4": Stub((1, 4), ("data", "model")),
          "2x2": Stub((2, 2), ("data", "model")),
          "2x4": Stub((2, 4), ("data", "model")),
          "16x16": Stub((16, 16), ("data", "model")),
          "2x16x16": Stub((2, 16, 16), ("pod", "data", "model"))}


def _jax_specs(arch):
    captured = {}

    def build(k):
        p, s = JM.init_model(k, jbase.get_config(arch), max_pos=64)
        captured["s"] = s
        return p
    shapes = jax.eval_shape(build, jax.random.PRNGKey(0))
    return captured["s"], shapes


def _pairs(spec_tree, shape_tree):
    """(spec, shape) of every leaf of the reference's trees."""
    is_spec = lambda x: isinstance(x, tuple) and all(      # noqa: E731
        isinstance(e, (str, type(None))) for e in x)
    specs = jax.tree_util.tree_leaves(spec_tree, is_leaf=is_spec)
    shapes = jax.tree_util.tree_leaves(shape_tree)
    assert len(specs) == len(shapes)
    return [(s, tuple(x.shape)) for s, x in zip(specs, shapes)]


def _same_resolution(pairs):
    for name, mesh in MESHES.items():
        rules = jshd.rules_for_mesh(mesh)
        assert shd.rules_for_mesh(mesh) == rules, name
        for spec, shape in pairs:
            want = tuple(jshd.resolve_spec(spec, shape, mesh, rules))
            assert shd.resolve_spec(spec, shape, mesh) == want, (
                name, spec, shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_trees_and_their_resolution_match_the_reference(arch):
    jspec, jshapes = _jax_specs(arch)
    tcfg = tbase.get_config(arch)
    assert TM.model_specs(tcfg) == jspec
    meta = TM.init_model(tcfg, device="meta", max_pos=64)
    assert [tuple(t.shape) for t in tree_leaves(meta)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jshapes)]
    assert all(t.device.type == "meta" for t in tree_leaves(meta))
    _same_resolution(_pairs(jspec, jshapes))


@pytest.mark.parametrize("mode", ["dense", "clustered"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, mode):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    if mode == "clustered" and jcfg.family == "ssm":
        mode = "dense"          # the reference's decode_mode_for
    jc = jax.eval_shape(lambda: JM.init_decode_caches(
        jcfg, 2, 4096, mode=mode, dtype=jnp.bfloat16))
    tc = TM.init_decode_caches(tcfg, 2, 4096, mode=mode, device="meta")
    assert [tuple(t.shape) for t in tree_leaves(tc)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jc)]
    for shardable in (True, False):
        want = jspecs.cache_logical_specs(jc, shardable)
        got = tspecs.cache_logical_specs(tc, shardable)
        is_spec = lambda x: isinstance(x, tuple) and all(  # noqa: E731
            isinstance(e, (str, type(None))) for e in x)
        got_leaves = jax.tree_util.tree_leaves(got, is_leaf=is_spec)
        assert got_leaves == jax.tree_util.tree_leaves(want,
                                                       is_leaf=is_spec)
        _same_resolution(_pairs(want, jc))


def test_the_tables_and_the_batch_specs_match_the_reference():
    assert tspecs.BATCH_SPECS == jspecs.BATCH_SPECS
    for shardable in (True, False):
        assert tspecs._cache_leaf_specs(shardable) == \
            jspecs._cache_leaf_specs(shardable)
    assert shd.DEFAULT_RULES == jshd.DEFAULT_RULES
    pairs = [(s, (8, 4096, 64)[:len(s)]) for s in jspecs.BATCH_SPECS.values()]
    pairs += [(s, (6, 5, 3)[:len(s)]) for s in jspecs.BATCH_SPECS.values()]
    _same_resolution(pairs)
    for arch in ARCHS:
        jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
        for shape in jbase.SHAPES.values():
            assert tspecs.decode_mode_for(tcfg, tbase.SHAPES[shape.name]) \
                == jspecs.decode_mode_for(jcfg, shape)


def test_placements_are_row_major_in_mesh_dim_order():
    mesh = MESHES["2x16x16"]
    assert shd.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert shd.placements((None,), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError, match="dim order"):
        shd.placements((("data", "pod"),), mesh)
    tree = {"a": ("model", None), "b": [((None, "data"))]}
    assert shd.named_tree(tree, MESHES["2x4"]) == {
        "a": [Replicate(), Shard(0)], "b": [[Shard(1), Replicate()]]}


def test_constrain_is_the_identity_without_a_mesh_or_a_dtensor():
    x = torch.ones(2, 3)
    assert shd.constrain(x, None, "dp", None) is x
    assert shd.constrain(x, MESHES["2x2"], "dp", None) is x
    assert shd.gather(x) is x


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-base",
                                  "zamba2-7b"])
def test_abstract_state_and_decode_inputs_have_the_reference_shapes(arch):
    jcfg, tcfg = jbase.get_config(arch), tbase.get_config(arch)
    mesh = MESHES["16x16"]
    p, psh, o, osh = tspecs.abstract_state(tcfg, mesh, max_pos=64,
                                           params_dtype=torch.bfloat16)
    _, jshapes = _jax_specs(arch)
    assert [tuple(t.shape) for t in tree_leaves(p)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jshapes)]
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(p))
    want = shd.named_tree(shd.resolve_tree(TM.model_specs(tcfg), p, mesh),
                          mesh)
    assert psh == want and osh["m"] == want and osh["v"] == want
    assert osh["count"] == [Replicate(), Replicate()]
    assert tuple(o["count"].shape) == () and o["count"].dtype == torch.int32
    shape = tbase.SHAPES["decode_32k"]
    tok, tok_sh, caches, cache_sh, cross, cross_sh = \
        tspecs.decode_inputs_specs(tcfg, shape, mesh, mode="dense")
    assert tuple(tok.shape) == (shape.global_batch, 1)
    assert tok_sh == shd.placements(shd.resolve_spec(
        ("dp", None), (shape.global_batch, 1), mesh), mesh)
    jc = jax.eval_shape(lambda: JM.init_decode_caches(
        jcfg, shape.global_batch, shape.seq_len, mode="dense",
        dtype=jnp.bfloat16))
    assert [tuple(t.shape) for t in tree_leaves(caches)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jc)]
    assert (cross is None) == (not jcfg.cross_attention)
    batch, bsh = tspecs.train_batch_specs(tcfg, tbase.SHAPES["train_4k"],
                                          mesh)
    for k, (shp, _) in batch.items():
        assert bsh[k] == shd.placements(shd.resolve_spec(
            tspecs.BATCH_SPECS[k], shp, mesh), mesh)
