"""The port's mesh rules (``bayeslms_tpu_torch.parallel.mesh``) against the
JAX package's ``parallel/mesh.py``, with no processes: ``param_spec`` on
every parameter of four models at tp 1, 2 and 4, the rank grid against
``make_mesh``'s device order, and each rank's block of a (T, B) batch and
an (L, B, H) state against the shards JAX places on that device."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bayeslms_tpu as jx
import bayeslms_tpu_torch as bt
from bayeslms_tpu.core.registry import build_model as j_build_model
from bayeslms_tpu.core.registry import init_params as j_init_params
from bayeslms_tpu.parallel import mesh as jmesh
from bayeslms_tpu_torch.parallel import mesh as tmesh

MODELS = {
    "lstm": dict(model="LSTM"),
    "bayes-lstm": dict(model="LSTM", uncertainty="Bayesian", l_bayes_pos=3),
    "gp-lstm": dict(model="LSTM", uncertainty="Gaussian", l_gauss_pos="13"),
    "bayes-ffn-tm": dict(model="Transformer", nhead=2,
                         uncertainty="Bayesian", t_bayes_pos="FFN"),
}


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(np.shape(v))


@functools.lru_cache(maxsize=None)
def _trees(name):
    kw = dict(vocab_size=24, emsize=8, nhid=8, nlayers=2, **MODELS[name])
    if kw["model"] == "Transformer":
        kw["nhid"] = 16
    jcfg, tcfg = jx.ModelConfig(**kw), bt.ModelConfig(**kw)
    return (j_init_params(j_build_model(jcfg), jcfg, seed=0),
            bt.init_params(bt.build_model(tcfg), tcfg, seed=0))


@pytest.mark.parametrize("tp", [1, 2, 4])
@pytest.mark.parametrize("name", list(MODELS))
def test_param_spec_matches_jax(name, tp):
    jtree, ttree = _trees(name)
    jpaths, tpaths = dict(_paths(jtree)), dict(_paths(ttree))
    assert jpaths == tpaths
    specs = tmesh.params_specs(tp, ttree)
    split = 0
    for path, shape in jpaths.items():
        ref = tuple(jmesh.param_spec(path, shape, tp))
        got = tmesh.param_spec(path, shape, tp)
        assert got == ref, (path, got, ref)
        node = specs
        for k in path:
            node = node[k]
        assert node == ref
        split += bool(ref)
    # something splits at tp > 1 (the vocabulary, the gate rows)
    assert (split > 0) == (tp > 1)


@pytest.mark.parametrize("dp,tp", [(1, 1), (2, 2), (4, 2), (2, 4), (8, 1)])
def test_rank_grid_is_make_mesh_device_order(dp, tp):
    m = jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    ids = np.vectorize(lambda d: d.id)(m.devices)
    np.testing.assert_array_equal(tmesh.rank_grid(dp, tp), ids)


@pytest.mark.parametrize("dp,tp", [(4, 2), (2, 2), (8, 1)])
def test_rank_blocks_match_jax_shards(dp, tp):
    """Each rank's block of a (T, B) batch (``batch_sharding``), an (L, B,
    H) state (``hidden_sharding``) and of the dp x tp split of the tp
    step's columns equals the shard JAX places on that rank's device."""
    T, B, L, H = 3, 16, 2, 5
    x = np.arange(T * B).reshape(T, B).astype(np.float32)
    h = np.arange(L * B * H).reshape(L, B, H).astype(np.float32)
    m = jmesh.make_mesh(dp=dp, tp=tp, devices=jax.devices()[:dp * tp])
    from jax.sharding import NamedSharding, PartitionSpec as P
    placed = {
        "batch": (jax.device_put(jnp.asarray(x), jmesh.batch_sharding(m)), x,
                  "dp", 1),
        "hidden": (jax.device_put(jnp.asarray(h), jmesh.hidden_sharding(m)),
                   h, "dp", 1),
        "tp step": (jax.device_put(jnp.asarray(x), NamedSharding(
            m, P(None, ("dp", "tp")))), x, "all", 1),
    }
    for what, (arr, host, axis, dim) in placed.items():
        shards = {s.device.id: np.asarray(s.data)
                  for s in arr.addressable_shards}
        for rank in range(dp * tp):
            mesh = tmesh.Mesh(dp=dp, tp=tp, rank=rank,
                              device=torch.device("cpu"), backend="gloo")
            t = torch.from_numpy(host)
            got = tmesh.hidden_rows(mesh, t) if what == "hidden" else \
                tmesh.batch_columns(mesh, t, axis, dim)
            np.testing.assert_array_equal(got.numpy(), shards[rank],
                                          err_msg=f"{what} rank {rank}")
    assert tmesh.replicated() == tuple(jmesh.replicated(m).spec)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh(dp=2)
