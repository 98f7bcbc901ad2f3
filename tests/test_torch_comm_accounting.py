"""The port's collective-bytes census against the JAX package's.

JAX's ``count_collective_bytes`` walks a traced program's jaxpr; the port's
runs the program once and converts what its mesh counted into JAX's
per-device received-bytes conventions (``comm_accounting.py:38-46`` of the
JAX package).  On the same shapes (a 4-shard mesh, 64·D nodes, 3 seeds a
shard, fanout (3, 3), SAGE hidden 16) the two agree exactly, collective by
collective, for the graph-sharded sample and for the graph-sharded train
and eval steps, backward included, with the broadcast and the compacted
exchanges; both equal ``sharded_sampling_comm_model``'s exchange bytes.
JAX reports its all-reduces as ``psum`` or ``psum_invariant`` (its
``shard_map`` autodiff), which the comparison counts as one.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from collections import Counter
from jax.sharding import PartitionSpec as P

import connectome_gnn_tpu.data as jd
import connectome_gnn_tpu.parallel as jp
from connectome_gnn_tpu.models.node_coo import BlockedNodeSAGE as JSAGE
from connectome_gnn_tpu.parallel import sharded_sampling as jss

import connectome_gnn_tpu_torch as tpk
import connectome_gnn_tpu_torch.data as td
import connectome_gnn_tpu_torch.parallel as tp
from connectome_gnn_tpu_torch.parallel import comm_accounting as tca
from connectome_gnn_tpu_torch.parallel import sharded_sampling as tss

D, S, FANOUT = 4, 3, (3, 3)
CONFIGS = {
    "broadcast": None,
    "compacted": dict(alpha=1.5, rounds=2),
    "compacted, one round": dict(alpha=1.0, rounds=1),
    "compacted, per-stage": dict(alpha=2.0, rounds=2, alpha_features=1.25, rounds_features=1),
}


def jax_named(counts: dict) -> dict:
    """JAX's counts with its all-reduce primitives under one name."""
    out = Counter()
    for k, v in counts.items():
        out["psum" if k.startswith("psum") else k] += v
    return dict(out)


@pytest.fixture(scope="module")
def setup(cpu_devices):
    jg = jd.generate_spatial_graph(64 * D, degree=5, band=24, seed=0, shortcut_frac=0.2)
    tg = td.generate_spatial_graph(64 * D, degree=5, band=24, seed=0, shortcut_frac=0.2)
    zeros = [np.zeros((D, S), np.int32), np.zeros((D, 2), np.uint32), np.zeros((D, S), np.int32),
             np.ones((D, S), bool)]
    jm = JSAGE(in_channels=5, hidden_dim=16, num_layers=2)
    params, state = jm.init(jax.random.PRNGKey(0))
    return dict(jsg=jp.ShardedGraphCSR.partition(jg, D),
                tsg=tss.ShardedGraphCSR.partition(tg, D, device="cpu"),
                jmesh=jp.create_mesh(devices=cpu_devices[:D]),
                tmesh=tp.create_mesh((D,), ("data",), device="cpu"),
                jargs=[jnp.asarray(a) for a in zeros],
                targs=[torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32 else a)
                       for a in zeros],
                jm=jm, params=params, state=state, F=jg.num_features)


@pytest.mark.parametrize("program", ["sample", "train step", "eval step"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_census_is_jaxs(setup, name, program):
    jcomp = None if CONFIGS[name] is None else jss.CompactionConfig(**CONFIGS[name])
    tcomp = None if CONFIGS[name] is None else tss.CompactionConfig(**CONFIGS[name])
    jmesh, tmesh, jsg, tsg = setup["jmesh"], setup["tmesh"], setup["jsg"], setup["tsg"]
    jargs, targs = setup["jargs"], setup["targs"]
    jm, params, state = setup["jm"], setup["params"], setup["state"]
    tm = tpk.NodeSAGE(5, 16, num_layers=2)
    if program == "sample":
        @jax.jit
        @partial(jax.shard_map, mesh=jmesh, in_specs=(P("data"),) * 3, out_specs=P("data"))
        def run(gs, sd, kd):
            b = jss.sharded_device_sample(gs, sd[0], jax.random.wrap_key_data(kd[0]), FANOUT,
                                          compaction=jcomp)
            return jnp.sum(b.node_features)[None]

        want = jp.count_collective_bytes(run, jsg, *jargs[:2])
        got = tp.count_collective_bytes(tmesh, tss.sharded_device_sample, tsg, *targs[:2],
                                        FANOUT, tmesh, compaction=tcomp)
    elif program == "train step":
        opt = optax.sgd(1.0)
        step = jp.make_graph_sharded_train_step(jm, opt, jmesh, FANOUT, compaction=jcomp)
        want = jp.count_collective_bytes(step, params, state, opt.init(params),
                                         jax.random.PRNGKey(0), jsg, *jargs)
        tstep = tp.make_graph_sharded_train_step(tm, torch.optim.SGD(tm.parameters(), lr=1.0),
                                                 tmesh, FANOUT, compaction=tcomp)
        got = tp.count_collective_bytes(tmesh, tstep, tsg, *targs)
    else:
        ev = jp.make_graph_sharded_eval_step(jm, jmesh, FANOUT, compaction=jcomp)
        want = jp.count_collective_bytes(ev, params, state, jsg, *jargs)
        got = tp.count_collective_bytes(tmesh, tp.make_graph_sharded_eval_step(
            tm, tmesh, FANOUT, compaction=tcomp), tsg, *targs)
    assert got == jax_named(want), (got, want)
    model = tp.sharded_sampling_comm_model(D=D, S=S, fanout=FANOUT, F=setup["F"],
                                           max_deg=max(tsg.max_in_degree, 3), compaction=tcomp)
    exchange = got.get("all_gather", 0) + got.get("all_to_all", 0)
    assert exchange == model["per_device_bytes_per_step"] == jp.sharded_sampling_comm_model(
        D=D, S=S, fanout=FANOUT, F=setup["F"], max_deg=max(jsg.max_in_degree, 3),
        compaction=jcomp)["per_device_bytes_per_step"]


def test_conventions_and_counters():
    """The per-device conventions on a mesh of 4 shards in one rank, and a
    count leaves the mesh's counters as a plain call would."""
    mesh = tp.create_mesh((4,), ("data",), device="cpu")
    x = torch.zeros(4, 4, 10)  # a shard's operand: 4 x 10 float32 = 160 B
    got = tp.count_collective_bytes(mesh, lambda: (mesh.all_gather(x), mesh.all_to_all(x, "data"),
                                                   mesh.psum(x), mesh.pmax(x),
                                                   mesh.shift(x, "data", 1)))
    assert got == {"all_gather": 160 * 3, "all_to_all": 120, "psum": 240, "pmax": 240,
                   "ppermute": 120, "total": 480 + 120 + 240 + 240 + 120}
    assert mesh.bytes_moved["all_gather"] == 4 * 160 and mesh.calls["psum"] == 1
    assert tca.received_bytes(tp.create_mesh((1,), ("data",), device="cpu"),
                              Counter(psum=64)) == {"total": 0}
    with pytest.raises(ValueError, match="no convention"):
        tca.received_bytes(mesh, Counter(probe=4))
