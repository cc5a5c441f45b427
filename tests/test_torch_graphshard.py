"""Graph-dimension sharding (``hydragnn_tpu_torch/parallel/graphshard.py``
and ``drivers/giant_graph.py``) against the JAX package, on the CPU.

The port's D "devices" are the ranks of a process group. One
module-scoped spawn of four gloo ranks (``tests/_torch_graphshard_worker.py``,
torch and the port only) runs every sharded case on graph axes over
ranks {0, 1} (D = 2) and over all four (D = 4), and the driver's CLI runs
beside it, while this process computes the JAX side with the jitted
single-device ``reference_mpnn_forward`` (tests/test_graphshard.py holds
the JAX package's sharded forwards equal to it; compiling those here
would take minutes).

- the host builds (``GraphShards``, ``HaloShards``, ``union_layout``,
  the layout errors) equal the JAX package's element for element at D =
  2, 4 and 8, from one ``edge_index`` (the port's numpy radius graph);
- both sharded forwards at D = 2 and 4, with and without ring attention,
  on test_graphshard.py's two geometries (the 200-node box, seed 0; the
  240-node z-sorted slab, seed 3; cutoff 2.5, 12 Gaussians, 2 layers,
  hidden 16): energy, forces and summed parameter gradients within
  tests/test_graphshard.py's tolerances of JAX's reference;
- every collective's forward and backward, the replicated psum giving
  each rank's share a gradient of 1 (not D);
- the driver: three Adam steps of its train step at D = 2 in both
  schemes against ``reference_mpnn_forward`` + ``optax.adam(3e-3)``; its
  CLI on two CPU ranks; its data against examples/giant_graph/giant.py's.
"""

import importlib.util
import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import tests._cpu  # noqa: F401

import jax
import jax.numpy as jnp
import optax

from hydragnn_tpu.parallel import graphshard as J

from hydragnn_tpu_torch.drivers import giant_graph as gg
from hydragnn_tpu_torch.ops.neighbors import radius_graph
from hydragnn_tpu_torch.parallel import graphshard as T
from hydragnn_tpu_torch.parallel.mesh import make_mesh

from tests import _torch_graphshard_worker as worker

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
WORLD = 4
GRAD_TOL = dict(rtol=1e-4, atol=1e-3)  # f32 gradients and updated parameters
CLI = ["--ranks", "2", "--device", "cpu", "--atoms", "125", "--configs", "6", "--epochs", "2",
       "--halo"]
DRIVER = dict(atoms=64, configs=3, cutoff=3.2, hidden=32, heads=2)
# The attention key bias adds q . b_k to every score of a query, which the
# softmax cancels: its true gradient is 0, and both packages return
# rounding noise there (the port's ring attention ~3e-5 of the largest
# gradient, JAX's dense reference ~2e-8), which Adam turns into steps of
# +-lr in either direction.
ZERO_GRAD = re.compile(r"attn_\d+/k/b")
NOISE = 1e-4  # rounding noise of a zero gradient, relative to the largest


def _geometries():
    """tests/test_graphshard.py's two structures: (x, pos, edge_index)."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 8.0, (200, 3)).astype(np.float32)
    x = rng.normal(size=(200, 4)).astype(np.float32)
    box = (x, pos, radius_graph(pos, worker.CUTOFF, max_neighbours=24))
    rng = np.random.default_rng(3)
    pos = (rng.uniform(0, 1.0, (240, 3)) * np.array([6.0, 6.0, 24.0])).astype(np.float32)
    pos = pos[np.argsort(pos[:, 2])]
    x = rng.normal(size=(240, 4)).astype(np.float32)
    slab = (x, pos, radius_graph(pos, worker.CUTOFF, max_neighbours=24))
    return {"box": box, "slab": slab}


GEOMS = _geometries()


def _plain(tree):
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _flat(tree, prefix=""):
    """``{path: array}`` with ``/``-joined paths (``graphshard.param_items``'s)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jax_params():
    return {0: J.init_params(jax.random.PRNGKey(0), worker.IN_DIM, worker.HIDDEN,
                             worker.LAYERS, worker.NG),
            2: J.init_params(jax.random.PRNGKey(3), worker.IN_DIM, worker.HIDDEN,
                             worker.LAYERS, worker.NG, attn_heads=2)}


def _reference(params, geom, heads):
    """JAX's single-device energy, forces and parameter gradients."""
    x, pos, ei = geom
    s = J.GraphShards.build(x, pos, ei, 1)

    def energy(p, pos):
        return J.reference_mpnn_forward(
            p, s.x, pos, s.node_mask, s.senders, s.receivers, s.edge_mask,
            cutoff=worker.CUTOFF, num_gaussians=worker.NG, num_layers=worker.LAYERS,
            attn_heads=heads)

    e, (g_p, g_pos) = jax.jit(jax.value_and_grad(energy, argnums=(0, 1)))(params, s.pos)
    return {"e": float(e), "forces": -np.asarray(g_pos), "grads": _flat(g_p)}


def _driver_inputs():
    configs, edge_cap = gg.build_configs(DRIVER["atoms"], DRIVER["configs"], DRIVER["cutoff"])
    energies = np.array([c[2] for c in configs], np.float32)
    params = J.init_params(jax.random.PRNGKey(0), 1, DRIVER["hidden"], gg.NUM_LAYERS,
                           gg.NUM_GAUSSIANS, attn_heads=DRIVER["heads"])
    return dict(configs=configs, edge_cap=edge_cap, e_mean=float(energies.mean()),
                e_std=float(energies.std() + 1e-6), params=params, cutoff=DRIVER["cutoff"],
                heads=DRIVER["heads"])


def _driver_reference(drv):
    """Three steps of JAX's reference + optax.adam(3e-3) on one device."""
    x0 = np.ones((DRIVER["atoms"], 1), np.float32)
    shards = [J.GraphShards.build(x0, pos, ei, 1, edge_capacity=drv["edge_cap"])
              for pos, ei, _ in drv["configs"]]

    def loss_fn(p, x, pos, nm, snd, rcv, em, tgt):
        e = J.reference_mpnn_forward(p, x, pos, nm, snd, rcv, em, cutoff=drv["cutoff"],
                                     num_gaussians=gg.NUM_GAUSSIANS,
                                     num_layers=gg.NUM_LAYERS, attn_heads=drv["heads"])
        return ((e - (tgt - drv["e_mean"])) / drv["e_std"]) ** 2

    vg = jax.jit(jax.value_and_grad(loss_fn))
    tx = optax.adam(3e-3)
    params = drv["params"]
    state = tx.init(params)
    losses = []
    for i, s in enumerate(shards):
        loss, g = vg(params, s.x, s.pos, s.node_mask, s.senders, s.receivers, s.edge_mask,
                     jnp.asarray(drv["configs"][i][2]))
        updates, state = tx.update(g, state)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return losses, _flat(params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' outputs and the CLI run (spawned first), and the
    JAX references (computed meanwhile)."""
    torch.set_num_threads(1)
    work = tmp_path_factory.mktemp("graphshard_ranks")
    params = _jax_params()
    drv = _driver_inputs()
    torch.save({"geoms": GEOMS, "params": {h: _plain(p) for h, p in params.items()},
                "driver": dict(drv, params=_plain(drv["params"]))}, str(work / "inputs.pt"))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_graphshard_worker.py"), str(r), str(WORLD),
         str(work)], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    procs.append(subprocess.Popen([sys.executable, "-m", "hydragnn_tpu_torch.drivers.giant_graph",
                                   *CLI], cwd=str(work), env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT))
    try:
        want = {(g, h): _reference(params[h], GEOMS[g], h) for g in GEOMS for h in (0, 2)}
        want["driver"] = _driver_reference(drv)
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r in range(WORLD):
        assert procs[r].returncode == 0, f"rank {r} failed:\n{logs[r][-4000:]}"
    got = [torch.load(str(work / f"out{r}.pt"), weights_only=False) for r in range(WORLD)]
    return types.SimpleNamespace(got=got, want=want, cli=(procs[-1].returncode, logs[-1]),
                                 start=_flat(drv["params"]))


# ----------------------------------------------------------------------
# The host builds, in this process
# ----------------------------------------------------------------------

GRAPH_FIELDS = ("x", "pos", "node_mask", "senders", "receivers", "edge_mask")
HALO_FIELDS = GRAPH_FIELDS[:3] + ("senders_halo", "receivers_local", "edge_mask", "send_idx")


def _assert_same(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert got.num_nodes_padded == want.num_nodes_padded


def _perturbed(geom, seed, n=3):
    """``n`` thermal copies of a geometry, each with its own radius graph
    (so their halo needs differ)."""
    x, pos, _ = geom
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        p = (pos + rng.normal(scale=0.15, size=pos.shape)).astype(np.float32)
        out.append((x, p, radius_graph(p, worker.CUTOFF, max_neighbours=24)))
    return out


@pytest.mark.parametrize("d", [2, 4, 8])
def test_graph_shards_build_matches_jax(d):
    for x, pos, ei in GEOMS.values():
        for cap in (None, ei.shape[1] + 13):
            _assert_same(T.GraphShards.build(x, pos, ei, d, edge_capacity=cap),
                         J.GraphShards.build(x, pos, ei, d, edge_capacity=cap), GRAPH_FIELDS)


def test_edge_capacity_too_small_raises():
    x, pos, ei = GEOMS["box"]
    with pytest.raises(ValueError) as want:
        J.GraphShards.build(x, pos, ei, 2, edge_capacity=ei.shape[1] - 1)
    with pytest.raises(ValueError, match="exceed edge_capacity") as got:
        T.GraphShards.build(x, pos, ei, 2, edge_capacity=ei.shape[1] - 1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_halo_shards_build_matches_jax(d):
    """Probes, their union layout, the rebuild on it, and the static
    numbers, on both geometries (the box unsorted: up to D - 1 hops)."""
    for g, geom in GEOMS.items():
        cfgs = [geom] + _perturbed(geom, seed=len(g))
        t_probes = [T.HaloShards.build(x, p, ei, d) for x, p, ei in cfgs]
        j_probes = [J.HaloShards.build(x, p, ei, d) for x, p, ei in cfgs]
        for t, j in zip(t_probes, j_probes):
            _assert_same(t, j, HALO_FIELDS)
            assert (t.layout, t.n_loc, t.halo_rows, t.n_shards) == (
                j.layout, j.n_loc, j.halo_rows, j.n_shards)
        layout = T.HaloShards.union_layout(t_probes)
        assert layout == J.HaloShards.union_layout(j_probes)
        for x, p, ei in cfgs:
            t = T.HaloShards.build(x, p, ei, d, layout=layout)
            _assert_same(t, J.HaloShards.build(x, p, ei, d, layout=layout), HALO_FIELDS)
            assert t.layout == layout


@pytest.mark.parametrize("which", ["e_loc", "hop", "cap"])
def test_halo_layout_errors_match_jax(which):
    x, pos, ei = GEOMS["slab"]
    e_loc, hops, caps = T.HaloShards.build(x, pos, ei, 4).layout
    assert hops == (0, 2)
    layout = {"e_loc": (e_loc - 8, hops, caps), "hop": (e_loc, hops[1:], caps[1:]),
              "cap": (e_loc, hops, (caps[0] - 8,) + caps[1:])}[which]
    with pytest.raises(ValueError) as want:
        J.HaloShards.build(x, pos, ei, 4, layout=layout)
    with pytest.raises(ValueError, match="layout") as got:
        T.HaloShards.build(x, pos, ei, 4, layout=layout)
    assert str(got.value) == str(want.value)


def test_halo_memory_model():
    """tests/test_graphshard.py:243-250 on the port's build: on the
    z-sorted slab over 8 ranks a layer materializes under half the rows
    of the all-gather path, with at most 2 hops."""
    x, pos, ei = GEOMS["slab"]
    halo = T.HaloShards.build(x, pos, ei, 8)
    assert halo.halo_rows < halo.num_nodes_padded / 2
    assert len(halo.hops) <= 2
    assert (halo.halo_rows, halo.hops, halo.caps) == (94, (0, 6), (32, 32))


def test_make_mesh_graph_axis(monkeypatch):
    with pytest.raises(ValueError, match="stands alone"):
        make_mesh({"graph": 2, "data": 1})
    with pytest.raises(ValueError, match="graph alone"):
        make_mesh({"model": 2})
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh({"graph": 2})


def test_morse_energy_and_configs_match_giant():
    """The driver's blockwise Morse sum (rtol 1e-12 of giant.py's [N, N, 3]
    one) and its configurations: the same positions, energies and edges
    (as sets: the JAX package's radius graph may list them in another
    order)."""
    spec = importlib.util.spec_from_file_location(
        "giant", os.path.join(REPO, "examples", "giant_graph", "giant.py"))
    giant = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(giant)
    pos = np.random.default_rng(5).uniform(0, 12.0, (300, 3))
    for block in (7, 512):
        np.testing.assert_allclose(gg._morse_energy(pos, block), giant._morse_energy(pos),
                                   rtol=1e-12)
    got, got_cap = gg.build_configs(64, 2, 3.2)
    want, want_cap = giant.build_configs(64, 2, 3.2)
    assert got_cap == want_cap
    for (p, ei, e), (wp, wei, we) in zip(got, want):
        assert np.array_equal(p, wp)
        np.testing.assert_allclose(e, we, rtol=1e-12)
        assert set(map(tuple, ei.T)) == set(map(tuple, np.asarray(wei).T))


# ----------------------------------------------------------------------
# The ranks
# ----------------------------------------------------------------------


def test_ranks_load_no_jax_and_take_their_places(ranks):
    """The ranks imported graphshard and the driver and loaded no jax,
    flax, optax or hydragnn_tpu module; ranks 2 and 3 sit outside the
    D = 2 axis."""
    assert [g["jax_modules"] for g in ranks.got] == [[]] * WORLD
    assert [g["index"] for g in ranks.got] == [{2: 0, 4: 0}, {2: 1, 4: 1}, {2: -1, 4: 2},
                                               {2: -1, 4: 3}]


def _on_axis(ranks, d):
    return [g for g in ranks.got if g["index"][d] >= 0]


@pytest.mark.parametrize("kind", ["all_gather", "reduce_scatter", "ppermute", "psum",
                                  "sum_gradients"])
@pytest.mark.parametrize("d", [2, 4])
def test_collective_forward_and_backward(ranks, kind, d):
    """Each rank's output and input gradient against numpy: the
    all-gather's backward is a reduce-scatter sum, the reduce-scatter's an
    all-gather, a shift's the reverse shift, the psum's the identity (1,
    not D), and ``sum_gradients_`` the sum."""
    inp = [worker.collective_inputs(i, d) for i in range(d)]
    tol = dict(rtol=1e-6, atol=1e-6)  # f32 sums of D terms in another order
    outs = [g["collectives"][d] for g in _on_axis(ranks, d)]
    for i, out in enumerate(outs):
        if kind == "all_gather":
            y, gx = out["all_gather"]
            np.testing.assert_array_equal(y, np.concatenate([v["ag_x"] for v in inp]))
            np.testing.assert_allclose(gx, sum(v["ag_w"] for v in inp)[3 * i: 3 * i + 3],
                                       **tol)
        elif kind == "reduce_scatter":
            y, gx = out["reduce_scatter"]
            np.testing.assert_allclose(y, sum(v["rs_x"] for v in inp)[3 * i: 3 * i + 3],
                                       **tol)
            np.testing.assert_array_equal(gx, np.concatenate([v["rs_w"] for v in inp]))
        elif kind == "ppermute":
            for shift in (1, -1) + ((2,) if d == 4 else ()):
                y, gx = out[f"ppermute{shift:+d}"]
                np.testing.assert_array_equal(y, inp[(i - shift) % d]["pp_x"])
                np.testing.assert_array_equal(gx, inp[(i + shift) % d]["pp_w"])
        elif kind == "psum":
            y, gx = out["psum"]
            assert y == pytest.approx(sum(float(v["psum_x"]) for v in inp), rel=1e-6)
            assert gx == 1.0
        else:
            got = out["sum_gradients"]
            np.testing.assert_allclose(got["a/w"], sum(2 * v["ag_x"] for v in inp), **tol)
            np.testing.assert_allclose(got["b"], sum(2 * v["pp_x"][0] for v in inp), **tol)
    assert outs[0]["stats"]["psum"] == 1 and outs[0]["stats"]["grad_sum"] == 1


CASES = [(g, s, d, h) for g in ("box", "slab") for s in worker.SCHEMES for d in (2, 4)
         for h in (0, 2)]


def _case_id(c):
    return f"{c[0]}-{c[1]}-d{c[2]}-heads{c[3]}"


def _got(ranks, case):
    return [g["forward"][case] for g in _on_axis(ranks, case[2])]


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_energy_matches_jax_reference(ranks, case):
    """Replicated on every rank; rtol 1e-5, 2e-5 with ring attention
    (tests/test_graphshard.py:65, :151, :214)."""
    want = ranks.want[(case[0], case[3])]["e"]
    for out in _got(ranks, case):
        np.testing.assert_allclose(out["e"], want, rtol=2e-5 if case[3] else 1e-5)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_forces_match_jax_reference(ranks, case):
    """-dE/dpos, each rank's rows in axis order; rtol 1e-4 / atol 1e-5, with
    ring attention rtol 1e-3 / atol 2e-5 (tests/test_graphshard.py:90,
    :174, :239)."""
    got = np.concatenate([out["forces"] for out in _got(ranks, case)])
    want = ranks.want[(case[0], case[3])]["forces"]
    tol = dict(rtol=1e-3, atol=2e-5) if case[3] else dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[: want.shape[0]], want, **tol)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_param_grads_match_jax_reference(ranks, case):
    """The summed gradients, equal on every rank bit for bit, within rtol
    1e-4 / atol 1e-5 of JAX's (tests/test_graphshard.py:107); through ring
    attention within the JAX package's tolerance for gradients through its
    online softmax, rtol 1e-3 / atol 2e-5 (tests/test_graphshard.py:174),
    and the key biases (``ZERO_GRAD``) within rounding noise of 0."""
    outs = _got(ranks, case)
    want = ranks.want[(case[0], case[3])]["grads"]
    assert set(outs[0]["grads"]) == set(want)
    top = max(float(np.abs(g).max()) for g in want.values())
    tol = dict(rtol=1e-3, atol=2e-5) if case[3] else dict(rtol=1e-4, atol=1e-5)
    for k, g in outs[0]["grads"].items():
        for other in outs[1:]:
            np.testing.assert_array_equal(other["grads"][k], g)
        if ZERO_GRAD.fullmatch(k):
            assert max(np.abs(g).max(), np.abs(want[k]).max()) <= NOISE * top, k
        else:
            np.testing.assert_allclose(g, want[k], err_msg=k, **tol)


@pytest.mark.parametrize("scheme", worker.SCHEMES)
def test_driver_steps_match_jax_adam(ranks, scheme):
    """Three of the driver's train steps at D = 2 (64 atoms, hidden 32, 2
    heads) against three of JAX's reference + optax.adam(3e-3): losses and
    parameters within the f32 gradient tolerance (the key biases, whose
    gradient is noise, each within Adam's 3 steps of lr of where it
    started, on both sides); both ranks' parameters equal bit for bit."""
    want_losses, want_params = ranks.want["driver"]
    (l0, p0), (l1, p1) = [g["driver"][scheme] for g in _on_axis(ranks, 2)]
    assert l0 == l1
    np.testing.assert_allclose(l0, want_losses, **GRAD_TOL)
    assert set(p0) == set(want_params)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k])
        if ZERO_GRAD.fullmatch(k):
            for p in (p0[k], want_params[k]):
                assert np.abs(p - ranks.start[k]).max() <= 3.2 * gg.LEARNING_RATE, k
        else:
            np.testing.assert_allclose(p0[k], want_params[k], err_msg=k, **GRAD_TOL)


def test_driver_cli_on_two_cpu_ranks(ranks):
    rc, log = ranks.cli
    assert rc == 0, log[-4000:]
    assert "memory model" in log and "giant-graph training done" in log
    assert sum(line.startswith("epoch") for line in log.splitlines()) == 2
