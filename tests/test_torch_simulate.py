"""MD rollouts of the port (hydragnn_tpu_torch/simulate/) against the JAX
package, on the CPU.

- ``ops/prng``: ``split`` and 32-bit ``bits`` equal ``jax.random``'s bit
  for bit (jax 0.9.0, threefry partitionable); ``normal`` within float32
  rounding (``torch.erfinv`` is not XLA's polynomial);
- ``radius_graph_device`` equals ``radius_graph_jax`` element for
  element, with room and with overflow;
- ``plan_blocks_device`` equals the host planner's ``plan_blocks_static``
  element for element (the device lists, empty windows, a full list,
  an all-padding list), and K1's plain version on it equals the
  unplanned scatter;
- NVE and Langevin rollouts (16 steps, K = 4) from the JAX engine's
  ``init_state``, carried across by ``md_state_from_numpy``: energies,
  kinetic energies, positions and velocities within the float32 forward
  tolerance of tests/test_pallas_segment.py:341 (rtol 1e-5, atol 1e-4),
  and the neighbor arrays, rebuild counts, counters and thermostat key
  equal. The test first holds that no pair distance at any step lies
  within 1e-5 of the list radius, where the two packages could
  legitimately decide a pair differently;
- every contract of tests/test_simulate.py on the port's CPU path, bit
  for bit where the reference holds it bit for bit: K-macro == serial
  with rebuilds and the thermostat, the tail macro, overflow growth ==
  the roomy run, growths exhausted, ``nan:force`` with a dt halving, the
  halt policy and halvings exhausted, interrupt and resume, the adopted
  ladder, ``rollout`` rows read back by tools/graftboard.py,
  ``run_simulation`` on a config, the settings' validation, NVE energy
  conservation and momentum;
- an ``MDState`` through the checkpoint writer and back, leaf for leaf;
- ``train/capture.collector_paused``, which holds Python's cyclic
  collector off while a step or a macro is captured, restores the
  collector's state on the way out.

The potential is tests/test_simulate.py's: the small SchNet of
``_mlip_config("node")`` on 10 atoms (cutoff 2.5), its JAX parameters
carried into the port with ``params_from_jax``. One JAX engine per
thermostat compiles once (module fixture).
"""

import json
import os
import sys
import types

import numpy as np
import pytest

import tests._cpu  # noqa: F401

import jax

from hydragnn_tpu import simulate as jsim
from hydragnn_tpu.data.graph import GraphSample, collate
from hydragnn_tpu.models.create import create_model, init_params
from hydragnn_tpu.ops.neighbors import radius_graph, radius_graph_jax
from tests.test_interatomic_potential import _mlip_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ATOMS = 10
CUTOFF = 2.5
# tests/test_pallas_segment.py:341, the float32 forward tolerance
F32_TOL = dict(rtol=1e-5, atol=1e-4)
# the parity runs' Simulation block (tests/test_simulate.py's _engine,
# with a skin small enough that the list is rebuilt mid-run)
PARITY_BLOCK = {"steps": 16, "dt": 2e-3, "superstep_k": 4, "temperature_k": 0.2,
                "kb": 1.0, "seed": 3, "friction": 0.5,
                "neighbor": {"skin": 0.02, "max_edges": 256}}


@pytest.fixture(scope="module")
def port():
    import torch

    torch.set_num_threads(1)
    from hydragnn_tpu_torch import simulate
    from hydragnn_tpu_torch.data import graph
    from hydragnn_tpu_torch.models import convert, create, spec
    from hydragnn_tpu_torch.ops import edge_pipeline, neighbors, prng, segment
    from hydragnn_tpu_torch.utils import checkpoint, faults, telemetry

    return types.SimpleNamespace(
        torch=torch, sim=simulate, graph=graph, convert=convert, create=create, spec=spec,
        ep=edge_pipeline, neighbors=neighbors, prng=prng, segment=segment,
        checkpoint=checkpoint, faults=faults, telemetry=telemetry)


@pytest.fixture(scope="module")
def potential(port):
    """tests/test_simulate.py's potential in both packages: (JAX model,
    variables, cfg), (port model, cfg), the JAX sample."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 3.0, (N_ATOMS, 3)).astype(np.float32)
    x = np.ones((N_ATOMS, 1), np.float32)
    jcfg = _mlip_config("node")
    jmodel = create_model(jcfg)
    sample = GraphSample(x=x, pos=pos, edge_index=radius_graph(pos, CUTOFF), energy=0.0,
                         forces=np.zeros((N_ATOMS, 3), np.float32))
    params, bs = init_params(jmodel, collate([sample]))
    sp = port.spec
    tcfg = sp.ModelConfig(
        mpnn_type="SchNet", input_dim=1, hidden_dim=16, num_conv_layers=2,
        heads=(sp.HeadSpec("energy", "node", 1),), graph_branches=(sp.BranchSpec(),),
        node_branches=(sp.BranchSpec(),), task_weights=(1.0,), radius=CUTOFF,
        num_gaussians=8, num_filters=16, num_radial=6, graph_pooling="mean",
        enable_interatomic_potential=True, energy_weight=1.0, energy_peratom_weight=0.5,
        force_weight=10.0)
    tmodel = port.create.create_model(tcfg, "cpu")
    tmodel.load_state_dict(port.convert.params_from_jax(params))
    return types.SimpleNamespace(jmodel=jmodel, variables={"params": params, "batch_stats": bs},
                                 jcfg=jcfg, model=tmodel, cfg=tcfg, sample=sample)


def _engine(port, potential, *, k=8, steps=24, max_edges=256, **sim):
    """The port's engine with tests/test_simulate.py's block."""
    block = {"steps": steps, "dt": 2e-3, "superstep_k": k, "temperature_k": 0.2,
             "kb": 1.0, "seed": 3, "neighbor": {"skin": 0.2, "max_edges": max_edges}}
    block.update(sim)
    s = port.sim.simulation_settings({"Simulation": block})
    smp = potential.sample
    tmpl = port.sim.md_template_batch(np.asarray(smp.x), np.asarray(smp.pos),
                                      s.neighbor.max_edges)
    return port.sim.RolloutEngine(potential.model, None, potential.cfg, tmpl, s)


@pytest.fixture(scope="module")
def reference(port, potential):
    """The JAX engine's 16-step rollouts (NVE and Langevin, K = 4) and
    their initial states: one compile per thermostat."""
    out = {}
    smp = potential.sample
    for thermostat in ("none", "langevin"):
        s = jsim.simulation_settings({"Simulation": dict(PARITY_BLOCK, thermostat=thermostat)})
        tmpl = jsim.md_template_batch(np.asarray(smp.x), np.asarray(smp.pos),
                                      s.neighbor.max_edges)
        eng = jsim.RolloutEngine(potential.jmodel, potential.variables, potential.jcfg,
                                 tmpl, s)
        st0 = eng.init_state()
        out[thermostat] = (jax.device_get(st0), eng.run(st0, record=True))
    return out


# ---------------------------------------------------------------- ops/prng


@pytest.mark.parametrize("seed", [0, 3, 12345, 2**32 + 17])
def test_prng_bits_and_split_equal_jax(port, seed):
    import jax.numpy as jnp

    key = jax.random.PRNGKey(seed)
    tkey = port.prng.prng_key(seed)
    assert np.array_equal(np.asarray(key).astype(np.int64), tkey.numpy())
    for num in (2, 5):
        want = np.asarray(jax.random.split(key, num)).astype(np.int64)
        assert np.array_equal(port.prng.split(tkey, num).numpy(), want)
    # a chain of splits, as the thermostat walks its key
    jk, tk = key, tkey
    for _ in range(3):
        jk = jax.random.split(jk)[0]
        tk = port.prng.split(tk)[0]
    assert np.array_equal(np.asarray(jk).astype(np.int64), tk.numpy())
    for shape in ((11, 3), (4, 5, 6)):
        want = np.asarray(jax.random.bits(key, shape, jnp.uint32)).astype(np.int64)
        assert np.array_equal(port.prng.random_bits(tkey, shape).numpy(), want)
    want = np.asarray(jax.random.uniform(key, (11, 3), jnp.float32, -1.0, 1.0))
    assert np.array_equal(port.prng.uniform(tkey, (11, 3), -1.0, 1.0).numpy(), want)


@pytest.mark.parametrize("shape", [(11, 3), (64, 3)])
def test_prng_normal_within_f32(port, shape):
    import jax.numpy as jnp

    for seed in (0, 5):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32))
        got = port.prng.normal(port.prng.prng_key(seed), shape).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, **F32_TOL)


# -------------------------------------------------- the device neighbor list


@pytest.mark.parametrize("max_edges", [256, 40, 8])
def test_radius_graph_device_equals_jax(port, max_edges):
    """With room (256 > N^2 = 121 slots: both cut to N^2) and
    overflowing."""
    torch = port.torch
    rng = np.random.default_rng(4)
    n = 11
    pos = rng.uniform(0, 3.0, (n, 3)).astype(np.float32)
    pos[-1] = 0.0
    ngi = np.zeros(n, np.int32)
    ngi[-1] = 1
    mask = np.ones(n, bool)
    mask[-1] = False
    want = jax.device_get(radius_graph_jax(pos, 2.7, ngi, mask, max_edges))
    got = port.neighbors.radius_graph_device(torch.from_numpy(pos), 2.7,
                                             torch.from_numpy(ngi), torch.from_numpy(mask),
                                             max_edges)
    for w, g, dt in zip(want, got, (torch.int32, torch.int32, torch.bool, torch.int32)):
        assert g.dtype == dt
        assert np.array_equal(np.asarray(w), g.numpy())


def _device_lists(port, n, radius, max_edges, seed):
    torch = port.torch
    rng = np.random.default_rng(seed)
    pos = torch.from_numpy(rng.uniform(0, 4.0, (n, 3)).astype(np.float32))
    pos[-1] = 0.0
    ngi = torch.zeros(n, dtype=torch.int32)
    ngi[-1] = 1
    mask = torch.ones(n, dtype=torch.bool)
    mask[-1] = False
    snd, rcv, em, _ = port.neighbors.radius_graph_device(pos, radius, ngi, mask, max_edges)
    return snd, rcv, em


@pytest.mark.parametrize("case", ["device_list", "empty_windows", "full", "all_padding"])
def test_plan_blocks_device_equals_host(port, case):
    torch = port.torch
    ep = port.ep
    be, bn = 8, 4
    if case == "device_list":  # a rollout's list: sorted receivers, padding on N - 1
        n = 23
        snd, rcv, em = _device_lists(port, n, 2.5, 400, seed=1)
    elif case == "empty_windows":
        n = 40
        rng = np.random.default_rng(2)
        seg = np.sort(np.concatenate([rng.integers(0, 6, 30), rng.integers(30, 39, 30)]))
        rcv = torch.from_numpy(np.concatenate([seg, np.full(12, n - 1)]).astype(np.int32))
        em = torch.from_numpy(np.arange(rcv.numel()) < seg.size)
    elif case == "full":  # every slot a valid edge
        n = 23
        snd, rcv, em = _device_lists(port, n, 6.0, 64, seed=3)
        assert bool(em.all())
    else:
        n = 23
        rcv = torch.full((48,), n - 1, dtype=torch.int32)
        em = torch.zeros(48, dtype=torch.bool)
    e = rcv.numel()
    bound = ep.static_block_bound(e, n, be, bn)
    for extra in (0, 2):
        want = ep.plan_blocks_static(rcv.numpy(), n, bound + extra, be, bn,
                                     edge_valid=em.numpy())
        got = ep.plan_blocks_device(rcv, em, n, bound + extra, be, bn)
        for w, g in zip(want, got):
            assert g.dtype == torch.from_numpy(w).dtype
            assert np.array_equal(w, g.numpy())
    with pytest.raises(ValueError, match="static bound"):
        ep.plan_blocks_device(rcv, em, n, bound - 1, be, bn)
    # K1's plain version on the device plan equals the unplanned scatter
    data = torch.from_numpy(np.random.default_rng(5).normal(size=(e, 6)).astype(np.float32))
    planned = ep.segment_sum_planned(data, *got, n, bn, be)
    scatter = port.segment.segment_sum(data, rcv.long(), n, mask=em)
    np.testing.assert_allclose(planned.numpy(), scatter.numpy(), **F32_TOL)


# ------------------------------------------------- rollouts against the JAX engine


def _no_pair_near(traj, n_real, radius, margin=1e-5):
    """The closest any pair distance of the real atoms comes to
    ``radius`` over every recorded frame."""
    p = traj[:, :n_real].astype(np.float64)
    d = np.linalg.norm(p[:, :, None, :] - p[:, None, :, :], axis=-1)
    iu = np.triu_indices(n_real, 1)
    gap = float(np.abs(d[:, iu[0], iu[1]] - radius).min())
    assert gap > margin, f"a pair lies {gap:g} from the list radius {radius}"
    return gap


@pytest.mark.parametrize("thermostat", ["none", "langevin"])
def test_rollout_matches_jax(port, potential, reference, thermostat):
    st0, want = reference[thermostat]
    s = port.sim.simulation_settings({"Simulation": dict(PARITY_BLOCK, thermostat=thermostat)})
    smp = potential.sample
    eng = port.sim.RolloutEngine(
        potential.model, None, potential.cfg,
        port.sim.md_template_batch(np.asarray(smp.x), np.asarray(smp.pos),
                                   s.neighbor.max_edges), s)
    radius = CUTOFF + s.neighbor.skin
    _no_pair_near(np.concatenate([np.asarray(st0.pos)[None], want.trajectory]), N_ATOMS,
                  radius)
    got = eng.run(port.sim.md_state_from_numpy(st0, "cpu"), record=True)
    assert got.stats["steps"] == want.stats["steps"] == 16
    assert got.stats["rebuilds"] == want.stats["rebuilds"] > 0
    assert got.stats["macros"] == want.stats["macros"] == 4
    for name in ("energies", "kinetic", "trajectory", "velocities"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), **F32_TOL,
                                   err_msg=name)
    for name in ("senders", "receivers", "edge_mask", "key", "step", "good_steps",
                 "rebuilds", "overflow", "poisoned"):
        w = np.asarray(getattr(want.state, name))
        g = getattr(got.state, name).numpy()
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), name
    for name in ("pos", "vel", "forces", "ref_pos", "energy"):
        np.testing.assert_allclose(getattr(got.state, name).numpy(),
                                   np.asarray(getattr(want.state, name)), **F32_TOL,
                                   err_msg=name)


def test_init_state_matches_jax(port, potential, reference):
    """The port's own ``init_state`` (threefry velocities, the neighbor list,
    the t = 0 force pass) against the JAX engine's."""
    st0 = reference["langevin"][0]
    s = port.sim.simulation_settings({"Simulation": dict(PARITY_BLOCK, thermostat="langevin")})
    smp = potential.sample
    eng = port.sim.RolloutEngine(
        potential.model, None, potential.cfg,
        port.sim.md_template_batch(np.asarray(smp.x), np.asarray(smp.pos),
                                   s.neighbor.max_edges), s)
    got = eng.init_state()
    for name, t in got.leaves().items():
        w = np.asarray(getattr(st0, name))
        if t.is_floating_point():
            np.testing.assert_allclose(t.numpy(), w, **F32_TOL, err_msg=name)
        else:
            assert np.array_equal(t.numpy().astype(np.int64), w.astype(np.int64)), name


# ------------------------------------------- the port's own contracts (CPU path)


def test_nve_conservation_and_momentum(port, potential):
    eng = _engine(port, potential, k=8, steps=40, dt=1e-3)
    res = eng.run(eng.init_state())
    assert res.stats["steps"] == 40
    total = res.energies + res.kinetic
    scale = max(abs(float(total[0])), float(res.kinetic[0]), 1e-3)
    drift = float(np.max(np.abs(total - total[0])))
    assert drift < 1e-3 * scale, (drift, scale)
    p = port.sim.total_momentum(res.state.vel, eng.masses, eng.template.node_mask).numpy()
    assert np.max(np.abs(p)) < 1e-4, p


@pytest.mark.parametrize("case", ["rebuilds_langevin", "tail"])
def test_macro_bitwise_equals_serial(port, potential, case):
    """K-macro dispatch equals serial (K = 1) bit for bit: with the
    Langevin thermostat and mid-run rebuilds, and with a tail macro
    shorter than K (11 steps at K = 4)."""
    if case == "tail":
        kw, k = dict(steps=11), 4
    else:
        kw, k = dict(steps=32, thermostat="langevin", friction=0.5,
                     neighbor={"skin": 0.02, "max_edges": 256}), 8
    e1 = _engine(port, potential, k=1, **kw)
    r1 = e1.run(e1.init_state(), record=True)
    ek = _engine(port, potential, k=k, **kw)
    rk = ek.run(ek.init_state(), record=True)
    assert rk.stats["steps"] == kw["steps"]
    if case != "tail":
        assert r1.stats["rebuilds"] == rk.stats["rebuilds"] > 0
    assert np.array_equal(r1.trajectory, rk.trajectory)
    assert np.array_equal(r1.velocities, rk.velocities)
    assert np.array_equal(r1.energies, rk.energies)


def test_overflow_containment_and_capacity_growth(port, potential):
    clean = _engine(port, potential, k=8, steps=24)
    res_clean = clean.run(clean.init_state(), record=True)
    tiny = _engine(port, potential, k=8, steps=24, max_edges=32)
    st = tiny.init_state()
    assert bool(st.poisoned)  # t = 0 overflow flagged
    res = tiny.run(st, record=True)
    assert res.stats["steps"] == 24
    assert res.stats["capacity_growths"] >= 1
    assert res.stats["capacity"] > 32
    assert [e["action"] for e in res.stats["events"]] == (
        ["rebuild"] * res.stats["capacity_growths"])
    assert np.array_equal(res.trajectory, res_clean.trajectory)


def test_overflow_growths_exhausted_halts(port, potential):
    eng = _engine(port, potential, k=8, max_edges=32, guard={"max_capacity_growths": 0})
    with pytest.raises(port.sim.RolloutHalt, match="capacity growths exhausted") as err:
        eng.run(eng.init_state())
    assert bool(err.value.state.poisoned)


def test_injected_nonfinite_force_dt_halve(port, potential):
    """``nan:force@10``: the poisoned step is not committed, the prefix
    equals the clean run bit for bit, dt halves, and every step is still
    delivered."""
    clean = _engine(port, potential, k=8, steps=24)
    res_clean = clean.run(clean.init_state(), record=True)
    port.faults.install("nan:force@10")
    try:
        eng = _engine(port, potential, k=8, steps=24)
        res = eng.run(eng.init_state(), record=True)
    finally:
        port.faults.reset()
    assert res.stats["steps"] == 24
    assert res.stats["dt_halvings"] == 1
    assert res.stats["dt"] == pytest.approx(1e-3)
    assert [e["action"] for e in res.stats["events"]] == ["dt_halve"]
    assert np.array_equal(res.trajectory[:10], res_clean.trajectory[:10])
    assert not np.array_equal(res.trajectory[10:], res_clean.trajectory[10:])
    assert np.all(np.isfinite(res.trajectory))


@pytest.mark.parametrize("guard,match", [({"on_nonfinite": "halt"}, "non-finite"),
                                         ({"max_dt_halvings": 0}, "halvings exhausted")])
def test_injected_nonfinite_halts(port, potential, guard, match):
    port.faults.install("nan:force@5")
    try:
        eng = _engine(port, potential, k=8, guard=guard)
        with pytest.raises(port.sim.RolloutHalt, match=match) as err:
            eng.run(eng.init_state())
    finally:
        port.faults.reset()
    # the last good state: five committed steps, all finite
    assert int(err.value.state.good_steps) == 5
    assert bool(port.torch.isfinite(err.value.state.pos).all())


def test_force_fault_site(port):
    port.faults.install("nan:force@3")
    try:
        assert port.faults.nan_rules() == {"force": [3]}
    finally:
        port.faults.reset()
    with pytest.raises(ValueError, match="nan fault site"):
        port.faults.install("nan:forces@3")
    port.faults.reset()


@pytest.mark.parametrize("enabled", [True, False])
def test_collector_paused_restores_state(port, enabled):
    import gc

    from hydragnn_tpu_torch.train.capture import collector_paused

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with collector_paused():
            assert not gc.isenabled()
        assert gc.isenabled() == enabled
        with pytest.raises(KeyError):
            with collector_paused():
                raise KeyError("inside")
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


def test_checkpoint_interrupt_resume_bitwise(port, potential, tmp_path, monkeypatch):
    """A rollout interrupted at step 16, saved through the writer and
    resumed into a fresh engine's state, continues on the uninterrupted
    trajectory bit for bit."""
    monkeypatch.chdir(tmp_path)
    kw = dict(steps=32, thermostat="langevin", friction=0.5)
    full = _engine(port, potential, k=8, **kw)
    res_full = full.run(full.init_state(), record=True)
    w = port.checkpoint.CheckpointWriter("md_resume_test")
    first = _engine(port, potential, k=8, **kw)
    res_half = first.run(first.init_state(), 16, record=True)
    w.save(res_half.state, kind="auto", epoch=0, step=16)
    w.close()
    second = _engine(port, potential, k=8, **kw)
    restored, manifest = port.checkpoint.load_resume_checkpoint("md_resume_test",
                                                                second.init_state())
    assert manifest is not None and manifest["step"] == 16
    for name, t in restored.leaves().items():
        assert port.torch.equal(t, getattr(res_half.state, name)), name
    res_rest = second.run(restored, 16, record=True)
    whole = np.concatenate([res_half.trajectory, res_rest.trajectory])
    assert np.array_equal(whole, res_full.trajectory)


def test_md_state_checkpoint_round_trip(port, potential, tmp_path, monkeypatch):
    """Every leaf of an ``MDState`` through the writer and back bit for
    bit, into a fresh engine's state of another capacity; a non-finite
    state is refused by the validate-finite gate; a train state's
    checkpoint and an ``MDState`` do not restore into each other."""
    torch = port.torch
    monkeypatch.chdir(tmp_path)
    eng = _engine(port, potential, k=4, steps=8, thermostat="langevin", friction=0.5)
    st = eng.run(eng.init_state()).state
    w = port.checkpoint.CheckpointWriter("md_round_trip")
    w.save(st, kind="final", epoch=0, step=8, loop=eng.ladder_state())
    w.close()
    fresh = _engine(port, potential, k=4, max_edges=32)
    target = fresh.init_state()
    restored, manifest = port.checkpoint.load_resume_checkpoint("md_round_trip", target)
    assert manifest["loop"] == eng.ladder_state()
    for name, t in st.leaves().items():
        got = getattr(restored, name)
        assert got.dtype == t.dtype and torch.equal(got, t), name
    bad = st.replace(pos=torch.full_like(st.pos, float("nan")))
    w = port.checkpoint.CheckpointWriter("md_nan")
    w.save(bad, kind="auto", epoch=0, step=8)
    w.close()
    assert w.rejected_saves == 1
    assert not os.path.exists(os.path.join("logs", "md_nan", "resume.pt"))
    # a train state's checkpoint and an MDState do not restore into each
    # other: each load skips the file with a warning and finds nothing else
    from hydragnn_tpu_torch.train.optimizer import select_optimizer
    from hydragnn_tpu_torch.train.state import TrainState

    model = port.create.create_model(potential.cfg, "cpu", seed=1)
    train = TrainState(model, select_optimizer(model.parameters(), {"type": "AdamW"}))
    port.checkpoint.save_checkpoint("md_train", train)
    with pytest.raises(FileNotFoundError, match="No restorable checkpoint"):
        port.checkpoint.load_resume_checkpoint("md_train", fresh.init_state())
    with pytest.raises(FileNotFoundError, match="No restorable checkpoint"):
        port.checkpoint.load_checkpoint("md_round_trip", train)


def test_resume_adopts_policy_ladder(port, potential, tmp_path, monkeypatch):
    """A resumed ``run_simulation`` continues at the rungs the
    interrupted run reached (dt, capacity), from the manifest."""
    monkeypatch.chdir(tmp_path)
    config = {"Simulation": {
        "steps": 16, "dt": 2e-3, "superstep_k": 8, "temperature_k": 0.2, "kb": 1.0,
        "seed": 3, "log_name": "md_ladder_resume",
        "checkpoint": {"enabled": True, "interval_steps": 8},
        "neighbor": {"skin": 0.2, "max_edges": 32},
    }}
    kw = dict(sample=potential.sample, model=potential.model, cfg=potential.cfg,
              device="cpu")
    port.faults.install("nan:force@4")
    try:
        first = port.sim.run_simulation(config, **kw)
    finally:
        port.faults.reset()
    assert first.stats["capacity_growths"] >= 1
    assert first.stats["dt_halvings"] == 1
    config["Simulation"]["steps"] = 32
    second = port.sim.run_simulation(config, resume=True, **kw)
    assert second.stats["dt"] == pytest.approx(first.stats["dt"])
    assert second.stats["capacity"] == first.stats["capacity"]
    assert second.stats["steps"] == 16
    assert second.stats["events"] == []
    assert np.all(np.isfinite(second.energies))


def test_rollout_telemetry_rows(port, potential, tmp_path):
    stream_path = str(tmp_path / "telemetry.jsonl")
    stream = port.telemetry.configure(
        {"Telemetry": {"enabled": True, "stream_path": stream_path}}, "md_rows")
    try:
        eng = _engine(port, potential, k=8, steps=24)
        eng.run(eng.init_state())
    finally:
        port.telemetry.close_run(stream)
    rows = [json.loads(line) for line in open(stream_path) if line.strip()]
    rollout = [r for r in rows if r.get("t") == "rollout"]
    assert len(rollout) == 3
    required = {"macro", "step", "k", "committed", "dt", "spec", "energy", "drift",
                "rebuilds", "overflow", "nonfinite", "dispatch_ms", "steps_per_sec",
                "ns_per_day"}
    for r in rollout:
        assert required <= set(r), sorted(required - set(r))
    assert rollout[-1]["step"] == 24
    assert all(r["overflow"] == 0 and not r["nonfinite"] for r in rollout)
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import graftboard

        rep = graftboard.build_report(stream_path)
    finally:
        sys.path.pop(0)
    rs = rep["rollout_summary"]
    assert rs["macros"] == 3 and rs["steps"] == 24
    assert rs["halts"] == 0 and rs["overflow_events"] == 0


def test_run_simulation_api(port, potential):
    """``run_simulation`` on a config, over a state dict, on the CPU;
    without a device it asks for the card."""
    config = {"Simulation": {
        "steps": 8, "dt": 1e-3, "superstep_k": 4, "temperature_k": 0.1, "kb": 1.0,
        "seed": 1, "record_trajectory": True,
        "neighbor": {"skin": 0.3, "max_edges": 256},
    }}
    res = port.sim.run_simulation(
        config, sample=potential.sample, model=potential.model, cfg=potential.cfg,
        variables=potential.model.state_dict(), device="cpu")
    assert res.stats["steps"] == 8
    assert res.trajectory.shape == (8, N_ATOMS + 1, 3)
    assert np.all(np.isfinite(res.energies))
    assert port.sim.macro_plan(8, 4) == [4, 4] and port.sim.macro_plan(11, 4) == [4, 4, 3]
    if not port.torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port.sim.run_simulation(config, sample=potential.sample, model=potential.model,
                                    cfg=potential.cfg)


def test_simulation_settings_validation(port):
    settings = port.sim.simulation_settings
    with pytest.raises(ValueError, match="thermostat"):
        settings({"Simulation": {"thermostat": "nose"}})
    with pytest.raises(ValueError, match="rebuild_policy"):
        settings({"Simulation": {"neighbor": {"rebuild_policy": "sometimes"}}})
    with pytest.raises(ValueError, match="on_nonfinite"):
        settings({"Simulation": {"guard": {"on_nonfinite": "retry"}}})
    with pytest.raises(ValueError, match="must be positive"):
        settings({"Simulation": {"steps": 0}})
    with pytest.raises(ValueError, match="capacity_growth"):
        settings({"Simulation": {"guard": {"capacity_growth": 1.0}}})
    block = {"steps": 200, "dt": 0.001, "superstep_k": 16, "temperature_k": 0.1,
             "kb": 1.0, "thermostat": "langevin", "friction": 0.5, "seed": 0,
             "neighbor": {"skin": 0.4, "max_edges": 1024},
             "guard": {"on_nonfinite": "dt_halve", "max_dt_halvings": 2}}
    assert settings({"Simulation": block}) == port.sim.SimulationSettings(
        **{f: getattr(jsim.simulation_settings({"Simulation": block}), f)
           for f in ("steps", "dt", "superstep_k", "temperature_k", "thermostat",
                     "friction", "kb", "mass", "seed", "record_trajectory", "log_name",
                     "checkpoint_enabled", "checkpoint_interval_steps")},
        neighbor=port.sim.engine.NeighborSettings(
            **jsim.simulation_settings({"Simulation": block}).neighbor.__dict__),
        guard=port.sim.engine.SimGuardSettings(
            **jsim.simulation_settings({"Simulation": block}).guard.__dict__))


def test_run_simulation_export(port):
    """``hydragnn_tpu_torch.run_simulation`` is the engine's entry, loaded
    on first access (the port's sources import no JAX:
    tests/test_torch_host.py::test_sources_import_no_jax walks them)."""
    import hydragnn_tpu_torch

    assert "run_simulation" in hydragnn_tpu_torch.__all__
    assert hydragnn_tpu_torch.run_simulation is port.sim.engine.run_simulation
