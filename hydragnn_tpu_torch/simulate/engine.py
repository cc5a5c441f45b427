"""MD rollout engine: velocity Verlet over an interatomic potential's
forces, with guarded neighbor rebuilds, in K-step macros.

Counterpart of ``hydragnn_tpu/simulate/engine.py``: the settings
(``simulation_settings``, ``macro_plan``), ``RolloutHalt``,
``RolloutResult``, ``RolloutEngine`` and ``run_simulation``, with the
JAX package's step, policy ladder, checkpoints and telemetry rows. Where
the JAX engine runs K steps in one ``lax.scan`` per dispatch, the port
runs them as one captured CUDA graph per ``(K, record)`` on the card and
eagerly on the CPU. Three things differ, each for the card:

- **The neighbor list is built every step and selected.** The scan
  body rebuilds under ``lax.cond``; a CUDA graph cannot branch on a
  device value. Under the ``displacement`` policy the body builds the
  candidate list with ``ops/neighbors.radius_graph_device`` on every
  step and takes it with ``torch.where(need, ...)`` (with ``overflow``
  where(need, ovf, 0) and ``rebuilt = need``); ``always`` and ``never``
  take their one side. The reused side of the reference's cond passes
  the cached list through unchanged, so the select computes the same
  function; it costs one O(N^2) pair test a step instead of one a
  rebuild.
- **The force pass carries a block plan built on the device.** The JAX
  rollout's template has no plan, so its sums take XLA's deterministic
  segment sums. The port's unplanned sum is the ``index_add_`` scatter,
  float atomics whose order changes between runs on the card, which
  would break every bitwise contract below. The device lists come
  sorted by receiver, so ``ops/edge_pipeline.plan_blocks_device`` plans
  each step's list on the device, and every force pass runs K1 forward
  and K2 in its backward, deterministic and with no host round trip.
- **The thermostat's noise is a function of the key** (``ops/prng``,
  threefry as jax computes it), so a replayed graph draws what the
  eager step drew, a frozen key replays its noise, and a saved key
  resumes the stream.

The carry lives in static device tensors (``MDState``) that each macro
updates in place; ``dt``, the friction and kT are 0-d device tensors
written between replays, so a dt halving never recaptures. A capacity
growth changes the list's shape and drops the graphs, as the JAX engine
drops its compiled macros. A key's first dispatch runs eagerly on a side
stream, its second is captured and replayed, every later one replays,
all under ``train/capture.GRAPH_LOCK`` (captures keep torch's default
``capture_error_mode="global"``). Each macro's per-step rows and
counters are packed into one int32 buffer, so the host's per-macro
policy point is one copy and one sync.

Bitwise contracts (as tests/test_simulate.py holds the JAX engine): a
K-step macro equals K single steps, a tail macro stays on the serial
curve, an overflow contained and outgrown equals the roomy run, a NaN
force's step is not committed and the prefix is untouched, and a
resumed rollout continues the uninterrupted one.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from hydragnn_tpu_torch.data.graph import GraphBatch
from hydragnn_tpu_torch.models.spec import ModelConfig
from hydragnn_tpu_torch.ops import prng
from hydragnn_tpu_torch.ops.edge_pipeline import (
    DEFAULT_BE,
    DEFAULT_BN,
    plan_blocks_device,
    static_block_bound,
)
from hydragnn_tpu_torch.ops.neighbors import radius_graph_device
from hydragnn_tpu_torch.simulate import integrators
from hydragnn_tpu_torch.simulate.state import (
    MDState,
    kinetic_energy,
    maxwell_boltzmann_velocities,
    md_template_batch,
)
from hydragnn_tpu_torch.train import mlip
from hydragnn_tpu_torch.train.capture import side_stream
from hydragnn_tpu_torch.train.guard import nan_injections, poison_scalar

__all__ = [
    "KB_EV_PER_K",
    "NeighborSettings",
    "SimGuardSettings",
    "SimulationSettings",
    "simulation_settings",
    "macro_plan",
    "RolloutHalt",
    "RolloutResult",
    "RolloutEngine",
    "run_simulation",
]

# Boltzmann constant in eV/K, for eV/Angstrom potentials; reduced-unit
# systems set ``Simulation.kb: 1.0``.
KB_EV_PER_K = 8.617333262e-5

_THERMOSTATS = ("none", "langevin")
_REBUILD_POLICIES = ("displacement", "always", "never")
_NONFINITE_POLICIES = ("dt_halve", "halt")


@dataclass(frozen=True)
class NeighborSettings:
    """``Simulation.neighbor``: the fixed-capacity skin list, built at
    ``cutoff + skin`` and valid while no atom moved more than ``skin/2``
    since the build."""

    skin: float = 0.5
    max_edges: int = 512
    rebuild_policy: str = "displacement"


@dataclass(frozen=True)
class SimGuardSettings:
    """``Simulation.guard``: the containment ladder. Overflow grows the
    capacity (``capacity_growth`` x, at most ``max_capacity_growths``
    times); a non-finite step halves dt (at most ``max_dt_halvings``
    times) or halts, per ``on_nonfinite``. The floor is ``RolloutHalt``."""

    enabled: bool = True
    max_capacity_growths: int = 2
    capacity_growth: float = 2.0
    max_dt_halvings: int = 2
    on_nonfinite: str = "dt_halve"


@dataclass(frozen=True)
class SimulationSettings:
    """The resolved top-level ``Simulation`` block."""

    steps: int = 100
    dt: float = 1e-3
    superstep_k: int = 16
    temperature_k: float = 0.0
    thermostat: str = "none"
    friction: float = 1.0
    kb: float = KB_EV_PER_K
    mass: float = 1.0
    seed: int = 0
    record_trajectory: bool = False
    log_name: str = "md_rollout"
    checkpoint_enabled: bool = False
    checkpoint_interval_steps: int = 0
    neighbor: NeighborSettings = field(default_factory=NeighborSettings)
    guard: SimGuardSettings = field(default_factory=SimGuardSettings)


def simulation_settings(config: dict) -> SimulationSettings:
    """``config["Simulation"]`` as settings, with the JAX package's
    defaults and errors (unknown keys are refused by
    ``config.update_config``)."""
    raw = (config.get("Simulation") or {}) if config else {}
    nb = raw.get("neighbor") or {}
    gd = raw.get("guard")
    if isinstance(gd, bool):
        gd = {"enabled": gd}
    gd = gd or {}
    ck = raw.get("checkpoint")
    if isinstance(ck, bool):
        ck = {"enabled": ck}
    ck = ck or {}
    thermostat = str(raw.get("thermostat", "none"))
    if thermostat not in _THERMOSTATS:
        raise ValueError(f"Simulation.thermostat {thermostat!r} not in {_THERMOSTATS}")
    policy = str(nb.get("rebuild_policy", "displacement"))
    if policy not in _REBUILD_POLICIES:
        raise ValueError(
            f"Simulation.neighbor.rebuild_policy {policy!r} not in {_REBUILD_POLICIES}"
        )
    on_nf = str(gd.get("on_nonfinite", "dt_halve"))
    if on_nf not in _NONFINITE_POLICIES:
        raise ValueError(
            f"Simulation.guard.on_nonfinite {on_nf!r} not in {_NONFINITE_POLICIES}"
        )
    steps = int(raw.get("steps", 100))
    dt = float(raw.get("dt", 1e-3))
    if steps <= 0 or dt <= 0.0:
        raise ValueError(
            f"Simulation.steps ({steps}) and Simulation.dt ({dt}) must be positive"
        )
    growth = float(gd.get("capacity_growth", 2.0))
    if growth <= 1.0:
        # a factor <= 1 never outgrows an overflow: the ladder would spin
        raise ValueError(f"Simulation.guard.capacity_growth must be > 1, got {growth}")
    return SimulationSettings(
        steps=steps,
        dt=dt,
        superstep_k=max(1, int(raw.get("superstep_k", 16))),
        temperature_k=float(raw.get("temperature_k", 0.0)),
        thermostat=thermostat,
        friction=float(raw.get("friction", 1.0)),
        kb=float(raw.get("kb", KB_EV_PER_K)),
        mass=float(raw.get("mass", 1.0)),
        seed=int(raw.get("seed", 0)),
        record_trajectory=bool(raw.get("record_trajectory", False)),
        log_name=str(raw.get("log_name", "md_rollout")),
        checkpoint_enabled=bool(ck.get("enabled", False)),
        checkpoint_interval_steps=max(0, int(ck.get("interval_steps", 0))),
        neighbor=NeighborSettings(
            skin=float(nb.get("skin", 0.5)),
            max_edges=int(nb.get("max_edges", 512)),
            rebuild_policy=policy,
        ),
        guard=SimGuardSettings(
            enabled=bool(gd.get("enabled", True)),
            max_capacity_growths=max(0, int(gd.get("max_capacity_growths", 2))),
            capacity_growth=growth,
            max_dt_halvings=max(0, int(gd.get("max_dt_halvings", 2))),
            on_nonfinite=on_nf,
        ),
    )


def macro_plan(n_steps: int, superstep_k: int) -> List[int]:
    """The steps of each dispatch of a clean rollout of ``n_steps``: full
    K macros and one shorter tail."""
    k = max(1, int(superstep_k))
    out: List[int] = []
    left = int(n_steps)
    while left > 0:
        out.append(min(k, left))
        left -= out[-1]
    return out


class RolloutHalt(RuntimeError):
    """The ladder's floor: growths or halvings spent, or the policy is
    ``halt``. The message is the report; ``state`` is the last good
    state, bit-preserved."""

    def __init__(self, message: str, state: Optional[MDState] = None):
        super().__init__(message)
        self.state = state


@dataclass
class RolloutResult:
    """A rollout's outcome on the host. ``energies``/``kinetic`` hold one
    entry per committed step; ``trajectory``/``velocities`` are
    ``[steps, N, 3]`` when recording, else None."""

    state: Any
    energies: np.ndarray
    kinetic: np.ndarray
    trajectory: Optional[np.ndarray]
    velocities: Optional[np.ndarray]
    stats: Dict[str, Any]


@dataclass
class _CapturedMacro:
    """One captured K-step macro: its graph, its static output (the packed
    per-macro rows), the K1/K2 launches one replay makes and the bytes
    its memory pool reserved."""

    graph: Any
    out: torch.Tensor
    launches: Tuple[int, int]
    pool_bytes: int


@contextlib.contextmanager
def _eval_mode(model):
    was = model.training
    model.train(False)
    try:
        yield
    finally:
        model.train(was)


def _as_int32(t: torch.Tensor) -> torch.Tensor:
    """``t`` flattened as int32 words: a float32 tensor's bits, an
    integer or bool tensor's values."""
    if t.dtype == torch.float32:
        return t.reshape(-1).view(torch.int32)
    return t.reshape(-1).to(torch.int32)


class RolloutEngine:
    """Builds and drives the rollout step (module docstring).

    Fixed per engine: the model (evaluated in eval mode, its weights
    loaded from ``variables`` when given: a state dict such as
    ``models/convert.params_from_jax`` returns), the template batch
    (species, masks), masses, cutoff and skin, the thermostat and K. Per
    dispatch: the carry and the 0-d dt, friction and kT tensors. The
    engine runs on the device of the model's parameters. Counts on the
    card: ``eager_runs``, ``captures``, ``replays``, ``capture_seconds``
    and each graph's pool bytes (``graph_stats``)."""

    def __init__(
        self,
        model,
        variables: Optional[dict],
        cfg: ModelConfig,
        template: GraphBatch,
        settings: SimulationSettings,
    ):
        if cfg.radius is None:
            raise ValueError(
                "RolloutEngine needs Architecture.radius (the model cutoff) to build "
                "neighbor lists"
            )
        if variables is not None:
            model.load_state_dict(variables)
        self.model = model
        self.device = next(model.parameters()).device
        self.cfg = cfg
        self.template = template.to(self.device)
        self.settings = settings
        self.cutoff = float(cfg.radius)
        self.max_edges = int(settings.neighbor.max_edges)
        dev = self.device
        n = self.template.node_mask.shape[0]
        self.masses = torch.full((n, 1), float(settings.mass), dtype=torch.float32,
                                 device=dev)
        mask = self.template.node_mask.to(torch.float32)[:, None]
        # padding rows get inv_mass 0, so padded velocities stay 0
        self.inv_masses = mask / self.masses
        self.capacity_growths = 0
        self.dt_halvings = 0
        self.dt = float(settings.dt)
        self._nan_rules = nan_injections()
        self._dt_t = torch.zeros((), dtype=torch.float32, device=dev)
        self._gamma_t = torch.zeros((), dtype=torch.float32, device=dev)
        self._kt_t = torch.zeros((), dtype=torch.float32, device=dev)
        self._true = torch.ones((), dtype=torch.bool, device=dev)
        self._false = torch.zeros((), dtype=torch.bool, device=dev)
        self._zero = torch.zeros((), dtype=torch.int32, device=dev)
        self._carry: Optional[MDState] = None
        self._graphs: Dict[Tuple[int, bool], _CapturedMacro] = {}
        self._seen: set = set()
        self._side = side_stream(dev) if dev.type == "cuda" else None
        self.eager_runs = 0
        self.captures = 0
        self.replays = 0
        self.capture_seconds = 0.0

    # -- the step ------------------------------------------------------

    def _list_radius(self) -> float:
        return self.cutoff + float(self.settings.neighbor.skin)

    def _neighbor(self, pos):
        t = self.template
        return radius_graph_device(pos, self._list_radius(), t.node_graph_idx,
                                   t.node_mask, self.max_edges)

    def force_batch(self, pos, senders, receivers, edge_mask) -> GraphBatch:
        """The force pass's batch: the template with ``pos``, the list and
        the list's block plan, built on the device."""
        n, e = pos.shape[0], senders.shape[0]
        plan = plan_blocks_device(receivers, edge_mask, n, static_block_bound(e, n))
        return dataclasses.replace(
            self.template, pos=pos, senders=senders, receivers=receivers,
            edge_mask=edge_mask, seg_perm=plan[0], seg_ids=plan[1],
            seg_valid=plan[2], seg_window=plan[3], seg_tile=(DEFAULT_BE, DEFAULT_BN))

    def _energy_forces(self, pos, senders, receivers, edge_mask):
        """(energy, forces) at ``pos`` under the given list and its
        device-built plan: the model's energy and its gradient (K1
        forward, K2 in the backward on the card)."""
        batch = self.force_batch(pos, senders, receivers, edge_mask)
        with _eval_mode(self.model), torch.enable_grad():
            graph_e, forces = mlip.energy_and_forces(self.model, batch, self.cfg,
                                                     create_graph=False)
        # one real graph in slot 0 (slot 1 is the padding graph)
        return graph_e[0].detach(), forces.detach()

    def _init_forces(self, state: MDState) -> MDState:
        """Forces and energy at the state's positions under its current
        list (the t = 0 force pass and the refresh after a growth)."""
        with torch.no_grad():
            energy, forces = self._energy_forces(state.pos, state.senders, state.receivers,
                                                 state.edge_mask)
        return state.replace(energy=energy, forces=forces)

    def _body(self, st: MDState, dt, gamma, kt):
        """One physics step of the macro: the reference's scan body with
        the neighbor cond replaced by a select (module docstring)."""
        s = self.settings
        langevin = s.thermostat == "langevin"
        node_mask = self.template.node_mask
        key = st.key
        vel = st.vel
        if langevin:
            vel, key = integrators.ou_half_step(vel, key, gamma, kt, self.masses,
                                                node_mask, dt)
        vel = integrators.half_kick(vel, st.forces, self.inv_masses, dt)
        pos = integrators.drift(st.pos, vel, dt)

        # Verlet-skin check: rebuild when a real atom moved more than
        # skin/2 since the cached list was built (padding rows never
        # move). A fixed policy takes its side alone; the displacement
        # policy builds the candidate list every step and selects it.
        policy = s.neighbor.rebuild_policy
        if policy == "never":
            snd, rcv, em, ref_pos = st.senders, st.receivers, st.edge_mask, st.ref_pos
            ovf, rebuilt = self._zero, self._false
        elif policy == "always":
            snd, rcv, em, ovf = self._neighbor(pos)
            ref_pos, rebuilt = pos, self._true
        else:
            moved = pos - st.ref_pos
            need = torch.max(torch.sum(moved * moved, dim=-1)) > (
                0.5 * float(s.neighbor.skin)) ** 2
            snd_new, rcv_new, em_new, ovf_new = self._neighbor(pos)
            snd = torch.where(need, snd_new, st.senders)
            rcv = torch.where(need, rcv_new, st.receivers)
            em = torch.where(need, em_new, st.edge_mask)
            ref_pos = torch.where(need, pos, st.ref_pos)
            ovf = torch.where(need, ovf_new, self._zero)
            rebuilt = need

        energy, forces = self._energy_forces(pos, snd, rcv, em)
        # fault site ``nan:force@step``: a select, never an add
        forces = poison_scalar(self._nan_rules, "force", st.step, forces)

        vel = integrators.half_kick(vel, forces, self.inv_masses, dt)
        if langevin:
            vel, key = integrators.ou_half_step(vel, key, gamma, kt, self.masses,
                                                node_mask, dt)

        # containment: finite energy, forces and positions, and a list
        # that fit its capacity; a poisoned macro commits nothing more
        ok = (torch.isfinite(energy) & torch.all(torch.isfinite(forces))
              & torch.all(torch.isfinite(pos)) & (ovf == 0))
        alive = ok & ~st.poisoned

        def sel(new, old):
            return torch.where(alive, new, old)

        committed = MDState(
            pos=sel(pos, st.pos),
            vel=sel(vel, st.vel),
            forces=sel(forces, st.forces),
            energy=sel(energy, st.energy),
            senders=sel(snd, st.senders),
            receivers=sel(rcv, st.receivers),
            edge_mask=sel(em, st.edge_mask),
            ref_pos=sel(ref_pos, st.ref_pos),
            key=sel(key, st.key),
            # ``step`` always advances, so one armed fault fires once
            step=st.step + 1,
            good_steps=st.good_steps + alive.to(torch.int32),
            rebuilds=st.rebuilds + (alive & rebuilt).to(torch.int32),
            # survives containment: the ladder must outgrow it
            overflow=torch.maximum(st.overflow, ovf),
            poisoned=st.poisoned | ~ok,
        )
        ke = kinetic_energy(committed.vel, self.masses, node_mask)
        return committed, (committed.energy, ke, alive, rebuilt & alive,
                           committed.pos, committed.vel)

    def _macro(self, k: int, record: bool) -> torch.Tensor:
        """K steps from the carry, written back into it; returns the
        packed int32 rows: good_steps, rebuilds, overflow, poisoned and
        the energy's bits, then per step the energy, kinetic energy,
        alive and rebuilt flags, and with ``record`` positions and
        velocities (floats as their bits)."""
        st = self._carry
        ys = []
        with torch.no_grad():
            for _ in range(k):
                st, y = self._body(st, self._dt_t, self._gamma_t, self._kt_t)
                ys.append(y)
            self._carry.copy_(st)
            cols = list(zip(*ys))
            parts = [torch.stack([st.good_steps, st.rebuilds, st.overflow,
                                  st.poisoned.to(torch.int32), st.energy.view(torch.int32)])]
            parts += [_as_int32(torch.stack(c)) for c in cols[:4]]
            if record:
                parts += [_as_int32(torch.stack(c)) for c in cols[4:]]
            return torch.cat(parts)

    def _unpack(self, h: np.ndarray, k: int, record: bool) -> dict:
        n = int(self.template.node_mask.shape[0])
        out = {"good_steps": int(h[0]), "rebuilds": int(h[1]), "overflow": int(h[2]),
               "poisoned": bool(h[3]), "energy": float(h[4:5].view(np.float32)[0])}
        at = 5
        for name, as_float in (("e", True), ("ke", True), ("alive", False),
                               ("rebuilt", False)):
            col = h[at:at + k]
            out[name] = col.view(np.float32).copy() if as_float else col.astype(bool)
            at += k
        if record:
            size = k * n * 3
            out["pos"] = h[at:at + size].view(np.float32).reshape(k, n, 3).copy()
            out["vel"] = h[at + size:at + 2 * size].view(np.float32).reshape(k, n, 3).copy()
        return out

    # -- dispatch: eager on the CPU; eager, captured, replayed on a card --

    def _dispatch(self, k: int, record: bool) -> np.ndarray:
        """Run one macro on the carry and fetch its packed rows to the
        host (one copy, one sync)."""
        if self.device.type != "cuda":
            # graftlint: disable-next-line=host-sync -- the CPU path: the macro's rows are host memory already, nothing waits
            return self._macro(k, record).numpy()
        from hydragnn_tpu_torch.train.capture import GRAPH_LOCK

        key = (int(k), bool(record))
        with GRAPH_LOCK:
            if key in self._graphs:
                out = self._replay(key)
            elif key not in self._seen:
                self._seen.add(key)
                out = self._eager(k, record)
            else:
                self._capture(key)
                out = self._replay(key)
            # graftlint: disable-next-line=host-sync -- the per-macro policy point: one copy of the packed rows per K-step dispatch, the rollout's one designed fetch
            return out.cpu().numpy()

    def _eager(self, k: int, record: bool) -> torch.Tensor:
        cur = torch.cuda.current_stream(self.device)
        self._side.wait_stream(cur)
        with torch.cuda.stream(self._side):
            out = self._macro(k, record)
        cur.wait_stream(self._side)
        self.eager_runs += 1
        return out

    def _capture(self, key) -> None:
        from hydragnn_tpu_torch.train.capture import _launch_counters, collector_paused
        from hydragnn_tpu_torch.utils import telemetry

        t0 = time.perf_counter()
        counters = _launch_counters()
        before = tuple(c.launches for c in counters)
        # graftlint: disable-next-line=host-sync -- the sync before a capture: the pool's reserved bytes are read against an idle card; once per key, never per macro
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with collector_paused(), torch.cuda.graph(graph):
            out = self._macro(*key)
        recorded = tuple(c.launches - b for c, b in zip(counters, before))
        for c, b in zip(counters, before):
            c.launches = b
        # graftlint: disable-next-line=host-sync -- the sync after a capture: the capture's seconds and pool bytes; once per key, never per macro
        torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        self._graphs[key] = _CapturedMacro(
            graph, out, recorded, torch.cuda.memory_reserved(self.device) - reserved)
        self.captures += 1
        self.capture_seconds += seconds
        telemetry.note_capture(seconds)

    def _replay(self, key) -> torch.Tensor:
        from hydragnn_tpu_torch.train.capture import _launch_counters

        macro = self._graphs[key]
        macro.graph.replay()
        for c, n in zip(_launch_counters(), macro.launches):
            c.launches += n
        self.replays += 1
        return macro.out

    def _drop_graphs(self) -> None:
        """Release every captured macro (the list's shape changed, or the
        carry moved)."""
        if self._graphs:
            with self._locked():
                for macro in self._graphs.values():
                    macro.graph.reset()
                    macro.out = None
                self._graphs.clear()
                torch.cuda.empty_cache()
        self._seen.clear()

    def graph_stats(self) -> dict:
        """The graph cache's counts and the bytes its pools reserved."""
        return {"eager_runs": self.eager_runs, "captures": self.captures,
                "replays": self.replays, "capture_seconds": self.capture_seconds,
                "graphs": len(self._graphs),
                "pool_bytes": sum(m.pool_bytes for m in self._graphs.values())}

    def _set_carry(self, state: MDState) -> None:
        """Make ``state`` the carry: copied into the static tensors where
        the shapes match, else a fresh carry (and no graph survives)."""
        if state is self._carry:
            return
        same = self._carry is not None and all(
            a.shape == b.shape and a.dtype == b.dtype
            for a, b in zip(self._carry.leaves().values(), state.leaves().values()))
        if same:
            self._carry.copy_(state)
            return
        self._drop_graphs()
        self._carry = MDState(**{k: v.to(self.device).clone()
                                 for k, v in state.leaves().items()})

    # -- host-side lifecycle -------------------------------------------

    def _locked(self):
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        from hydragnn_tpu_torch.train.capture import GRAPH_LOCK

        return GRAPH_LOCK

    def init_state(self, pos=None, *, seed: Optional[int] = None) -> MDState:
        """A fresh state at ``pos`` (default: the template's positions):
        thermal velocities, a freshly built list, and the t = 0 force
        pass. An initial list that overflows is flagged (poisoned), for
        ``run``'s first policy check."""
        s = self.settings
        t = self.template
        dev = self.device
        pos = t.pos if pos is None else torch.as_tensor(pos, dtype=torch.float32).to(dev)
        if tuple(pos.shape) != tuple(t.pos.shape):
            raise ValueError(
                f"pos shape {tuple(pos.shape)} != template {tuple(t.pos.shape)} — build "
                "the template from the same configuration"
            )
        with self._locked(), torch.no_grad():
            keys = prng.split(prng.prng_key(s.seed if seed is None else int(seed), dev))
            key, vkey = keys[0].clone(), keys[1].clone()
            kt = s.kb * s.temperature_k
            if kt > 0.0:
                vel = maxwell_boltzmann_velocities(vkey, t.node_mask, self.masses, kt)
            else:
                vel = torch.zeros_like(pos)
            snd, rcv, em, ovf = self._neighbor(pos)
            state = MDState(
                pos=pos.clone(),
                vel=vel,
                forces=torch.zeros_like(pos),
                energy=torch.zeros((), dtype=torch.float32, device=dev),
                senders=snd,
                receivers=rcv,
                edge_mask=em,
                ref_pos=pos.clone(),
                key=key,
                step=torch.zeros((), dtype=torch.int32, device=dev),
                good_steps=torch.zeros((), dtype=torch.int32, device=dev),
                rebuilds=torch.zeros((), dtype=torch.int32, device=dev),
                overflow=ovf,
                poisoned=torch.zeros((), dtype=torch.bool, device=dev),
            )
            if int(ovf) > 0:
                return state.replace(poisoned=torch.ones((), dtype=torch.bool, device=dev))
            return self._init_forces(state)

    def reset_containment(self, state: MDState) -> MDState:
        """Between macros: clear the sticky poison flag and the overflow
        high-water mark after a policy action."""
        return state.replace(
            poisoned=torch.zeros((), dtype=torch.bool, device=self.device),
            overflow=torch.zeros((), dtype=torch.int32, device=self.device),
        )

    def _resize_template(self, cap: int) -> None:
        pad_node = self.template.node_mask.shape[0] - 1
        dev = self.device
        self.template = dataclasses.replace(
            self.template,
            senders=torch.full((cap,), pad_node, dtype=torch.int32, device=dev),
            receivers=torch.full((cap,), pad_node, dtype=torch.int32, device=dev),
            edge_mask=torch.zeros((cap,), dtype=torch.bool, device=dev),
        )
        self._drop_graphs()

    def grow_capacity(self, state: MDState, need: int) -> MDState:
        """The overflow rung: grow ``max_edges`` past the reported need,
        drop the graphs (the shapes changed), rebuild the list at the
        preserved positions and refresh the forces under it."""
        growth = self.settings.guard.capacity_growth
        new_cap = int(np.ceil(self.max_edges * growth))
        while new_cap < self.max_edges + need:
            new_cap = int(np.ceil(new_cap * growth))
        self.max_edges = new_cap
        self.capacity_growths += 1
        self._resize_template(new_cap)
        with self._locked(), torch.no_grad():
            snd, rcv, em, ovf = self._neighbor(state.pos)
            state = self.reset_containment(state).replace(
                senders=snd, receivers=rcv, edge_mask=em, ref_pos=state.pos.clone(),
                overflow=ovf)
            if int(ovf) > 0:
                # still too small: let the ladder spend another growth
                return state.replace(
                    poisoned=torch.ones((), dtype=torch.bool, device=self.device))
            return self._init_forces(state)

    def spec(self) -> str:
        n = int(self.template.node_mask.shape[0])
        return f"n{n}_e{self.max_edges}"

    # -- ladder persistence --------------------------------------------

    def ladder_state(self) -> Dict[str, Any]:
        """The ladder's host state, kept in every trajectory checkpoint's
        manifest (the writer's ``loop`` slot): a resumed rollout goes on
        at the dt and capacity the run had reached."""
        return {
            "dt": self.dt,
            "dt_halvings": self.dt_halvings,
            "max_edges": self.max_edges,
            "capacity_growths": self.capacity_growths,
        }

    def adopt_ladder(self, ladder: Optional[Dict[str, Any]]) -> None:
        """Restore the ladder from a manifest before the restored state
        is used (its lists carry the capacity at save time)."""
        if not ladder:
            return
        self.dt = float(ladder.get("dt", self.dt))
        self.dt_halvings = int(ladder.get("dt_halvings", self.dt_halvings))
        self.capacity_growths = int(ladder.get("capacity_growths", self.capacity_growths))
        cap = int(ladder.get("max_edges", self.max_edges))
        if cap != self.max_edges:
            self.max_edges = cap
            self._resize_template(cap)

    # -- the rollout loop ----------------------------------------------

    def run(
        self,
        state: MDState,
        n_steps: Optional[int] = None,
        *,
        record: Optional[bool] = None,
        writer=None,
    ) -> RolloutResult:
        """Drive ``n_steps`` committed steps from ``state``: K-step
        macros (a tail shorter than K is a macro of its own), each
        followed by one fetch of its packed rows, the policy point where
        containment climbs the ladder and the ``rollout`` telemetry row
        is emitted. ``writer`` (a ``CheckpointWriter``) saves the state
        every ``checkpoint_interval_steps`` committed steps and at the
        end. The returned state is a copy of the carry."""
        from hydragnn_tpu_torch.utils import telemetry

        s = self.settings
        if n_steps is None:
            n_steps = s.steps
        if record is None:
            record = s.record_trajectory
        record = bool(record)
        k_cfg = max(1, int(s.superstep_k))
        energies: List[np.ndarray] = []
        kinetic: List[np.ndarray] = []
        traj: List[np.ndarray] = []
        vels: List[np.ndarray] = []
        events: List[dict] = []
        macro_idx = 0
        rebuilds = 0
        e0: Optional[float] = None
        t_run0 = time.perf_counter()

        with self._locked():
            # a state initialised or restored into a containment event is
            # a policy decision before the first macro
            self._set_carry(self._policy_gate(state, events))
            good = int(self._carry.good_steps)
            self._gamma_t.fill_(float(s.friction))
            self._kt_t.fill_(float(s.kb * s.temperature_k))
        base_good = good
        # the checkpoint cadence anchors at the resume cursor
        last_ckpt = base_good
        target = base_good + int(n_steps)
        while good < target:
            k = min(k_cfg, target - good)
            t0 = time.perf_counter()
            with self._locked():
                self._dt_t.fill_(self.dt)
            h = self._unpack(self._dispatch(k, record), k, record)
            dispatch_ms = 1e3 * (time.perf_counter() - t0)
            good_now = h["good_steps"]
            rebuilds = h["rebuilds"]
            alive = h["alive"]
            energies.append(h["e"][alive])
            kinetic.append(h["ke"][alive])
            if record:
                traj.append(h["pos"][alive])
                vels.append(h["vel"][alive])
            if e0 is None:
                for arr in energies:
                    if arr.size:
                        e0 = float(arr[0])
                        break
            drift = h["energy"] - e0 if e0 is not None else 0.0
            wall_s = max(time.perf_counter() - t_run0, 1e-9)
            steps_per_sec = (good_now - base_good) / wall_s
            telemetry.emit(
                {
                    "t": "rollout",
                    "macro": macro_idx,
                    "step": good_now,
                    "k": int(k),
                    "committed": good_now - good,
                    "dt": self.dt,
                    "spec": self.spec(),
                    "energy": h["energy"],
                    "drift": drift,
                    "rebuilds": rebuilds,
                    "overflow": h["overflow"],
                    "nonfinite": h["poisoned"] and h["overflow"] == 0,
                    "dispatch_ms": round(dispatch_ms, 3),
                    "steps_per_sec": round(steps_per_sec, 3),
                    # dt read as femtoseconds; reduced-unit runs read it
                    # as a relative throughput only
                    "ns_per_day": round(steps_per_sec * self.dt * 86400.0 / 1e6, 6),
                }
            )
            macro_idx += 1
            good = good_now
            if h["poisoned"]:
                with self._locked():
                    self._set_carry(self._policy_gate(self._carry.clone(), events))
            if (
                writer is not None
                and s.checkpoint_interval_steps > 0
                and good - last_ckpt >= s.checkpoint_interval_steps
            ):
                writer.save(self._carry, kind="auto", epoch=0, step=good,
                            loop=self.ladder_state())
                last_ckpt = good
        if writer is not None:
            writer.save(self._carry, kind="final", epoch=0, step=good,
                        loop=self.ladder_state())

        energies_np = np.concatenate(energies) if energies else np.zeros(0)
        kinetic_np = np.concatenate(kinetic) if kinetic else np.zeros(0)
        stats = {
            "steps": good - base_good,
            "macros": macro_idx,
            "rebuilds": rebuilds if macro_idx else 0,
            "dt": self.dt,
            "dt_halvings": self.dt_halvings,
            "capacity": self.max_edges,
            "capacity_growths": self.capacity_growths,
            "events": events,
            "energy_drift": (
                float(energies_np[-1] + kinetic_np[-1])
                - float(energies_np[0] + kinetic_np[0])
                if energies_np.size
                else 0.0
            ),
            "steps_per_sec": (good - base_good) / max(time.perf_counter() - t_run0, 1e-9),
        }
        with self._locked():
            final = self._carry.clone()
        return RolloutResult(
            state=final,
            energies=energies_np,
            kinetic=kinetic_np,
            trajectory=np.concatenate(traj) if traj else None,
            velocities=np.concatenate(vels) if vels else None,
            stats=stats,
        )

    # -- policy ladder -------------------------------------------------

    def _policy_gate(self, state: MDState, events: List[dict]) -> MDState:
        """Climb the ladder for a poisoned state: overflow grows the
        capacity, a non-finite step halves dt, exhaustion or the halt
        policy raises ``RolloutHalt``. A clean state passes untouched."""
        if not bool(state.poisoned):
            return state
        overflow = int(state.overflow)
        guard = self.settings.guard
        if not guard.enabled:
            raise RolloutHalt(self._halt_report(state, overflow, "guard disabled"), state)
        if overflow > 0:
            if self.capacity_growths >= guard.max_capacity_growths:
                self._emit_event(events, "halt", overflow=overflow)
                raise RolloutHalt(
                    self._halt_report(state, overflow, "neighbor capacity growths exhausted"),
                    state,
                )
            old_cap = self.max_edges
            state = self.grow_capacity(state, overflow)
            self._emit_event(events, "rebuild", overflow=overflow, capacity_from=old_cap,
                             capacity_to=self.max_edges)
            # still overflowing: climb again (bounded by the growths)
            return self._policy_gate(state, events)
        if guard.on_nonfinite == "halt" or self.dt_halvings >= guard.max_dt_halvings:
            self._emit_event(events, "halt", nonfinite=True)
            raise RolloutHalt(
                self._halt_report(
                    state, 0,
                    "non-finite energy/forces"
                    + ("" if guard.on_nonfinite == "halt" else " (dt halvings exhausted)"),
                ),
                state,
            )
        self.dt *= 0.5
        self.dt_halvings += 1
        self._emit_event(events, "dt_halve", dt=self.dt)
        return self.reset_containment(state)

    def _emit_event(self, events: List[dict], action: str, **kw) -> None:
        from hydragnn_tpu_torch.utils import telemetry
        from hydragnn_tpu_torch.utils.print_utils import print_distributed

        row = {"t": "rollout_event", "action": action, **kw}
        events.append({"action": action, **kw})
        telemetry.emit(row)
        print_distributed(0, 0, f"[rollout] containment: {row}")

    def _halt_report(self, state: MDState, overflow: int, why: str) -> str:
        from hydragnn_tpu_torch.utils import faults

        good = int(state.good_steps)
        return (
            f"rollout HALTED by the containment guard: {why} at committed step {good} "
            f"(neighbor capacity {self.max_edges}, overflow {overflow}, dt {self.dt}, "
            f"{self.capacity_growths} capacity growth(s), {self.dt_halvings} dt "
            f"halving(s) spent; injected fault plan: {faults.plan_spec()!r}). The "
            "returned state is the last good step, bit-preserved — raise "
            "Simulation.neighbor.max_edges, lower Simulation.dt, or inspect the "
            "telemetry `rollout` rows (tools/graftboard.py report)."
        )


# ----------------------------------------------------------------------
# Public entry


def run_simulation(
    config: dict,
    *,
    sample=None,
    model=None,
    cfg: Optional[ModelConfig] = None,
    state=None,
    variables: Optional[dict] = None,
    log_name: Optional[str] = None,
    resume: bool = False,
    device=None,
) -> RolloutResult:
    """Run ``config``'s ``Simulation`` block over an interatomic
    potential, on the card unless ``device`` names another.

    ``sample`` is the initial configuration (a ``GraphSample`` with ``x``
    and ``pos``). ``model``/``cfg`` and a ``TrainState`` (``state``) or a
    state dict (``variables``) give the potential, typically the returns
    of ``run_training``; without ``model``/``cfg`` both are created from
    the config with seeded random weights (a smooth potential all the
    same). The model must already live on the run's device.
    ``resume=True`` restores the newest trajectory checkpoint a previous
    run wrote under the same log name and continues to
    ``Simulation.steps`` committed steps."""
    from hydragnn_tpu_torch.device import resolve_device
    from hydragnn_tpu_torch.utils import telemetry
    from hydragnn_tpu_torch.utils.checkpoint import CheckpointWriter, load_resume_checkpoint

    s = simulation_settings(config)
    if sample is None:
        raise ValueError(
            "run_simulation needs an initial configuration (sample=GraphSample with x "
            "and pos)"
        )
    dev = resolve_device(device)
    if model is None or cfg is None:
        from hydragnn_tpu_torch.models.create import create_model_config

        model, cfg = create_model_config(config, dev)
    model_dev = next(model.parameters()).device
    if model_dev != dev and not (dev.type == "cuda" and model_dev.type == "cuda"
                                 and dev.index is None):
        raise ValueError(f"the model lives on {model_dev}, the run on {dev}")
    if variables is None and state is not None and state.model is not model:
        variables = state.model.state_dict()

    template = md_template_batch(np.asarray(sample.x), np.asarray(sample.pos),
                                 s.neighbor.max_edges)
    engine = RolloutEngine(model, variables, cfg, template, s)
    log = log_name or s.log_name

    own_stream = None
    if not telemetry.active():
        training = config.get("NeuralNetwork", {}).get("Training", {}) if config else {}
        own_stream = telemetry.configure(training, log, device=engine.device)

    writer = None
    md0 = engine.init_state()
    done_steps = 0
    if resume:
        restored, manifest = load_resume_checkpoint(log, md0)
        if manifest is not None:
            # the ladder first: the saved lists carry the capacity at
            # save time, and the run had reached the saved dt
            engine.adopt_ladder(manifest.get("loop"))
            md0 = restored
            done_steps = int(manifest.get("step", 0))
    if s.checkpoint_enabled:
        writer = CheckpointWriter(log)
    try:
        result = engine.run(md0, max(0, s.steps - done_steps), writer=writer)
    finally:
        if writer is not None:
            writer.close()
        if own_stream is not None:
            telemetry.close_run(own_stream)
    return result
