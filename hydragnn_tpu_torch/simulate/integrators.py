"""Integrator pieces of the rollout step.

Counterpart of ``hydragnn_tpu/simulate/integrators.py``. Velocity Verlet
is split at the force evaluation, ``half_kick`` (B) and ``drift`` (A),
because the engine owns the force pass between the two B halves. The
Langevin thermostat is the symmetric OBABO splitting: an exact
Ornstein-Uhlenbeck half step (``ou_half_step``, O) on each side of the
Verlet core. ``gamma == 0`` makes O the identity (``exp(0) == 1`` and
the noise is multiplied by 0), so an NVT engine with zero friction is
the NVE engine bit for bit.

Each piece is tensor arithmetic with no host read and no branch on a
value, so the macro that composes them is captured as one CUDA graph.
The noise comes from ``ops/prng`` on the state's key, never from a
``torch.Generator``: a generator's hidden state would not rewind with a
saved key, and a replayed graph could not freeze it on an uncommitted
step.
"""

from __future__ import annotations

from hydragnn_tpu_torch.ops import prng

__all__ = ["half_kick", "drift", "ou_half_step"]


def half_kick(vel, forces, inv_masses, dt):
    """B: v += (dt/2) f/m. ``inv_masses`` is [N, 1], zero on padding
    rows, so padded velocities stay exactly 0."""
    return vel + (0.5 * dt) * forces * inv_masses


def drift(pos, vel, dt):
    """A: x += dt v, the step's single position update."""
    return pos + dt * vel


def ou_half_step(vel, key, gamma, kt, masses, node_mask, dt):
    """O: ``v <- c1 v + sqrt((1 - c1^2) kT / m) xi`` with ``c1 =
    exp(-gamma dt / 2)``. The key advances by exactly one split per call,
    and the noise is masked to real atoms. Returns (vel, key)."""
    keys = prng.split(key)
    key, sub = keys[0], keys[1]
    c1 = (-gamma * (0.5 * dt)).exp()
    sigma = ((1.0 - c1 * c1) * kt / masses).sqrt()
    noise = prng.normal(sub, tuple(vel.shape))
    mask = node_mask.to(vel.dtype)[:, None]
    return c1 * vel + sigma * noise * mask, key
