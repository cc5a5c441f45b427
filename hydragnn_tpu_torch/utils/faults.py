"""Fault injection for the durability drills.

Counterpart of ``hydragnn_tpu/utils/faults.py``, with the same spec
grammar (``;``-separated rules):

- ``write_fail:<substr>:<count>``: the next ``count`` checkpoint writes
  whose target path contains ``substr`` raise ``OSError`` (a transient
  error: the writer retries it, or records it on ``last_error`` once the
  retries are spent; training never crashes on it);
- ``slow_write:<substr>:<seconds>:<count>``: delay matching writes
  (a slow shared filesystem: the writer's backpressure);
- ``crash:<point>:<nth>``: the ``nth`` arrival at ``crash_point(point)``
  raises ``InjectedCrash`` (a ``BaseException``, so no ``except
  Exception`` absorbs it), a kill landing mid-operation: the points sit
  inside the atomic write (``write_tmp``), the hard-link publish
  (``publish_link``) and between the sharded format's two renames
  (``orbax_between_replaces``: the old directory moved aside, the new
  one not yet in place);
- ``kill:<site>[@proc<i>]:<at>``: the ``at``-th ``tick(site)`` sends
  this process a real ``SIGKILL`` (the preemption drill's mid-epoch
  kill). ``train_step`` ticks once per optimizer step, so a K-step
  dispatch ticks K times. ``@proc<i>`` scopes the rule to one rank
  (``HYDRAGNN_TPU_PROCESS_ID``, else ``parallel/runtime.rank()``);
- ``stall:<site>@<at>[@proc<i>][:<seconds>]``: sleep at the ``at``-th
  tick of ``site`` (default 1 s);
- ``nan:<site>@<step>``: poison ``site`` with NaN at optimizer step
  ``step`` (0-based, the train state's device step counter, so the
  poison lands inside a captured K-step graph as well). Sites: ``loss``
  (after the backward: the gradients stay finite), ``grad`` (every
  gradient), ``batch`` (the node features: loss and gradients both go
  non-finite), ``force`` (the MD rollout's forces, at the rollout's step
  counter, ``simulate/engine.py``). These rules are read once, when a
  train step or a rollout engine is built (``nan_rules``), and the step
  selects NaN where its counter matches.

Arm a plan with ``install(spec)``, or with the ``HYDRAGNN_TPU_FAULTS``
environment variable, read once at first use (the drills' child
processes arm themselves that way). With no plan every hook returns at
once.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Dict, List, Optional

NAN_SITES = ("loss", "grad", "batch", "force")


class InjectedCrash(BaseException):
    """A simulated kill mid-operation (module docstring)."""


def _parse_proc_seg(seg: str) -> Optional[int]:
    """``proc<i>`` -> i, else None."""
    if seg.startswith("proc") and seg[len("proc"):].isdigit():
        return int(seg[len("proc"):])
    return None


def _parse_scoped_site(tok: str, what: str) -> tuple:
    """``<site>[@proc<i>]`` -> (site, proc); a malformed scope raises
    rather than arming a rule that can never fire."""
    if "@" not in tok:
        return tok, None
    site, seg = tok.split("@", 1)
    proc = _parse_proc_seg(seg)
    if not site or proc is None:
        raise ValueError(
            f"malformed process-scoped {what} site {tok!r}: expected <site>@proc<i>"
        )
    return site, proc


def _proc_index() -> int:
    """This rank's index for ``@proc<i>`` scoping: the launcher's
    ``HYDRAGNN_TPU_PROCESS_ID``, else the process group's rank."""
    env = os.environ.get("HYDRAGNN_TPU_PROCESS_ID", "").strip()
    if env.isdigit():
        return int(env)
    from hydragnn_tpu_torch.parallel.runtime import rank

    return rank()


def _parse_stall(rule: str, parts: List[str]) -> dict:
    """``stall:<site>@<at>[@proc<i>][:<seconds>]``: after the site, one
    step index and at most one process scope, in either order."""
    bad = ValueError(f"malformed stall rule: {rule!r}: expected "
                     "stall:<site>@<at>[@proc<i>][:<seconds>]")
    site, *segs = parts[1].split("@")
    at = proc = None
    for seg in segs:
        p = _parse_proc_seg(seg)
        if p is not None and proc is None:
            proc = p
        elif seg.isdigit() and at is None:
            at = int(seg)
        else:
            raise bad
    if not site or at is None:
        raise bad
    return {"site": site, "at": at, "proc": proc,
            "seconds": float(parts[2]) if len(parts) == 3 else 1.0}


class _Plan:
    def __init__(self, spec: str):
        self.spec = spec
        self.write_fail: List[dict] = []
        self.slow_write: List[dict] = []
        self.crashes: List[dict] = []
        self.kills: List[dict] = []
        self.stalls: List[dict] = []
        self.nans: List[dict] = []
        self._counters: Dict[str, int] = {}
        self._lock = threading.Lock()
        for rule in spec.split(";"):
            rule = rule.strip()
            if rule:
                self._add(rule)

    def _add(self, rule: str) -> None:
        parts = rule.split(":")
        kind = parts[0]
        if kind == "write_fail" and len(parts) == 3:
            self.write_fail.append({"pat": parts[1], "left": int(parts[2])})
        elif kind == "slow_write" and len(parts) == 4:
            self.slow_write.append({"pat": parts[1], "seconds": float(parts[2]),
                                    "left": int(parts[3])})
        elif kind == "crash" and len(parts) == 3:
            self.crashes.append({"point": parts[1], "at": int(parts[2]), "seen": 0})
        elif kind == "kill" and len(parts) == 3:
            site, proc = _parse_scoped_site(parts[1], "kill")
            self.kills.append({"site": site, "at": int(parts[2]), "proc": proc})
        elif kind == "stall" and len(parts) in (2, 3):
            self.stalls.append(_parse_stall(rule, parts))
        elif kind == "nan" and len(parts) == 2 and "@" in parts[1]:
            site, at = parts[1].split("@", 1)
            if site not in NAN_SITES:
                raise ValueError(f"nan fault site {site!r} not in {NAN_SITES}")
            self.nans.append({"site": site, "at": int(at)})
        else:
            raise ValueError(f"unrecognized fault rule: {rule!r}")


_PLAN: Optional[_Plan] = None
_ENV_READ = False


def install(spec: str) -> None:
    """Arm a fault plan for this process."""
    global _PLAN, _ENV_READ
    _PLAN = _Plan(spec)
    _ENV_READ = True


def reset() -> None:
    """Disarm every fault (and forget the environment's spec)."""
    global _PLAN, _ENV_READ
    _PLAN = None
    _ENV_READ = True


def _plan() -> Optional[_Plan]:
    global _PLAN, _ENV_READ
    if not _ENV_READ:
        _ENV_READ = True
        spec = os.environ.get("HYDRAGNN_TPU_FAULTS", "").strip()
        if spec:
            _PLAN = _Plan(spec)
    return _PLAN


def active() -> bool:
    return _plan() is not None


def on_write(path: str) -> None:
    """Called inside every checkpoint write with its final path, after
    half the bytes went to the temporary file: may sleep (``slow_write``)
    and raise ``OSError`` (``write_fail``)."""
    plan = _plan()
    if plan is None:
        return
    delay, fail = 0.0, False
    with plan._lock:
        for rule in plan.slow_write:
            if rule["pat"] in path and rule["left"] > 0:
                rule["left"] -= 1
                delay = rule["seconds"]
                break
        for rule in plan.write_fail:
            if rule["pat"] in path and rule["left"] > 0:
                rule["left"] -= 1
                fail = True
                break
    if delay:
        # graftlint: disable-next-line=thread-discipline -- the slow_write fault injector: the stall IS the injected fault (durability drills arm it to prove the step loop survives a slow writer)
        time.sleep(delay)
    if fail:
        raise OSError(f"injected transient write failure: {path}")


def crash_point(name: str) -> None:
    """Raise ``InjectedCrash`` on the armed arrival at ``name``."""
    plan = _plan()
    if plan is None:
        return
    with plan._lock:
        for rule in plan.crashes:
            if rule["point"] == name:
                rule["seen"] += 1
                if rule["seen"] == rule["at"]:
                    raise InjectedCrash(f"injected crash at {name}")


def nan_rules() -> Dict[str, List[int]]:
    """The armed ``nan`` rules as ``{site: [step, ...]}`` (empty when
    none is armed), read when a train step is built."""
    plan = _plan()
    out: Dict[str, List[int]] = {}
    for r in plan.nans if plan is not None else ():
        out.setdefault(r["site"], []).append(r["at"])
    return out


def plan_spec() -> Optional[str]:
    """The armed plan's spec string, or None."""
    plan = _plan()
    return plan.spec if plan is not None else None


def tick(site: str) -> None:
    """Count one arrival at ``site``: SIGKILL this process where a kill
    rule's threshold is reached (no cleanup runs, as in a real
    preemption), sleep where a stall rule names this arrival. Each rank
    counts its own arrivals."""
    plan = _plan()
    if plan is None:
        return
    with plan._lock:
        n = plan._counters.get(site, 0) + 1
        plan._counters[site] = n

        def hit(r):
            return (r["site"] == site and r["at"] == n
                    and (r["proc"] is None or r["proc"] == _proc_index()))

        kill = any(hit(r) for r in plan.kills)
        delay = max([r["seconds"] for r in plan.stalls if hit(r)], default=0.0)
    if kill:
        os.kill(os.getpid(), signal.SIGKILL)
    if delay:
        # graftlint: disable-next-line=thread-discipline -- the stall fault injector: the sleep IS the injected fault (a late process at a shared rendezvous); drills arm it to prove the stall lands
        time.sleep(delay)
