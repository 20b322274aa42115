"""Deterministic, env-driven fault injection (counterpart:
tdc_tpu/testing/faults.py, copied so the port imports nothing of the JAX
package; the same $TDC_FAULTS grammar, so one spec string parses and
fires alike in both packages).

Production code calls `fault_point("name")` where failures strike, and
the $TDC_FAULTS environment variable decides (deterministically, per
process) which of those points fire and how. Unset, a fault point is one
dict lookup — safe in hot loops.

Spec grammar (comma-separated entries):

    TDC_FAULTS="ckpt.save.pre_replace=crash@2,stream.batch=delay:1.5@10"
    TDC_FAULTS="stream.batch=kill@10&attempt=0&pid=1"

    point '=' action[':' arg]['@' N['+']]['&' key '=' value ...]

Actions:
    crash        os._exit(137) — abrupt death, no cleanup
    kill         SIGKILL to self — the real kill -9
    sigterm      SIGTERM to self — the preemption notice; execution
                 continues so the handler/drain path is what's exercised
    exit:<code>  os._exit(code)
    raise:<Exc>  raise builtins.<Exc>("injected fault at <point>")
    delay:<sec>  time.sleep(sec) — slow disk / network stall

Trigger: '@N' fires on exactly the Nth eligible hit of that point in this
process (1-based, default @1); '@N+' fires on every hit from the Nth on.
Hits are counted per process.

Filters: '&key=value' terms must ALL match the environment for the entry
to count hits at all. 'attempt' reads $TDC_ATTEMPT and 'pid'/'process'
reads $TDC_PROCESS_ID; any other key reads $TDC_<KEY-uppercased>.

`KNOWN_POINTS` is the JAX package's whole registry, so a spec written for
either package names the same points. The points the port calls:
    ckpt.save.pre_replace   between the tmp write and the atomic rename
                            (utils/checkpoint.py)
    ckpt.restore            before loading a step's state
    ckpt.restore.layout     reading a checkpoint's mesh-layout manifest
                            (parallel/reshard.py)
    stream.batch            each streamed-fit batch boundary
                            (models/streaming.py)
    data.read.transient     each guarded stream read attempt (ingest.py);
                            raise: injections here classify transient
    data.read.permanent     same site; raise: e.g. ValueError classifies
                            permanent (no retry)
    data.corrupt            the ingest guard's host screen — raise:
                            injects a poisoned-batch quarantine verdict
    data.load               dataset open (data/loader.py)
    store.read.transient    every object-store ranged blob read, before
                            the backend I/O (data/store.py)
    store.read.permanent    the same site (the non-retryable injection)
    store.list              before an object-store manifest document load
The others (supervisor.*, serve.dispatch, resident.chunk,
reshard.redistribute, assign.*, online.*, fleet.*) wait for the modules
that hold their sites (ROADMAP.md Queue A, A9-A12).
"""

from __future__ import annotations

import builtins
import os
import signal
import time
from dataclasses import dataclass

ENV_VAR = "TDC_FAULTS"

# The JAX package's registry, entry for entry (a test holds them equal):
# a $TDC_FAULTS spec names the same points in both packages.
KNOWN_POINTS = frozenset({
    "ckpt.save.pre_replace",
    "ckpt.restore",
    "ckpt.restore.layout",
    "stream.batch",
    "data.read.transient",
    "data.read.permanent",
    "data.corrupt",
    "supervisor.spawn",
    "supervisor.resize",
    "serve.dispatch",
    "data.load",
    "resident.chunk",
    "reshard.redistribute",
    "assign.refine",
    "assign.bounds_recompute",
    "online.fold",
    "online.validate",
    "online.swap",
    "online.rollback",
    "fleet.route",
    "fleet.scale",
    "fleet.replica_spawn",
    "store.read.transient",
    "store.read.permanent",
    "store.list",
})

# Exit code used by the 'crash' action: 128+9, what a shell reports for a
# kill -9 — postmortems grepping for OOM-killer/preemption kills match it.
CRASH_EXIT_CODE = 137

_FILTER_ENV = {"attempt": "TDC_ATTEMPT", "pid": "TDC_PROCESS_ID",
               "process": "TDC_PROCESS_ID"}


@dataclass
class FaultSpec:
    point: str
    action: str  # crash | kill | sigterm | exit | raise | delay
    arg: str | None  # exit code / exception name / seconds
    nth: int  # 1-based hit index the fault fires on
    from_nth_on: bool  # '@N+': fire on every hit >= nth
    filters: dict[str, str]  # env-var name -> required value

    def matches_env(self) -> bool:
        return all(os.environ.get(k) == v for k, v in self.filters.items())


class FaultSpecError(ValueError):
    """Malformed $TDC_FAULTS — raised at parse (first fault_point call),
    loudly: a typo'd chaos spec silently injecting nothing would make a
    chaos test pass vacuously."""


def parse_faults(spec: str) -> list[FaultSpec]:
    """Parse a TDC_FAULTS string; raises FaultSpecError on bad grammar."""
    out = []
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        point, sep, rest = entry.partition("=")
        if not sep or not point or not rest:
            raise FaultSpecError(
                f"bad TDC_FAULTS entry {entry!r}: want point=action[:arg]"
                f"[@N[+]][&key=value...]"
            )
        terms = rest.split("&")
        action_part = terms[0]
        filters = {}
        for term in terms[1:]:
            k, fsep, v = term.partition("=")
            if not fsep or not k:
                raise FaultSpecError(
                    f"bad filter {term!r} in TDC_FAULTS entry {entry!r}"
                )
            filters[_FILTER_ENV.get(k, f"TDC_{k.upper()}")] = v
        action_part, asep, nth_part = action_part.partition("@")
        nth, from_nth_on = 1, False
        if asep:
            if nth_part.endswith("+"):
                from_nth_on = True
                nth_part = nth_part[:-1]
            if not nth_part.isdigit() or int(nth_part) < 1:
                raise FaultSpecError(
                    f"bad trigger '@{nth_part}' in TDC_FAULTS entry "
                    f"{entry!r}: want @N or @N+ with N >= 1"
                )
            nth = int(nth_part)
        action, _, arg = action_part.partition(":")
        arg = arg or None
        if action not in ("crash", "kill", "sigterm", "exit", "raise",
                          "delay"):
            raise FaultSpecError(
                f"unknown fault action {action!r} in TDC_FAULTS entry "
                f"{entry!r}"
            )
        if action in ("exit", "raise", "delay") and arg is None:
            raise FaultSpecError(
                f"action {action!r} needs an argument "
                f"({action}:<value>) in TDC_FAULTS entry {entry!r}"
            )
        if action == "exit" and not arg.isdigit():
            raise FaultSpecError(f"exit code {arg!r} is not an integer")
        if action == "delay":
            try:
                float(arg)
            except ValueError:
                raise FaultSpecError(
                    f"delay seconds {arg!r} is not a number"
                ) from None
        out.append(FaultSpec(point.strip(), action, arg, nth, from_nth_on,
                             filters))
    return out


# Parse cache keyed by the raw spec string (env can change under
# monkeypatch; a changed string re-parses, the common unset case is one
# dict lookup) and per-point hit counters for this process.
_parsed: tuple[str, list[FaultSpec]] | None = None
_hits: dict[str, int] = {}


def reset() -> None:
    """Clear hit counters and the parse cache (test isolation)."""
    global _parsed
    _parsed = None
    _hits.clear()


def hit_count(point: str) -> int:
    return _hits.get(point, 0)


def _fire(spec: FaultSpec, n: int) -> None:
    # Log BEFORE acting: crash/kill never return, and a chaos postmortem
    # needs to see which injection a dead worker died of.
    from tdc_tpu_torch.utils.structlog import emit

    emit("fault_injected", point=spec.point, action=spec.action, hit=n)
    if spec.action == "crash":
        os._exit(CRASH_EXIT_CODE)
    elif spec.action == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif spec.action == "sigterm":
        os.kill(os.getpid(), signal.SIGTERM)
    elif spec.action == "exit":
        os._exit(int(spec.arg))
    elif spec.action == "raise":
        exc = getattr(builtins, spec.arg, None)
        if not (isinstance(exc, type) and issubclass(exc, BaseException)):
            raise FaultSpecError(
                f"raise:{spec.arg} is not a builtin exception"
            )
        raise exc(f"injected fault at {spec.point}")
    elif spec.action == "delay":
        time.sleep(float(spec.arg))


def fault_point(name: str) -> None:
    """Declare a named fault point; no-op unless $TDC_FAULTS targets it."""
    spec_str = os.environ.get(ENV_VAR)
    if not spec_str:
        return
    global _parsed
    if _parsed is None or _parsed[0] != spec_str:
        _parsed = (spec_str, parse_faults(spec_str))
        _hits.clear()
    eligible = [s for s in _parsed[1]
                if s.point == name and s.matches_env()]
    if not eligible:
        return
    n = _hits.get(name, 0) + 1
    _hits[name] = n
    for spec in eligible:
        if n == spec.nth or (spec.from_nth_on and n >= spec.nth):
            _fire(spec, n)


__all__ = [
    "CRASH_EXIT_CODE",
    "ENV_VAR",
    "KNOWN_POINTS",
    "FaultSpec",
    "FaultSpecError",
    "fault_point",
    "hit_count",
    "parse_faults",
    "reset",
]
