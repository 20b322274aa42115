"""Graceful preemption (counterpart: tdc_tpu/utils/preempt.py): SIGTERM
-> checkpoint at the next safe boundary -> exit with a code a supervisor
tells apart from a crash.

With `install_preemption_handler()` a SIGTERM only sets a flag. The
streamed fits (models/streaming.py) read it at each batch boundary on
one rank, or once per pass on a gang (every rank of a mesh must stop
after the same pass, or the next all_reduce waits forever:
`sync_requested(gang=True)` is one all_reduce(MAX) over the fit's
ranks). The fit then checkpoints and raises `Preempted`, a SystemExit
carrying PREEMPTED_EXIT_CODE, so the process exits with that code and no
traceback.

Gang contract: install the handler on every rank or on none; the
per-pass agreement is a collective that only runs when it is installed.
A second SIGTERM during a drain exits at once, still with the code.
"""

from __future__ import annotations

import os
import signal
import threading

# 75 = EX_TEMPFAIL (sysexits.h): "temporary failure, retry later";
# distinct from a signal death (> 128) and a Python traceback (1).
PREEMPTED_EXIT_CODE = 75


class Preempted(SystemExit):
    """Raised by the fits at the checkpoint boundary after a SIGTERM.
    A SystemExit: uncaught, the process exits PREEMPTED_EXIT_CODE with
    no traceback, and `except Exception` never swallows it."""

    def __init__(self, message: str = "preempted"):
        super().__init__(PREEMPTED_EXIT_CODE)
        self.message = message

    def __str__(self) -> str:
        return self.message


_state = {"installed": False, "requested": False}


def install_preemption_handler(signals=(signal.SIGTERM,)) -> None:
    """Install the drain-on-SIGTERM handler (main thread only; a no-op
    once installed)."""
    if _state["installed"]:
        return
    if threading.current_thread() is not threading.main_thread():
        raise RuntimeError(
            "install_preemption_handler must run on the main thread "
            "(signal.signal requirement)")
    for sig in signals:
        signal.signal(sig, _on_signal)
    _state["installed"] = True
    _state["signals"] = tuple(signals)


def reinstall_if_installed() -> None:
    """Install the handler again if it was ever installed: after anything
    that registers its own SIGTERM handler on top of it."""
    if not _state["installed"]:
        return
    if threading.current_thread() is not threading.main_thread():
        return
    for sig in _state.get("signals", (signal.SIGTERM,)):
        signal.signal(sig, _on_signal)


def _on_signal(signum, frame) -> None:
    if _state["requested"]:
        # The grace window is running out: leave now, with the code.
        os._exit(PREEMPTED_EXIT_CODE)
    _state["requested"] = True
    # Signal context: no buffered I/O (a print into a stream the signal
    # interrupted raises 'reentrant call'); one raw write to fd 2.
    try:
        os.write(2, b'{"event": "preempt_requested", "signal": %d, '
                    b'"pid": %d}\n' % (signum, os.getpid()))
    except OSError:
        pass


def installed() -> bool:
    return _state["installed"]


def requested() -> bool:
    """Has a preemption notice arrived? (This process's flag.)"""
    return _state["requested"]


def request() -> None:
    """Raise the flag without a signal (tests, or a runtime that learns of
    a preemption from an API). A gang honours it only where the handler is
    installed on every rank (the per-pass agreement runs only then)."""
    _state["requested"] = True


def reset() -> None:
    """Clear the flag (tests). Does not uninstall the handler."""
    _state["requested"] = False


def sync_requested(gang: bool = False, mesh=None, device=None) -> bool:
    """The gang's agreed preemption check. gang=False reads this
    process's flag. gang=True is a collective every rank of the fit must
    call the same number of times: one all_reduce(MAX) of the flag over
    the mesh's data axes (the whole process group without a mesh), on
    `device` (a CUDA device under NCCL); True on every rank iff any rank
    has the flag."""
    local = requested()
    if not gang:
        return local
    import torch
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() <= 1:
        return local
    flag = torch.tensor([int(local)], dtype=torch.int32,
                        device=device or "cpu")
    if mesh is None:
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    else:
        from tdc_tpu_torch.parallel.mesh import data_axes

        mesh.psum(flag, *data_axes(mesh), op=dist.ReduceOp.MAX)
    return bool(int(flag.item()) > 0)


__all__ = ["PREEMPTED_EXIT_CODE", "Preempted", "install_preemption_handler",
           "installed", "reinstall_if_installed", "request", "requested",
           "reset", "sync_requested"]
