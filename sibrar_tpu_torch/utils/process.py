"""Process hygiene for multi-worker launches (port of
``sibrar_tpu/utils/process.py``): children that die with their parent
(Linux ``PR_SET_PDEATHSIG``) and the teardown of a child's whole process
group. Standard library only."""
from __future__ import annotations

import signal


def on_parent_exit(sig: int = signal.SIGTERM):
    """A ``preexec_fn`` for ``subprocess.Popen``: the child gets ``sig``
    when its parent dies."""
    import ctypes

    PR_SET_PDEATHSIG = 1

    def set_parent_exit_signal():
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        if libc.prctl(PR_SET_PDEATHSIG, sig) != 0:
            raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG) failed")

    return set_parent_exit_signal


def terminate_process_group(proc, sig: int = signal.SIGTERM) -> None:
    """Send ``sig`` to a child's whole process group (the child started
    with ``start_new_session=True``); a group that is gone is ignored."""
    import os

    try:
        os.killpg(os.getpgid(proc.pid), sig)
    except ProcessLookupError:
        pass
