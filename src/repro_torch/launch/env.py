"""Tuned launch environment: the process-level half of device overlap.

Counterpart of ``repro/launch/env.py``. The input pipeline hides
preprocessing behind device compute only if the host side is not held
back by its own runtime: glibc malloc serializes the multi-threaded
byte-buffer churn, which tcmalloc fixes. This module derives the launch
environment as data, so it is unit-testable and composes with an
existing environment instead of clobbering it:

    # print eval-able exports
    PYTHONPATH=src python -m repro_torch.launch.env

    # re-exec a training command under the tuned env (LD_PRELOAD must be
    # set before the process starts, so exec is the honest wiring)
    PYTHONPATH=src python -m repro_torch.launch.env -- \\
        python -m repro_torch.launch.train --arch stablelm_3b --smoke --device cpu

    # the same over four local ranks, a (2, 2) mesh
    PYTHONPATH=src python -m repro_torch.launch.env --devices 4 -- \\
        python -m repro_torch.launch.train --smoke --device cpu --model-parallel 2

Copied: ``TCMALLOC_CANDIDATES`` and ``find_tcmalloc`` (``:27-48``),
``merge_xla_flags`` (``:51``), ``tuned_env`` (``:64-97``), ``apply``
(``:100``), ``render_exports`` (``:124``) and ``main`` (``:129``), exec
after ``--`` included. Pinning N host devices for a CPU mesh is N local
ranks here: ``tuned_env(N)`` gives ``WORLD_SIZE=N``, and
``--devices N -- command ...`` execs ``python -m torch.distributed.run
--standalone --nproc-per-node N --no-python command ...``, which starts N
ranks of the command on this host. On the card N above the visible card
count raises with both numbers. Left out, each against its original:

* ``TF_CPP_MIN_LOG_LEVEL`` (``:83``): the port has no TensorFlow to
  silence;
* ``JAX_DEFAULT_DTYPE_BITS`` (``:85``): torch's default dtype is already
  fp32;
* the ``XLA_FLAGS`` pin (``:91-96``): nothing of the port reads XLA's flags;
  ``merge_xla_flags`` stays the string function it is.
"""

from __future__ import annotations

import argparse
import os
import shlex
from typing import Mapping, Sequence

# Preload candidates, most specific first: full tcmalloc, then the
# minimal build Debian/Ubuntu ship by default.
TCMALLOC_CANDIDATES: tuple[str, ...] = (
    "/usr/lib/x86_64-linux-gnu/libtcmalloc.so.4",
    "/usr/lib/x86_64-linux-gnu/libtcmalloc_minimal.so.4",
    "/usr/lib/libtcmalloc.so.4",
    "/usr/lib/libtcmalloc_minimal.so.4",
)

# Keep large transient buffers (flat byte buffers, token arrays) below
# tcmalloc's large-alloc report chatter.
TCMALLOC_REPORT_THRESHOLD = "60000000000"

def find_tcmalloc(candidates: Sequence[str] | None = None) -> str | None:
    """First present tcmalloc shared object, or None (then no preload)."""
    if candidates is None:
        candidates = TCMALLOC_CANDIDATES  # read at call time: patchable
    for path in candidates:
        if os.path.exists(path):
            return path
    return None


def merge_xla_flags(existing: str, *flags: str) -> str:
    """Append ``flags`` to an ``XLA_FLAGS`` string, letting the new value
    win when the same ``--flag=`` is already present. Copy of
    ``repro/launch/env.py:51``."""
    merged: list[str] = []
    names = {f.split("=", 1)[0] for f in flags}
    for tok in existing.split():
        if tok.split("=", 1)[0] not in names:
            merged.append(tok)
    merged.extend(flags)
    return " ".join(merged)


def tuned_env(host_device_count: int | None = None, *, tcmalloc: bool = True
              ) -> dict[str, str]:
    """The tuned launch variables as a plain dict: ``LD_PRELOAD`` and the
    report threshold when tcmalloc is present, and with
    ``host_device_count`` N the world of N local ranks, ``WORLD_SIZE=N``.
    The reference's ``base``, the ``XLA_FLAGS`` to merge with, has no
    counterpart: no variable of the port's extends an existing one."""
    env: dict[str, str] = {}
    if tcmalloc:
        lib = find_tcmalloc()
        if lib is not None:
            env["LD_PRELOAD"] = lib
            env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = TCMALLOC_REPORT_THRESHOLD
    if host_device_count is not None:
        if host_device_count < 1:
            raise ValueError(f"host_device_count must be >= 1, got {host_device_count}")
        env["WORLD_SIZE"] = str(host_device_count)
    return env


def rank_command(n: int, command: Sequence[str]) -> list[str]:
    """``command`` run as ``n`` local ranks by ``torch.distributed.run``
    (installed with torch); on a host with a card, ``n`` must not exceed
    the visible cards."""
    import sys

    import torch

    if torch.cuda.is_available() and n > torch.cuda.device_count():
        raise SystemExit(f"--devices {n}: {torch.cuda.device_count()} visible card(s)")
    return [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={n}", "--no-python", *command]


def apply(env: Mapping[str, str] | None = None, *, overwrite: bool = False) -> dict[str, str]:
    """Set the tuned variables on ``os.environ`` and return what was set.

    Values the user already exported win unless ``overwrite=True``. Note
    ``LD_PRELOAD`` only affects *future* processes (worker spawns, an
    ``exec``'d trainer): preloading the current process is the wrapper
    shell's job (see the module's docstring)."""
    env = tuned_env() if env is None else dict(env)
    applied: dict[str, str] = {}
    for k, v in env.items():
        if overwrite or k not in os.environ:
            os.environ[k] = v
            applied[k] = v
    return applied


def render_exports(env: Mapping[str, str]) -> str:
    """Eval-able ``export K=V`` lines for a wrapper shell."""
    return "\n".join(f"export {k}={shlex.quote(v)}" for k, v in sorted(env.items()))


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, default=None,
                    help="run the command as this many local ranks (torch.distributed.run)")
    ap.add_argument("--no-tcmalloc", action="store_true", help="skip the LD_PRELOAD probe")
    ap.add_argument("command", nargs="*",
                    help="after '--': command to exec under the tuned environment")
    args = ap.parse_args(argv)
    env = tuned_env(args.devices, tcmalloc=not args.no_tcmalloc)
    if args.command:
        command = list(args.command)
        if args.devices is not None:
            env.pop("WORLD_SIZE")  # torch.distributed.run sets each rank's
            command = rank_command(args.devices, command)
        os.environ.update(env)
        os.execvpe(command[0], command, os.environ)
    print(render_exports(env))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
