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

Copied: ``TCMALLOC_CANDIDATES`` and ``find_tcmalloc`` (``:27-48``),
``tuned_env``'s ``LD_PRELOAD`` and ``TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD``
(``:64-97``), ``apply`` (``:100``), ``render_exports`` (``:124``) and
``main`` (``:129``), exec after ``--`` included. Left out, each against
its original:

* ``TF_CPP_MIN_LOG_LEVEL`` (``:83``): the port has no TensorFlow to
  silence;
* ``JAX_DEFAULT_DTYPE_BITS`` (``:85``): torch's default dtype is already
  fp32;
* ``merge_xla_flags`` (``:51``) and ``--devices`` (``:133``): they pin a
  host device count for a CPU mesh, which waits for the port's mesh
  (ROADMAP.md Queue 1 item 6.4); until then ``tuned_env(host_device_count)``
  and ``--devices`` raise.
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

NO_MESH = ("a host device count pins a CPU mesh, which the port does not have yet "
           "(ROADMAP.md Queue 1 item 6.4)")


def find_tcmalloc(candidates: Sequence[str] | None = None) -> str | None:
    """First present tcmalloc shared object, or None (then no preload)."""
    if candidates is None:
        candidates = TCMALLOC_CANDIDATES  # read at call time: patchable
    for path in candidates:
        if os.path.exists(path):
            return path
    return None


def tuned_env(host_device_count: int | None = None, *, tcmalloc: bool = True
              ) -> dict[str, str]:
    """The tuned launch variables as a plain dict: ``LD_PRELOAD`` and the
    report threshold when tcmalloc is present. The reference's ``base``,
    the ``XLA_FLAGS`` to merge with, has no counterpart: no variable of
    the port's extends an existing one. ``host_device_count`` raises."""
    if host_device_count is not None:
        raise NotImplementedError(f"host_device_count={host_device_count}: {NO_MESH}")
    env: dict[str, str] = {}
    if tcmalloc:
        lib = find_tcmalloc()
        if lib is not None:
            env["LD_PRELOAD"] = lib
            env["TCMALLOC_LARGE_ALLOC_REPORT_THRESHOLD"] = TCMALLOC_REPORT_THRESHOLD
    return env


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
                    help="refused: pins a host device count for a CPU mesh (Queue 1 item 6.4)")
    ap.add_argument("--no-tcmalloc", action="store_true", help="skip the LD_PRELOAD probe")
    ap.add_argument("command", nargs="*",
                    help="after '--': command to exec under the tuned environment")
    args = ap.parse_args(argv)
    if args.devices is not None:
        raise SystemExit(f"--devices {args.devices}: {NO_MESH}")
    env = tuned_env(tcmalloc=not args.no_tcmalloc)
    if args.command:
        os.environ.update(env)
        os.execvpe(args.command[0], list(args.command), os.environ)
    print(render_exports(env))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
