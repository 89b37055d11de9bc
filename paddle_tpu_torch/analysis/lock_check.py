"""Runtime validator for ``# guarded-by:`` annotations.

The static race pass (race_rules.py) accepts a ``# guarded-by: <attr>``
comment on a ``def`` line as the claim "every caller holds
``self.<attr>`` here" — that is what keeps ``ReplicaRouter._pick`` and
``_Ring._slot`` out of the unguarded-shared-state rule.  A claim the
analyzer trusts must be checkable, or it rots into a suppression
mechanism: this module makes the claim executable.

``install(cls)`` (usable as a class decorator) re-reads the class
source, finds the annotated methods, and wraps each so that — when the
analysis mode is ``strict`` (``PT_ANALYSIS=strict``, the tier-1 test
default for the serving suites) — entering the method without the named
lock held raises ``GuardViolation``.  Under the default ``off`` mode the
wrapper is a single ``mode()`` check; nothing imports jax and no lock
is ever touched.

The check is the strongest one plain ``threading`` exposes: ``Lock``
reports only ``locked()`` (held by *someone*), ``RLock`` reports
``_is_owned()`` (held by *this* thread).  A lock object exposing
neither is skipped — annotated code on exotic lock types degrades to
static-only checking rather than false-failing.

The comment in the source stays the single source of truth: there is no
second registry to drift.  If the annotation moves or is deleted,
``install`` finds nothing and wraps nothing.
"""
from __future__ import annotations

import functools
import inspect
import re

from . import mode

__all__ = ["GuardViolation", "guards_of", "install"]

_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([\w]+(?:\s*,\s*[\w]+)*)")
_DEF_RE = re.compile(r"^\s*(?:async\s+)?def\s+(\w+)")


class GuardViolation(AssertionError):
    """A ``# guarded-by:`` method was entered without its lock held."""


def guards_of(cls) -> dict:
    """{method name: set of lock attr names} for every annotated def in
    ``cls``'s source (annotation on the def line or the line above)."""
    try:
        src = inspect.getsource(cls)
    except (OSError, TypeError):          # no source (REPL, frozen)
        return {}
    lines = src.splitlines()
    out: dict = {}
    for i, line in enumerate(lines):
        m = _GUARDED_BY_RE.search(line)
        if not m:
            continue
        dm = _DEF_RE.match(line)
        if dm is None and i + 1 < len(lines):
            dm = _DEF_RE.match(lines[i + 1])
        if dm:
            out.setdefault(dm.group(1), set()).update(
                x.strip() for x in m.group(1).split(","))
    return out


def _held(lock):
    """True/False when determinable; None when this lock type can't say."""
    probe = getattr(lock, "locked", None)        # Lock: held by someone
    if probe is None:
        probe = getattr(lock, "_is_owned", None)  # RLock: held by US
    if not callable(probe):
        return None
    try:
        return bool(probe())
    except Exception:
        return None


def _wrap(fn, locks, owner: str):
    @functools.wraps(fn)
    def guard(self, *args, **kwargs):
        if mode() == "strict":
            for attr in locks:
                lock = getattr(self, attr, None)
                if lock is not None and _held(lock) is False:
                    raise GuardViolation(
                        f"{owner}.{fn.__name__} is annotated "
                        f"`# guarded-by: {attr}` but `self.{attr}` is "
                        f"not held — the caller broke the documented "
                        f"lock discipline")
        return fn(self, *args, **kwargs)
    guard.__pt_guarded_by__ = tuple(locks)
    return guard


def install(cls):
    """Wrap ``cls``'s ``# guarded-by:``-annotated methods with the
    strict-mode hold check.  Idempotent; returns ``cls`` so it works as
    a class decorator."""
    for name, locks in sorted(guards_of(cls).items()):
        fn = cls.__dict__.get(name)
        if fn is None or not callable(fn) \
                or getattr(fn, "__pt_guarded_by__", None):
            continue
        setattr(cls, name, _wrap(fn, sorted(locks), cls.__name__))
    return cls
