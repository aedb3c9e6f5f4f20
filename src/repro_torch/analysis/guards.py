"""``guarded_by`` declarations: assert the owning lock is held on access.

Usage::

    @guarded_by("_acct_lock", "_outstanding", "_arrivals")
    class DynamicServer:
        ...

declares that ``self._outstanding``/``self._arrivals`` may only be read
or written while ``self._acct_lock`` is held.  The declaration is free
by default: it only appends to a registry.  When guards are enabled —
``REPRO_GUARDS=1`` in the environment at import time, or
:func:`enable_guards` at runtime — each declared field gets a data
descriptor that checks lock ownership on every access and raises
:class:`GuardViolation` with the offending field, lock and thread.
:func:`disable_guards` removes the descriptors again; values live in
the instance ``__dict__`` under their real names throughout, so
toggling mid-process hands them off seamlessly (the overhead benchmark
measures the same process with guards on and off).

Two deliberate allowances keep the checks sound without contorting
``__init__`` bodies:

* if the lock attribute does not exist yet, access is allowed —
  construction order (fields before locks) is not a data race;
* the *first binding* of a field (name not yet in the instance dict) is
  allowed — ``__init__`` assigns initial values before any other
  thread can see the object.

Ownership is checked via the lock's ``_is_owned()`` when present
(RLock, tracked locks); plain ``Lock`` falls back to ``locked()``,
which cannot attribute ownership to a thread but still catches
lock-free access.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Tuple, Type

ENV_VAR = "REPRO_GUARDS"


class GuardViolation(AssertionError):
    """A guarded attribute was touched without its owning lock held."""


def _env_enabled() -> bool:
    return os.environ.get(ENV_VAR, "0").lower() not in ("", "0", "false", "off")


_REGISTRY: List[Tuple[Type, str, Tuple[str, ...]]] = []
_enabled = False


class _GuardedField:
    """Data descriptor storing the value under its real name in the
    instance dict, so installing/removing the descriptor never moves
    data around."""

    __slots__ = ("name", "lock_attr", "owner_name")

    def __init__(self, name: str, lock_attr: str, owner_name: str):
        self.name = name
        self.lock_attr = lock_attr
        self.owner_name = owner_name

    def _check(self, inst, verb: str) -> None:
        lock = inst.__dict__.get(self.lock_attr)
        if lock is None:
            lock = getattr(inst, self.lock_attr, None)
        if lock is None:
            return  # construction: the lock doesn't exist yet
        owned = None
        is_owned = getattr(lock, "_is_owned", None)
        if callable(is_owned):
            try:
                owned = bool(is_owned())
            except Exception:
                owned = None
        if owned is None:
            locked = getattr(lock, "locked", None)
            owned = bool(locked()) if callable(locked) else True
        if not owned:
            raise GuardViolation(
                f"{self.owner_name}.{self.name} {verb} without holding "
                f"{self.lock_attr} (thread {threading.current_thread().name})")

    def __get__(self, inst, owner=None):
        if inst is None:
            return self
        try:
            value = inst.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None
        self._check(inst, "read")
        return value

    def __set__(self, inst, value) -> None:
        if self.name in inst.__dict__:
            self._check(inst, "written")
        inst.__dict__[self.name] = value

    def __delete__(self, inst) -> None:
        self._check(inst, "deleted")
        try:
            del inst.__dict__[self.name]
        except KeyError:
            raise AttributeError(self.name) from None


def guarded_by(lock_attr: str, *fields: str):
    """Class decorator declaring ``fields`` guarded by ``self.<lock_attr>``."""

    def deco(cls):
        spec = (cls, lock_attr, tuple(fields))
        _REGISTRY.append(spec)
        if _enabled:
            _install_spec(spec)
        return cls

    return deco


def _install_spec(spec) -> None:
    cls, lock_attr, fields = spec
    for name in fields:
        current = cls.__dict__.get(name)
        if isinstance(current, _GuardedField):
            continue
        setattr(cls, name, _GuardedField(name, lock_attr, cls.__name__))


def _remove_spec(spec) -> None:
    cls, _lock_attr, fields = spec
    for name in fields:
        if isinstance(cls.__dict__.get(name), _GuardedField):
            delattr(cls, name)


def enable_guards() -> None:
    """Install guard descriptors for every registered declaration."""
    global _enabled
    _enabled = True
    for spec in _REGISTRY:
        _install_spec(spec)


def disable_guards() -> None:
    """Remove all guard descriptors; classes revert to plain attributes."""
    global _enabled
    _enabled = False
    for spec in _REGISTRY:
        _remove_spec(spec)


def guards_enabled() -> bool:
    return _enabled


def registered() -> Dict[str, Dict[str, Tuple[str, ...]]]:
    """{class-name: {lock: fields}} — introspection for tests/CLI."""
    out: Dict[str, Dict[str, Tuple[str, ...]]] = {}
    for cls, lock_attr, fields in _REGISTRY:
        out.setdefault(cls.__name__, {})[lock_attr] = fields
    return out


if _env_enabled():
    _enabled = True
