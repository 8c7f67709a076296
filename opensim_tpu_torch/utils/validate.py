"""Registered input validators — the port's copy of
``opensim_tpu/utils/validate.py``.

Every place untrusted input (CLI args, YAML documents, REST bodies)
crosses into the filesystem goes through one of these functions or a
``@sanitizer``-decorated validator next to the code it guards (the
campaign planner's ``_resolve_path``). The decorator marks a function as
such a validator (the JAX package's taint lint keys on it; the port has
no lint yet, ROADMAP Queue 1 item 11). Validators raise ``ValueError`` on
rejection so the CLI/REST surfaces render the usual one-liner.
"""

from __future__ import annotations

import os

__all__ = ["sanitizer", "user_path", "child_path"]


def sanitizer(fn):
    """Mark ``fn`` as an input validator; the attribute makes the mark
    introspectable at run time."""
    fn.__taint_sanitizer__ = True
    return fn


@sanitizer
def user_path(p, *, label: str = "path", allow_empty: bool = False) -> str:
    """Validate a user-supplied filesystem path (CLI flags, config
    references). Rejects control characters — the class of input that
    turns log lines, shell handoffs, and error messages into injection
    vectors — and empty strings unless the flag is optional."""
    s = os.fspath(p)
    if not s:
        if allow_empty:
            return s
        raise ValueError(f"empty {label}")
    if any(ord(c) < 32 for c in s):
        raise ValueError(f"invalid {label}: control character in {s!r}")
    return s


@sanitizer
def child_path(base: str, rel, *, label: str = "path") -> str:
    """Resolve a spec-relative path against its document's directory.
    Absolute paths pass through (the CLI trust domain allows them — the
    operator already has file access); relative paths are joined,
    normalized, and must stay UNDER ``base`` — a ``..`` escape out of the
    spec's directory is rejected. Control characters are rejected either
    way."""
    s = user_path(rel, label=label)
    if os.path.isabs(s) or not base:
        return s
    resolved = os.path.normpath(os.path.join(base, s))
    root = os.path.normpath(base)
    if resolved != root and not resolved.startswith(root + os.sep):
        raise ValueError(
            f"invalid {label}: {s!r} escapes the spec directory {base!r}"
        )
    return resolved
