"""Per-axis collective-schedule selection, ``FLAGS_comm_backend``
(counterpart of ``paddle_tpu/distributed/comm_backend.py:54-110`` and
``tp_overlap.py:76-98``: ``parse``, ``requested``, ``serving_requested``,
``train_requested``).

``FLAGS_comm_backend`` is a comma-separated ``axis=backend`` list
(``"mp=fused,dp=ring"``); a bare backend name applies to every axis. The
backends are the rungs of one schedule: ``gspmd`` (whole collectives),
``ring`` (n - 1 point-to-point hops) and ``fused`` (the hand-written
kernels of ``ops/fused_collectives.py``). Unknown backends warn once and
are dropped, as in the reference. The dp and pp axes' schedules come with
later slices (ROADMAP Queue A 11).
"""
from __future__ import annotations

import logging

from ..flags import get_flags

logger = logging.getLogger(__name__)

BACKENDS = ("gspmd", "ring", "fused")

_warned = set()


def _warn_once(key, msg):
    if key not in _warned:
        _warned.add(key)
        logger.warning(msg)


def parse(spec):
    """``"mp=fused,dp=ring"`` | ``"fused"`` | dict -> {axis: backend}.
    Unknown backends and garbage entries warn once and are dropped."""
    if not spec:
        return {}
    if isinstance(spec, dict):
        items = list(spec.items())
    else:
        items = []
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            if "=" in part:
                axis, _, backend = part.partition("=")
                items.append((axis.strip(), backend.strip()))
            else:
                items.append((None, part))        # bare backend: every axis
    out = {}
    for axis, backend in items:
        if backend not in BACKENDS:
            _warn_once(("backend", axis, backend),
                       f"FLAGS_comm_backend names unknown backend "
                       f"{backend!r} for axis {axis or '*'}; valid backends "
                       f"are {'/'.join(BACKENDS)}; entry ignored")
            continue
        if axis is None:
            for a in ("dp", "mp", "pp"):
                out[a] = backend
        else:
            out[axis] = backend
    return out


def requested(axis):
    """The backend ``FLAGS_comm_backend`` names for ``axis``, or None."""
    return parse(get_flags("FLAGS_comm_backend")["FLAGS_comm_backend"]
                 ).get(axis)


def train_requested():
    """The training step's mp rung from the flags, as the reference's
    ``tp_overlap.mp_backend_requested`` resolves it: None (no explicit
    schedule), 'rsag' (sequence-parallel layout, whole reduce-scatters and
    all-gathers), 'ring' (n - 1 point-to-point hops) or 'fused' (the
    hand-written kernels of ``ops/ring_gemm.py``). Naming mp=ring or
    mp=fused in ``FLAGS_comm_backend`` implies the sequence-parallel
    layout; mp=gspmd keeps it only under ``FLAGS_sequence_parallel``."""
    flags = get_flags(["FLAGS_sequence_parallel", "FLAGS_mp_overlap"])
    sp = bool(flags["FLAGS_sequence_parallel"])
    req = requested("mp")
    if req is None:
        if not sp:
            return None
        return "ring" if flags["FLAGS_mp_overlap"] else "rsag"
    if req == "gspmd":
        return "rsag" if sp else None
    return req


def serving_requested():
    """The serving engine's mp rung from ``FLAGS_comm_backend`` (None when
    the flag leaves mp alone: the engine then takes ``gspmd``). Every rung
    runs the same gather-only arithmetic; the backend moves bytes
    differently and never changes the math."""
    return requested("mp")
