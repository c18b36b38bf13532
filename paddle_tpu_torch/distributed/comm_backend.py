"""Per-axis collective-schedule selection, ``FLAGS_comm_backend``
(counterpart of ``paddle_tpu/distributed/comm_backend.py:54-110`` and
``tp_overlap.py:76-98``: ``parse``, ``requested``, ``serving_requested``,
``train_requested``).

``FLAGS_comm_backend`` is a comma-separated ``axis=backend`` list
(``"mp=fused,dp=ring"``); a bare backend name applies to every axis. The
backends are the rungs of one schedule: ``gspmd`` (whole collectives),
``ring`` (n - 1 point-to-point hops) and ``fused`` (the hand-written
kernels of ``ops/fused_collectives.py``); the training mp axis also has
``rsag`` (whole reduce-scatters and all-gathers in the sequence-parallel
layout), which a bare name gives the mp axis alone. Unknown backends warn
once and are dropped, as in the reference. ``HybridTrainStep``'s
``comm_backend`` takes the same list for its three axes
(``"mp=fused,pp=ring,dp=fused"``). The pp axis resolves through
``resolve_pp`` (reference :141-285); the dp axis's rung through
``distributed/grad_comm.py:resolve`` (the eager ``TrainStep``) or
``resolve_hybrid`` (``HybridTrainStep``), which read the ``dp`` entry
here.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import torch

from ..flags import get_flags

logger = logging.getLogger(__name__)

BACKENDS = ("gspmd", "ring", "fused")
MP_TRAIN_ONLY = ("rsag",)          # a training mp rung no other axis has

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
        mp_only = backend in MP_TRAIN_ONLY and axis in (None, "mp")
        if backend not in BACKENDS and not mp_only:
            _warn_once(("backend", axis, backend),
                       f"FLAGS_comm_backend names unknown backend "
                       f"{backend!r} for axis {axis or '*'}; valid backends "
                       f"are {'/'.join(BACKENDS)}; entry ignored")
            continue
        if axis is None:
            for a in (("mp",) if mp_only else ("dp", "mp", "pp")):
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


# ---------------------------------------------------------------------------
# pp axis: the explicit pipeline schedule (FLAGS_comm_backend='pp=...')
#
#   * ring  -- the stages' boundary hops are point-to-point sends posted at
#     the end of each tick of the explicit GPipe or 1F1B schedule
#     (distributed/pipeline.py);
#   * fused -- ring, plus the last GEMM of each sending stage runs as the
#     hand-written boundary kernel whose wrapper posts the hop
#     (ops/pp_boundary.py), with its backward kernels.
#
# The reference's third rung, gspmd, is its partitioner-placed pipeline;
# the port has no GSPMD schedule (and the reference's carries the known
# 1F1B backward defect, tests/test_pp_backend.py:7-9), so wherever the
# reference falls back to it the port raises with the reference's text.

WIRE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class PpConfig:
    """Static pp schedule of one pipelined step."""
    n: int               # stage count
    backend: str         # "ring" | "fused"
    schedule: str        # "gpipe" | "1f1b": what the schedule RUNS
    wire_dtype: object   # boundary wire torch dtype, or None = compute dtype


def _no_gspmd(msg):
    raise ValueError(msg + " (the port has no GSPMD pp schedule to fall "
                     "back to)")


def resolve_pp(config, n, comm_backend=None, batch=None,
               num_microbatches=1, mp=1, zero3=False, extra_axes=(),
               device=None, dp=1):
    """The pp schedule of a step over ``n`` stages: a ``PpConfig``, or None
    when ``n <= 1``.

    The rung comes from ``comm_backend`` (``"pp=ring"``, ``"pp=fused"``,
    a bare ``"ring"``/``"fused"``, or a dict as ``parse`` takes it), else
    from ``FLAGS_comm_backend``; with no pp rung named the port runs
    ``"ring"`` with ``config.pp_schedule``. The reference's bail matrix
    (comm_backend.py:167-285) holds, but where the reference falls back to
    its GSPMD schedule the port raises with the reference's fix-naming
    text: virtual stages (``pp_interleave > 1``), ZeRO stage 3, other mesh
    axes, a batch that ``num_microbatches`` does not divide, a microbatch
    that ``dp`` does not divide (the schedule shards each microbatch over
    dp), and ``pp=gspmd``. An active mp axis (``mp > 1``) runs inside each
    stage on the ring rung; ``pp=fused`` with ``mp > 1`` raises, naming
    ``pp=ring`` (the reference steps down to ring there with a warning,
    the port never steps down). ``pp=fused`` with ``pp_schedule="1f1b"``
    runs GPipe with the reference's warning. ``FLAGS_pp_wire_dtype`` (``auto`` /
    ``float32`` / ``bfloat16``) sets the ring rung's wire; the fused rung
    ignores it with the reference's warning. On CUDA (``device``) the
    fused rung needs a bfloat16 compute dtype: its kernels take nothing
    else, and it raises rather than step down to ring."""
    if n <= 1:
        return None
    req = parse(comm_backend).get("pp") if comm_backend else None
    req = req or requested("pp")
    if req == "gspmd":
        _no_gspmd("FLAGS_comm_backend='pp=gspmd' names the reference's "
                  "GSPMD pipeline; set 'pp=ring' or 'pp=fused'")
    backend = req or "ring"
    if getattr(config, "pp_interleave", 1) > 1:
        _no_gspmd("the explicit pp schedule does not interleave virtual "
                  "stages yet; set config.pp_interleave=1")
    if zero3 or getattr(config, "zero3_params", False):
        _no_gspmd("ZeRO stage-3 FSDP params need the GSPMD per-layer "
                  "all-gather inside the stage scan, which a full-manual "
                  "region cannot emit; set zero_stage=1 (host offload of "
                  "optimizer moments composes either way)")
    if mp > 1 and backend == "fused":
        raise ValueError(
            f"pp=fused boundary kernels take the plain (mp=1) block tail; "
            f"with an active mp axis (mp={mp}) set comm_backend='pp=ring' "
            f"(the mp schedule then runs inside each stage)")
    if extra_axes:
        _no_gspmd(f"the explicit pp schedule binds the whole mesh "
                  f"manually; axes {list(extra_axes)} must be size 1 (set "
                  f"them to 1 in create_hybrid_mesh)")
    M = int(num_microbatches)
    if batch is not None and batch % M:
        _no_gspmd(f"batch {batch} not divisible by num_microbatches={M} "
                  f"(choose a microbatch count dividing the global batch)")
    if batch is not None and dp > 1 and (batch // M) % dp:
        _no_gspmd(f"microbatch size {batch // M} not divisible by dp={dp}; "
                  f"the explicit schedule shards each microbatch over dp — "
                  f"lower num_microbatches (or the dp degree)")
    schedule = getattr(config, "pp_schedule", "1f1b") or "1f1b"
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pp_schedule {schedule!r}; choose "
                         f"'gpipe' or '1f1b'")
    if backend == "fused" and schedule == "1f1b":
        _warn_once("pp-fused-1f1b",
                   "pp=fused runs the gpipe autodiff schedule (the 1f1b "
                   "combined tick needs a scan-carried cotangent hop); "
                   "set FLAGS_comm_backend='pp=ring' to keep the 1f1b "
                   "schedule explicit")
        schedule = "gpipe"
    raw = get_flags("FLAGS_pp_wire_dtype")["FLAGS_pp_wire_dtype"]
    wire = None
    if raw not in ("auto", None, ""):
        wire = WIRE_DTYPES.get(raw)
        if wire is None:
            _warn_once(("pp-wire", raw),
                       f"FLAGS_pp_wire_dtype={raw!r} unsupported for the "
                       f"boundary wire (float32/bfloat16/auto) — using the "
                       f"compute dtype; set FLAGS_pp_wire_dtype='bfloat16' "
                       f"for the compressed wire")
    if backend == "fused" and wire is not None:
        _warn_once(("pp-fused-wire", raw),
                   "pp=fused issues the boundary RDMA from the GEMM epilogue "
                   "at the compute dtype (a cast copy would reintroduce the "
                   "buffer the kernel exists to remove) — "
                   "FLAGS_pp_wire_dtype ignored; set "
                   "FLAGS_comm_backend='pp=ring' to compress the wire")
        wire = None
    if backend == "fused" and device is not None and \
            torch.device(device).type == "cuda" and \
            (config.compute_dtype or "float32") != "bfloat16":
        raise ValueError(
            f"pp=fused on CUDA runs the boundary kernels, which take "
            f"bfloat16 operands, not compute_dtype="
            f"{config.compute_dtype!r}; choose compute_dtype='bfloat16' "
            f"or comm_backend='pp=ring'")
    return PpConfig(n=int(n), backend=backend, schedule=schedule,
                    wire_dtype=wire)
