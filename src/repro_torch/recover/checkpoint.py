"""SolveCheckpoint: a consistent on-disk snapshot of a running solve.

A checkpoint captures everything the coordinator owns at one arrival
boundary — the iterate ``x``, the rng state, the Anderson/DIIS window,
the elastic-membership assignment, the SDC-guard state and every
accounting counter — plus the backend's own resumable loop state (the
virtual backend's event heap; cadence counters elsewhere).  Arrival
boundaries are the engine's consistency points: no apply, fire or record
is mid-flight, so restoring the snapshot is exact, with at-most-once
commit semantics — work applied after the checkpoint was never committed
into it and is simply redone, never double-counted.

On-disk format: ``<dir>/<tag>.json`` (scalars, membership, history, rng
state) plus ``<tag>.npz`` (the iterate, the Anderson window rows, heap
payload arrays).  Writes are atomic (tmp + rename), so a crash mid-write
never leaves a half checkpoint as the latest one.  This is the port's copy
of the reference's module, in the same format (``FORMAT_VERSION`` 1).

The Anderson window lives on the problem's device: :func:`capture` pulls
it to the host through ``AndersonState.snapshot`` and
:func:`restore_coordinator` puts it back through ``AndersonState.restore``.
At the Jacobi g = 2048 size a checkpoint holds the iterate plus the
window's X, G and F rows, 19 vectors of 33.6 MB at depth 6.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..core.engine.types import FaultProfile

__all__ = [
    "SolveCheckpoint",
    "write_checkpoint",
    "latest_checkpoint",
    "list_checkpoints",
    "resolve_checkpoint",
    "restore_coordinator",
]

FORMAT_VERSION = 1

#: Coordinator counters checkpointed / restored verbatim (all JSON scalars).
_COUNTERS = (
    "wu", "drops", "stale_drops", "crashes", "restarts",
    "staleness_sum", "staleness_n", "coordinator_evals", "arrivals",
    "since_record", "offloaded_evals", "accel_discards", "busy_s",
    "fire_window_s", "fire_window_arrivals", "_x_version", "_res_version",
    "res_norm", "preemptions", "joins", "reassigned_blocks",
    "preempt_discards", "_membership_version", "accel_partial_commits",
    "sdc_rejects", "quarantined", "checkpoints_written", "controller_actions",
)


@dataclass
class SolveCheckpoint:
    """One loaded (or about-to-be-written) checkpoint.

    ``meta`` is the JSON document; ``arrays`` the npz payload.  ``tag`` is
    the checkpoint's identity (``ckpt-<wu>``), recorded on the resumed
    run's ``RunResult.resumed_from``.
    """

    meta: dict
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)
    path: Optional[str] = None  # the .json path once saved/loaded

    @property
    def tag(self) -> str:
        return self.meta["tag"]

    @property
    def wu(self) -> int:
        return int(self.meta["wu"])

    @property
    def t(self) -> float:
        return float(self.meta["t"])

    @property
    def loop(self) -> dict:
        """The backend loop state captured with the snapshot (may be {})."""
        return self.meta.get("loop") or {}

    # ------------------------------------------------------------------ #
    def save(self, directory: str) -> str:
        """Write ``<tag>.json`` + ``<tag>.npz`` atomically; returns the
        json path."""
        os.makedirs(directory, exist_ok=True)
        base = os.path.join(directory, self.tag)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **self.arrays)
            os.replace(tmp, base + ".npz")
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".json.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.meta, f)
            os.replace(tmp, base + ".json")
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        self.path = base + ".json"
        return self.path

    @classmethod
    def load(cls, path: str) -> "SolveCheckpoint":
        """Load from a ``.json`` path (the sibling ``.npz`` rides along)."""
        if path.endswith(".npz"):
            path = path[:-4] + ".json"
        with open(path) as f:
            meta = json.load(f)
        if meta.get("format") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint format {meta.get('format')!r} "
                f"in {path} (expected {FORMAT_VERSION})")
        arrays: Dict[str, np.ndarray] = {}
        npz_path = path[:-5] + ".npz"
        with np.load(npz_path) as z:
            for k in z.files:
                arrays[k] = z[k]
        return cls(meta=meta, arrays=arrays, path=path)


def list_checkpoints(directory: str) -> list:
    """All checkpoint json paths under ``directory``, oldest first."""
    if not os.path.isdir(directory):
        return []
    names = [n for n in os.listdir(directory)
             if n.startswith("ckpt-") and n.endswith(".json")]
    return [os.path.join(directory, n) for n in sorted(names)]


def latest_checkpoint(directory: str) -> Optional[SolveCheckpoint]:
    """Load the most recent checkpoint in ``directory`` (None if empty)."""
    paths = list_checkpoints(directory)
    return SolveCheckpoint.load(paths[-1]) if paths else None


def resolve_checkpoint(ref) -> SolveCheckpoint:
    """Normalize ``RunConfig.resume_from``: a SolveCheckpoint passes
    through, a path to a ``.json`` (or a checkpoint directory) loads."""
    if isinstance(ref, SolveCheckpoint):
        return ref
    if isinstance(ref, str):
        if os.path.isdir(ref):
            ckpt = latest_checkpoint(ref)
            if ckpt is None:
                raise FileNotFoundError(f"no checkpoints under {ref!r}")
            return ckpt
        return SolveCheckpoint.load(ref)
    raise TypeError(
        f"resume_from must be a SolveCheckpoint or a path, got {type(ref)}")


# --------------------------------------------------------------------- #
# Capture
# --------------------------------------------------------------------- #
def capture(coord, t: float, loop_state=None) -> SolveCheckpoint:
    """Snapshot a coordinator (plus optional backend loop state) into an
    in-memory SolveCheckpoint.  ``loop_state`` is ``None`` or a
    ``(meta_dict, arrays_dict)`` pair from the backend's loop."""
    meta: dict = {
        "format": FORMAT_VERSION,
        "tag": f"ckpt-{coord.wu:08d}",
        "t": float(t),
        "wu": int(coord.wu),
        "executor": coord.cfg.executor,
        "seed": int(coord.cfg.seed),
        "n_workers": int(coord.cfg.n_workers),
        "rng": _jsonable(coord.rng.bit_generator.state),
        "history": [[float(ht), int(hw), float(hr)]
                    for ht, hw, hr in coord.history],
        "counters": {},
        "membership": {
            "active": sorted(coord.active),
            "paused": sorted(coord.paused),
            "worker_blocks": {str(w): list(bs)
                              for w, bs in coord.worker_blocks.items()},
            "block_owner": {str(b): int(w)
                            for b, w in coord.block_owner.items()},
            "orphan_blocks": list(coord._orphan_blocks),
            "rr": {str(w): int(c) for w, c in coord._rr.items()},
            "preempt_gen": {str(w): int(g)
                            for w, g in coord.preempt_gen.items()},
            "applied_by_worker": {str(w): int(c)
                                  for w, c in coord.applied_by_worker.items()},
            "block_moved_at": {str(b): int(v)
                               for b, v in coord._block_moved_at.items()},
            "scenario_down": sorted(coord.scenario_down),
            "live_profiles": {str(w): dataclasses.asdict(p)
                              for w, p in coord.live_profiles.items()},
        },
        "sdc": {
            "norms": [float(v) for v in coord._sdc_norms],
            "strikes": {str(w): int(s)
                        for w, s in coord._sdc_strikes.items()},
            # Block keys are (start, stop, step)/(first, last, size)
            # tuples; flatten to [k0, k1, k2, count] rows for JSON.
            "block_rejects": [[*k, int(n)] for k, n in
                              coord._sdc_block_rejects.items()],
        },
        "loop": None,
        "arrays": [],
    }
    for name in _COUNTERS:
        v = getattr(coord, name)
        meta["counters"][name] = (
            int(v) if isinstance(v, (int, np.integer)) else float(v))
    arrays: Dict[str, np.ndarray] = {"x": np.asarray(coord.x, np.float64)}
    if coord.accel is not None:
        snap = coord.accel.snapshot()
        meta["accel"] = {k: snap[k] for k in
                         ("n_accept", "n_reject", "n_fire")}
        meta["accel"]["has_window"] = "X" in snap
        if snap.get("last_alpha") is not None:
            arrays["accel_last_alpha"] = snap["last_alpha"]
        for k in ("X", "G", "F"):
            if k in snap:
                arrays[f"accel_{k}"] = snap[k]
    if loop_state is not None:
        loop_meta, loop_arrays = loop_state
        meta["loop"] = loop_meta
        arrays.update(loop_arrays)
    meta["arrays"] = sorted(arrays)
    return SolveCheckpoint(meta=meta, arrays=arrays)


def write_checkpoint(coord, t: float, loop_state=None) -> str:
    """Capture + save under ``coord.cfg.checkpoint_dir`` (the hook
    :meth:`Coordinator.maybe_checkpoint` calls)."""
    return capture(coord, t, loop_state).save(coord.cfg.checkpoint_dir)


def _jsonable(obj):
    """Recursively convert a bit_generator state dict to JSON scalars."""
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _rng_state(obj):
    """Inverse of :func:`_jsonable` for bit_generator state: numpy's
    setters accept plain ints/lists, so this is a pass-through."""
    return obj


# --------------------------------------------------------------------- #
# Restore
# --------------------------------------------------------------------- #
def restore_coordinator(coord, ckpt: SolveCheckpoint) -> None:
    """Load a checkpoint into a freshly constructed Coordinator.

    The coordinator must have been built from the *same problem and an
    equivalent config* (same partition, same accel settings) — the
    checkpoint stores solver state, not the problem operator.  After this
    the backend seeds its loop from ``ckpt.loop`` and runs; counters pick
    up exactly where the snapshot left them (at-most-once: post-snapshot
    work was never committed and is redone).
    """
    meta = ckpt.meta
    if int(meta["n_workers"]) != coord.cfg.n_workers:
        raise ValueError(
            f"checkpoint was taken with n_workers={meta['n_workers']}, "
            f"resume config has {coord.cfg.n_workers}")
    x = np.asarray(ckpt.arrays["x"], np.float64)
    if x.shape != coord.x.shape:
        raise ValueError(
            f"checkpoint iterate has shape {x.shape}, problem produces "
            f"{coord.x.shape} — wrong problem?")
    coord.x = x.copy()
    coord.rng.bit_generator.state = _rng_state(meta["rng"])
    for name, v in meta["counters"].items():
        setattr(coord, name, v)
    coord.history = [(float(ht), int(hw), float(hr))
                     for ht, hw, hr in meta["history"]]
    mem = meta["membership"]
    coord.active = set(mem["active"])
    coord.paused = set(mem["paused"])
    coord.worker_blocks = {int(w): list(bs)
                           for w, bs in mem["worker_blocks"].items()}
    coord.block_owner = {int(b): int(w)
                         for b, w in mem["block_owner"].items()}
    coord._orphan_blocks = list(mem["orphan_blocks"])
    coord._rr = {int(w): int(c) for w, c in mem["rr"].items()}
    coord.preempt_gen = {int(w): int(g)
                         for w, g in mem["preempt_gen"].items()}
    coord.applied_by_worker = {int(w): int(c)
                               for w, c in mem["applied_by_worker"].items()}
    coord._block_moved_at = {int(b): int(v)
                             for b, v in mem["block_moved_at"].items()}
    coord.scenario_down = set(mem["scenario_down"])
    coord.live_profiles = {int(w): FaultProfile(**p)
                           for w, p in mem["live_profiles"].items()}
    sdc = meta.get("sdc") or {}
    coord._sdc_norms = [float(v) for v in sdc.get("norms", [])]
    coord._sdc_strikes = {int(w): int(s)
                          for w, s in sdc.get("strikes", {}).items()}
    coord._sdc_block_rejects = {
        tuple(None if k is None else int(k) for k in rowv[:-1]): int(rowv[-1])
        for rowv in sdc.get("block_rejects", [])}
    if coord.accel is not None and "accel" in meta:
        snap = dict(meta["accel"])
        snap["last_alpha"] = ckpt.arrays.get("accel_last_alpha")
        for k in ("X", "G", "F"):
            if f"accel_{k}" in ckpt.arrays:
                snap[k] = ckpt.arrays[f"accel_{k}"]
        coord.accel.restore(snap)
    # Resume provenance + cadence: never rewrite the checkpoint we resumed
    # from at the same wu.
    coord.resumed_from = ckpt.tag
    coord._last_ckpt_wu = int(meta["wu"])
    tel = coord.telemetry
    if tel is not None:
        tel.instant("restore", "coord", float(ckpt.t),
                    tag=str(ckpt.tag), wu=int(meta["wu"]))
