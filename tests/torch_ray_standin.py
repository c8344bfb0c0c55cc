"""A stand-in for the part of Ray's API that the Ray backends use.

Both packages' ``RayExecutor`` call seven things of ``ray``: ``remote`` on
a class (with ``.remote`` on the class and on its methods, and
``.options(num_gpus=, num_cpus=)``), ``put``, ``get`` (also with
``timeout=``), ``wait(refs, num_returns=1, timeout=)``, ``kill(actor,
no_restart=True)``, ``init`` and ``is_initialized``.  This module provides
those, keeping Ray's semantics where a backend could trip on them:

* each actor is its own process, forked from a server that has imported
  torch but opened no CUDA context (as Ray keeps idle worker processes
  ready), whose calls run one at a time, in the order they were
  submitted;
* arguments and results are pickled (protocol 5, arrays out of band);
  an argument is copied when the call is submitted, a ``put`` when it is
  made; between processes a buffer of 64 KiB or more travels as a file
  under ``/dev/shm`` that the reader maps (Ray's object store is shared
  memory too), a smaller one through the actor's pipe;
* an ``ObjectRef`` passed at the top level of a call arrives resolved;
* numpy arrays that come out of the store are read-only, as Ray's
  zero-copy reads are (they are rebuilt over immutable ``bytes``);
* ``wait`` returns ready refs in completion order;
* ``get(timeout=)`` raises :class:`GetTimeoutError`, a ``TimeoutError``;
* a method that raises makes ``get`` raise that exception (its remote
  traceback chained as a :class:`RayTaskError`);
* an actor whose constructor raises, or that was killed, fails every ref
  it still owes and every later call with :class:`RayActorError`;
* an actor started without ``num_gpus`` gets ``CUDA_VISIBLE_DEVICES=""``,
  as Ray does for actors that ask for no GPU; one with ``num_gpus`` gets
  the index of the card it was assigned (fractions pack onto a card, as
  Ray's do).  The cards are those ``init(num_gpus=)`` declares, else those
  ``CUDA_VISIBLE_DEVICES`` or torch sees.

Differences from Ray: a call whose top-level argument is the ref of a call
still running waits for it at submission (Ray defers the call instead),
and an actor that asks for more GPU than is free raises at creation (Ray
leaves it pending).

``RAY_STANDIN_MODE=thread`` runs each actor in a thread of the calling
process instead, with the same pickling and read-only semantics; it
serves short CPU runs that cannot afford an interpreter start per actor,
and runs no GPU actor.

The module is test scaffolding: it is never imported as ``ray`` in the
pytest process.  A child interpreter calls :func:`install` before it
imports either package, and every actor process does the same before it
imports its class.
"""

from __future__ import annotations

import atexit
import importlib
import importlib.util
import itertools
import mmap
import multiprocessing as mp
import os
import pickle
import queue
import sys
import threading
import time
import traceback
import types
from typing import Dict, List, Optional

__all__ = ["remote", "put", "get", "wait", "kill", "init", "is_initialized",
           "shutdown", "install", "actors_created", "ObjectRef",
           "exceptions", "RayError", "RayTaskError", "RayActorError",
           "GetTimeoutError"]


class RayError(Exception):
    """Base of the stand-in's errors (``ray.exceptions.RayError``)."""


class RayTaskError(RayError):
    """A method raised; carries its remote traceback."""


class RayActorError(RayError):
    """The actor died (its constructor raised, or it was killed) before
    the call could return."""


class GetTimeoutError(RayError, TimeoutError):
    """``get(timeout=)`` expired before every ref was ready."""


exceptions = types.SimpleNamespace(
    RayError=RayError, RayTaskError=RayTaskError,
    RayActorError=RayActorError, GetTimeoutError=GetTimeoutError)

_MODE = os.environ.get("RAY_STANDIN_MODE", "process")
_CTX = mp.get_context("forkserver")
_LOCK = threading.Condition()  # guards the store, the actors and the cards
_IDS = itertools.count(1)
_SEQ = itertools.count(1)
_STORE: Dict[int, list] = {}  # id -> [state, completion seq, parts, error]
_ACTORS: List["_Actor"] = []
_THREADS: List[threading.Thread] = []  # thread-mode actors, joined at exit
_CARDS: Optional[List[list]] = None  # [[visible id, free fraction], ...]
_STATE = {"initialized": False, "created": 0}
_PENDING, _READY, _ERROR = 0, 1, 2


def install() -> None:
    """Make ``import ray`` return this module (call before importing a
    package whose Ray backend should register)."""
    sys.modules["ray"] = sys.modules[__name__]


def actors_created() -> int:
    """How many actors this process has created so far."""
    return _STATE["created"]


# --------------------------------------------------------------------- #
# Serialization: a value is (head, [buffer, ...]) — pickle protocol 5 with
# its buffers out of band.  Between processes a buffer of _SHM_MIN bytes or
# more travels as a file under /dev/shm that the reader maps read-only (as
# Ray's object store does); a smaller one, and every buffer in thread mode,
# is copied into immutable bytes.
# --------------------------------------------------------------------- #
_SHM_DIR = "/dev/shm"
_SHM_MIN = 1 << 16
_SEGS = itertools.count(1)
_PREFIX = f"ray_standin_{os.getpid()}_"  # the driver's, inherited by actors


class _Seg:
    """A buffer in a file under ``_SHM_DIR``, mapped read-only when read.

    The driver unlinks a file it wrote once nothing holds it (the store
    entry and the calls that carry it), and an actor's result file as soon
    as it has mapped it; a mapping outlives its file."""

    def __init__(self, name: str, size: int, owned: bool):
        self.name, self.size, self.owned, self._view = name, size, owned, None

    @classmethod
    def write(cls, raw, owned: bool) -> "_Seg":
        name = f"{_PREFIX}{os.getpid()}_{next(_SEGS)}"
        fd = os.open(os.path.join(_SHM_DIR, name),
                     os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o600)
        try:
            mv, off = memoryview(raw).cast("B"), 0
            while off < len(mv):
                off += os.write(fd, mv[off:])
        finally:
            os.close(fd)
        return cls(name, len(mv), owned)

    @classmethod
    def adopt(cls, name: str, size: int) -> "_Seg":
        """Map an actor's result file and unlink it."""
        seg = cls(name, size, owned=False)
        seg.view()
        os.unlink(os.path.join(_SHM_DIR, name))
        return seg

    def view(self) -> memoryview:
        if self._view is None:
            fd = os.open(os.path.join(_SHM_DIR, self.name), os.O_RDONLY)
            try:
                # Populate the page tables in one call: read lazily, a
                # tmpfs mapping takes a fault for every 4 KiB page.
                self._view = memoryview(mmap.mmap(
                    fd, self.size, prot=mmap.PROT_READ,
                    flags=mmap.MAP_SHARED | getattr(mmap, "MAP_POPULATE",
                                                    0)))
            finally:
                os.close(fd)
        return self._view

    def __del__(self):
        if self.owned:
            try:
                os.unlink(os.path.join(_SHM_DIR, self.name))
            except (FileNotFoundError, TypeError, AttributeError):
                pass


def _shared() -> bool:
    return _MODE == "process" and os.path.isdir(_SHM_DIR)


def _dumps(value, owned: bool = True):
    bufs: list = []
    head = pickle.dumps(value, protocol=5, buffer_callback=bufs.append)
    shared = _shared()
    return head, [_Seg.write(raw, owned)
                  if shared and raw.nbytes >= _SHM_MIN else bytes(raw)
                  for raw in (b.raw() for b in bufs)]


def _loads(parts):
    head, bufs = parts
    return pickle.loads(head, buffers=[
        b.view() if isinstance(b, _Seg) else b for b in bufs])


def _send(conn, meta, parts) -> None:
    layout = [[(b.name, b.size) if isinstance(b, _Seg) else len(b)
               for b in bufs] for _, bufs in parts]
    conn.send((meta, layout))
    for head, bufs in parts:
        conn.send_bytes(head)
        for b in bufs:
            if not isinstance(b, _Seg):
                conn.send_bytes(b)


def _recv(conn, adopt: bool):
    """``(meta, parts)`` off ``conn``; ``adopt``: the files are an actor's
    results, which the reader unlinks once mapped."""
    meta, layout = conn.recv()
    parts = []
    for bufs in layout:
        head = conn.recv_bytes()
        parts.append((head, [
            conn.recv_bytes() if isinstance(b, int)
            else (_Seg.adopt(*b) if adopt else _Seg(*b, owned=False))
            for b in bufs]))
    return meta, parts


def _remove_files() -> None:
    """Files left under ``_SHM_DIR`` by actors that were killed mid-reply
    (the driver's call only: actors share its prefix)."""
    if _PREFIX != f"ray_standin_{os.getpid()}_":
        return
    try:
        names = os.listdir(_SHM_DIR)
    except OSError:
        return
    for name in names:
        if name.startswith(_PREFIX):
            try:
                os.unlink(os.path.join(_SHM_DIR, name))
            except OSError:
                pass


# --------------------------------------------------------------------- #
# Object store (the driver's)
# --------------------------------------------------------------------- #
class ObjectRef:
    """A handle to a value in the store; its entry is freed with it."""

    __slots__ = ("id",)

    def __init__(self, oid: int):
        self.id = oid

    def __repr__(self) -> str:
        return f"ObjectRef({self.id})"

    def __del__(self):
        try:
            with _LOCK:
                _STORE.pop(self.id, None)
        except Exception:  # interpreter teardown
            pass


def _new_ref(parts=None) -> ObjectRef:
    oid = next(_IDS)
    with _LOCK:
        _STORE[oid] = ([_READY, next(_SEQ), parts, None] if parts is not None
                       else [_PENDING, 0, None, None])
    return ObjectRef(oid)


def _settle(oid: int, parts=None, error=None) -> None:
    with _LOCK:
        entry = _STORE.get(oid)
        if entry is not None and entry[0] == _PENDING:
            entry[:] = [_ERROR if error is not None else _READY, next(_SEQ),
                        parts, error]
        _LOCK.notify_all()


def put(value) -> ObjectRef:
    """Copy ``value`` into the store."""
    return _new_ref(_dumps(value))


def _wait_done(refs, count: int, timeout: Optional[float]):
    deadline = None if timeout is None else time.monotonic() + timeout
    with _LOCK:
        while True:
            done = [r for r in refs if _STORE[r.id][0] != _PENDING]
            if len(done) >= count:
                return done
            left = None if deadline is None else deadline - time.monotonic()
            if left is not None and left <= 0:
                return done
            _LOCK.wait(left)


def _value(ref: ObjectRef):
    with _LOCK:
        state, _, parts, error = _STORE[ref.id]
    if state == _ERROR:
        raise _raise_of(error)
    return _loads(parts)


def _raise_of(error) -> BaseException:
    kind, parts, text = error
    if kind == "actor":
        return RayActorError(text)
    remote_tb = RayTaskError(text)
    try:
        exc = _loads(parts)
    except Exception:
        return remote_tb
    exc.__cause__ = remote_tb
    return exc


def get(refs, *, timeout: Optional[float] = None):
    """The value of one ref, or a list of values; raises what the method
    raised, :class:`RayActorError` for a dead actor and
    :class:`GetTimeoutError` when ``timeout`` expires first."""
    single = isinstance(refs, ObjectRef)
    seq = [refs] if single else list(refs)
    if len(_wait_done(seq, len(seq), timeout)) < len(seq):
        raise GetTimeoutError(f"get timed out after {timeout} s")
    out = [_value(r) for r in seq]
    return out[0] if single else out


def wait(refs, *, num_returns: int = 1, timeout: Optional[float] = None):
    """``(ready, not_ready)``: at most ``num_returns`` ready refs, in the
    order they completed, once that many are ready or ``timeout`` ends."""
    refs = list(refs)
    done = _wait_done(refs, num_returns, timeout)
    with _LOCK:
        done.sort(key=lambda r: _STORE[r.id][1])
    ready = done[:num_returns]
    taken = {id(r) for r in ready}
    return ready, [r for r in refs if id(r) not in taken]


def init(*, num_gpus: Optional[int] = None, **_kw) -> None:
    """Start the stand-in and, in process mode, the server its actors are
    forked from (keyword arguments of ``ray.init`` other than ``num_gpus``
    are accepted and ignored)."""
    global _CARDS
    with _LOCK:
        _STATE["initialized"] = True
        if num_gpus is not None:
            _CARDS = [[str(i), 1.0] for i in range(num_gpus)]
    if _MODE == "process":
        # The server imports torch once (no CUDA context: the actors open
        # their own), so that an actor's start is a fork, not an import.
        from multiprocessing import forkserver

        _CTX.set_forkserver_preload(["__main__"] + [
            m for m in ("numpy", "torch") if importlib.util.find_spec(m)])
        forkserver.ensure_running()


def is_initialized() -> bool:
    return _STATE["initialized"]


def _cards() -> List[list]:
    global _CARDS
    if _CARDS is None:
        env = os.environ.get("CUDA_VISIBLE_DEVICES")
        if env is not None:
            ids = [c.strip() for c in env.split(",") if c.strip()]
        else:
            try:
                import torch

                ids = [str(i) for i in range(torch.cuda.device_count())]
            except ImportError:
                ids = []
        _CARDS = [[i, 1.0] for i in ids]
    return _CARDS


def _assign_card(share: float) -> list:
    with _LOCK:
        for card in _cards():
            if card[1] + 1e-9 >= share:
                card[1] -= share
                return card
    raise RuntimeError(f"no card has {share} of a GPU free "
                       f"(cards: {_cards()})")


# --------------------------------------------------------------------- #
# Actors
# --------------------------------------------------------------------- #
def _resolve_class(module: str, qualname: str):
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return getattr(obj, "_cls", obj)  # an ActorClass wraps the class


def _serve(next_msg, reply, cls_of) -> None:
    """An actor's loop: the first message constructs the instance, each
    later one calls a method; every call is answered with ("ok", tid),
    ("err", tid, traceback) or, when the constructor raised, ("died",
    tid, traceback) after which the actor stops."""
    inst = None
    while True:
        msg = next_msg()
        if msg is None:
            return
        (tid, method, kw), parts = msg
        try:
            vals = [_loads(p) for p in parts]
            args, kwargs = vals[:len(vals) - len(kw)], dict(
                zip(kw, vals[len(vals) - len(kw):]))
            if method is None:
                inst = cls_of()(*args, **kwargs)
                out = None
            else:
                out = getattr(inst, method)(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001 - shipped to the caller
            text = traceback.format_exc()
            if method is None:
                reply(("died", tid, text), [])
                return
            try:
                parts = [_dumps(e, owned=False)]
            except Exception:
                parts = []
            reply(("err", tid, text), parts)
            continue
        reply(("ok", tid, None), [_dumps(out, owned=False)])


def _actor_main(task_conn, result_conn, module: str, qualname: str,
                visible: Optional[str], prefix: str) -> None:
    """Body of an actor process."""
    global _MODE, _PREFIX
    _MODE, _PREFIX = "process", prefix
    if visible is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = visible
    install()
    inbox: "queue.Queue" = queue.Queue()

    def reader() -> None:
        # Drain the pipe as calls arrive, so a caller never blocks on a
        # busy actor longer than the transfer itself.
        try:
            while True:
                inbox.put(_recv(task_conn, adopt=False))
        except (EOFError, OSError):
            inbox.put(None)

    threading.Thread(target=reader, daemon=True).start()
    _serve(inbox.get, lambda meta, parts: _send(result_conn, meta, parts),
           lambda: _resolve_class(module, qualname))


class _Actor:
    """The driver's side of one actor: its calls, its owed refs."""

    def __init__(self, cls, args, kwargs, options):
        self.share = float(options.get("num_gpus") or 0.0)
        self.card = None
        if self.share:
            if _MODE == "thread":
                raise ValueError("thread-mode actors run no GPU work")
            self.card = _assign_card(self.share)
        # ref id -> the call's arguments, kept (with their files) until the
        # actor answers
        self.owed: Dict[int, list] = {}
        self.dead: Optional[str] = None
        self.send_lock = threading.Lock()
        if _MODE == "thread":
            self.inbox: "queue.Queue" = queue.Queue()
            self.thread = threading.Thread(
                target=_serve, args=(self.inbox.get, self._reply,
                                     lambda: cls),
                daemon=True)
            self.thread.start()
            _THREADS.append(self.thread)
            self.proc = None
        else:
            visible = self.card[0] if self.card is not None else ""
            task_r, self.task_w = _CTX.Pipe(duplex=False)
            self.result_r, result_w = _CTX.Pipe(duplex=False)
            self.proc = _CTX.Process(
                target=_actor_main,
                args=(task_r, result_w, cls.__module__, cls.__qualname__,
                      visible, _PREFIX),
                daemon=True)
            self.proc.start()
            task_r.close()
            result_w.close()
            threading.Thread(target=self._receive, daemon=True).start()
        with _LOCK:
            _ACTORS.append(self)
            _STATE["created"] += 1
        self.init_ref = self.call(None, args, kwargs)

    # ---- calls -------------------------------------------------------- #
    def call(self, method, args, kwargs) -> ObjectRef:
        parts = [self._arg(a) for a in args]
        parts += [self._arg(v) for v in kwargs.values()]
        ref = _new_ref()
        tid = ref.id
        with _LOCK:
            dead = self.dead
            if dead is None:
                self.owed[tid] = parts
        if dead is not None:
            _settle(tid, error=("actor", None, dead))
            return ref
        msg = ((tid, method, tuple(kwargs)), parts)
        if self.proc is None:
            self.inbox.put(msg)
        else:
            try:
                with self.send_lock:
                    _send(self.task_w, *msg)
            except (OSError, ValueError):
                self._die("the actor's process is gone")
        return ref

    @staticmethod
    def _arg(a):
        if isinstance(a, ObjectRef):
            # A top-level ref arrives as its value.
            _wait_done([a], 1, None)
            with _LOCK:
                state, _, parts, error = _STORE[a.id]
            if state == _ERROR:
                raise _raise_of(error)
            return parts
        return _dumps(a)

    # ---- replies ------------------------------------------------------ #
    def _reply(self, meta, parts) -> None:
        kind, tid, text = meta
        if kind == "died":  # the constructor raised
            self._die("the actor died in its constructor:\n" + text)
            return
        with _LOCK:
            if self.dead is not None or self.owed.pop(tid, None) is None:
                return
        if kind == "ok":
            _settle(tid, parts=parts[0])
        else:
            _settle(tid, error=("task", parts[0] if parts else None, text))

    def _receive(self) -> None:
        try:
            while True:
                self._reply(*_recv(self.result_r, adopt=True))
        except (EOFError, OSError):
            self._die("the actor's process exited")

    def _die(self, reason: str) -> None:
        with _LOCK:
            if self.dead is not None:
                return
            self.dead = reason
            owed, self.owed = list(self.owed), {}
            if self.card is not None:
                self.card[1] += self.share
                self.card = None
        for tid in owed:
            _settle(tid, error=("actor", None, reason))

    # ---- lifecycle ---------------------------------------------------- #
    def kill(self) -> None:
        self._die("the actor was killed")
        if self.proc is None:
            while True:  # drop queued calls; the thread ends after its call
                try:
                    self.inbox.get_nowait()
                except queue.Empty:
                    break
            self.inbox.put(None)
            return
        self.proc.terminate()
        self.proc.join(5.0)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(5.0)
        for conn in (self.task_w, self.result_r):
            try:
                conn.close()
            except OSError:
                pass


class ActorHandle:
    def __init__(self, actor: _Actor):
        self._actor = actor

    def __getattr__(self, name: str) -> "_ActorMethod":
        if name.startswith("_"):
            raise AttributeError(name)
        return _ActorMethod(self._actor, name)


class _ActorMethod:
    def __init__(self, actor: _Actor, name: str):
        self._actor, self._name = actor, name

    def remote(self, *args, **kwargs) -> ObjectRef:
        return self._actor.call(self._name, args, kwargs)


class ActorClass:
    """What ``remote`` makes of a class."""

    def __init__(self, cls, options=None):
        self._cls = cls
        self._options = dict(options or {})
        self.__module__ = cls.__module__
        self.__qualname__ = cls.__qualname__
        self.__name__ = cls.__name__
        self.__doc__ = cls.__doc__

    def options(self, *, num_gpus=None, num_cpus=None, **kw) -> "ActorClass":
        return ActorClass(self._cls, dict(self._options, num_gpus=num_gpus,
                                          num_cpus=num_cpus, **kw))

    def remote(self, *args, **kwargs) -> ActorHandle:
        if not _STATE["initialized"]:
            init()
        return ActorHandle(_Actor(self._cls, args, kwargs, self._options))


def remote(cls):
    """``@ray.remote`` on a class."""
    if not isinstance(cls, type):
        raise TypeError("the stand-in's remote() takes classes only")
    return ActorClass(cls)


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    """End the actor now: the refs it owes, and later calls, fail."""
    actor._actor.kill()


def shutdown() -> None:
    """Kill every actor, wait for thread-mode actors to finish the call
    they are in (a thread still in native code when the interpreter ends
    would abort it), and forget the cards."""
    global _CARDS
    with _LOCK:
        actors = list(_ACTORS)
        _ACTORS.clear()
        _STATE["initialized"] = False
    for a in actors:
        a.kill()
    while _THREADS:
        _THREADS.pop().join(60.0)
    _remove_files()
    _CARDS = None


atexit.register(shutdown)


# --------------------------------------------------------------------- #
# Child interpreters
# --------------------------------------------------------------------- #
def child_main(jobs_path: str, out_path: str) -> int:
    """Run the jobs pickled at ``jobs_path`` with this module installed as
    ``ray`` and pickle their results to ``out_path``.

    A job is ``("module:function", kwargs)``; its result is ``("ok",
    value)`` or ``("error", traceback)``.
    """
    install()
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    out = []
    for target, kwargs in jobs:
        module, func = target.split(":")
        try:
            out.append(("ok", getattr(importlib.import_module(module),
                                      func)(**kwargs)))
        except BaseException:  # noqa: BLE001 - reported to the parent
            out.append(("error", traceback.format_exc()))
    shutdown()
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0
