"""Runtime lock-order witness: instrumented Lock/RLock wrappers.

The static graph in ``lockorder.py`` is an over-approximation of what *may*
happen; this module records what *does* happen.  Wrap the runtime's locks with
:class:`LockWitness` before a concurrency soak, run the soak, then call
``assert_consistent(static_edges)``:

- observed acquisition orders must themselves be acyclic (an A-under-B and
  B-under-A pair observed at runtime is an inversion even if the soak got
  lucky and never deadlocked), and
- combined with the static graph they must stay acyclic -- an observed edge
  whose reverse is statically possible is a latent deadlock.

Static analysis proposes, the witness disposes.

Wrappers are drop-in: they support the context-manager protocol,
``acquire(blocking, timeout)``/``release``, and the private hooks
``threading.Condition`` uses (``_is_owned``/``_release_save``/
``_acquire_restore``), so a ``Condition`` built on a witnessed lock keeps
working -- including the release-reacquire dance inside ``wait()``, which the
witness tracks as a real release and a real (ordered) re-acquire.

Instance names may carry an ``[instance]`` suffix (``Backend.cond[FLASK]``);
it distinguishes instances for cycle detection (holding one backend's
condition while taking another's is an ordering hazard even though the static
graph has a single ``Backend.cond`` node) and is stripped when comparing
against static node ids.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple


def base_name(name: str) -> str:
    """Strip the ``[instance]`` suffix: ``Backend.cond[FLASK]`` -> ``Backend.cond``."""
    return name.split("[", 1)[0]


@dataclass
class ObservedEdge:
    src: str
    dst: str
    count: int = 0
    thread: str = ""


class LockWitness:
    """Registry of witnessed locks + the acquisition-order edges they record."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._edges: Dict[Tuple[str, str], ObservedEdge] = {}
        self._acquires: Dict[str, int] = {}
        self._tls = threading.local()

    # -- wrapping -----------------------------------------------------------
    def wrap(self, name: str, *, reentrant: bool = False) -> "WitnessedLock":
        return WitnessedLock(self, name, reentrant=reentrant)

    # -- recording (called by WitnessedLock) --------------------------------
    def _held_stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def on_acquired(self, name: str) -> None:
        stack = self._held_stack()
        with self._mu:
            self._acquires[name] = self._acquires.get(name, 0) + 1
        if stack:
            with self._mu:
                for held in stack:
                    key = (held, name)
                    e = self._edges.get(key)
                    if e is None:
                        e = self._edges[key] = ObservedEdge(held, name)
                    e.count += 1
                    e.thread = threading.current_thread().name
        stack.append(name)

    def on_released(self, name: str) -> None:
        stack = self._held_stack()
        # release may be out of LIFO order (hand-over-hand): drop the most
        # recent matching entry.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == name:
                del stack[i]
                return

    # -- results ------------------------------------------------------------
    def acquire_counts(self) -> Dict[str, int]:
        """Outermost acquisitions seen per lock name — lets a soak assert it
        actually exercised the witnessed locks even when no nesting (and so
        no edge) was ever observed."""
        with self._mu:
            return dict(self._acquires)

    def edges(self) -> List[ObservedEdge]:
        with self._mu:
            return sorted(self._edges.values(), key=lambda e: (e.src, e.dst))

    def edge_set(self, *, strip_instances: bool = False) -> Set[Tuple[str, str]]:
        out = set()
        for e in self.edges():
            if strip_instances:
                out.add((base_name(e.src), base_name(e.dst)))
            else:
                out.add((e.src, e.dst))
        return out

    def assert_consistent(
        self,
        static_edges: Optional[Iterable[Tuple[str, str]]] = None,
        *,
        reentrant: Iterable[str] = (),
    ) -> None:
        """Raise AssertionError on any observed inversion.

        ``static_edges`` are (src, dst) pairs from the static graph (base
        names).  ``reentrant`` lists base names whose self-edges are legal
        (RLocks).
        """
        observed = self.edge_set()
        reent = set(reentrant)
        for a, b in observed:
            if a == b and base_name(a) not in reent:
                raise AssertionError(f"witness: non-reentrant lock {a} re-acquired while held")
        cycle = _find_cycle({(a, b) for a, b in observed if a != b})
        if cycle:
            raise AssertionError(f"witness: runtime lock-order cycle: {' -> '.join(cycle)}")
        if static_edges is not None:
            static = {(a, b) for a, b in static_edges if a != b}
            stripped = {(base_name(a), base_name(b)) for a, b in observed
                        if base_name(a) != base_name(b)}
            combined = static | stripped
            cycle = _find_cycle(combined)
            if cycle:
                raise AssertionError(
                    "witness: observed order inverts the static lock-order graph: "
                    + " -> ".join(cycle))

    def unknown_edges(self, static_edges: Iterable[Tuple[str, str]]) -> Set[Tuple[str, str]]:
        """Observed orderings the static graph never predicted (informational:
        usually a sign the static extraction should learn a new call path)."""
        static = set(static_edges)
        return {e for e in self.edge_set(strip_instances=True)
                if e not in static and e[0] != e[1]}


def _find_cycle(edges: Set[Tuple[str, str]]) -> Optional[List[str]]:
    adj: Dict[str, List[str]] = {}
    for a, b in edges:
        adj.setdefault(a, []).append(b)
    state: Dict[str, int] = {}
    path: List[str] = []

    def dfs(n: str) -> Optional[List[str]]:
        state[n] = 1
        path.append(n)
        for m in adj.get(n, []):
            if state.get(m, 0) == 1:
                return path[path.index(m):] + [m]
            if state.get(m, 0) == 0:
                got = dfs(m)
                if got:
                    return got
        path.pop()
        state[n] = 2
        return None

    for n in list(adj):
        if state.get(n, 0) == 0:
            got = dfs(n)
            if got:
                return got
    return None


class WitnessedLock:
    """Drop-in Lock/RLock wrapper that reports acquisition order.

    Reentrant mode tracks per-thread depth so only the outermost
    acquire/release record edges (matching RLock semantics).
    """

    def __init__(self, witness: LockWitness, name: str, *, reentrant: bool = False):
        self._witness = witness
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._tls = threading.local()

    def _depth(self) -> int:
        return getattr(self._tls, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            d = self._depth()
            if d == 0:
                self._witness.on_acquired(self.name)
            self._tls.depth = d + 1
        return got

    def release(self) -> None:
        d = self._depth()
        self._inner.release()
        self._tls.depth = max(0, d - 1)
        if self._tls.depth == 0:
            self._witness.on_released(self.name)

    def __enter__(self) -> "WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        inner = self._inner
        return inner.locked() if hasattr(inner, "locked") else self._depth() > 0

    # Condition-protocol hooks: Python's Condition falls back to calling
    # acquire/release when these are missing, but defining _is_owned avoids
    # its try-acquire probe (which would record a spurious self-edge).
    def _is_owned(self) -> bool:
        return self._depth() > 0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<WitnessedLock {self.name} reentrant={self.reentrant}>"


# ---------------------------------------------------------------------------
# One-line wiring helpers for the runtime's objects.  Call while the object
# is idle (before start()/first traffic).
# ---------------------------------------------------------------------------


def instrument_router(router, witness: LockWitness) -> None:
    """Witness the router registry lock and every backend's condition."""
    router._lock = witness.wrap("StraightLineRouter._lock")
    for tier, b in router.backends.items():
        lk = witness.wrap(f"Backend.cond[{getattr(tier, 'name', tier)}]")
        b.lock = lk
        b.cond = threading.Condition(lk)


def instrument_engine(engine, witness: LockWitness, name: str = "_EngineBase.lock") -> None:
    """Witness an InferenceEngine/PagedInferenceEngine coarse step RLock.

    The default name matches the static graph's node id (the lock is declared
    on both engine classes; the extractor collapses them onto their common
    base), so observed edges line up with ``load_static_edges`` output."""
    engine.lock = witness.wrap(name, reentrant=True)


def instrument_loop(loop, witness: LockWitness) -> None:
    """Witness an EngineLoop registry lock (and its engine's step lock)."""
    loop._lock = witness.wrap("EngineLoop._lock")
    instrument_engine(loop.engine, witness)


def instrument_sampler(sampler, witness: LockWitness) -> None:
    sampler._lock = witness.wrap("MonitorSampler._lock")


def instrument_tracer(tracer, witness: LockWitness) -> None:
    tracer._lock = witness.wrap("Tracer._lock")


def instrument_build(witness: LockWitness):
    """Witness the kernel library's two module-level locks in place, under
    the static graph's node ids: ``_build._lock`` (the one build of a
    process) and ``_build._count_lock`` (every launch's count). The wrappers
    read the module globals at call time, so the swap takes effect at once;
    call it while no kernel is being built or counted. Returns a function
    that puts the original locks back."""
    from repro_torch.kernels import _build

    saved = (_build._lock, _build._count_lock)
    _build._lock = witness.wrap("_build._lock")
    _build._count_lock = witness.wrap("_build._count_lock")

    def restore() -> None:
        _build._lock, _build._count_lock = saved

    return restore
