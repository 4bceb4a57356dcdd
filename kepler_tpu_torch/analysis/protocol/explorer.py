"""kepmc explicit-state explorer: exhaustive BFS over a protocol model.

The fleet's chaos tests sample a few dozen interleavings per run; each of
the elastic-membership bugs hid in a schedule they happened not to draw. This explorer
closes that gap at small scope: a model exposes an initial state, a
successor relation (every event any component could take next), and
safety invariants — the explorer walks EVERY reachable state
breadth-first, so the first state violating an invariant yields a
MINIMAL event trace (BFS discovery order is shortest-path order).

Design points, in the TLC tradition:

- **Canonical hashable states.** A state is a plain tuple the model
  builds; hashing dedupes revisits, so duplicate/reorder events (which
  loop back to seen states) terminate naturally.
- **Bounded scope.** Models cap epochs/windows/records; the explorer
  additionally hard-caps the state count (``max_states``) and raises
  :class:`StateExplosionError` instead of silently truncating — a
  truncated "all clear" would be a false negative.
- **Possibility goals.** Pure safety misses wedges ("awaiting forever"
  is a liveness failure). A model may declare a ``goal`` predicate and
  a ``goal_event_ok`` label filter; after the forward sweep the
  explorer computes backward reachability from the goal states over
  the permitted edges — any reachable state that can NEVER reach a
  goal state is reported with its (minimal) discovery trace. This is
  TLA+'s "eventually possible" weakening of liveness, which is exactly
  what a wedge violates.

No clocks, no randomness, no I/O: same model → same exploration,
state-for-state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Hashable, Iterable, Protocol

__all__ = [
    "Counterexample",
    "ExplorationResult",
    "ProtocolModel",
    "StateExplosionError",
    "explore",
]

State = Hashable


class StateExplosionError(RuntimeError):
    """The model's reachable space outgrew the declared scope cap —
    the SPEC is wrong (unbounded epoch/seq growth), not the fleet."""


class ProtocolModel(Protocol):
    """What the explorer needs from a model (duck-typed; the concrete
    models in :mod:`.models` drive the real fleet transition code)."""

    def initial(self) -> State: ...

    def successors(self, state: State) -> Iterable[tuple[str, State]]: ...

    def violations(self, state: State) -> Iterable[tuple[str, str]]: ...

    def describe_state(self, state: State) -> str: ...


@dataclasses.dataclass(frozen=True)
class Counterexample:
    """One invariant violation, with the shortest event schedule that
    reaches it from the initial state — the review surface."""

    invariant: str
    detail: str
    trace: tuple[str, ...]
    state_repr: str

    def format(self) -> str:
        steps = "\n".join(f"  {i + 1}. {ev}"
                          for i, ev in enumerate(self.trace)) or "  (initial state)"
        return (f"invariant `{self.invariant}` violated: {self.detail}\n"
                f"minimal trace ({len(self.trace)} event(s)):\n{steps}\n"
                f"  => {self.state_repr}")


@dataclasses.dataclass(frozen=True)
class ExplorationResult:
    """Outcome of one exhaustive exploration."""

    states: int
    transitions: int
    depth: int
    counterexamples: tuple[Counterexample, ...]

    @property
    def ok(self) -> bool:
        return not self.counterexamples


def _trace_of(state: State,
              parents: dict[State, tuple[State, str] | None]
              ) -> tuple[str, ...]:
    labels: list[str] = []
    cur: State = state
    while True:
        link = parents[cur]
        if link is None:
            break
        cur, label = link
        labels.append(label)
    labels.reverse()
    return tuple(labels)


def explore(model: ProtocolModel,
            max_states: int = 250_000) -> ExplorationResult:
    """Exhaustively explore ``model``; first (= minimal-trace)
    counterexample per invariant. Deterministic: successor order is the
    model's, discovery is FIFO."""
    init = model.initial()
    parents: dict[State, tuple[State, str] | None] = {init: None}
    depth: dict[State, int] = {init: 0}
    order: list[State] = [init]
    edges: dict[State, tuple[tuple[str, State], ...]] = {}
    found: dict[str, Counterexample] = {}
    transitions = 0
    max_depth = 0
    i = 0
    while i < len(order):
        state = order[i]
        i += 1
        for invariant, detail in model.violations(state):
            if invariant not in found:
                found[invariant] = Counterexample(
                    invariant=invariant, detail=detail,
                    trace=_trace_of(state, parents),
                    state_repr=model.describe_state(state))
        succ: list[tuple[str, State]] = []
        for label, nxt in model.successors(state):
            transitions += 1
            succ.append((label, nxt))
            if nxt not in parents:
                parents[nxt] = (state, label)
                depth[nxt] = depth[state] + 1
                max_depth = max(max_depth, depth[nxt])
                order.append(nxt)
                if len(order) > max_states:
                    raise StateExplosionError(
                        f"model exceeded the {max_states}-state scope "
                        f"cap at depth {depth[nxt]}; tighten the case "
                        f"bounds (epoch/window/record caps)")
        edges[state] = tuple(succ)

    goal: Callable[[State], bool] | None = getattr(model, "goal", None)
    if goal is not None:
        found.update(_check_goal(model, goal, order, edges, parents,
                                 depth, found))
    ranked = sorted(found.values(),
                    key=lambda c: (len(c.trace), c.invariant))
    return ExplorationResult(states=len(order), transitions=transitions,
                             depth=max_depth,
                             counterexamples=tuple(ranked))


def _check_goal(model: ProtocolModel, goal: Callable[[State], bool],
                order: list[State],
                edges: dict[State, tuple[tuple[str, State], ...]],
                parents: dict[State, tuple[State, str] | None],
                depth: dict[State, int],
                found: dict[str, Counterexample],
                ) -> dict[str, Counterexample]:
    """Possibility check: every reachable state must be able to reach a
    goal state via permitted events (wedge detection — see module
    docstring)."""
    goal_name: str = getattr(model, "goal_name", "goal-reachable")
    if goal_name in found:
        return {}
    event_ok: Callable[[str], bool] = getattr(
        model, "goal_event_ok", lambda _label: True)
    preds: dict[State, list[State]] = {}
    for src, succ in edges.items():
        for label, dst in succ:
            if event_ok(label):
                preds.setdefault(dst, []).append(src)
    can_reach = {s for s in order if goal(s)}
    stack = list(can_reach)
    while stack:
        dst = stack.pop()
        for src in preds.get(dst, ()):
            if src not in can_reach:
                can_reach.add(src)
                stack.append(src)
    stuck = [s for s in order if s not in can_reach]
    if not stuck:
        return {}
    worst = min(stuck, key=lambda s: depth[s])
    return {goal_name: Counterexample(
        invariant=goal_name,
        detail=(f"{len(stuck)} reachable state(s) can NEVER reach the "
                f"goal again (a wedge): no schedule of permitted "
                f"events recovers"),
        trace=_trace_of(worst, parents),
        state_repr=model.describe_state(worst))}
