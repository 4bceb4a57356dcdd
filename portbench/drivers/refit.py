"""A refit of an estimator from the Aggregator's training dumps, as
``cmd.train`` runs it.

Set-up finds the plain refit of the configuration's ``model``
(``reference/refit_<model>.py``, ``spec.refit_reference``: a family
without one stops here, naming the file), makes the dumps of
``dump_windows`` fleet windows from the seed (``fleetgen.training_dump``:
RAPL rows only, labelled with their ratio watts, with their histories
where the family is ``temporal``, joined as ``cmd.train.load_windows``
joins them), then builds the job with ``cmd.train.build_trainer``
(``--model`` the configuration's, ``--seed`` the run's, every other flag
at its default) and drives its ``step_fn`` through the first
``checked_steps`` steps, as ``cmd.train.main``'s loop calls it. The
window goes on stepping that same state, syncing on the loss every
``--log-every`` steps as the loop does. Once the window has closed, the
same ``step_fn`` makes one more step of that state (the window's next),
from a copy of the params and AdamW's moments that the window left.

Counts: ``steps`` in the window and ``samples`` (labelled rows × steps).
``correct``: against the family's plain refit (``adamw`` stepping its
``loss_and_grad``) from the same seed and dumps. ``loss_gap``: the
losses of the checked steps and of the step after the window, each
relative to the reference's; ``change_gap``: the params' change over the
checked steps, by the worst leaf (``leaf_gap``); ``timed_change_gap``:
the change the step after the window made, against the reference's step
from the same state (the program's own params and moments as the window
left them), by the worst leaf; ``unmoved_leaves``: the leaves that the
reference moves and that the window left as it found them, bit for bit.
"""

from __future__ import annotations

import statistics
import time
from typing import Any, Mapping, NamedTuple

import torch

from portbench import fleetgen, spec
from portbench.harness import Check, Spans, Window
from portbench.reference import adamw
from portbench.reference.precision import BELOW, rounding

BETA1 = 0.9
# a leaf whose reference gradient stays under this share of the median
# leaf's at every step compared moves by round-off alone: its change is
# not compared
ROUND_OFF_SHARE = 1e-3


def setup(config: Mapping[str, Any], traffic: Mapping[str, Any], seed: int,
          device: torch.device, spans: Spans) -> "Session":
    return Session(config, traffic, seed, device, spans)


def leaf_gap(got: Mapping[str, float], want: Mapping[str, float],
             leaves: list[str] | None = None) -> float:
    """Worst leaf's |‖got‖ − ‖want‖| over the larger of the reference
    leaf's norm and the median leaf's (all leaves). A leaf whose
    denominator is 0 must read exactly 0."""
    median = statistics.median(want.values())
    worst = 0.0
    for k in leaves if leaves is not None else want:
        denom = max(want[k], median)
        diff = abs(got[k] - want[k])
        gap = (diff / denom if denom > 0
               else (0.0 if diff == 0 else float("inf")))
        if gap != gap:  # a NaN norm
            return float("inf")
        worst = max(worst, gap)
    return worst


def norms(params: Mapping[str, torch.Tensor]) -> dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.detach().double()))
            for k, v in params.items()}


def moved(grads: list[adamw.Params]) -> list[str]:
    """The leaves whose reference gradient reaches ``ROUND_OFF_SHARE`` of
    the median leaf's at some step of ``grads``; every leaf where no step
    has a median above 0 (nothing to tell round-off by)."""
    out, told = set(), False
    for g in grads:
        n = norms(g)
        median = statistics.median(n.values())
        if median > 0:
            told = True
            out |= {k for k in n if n[k] >= ROUND_OFF_SHARE * median}
    return [k for k in grads[0] if k in out or not told]


class Last(NamedTuple):
    """The step after the window: the state it started from (params and
    AdamW's moments as the window left them), its number (from 1), its
    loss and the params after it."""

    params: adamw.Params
    exp_avg: adamw.Params
    exp_avg_sq: adamw.Params
    t: int
    loss: float
    end: adamw.Params


class Session:
    def __init__(self, config: Mapping[str, Any],
                 traffic: Mapping[str, Any], seed: int,
                 device: torch.device, spans: Spans) -> None:
        from kepler_tpu_torch.cmd import train as train_cli

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device, self.spans = device, spans
        self.family = spec.refit_reference(config["model"])
        self.precision = config["estimator"]["compute_dtype"]
        gen = torch.Generator(device=device).manual_seed(seed)
        self.data = fleetgen.training_dump(config, traffic, gen, device)
        self.labelled = int(self.data["workload_valid"].sum())
        self.args = train_cli.parse_args(
            ["--data", ".", "--out", "params.npz", "--model",
             config["model"], "--seed", str(seed)])
        self.state, self.step_fn, self.inputs = train_cli.build_trainer(
            self.args, self.data, device)
        self.start = self._params()
        self.losses: list[float] = []
        # the first gradient as AdamW holds it after step 1, exp_avg /
        # (1 − β1): calibrate.py reads it against the reference's
        self.first_grad: dict[str, torch.Tensor] = {}
        for _ in range(int(traffic["checked_steps"])):
            self.state, loss = self.step_fn(self.state, *self.inputs)
            self.losses.append(float(loss))
            if not self.first_grad:
                opt = self.state.opt_state
                self.first_grad = {
                    k: opt.state[p]["exp_avg"].detach().clone() / (1 - BETA1)
                    for k, p in self.state.params.items()}
        self.end = self._params()
        self.last: Last | None = None
        self.ref: adamw.Refit | None = None

    def _params(self) -> dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in self.state.params.items()}

    @staticmethod
    def _sources(state: Any) -> list[torch.Tensor]:
        """Each leaf's param, exp_avg and exp_avg_sq, leaf by leaf."""
        opt = state.opt_state
        out = []
        for p in state.params.values():
            out += [p.detach(), opt.state[p]["exp_avg"],
                    opt.state[p]["exp_avg_sq"]]
        return out

    def run(self, seconds: float) -> Window:
        spans, step_fn, inputs = self.spans, self.step_fn, self.inputs
        log_every = self.args.log_every
        state, steps = self.state, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with spans("harness.step"):
                state, loss = step_fn(state, *inputs)
            steps += 1
            if log_every and state.step % log_every == 0:
                with spans("harness.log"):
                    float(loss)
        with spans("harness.sync"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        seconds = time.perf_counter() - t0
        self.state = state
        return Window(seconds=seconds,
                      counts={"steps": steps,
                              "samples": steps * self.labelled},
                      attempted=steps)

    def _close(self) -> Last:
        """The step after the window, as the program makes it; then
        frees the program's state (once)."""
        if self.last is None:
            kept = [x.clone() for x in self._sources(self.state)]
            keys = list(self.state.params)
            self.state, loss = self.step_fn(self.state, *self.inputs)
            self.last = Last(
                params={k: kept[3 * i] for i, k in enumerate(keys)},
                exp_avg={k: kept[3 * i + 1] for i, k in enumerate(keys)},
                exp_avg_sq={k: kept[3 * i + 2] for i, k in enumerate(keys)},
                t=self.state.step, loss=float(loss), end=self._params())
            self.state = self.step_fn = self.inputs = None
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
                torch.cuda.empty_cache()
        return self.last

    def reference(self, precision: str, last: Last,
                  data: tuple[torch.Tensor, ...]
                  ) -> tuple[adamw.Refit, adamw.Step]:
        """The plain refit of the checked steps, and the plain step from
        the state the window left, at ``precision``."""
        loss_and_grad = self.family.loss_and_grad
        start = self.family.start(self.seed, self.config)
        opt = adamw.AdamW(lr=self.args.lr)
        rnd = rounding(precision)
        refit = adamw.refit(loss_and_grad, start, data, opt,
                            int(self.traffic["checked_steps"]), rnd)
        step = adamw.step_from(loss_and_grad, last.params, last.exp_avg,
                               last.exp_avg_sq, last.t, data, opt, rnd)
        return refit, step

    def readings(self, losses: list[float], start: Mapping[str, torch.Tensor],
                 end: Mapping[str, torch.Tensor], last: Last,
                 ref: adamw.Refit, ref_last: adamw.Step
                 ) -> dict[str, float]:
        """The compared readings of a refit against the reference's."""
        got = losses + [last.loss]
        want = ref.losses + [ref_last.loss]
        gaps = [abs(a - b) / abs(b) if b else abs(a - b)
                for a, b in zip(got, want)]
        if len(got) != len(want):
            gaps = [float("inf")]
        change = {k: end[k] - start[k] for k in ref.start}
        ref_change = {k: ref.end[k] - ref.start[k] for k in ref.start}
        step = {k: last.end[k] - last.params[k] for k in ref.start}
        ref_step = {k: ref_last.end[k] - last.params[k] for k in ref.start}
        moves = moved(ref.grads)
        return {
            "loss_gap": max(gaps),
            "change_gap": leaf_gap(norms(change), norms(ref_change), moves),
            "timed_change_gap": leaf_gap(norms(step), norms(ref_step),
                                         moved([ref_last.grad])),
            "unmoved_leaves": float(sum(
                bool(torch.equal(last.params[k], end[k])) for k in moves)),
        }

    def program_readings(self) -> dict[str, float]:
        """Frees the program's state, runs the reference, compares."""
        last = self._close()
        data = self.family.inputs(self.data, self.device)
        self.ref, ref_last = self.reference(self.precision, last, data)
        return self.readings(self.losses, self.start, self.end, last,
                             self.ref, ref_last)

    def check(self, limits: Mapping[str, float]) -> list[Check]:
        got = self.program_readings()
        return [Check(name, got[name], float(limit))
                for name, limit in limits.items()]

    def control_gaps(self) -> dict[str, float]:
        """The control's readings: the reference one precision below the
        configuration's in the program's place (its checked steps, and
        its step from the state the window left), against the
        reference."""
        last = self._close()
        data = self.family.inputs(self.data, self.device)
        low, low_last = self.reference(BELOW[self.precision], last, data)
        ref, ref_last = self.reference(self.precision, last, data)
        return self.readings(low.losses, low.start, low.end,
                             last._replace(loss=low_last.loss,
                                           end=low_last.end),
                             ref, ref_last)
