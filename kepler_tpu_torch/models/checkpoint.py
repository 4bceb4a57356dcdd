"""Training checkpoint and resume.

As ``kepler_tpu.models.checkpoint``: a long fit on fleet history should
survive preemption, so the trainer's ``TrainState`` (params, optimizer
moments, step) is saved periodically and a restart resumes mid-run. The
JAX package wraps orbax; this port keeps the same API over its own format:
one ``torch.save`` file per step, ``<step>.pt``, written to a temporary
sibling, flushed to disk and renamed into place (atomic on POSIX), so a
crash leaves either the previous checkpoints or the new one, never a torn
file. Files are read back with ``weights_only=True`` (tensors and plain
containers only; no code runs on load).

The serve-time handoff stays ``estimator.save_params`` / ``load_params``
(``.npz``); checkpoints are the training artifact and do not cross
packages.
"""

from __future__ import annotations

import os
import re

import torch

from kepler_tpu_torch.models.estimator import param_leaves
from kepler_tpu_torch.models.train import TrainState

_NAME = re.compile(r"^(\d+)\.pt$")


class TrainCheckpointer:
    """Periodic save / latest-restore for a training run.

    ``directory`` is created on first save; ``max_to_keep`` bounds disk
    (older steps are deleted after each save; None keeps all).
    """

    def __init__(self, directory: str,
                 max_to_keep: int | None = 3) -> None:
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep

    def _steps(self) -> list[int]:
        if not os.path.isdir(self._dir):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self._dir))
                      if m)

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"{step}.pt")

    def save(self, state: TrainState, force: bool = False) -> bool:
        """Persist ``state`` under its own step number. → saved? A step
        already saved is not written again unless ``force``."""
        step = int(state.step)
        if step in self._steps() and not force:
            return False
        os.makedirs(self._dir, exist_ok=True)
        payload = {
            "step": step,
            "params": [t.detach().cpu() for t in param_leaves(state.params)],
            "opt_state": state.opt_state.state_dict(),
        }
        path = self._path(step)
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "wb") as fh:
            torch.save(payload, fh)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        dir_fd = os.open(self._dir, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)
        if self._keep:
            for old in self._steps()[:-self._keep]:
                os.remove(self._path(old))
        return True

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, state_like: TrainState) -> TrainState | None:
        """→ the newest checkpoint, loaded into ``state_like``'s tensors
        and optimizer (so onto their device, in their dtype), or None if
        the directory has none. ``state_like`` is updated in place."""
        step = self.latest_step()
        if step is None:
            return None
        leaves = param_leaves(state_like.params)
        # read onto the host: copy_ below and the optimizer's
        # load_state_dict put each tensor where state_like keeps it (the
        # moments by their parameter, the step count on the host)
        payload = torch.load(self._path(step), map_location="cpu",
                             weights_only=True)
        saved = payload["params"]
        if len(saved) != len(leaves) or any(
                s.shape != t.shape for s, t in zip(saved, leaves)):
            raise ValueError(
                f"checkpoint {self._path(step)} holds params of other "
                "shapes than the state to restore")
        with torch.no_grad():
            for s, t in zip(saved, leaves):
                t.copy_(s)
        state_like.opt_state.load_state_dict(payload["opt_state"])
        return TrainState(state_like.params, state_like.opt_state,
                          int(payload["step"]))

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for (the JAX package's
        orbax saves may run in the background)."""

    def close(self) -> None:
        """Nothing is held open between calls."""

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()
