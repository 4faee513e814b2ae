"""Training loop with the reference's fault-tolerance mechanics:

* checkpoint/restart (atomic, keep-N, resume from the latest on start),
* failure recovery: a step that raises rolls back to the last checkpoint
  (or to the initial state when there is none) and replays; the data
  pipeline is a pure function of the step, so the replay is exact,
* a straggler watchdog: each step's wall time against the running median,
  slow steps logged,
* deterministic skip-ahead: resuming at step k consumes batch(k) directly.

The port of ``repro.train.trainer``. The step writes parameters, moments
and ``.grad`` in place, so a step that fails part way leaves them
half-written, which the reference's functional state never does: recovery
drops that state (its ``.grad`` cleared) and builds a new one, every
parameter, moment, residual, counter and the key read from the latest
checkpoint, or drawn afresh from the seed when there is none.
Checkpoints hold the JAX package's layout (``convert.train_state_layout``),
so one written by either package's ``Trainer`` restores in the other's.
"""
from __future__ import annotations

import dataclasses
import logging
import statistics
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import convert, prng
from repro_torch.ckpt import checkpoint
from repro_torch.optim.adamw import AdamW
from repro_torch.train import train_step as ts

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    num_steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    max_retries: int = 2


def _template(t: torch.Tensor) -> torch.Tensor:
    """A restore template of ``t``'s shape and dtype that holds no memory."""
    return torch.empty((), dtype=t.dtype).expand(t.shape)


def _template_stack(leaves) -> torch.Tensor:
    return torch.empty((), dtype=leaves[0].dtype).expand(len(leaves),
                                                         *leaves[0].shape)


class Trainer:
    def __init__(self, loss_fn: Callable, optimizer: AdamW, data,
                 tcfg: ts.TrainConfig, cfg: TrainerConfig,
                 init_params_fn: Callable[[torch.Tensor], torch.nn.Module],
                 seed: int = 0):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.data = data
        self.tcfg = tcfg
        self.cfg = cfg
        self.init_params_fn = init_params_fn
        self.seed = seed
        self.step_fn = ts.make_train_step(loss_fn, optimizer, tcfg)
        self.metrics_history: List[Dict] = []
        self.straggler_events: List[int] = []
        self.state: Optional[ts.TrainState] = None

    # ------------------------------------------------------------------
    def _fresh_state(self) -> ts.TrainState:
        """The reference's init: parameters from ``fold_in(PRNGKey(seed),
        1)``, the state's key ``fold_in(PRNGKey(seed), 2)``, on the
        parameters' device."""
        key = prng.PRNGKey(self.seed)
        params = self.init_params_fn(prng.fold_in(key, 1))
        dev = next(params.parameters()).device
        return ts.init_state(prng.fold_in(key, 2).to(dev), params,
                             self.optimizer, self.tcfg)

    def _restore_or_init(self) -> ts.TrainState:
        """A new state, from the latest checkpoint or the seed. The last
        state (half-written by a failed step) is dropped first, its
        ``.grad`` cleared, so that its memory is free for the new one."""
        if self.state is not None:
            for p in self.state.params.parameters():
                p.grad = None
            self.state = None
        state = self._fresh_state()
        if self.cfg.ckpt_dir and \
                checkpoint.latest_step(self.cfg.ckpt_dir) is not None:
            like = convert.train_state_layout(state, _template,
                                              _template_stack)
            tree = checkpoint.restore(self.cfg.ckpt_dir, like)
            convert.load_train_state(state, tree)
            log.info("restored checkpoint at step %d", int(state.step))
        self.state = state
        return state

    def _save(self, step: int, state: ts.TrainState) -> None:
        checkpoint.save(self.cfg.ckpt_dir, step,
                        convert.train_state_to_numpy(state),
                        keep=self.cfg.keep)

    # ------------------------------------------------------------------
    def run(self, fault_hook: Optional[Callable[[int], None]] = None
            ) -> ts.TrainState:
        """fault_hook(step): a test hook that may raise to simulate a node
        failure; the trainer recovers from the last checkpoint."""
        state = self._restore_or_init()
        retries = 0
        times: List[float] = []
        step = int(state.step)
        while step < self.cfg.num_steps:
            batch = self.data.batch(step)
            t0 = time.monotonic()
            failed = False
            try:
                if fault_hook is not None:
                    fault_hook(step)
                state, metrics = self.step_fn(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()
                           if not torch.is_tensor(v) or v.ndim == 0}
            except Exception as e:  # noqa: BLE001 - node-failure recovery
                retries += 1
                if retries > self.cfg.max_retries:
                    raise
                log.warning("step %d failed (%s); restoring last checkpoint",
                            step, e)
                failed = True
            if failed:      # outside the handler: its traceback holds tensors
                state = batch = None
                state = self._restore_or_init()
                step = int(state.step)
                continue
            self.state = state
            dt = time.monotonic() - t0
            times.append(dt)
            med = statistics.median(times[-20:])
            if len(times) > 5 and dt > self.cfg.straggler_factor * med:
                self.straggler_events.append(step)
                log.warning("straggler: step %d took %.3fs (median %.3fs)",
                            step, dt, med)
            if step % self.cfg.log_every == 0:
                log.info("step %d: %s", step, metrics)
            self.metrics_history.append({"step": step, **metrics})
            step += 1
            if self.cfg.ckpt_dir and step % self.cfg.ckpt_every == 0:
                self._save(step, state)
        if self.cfg.ckpt_dir:
            self._save(step, state)
        return state
