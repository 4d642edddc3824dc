"""Training loop: the train step, checkpoint/restart, preemption handling
(the torch twin of ``repro/train/trainer.py``).

Fault-tolerance contract (exercised by the tests and ``chip_smoke.py``):
  * checkpoint every N steps (atomic, manifest'd);
  * on start, auto-resume from the latest checkpoint (exact data-iterator
    state comes from the step counter — SyntheticLM/FileTokens are
    deterministic in (seed, step, shard));
  * SIGTERM/preemption => save-and-exit cleanly;
  * restart reproduces the loss trajectory bit for bit on the CPU (test).

The trainer runs on one explicit device (``device=None`` is the card) and
draws fresh weights from a ``torch.Generator`` seeded with ``seed``. With a
``ctx`` it hands it to ``make_train_step``: over more than one device the
parameters and states it is given, or draws, or restores, are put on the
mesh by ``launch/steps.param_shardings(fsdp=True)`` and ``opt_shardings``.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch

from repro_torch.launch.steps import distribute_tree, make_train_step, opt_shardings, param_shardings
from repro_torch.models.transformer import sharded
from repro_torch.models.common import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import DataConfig, make_source
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.schedule import Constant


@dataclass
class TrainConfig:
    steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    opt: OptConfig = field(default_factory=OptConfig)


class Trainer:
    def __init__(self, model, tcfg: TrainConfig, dcfg: DataConfig, schedule=None, device=None, ctx=None):
        self.model = model
        self.ctx = ctx
        self.tcfg = tcfg
        self.dcfg = dcfg
        self.device = resolve_device(device)
        self.schedule = schedule or Constant(tcfg.opt.lr)
        self.source = make_source(dcfg)
        self.history: List[Dict[str, float]] = []
        self._preempted = False
        self._step_fn = make_train_step(model, tcfg.opt, schedule=self.schedule, ctx=ctx)
        self._psh = self._osh = None
        if sharded(ctx):
            self._psh = param_shardings(model, ctx, fsdp=True)
            self._osh = opt_shardings(model, ctx, tcfg.opt)

    # -- preemption ---------------------------------------------------------
    def install_preemption_handler(self):
        def handler(signum, frame):
            self._preempted = True

        signal.signal(signal.SIGTERM, handler)

    def _init(self, seed: int):
        return self.model.init(torch.Generator(self.device).manual_seed(seed))

    # -- main loop ------------------------------------------------------------
    def run(self, params: Any = None, seed: int = 0) -> Dict[str, Any]:
        tcfg = self.tcfg
        start_step = 0
        opt_state = None
        if tcfg.ckpt_dir:
            last = ckpt.latest_step(tcfg.ckpt_dir)
            if last is not None:
                params = self._init(seed)  # structure
                opt_state = init_opt_state(params, tcfg.opt)
                state = ckpt.restore(tcfg.ckpt_dir, last, {"p": params, "o": opt_state},
                                     shardings=None if self._psh is None else {"p": self._psh, "o": self._osh})
                params, opt_state = state["p"], state["o"]
                start_step = last
        if params is None:
            params = self._init(seed)
        if opt_state is None:
            opt_state = init_opt_state(params, tcfg.opt)
        if self._psh is not None:
            params = distribute_tree(params, self._psh)
            opt_state = distribute_tree(opt_state, self._osh)

        t0 = time.time()
        step = start_step
        for step in range(start_step, tcfg.steps):
            batch = {k: torch.as_tensor(v, device=self.device) for k, v in self.source.batch_at(step).items()}
            params, opt_state, metrics = self._step_fn(params, opt_state, batch)
            if step % tcfg.log_every == 0 or step == tcfg.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                self.history.append(m)
            if tcfg.ckpt_dir and (step + 1) % tcfg.ckpt_every == 0:
                ckpt.save(tcfg.ckpt_dir, step + 1, {"p": params, "o": opt_state},
                          meta={"data_step": step + 1})
            if self._preempted:
                if tcfg.ckpt_dir:
                    ckpt.save(tcfg.ckpt_dir, step + 1, {"p": params, "o": opt_state},
                              meta={"preempted": True})
                break
        return {
            "params": params,
            "opt_state": opt_state,
            "history": self.history,
            "steps_done": step + 1,
            "wall_s": time.time() - t0,
            "preempted": self._preempted,
        }
