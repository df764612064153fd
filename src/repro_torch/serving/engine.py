"""E2C-scheduled LM serving — the paper's FELARE use case, on the port.

The serving engine of ``repro/serving/engine.py``: the E2C pipeline with
real work behind the machines,

  requests (workload trace) -> batch queue -> E2C scheduling policy
    -> machine queues -> execution -> completed / cancelled / missed
    pools + energy accounting.

A machine is a slice pool of some machine type, with an EET column; a
task type is an application (a model and a decode length).  The host
event loop is the port's copy of the reference loop
(``core/ref_engine._Sim``), so the schedule, the energy and every report
field equal the reference's for the same trace.  With
``run_mode="real"`` each task start runs a real model on ``device``:
``models/model.py::prefill`` over a prompt drawn from
``numpy.random.default_rng(task)``, then greedy ``decode_step``s with f32
activations, one host read per generated token; virtual time still
advances by the EET.  Prefill attention runs the flash-attention kernel
and the MoE expert FFN the grouped-matmul kernel (on the CPU, their plain
versions).

This is an online engine: decisions are made event by event with no
lookahead, like a production request router.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import metrics as ME
from repro_torch.core import ref_engine as R
from repro_torch.core import state as S
from repro_torch.core.eet import EETTable
from repro_torch.models import model as M


@dataclass
class AppSpec:
    """One task type: an application served by the cluster."""
    name: str
    gen_len: int = 16                       # tokens to decode per request
    arch: Any = None                        # ArchConfig | None
    params: Any = None                      # model params for run_mode=real
    prompt_len: int = 16


@dataclass(frozen=True)
class ServeConfig:
    policy: str = "ee_mct"
    lcap: int = 4
    qcap: int = 1 << 30
    cancel_infeasible: bool = True
    run_mode: str = "sim"                   # sim | real


@dataclass
class ServeReport:
    n_requests: int
    completed: int
    cancelled: int
    missed: int
    makespan: float
    active_energy: float
    idle_energy: float
    mean_response: float
    p50_response: float
    p99_response: float
    tokens_generated: int
    wall_seconds: float
    per_machine_util: np.ndarray

    @property
    def total_energy(self) -> float:
        return self.active_energy + self.idle_energy

    @property
    def slo_attainment(self) -> float:
        return self.completed / max(self.n_requests, 1)

    def row(self) -> dict:
        return {"completed": self.completed, "cancelled": self.cancelled,
                "missed": self.missed,
                "slo": round(self.slo_attainment, 4),
                "makespan_s": round(self.makespan, 3),
                "energy_J": round(self.total_energy, 1),
                "mean_resp_s": round(self.mean_response, 4),
                "p50_resp_s": round(self.p50_response, 4),
                "p99_resp_s": round(self.p99_response, 4),
                "tokens": self.tokens_generated}


class _ServeSim(R._Sim):
    """Reference-loop subclass with an execution hook on task start."""

    def __init__(self, *args, on_start: Callable[[int, int, float], None],
                 **kw):
        super().__init__(*args, **kw)
        self._on_start = on_start

    def start_tasks(self):
        for m in range(len(self.mtype)):
            if self.running[m] < 0:
                queue = self.queue_of(m)
                if queue:
                    t = queue[0]
                    self.status[t] = S.RUNNING
                    self.t_start[t] = self.time
                    self.busy_until[m] = self.time + self.exec_time(t, m)
                    self.running[m] = t
                    self._on_start(t, m, self.time)


class ServingEngine:
    """Online E2C-scheduled serving over a heterogeneous slice cluster.

    ``device`` is where ``run_mode="real"`` runs the models (default
    ``"cuda"``; ``"cpu"`` runs the kernels' plain versions); each app's
    parameters must already lie there."""

    def __init__(self, eet: EETTable | np.ndarray, power: np.ndarray,
                 machine_types: list[int] | np.ndarray,
                 apps: list[AppSpec], cfg: ServeConfig = ServeConfig(),
                 device="cuda"):
        self.eet = eet.eet if isinstance(eet, EETTable) else np.asarray(eet)
        self.power = np.asarray(power, np.float64)
        self.mtype = np.asarray(machine_types, np.int64)
        self.apps = apps
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.eet.shape[0] != len(apps):
            raise ValueError(f"EET has {self.eet.shape[0]} task types but "
                             f"{len(apps)} apps were given")
        self.tokens_generated = 0
        self.outputs: dict[int, np.ndarray] = {}

    # ---- real execution --------------------------------------------------
    def _execute(self, task: int, type_id: int, machine: int):
        app = self.apps[type_id]
        if self.cfg.run_mode != "real" or app.arch is None:
            self.tokens_generated += app.gen_len
            return
        opt = M.ModelOptions(dtype=torch.float32)
        cfg = app.arch
        rng = np.random.default_rng(task)
        prompt = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, app.prompt_len)),
            dtype=torch.int64, device=self.device)
        logits, cache = M.prefill(app.params, {"tokens": prompt}, cfg, opt,
                                  cache_len=app.prompt_len + app.gen_len)
        toks = []
        tok = torch.argmax(logits[:, -1], -1)[:, None]
        for _ in range(app.gen_len):
            toks.append(int(tok[0, 0]))
            logits, cache = M.decode_step(app.params, cache, tok, cfg, opt)
            tok = torch.argmax(logits[:, -1], -1)[:, None]
        self.outputs[task] = np.asarray(toks, np.int32)
        self.tokens_generated += app.gen_len

    # ---- main entry --------------------------------------------------------
    def run(self, requests) -> ServeReport:
        """``requests``: a workload with ``arrival``, ``type_id``,
        ``deadline`` (N,) columns and ``n_tasks``."""
        t0 = time.perf_counter()
        cfg = self.cfg

        def on_start(task, machine, t):
            self._execute(task, int(requests.type_id[task]), machine)

        sim = _ServeSim(
            np.asarray(requests.arrival, np.float64),
            np.asarray(requests.type_id, np.int64),
            np.asarray(requests.deadline, np.float64),
            np.asarray(self.eet, np.float64), self.power, self.mtype,
            np.ones(requests.n_tasks), cfg.policy, cfg.lcap, cfg.qcap,
            cfg.cancel_infeasible, on_start=on_start)
        res = sim.run()
        wall = time.perf_counter() - t0

        done = res.status == S.COMPLETED
        resp = (res.t_end - requests.arrival)[done]
        makespan = res.makespan
        idle = ((makespan - res.active_time).clip(min=0)
                * self.power[self.mtype, 0]).sum()
        return ServeReport(
            n_requests=requests.n_tasks,
            completed=int(done.sum()),
            cancelled=int((res.status == S.CANCELLED).sum()),
            missed=int(((res.status == S.MISSED_QUEUE)
                        | (res.status == S.MISSED_RUNNING)).sum()),
            makespan=float(makespan),
            active_energy=float(res.active_energy.sum()),
            idle_energy=float(idle),
            mean_response=float(resp.mean()) if resp.size else 0.0,
            p50_response=ME.percentile(resp, 50),
            p99_response=ME.percentile(resp, 99),
            tokens_generated=self.tokens_generated,
            wall_seconds=wall,
            per_machine_util=res.active_time / max(makespan, 1e-9),
        )
