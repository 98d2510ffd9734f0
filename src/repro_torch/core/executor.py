"""FL experiment executor of the port: dataset -> partition -> blocks of
rounds -> eval history (the twin of the JAX package's
``core/executor.py::run_experiment``, its serial and pipelined drivers).

Rounds run in eval-to-eval blocks — plan block -> run block -> eval ->
record — through ``algo.dispatch_block``; under the fused engine a block is
one ``LocalTrainer.train_schedule`` call, under the sequential and batched
engines one ``Engine.run`` per round. Block boundaries come from
absolute round indices, as in the reference.

Two arguments the reference does not have: ``init_params`` (the JAX
package draws its initial weights from ``jax.random``, which torch cannot
replay, so a parity run passes the reference's ``w_glob`` in, as numpy
arrays or tensors) and ``device`` (the GPU unless the caller asks for
another; there is no silent CPU fallback). ``on_block(t0, schedule)`` is
called with every block's pre-drawn plans before the block runs; an
algorithm that bypasses the plan IR (Centralized, ``pipelinable =
False``) has none, so it is called with ``schedule=None`` and the block
runs through the algorithm's own ``run_schedule``, as the reference's
serial driver runs it.

Checkpoints (``checkpoint_dir``, ``checkpoint_every``, ``resume``) keep the
reference's files and layout — ``model.msgpack``, ``algo_state.msgpack``
(MOON's and SCAFFOLD's state as per-client-id dicts, the ids tagged
``"i:<id>"``) and ``state.json`` — so a run saved by either package
resumes in the other; on resume the checkpoint's weights replace
``init_params``.

``FLConfig.prefetch=1`` runs the same blocks through the pipelined
driver: while block ``t`` runs, the host plans block ``t + 1``, hands its
cohort arena to the store's staging thread and stages its state rows
early when the visited sets are disjoint (``algo.prefetch_block``); the
eval of block ``t`` is queued before that plan and read only when it is
recorded. Planning order is the serial driver's (block ``t`` wholly
planned before block ``t + 1``), so the RNG stream and every result are
bit-equal to ``prefetch=0``; a checkpoint saves the RNG state snapshotted
between the two plans, so a resumed run plans the lookahead block again
identically. On the GPU a block's steps are enqueued from a Python loop
and return only once the last is enqueued, so the prefetch overlaps the
device's tail of the block, the eval and the next plan, not the step
loop. Algorithms that bypass the plan IR (Centralized,
``pipelinable = False``) run through the serial driver.

A ``label_flip`` adversary poisons the attacker shards right after the
partition and before the algorithm (and its engine's store) is built.
Under DP-SGD the result reports the planner's ledger as ``dp_epsilon`` and
``dp_delta``. As in the reference, a checkpoint keeps neither the ledger
nor the noise stream: a resumed run charges only the rounds after the
resume and draws its noise anew (ROADMAP C9).

An active ``FLConfig.personalize`` runs the personalization stage
(``core.personalize``) after the round loop and before the engine's store
is closed, so the fused engine's store serves it too and its staging
counts in ``stage_seconds``; the result reports ``personalized_accuracy``,
``global_client_accuracy`` and ``personalized_fleet``, and a
``checkpoint_dir`` gets ``personalized.msgpack``.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint.io import restore, save
from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.adversary import AdversaryState
from repro_torch.core.algorithms import make_algorithm
from repro_torch.core.comm import CommMeter
from repro_torch.core.local import LocalTrainer
from repro_torch.core.personalize import personalize_fleet, save_personalized
from repro_torch.core.plan import Schedule
from repro_torch.data.pipeline import make_clients
from repro_torch.data.synthetic import Dataset, make_task
from repro_torch.models.small import (
    classifier_accuracy, init_small_model, params_from_numpy,
)
from repro_torch.optim.schedules import cosine_decay
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import layout_of, ravel_params, tree_bytes, unravel


@dataclasses.dataclass
class RoundRecord:
    """One eval point. ``seconds`` covers the wall time since the previous
    record (the whole block of ``rounds`` rounds plus this eval), fenced by
    a device synchronize on the GPU."""

    round: int
    accuracy: float
    comm: Dict[str, float]
    lr: float
    seconds: float
    rounds: int = 1


@dataclasses.dataclass
class ExperimentResult:
    algorithm: str
    task: str
    partition: str
    history: List[RoundRecord]
    final_model: Optional[Dict[str, torch.Tensor]] = None
    peak_device_bytes: int = 0              # max over blocks of the data
                                            # plane + staged state (0 under
                                            # the host-fed engines; O(cohort)
                                            # under the staged stores; both
                                            # pipeline buffers under
                                            # prefetch=1)
    dp_epsilon: Optional[float] = None      # (eps, delta) spent by the run's
    dp_delta: Optional[float] = None        # DP-SGD ledger (dp_clip > 0 only)
    stage_seconds: float = 0.0              # host->device staging wall
                                            # (store gathers + uploads)
    overlapped_stage_seconds: float = 0.0   # the part of it a prefetch hid
                                            # behind a running block
    dispatch_seconds: float = 0.0           # per-block dispatch-to-sync wall
    h2d_bytes: int = 0                      # LocalTrainer.h2d_bytes at the end
    dispatches: int = 0                     # LocalTrainer.dispatches (steps,
                                            # hop calls or blocks)
    # the personalization stage (None when it is off): the mean per-client
    # accuracy of the fleet and of the global model on the same draws, and
    # the fleet as {leaf: (K, ...)} views of the stage's host arena
    personalized_accuracy: Optional[float] = None
    global_client_accuracy: Optional[float] = None
    personalized_fleet: Optional[Dict[str, np.ndarray]] = None

    @property
    def overlap_fraction(self) -> float:
        """The share of the staging wall the prefetch pipeline hid (0.0
        when nothing was staged, or under prefetch=0)."""
        if self.stage_seconds <= 0.0:
            return 0.0
        return self.overlapped_stage_seconds / self.stage_seconds

    @property
    def final_accuracy(self) -> float:
        return self.history[-1].accuracy if self.history else float("nan")

    def rounds_to_accuracy(self, target: float) -> Optional[int]:
        for rec in self.history:
            if rec.accuracy >= target:
                return rec.round
        return None

    def comm_to_accuracy(self, target: float) -> Optional[int]:
        """Total model transfers when target accuracy is first hit (Table III)."""
        for rec in self.history:
            if rec.accuracy >= target:
                return rec.comm["total_transfers"]
        return None


def run_experiment(
    *,
    task: str,
    model_cfg: ModelConfig,
    fl: FLConfig,
    eval_every: int = 1,
    train: Optional[Dataset] = None,
    test: Optional[Dataset] = None,
    quiet: bool = True,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    stop_after: Optional[int] = None,   # simulate interruption after round N
    init_params: Optional[Mapping] = None,
    device=None,
    on_block: Optional[Callable[[int, Schedule], None]] = None,
) -> ExperimentResult:
    device = resolve_device(device)
    if train is None or test is None:
        train, test = make_task(task, seed=fl.seed)
    rng = np.random.default_rng(fl.seed)
    clients = make_clients(
        train, scheme=fl.partition, num_devices=fl.num_devices,
        rng=rng, xi=fl.xi, alpha=fl.alpha,
    )
    if fl.adversary.active and fl.adversary.kind == "label_flip":
        # the data poison: attacker shards get flipped labels once, before
        # the engine stages any data (every store serves the poisoned
        # shards); the adversary's own seed picks the attackers
        clients = AdversaryState(fl.adversary, fl.num_devices).poison_clients(
            clients, model_cfg.num_classes)
    trainer = LocalTrainer(model_cfg, fl, device)
    ck = (_restore_checkpoint(checkpoint_dir)
          if resume and checkpoint_dir else None)
    if ck is not None:
        init_params = ck["w_glob"]
    if init_params is None:
        params = init_small_model(torch.Generator().manual_seed(fl.seed),
                                  model_cfg, device)
    else:
        params = params_from_numpy(
            {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                 else v) for k, v in init_params.items()}, device)
    layout = layout_of(params)
    if layout != trainer.layout:
        raise ValueError(f"initial weights' layout {layout} does not match "
                         f"the model's {trainer.layout}")
    w_glob = ravel_params(params)
    algo = make_algorithm(fl.algorithm, trainer, clients, fl)
    meter = CommMeter(model_bytes=tree_bytes(params))
    lr_fn = cosine_decay(fl.init_lr, fl.final_lr, fl.rounds)
    state: Dict = {}
    start_round = 0
    history: List[RoundRecord] = []
    if ck is not None:
        start_round = int(ck["round"])
        rng.bit_generator.state = ck["rng_state"]
        for k, v in ck["comm"].items():
            setattr(meter, k, float(v) if k == "sim_seconds" else int(v))
        # the pre-checkpoint history rides along, so rounds_to_accuracy and
        # comm_to_accuracy see the whole run, not just the resumed tail
        history = [RoundRecord(**h) for h in ck.get("history", [])]
        state = algo.state_from_ckpt(ck.get("state") or {}, w_glob)

    test_images = torch.from_numpy(test.images).to(device)
    test_labels = torch.from_numpy(test.labels).to(device)

    def sync() -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    end = fl.rounds if stop_after is None else min(fl.rounds, stop_after)

    def next_boundary(t: int) -> int:
        stop = min(end, t - t % eval_every + eval_every)
        if checkpoint_dir and checkpoint_every:
            stop = min(stop, t - t % checkpoint_every + checkpoint_every)
        return stop

    def block_lrs(t: int, stop: int) -> np.ndarray:
        return np.asarray([float(lr_fn(i)) for i in range(t, stop)])

    def accuracy(w) -> torch.Tensor:
        """The eval, queued: a 0-dim device tensor, read when recorded."""
        return classifier_accuracy(unravel(w, layout), test_images,
                                   test_labels, model_cfg)

    t = start_round
    last_time = time.perf_counter()
    last_round = start_round
    dispatch_t0: Optional[float] = None

    def record_eval(t_now: int, acc_dev: torch.Tensor, lrs) -> None:
        """Read a queued eval (the read fences the device, so the clock
        covers the block) and record the eval point."""
        nonlocal last_time, last_round, dispatch_t0
        acc = float(acc_dev)
        sync()
        now = time.perf_counter()
        if dispatch_t0 is not None:
            algo.residency.record_dispatch(now - dispatch_t0)
            dispatch_t0 = None
        history.append(RoundRecord(
            round=t_now, accuracy=acc, comm=meter.snapshot(),
            lr=float(lrs[-1]), seconds=now - last_time,
            rounds=t_now - last_round,
        ))
        last_time, last_round = now, t_now
        if not quiet:
            print(f"  [{fl.algorithm:>12}] round {t_now:>3} "
                  f"acc={acc:.4f} lr={lrs[-1]:.5f} "
                  f"transfers={meter.total_transfers}")

    def maybe_checkpoint(t_now: int, rng_state: Dict) -> None:
        if checkpoint_dir and checkpoint_every and t_now % checkpoint_every == 0:
            _save_checkpoint(checkpoint_dir, unravel(w_glob, layout), t_now,
                             rng_state, meter, history,
                             algo.state_to_ckpt(state))

    def plan(t: int):
        """Plan the block that starts at round ``t``: its end, its learning
        rates and its schedule (None for an algorithm without plans)."""
        stop = next_boundary(t)
        lrs = block_lrs(t, stop)
        sched = (algo.plan_schedule(t, len(lrs), rng, state)
                 if algo.pipelinable else None)
        if on_block is not None:
            on_block(t, sched)
        return stop, lrs, sched

    store = getattr(algo.engine, "store", None)
    try:
        if not (fl.prefetch > 0 and algo.pipelinable):
            # the serial driver: plan -> stage -> run -> eval, one block at
            # a time
            while t < end:
                if dispatch_t0 is None:
                    dispatch_t0 = time.perf_counter()
                stop, lrs, sched = plan(t)
                if sched is None:
                    # no plan IR (Centralized): the algorithm's own loop
                    w_glob, state = algo.run_schedule(w_glob, t, lrs, rng,
                                                      meter, state)
                else:
                    w_glob = algo.dispatch_block(sched, w_glob, lrs, state)
                    algo.finish_block(sched, state, meter)
                t = stop
                # `t == end`: a stop_after/rounds not aligned to eval_every
                # still gets its final partial block evaluated
                if t % eval_every == 0 or t == end:
                    record_eval(t, accuracy(w_glob), lrs)
                maybe_checkpoint(t, rng.bit_generator.state)
        else:
            # the pipelined driver: while block t runs, plan block t + 1
            # and start staging it
            nxt = plan(t) if t < end else None
            while nxt is not None:
                stop, lrs, sched = nxt
                if dispatch_t0 is None:
                    dispatch_t0 = time.perf_counter()
                w_glob = algo.dispatch_block(sched, w_glob, lrs, state)
                is_eval = stop % eval_every == 0 or stop == end
                # queue the eval without reading it
                acc_dev = accuracy(w_glob) if is_eval else None
                # the RNG between the two plans: a checkpoint at this
                # boundary resumes by planning the lookahead block again
                rng_snap = copy.deepcopy(rng.bit_generator.state)
                nxt = None
                if stop < end:
                    nxt = plan(stop)
                    # data to the staging thread; state rows now when the
                    # visited sets are disjoint
                    algo.prefetch_block(nxt[2], sched.visited(), state)
                # retire the running block (the state write-back waits
                # for it)
                algo.finish_block(sched, state, meter)
                t = stop
                if is_eval:
                    record_eval(t, acc_dev, lrs)
                maybe_checkpoint(t, rng_snap)
        # the personalization stage, on the engine's store when it has one
        preport = None
        if fl.personalize.active:
            preport = personalize_fleet(model_cfg, fl, clients, w_glob, test,
                                        store=store, device=device)
            if checkpoint_dir:
                save_personalized(checkpoint_dir, preport.arena, layout)
        # the store's staging wall (the stage's included) and the part of
        # it a prefetch hid
        stage_s, overlap_s = algo.engine.staging_stats()
    finally:
        if store is not None:
            store.close()

    res = algo.residency
    res.stage_seconds, res.overlapped_stage_seconds = stage_s, overlap_s
    eps, delta = ((None, None) if algo.privacy is None
                  else algo.privacy.spent)
    return ExperimentResult(fl.algorithm, task, fl.partition, history,
                            final_model=unravel(w_glob, layout),
                            peak_device_bytes=res.peak_bytes,
                            dp_epsilon=eps, dp_delta=delta,
                            stage_seconds=res.stage_seconds,
                            overlapped_stage_seconds=(
                                res.overlapped_stage_seconds),
                            dispatch_seconds=res.dispatch_seconds,
                            h2d_bytes=trainer.h2d_bytes,
                            dispatches=trainer.dispatches,
                            personalized_accuracy=(
                                None if preport is None
                                else preport.personalized_accuracy),
                            global_client_accuracy=(
                                None if preport is None
                                else preport.global_client_accuracy),
                            personalized_fleet=(
                                None if preport is None else preport.fleet))


# ---------------------------------------------------------------------------
# checkpoint / resume (exact: model + round + numpy RNG + comm counters +
# eval history + algorithm state), in the reference's files and layout


_COMM_FIELDS = ("model_bytes", "cloud_up", "cloud_down", "edge_up",
                "edge_down", "p2p")


def _pack_state(state):
    """Algorithm state as a msgpack-able tree: client-id keys (ints) become
    the tagged strings ``"i:<id>"`` the reference writes."""
    if isinstance(state, dict):
        return {(f"i:{k}" if isinstance(k, int) else str(k)): _pack_state(v)
                for k, v in state.items()}
    return state


def _unpack_state(obj):
    """Inverse of ``_pack_state`` over a restored tree."""
    if isinstance(obj, dict):
        return {(int(k[2:]) if isinstance(k, str) and k.startswith("i:")
                 else k): _unpack_state(v)
                for k, v in obj.items()}
    return obj


def _save_checkpoint(ckdir: str, params: Mapping[str, torch.Tensor],
                     round_: int, rng_state: Dict, meter: CommMeter,
                     history: List[RoundRecord] = (),
                     state: Optional[Dict] = None) -> None:
    """``rng_state`` is the numpy bit-generator state to persist: the
    serial driver's after the block that ends at ``round_``; the pipelined
    driver's snapshot from before the lookahead block was planned."""
    os.makedirs(ckdir, exist_ok=True)
    save(f"{ckdir}/model.msgpack", params)
    save(f"{ckdir}/algo_state.msgpack", _pack_state(state or {}))
    comm = {f: int(getattr(meter, f)) for f in _COMM_FIELDS}
    comm["sim_seconds"] = float(meter.sim_seconds)
    with open(f"{ckdir}/state.json", "w") as f:
        json.dump({"round": round_, "rng_state": rng_state, "comm": comm,
                   "history": [dataclasses.asdict(r) for r in history]}, f)


def _restore_checkpoint(ckdir: str) -> Optional[Dict]:
    """The checkpoint in ``ckdir`` with numpy weights, or None when there
    is none."""
    if not os.path.exists(f"{ckdir}/state.json"):
        return None
    with open(f"{ckdir}/state.json") as f:
        meta = json.load(f)
    out = {"w_glob": restore(f"{ckdir}/model.msgpack"), **meta}
    if os.path.exists(f"{ckdir}/algo_state.msgpack"):
        out["state"] = _unpack_state(restore(f"{ckdir}/algo_state.msgpack"))
    return out
