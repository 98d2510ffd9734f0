"""Local training of the port — the twin of the JAX package's
``core/local.py`` for the three ported engines (the four loss variants,
the weighted-mean or a robust reduce (``core.robust``), the adversary's
per-lane delta transform before it), for either small model (the paper's
MLP or CNN).

Parameters and momentum of C lanes each live in ONE contiguous ``(C, P)``
buffer, in the sorted-leaf layout of ``utils.tree``; the model reads
per-leaf views of it, and one update launch covers the whole stack. Each
engine has its entry point:

* ``train`` (sequential engine) — one client visit as a one-lane stack,
  one step per row of the plan, each step's batch moved H2D from the
  client's numpy shard;
* ``train_many`` (batched engine) — one hop of C concurrent visits over
  host-built ``(C, S, B, ...)`` batch stacks moved H2D per call;
* ``train_schedule`` (fused engine) — an eval-to-eval block of rounds as
  ONE call against the device-resident data plane. The JAX package
  compiles it into one ``lax.scan``; here it is a Python loop over rounds
  and, inside a round, over the flat H*S steps of ``_run_hops`` (for
  HierFAVG over R chained edge iterations of one hop each);
* ``train_many_fused`` (the personalization stage, ``core.personalize``)
  — one visit group of H hops against the data plane, without a reduce:
  the trained (C, P) lane stack is the result.

The variants (``variant=`` and its extras, as in the reference):

* ``"plain"`` — the classifier loss;
* ``"prox"`` (FedProx) — plus ``mu/2 ||w - anchor||^2`` per lane, the
  anchor the round's (P,) global model;
* ``"moon"`` (MOON) — plus ``mu`` times the model-contrastive loss of each
  lane's features against those of the (P,) global model ``w_glob``
  (positive) and of its (C, P) previous local model ``w_prev``
  (negative);
* ``"scaffold"`` (SCAFFOLD) — the plain loss, and the momentum-free
  drift-corrected update ``p - lr*(g + c_glob - c_local)`` with the (P,)
  server variate and the (C, P) client variates. It never goes through
  ``fused_sgd``, whatever ``use_fused_sgd`` says, as in the reference.

The ``"prox"`` and ``"moon"`` gradients reach the momentum update through
the same leaves, so ``fused_sgd``'s contract is unchanged. The fused
block carries MOON's and SCAFFOLD's device-resident state
(``core.state``) from round to round.

A lane-stacked step (``_sgd_steps``, shared by ``train_many`` and
``_run_hops``; only the batch source differs) takes every lane's gradient
with one autograd pass over the lane-summed loss (lanes are independent,
so each gets its own gradient), then applies the masked momentum update.
Momentum is zeroed wherever a new client visit starts. The gradient stays
as autograd's per-leaf tensors: the fused update reads them in place, and
only the unfused masked path concatenates them into a flat ``(C, P)``
buffer (the reference's ``ravel_pytree``). The CNN's conv-weight
gradients come back from autograd as permuted views of the grouped conv's
(C*Cout, Cin, 3, 3) gradient; each is copied dense (one copy kernel per
conv weight a step), since the kernel reads leaves only in place and
contiguous.

The update rounds in three forms, as in the reference (ROADMAP C2), so
each path is held against its own reference path:

* masked, ``use_fused_sgd=False`` — the reference's folded-mask
  arithmetic, ``m' = m + ok*((mu-1)m + g)``, ``p' = p - (ok*lr)*m'``;
* masked, ``use_fused_sgd=True`` — ``m' = mu*m + g`` under a per-lane
  select: the hand-written CUDA kernel on the GPU (``kernels.fused_sgd``),
  its plain version on the CPU;
* unmasked (``train``) — ``m' = mu*m + g``, ``p' = p - lr*m'``: the same
  kernel with every lane stepping when ``use_fused_sgd``, else per leaf in
  torch ops.

DP-SGD (``FLConfig.dp_clip > 0``) transforms every step's gradient
between autograd and the update, under every engine and variant, as the
reference's ``_make_dp`` does (``dp_clip_noise_``): each lane's
batch-mean gradient (the whole loss's: FedProx's and MOON's terms
included, SCAFFOLD's before its drift correction) is clipped to L2 norm
``dp_clip`` over all its leaves, then every element gets Gaussian noise of
std ``dp_noise_mult * dp_clip``. Masked lanes are transformed too; the
masked update discards them. The transform works in place on autograd's
leaves, so the fused update still reads them in place. The noise comes
from the trainer's own ``torch.Generator`` on its device, seeded once from
``dp_seed`` and drawn on the training thread in step order; it never
touches the experiment's numpy RNG, so plans and meters are those of the
run without noise. Torch cannot replay ``jax.random``, and a CUDA
generator draws other numbers than a CPU one, so a noised run matches the
reference in law, not element for element.

``grad_mask`` (the reference's, for head-only personalization) freezes
leaves: a params-shaped 0/1 mask, kept as one tensor a leaf in the
layout's order, multiplied in place into every gradient leaf between
autograd and the DP transform, on every path. A frozen leaf's gradient is
zero, so its momentum stays zero and the update leaves it bit for bit;
it still goes through the update, and DP noise, added after the mask,
moves it (ROADMAP C10).

``train_many`` and ``train_schedule`` take the sim mesh (``mesh=``;
``launch.mesh``) of the sharded engine and ``mesh_data_axis``: the lane
axis C must be a multiple of the mesh size, with the reference's
``ValueError`` otherwise. Every mesh entry is the trainer's one device, so
placement leaves the lanes where they are; a ghost lane is an ordinary lane whose ``valid`` row is all false.

Counters, as the reference meters them: ``h2d_bytes`` (what each entry
point ships: per-step batches, per-hop stacks and masks, or the block's
index plans and per-round arrays) and ``dispatches`` (one per step, per
hop call, or per block).
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.plan import GLOBAL
from repro_torch.core.robust import robust_agg
from repro_torch.core.state import gather_rows, scaffold_step, scatter_rows
from repro_torch.kernels.fused_sgd.ops import fused_sgd_lanes
from repro_torch.kernels.fused_sgd.ref import flat_grads
from repro_torch.launch.mesh import check_lane_axis
from repro_torch.models.registry import specs_for
from repro_torch.data.pipeline import plan_epoch_indices
from repro_torch.models.small import (
    classifier_loss_and_features_lanes, classifier_loss_lanes,
    small_model_features_lanes,
)
from repro_torch.utils.device import resolve_device
from repro_torch.utils.tree import unravel


def _h2d_nbytes(a) -> int:
    """Bytes that cross H2D for one host array, metered as the reference
    meters them: 64-bit dtypes count as the 32-bit arrays JAX ships."""
    a = np.asarray(a)
    return a.size * min(a.dtype.itemsize, 4)


# the extras each loss variant reads, in the reference's order; the
# per-lane ones (MOON's w_prev, SCAFFOLD's c_local) are (C, P) stacks.
# SCAFFOLD's feed its update; the others feed the loss (``lane_grads``).
_EXTRAS = {"plain": (), "prox": ("anchor",), "moon": ("w_glob", "w_prev"),
           "scaffold": ("c_glob", "c_local")}
_PER_LANE = ("w_prev", "c_local")
_LOSS_EXTRAS = ("anchor", "w_glob", "w_prev")


def _variant_extras(variant: str, **extras) -> Dict[str, torch.Tensor]:
    """The extras that ``variant`` reads, each required; the others are
    ignored."""
    if variant not in _EXTRAS:
        raise ValueError(f"unknown loss variant {variant!r}")
    out = {}
    for k in _EXTRAS[variant]:
        if extras.get(k) is None:
            raise ValueError(f"the {variant!r} loss needs {k}=")
        out[k] = extras[k]
    return out


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's cosine over the last axis: each side divided by its
    norm plus 1e-8 (the norm as ``sqrt(sum(x*x))``, as ``jnp.linalg.norm``
    computes it and differentiates it)."""
    a = a / (torch.sqrt(torch.sum(a * a, -1, keepdim=True)) + 1e-8)
    b = b / (torch.sqrt(torch.sum(b * b, -1, keepdim=True)) + 1e-8)
    return torch.sum(a * b, -1)


def apply_lane_scale(lanes: torch.Tensor, scale: torch.Tensor,
                     ref: torch.Tensor) -> torch.Tensor:
    """The adversary's Byzantine delta transform on a (C, P) lane stack:
    lane c becomes ``ref + scale[c] * (lane - ref)`` (honest lanes carry
    1.0). ``ref`` is the lanes' seed: one (P,) model or a (C, P) stack."""
    return ref + scale.view(-1, 1) * (lanes - ref)


def masked_momentum_update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                           ok: torch.Tensor, lr: torch.Tensor, *, reset: bool,
                           momentum: float) -> None:
    """The reference's unfused masked update, in place on (C, P) buffers:
    an invalid step (ok = 0) is folded into the arithmetic,
    ``m' = m + ok*((mu-1)m + g)`` and ``p' = p - (ok*lr)*m'``."""
    if reset:
        m.zero_()
    okf = ok.to(p.dtype).view(-1, 1)
    m.add_(okf * ((momentum - 1.0) * m + g))
    p.sub_((okf * lr) * m)


def dp_clip_noise_(grads, clip: float, sigma: float,
                   gen: Optional[torch.Generator]) -> torch.Tensor:
    """The reference's DP-SGD transform (``_make_dp(clip, sigma, True)``),
    in place on the gradient leaves ``grads`` (one (C, *shape) tensor a
    leaf, in the layout's sorted order): each lane's squared L2 norm ``sq``
    summed over the leaves, ``fac = min(1, clip / sqrt(sq + 1e-12))`` times
    every leaf of the lane, then, when ``sigma > 0``, ``sigma`` times a
    standard normal drawn from ``gen`` added to every element, leaf by
    leaf. Returns the (C,) factors."""
    sq = sum(torch.sum(g * g, dim=tuple(range(1, g.dim()))) for g in grads)
    fac = torch.clamp(clip / torch.sqrt(sq + 1e-12), max=1.0)
    for g in grads:
        g.mul_(fac.view(-1, *[1] * (g.dim() - 1)))
        if sigma > 0:
            g.add_(torch.randn(g.shape, generator=gen, dtype=g.dtype,
                               device=g.device), alpha=sigma)
    return fac


class LocalTrainer:
    """Lane-stacked local SGD for one (model, FL) config on one device."""

    def __init__(self, cfg: ModelConfig, fl: FLConfig, device=None,
                 grad_mask: Optional[Mapping] = None):
        self.cfg = cfg
        self.fl = fl
        self.device = resolve_device(device)
        specs = specs_for(cfg)
        self.layout = tuple((k, specs[k].shape) for k in sorted(specs))
        # the frozen-leaf mask, one (*shape) float32 tensor a leaf
        self._mask = None if grad_mask is None else tuple(
            torch.as_tensor(grad_mask[k], dtype=torch.float32,
                            device=self.device).reshape(shape)
            for k, shape in self.layout)
        self.h2d_bytes = 0
        self.dispatches = 0
        # DP-SGD: (clip, noise std) and the noise stream, seeded once
        self._dp = None
        if fl.dp_clip > 0:
            self._dp = (float(fl.dp_clip), float(fl.dp_noise_mult * fl.dp_clip))
            self._dp_gen = torch.Generator(device=self.device)
            self._dp_gen.manual_seed(fl.dp_seed)
        self.last_steps = 0

    # ------------------------------------------------------------------
    def lane_grads(self, params: torch.Tensor, batch: Dict[str, torch.Tensor],
                   anchor: Optional[torch.Tensor] = None, *,
                   w_glob: Optional[torch.Tensor] = None,
                   w_prev: Optional[torch.Tensor] = None):
        """Per-lane losses (C,) and the gradient as autograd's leaves, one
        contiguous (C, *shape) tensor per leaf in ``self.layout`` order,
        for the (C, P) flat lane stack ``params``. ``.contiguous()`` is a
        no-op on every leaf but the CNN's conv weights. With ``anchor`` (a
        (P,) model, never differentiated) each lane's loss is FedProx's,
        the reference's ``prox_loss``: the classifier loss plus
        ``0.5 * mu * sum_k ||w_k - anchor_k||^2`` over the leaves. With
        ``w_glob`` (P,) and ``w_prev`` (C, P) it is MOON's, the reference's
        ``moon_loss``: the classifier loss plus ``mu`` times
        ``-mean_b(pos - logaddexp(pos, neg))``, where ``pos`` and ``neg``
        are the cosines (over ``moon_tau``) of each sample's features under
        the lane's weights with those under ``w_glob`` and under the lane's
        ``w_prev``; those two feature sets carry no gradient."""
        leaves = {k: v.detach().requires_grad_()
                  for k, v in unravel(params, self.layout).items()}
        with torch.enable_grad():
            if w_glob is None:
                losses = classifier_loss_lanes(leaves, batch, self.cfg)
            else:
                losses = self._moon_losses(leaves, batch, w_glob, w_prev)
            if anchor is not None:
                anc = unravel(anchor, self.layout)
                sq = sum(torch.square(leaves[k] - anc[k]).flatten(1).sum(1)
                         for k, _ in self.layout)
                losses = losses + 0.5 * self.fl.mu * sq
            grads = torch.autograd.grad(
                losses.sum(), [leaves[k] for k, _ in self.layout])
        return losses.detach(), tuple(g.contiguous() for g in grads)

    def _moon_losses(self, leaves, batch, w_glob: torch.Tensor,
                     w_prev: torch.Tensor) -> torch.Tensor:
        """MOON's per-lane loss (see ``lane_grads``): ``z_g`` is the one
        global model's features on every lane's batch, ``z_p`` each lane's
        previous local model's on its own."""
        ce, z = classifier_loss_and_features_lanes(leaves, batch, self.cfg)
        images = batch["images"]
        C, B = images.shape[:2]
        with torch.no_grad():
            z_g = small_model_features_lanes(
                unravel(w_glob.unsqueeze(0), self.layout),
                images.reshape(1, C * B, *images.shape[2:]),
                self.cfg).reshape(C, B, -1)
            z_p = small_model_features_lanes(unravel(w_prev, self.layout),
                                             images, self.cfg)
        pos = _cos(z, z_g) / self.fl.moon_tau
        neg = _cos(z, z_p) / self.fl.moon_tau
        con = -torch.mean(pos - torch.logaddexp(pos, neg), dim=-1)
        return ce + self.fl.mu * con

    def _step_grads(self, params, batch, loss_kw):
        """``lane_grads``'s gradient leaves, masked by ``grad_mask`` and
        then DP-transformed, in place, as far as the trainer asks."""
        _, grads = self.lane_grads(params, batch, **loss_kw)
        if self._mask is not None:
            for g, mk in zip(grads, self._mask):
                g.mul_(mk)
        if self._dp is not None:
            dp_clip_noise_(grads, *self._dp, self._dp_gen)
        return grads

    def _update(self, p, grads, m, ok, lr, reset: bool) -> None:
        """The masked momentum step on the (C, P) stack ``p`` from the
        gradient leaves ``grads``: the fused update reads them in place,
        the unfused one concatenates them first."""
        if self.fl.use_fused_sgd:
            fused_sgd_lanes(p, grads, m, ok, lr, reset=reset,
                            momentum=self.fl.momentum)
        else:
            masked_momentum_update(p, flat_grads(grads, p.shape[0]), m, ok,
                                   lr, reset=reset, momentum=self.fl.momentum)

    def _scaffold_update(self, p, grads, lr, c_glob, c_local,
                         ok: Optional[torch.Tensor] = None) -> None:
        """SCAFFOLD's momentum-free step, in place on the (C, P) stack
        ``p``, leaf by leaf on views (no gradient is concatenated): the
        reference's ``scaffold_update``, ``p - lr*(g + c - ci)``, or with
        the (C,) step mask ``ok`` its ``masked_scaffold_update``,
        ``p - (ok*lr)*(g + c - ci)``. Never ``fused_sgd``."""
        rate = lr if ok is None else ok.to(p.dtype).view(-1, 1) * lr
        for pk, ck, cik, g in zip(unravel(p, self.layout).values(),
                                  unravel(c_glob, self.layout).values(),
                                  unravel(c_local, self.layout).values(),
                                  grads):
            scale = rate if ok is None else rate.view(-1, *[1] * (g.dim() - 1))
            pk.sub_(scale * (g + ck - cik))

    def _sgd_steps(self, params: torch.Tensor,
                   batch_at: Callable[[int], Dict[str, torch.Tensor]],
                   ok: torch.Tensor, lr: torch.Tensor, S: int,
                   extras: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The flat loop of masked SGD steps, in place on the (C, P) lane
        stack ``params``: step t trains on ``batch_at(t)`` (a (C, B, ...)
        batch), lanes where ``ok[t]`` (T, C) is False are left unchanged,
        and a client visit starts — the momentum is zeroed — when
        t % S == 0 (the reference's per-step reset flag). ``extras``: the
        loss variant's (``_variant_extras``); SCAFFOLD's take its update
        instead of the momentum step."""
        scaffold = "c_glob" in extras
        loss_kw = {k: v for k, v in extras.items() if k in _LOSS_EXTRAS}
        m = None if scaffold else torch.zeros_like(params)
        for t in range(ok.shape[0]):
            grads = self._step_grads(params, batch_at(t), loss_kw)
            if scaffold:
                self._scaffold_update(params, grads, lr, extras["c_glob"],
                                      extras["c_local"], ok[t])
            else:
                self._update(params, grads, m, ok[t], lr, reset=t % S == 0)
        return params

    @torch.no_grad()
    def _run_hops(self, params: torch.Tensor, plane, rows: torch.Tensor,
                  plans: torch.Tensor, valid: torch.Tensor,
                  lr: torch.Tensor,
                  extras: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The flat H*S-step gathered-SGD loop over one visit group, in
        place on the (C, P) lane stack ``params``; ``rows`` (H, C),
        ``plans`` (H, C, S, B) and ``valid`` (H, C, S) index the
        device-resident fleet arrays, ``lr`` is a (1,) tensor."""
        H, C, S = valid.shape
        flat_rows = rows.repeat_interleave(S, dim=0)                 # (HS, C)
        flat_ix = plans.permute(0, 2, 1, 3).reshape(H * S, C, -1)   # (HS, C, B)
        flat_ok = valid.permute(0, 2, 1).reshape(H * S, C).contiguous()

        def gather(t):
            # fleet row r, sample i -> flat row offsets[r] + i
            gidx = (torch.index_select(plane.offsets, 0, flat_rows[t])
                    .unsqueeze(1) + flat_ix[t]).reshape(-1)
            return {
                "images": torch.index_select(plane.images, 0, gidx)
                .reshape(C, -1, *plane.images.shape[1:]),
                "labels": torch.index_select(plane.labels, 0, gidx)
                .reshape(C, -1),
            }
        return self._sgd_steps(params, gather, flat_ok, lr, S, extras)

    def _device_lr(self, lr: float) -> torch.Tensor:
        """A python learning rate as the (1,) float32 device tensor the
        update reads (the reference's ``jnp.asarray(lr, jnp.float32)``)."""
        return torch.tensor([lr], dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def train(self, params: torch.Tensor, client, *, lr: float,
              epochs: Optional[int] = None,
              rng: Optional[np.random.Generator] = None,
              plan: Optional[np.ndarray] = None, variant: str = "plain",
              anchor: Optional[torch.Tensor] = None,
              w_glob: Optional[torch.Tensor] = None,
              w_prev: Optional[torch.Tensor] = None,
              c_glob: Optional[torch.Tensor] = None,
              c_local: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One client visit (the sequential engine's unit): from the flat
        (P,) model ``params``, one step per row of the pre-drawn ``plan``
        (a (steps, batch) index array), or of one drawn from ``rng`` with
        the planners' calls (``plan_epoch_indices`` over ``epochs``).
        Momentum starts at zero. The model trains as a one-lane (1, P)
        stack; each step's batch moves H2D from the client's numpy shard
        and is metered into ``h2d_bytes``, and each step is one dispatch.
        The update is unmasked (see the module docstring). ``variant``
        picks the loss and its extras, each a (P,) model here (the
        client's own ``w_prev``/``c_local`` too). Returns the trained (P,)
        model; ``params`` is left as it was. The visit's step count is left
        in ``last_steps`` (Centralized's privacy ledger reads it)."""
        extras = {k: v.reshape(1, -1) if k in _PER_LANE else v
                  for k, v in _variant_extras(
                      variant, anchor=anchor, w_glob=w_glob, w_prev=w_prev,
                      c_glob=c_glob, c_local=c_local).items()}
        if plan is None:
            if epochs is None or rng is None:
                raise ValueError(
                    "train() needs a pre-drawn plan= or epochs= and rng= "
                    "to draw one")
            plan = plan_epoch_indices(client, self.fl.batch_size, epochs, rng)
        scaffold = "c_glob" in extras
        loss_kw = {k: v for k, v in extras.items() if k in _LOSS_EXTRAS}
        p = params.reshape(1, -1).clone()
        m = None if scaffold else torch.zeros_like(p)
        lr = self._device_lr(lr)
        ok = torch.ones(1, dtype=torch.bool, device=p.device)
        mom = self.fl.momentum
        self.last_steps = int(plan.shape[0])
        for s, sl in enumerate(plan):
            batch = {"images": client.images[sl], "labels": client.labels[sl]}
            self.h2d_bytes += sum(_h2d_nbytes(v) for v in batch.values())
            self.dispatches += 1
            grads = self._step_grads(p, {
                k: torch.from_numpy(v).to(self.device).unsqueeze(0)
                for k, v in batch.items()}, loss_kw)
            if scaffold:
                self._scaffold_update(p, grads, lr, extras["c_glob"],
                                      extras["c_local"])
            elif self.fl.use_fused_sgd:
                fused_sgd_lanes(p, grads, m, ok, lr, reset=s == 0,
                                momentum=mom)
            else:
                for pk, mk, g in zip(unravel(p, self.layout).values(),
                                     unravel(m, self.layout).values(), grads):
                    mk.mul_(mom).add_(g)
                    pk.sub_(lr * mk)
        return p.reshape(-1)

    @torch.no_grad()
    def train_many(self, params: torch.Tensor, batches: Dict[str, np.ndarray],
                   valid: np.ndarray, *, lr: float, broadcast: bool = False,
                   agg: Optional[np.ndarray] = None, keep_locals: bool = False,
                   agg_gw: Optional[np.ndarray] = None,
                   reducer: str = "weighted_mean", trim_frac: float = 0.0,
                   krum_f: int = 0,
                   dscale: Optional[np.ndarray] = None,
                   dref: Optional[torch.Tensor] = None,
                   variant: str = "plain", mesh=None,
                   anchor: Optional[torch.Tensor] = None,
                   w_glob: Optional[torch.Tensor] = None,
                   w_prev: Optional[torch.Tensor] = None,
                   c_glob: Optional[torch.Tensor] = None,
                   c_local: Optional[torch.Tensor] = None):
        """One hop of C concurrent client visits as one call (the batched
        engine's unit). ``batches`` (``images`` (C, S, B, ...), ``labels``
        (C, S, B)) and the (C, S) step mask ``valid`` are host arrays
        (``stack_plans``), moved to the device here and metered into
        ``h2d_bytes``; the call is one dispatch. ``params`` is the (C, P)
        lane stack, trained in place, or with ``broadcast=True`` one (P,)
        model every lane starts from. Momentum starts at zero; invalid
        steps leave their lane unchanged. ``agg`` (``AggSpec.matrix``) folds
        the reduce into the call: a (C,) weight vector returns the (P,)
        aggregate, a (G, C) matrix the (G, P) per-group stack; without it
        the trained (C, P) stack is returned, and with ``keep_locals`` the
        pair (aggregate, trained stack). A robust ``reducer``
        (``AggSpec.reduce_kwargs``) takes ``agg`` as the uncollapsed
        (G, C) lane-weight matrix and ``agg_gw`` as the (G,) group weights
        (None: the (G, P) stack) and reduces through ``robust_agg``.
        ``dscale`` (C,) is the adversary's
        per-lane delta factor (``VisitGroup.lane_scale``), applied to the
        trained lanes before the reduce (and in the returned stack)
        against ``dref`` or, without it, the lanes' seed ``params``; like
        ``agg`` it is not metered, as the reference meters the call.
        ``variant`` and its extras: the loss, as in ``train``, the
        per-lane ones (C, P) stacks. With ``mesh`` (``launch.mesh``) C
        must be a multiple of the mesh's axis size (callers ghost-pad);
        the lanes stay on the trainer's device, every mesh entry's."""
        if mesh is not None:
            check_lane_axis(mesh, valid.shape[0], "client", self.device)
        extras = _variant_extras(variant, anchor=anchor, w_glob=w_glob,
                                 w_prev=w_prev, c_glob=c_glob,
                                 c_local=c_local)
        self.h2d_bytes += (sum(_h2d_nbytes(v) for v in batches.values())
                           + _h2d_nbytes(valid))
        self.dispatches += 1
        C, S = valid.shape
        # (C, S, ...) host stacks -> (S, C, ...) on the device, so step s
        # reads one contiguous (C, B, ...) batch
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               .transpose(0, 1).contiguous() for k, v in batches.items()}
        ok = torch.from_numpy(np.ascontiguousarray(valid.T)).to(self.device)
        # repeat copies even one lane (an expanded (1, P) view would share
        # the caller's storage, and the steps train the stack in place)
        lanes = params.repeat(C, 1) if broadcast else params
        if dscale is not None and dref is None:
            # the lanes' seed, before the steps train the stack in place
            dref = params if broadcast else params.clone()
        self._sgd_steps(lanes, lambda s: {k: v[s] for k, v in dev.items()},
                        ok, self._device_lr(lr), S, extras)
        if dscale is not None:
            lanes = apply_lane_scale(lanes, torch.from_numpy(
                np.asarray(dscale, np.float32)).to(self.device), dref)
        if agg is None:
            return lanes
        agg = torch.from_numpy(np.asarray(agg, np.float32)).to(self.device)
        if reducer == "weighted_mean":
            out = agg @ lanes
        else:
            out = robust_agg(lanes, agg, agg_gw, reducer, trim_frac, krum_f)
        return (out, lanes) if keep_locals else out

    @torch.no_grad()
    def train_many_fused(self, params: torch.Tensor, plane, rows: np.ndarray,
                         plans: np.ndarray, valid: np.ndarray, *,
                         lr: float) -> torch.Tensor:
        """One visit group of H hops against the device data plane
        ``plane`` as one call (one dispatch), without a reduce: the
        reference's ``train_many_fused`` with ``agg=None``, as the
        personalization stage calls it. ``rows`` (H, C), ``plans``
        (H, C, S, B) and ``valid`` (H, C, S) are ``stack_plan_indices``'s
        host arrays, the call's whole H2D payload (metered into
        ``h2d_bytes``); every lane starts from the (P,) model ``params``,
        and hop h trains fleet row ``rows[h, c]`` on plan ``plans[h, c]``,
        momentum reset at each visit. Returns the trained (C, P) stack.
        The plain loss only; the reference's other options run in the
        port through ``train_schedule`` and ``train_many``."""
        rows = np.asarray(rows, np.int32)
        plans = np.asarray(plans, np.int32)
        valid = np.asarray(valid, bool)
        self.h2d_bytes += rows.nbytes + plans.nbytes + valid.nbytes
        self.dispatches += 1
        dev = [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
               for a in (rows, plans, valid)]
        # repeat copies even one lane, as in train_many
        lanes = params.repeat(valid.shape[1], 1)
        return self._run_hops(lanes, plane, *dev, self._device_lr(lr), {})

    @torch.no_grad()
    def train_schedule(self, w_glob: torch.Tensor, plane,
                       xs: Dict[str, np.ndarray],
                       carry: Optional[Dict[str, torch.Tensor]] = None, *,
                       variant: str = "plain",
                       shared_extras: Optional[Dict] = None,
                       stacked_extras: Optional[Dict] = None,
                       reducer: str = "weighted_mean",
                       trim_frac: float = 0.0, krum_f: int = 0,
                       mesh=None):
        """An entire block of rounds as ONE call (one dispatch).

        ``w_glob`` is the global model as a flat (P,) vector. ``xs`` stacks
        the block along a leading round axis n (built by
        ``engines.fused.FusedEngine``): ``rows`` (n, H, C), ``plans``
        (n, H, C, S, B), ``valid`` (n, H, C, S), ``lr`` (n,) and the
        collapsed eq.-11 weights ``aggv`` (n, C) — the block's whole H2D
        payload — plus the state lanes of MOON and SCAFFOLD: each lane's
        client row ``ids`` (n, C), MOON's ``use_prev`` (n, C), SCAFFOLD's
        ``kl`` (n, C), ``mw`` (n, C) and ``frac`` (n,). Each round
        broadcasts the carried global to the C lanes, runs the hop loop,
        contracts ``aggv`` against the trained stack and updates the state
        ``carry`` (``core.state``): MOON scatters the trained lanes into
        its ``prev`` rows, SCAFFOLD applies ``scaffold_step`` to ``c`` and
        ``ci``. ``variant`` and the plans' extras give the loss: ``GLOBAL``
        reads the round's carried global; a ``StateRef`` reads ``carry``, a
        per-lane one the rows ``ids`` of its client stack (with
        ``fallback_global`` the carried global where ``use_prev`` is
        False). With ``wg`` in ``xs`` (HierFAVG) the H axis is the round's
        R edge iterations of one hop each: each lane starts from its edge's
        row ``seed`` (n, C) of the (G, P) edge models (the carried global in
        iteration 0), and after every iteration but the last the per-edge
        reduce ``wg`` (n, G, C) gives the next edge models; the last applies
        ``aggv``. With ``dscale`` (n, C) in ``xs`` (an attacked block) each
        round's trained lanes take the adversary's delta transform before
        every reduce and the state update, against their seed: the round's
        global, or each HierFAVG iteration's edge rows. A robust
        ``reducer`` (with ``trim_frac``, ``krum_f``; ``core.robust``) takes
        every round's reduce: a cohort block ships the uncollapsed
        lane weights ``aggw`` (n, G, C) and the group weights ``aggg``
        (n, G) in place of ``aggv``, a HierFAVG block reduces each
        iteration by ``wg``'s validity and the last one with the cloud
        weights ``gwv`` (n, G). With ``mesh`` every lane axis C must be a
        multiple of the mesh's axis size (the engine ghost-pads), as
        in ``train_many``. Returns the new (P,) global model and the new
        carry."""
        if mesh is not None:
            check_lane_axis(mesh, xs["valid"].shape[2], "schedule",
                            self.device)
        self.h2d_bytes += sum(_h2d_nbytes(v) for v in xs.values())
        self.dispatches += 1
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in xs.items()}
        carry = dict(carry or {})
        n, H, C = xs["rows"].shape
        rk = (reducer, trim_frac, krum_f)
        w = w_glob
        for r in range(n):
            x = {k: v[r] for k, v in dev.items()}
            lr = dev["lr"][r:r + 1]
            ids = x["ids"].long() if "ids" in x else None
            extras = self._block_extras(variant, shared_extras or {},
                                        stacked_extras or {}, w, carry, x,
                                        ids)
            ds = x.get("dscale")
            if "wg" in x:
                edges = w.unsqueeze(0).expand(x["wg"].shape[0], -1)
                for it in range(H):
                    lanes = self._run_hops(
                        torch.index_select(edges, 0, x["seed"]), plane,
                        x["rows"][it:it + 1], x["plans"][it:it + 1],
                        x["valid"][it:it + 1], lr, extras)
                    if ds is not None:
                        # the iteration's seeds, gathered again (the
                        # steps trained the first gather in place)
                        lanes = apply_lane_scale(
                            lanes, ds,
                            torch.index_select(edges, 0, x["seed"]))
                    if it < H - 1:
                        edges = (x["wg"] @ lanes if "aggv" in x
                                 else robust_agg(lanes, x["wg"], None, *rk))
            else:
                lanes = self._run_hops(
                    w.repeat(C, 1), plane,
                    x["rows"], x["plans"], x["valid"], lr, extras)
                if ds is not None:
                    lanes = apply_lane_scale(lanes, ds, w)
            if variant == "moon":
                carry["prev"] = scatter_rows(carry["prev"], ids, lanes)
            elif variant == "scaffold":
                carry["c"], carry["ci"] = scaffold_step(
                    carry["c"], carry["ci"], ids, lanes, w, x["kl"],
                    x["mw"], x["frac"])
            if "aggv" in x:
                w = x["aggv"] @ lanes
            elif "gwv" in x:
                w = robust_agg(lanes, x["wg"], x["gwv"], *rk)
            else:
                w = robust_agg(lanes, x["aggw"], x["aggg"], *rk)
        return w, carry

    @staticmethod
    def _block_extras(variant, shared, stacked, w, carry, x, ids):
        """One round's loss extras inside the fused block, resolved from
        the carried global ``w`` and the state ``carry``: ``GLOBAL`` is
        ``w``, a shared ``StateRef`` its ``carry`` entry; a per-lane entry
        (a ``StateRef`` a lane, all on one field) gathers the lanes' rows
        ``ids`` of that client stack, and with ``fallback_global`` takes
        ``w`` where ``use_prev`` is False (the client had no row yet)."""
        out = {k: w if v is GLOBAL else carry[v.field]
               for k, v in shared.items()}
        for k, refs in stacked.items():
            rows = gather_rows(carry[refs[0].field], ids)
            if refs[0].fallback_global:
                rows = torch.where(x["use_prev"].unsqueeze(1), rows,
                                   w.unsqueeze(0))
            out[k] = rows
        return _variant_extras(variant, **out)
