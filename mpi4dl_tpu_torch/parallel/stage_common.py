"""The pipeline schedules (counterpart of
``mpi4dl_tpu/parallel/stage_common.py``: ``gpipe_scan`` :137-215,
``resid_depth`` :317, ``make_1f1b_scan`` :504-688, and GEMS's
``gems_dual_scan`` :690-801 and ``make_gems_1f1b_scan`` :804-1013).

Both are Python loops over ticks, run by every rank for the stages it
holds (``stages.local_stages``: one on a :class:`ProcessGroupStages` rank,
all of them on a :class:`StageChain`).  Stage ``s`` forwards micro-batch
``p = t - s`` at tick ``t``; at the end of each tick one
``stages.exchange_streams`` hands activations one stage on and cotangents
one stage back.  The tick loops take one stream, or GEMS's two
(:func:`gems_dual`): stream B runs the same stages at the same ticks on
the mirrored ranks (rank ``d`` runs stage ``S-1-d``), so its activations
flow S-1 → 0 while A's flow 0 → S-1, and one exchange a tick carries
both.  A stage computes only on its valid ticks (the JAX program
computes bubble ticks on don't-care data and masks them; here a bubble is
idle).  The backward is explicit: each stage differentiates its own cells
(``torch.autograd.grad`` of its outputs against the cotangent handed back,
for its parameters and its input), so the same code serves one process
and many ranks.

- :func:`gpipe`: T = Pn + S - 1 forward ticks, then the same ticks in
  reverse for the backward (all forwards, then all backwards, as JAX's AD
  of the tick scan replays them).  With ``remat`` a stage keeps only its
  input and recomputes its cells in the backward (``jax.checkpoint`` of a
  branch); without, it keeps every micro-batch's activations.
- :func:`one_f_one_b`: T = Pn + 2(S - 1) ticks, each one forward and one
  backward micro-batch: stage ``s`` backwards micro-batch ``t - 2(S-1) +
  s``.  A stage other than the last runs its forward without a graph and
  keeps only its input, in a ring of :func:`resid_depth` slots; its
  backward tick recomputes the forward from that input and differentiates
  it.  The last stage forwards and backwards one micro-batch in the same
  tick.  Live activations are O(stages), not O(micro-batches).

Running statistics: each valid forward tick's BatchNorm updates are
summed (the caller divides by Pn); 1F1B's recompute deposits nothing.  The
loss and accuracy are summed over micro-batches on the last stage.  The
loss cotangent is ``seed`` (1/Pn, times the loss scale) on the last stage;
no cotangent is all-reduced.  ``grad_x`` also returns stage 0's input
cotangent per micro-batch, for a differentiated phase before the
pipeline (SP x PP).

``quant`` (``quant.QuantPolicy``, None: off): every stage and cotangent
handoff crosses the ``handoff`` class's wire (``stages.exchange_streams``),
as JAX's ``_handoff`` (``stage_common.py:35-42``) quantizes each ppermute.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from mpi4dl_tpu_torch.layer_ctx import ApplyCtx
from mpi4dl_tpu_torch.obs.scopes import scope
from mpi4dl_tpu_torch.parallel.partition import StagePartition
from mpi4dl_tpu_torch.quant.policy import class_mode


def resid_depth(num_stages: int) -> int:
    """1F1B's residual-ring depth (``stage_common.py:317``): stage ``s``
    holds a micro-batch's input from its forward tick ``p + s`` to its
    backward tick ``p + 2(S-1) - s``, 2(S-1-s) ticks, at most 2(S-1) at
    stage 0, whose read and write land on one slot (reads come first); the
    last stage never uses the ring."""
    return max(1, 2 * (num_stages - 1))


@dataclasses.dataclass
class ScheduleResult:
    """One step's schedule output, for this process's stages."""

    loss: torch.Tensor                 # Σ over micro-batches, last stage; 0 elsewhere
    accuracy: torch.Tensor
    grads: Dict[int, List[torch.Tensor]]  # per local stage, in stage_params order
    stats: Dict[object, tuple]         # BatchNorm -> (Σ mean, Σ var) over Pn ticks
    grad_x: Optional[List[object]]     # stage 0's input cotangent per micro-batch


def _leaves(act):
    return list(act) if isinstance(act, tuple) else [act]


def _like(act, leaves):
    return tuple(leaves) if isinstance(act, tuple) else leaves[0]


def _as_input(act):
    """A received (or injected) activation as a fresh autograd leaf."""
    return _like(act, [t.detach().requires_grad_(t.is_floating_point()) for t in _leaves(act)])


class _Schedule:
    """One stream's state for one step: the stages it runs in this process
    (``local_stages``), its micro-batches and what it accumulates."""

    def __init__(self, part, local_stages, ctx, x_parts, y_parts, seed, grad_x):
        from mpi4dl_tpu_torch.train import accuracy, cross_entropy

        self.part, self.local_stages, self.ctx = part, tuple(local_stages), ctx
        self.x_parts, self.y_parts = x_parts, y_parts
        self.S, self.Pn = part.num_stages, len(x_parts)
        self.seed, self.want_grad_x = seed, grad_x
        self.ce, self.acc_fn = cross_entropy, accuracy
        lead = _leaves(x_parts[0])[0]
        self.device, self.dtype = lead.device, lead.dtype
        zero = torch.zeros((), dtype=torch.promote_types(self.dtype, torch.float32),
                           device=self.device)
        self.loss, self.acc = zero.clone(), zero.clone()
        self.params = {s: part.stage_params(s) for s in self.local_stages}
        self.grads: Dict[int, List[torch.Tensor]] = {}
        self.stats: Dict[object, tuple] = {}
        self.grad_x = [None] * self.Pn if grad_x else None

    def valid(self, p: int) -> bool:
        return 0 <= p < self.Pn

    def spec(self, s: int):
        return (self.part.act_shapes[s], self.dtype, self.device)

    def stage_input(self, s: int, p: int, received):
        if s > 0:
            return _as_input(received[s])
        x = self.x_parts[p]
        return _as_input(x) if self.want_grad_x else x

    def forward(self, s: int, a, grad: bool, deposit: bool, remat: bool = False):
        """Stage ``s`` on ``a``; its BatchNorm updates summed when
        ``deposit``."""
        sink = {} if deposit else None
        c = dataclasses.replace(self.ctx, bn_sink=sink)
        with torch.set_grad_enabled(grad), scope(f"stage{s}"):
            y = self.part.apply(s, a, c, remat=remat)
        for bn, (m, v) in (sink or {}).items():
            old = self.stats.get(bn)
            self.stats[bn] = (m, v) if old is None else (old[0] + m, old[1] + v)
        return y

    def loss_of(self, y, p: int):
        logits = y[0] if isinstance(y, tuple) else y
        labels = self.y_parts[p]
        loss = self.ce(logits, labels)
        self.loss += loss.detach()
        self.acc += self.acc_fn(logits.detach(), labels)
        return loss

    def backward(self, s: int, p: int, a, outputs, cots):
        """Differentiate stage ``s``'s ``outputs`` against ``cots`` for its
        parameters and input ``a``; accumulate the parameter gradients and
        return the input cotangent (None where ``a`` is the raw batch)."""
        pairs = [(o, c) for o, c in zip(outputs, cots) if o.requires_grad]
        inputs = [t for t in _leaves(a) if t.requires_grad]
        wrt = self.params[s] + inputs
        with scope(f"stage{s}_bwd"):
            got = torch.autograd.grad([o for o, _ in pairs], wrt,
                                      grad_outputs=[c for _, c in pairs],
                                      allow_unused=True)
        got = [torch.zeros_like(w) if g is None else g for g, w in zip(got, wrt)]
        n = len(self.params[s])
        acc = self.grads.get(s)
        self.grads[s] = got[:n] if acc is None else [x + g for x, g in zip(acc, got[:n])]
        if not inputs:
            return None
        ga = _like(a, got[n:])
        if s == 0:
            self.grad_x[p] = ga
            return None
        return ga

    def last_stage(self, s: int, p: int, a):
        """The last stage's forward, loss and the loss's seeded backward in
        one go (1F1B); returns the input cotangent."""
        y = self.forward(s, a, grad=True, deposit=True)
        loss = self.loss_of(y, p)
        seed = torch.full((), self.seed, dtype=loss.dtype, device=loss.device)
        return self.backward(s, p, a, [loss], [seed])

    def result(self) -> ScheduleResult:
        return ScheduleResult(self.loss, self.acc, self.grads, self.stats, self.grad_x)


def gpipe(part: StagePartition, stages, ctx: ApplyCtx, x_parts, y_parts, *,
          seed: float, remat: bool = True, grad_x: bool = False,
          quant=None) -> ScheduleResult:
    """The GPipe schedule (``gpipe_scan`` and its AD transpose)."""
    sc = _Schedule(part, stages.local_stages, ctx, x_parts, y_parts, seed, grad_x)
    _gpipe_ticks(part, stages, [sc], remat, class_mode(quant, "handoff"))
    return sc.result()


def one_f_one_b(part: StagePartition, stages, ctx: ApplyCtx, x_parts, y_parts, *,
                seed: float, grad_x: bool = False, quant=None) -> ScheduleResult:
    """The 1F1B schedule (``make_1f1b_scan``)."""
    sc = _Schedule(part, stages.local_stages, ctx, x_parts, y_parts, seed, grad_x)
    _one_f_one_b_ticks(part, stages, [sc], class_mode(quant, "handoff"))
    return sc.result()


def _gpipe_ticks(part: StagePartition, stages, streams, remat: bool,
                 wire=(None, 0)) -> None:
    """GPipe's ticks for one stream, or GEMS's two (``gems_dual_scan``):
    each stream's stage ``s`` forwards micro-batch ``t - s`` at tick ``t``,
    wherever the stream places it, and one ``stages.exchange_streams`` a
    tick carries every stream's handoffs."""
    S, Pn = part.num_stages, streams[0].Pn
    T = Pn + S - 1
    last = S - 1
    saved = [{} for _ in streams]
    received = [{} for _ in streams]
    with scope("gpipe_fwd"):
        for t in range(T):
            hand = []
            for sc, sv, rcv in zip(streams, saved, received):
                fwd = {}
                for s in sc.local_stages:
                    p = t - s
                    if not sc.valid(p):
                        continue
                    a = sc.stage_input(s, p, rcv)
                    y = sc.forward(s, a, grad=True, deposit=True, remat=remat)
                    if s == last:
                        sv[(s, p)] = (a, [sc.loss_of(y, p)])
                    else:
                        sv[(s, p)] = (a, _leaves(y))
                        fwd[s] = _like(y, [v.detach() for v in _leaves(y)])
                want = {s: sc.spec(s) for s in sc.local_stages
                        if s > 0 and sc.valid(t + 1 - s)}
                hand.append((fwd, {}, want, {}))
            with scope("stage_handoff"):
                received = [got for got, _ in stages.exchange_streams(hand, *wire)]
    cots = [{} for _ in streams]
    with scope("gpipe_bwd"):
        for t in reversed(range(T)):
            hand = []
            for sc, sv, cot in zip(streams, saved, cots):
                bwd = {}
                for s in sc.local_stages:
                    p = t - s
                    if not sc.valid(p):
                        continue
                    a, outs = sv.pop((s, p))
                    if s == last:
                        grads_out = [torch.full((), sc.seed, dtype=outs[0].dtype,
                                                device=outs[0].device)]
                    else:
                        grads_out = _leaves(cot[s])
                    ga = sc.backward(s, p, a, outs, grads_out)
                    if ga is not None:
                        bwd[s] = ga
                want = {s: sc.spec(s + 1) for s in sc.local_stages
                        if s < last and sc.valid(t - 1 - s)}
                hand.append(({}, bwd, {}, want))
            with scope("cot_handoff"):
                cots = [got for _, got in stages.exchange_streams(hand, *wire)]


def _one_f_one_b_ticks(part: StagePartition, stages, streams, wire=(None, 0)) -> None:
    """1F1B's ticks for one stream, or GEMS's two (``make_gems_1f1b_scan``:
    stream B's cotangents ascend the ranks while A's descend, and B's last
    stage, which forwards and backwards in one tick, sits on rank 0)."""
    S, Pn = part.num_stages, streams[0].Pn
    D = resid_depth(S)
    T = Pn + 2 * (S - 1)
    last = S - 1
    rings = [{s: [None] * D for s in sc.local_stages} for sc in streams]
    received = [{} for _ in streams]
    cots = [{} for _ in streams]
    for t in range(T):
        hand = []
        for sc, ring, rcv, cot in zip(streams, rings, received, cots):
            fwd, bwd = {}, {}
            for s in sc.local_stages:
                p_f = t - s
                p_b = t - 2 * (S - 1) + s
                if s == last:
                    if sc.valid(p_f):  # p_b == p_f: forward and backward in one tick
                        with scope("fwd_tick"), scope("bwd_tick"):
                            ga = sc.last_stage(s, p_f, sc.stage_input(s, p_f, rcv))
                        if ga is not None:
                            bwd[s] = ga
                    continue
                # The backward first: it reads the ring slot that stage 0's
                # forward below overwrites (resid_depth).
                if sc.valid(p_b):
                    with scope("bwd_tick"):
                        a = ring[s][p_b % D]
                        ring[s][p_b % D] = None
                        a = _as_input(a) if (s > 0 or sc.want_grad_x) else a
                        y = sc.forward(s, a, grad=True, deposit=False)
                        ga = sc.backward(s, p_b, a, _leaves(y), _leaves(cot[s]))
                        del y
                    if ga is not None:
                        bwd[s] = ga
                if sc.valid(p_f):
                    with scope("fwd_tick"):
                        a = sc.stage_input(s, p_f, rcv)
                        a = _like(a, [v.detach() for v in _leaves(a)])
                        ring[s][p_f % D] = a
                        fwd[s] = sc.forward(s, a, grad=False, deposit=True)
            want_f = {s: sc.spec(s) for s in sc.local_stages
                      if s > 0 and sc.valid(t + 1 - s)}
            want_b = {s: sc.spec(s + 1) for s in sc.local_stages
                      if s < last and sc.valid(t + 1 - 2 * (S - 1) + s)}
            hand.append((fwd, bwd, want_f, want_b))
        with scope("stage_handoff"):
            got = stages.exchange_streams(hand, *wire)
        received = [f for f, _ in got]
        cots = [b for _, b in got]


@dataclasses.dataclass
class GemsResult:
    """One GEMS step's dual-stream output for this process: stream A's
    results (its stages are ``stages.local_stages``) and stream B's (its
    stages are the mirror ones, ``S - 1 - s``), summed over the ``times``
    pairs; ``grad_x[k]`` is pair ``k``'s (A, B) input cotangents per
    micro-batch, where this process holds that stream's stage 0."""

    loss: torch.Tensor
    accuracy: torch.Tensor
    grads_a: Dict[int, List[torch.Tensor]]
    grads_b: Dict[int, List[torch.Tensor]]
    stats_a: Dict[object, tuple]
    stats_b: Dict[object, tuple]
    grad_x: Optional[List[tuple]]


def mirror_stages(stages) -> Tuple[int, ...]:
    """Stream B's stages in this process: rank ``d`` runs stage ``S-1-d``."""
    return tuple(stages.num_stages - 1 - s for s in stages.local_stages)


def gems_dual(part: StagePartition, stages, ctx: ApplyCtx, x_groups, y_groups, *,
              seed: float, schedule: str = "gpipe", remat: bool = True,
              grad_x: bool = False, quant=None) -> GemsResult:
    """The GEMS dual-stream schedule (``gems_dual_scan`` :690-801 and
    ``make_gems_1f1b_scan`` :804-1013): for each of the ``times`` pairs,
    stream A (``x_groups[k][0]``, Pn micro-batches) flows through stages 0
    → S-1 on ranks 0 → S-1 and stream B (``x_groups[k][1]``) through the
    same stages on ranks S-1 → 0, both in one tick loop — GPipe's T = Pn +
    S - 1 ticks or 1F1B's Pn + 2(S - 1).  Stream B's stages run on the
    mirror copies of their parameters (the caller fills them); its
    gradients and statistics come back apart from A's."""
    res = GemsResult(0.0, 0.0, {}, {}, {}, {}, [] if grad_x else None)

    def add(acc, d):
        for k, v in d.items():
            acc[k] = v if k not in acc else type(v)(x + y for x, y in zip(acc[k], v))

    for xp, yp in zip(x_groups, y_groups):
        a = _Schedule(part, stages.local_stages, ctx, xp[0], yp[0], seed, grad_x)
        b = _Schedule(part, mirror_stages(stages), ctx, xp[1], yp[1], seed, grad_x)
        wire = class_mode(quant, "handoff")
        if schedule == "1f1b":
            _one_f_one_b_ticks(part, stages, [a, b], wire)
        else:
            _gpipe_ticks(part, stages, [a, b], remat, wire)
        res.loss = res.loss + a.loss + b.loss
        res.accuracy = res.accuracy + a.acc + b.acc
        for acc, d in ((res.grads_a, a.grads), (res.grads_b, b.grads),
                       (res.stats_a, a.stats), (res.stats_b, b.stats)):
            add(acc, d)
        if grad_x:
            res.grad_x.append((a.grad_x if 0 in a.local_stages else None,
                               b.grad_x if 0 in b.local_stages else None))
    return res
