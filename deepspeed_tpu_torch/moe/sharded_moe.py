"""GShard-style top-k gating and the expert layer's dispatch: the port of
``moe/sharded_moe.py``.

The gate reads its tokens in fp32 (``TopKGate``, an fp32 ``wg``) and
routes each one to its top-1 or top-2 experts, exactly as the JAX
``top1gating``/``top2gating`` do: argmax ties go to the first expert; a
token's slot in its expert's queue is the count of earlier tokens (in
token order, or in a random priority order with ``use_rts``) routed
there, top-2's second choices stacked after every first choice; a route
whose slot reaches the capacity ``max(int(t·cf/E), min_capacity)`` is
dropped (top-2: ``2·cf``); ``drop_tokens=False`` drops nothing.  The
load-balancing loss ``l_aux = E·Σ_e mean(gates_e)·mean(top-1 mask_e)``
reads the top-1 mask before any drop.  ``noisy_gate_policy="RSample"``
(Gumbel noise on the top-1 choice) and ``use_rts`` draw from an explicit
``torch.Generator``: the same distributions as the JAX package's threefry
draws, not the same bits.

The JAX layer dispatches with one-hot ``[t, E, C]`` einsums.  The port
computes the same function by index (:func:`moe_layer_forward`): the
routing is held as each route's expert, slot and keep flag
(:class:`Routing`), kept tokens are scattered into an ``[E, C, d]``
buffer, the experts run on it (``experts_apply``), and each token gathers
its routes' outputs weighted by their gates.  A dropless call (inference)
sizes C to the busiest expert, one read of a count from the device; a
call of at most :data:`GATHER_MAX_ROUTES` routes (decode) instead gathers
the routed experts' weights and runs each route alone
(``experts_apply_routed``), with no read from the device.
:func:`top1gating` and :func:`top2gating` still return the JAX package's
dense ``(l_aux, combine, dispatch, exp_counts)``.

:func:`recording_routes` collects, in call order, the :class:`Routing`
of every expert layer that decides its routing inside the block, whoever
calls it (a model, the serving engine, the batcher's thread): what a
check of routing against a reference reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .experts import experts_apply, experts_apply_routed

#: a dropless call with at most this many (token, expert) routes runs each
#: route on its gathered expert weights instead of the [E, C, d] buffer
GATHER_MAX_ROUTES = 16


#: the open recorders of :func:`recording_routes`
_RECORDERS: List[List["Routing"]] = []


@contextlib.contextmanager
def recording_routes() -> Iterator[List["Routing"]]:
    """A list that receives the :class:`Routing` of every expert layer
    call that routes inside the block (one per layer and call, rows in
    the call's row-major token order; a remat replay reuses its forward's
    and adds none)."""
    sink: List[Routing] = []
    _RECORDERS.append(sink)
    try:
        yield sink
    finally:
        _RECORDERS.remove(sink)


def _capacity(num_tokens: int, num_experts: int, capacity_factor: float,
              min_capacity: int) -> int:
    cap = int(num_tokens * capacity_factor / num_experts)
    return max(cap, min_capacity)


@dataclasses.dataclass
class Routing:
    """One gate call's decisions, by index: each token's ``k`` routes."""

    expert: torch.Tensor      # [t, k] long: the route's expert
    slot: torch.Tensor        # [t, k] long: its place in the expert's queue
    keep: torch.Tensor        # [t, k] bool: not dropped (and a used token)
    ce: torch.Tensor          # [E] fp32: mean of the pre-drop top-1 mask
    exp_counts: torch.Tensor  # [E] fp32: the JAX package's exp_counts
    capacity: Optional[int]   # slots per expert; None: dropless
    logits: torch.Tensor      # [t, E] fp32: the gate logits it came from

    @property
    def k(self) -> int:
        return self.expert.shape[1]


def _one_hot(idx, n):
    return F.one_hot(idx, n).float()


def _queue_positions(mask):
    """Each token's place in its expert's queue, in token order: the
    number of earlier tokens of the same expert (``mask`` [t, E])."""
    return ((torch.cumsum(mask, dim=0) - mask) * mask).sum(-1)


def _gumbel(shape, generator, device):
    u = torch.empty(shape, device=device).exponential_(generator=generator)
    return -torch.log(u)


def top1_routing(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
                 used_token=None, noisy_gate_policy: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 drop_tokens: bool = True, use_rts: bool = True) -> Routing:
    """Top-1 routing (JAX ``top1gating``): logits [t, E] fp32.  With a
    ``generator``, ``"RSample"`` adds Gumbel noise to the choice and
    ``use_rts`` assigns queue places in a uniform random priority order;
    without one, neither applies (as the JAX function without ``rng``)."""
    tokens, num_experts = logits.shape
    noisy = logits
    if noisy_gate_policy == "RSample" and generator is not None:
        noisy = logits + _gumbel(logits.shape, generator, logits.device)
    capacity = _capacity(tokens, num_experts, capacity_factor,
                         min_capacity) if drop_tokens else None
    idx = torch.argmax(noisy, dim=-1)                         # first on ties
    mask1 = _one_hot(idx, num_experts)
    if used_token is not None:
        mask1 = mask1 * used_token.float()[:, None]
    exp_counts = mask1.sum(0)
    ce = mask1.mean(0)
    if use_rts and generator is not None:
        priority = torch.rand(tokens, generator=generator,
                              device=logits.device)
        order = torch.argsort(-priority)
        placed = _queue_positions(mask1[order])
        positions = placed[torch.argsort(order)]
    else:
        positions = _queue_positions(mask1)
    keep = mask1.sum(-1) > 0
    if drop_tokens:
        keep = keep & (positions < capacity)
    return Routing(expert=idx[:, None], slot=positions.long()[:, None],
                   keep=keep[:, None], ce=ce, exp_counts=exp_counts,
                   capacity=capacity, logits=logits)


def top2_routing(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
                 drop_tokens: bool = True) -> Routing:
    """Top-2 routing (JAX ``top2gating``): the first choice is the gates'
    argmax, the second the logits' argmax over the other experts; second
    choices queue after every first choice of their expert."""
    tokens, num_experts = logits.shape
    capacity = _capacity(tokens, num_experts, 2 * capacity_factor,
                         min_capacity) if drop_tokens else None
    gates = torch.softmax(logits, dim=-1)
    idx1 = torch.argmax(gates, dim=-1)
    mask1 = _one_hot(idx1, num_experts)
    idx2 = torch.argmax(logits.masked_fill(mask1 > 0, float("-inf")), dim=-1)
    mask2 = _one_hot(idx2, num_experts)
    pos1 = _queue_positions(mask1)
    pos2 = _queue_positions(mask2) + (mask1.sum(0)[None] * mask2).sum(-1)
    slot = torch.stack([pos1, pos2], dim=1)
    keep = torch.ones_like(slot, dtype=torch.bool) if capacity is None \
        else slot < capacity
    kept = keep.float()
    exp_counts = (mask1 * kept[:, :1]).sum(0) + (mask2 * kept[:, 1:]).sum(0)
    return Routing(expert=torch.stack([idx1, idx2], dim=1),
                   slot=slot.long(), keep=keep, ce=mask1.mean(0),
                   exp_counts=exp_counts, capacity=capacity, logits=logits)


def gate_weights(routing: Routing) -> Tuple[torch.Tensor, torch.Tensor]:
    """The differentiable half of a gate call: (each route's combine
    weight [t, k] fp32, ``l_aux``) from ``routing.logits``.  Top-1: the
    route's gate; top-2: the two kept gates over their sum."""
    gates = torch.softmax(routing.logits, dim=-1)
    num_experts = gates.shape[-1]
    l_aux = torch.sum(gates.mean(0) * routing.ce) * num_experts
    w = gates.gather(1, routing.expert) * routing.keep
    if routing.k == 2:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, l_aux


def _dense(routing: Routing, weights):
    """The JAX package's ``(combine [t, E, C], dispatch [t, E, C])``; C is
    the tokens when not dropping."""
    t, num_experts = routing.logits.shape
    k = routing.k
    capacity = routing.capacity if routing.capacity is not None else t
    combine = weights.new_zeros((t, num_experts, capacity))
    rows = torch.arange(t, device=weights.device)[:, None].expand(t, k)
    slot = routing.slot.clamp(max=capacity - 1)
    combine = combine.index_put((rows, routing.expert, slot),
                                weights * routing.keep, accumulate=True)
    return combine, combine > 0


def _dense_gating(routing: Routing) -> Tuple:
    """A routing as the JAX gating functions return it: (l_aux, combine,
    dispatch, exp_counts)."""
    w, l_aux = gate_weights(routing)
    return (l_aux, *_dense(routing, w), routing.exp_counts)


def top1gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               used_token=None, noisy_gate_policy: Optional[str] = None,
               generator: Optional[torch.Generator] = None,
               drop_tokens: bool = True, use_rts: bool = True) -> Tuple:
    """JAX ``top1gating``'s dense form: (l_aux, combine [t, E, C],
    dispatch [t, E, C], exp_counts [E]); C = tokens when not dropping."""
    return _dense_gating(top1_routing(
        logits, capacity_factor, min_capacity, used_token, noisy_gate_policy,
        generator, drop_tokens, use_rts))


def top2gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               drop_tokens: bool = True) -> Tuple:
    """JAX ``top2gating``'s dense form, as :func:`top1gating`."""
    return _dense_gating(top2_routing(logits, capacity_factor, min_capacity,
                                      drop_tokens))


class TopKGate:
    """Gate config and apply (JAX ``TopKGate``); its ``wg`` [d, E] is fp32
    at init and read in fp32 whatever the serving dtype."""

    def __init__(self, model_dim: int, num_experts: int, k: int = 1,
                 capacity_factor: float = 1.0, eval_capacity_factor: float = 1.0,
                 min_capacity: int = 4, noisy_gate_policy: Optional[str] = None,
                 drop_tokens: bool = True, use_rts: bool = True):
        if k not in (1, 2):
            raise ValueError("Only top-1 and top-2 gatings are supported")
        if noisy_gate_policy not in (None, "RSample"):
            raise ValueError(f"noisy_gate_policy={noisy_gate_policy!r} "
                             "(want None or 'RSample')")
        self.model_dim = model_dim
        self.num_experts = num_experts
        self.k = k
        self.capacity_factor = capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity = min_capacity
        self.noisy_gate_policy = noisy_gate_policy
        self.drop_tokens = drop_tokens
        self.use_rts = use_rts

    def init(self, generator: torch.Generator, device=None):
        w = torch.randn((self.model_dim, self.num_experts),
                        generator=generator, device=device) * 0.02
        return {"wg": w}

    def route(self, params, x, train: bool = True,
              generator: Optional[torch.Generator] = None) -> Routing:
        """x [tokens, d] → the call's :class:`Routing` (logits in fp32)."""
        logits = x.float() @ params["wg"].float()
        cf = self.capacity_factor if train else self.eval_capacity_factor
        if self.k == 1:
            return top1_routing(
                logits, cf, self.min_capacity,
                noisy_gate_policy=self.noisy_gate_policy if train else None,
                generator=generator, drop_tokens=self.drop_tokens,
                use_rts=self.use_rts and train)
        return top2_routing(logits, cf, self.min_capacity,
                            drop_tokens=self.drop_tokens)

    def __call__(self, params, x, train: bool = True, generator=None):
        """x [tokens, d] → the dense (l_aux, combine, dispatch,
        exp_counts), as the JAX gate returns them."""
        return _dense_gating(self.route(params, x, train, generator))


def _combine_routes(tokens, routing: Routing, weights, expert_params):
    """Each token's weighted sum of its routes' expert outputs, [t, d] in
    the tokens' dtype."""
    t, d = tokens.shape
    k = routing.k
    cdt = tokens.dtype
    num_experts = routing.logits.shape[1]
    routed = tokens if k == 1 else \
        tokens[:, None].expand(t, k, d).reshape(t * k, d)
    if routing.capacity is None and t * k <= GATHER_MAX_ROUTES:
        y = experts_apply_routed(expert_params, routed,
                                 routing.expert.reshape(-1), cdt)
        y = y.view(t, k, d)
    else:
        # dropless: the busiest expert's count sizes the buffer (one read)
        cap = routing.capacity if routing.capacity is not None else \
            max(int(routing.exp_counts.max().item()), 1)
        n = num_experts * cap
        slot = torch.where(routing.keep, routing.expert * cap + routing.slot,
                           torch.full_like(routing.slot, n))
        buf = tokens.new_zeros((n + 1, d)).index_put(
            (slot.reshape(-1),), routed)
        ye = experts_apply(expert_params, buf[:n].view(num_experts, cap, d),
                           cdt)
        y = torch.cat([ye.reshape(n, d), ye.new_zeros((1, d))])[slot]
    return (y * weights.to(cdt)[..., None]).sum(1)


def moe_layer_forward(gate: TopKGate, gate_params, expert_params, x,
                      train: bool = True,
                      generator: Optional[torch.Generator] = None,
                      routing: Optional[Routing] = None):
    """The expert layer (JAX ``moe_layer_forward``) on x [B, S, d] →
    (output [B, S, d], l_aux, exp_counts, routing).  A given ``routing``
    (a remat replay's) is used as it is, so the replay routes as the
    forward did; its logits are recomputed for the gradient."""
    B, S, d = x.shape
    tokens = x.reshape(B * S, d)
    if routing is None:
        routing = gate.route(gate_params, tokens, train, generator)
        for sink in _RECORDERS:
            sink.append(routing)
    else:
        routing = dataclasses.replace(
            routing, logits=tokens.float() @ gate_params["wg"].float())
    weights, l_aux = gate_weights(routing)
    out = _combine_routes(tokens, routing, weights, expert_params)
    return out.view(B, S, d), l_aux, routing.exp_counts, routing
